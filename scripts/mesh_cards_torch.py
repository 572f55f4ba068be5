"""The multi-device layer across the cards of one host (2 to 4 NVIDIA GPUs).

    python3 scripts/mesh_cards_torch.py

``chip_smoke.py`` runs the layer on copies of one card, where every copy
between shards is a same-device copy on one stream. This script runs it on
distinct cards, where the copies cross cards and each shard launches on
its own card's stream; every sharded step graphed (``graph.sharded_step``:
a graph a (shard, segment) on its own card, each captured once, its inputs
copied in from the cards they lie on):
1. path 1's band (20.48 Msps, fft 131072, 180 frames) time-sharded over
   cards 0-3 (with 4 cards), against the one-card step on card 0
   (``chip_smoke.run_time_mesh``'s bars; each graph replayed once a
   block, the replays a block logged beside the ms a block);
2. ``chip_smoke.py``'s wideband step (163.84 Msps into 8 channels) over
   cards 0-1, fused and split, against one card (``run_band_shards``'s
   bars: outputs bit-equal);
3. ``main.run`` with ``mesh_time`` 4 and ``power_bf16`` on the runtime
   capture, the time mesh resolved to the visible cards, and a wideband
   session (2.048 Msps into 16 channels) with ``mesh_bands`` -1, fused and
   split, over the visible cards; each against the same config's CPU run
   on as many copies of the CPU device (``torch_checks.compare_payloads``).
Prints every card's name and power limit, ms a block beside the one-card
form, and the kernels' launch counts as JSON, last
``{"ok": true, ...}``. Needs at least 2 cards; run it from the repository
root.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def wideband_session(card: str, cards: int) -> dict:
    """Step 3b: a wideband session with mesh_bands -1 over the visible
    cards, fused and split, each against the CPU run on as many copies of
    the CPU. Returns {form: counts}."""
    import chip_smoke as cs
    import torch_checks as checks
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers

    wrappers = kernel_wrappers()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="mesh_cards_wb_") as tmp:
        capture = Path(tmp) / "wide.cs8"
        checks.write_capture(capture, cs.WB_RATE, cs.WB_SECONDS, cs.WB_SIGNALS, cs.WB_KEY, seed=7)
        for form in ("split", "fused"):
            config = cs.runtime_config(capture, cs.WB_RATE, cs.WB_CENTER, channels=cs.WB_CHANNELS, mesh_bands=-1,
                                       wideband_fused_dispatch=form == "fused")
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            payloads, scanner, wall_s, _ = cs.run_wideband_scanner(config, torch.device("cuda", 0))
            counts = {name: fn.launches for name, fn in wrappers.items()}
            shape = scanner._mesh.shape
            with cs.cpu_cards(cards):
                cpu_payloads, cpu_scanner, cpu_s, _ = cs.run_wideband_scanner(config, torch.device("cpu"))
            stats = checks.compare_payloads(cpu_payloads, payloads)
            found = cs.check_wideband_recordings(payloads)
            cs.log(f"wideband session {form}, mesh_bands -1 -> {shape} (CPU {cpu_scanner._mesh.shape}): launches "
                   f"{counts}; card vs CPU {stats} (CPU {cpu_s:.1f} s); recorded {found}; {wall_s:.2f} s wall for "
                   f"{cs.WB_SECONDS} s of stream on {card}")
            if shape != {"bands": min(cards, cs.WB_CHANNELS), "time": 1} or not counts["fused_selection"]:
                raise RuntimeError(f"wideband session over the cards: mesh {shape}, launches {counts}")
            launches[f"wideband_session_{shape['bands']}_cards_{form}"] = counts
    return launches


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_cards_torch: needs an NVIDIA GPU host with at least 2 cards", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from rtl_sdr_scanner_tpu_torch import native
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    dev = cards[0]
    torch.cuda.set_device(dev)
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    card = f"{len(cards)} x {lines[0]}"
    cs.log(f"cards: {lines}")
    build.build(verbose=False)
    build.library()
    if not native.native_available():
        raise RuntimeError("the native host codecs did not build (g++)")
    launches = {}
    if len(cards) >= cs.TMESH_SHARDS:
        launches.update(cs.run_time_mesh(dev, card, devices=cards[: cs.TMESH_SHARDS]))
    launches.update(cs.run_band_shards(dev, card, devices=cards[:2]))
    launches.update(cs.run_main_time_mesh(dev, card, cards=len(cards)))
    launches.update(wideband_session(card, len(cards)))
    for line in lines:
        cs.log(line)
    cs.log(json.dumps({"launches": launches}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
