"""Where one block of the port's main path spends its time on the card.

    python3 scripts/profile_torch_main_path.py
        [--path 1|2|491|session|wideband|wideband-shards|wideband-session|time-mesh|time-mesh-one-card]
        [--form serial|split|fused] [--blocks 3]

Same geometries and data as chip_smoke.py: path 1, 24 bands x 45 frames x
fft 131072 at 20.48 Msps with 2 modulated-taps DDC slots; path 2, the
RTL-SDR deployment, 24 bands x 75 frames x fft 16384 at 2.4 Msps with 2 v1
DDC slots at 32 kHz; ``--path 491`` chip_smoke.py's step 12d block, one band
at 491.52 Msps (16 frames of fft 2^21, decim 4, 2 slots at 30 kHz), its noise
learning cut to 200 ms as there. Default Tunables (every kernel, bf16
selection).
Runs blocks 3.. of the path under torch.profiler (after 3 warm-up blocks)
and prints, per block:
- each stage of the step: the device-side span of each profiler range
  the step itself opens (``fused_step.STAGES``). Kernels launched through
  ctypes are not attributed to a host range, so the span is the measure;
- the top kernels by device time, the device's busy share of the profiled
  window, and the host wall time.
These run the step eagerly (its graphed step's ``.fn``): inside a captured
CUDA graph a stage's host range is recorded once, at the capture, and each
replay shows the stage on the device between its two marker kernels
(``utils/trace.py``; the benchmark's ``stage.*`` metrics read them, this
script does not). Then the same step graphed (``graph.donated_step``, or for a sharded step
``graph.sharded_step``, as ``drivers`` and ``chip_smoke.TimeMesh`` build
them, its state carried on from the eager blocks): host wall a block and
the device's busy share of the profiled window, beside the eager split.
``--path session`` profiles the runtime session instead: chip_smoke.py's
runtime capture (one replay device, 2.4 Msps, 4 slots at 32 kHz) through
``Scanner.step()``, blocks 3.. (the FM signal keyed 3-6 s records there),
and prints the host time of each range a block opens
(``sdr_device.STAGES``) beside the device's busy time.
``--path wideband`` profiles chip_smoke.py's wideband step (bench.py's app
path: 163.84 Msps into 8 channels of path 1's geometry, fused dispatch):
the device span of the channelizer (``sharded_scan.STAGES``) and of each
step stage, as for paths 1 and 2; ``--path wideband-shards`` the same step
over chip_smoke.py's BAND_SHARDS band shards of the card (``--form fused``
or ``split``). ``--path wideband-session --form F``
profiles chip_smoke.py's wideband session (2.048 Msps into 16 channels of
128 kHz) in form F: the host time of each range a block opens (the
sessions' ranges summed over the 16 channels, the channelizer's and the
batched step's) beside the device's busy time. ``--path time-mesh``
profiles chip_smoke.py's time mesh (path 1's band, 180 frames a block,
time-sharded scan and DDC over 4 copies of the card; ``time-mesh-one-card``
the one-card step and DDC at the same geometry): the device span of each
scan range (summed over the shards) beside the busy time.
Needs a card; run it from the repository root.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402
import torch_checks as checks  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("1", "2", "491", "session", "wideband", "wideband-shards", "wideband-session",
                                       "time-mesh", "time-mesh-one-card"), default="1",
                    help="chip_smoke.py's path to drive")
    ap.add_argument("--form", choices=[f for f, _ in cs.WB_FORMS], default="fused",
                    help="the wideband session's form (--path wideband-session; fused or split for wideband-shards)")
    ap.add_argument("--blocks", type=int, default=3, help="blocks to average over")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_main_path: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from rtl_sdr_scanner_tpu_torch.drivers import card_line
    from rtl_sdr_scanner_tpu_torch.models.fused_step import STAGES
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    card = card_line()
    build.library()
    if args.path == "session":
        return profile_session(card, args.blocks)
    if args.path == "wideband-session":
        return profile_wideband_session(card, args.blocks, args.form)
    dev = torch.device("cuda", 0)
    if args.path.startswith("wideband"):
        from rtl_sdr_scanner_tpu_torch.parallel.sharded_scan import STAGES as WIDE_STAGES

        geo = cs.WIDE
        shards = cs.BAND_SHARDS if args.path == "wideband-shards" else 1
        path = cs.WidebandStep(dev, geo, args.form != "split", [], shards)
        path.ring = cs.wide_ring(geo, path.cfg.block_samples, dev)
        STAGES = WIDE_STAGES + STAGES
    elif args.path.startswith("time-mesh"):
        geo = cs.TMESH
        path = cs.TimeMesh(dev, args.path == "time-mesh")
    elif args.path == "491":
        geo = cs.BAND_491
        path = cs.MainPath(dev, geo, learn_ms=cs.BAND_491_LEARN_MS)
    else:
        geo = cs.PATH1 if args.path == "1" else cs.PATH2
        path = cs.MainPath(dev, geo)
    # the stage split runs the eager steps; the graphed ones follow
    graphed = graphed_steps(path)
    for owner, attr, step in graphed:
        setattr(owner, attr, step.fn)
    for b in range(3):  # warm up: allocator, cuFFT/cuBLAS plans, noise learning under way
        path.run_block(b)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in range(3, 3 + args.blocks):
            path.run_block(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.blocks

    span = defaultdict(float)  # device-side span of each stage range
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / args.blocks
        if e.name in STAGES:
            span[e.name] += ms
        else:
            kernels[e.name][0] += ms
            kernels[e.name][1] += 1

    print(f"{geo.name}: per-stage device span, ms per block, mean of blocks 3..{2 + args.blocks} ({card}):")
    for name in STAGES:
        print(f"  {span[name]:9.3f}  {name}" if name in span else f"  not measured  {name}")
    print(f"  {sum(span.values()):9.3f}  sum")

    print_kernels(kernels, args.blocks, wall_ms, card)
    if graphed:
        for owner, attr, step in graphed:
            setattr(owner, attr, step)
        profile_graphed(path, [step for _, _, step in graphed], 3 + args.blocks, args.blocks, card)
    return 0


def graphed_steps(path) -> list:
    """(owner, attribute, step) of each graphed step a path runs."""
    if isinstance(path, cs.TimeMesh):
        owner, attrs = path, ("scan_step", "ddc_step")
    else:
        owner, attrs = path.blocks, ("step", "wide_step", "ddc_step")
    return [(owner, a, getattr(owner, a)) for a in attrs if hasattr(getattr(owner, a, None), "fn")]


def profile_graphed(path, steps: list, first: int, blocks: int, card: str) -> None:
    """The path's graphed steps: 3 blocks (the captures in the first), then
    ``blocks`` blocks under the profiler; host wall a block, the device's
    busy share (the replays' kernel records) and the graphs' replays a
    block."""
    for b in range(first, first + 3):
        path.run_block(b)
    torch.cuda.synchronize()
    replayed = lambda: sum(g.replays for step in steps for g in step.graphs())
    before = replayed()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in range(first + 3, first + 3 + blocks):
            path.run_block(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / blocks
    replays = (replayed() - before) / blocks
    busy, records = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.time_range.elapsed_us() / 1e3 / blocks
            records += 1
    log = [c for step in steps for c in step.capture_log]
    share = f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of wall)" if records else (
        "not measured (the profiler recorded no kernel of the replays)")
    print(f"graphed ({len(log)} captures, {sum(c['seconds'] for c in log):.3f} s, pool "
          f"{sum(c['pool_bytes'] for c in log)} bytes): host wall {wall_ms:.3f} ms per block, device busy {share}, "
          f"{replays:g} graph replays and {records // blocks} device records a block; the trace holds the graphs' "
          f"kernels, not the stages ({card})")


def print_kernels(kernels: dict, blocks: int, wall_ms: float, card: str) -> None:
    top = sorted(((ms, n // blocks, name) for name, (ms, n) in kernels.items()), reverse=True)
    busy = sum(k[0] for k in top)
    print(f"profiled: host wall {wall_ms:.3f} ms per block, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall) ({card})")
    print("top device entries per block (ms, launches, name):")
    for ms, n, name in top[:25]:
        print(f"  {ms:9.3f} {n:5d}  {name[:110]}")


def profile_session(card: str, blocks: int) -> int:
    """The runtime session under the profiler: host ranges and device busy."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner
    from rtl_sdr_scanner_tpu_torch.runtime.sdr_device import STAGES

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        capture = Path(tmp) / "capture.cs8"
        checks.write_capture(capture, cs.RT_RATE, cs.RT_SECONDS, cs.RT_SHIFT, cs.RT_KEY)
        cfg = Config(json.loads(json.dumps(cs.runtime_config(capture, cs.RT_RATE, cs.RT_CENTER))))
        scanner = Scanner(cfg, cfg.devices[0], NullMqtt(), cfg.recorders_count(), device=torch.device("cuda", 0))
        for _ in range(3):  # warm up: allocator, pinned buffers, noise learning
            scanner.step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(blocks):
                assert scanner.step(), "the capture ended inside the profiled window"
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / blocks

    host = defaultdict(float)
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / blocks
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in STAGES and not e.name.startswith("scan."):
                kernels[e.name][0] += ms
                kernels[e.name][1] += 1
        elif e.name in STAGES:
            host[e.name] += ms
    print(f"session: host time of each range, ms per block, mean of blocks 3..{2 + blocks} ({card}):")
    for name in STAGES:
        print(f"  {host[name]:9.3f}  {name}" if name in host else f"  not opened  {name}")
    print(f"  {sum(host.values()):9.3f}  sum (the replay read and the scheduler are outside)")
    print_kernels(kernels, blocks, wall_ms, card)
    return 0


def profile_wideband_session(card: str, blocks: int, form: str) -> int:
    """The wideband session under the profiler: host ranges and device busy."""
    from rtl_sdr_scanner_tpu_torch.models.fused_step import STAGES as STEP_STAGES
    from rtl_sdr_scanner_tpu_torch.parallel.sharded_scan import STAGES as WIDE_STAGES
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.sdr_device import STAGES
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner

    ranges = WIDE_STAGES + STAGES + STEP_STAGES
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        capture = Path(tmp) / "wide.cs8"
        checks.write_capture(capture, cs.WB_RATE, cs.WB_SECONDS, cs.WB_SIGNALS, cs.WB_KEY, seed=7)
        raw = cs.runtime_config(capture, cs.WB_RATE, cs.WB_CENTER, channels=cs.WB_CHANNELS, **dict(cs.WB_FORMS)[form])
        cfg = Config(json.loads(json.dumps(raw)))
        scanner = WidebandScanner(cfg, cfg.devices[0], NullMqtt(), cfg.recorders_count(), device=torch.device("cuda", 0))
        for _ in range(10):  # warm up, into the keyed signals (3-6 s; 0.32 s blocks)
            scanner.step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(blocks):
                assert scanner.step(), "the capture ended inside the profiled window"
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / blocks
        recording = sum(s.is_recording for s in scanner.sessions)

    host = defaultdict(float)
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / blocks
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in ranges:
                kernels[e.name][0] += ms
                kernels[e.name][1] += 1
        elif e.name in ranges:
            host[e.name] += ms
    print(f"wideband session, {form}: host time of each range, ms per block, all channels, mean of blocks "
          f"10..{9 + blocks} ({recording} channels recording at the end) ({card}):")
    for name in ranges:
        if name in host:
            print(f"  {host[name]:9.3f}  {name}")
    print("  (scan.* ranges nest inside session.scan in the serial form, and are the batched step's enqueue "
          "in the others)")
    print_kernels(kernels, blocks, wall_ms, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
