"""Where one block of the port's main path spends its time on the card.

    python3 scripts/profile_torch_main_path.py [--blocks 3]

Same geometry and data as chip_smoke.py (24 bands x 45 frames x fft 131072
at 20.48 Msps, 2 DDC slots, both kernels on, bf16 selection). Runs the
blocks under torch.profiler and prints, per block:
- each stage of the step: the device-side span of each profiler range
  the step itself opens (``fused_step.STAGES``). Kernels launched through
  ctypes are not attributed to a host range, so the span is the measure;
- the top kernels by device time, the device's busy share of the profiled
  window, and the host wall time.
Needs a card; run it from the repository root.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=3, help="blocks to average over")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_main_path: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from rtl_sdr_scanner_tpu_torch.models.fused_step import STAGES
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    card = cs.card_line()
    build.library()
    path = cs.MainPath(torch.device("cuda", 0))
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

    print(f"per-stage device span, ms per block, mean of blocks 3..{2 + args.blocks} ({card}):")
    for name in STAGES:
        print(f"  {span[name]:9.3f}  {name}" if name in span else f"  not measured  {name}")
    print(f"  {sum(span.values()):9.3f}  sum")

    top = sorted(((ms, n // args.blocks, name) for name, (ms, n) in kernels.items()), reverse=True)
    busy = sum(k[0] for k in top)
    print(f"profiled: host wall {wall_ms:.3f} ms per block, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall) ({card})")
    print("top device entries per block (ms, launches, name):")
    for ms, n, name in top[:25]:
        print(f"  {ms:9.3f} {n:5d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
