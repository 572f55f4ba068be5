"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It loads the cell's files, builds and warms up the program
(``rtl_sdr_scanner_tpu_torch``) at the cell's shapes, measures for
``--seconds``, judges the outputs against the plain reference and prints
one JSON line last on stdout; each number compared, beside its limit, goes
last on stderr too. With ``--trace 1`` the window runs under the profiler
and the line carries the per-layer metrics, the device's busy and window
seconds and a breakdown. Without a card, or with fewer than the cell asks
for, it exits 2 and prints no result; it never times the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rtl_sdr_scanner_tpu")
CACHES = {  # every cache a library may keep, at fixed paths inside the checkout
    "CUDA_CACHE_PATH": "build/bench_cache/cuda",
    "TRITON_CACHE_DIR": "build/bench_cache/triton",
    "TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
    "PYTORCH_KERNEL_CACHE_PATH": "build/bench_cache/torch_kernels",
}
# One host thread a library: the sessions are host-bound, and a pool of
# intra-op threads on a shared host widens the tail of their block times.
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def set_environment(root: Path) -> None:
    """Caches inside the checkout, one thread a library, no Flax; before
    torch is imported."""
    for var, rel in CACHES.items():
        os.environ[var] = str(root / rel)
    for var in THREADS:
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def result_line(cell, out, trace: bool, device: dict) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](out.trace)
            if v is not None:
                values[m["name"]] = v
        device = dict(device, busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    else:
        values = {m["name"]: out.end_to_end[m["name"]] for m in cell.end_to_end}
    line = {
        "correct": out.correct,
        "attempted": out.attempted,
        "failed": 0,  # a block whose outputs do not come back ends the run
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": dict(device, memory_peak_bytes=out.memory_peak_bytes),
    }
    if trace:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": out.numbers.get(k), "limit": lim} for k, lim in out.limits.items()}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    set_environment(root)

    import torch

    torch.set_num_threads(1)

    from benchmark.harness import load_cell

    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    if args.trace and not out.trace.device:
        print("benchmark: the traced window holds no device operation", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 4
    line = result_line(cell, out, bool(args.trace),
                       {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips})
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
