"""Readings that a cell's limits are set from: the program's numbers over
many seeds, and the control's (the reference put in the program's place
one precision down: rows stored in bfloat16 where the configuration
stores float32, selection over float8 e4m3 where it selects over
bfloat16, the DDC's operands rounded to TF32 where it runs float32 with
TF32 off) judged the same way, on the same blocks. The benchmark's own
runs do not run the control.

    python3 -m benchmark.calibrate --workload <cell> --seconds 2 --seeds 11 12 13 [--control-seeds 3]

prints one JSON line a seed (``program`` numbers and ``correct``, and for
the first ``--control-seeds`` seeds the ``control`` numbers and
``control_correct``, the harness's own verdict on them against the cell's
limits) and a summary line last. It exits 1 where the control comes out
correct on any seed, or the program not correct on any.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    args = parser.parse_args(argv)
    from benchmark.run import set_environment

    root = Path.cwd()
    set_environment(root)
    import torch

    torch.set_num_threads(1)

    from benchmark.harness import Outcome, load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(root, args.workload)
    device = torch.device("cuda", 0)
    prog, ctl = {}, {}
    bad = []
    for i, seed in enumerate(args.seeds):
        control = i < args.control_seeds
        out = cell.driver().run(cell, seed, args.seconds, False, device, time.perf_counter(), control=control)
        verdict = None
        if control:
            judged = Outcome(end_to_end={}, numbers=out.control, limits=out.limits, attempted=out.attempted,
                             memory_peak_bytes=0)
            verdict = judged.correct
            if verdict:
                bad.append(f"the control is correct on seed {seed}")
        if not out.correct:
            bad.append(f"the program is not correct on seed {seed}")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out.correct, "program": out.numbers,
                          "control": out.control if control else None, "control_correct": verdict,
                          "end_to_end": out.end_to_end}), flush=True)
        for k, v in out.numbers.items():
            prog.setdefault(k, []).append(v)
        for k, v in out.control.items():
            ctl.setdefault(k, []).append(v)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    summary = {k: {"program_max": max(v), "control_min": min(ctl[k]) if k in ctl else None} for k, v in prog.items()}
    print(json.dumps({"workload": args.workload, "summary": summary, "faults": bad}), flush=True)
    for line in bad:
        print(f"calibrate: {line}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
