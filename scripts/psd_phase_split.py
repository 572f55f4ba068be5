"""Where the PSD kernel's time goes at both paths' shapes, on the card.

    python3 scripts/psd_phase_split.py [--root DIR ...]

Times ``psd_frames_int8`` at chip_smoke.py's two main-path shapes (path 1:
1080 frames x fft 131072, decim 3; path 2: 1800 x fft 16384, decim 2) with
``torch.fft.fft`` alone beside it, for this checkout's kernel and for
variants of it made by editing a copy of its source under
``build/psd_split/``:

- ``no input``: the first column pass reads no device memory (made-up pairs,
  a constant window);
- ``no output``: the last row pass writes no dB (computed, then dropped);
- ``local exchange``: the cluster's blocks read their own shared memory in
  place of each other's (no distributed shared memory; wrong numbers, same
  work);
- ``cluster of 8``: fft 131072 as 8 blocks of 16384 points (one a SM) in
  place of 16 of 8192 (two a SM).

The difference to the kernel as it is gives each phase's exposed cost.
``--root DIR`` adds another checkout's package (for example the parent
commit's, unpacked with ``git archive``) to the same run. Each kernel runs in
a process of its own (the package keeps one name); an edit that no longer
matches the source stops the script. Needs a card.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "rtl_sdr_scanner_tpu_torch/csrc/psd_kernel.cu"

VARIANTS = {
    "no input": [(
        "      iq[r] = x[(j + r * Q) * N2 + b];\n      win[r] = w[(j + r * Q) * N2 + b];",
        "      iq[r] = make_char2((signed char)(j + r), (signed char)b);\n      win[r] = 0.5f;",
    )],
    "no output": [(
        "    o[k2 * N1 + b] = 10.0f * log10f(fmaxf(p, 1e-30f) * inv_rate);",
        "    const float db = 10.0f * log10f(fmaxf(p, 1e-30f) * inv_rate);\n"
        "    if (db == 12345.0f) o[k2 * N1 + b] = db;",
    )],
    "local exchange": [(
        "      if constexpr (kClustered) src = cg::this_cluster().map_shared_rank(src, (unsigned)(n2 >> LOG_BA));",
        "",
    )],
    "cluster of 8": [(
        "  static constexpr int LOG_C = LOG_N > kSingleMaxLog ? LOG_N - kClusterBlockLog : 0;",
        "  static constexpr int LOG_C = LOG_N > kSingleMaxLog ? 3 : 0;",
    )],
}
SHAPES = ((1080, 131072, 3), (1800, 16384, 2))  # (frames, fft, decim): paths 1 and 2


def make_variant(name: str, edits) -> Path:
    dst = ROOT / "build" / "psd_split" / name.replace(" ", "_")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "rtl_sdr_scanner_tpu_torch", dst / "rtl_sdr_scanner_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / SRC
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"psd_phase_split: variant {name!r} no longer matches {SRC}: {old.strip()[:60]}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def time_one(root: str, reps: int) -> int:
    """In this process: the package under root, timed at SHAPES."""
    sys.path.insert(0, root)
    import torch

    from rtl_sdr_scanner_tpu_torch.ops.cuda import build, psd_kernel
    from rtl_sdr_scanner_tpu_torch.ops.psd import shifted_window

    build.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for frames, fft, decim in SHAPES:
        iq = torch.randint(-100, 100, (frames, fft * decim, 2), generator=gen, device=dev, dtype=torch.int8)
        win = torch.from_numpy(shifted_window(fft)).to(dev)
        frames_c = torch.complex(iq[:, :fft, 0].float() / 127.5, iq[:, :fft, 1].float() / 127.5) * win
        ms = cuda_ms(lambda: psd_kernel.psd_frames_int8(iq, 2.0e7, fft, decim))
        lib_ms = cuda_ms(lambda: torch.fft.fft(frames_c))
        print(f"  [{frames}, {fft}] decim {decim}: kernel {ms:.4f} ms, torch.fft.fft alone {lib_ms:.4f} ms",
              flush=True)
        del iq, frames_c
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[], help="another checkout to time as well")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--time-one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_one:
        return time_one(args.time_one, args.reps)
    import torch

    if not torch.cuda.is_available():
        print("psd_phase_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = [("as is", ROOT)] + [(f"--root {r}", Path(r).resolve()) for r in args.root]
    runs += [(name, make_variant(name, edits)) for name, edits in VARIANTS.items()]
    runs.append(("as is, again", ROOT))
    print(f"psd_frames_int8 on {card}", flush=True)
    for name, root in runs:
        print(f"{name}:", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--time-one", str(root), "--reps", str(args.reps)]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
