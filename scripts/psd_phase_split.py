"""Where a kernel's time goes at both paths' shapes, on the card.

    python3 scripts/psd_phase_split.py [--kernel psd|fir|select] [--root DIR ...]

Times one kernel's wrapper at chip_smoke.py's two main-path shapes, for this
checkout's kernel and for variants of it made by editing a copy of its
source under ``build/psd_split/``. The difference to the kernel as it is
gives each phase's exposed cost.

``--kernel psd`` (the default) times ``psd_frames_int8`` (path 1: 1080
frames x fft 131072, decim 3; path 2: 1800 x fft 16384, decim 2) with
``torch.fft.fft`` alone beside it, and these variants:

- ``no input``: the first column pass reads no device memory (made-up pairs,
  a constant window);
- ``no output``: the last row pass writes no dB (computed, then dropped);
- ``local exchange``: the cluster's blocks read their own shared memory in
  place of each other's (no distributed shared memory; wrong numbers, same
  work);
- ``cluster of 8``: fft 131072 as 8 blocks of 16384 points (one a SM) in
  place of 16 of 8192 (two a SM).

``--kernel fir`` times ``stage_apply_fir`` (path 1: 96 rows x 34,560 at
M = 40; path 2: 96 x 1,228,800 at M = 75) as the kernel's device time
(torch.profiler), with FIR_VARIANTS; ``--kernel select`` times
``fused_selection`` (1080 x 131072 and 1800 x 16384 bf16, top-64 and 16
margin winners) the same way, with SELECT_VARIANTS.

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
CSRC = "rtl_sdr_scanner_tpu_torch/csrc/"

PSD_VARIANTS = {
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
FIR_VARIANTS = {
    "no products": [(  # copies and lag sums only
        "          mma_tf32(acc[j][nt], hi[j], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));\n",
        "          ;\n",
    ), (
        "          mma_tf32(acc[j][nt], hi[j], __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));\n",
        "          ;\n",
    ), (
        "          mma_tf32(acc[j][nt], lo[j], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));\n",
        "          acc[j][nt][0] += __uint_as_float(lo[j][0] ^ hi[j][1]);\n",
    )],
    "one pass": [(  # x_hi * W_hi alone: what the split costs
        "          mma_tf32(acc[j][nt], hi[j], __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));\n",
        "          ;\n",
    ), (
        "          mma_tf32(acc[j][nt], lo[j], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));\n",
        "          ;\n",
    )],
    "no window copy": [(  # every tile after a run's first reads a stale window
        "    if (next < end) {\n      const int row = next / tiles_per_row",
        "    if (next < 0) {\n      const int row = next / tiles_per_row",
    )],
    "no lag sum": [(  # Z is stored, y is not summed
        "        if (q < r_rows) acc_y += zp[q * kZS + q];",
        "        if (q < 0) acc_y += zp[q * kZS + q];",
    )],
}
SELECT_VARIANTS = {
    "table only": [(  # one winner a phase: the pass over the row and the count
        "  for (int i = 0; i < top_k; ++i) {",
        "  for (int i = 0; i < 1; ++i) {",
    ), (
        "  for (int i = 0; i < k_sep; ++i) {",
        "  for (int i = 0; i < 1; ++i) {",
    ), (
        "  for (int i = lane; i < top_k; i += 32) {",
        "  for (int i = lane; i < 1; i += 32) {",
    ), (
        "  for (int i = lane; i < k_sep; i += 32) {",
        "  for (int i = lane; i < 1; i += 32) {",
    ), (
        "    for (int i = top_k - 1; i >= 0; --i) {",
        "    for (int i = 0; i >= 0; --i) {",
    )],
    "no margin phase": [(  # one margin winner
        "  for (int i = 0; i < k_sep; ++i) {",
        "  for (int i = 0; i < 1; ++i) {",
    ), (
        "  for (int i = lane; i < k_sep; i += 32) {",
        "  for (int i = lane; i < 1; i += 32) {",
    )],
}
PSD_SHAPES = ((1080, 131072, 3), (1800, 16384, 2))  # (frames, fft, decim): paths 1 and 2


def make_variant(kernel: str, name: str, edits) -> Path:
    src = CSRC + KERNELS[kernel][0]
    dst = ROOT / "build" / "psd_split" / f"{kernel}_{name.replace(' ', '_')}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "rtl_sdr_scanner_tpu_torch", dst / "rtl_sdr_scanner_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / src
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"psd_phase_split: variant {name!r} no longer matches {src}: {old.strip()[:60]}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_fir(reps: int) -> None:
    import torch

    import chip_smoke as cs
    from rtl_sdr_scanner_tpu_torch.ops import ddc
    from rtl_sdr_scanner_tpu_torch.ops.cuda import fir_kernel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for m, n in ((40, 34560), (75, 1228800)):
        plan = ddc.plan_stage(1, m)
        x = torch.randn((48, 2, n), generator=gen, device="cuda")
        tail = torch.randn((48, 2, plan.tail_len), generator=gen, device="cuda")
        ms = cs.device_ms(lambda: fir_kernel.stage_apply_fir(x, tail, plan), reps, "fir_decimate")
        print(f"  [96, {n}] M={m}: kernel {ms:.4f} ms device time", flush=True)


def time_select(reps: int) -> None:
    import torch

    import chip_smoke as cs
    from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    level = torch.tensor(cs.LEVEL, device="cuda")
    for rows, fft, submargin in ((1080, 131072, 52), (1800, 16384, 110)):
        t = torch.randn((rows, fft), generator=gen, device="cuda").mul_(6.0).to(torch.bfloat16)
        ms = cs.device_ms(lambda: select_kernel.fused_selection(t, level, cs.TOP_K, 16, submargin), reps,
                          "selection_kernel")
        print(f"  [{rows}, {fft}] bf16: kernel {ms:.4f} ms device time", flush=True)


def time_psd(reps: int) -> None:
    import torch

    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel
    from rtl_sdr_scanner_tpu_torch.ops.psd import shifted_window

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for frames, fft, decim in PSD_SHAPES:
        iq = torch.randint(-100, 100, (frames, fft * decim, 2), generator=gen, device=dev, dtype=torch.int8)
        win = torch.from_numpy(shifted_window(fft)).to(dev)
        frames_c = torch.complex(iq[:, :fft, 0].float() / 127.5, iq[:, :fft, 1].float() / 127.5) * win
        ms = cuda_ms(lambda: psd_kernel.psd_frames_int8(iq, 2.0e7, fft, decim), reps)
        lib_ms = cuda_ms(lambda: torch.fft.fft(frames_c), reps)
        print(f"  [{frames}, {fft}] decim {decim}: kernel {ms:.4f} ms, torch.fft.fft alone {lib_ms:.4f} ms",
              flush=True)
        del iq, frames_c


# kernel -> (source under csrc/, variants, timing at both paths' shapes)
KERNELS = {
    "psd": ("psd_kernel.cu", PSD_VARIANTS, time_psd),
    "fir": ("fir_kernel.cu", FIR_VARIANTS, time_fir),
    "select": ("select_kernel.cu", SELECT_VARIANTS, time_select),
}


def time_one(root: str, reps: int, kernel: str) -> int:
    """In this process: the package under root, timed at both paths' shapes."""
    sys.path.insert(0, root)
    sys.path.insert(1, str(ROOT))  # chip_smoke.py's timers
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    build.library()
    KERNELS[kernel][2](reps)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="psd", help="the kernel to split")
    ap.add_argument("--root", action="append", default=[], help="another checkout to time as well")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--time-one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_one:
        return time_one(args.time_one, args.reps, args.kernel)
    import torch

    if not torch.cuda.is_available():
        print("psd_phase_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = [("as is", ROOT)] + [(f"--root {r}", Path(r).resolve()) for r in args.root]
    runs += [(name, make_variant(args.kernel, name, edits)) for name, edits in KERNELS[args.kernel][1].items()]
    runs.append(("as is, again", ROOT))
    print(f"{args.kernel} kernel on {card}", flush=True)
    failed = 0
    for name, root in runs:
        print(f"{name}:", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--time-one", str(root), "--reps", str(args.reps),
                             "--kernel", args.kernel]).returncode
        if rc:
            print(f"  {name}: failed (rc {rc})", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
