"""Where a kernel's time goes on the card, phase by phase.

    python3 scripts/psd_phase_split.py [--kernel psd|fir|select] [--shape NAME ...]
        [--root DIR ...] [--variant NAME ...] [--reps 20]

Times one kernel's wrapper at named shapes (``SHAPES``; by default
chip_smoke.py's two main-path shapes), for this checkout's kernel and for
variants of it made by editing a copy of the package under
``build/psd_split/``. The difference to the kernel as it is gives each
phase's exposed cost. Each timing is the wrapper's pace (CUDA events around
back-to-back calls) and the kernel's device time (torch.profiler's kernel
records); the PSD's also ``torch.fft.fft``'s on the same complex frames.

Shapes (``--shape``, repeatable): ``path1`` and ``path2`` (the main paths'
block rows), ``491`` (chip_smoke.py step 12d's block: 16 frames of fft 2^21,
decim 4; its selection rows [16, 2^21] with submargin 64), ``2^18`` ...
``2^22`` (16 frames, decim 4) and ``scratch`` (all five); for the selection
also ``time-shard`` ([45, 131072]), ``band-shard`` ([180, 131072]),
``wideband`` (the wideband step's [360, 131072]) and any ``ROWSxFFT``
(``1024x131072``; submargin 52).

``--kernel psd``:

- ``no input``: the first column pass reads no device memory (made-up pairs,
  a constant window);
- ``no output``: the last row pass writes no dB (computed, then dropped);
- ``local exchange``: the cluster's blocks read their own shared memory in
  place of each other's (no distributed shared memory; wrong numbers, same
  work);
- ``cluster of 8``: fft 131072 as 8 blocks of 16384 points (one a SM) in
  place of 16 of 8192 (two a SM);
- the scratch form's passes alone (``pass 1 alone``, ``pass 2 alone``), its
  scratch traffic dropped (``no scratch write``: pass 1 computes and drops
  its product; ``no scratch read``: pass 2 transforms made-up points), ``no
  window`` (pass 1 computes no window), ``8192 points a block`` (2048-point
  sequences 4 a block, two blocks an SM, in place of 8 in one) and ``2048 as
  32 x 8 x 8`` (the 2048-point passes' radices).

``--kernel fir`` (``stage_apply_fir``; path 1: 96 rows x 34,560 at M = 40;
path 2: 96 x 1,228,800 at M = 75) with FIR_VARIANTS. ``--kernel select``
(``fused_selection``, bf16, top-64 and 16 margin winners): ``table only``
(one winner a phase: the pass over the row and the count), ``no top-K
chain`` and ``no margin phase`` (one winner in that phase), ``no table
pass`` (the row-split form's leaves made up: its chains alone), ``chains
a warp a block`` (the row-split form's chain kernel in blocks of one warp
in place of 8), and the choice of form (``select_kernel.row_slices``): ``a
warp a row throughout`` (no row-split form) and ``split to 2048 rows`` (the
row-split form up to 2048 rows, at least 2 warps a row: path 1's 1080 rows
split).

``--root DIR`` adds another checkout's package (for example the parent
commit's, unpacked with ``git archive``) to the same run, as it is. Each
kernel runs in a process of its own (the package keeps one name); an edit
that no longer matches its source stops the script. ``--variant`` keeps only
the named variants. Needs a card.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "rtl_sdr_scanner_tpu_torch/csrc/"
SELECT_PY = "rtl_sdr_scanner_tpu_torch/ops/cuda/select_kernel.py"

PSD_VARIANTS = {  # the on-chip forms
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
    # the scratch form
    "pass 1 alone": [("  psd_scratch2<LOG_N><<<", "  if (frames < 0) psd_scratch2<LOG_N><<<")],
    "pass 2 alone": [("  psd_scratch1<LOG_N><<<", "  if (frames < 0) psd_scratch1<LOG_N><<<")],
    "no scratch write": [(
        "  __device__ __forceinline__ void store(int i, int b, float2 x) const { c[(long long)i * N2 + b] = x; }",
        "  __device__ __forceinline__ void store(int i, int b, float2 x) const {\n"
        "    if (x.x == 12345.0f) c[(long long)i * N2 + b] = x;\n  }",
    )],
    "no scratch read": [(  # ExchangeIn: the cluster form's exchange too, at shapes not timed here
        "      v[r] = cmul(*src, tw);",
        "      v[r] = cmul(make_float2((float)n2, (float)b), tw);",
    )],
    "no window": [(  # pass 1 computes no window: a constant
        "      win[r] = (0.54f - 0.46f * z.x) * sign;",
        "      win[r] = 0.5f;",
    )],
    "8192 points a block": [(  # 2048-point sequences too: 4 a block, two blocks an SM
        "constexpr int kScratchNarrowLog = 10;", "constexpr int kScratchNarrowLog = 11;",
    ), (
        "static_assert(S2 >= 8 && S1 >= 8,", "static_assert(S2 >= 4 && S1 >= 4,",
    )],
    "2048 as 32 x 8 x 8": [(
        "(rem == 5 || rem == 9 || rem == 10) ? 5", "(rem == 5 || rem == 9 || rem == 10 || rem == 11) ? 5",
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
SELECT_VARIANTS = {  # edits of csrc/select_kernel.cu, or (file under the package, old, new)
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
    "no top-K chain": [(  # one top-K winner
        "  for (int i = 0; i < top_k; ++i) {",
        "  for (int i = 0; i < 1; ++i) {",
    ), (
        "  for (int i = lane; i < top_k; i += 32) {",
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
    "no table pass": [(  # made-up leaves: the chains alone, re-reducing leaves of the real rows
        "  const uint32_t cnt = leaf_table(rows + r * fft, leaf_w, w * n, n, lev, table + r * n_leaf);",
        "  for (int l = w * n + lane; l < (w + 1) * n; l += 32) {\n"
        "    table[r * n_leaf + l] = make_uint2(0x80000000u + l, (uint32_t)(l * leaf_w));\n  }\n"
        "  const uint32_t cnt = lev > 0.0f ? 0u : 1u;",
    )],
    "chains a warp a block": [(  # the row-split form's chain kernel in blocks of one warp
        "__launch_bounds__(kSplitThreads)\nselection_chain(", "__launch_bounds__(32)\nselection_chain(",
    ), (
        "selection_chain<T><<<n_rows, kSplitThreads, smem, s>>>(", "selection_chain<T><<<n_rows, 32, smem, s>>>(",
    )],
    "a warp a row throughout": [(
        SELECT_PY, "or not 0 < n_rows <= SPLIT_MAX_ROWS:", "or True:",
    )],
    "split to 2048 rows": [(  # the row-split form up to 2048 rows, at least 2 warps a row
        SELECT_PY, "or not 0 < n_rows <= SPLIT_MAX_ROWS:", "or not 0 < n_rows <= SPLIT_WARPS:",
    ), (
        SELECT_PY, "return min(1 << ((SPLIT_WARPS // n_rows).bit_length() - 1), runs)",
        "return min(max(2, 1 << ((SPLIT_WARPS // n_rows).bit_length() - 1)), runs)",
    )],
}
SCRATCH_SIZES = tuple(f"2^{log}" for log in range(18, 23))
# (frames, fft, decim): the main paths, step 12d's block, 16 frames of each scratch size
PSD_SHAPES = {"path1": (1080, 131072, 3), "path2": (1800, 16384, 2), "491": (16, 1 << 21, 4),
              **{name: (16, 1 << int(name[2:]), 4) for name in SCRATCH_SIZES}}
# (rows, fft, submargin): the main paths, step 12d's rows, a time shard's, a band shard's and the
# wideband step's; any other as ROWSxFFT (submargin 52)
SELECT_SHAPES = {"path1": (1080, 131072, 52), "path2": (1800, 16384, 110), "491": (16, 1 << 21, 64),
                 "time-shard": (45, 131072, 52), "band-shard": (180, 131072, 52),
                 "wideband": (360, 131072, 52)}
FIR_SHAPES = {"path1": (40, 34560), "path2": (75, 1228800)}  # (M, samples a row), 48 x 2 rows
ALIASES = {"scratch": SCRATCH_SIZES}


def make_variant(kernel: str, name: str, edits) -> Path:
    """A copy of this checkout's package with the edits made: (old, new) in
    the kernel's source, or (file, old, new)."""
    dst = ROOT / "build" / "psd_split" / f"{kernel}_{name.replace(' ', '_')}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "rtl_sdr_scanner_tpu_torch", dst / "rtl_sdr_scanner_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    for edit in edits:
        src, old, new = edit if len(edit) == 3 else (CSRC + KERNELS[kernel][0], *edit)
        path = dst / src
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"psd_phase_split: variant {name!r} no longer matches {src}: {old.strip()[:60]}")
        path.write_text(text.replace(old, new))
    return dst


def timed(fn, reps: int, kernel: str) -> str:
    """The wrapper's pace and the kernel's device time, as text."""
    import chip_smoke as cs

    ms = cs.cuda_ms(fn, reps)
    return f"{ms:.4f} ms a call, device {cs.device_ms(fn, reps, kernel):.4f} ms"


def time_fir(reps: int, shapes) -> None:
    import torch

    from rtl_sdr_scanner_tpu_torch.ops import ddc
    from rtl_sdr_scanner_tpu_torch.ops.cuda import fir_kernel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for name in shapes:
        m, n = FIR_SHAPES[name]
        plan = ddc.plan_stage(1, m)
        x = torch.randn((48, 2, n), generator=gen, device="cuda")
        tail = torch.randn((48, 2, plan.tail_len), generator=gen, device="cuda")
        print(f"  {name} [96, {n}] M={m}: kernel {timed(lambda: fir_kernel.stage_apply_fir(x, tail, plan), reps, 'fir_decimate')}",
              flush=True)


def select_shape(name: str):
    """(rows, fft, submargin) of a named selection shape or of ROWSxFFT."""
    if name in SELECT_SHAPES:
        return SELECT_SHAPES[name]
    rows, fft = (int(v) for v in name.split("x"))
    return rows, fft, 52


def time_select(reps: int, shapes) -> None:
    import torch

    import chip_smoke as cs
    from rtl_sdr_scanner_tpu_torch.drivers import LEVEL
    from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    level = torch.tensor(LEVEL, device="cuda")
    for name in shapes:
        rows, fft, submargin = select_shape(name)
        t = torch.randn((rows, fft), generator=gen, device="cuda").mul_(6.0).to(torch.bfloat16)
        call = lambda: select_kernel.fused_selection(t, level, cs.TOP_K, 16, submargin)  # noqa: E731
        print(f"  {name} [{rows}, {fft}] bf16: kernel {timed(call, reps, 'selection_')}", flush=True)
        del t


def time_psd(reps: int, shapes) -> None:
    import torch

    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel
    from rtl_sdr_scanner_tpu_torch.ops.psd import shifted_window

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for name in shapes:
        frames, fft, decim = PSD_SHAPES[name]
        iq = torch.randint(-100, 100, (frames, fft * decim, 2), generator=gen, device=dev, dtype=torch.int8)
        win = torch.from_numpy(shifted_window(fft)).to(dev)
        frames_c = torch.complex(iq[:, :fft, 0].float() / 127.5, iq[:, :fft, 1].float() / 127.5) * win
        kernel = timed(lambda: psd_kernel.psd_frames_int8(iq, 2.0e7, fft, decim), reps, "psd_")
        library = timed(lambda: torch.fft.fft(frames_c), reps, "")  # every record: cuFFT's kernels
        print(f"  {name} [{frames}, {fft}] decim {decim}: kernel {kernel}; torch.fft.fft alone {library}",
              flush=True)
        del iq, frames_c


# kernel -> (source under csrc/, its variants, timing at the shapes)
KERNELS = {
    "psd": ("psd_kernel.cu", PSD_VARIANTS, time_psd),
    "fir": ("fir_kernel.cu", FIR_VARIANTS, time_fir),
    "select": ("select_kernel.cu", SELECT_VARIANTS, time_select),
}
SHAPES = {"psd": PSD_SHAPES, "fir": FIR_SHAPES, "select": SELECT_SHAPES}


def time_one(root: str, reps: int, kernel: str, shapes) -> int:
    """In this process: the package under root, timed at the shapes."""
    sys.path.insert(0, root)
    sys.path.insert(1, str(ROOT))  # chip_smoke.py's timers
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    build.library()
    KERNELS[kernel][2](reps, shapes)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="psd", help="the kernel to split")
    ap.add_argument("--shape", action="append", default=[], help="a named shape (SHAPES, or 'scratch')")
    ap.add_argument("--root", action="append", default=[], help="another checkout to time as it is")
    ap.add_argument("--variant", action="append", default=[], help="keep only these variants")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--time-one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    shapes = [s for name in (args.shape or ["path1", "path2"]) for s in ALIASES.get(name, (name,))]
    unknown = [s for s in shapes
               if s not in SHAPES[args.kernel] and not (args.kernel == "select" and re.fullmatch(r"\d+x\d+", s))]
    if unknown:
        ap.error(f"no {args.kernel} shape {unknown}: {sorted(SHAPES[args.kernel])}")
    if args.time_one:
        return time_one(args.time_one, args.reps, args.kernel, shapes)
    import torch

    if not torch.cuda.is_available():
        print("psd_phase_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    variants = KERNELS[args.kernel][1]
    if args.variant:
        missing = set(args.variant) - set(variants)
        if missing:
            ap.error(f"no variant {sorted(missing)}: {sorted(variants)}")
        variants = {name: edits for name, edits in variants.items() if name in args.variant}
    runs = [("as is", ROOT)] + [(f"--root {r}", Path(r).resolve()) for r in args.root]
    runs += [(name, make_variant(args.kernel, name, edits)) for name, edits in variants.items()]
    runs.append(("as is, again", ROOT))
    print(f"{args.kernel} kernel on {card}", flush=True)
    failed = 0
    for name, root in runs:
        print(f"{name}:", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--time-one", str(root), "--reps", str(args.reps),
                             "--kernel", args.kernel, *[f"--shape={s}" for s in shapes]]).returncode
        if rc:
            print(f"  {name}: failed (rc {rc})", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
