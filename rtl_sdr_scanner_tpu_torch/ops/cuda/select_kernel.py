"""Fused candidate selection: the hand-written kernel
(``csrc/select_kernel.cu``) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/select_kernel.py``
(``fused_selection``): per row, the exact top-K (value descending,
first-occurrence ties), the K_SEP greedy margin-separated winners and the
count of bins >= level (level cast to the row dtype), bit-exact between the
kernel and the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rtl_sdr_scanner_tpu_torch.ops.detect import (
    SUPPRESSED,
    _margin_separated_top,
    count_at_level,
    top_k_exact,
)

GROUPS = 32  # groups of leaves in the kernel's table (at most one a lane of its warp)
LEAF_MIN = 32  # bins a leaf at least (one a lane)
LEAVES_A_LOAD = 8  # one warp load of the table pass spans 8 leaves
FFT_MULTIPLE = LEAVES_A_LOAD * LEAF_MIN  # fft must be a multiple (256): whole loads of whole leaves
MAX_LEAVES = 1024  # leaves widen (doubling) while a row has more
MAX_K_SEP = 32  # margin winners: the kernel tests a bin against the zones, a lane a zone
SMALL_MAX_FFT = 128  # rows of at most this many bins take the register form (4 bins a lane)
# the row-split form: rows of 2^17-2^24 bins (the PSD kernel's largest fft)
# too few to fill the card with a warp each
SPLIT_MIN_FFT = 1 << 17
SPLIT_MAX_FFT = 1 << 24
SPLIT_LEAF_WIDTH = 256  # its leaves: a 16-byte piece a lane in bf16, two in f32
SPLIT_MAX_LEAVES = 16384  # a row's table in its chain block's shared memory: 128 KB
SPLIT_WARPS = 2048  # rows x slices it aims at: ~16 warps on each of 132 SMs
# the most rows it takes: its chain kernel's blocks (8 warps, one running the
# chains) fit ~3 an SM, 396 rows a wave on 132 SMs; on the H100 the split
# wins up to 360 rows, ties at 384 and takes 1.6-2x a warp a row's time
# from 512 (PERF.md §6)
SPLIT_MAX_ROWS = 384


def leaf_width(fft: int) -> int:
    """Bins a leaf of the kernel's two-level table for rows of ``fft`` bins:
    32 (one a lane), doubled while the row has more than MAX_LEAVES leaves
    and the leaves still form whole groups (fft 131072: 128)."""
    width = LEAF_MIN
    while fft // width > MAX_LEAVES and (fft // width) % (2 * GROUPS) == 0:
        width *= 2
    return width


def split_leaf_width(fft: int) -> int:
    """Bins a leaf of the row-split form's table for rows of ``fft`` bins:
    SPLIT_LEAF_WIDTH, doubled while the row has more than SPLIT_MAX_LEAVES
    leaves (2^23: 512, 2^24: 1024), so that the table fits the chain
    block's shared memory."""
    width = SPLIT_LEAF_WIDTH
    while fft // width > SPLIT_MAX_LEAVES:
        width *= 2
    return width


def row_slices(n_rows: int, fft: int) -> int:
    """Warps that build one row's table in the kernel's row-split form, or 0
    where a warp a row runs (the warp-a-row form). The split takes
    power-of-two rows of SPLIT_MIN_FFT-SPLIT_MAX_FFT bins, at most
    SPLIT_MAX_ROWS of them: the largest power of two up to SPLIT_WARPS /
    n_rows, at most one warp a run of LEAVES_A_LOAD leaves (16 rows of 2^21:
    128; 45 of 131072: 32; 180: 8; 360: 4)."""
    if not SPLIT_MIN_FFT <= fft <= SPLIT_MAX_FFT or fft & (fft - 1) or not 0 < n_rows <= SPLIT_MAX_ROWS:
        return 0
    runs = fft // split_leaf_width(fft) // LEAVES_A_LOAD
    return min(1 << ((SPLIT_WARPS // n_rows).bit_length() - 1), runs)


def takes_fft(fft: int) -> bool:
    """Whether the kernel takes rows of ``fft`` bins: any row of at most 128
    bins (its register form, a row held in its warp's registers), and above
    that rows its table fits: whole warp loads of whole leaves (fft a
    multiple of 256), and whole groups of leaves where a row has more than
    32 leaves (below, a group is a leaf). Every power of two."""
    if 0 < fft <= SMALL_MAX_FFT:
        return True
    n_leaf = fft // leaf_width(fft)
    return fft > 0 and fft % FFT_MULTIPLE == 0 and (n_leaf <= GROUPS or n_leaf % GROUPS == 0)


def check_args(rows: torch.Tensor, top_k: int, k_sep: int, submargin: int) -> None:
    """Raise ValueError on what the kernel does not take."""
    if rows.dtype not in (torch.float32, torch.bfloat16) or rows.ndim != 2:
        raise ValueError(f"fused_selection: want [R, fft] f32/bf16, got {rows.dtype} {tuple(rows.shape)}")
    fft = rows.shape[1]
    if not takes_fft(fft) or not 1 <= top_k <= fft or not 1 <= k_sep <= MAX_K_SEP or submargin < 0:
        raise ValueError(
            f"fused_selection: fft {fft} must be at most {SMALL_MAX_FFT} or a multiple of {FFT_MULTIPLE} "
            f"(of {GROUPS * LEAF_MIN} above {GROUPS} leaves), 1 <= top_k <= fft, 1 <= k_sep <= {MAX_K_SEP}, "
            "submargin >= 0"
        )
    if not rows.is_contiguous() or rows.data_ptr() % 16 != 0:
        raise ValueError("fused_selection: rows must be contiguous and 16-byte aligned")


_NEG = {dtype: float(torch.tensor(SUPPRESSED, dtype=dtype)) for dtype in (torch.float32, torch.bfloat16)}

Selection = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_selection_plain(
    rows: torch.Tensor, start_level: torch.Tensor, top_k: int, k_sep: int, submargin: int
) -> Selection:
    """(top_val [R, top_k], top_idx, sep_val [R, k_sep], sep_idx, count [R]);
    values in the row dtype, indices and count int32."""
    top_val, top_idx = top_k_exact(rows, top_k)
    sep_val, sep_idx = _margin_separated_top(rows, k_sep, submargin)
    return top_val, top_idx, sep_val, sep_idx, count_at_level(rows, start_level)


def fused_selection(
    rows: torch.Tensor, start_level: torch.Tensor, top_k: int, k_sep: int, submargin: int
) -> Selection:
    """rows [R, fft] f32 or bf16; start_level a 0-d f32 tensor.

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``fused_selection.launches``); on a CPU tensor it runs the plain version.
    """
    if rows.device.type == "cpu":
        return fused_selection_plain(rows, start_level, top_k, k_sep, submargin)
    if rows.device.type != "cuda":
        raise ValueError(f"fused_selection: unsupported device {rows.device}")
    check_args(rows, top_k, k_sep, submargin)
    n_rows, fft = rows.shape
    level = start_level.to(device=rows.device, dtype=torch.float32).reshape(1).contiguous()
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    lib = library()
    dev = rows.device
    slices = row_slices(n_rows, fft)
    leaf_w = split_leaf_width(fft) if slices else leaf_width(fft)
    # the row-split form's scratch, one allocation: the leaf table ((key,
    # bin) pairs, 8 bytes each) and then each warp's int32 count
    table_len = n_rows * (fft // leaf_w)
    scratch = torch.empty((table_len + (n_rows * slices + 1) // 2,), dtype=torch.int64, device=dev) if slices else None
    table = scratch.data_ptr() if slices else None
    part_count = table + 8 * table_len if slices else None
    top_val = torch.empty((n_rows, top_k), dtype=rows.dtype, device=dev)
    top_idx = torch.empty((n_rows, top_k), dtype=torch.int32, device=dev)
    sep_val = torch.empty((n_rows, k_sep), dtype=rows.dtype, device=dev)
    sep_idx = torch.empty((n_rows, k_sep), dtype=torch.int32, device=dev)
    count = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_selection(
        rows.data_ptr(), int(rows.dtype == torch.bfloat16), level.data_ptr(),
        top_val.data_ptr(), top_idx.data_ptr(), sep_val.data_ptr(), sep_idx.data_ptr(),
        count.data_ptr(), n_rows, fft, leaf_w, top_k, k_sep, submargin, _NEG[rows.dtype], slices,
        table, part_count, stream,
    )
    check(rc, "fused_selection")
    fused_selection.launches += 1
    return top_val, top_idx, sep_val, sep_idx, count


fused_selection.launches = 0
