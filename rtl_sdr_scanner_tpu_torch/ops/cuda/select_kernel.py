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


def leaf_width(fft: int) -> int:
    """Bins a leaf of the kernel's two-level table for rows of ``fft`` bins:
    32 (one a lane), doubled while the row has more than MAX_LEAVES leaves
    and the leaves still form whole groups (fft 131072: 128)."""
    width = LEAF_MIN
    while fft // width > MAX_LEAVES and (fft // width) % (2 * GROUPS) == 0:
        width *= 2
    return width


def takes_fft(fft: int) -> bool:
    """Whether the kernel's table fits rows of ``fft`` bins: whole warp loads
    of whole leaves (fft a multiple of 256), and whole groups of leaves where
    a row has more than 32 leaves (below, a group is a leaf). Every power of
    two from 256 up."""
    n_leaf = fft // leaf_width(fft)
    return fft > 0 and fft % FFT_MULTIPLE == 0 and (n_leaf <= GROUPS or n_leaf % GROUPS == 0)


def check_args(rows: torch.Tensor, top_k: int, k_sep: int, submargin: int) -> None:
    """Raise ValueError on what the kernel does not take."""
    if rows.dtype not in (torch.float32, torch.bfloat16) or rows.ndim != 2:
        raise ValueError(f"fused_selection: want [R, fft] f32/bf16, got {rows.dtype} {tuple(rows.shape)}")
    fft = rows.shape[1]
    if not takes_fft(fft) or not 1 <= top_k <= fft or not 1 <= k_sep <= MAX_K_SEP or submargin < 0:
        raise ValueError(
            f"fused_selection: fft {fft} must be a multiple of {FFT_MULTIPLE} (of {GROUPS * LEAF_MIN} "
            f"above {GROUPS} leaves), 1 <= top_k <= fft, 1 <= k_sep <= {MAX_K_SEP}, submargin >= 0"
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
    top_val = torch.empty((n_rows, top_k), dtype=rows.dtype, device=dev)
    top_idx = torch.empty((n_rows, top_k), dtype=torch.int32, device=dev)
    sep_val = torch.empty((n_rows, k_sep), dtype=rows.dtype, device=dev)
    sep_idx = torch.empty((n_rows, k_sep), dtype=torch.int32, device=dev)
    count = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_selection(
        rows.data_ptr(), int(rows.dtype == torch.bfloat16), level.data_ptr(),
        top_val.data_ptr(), top_idx.data_ptr(), sep_val.data_ptr(), sep_idx.data_ptr(),
        count.data_ptr(), n_rows, fft, leaf_width(fft), top_k, k_sep, submargin, _NEG[rows.dtype], stream,
    )
    check(rc, "fused_selection")
    fused_selection.launches += 1
    return top_val, top_idx, sep_val, sep_idx, count


fused_selection.launches = 0
