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

SEG_W = 1024  # bins per segment of the kernel's table

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
    if rows.dtype not in (torch.float32, torch.bfloat16) or rows.ndim != 2:
        raise ValueError(f"fused_selection: want [R, fft] f32/bf16, got {rows.dtype} {tuple(rows.shape)}")
    n_rows, fft = rows.shape
    if fft % SEG_W != 0 or fft < top_k or not rows.is_contiguous():
        raise ValueError(f"fused_selection: fft {fft} must be a multiple of {SEG_W}, rows contiguous")
    if 2 * submargin + 1 > SEG_W:
        raise ValueError("fused_selection: the suppression zone must span <= 2 segments")
    level = start_level.to(device=rows.device, dtype=torch.float32).reshape(1).contiguous()
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    lib = library()
    dev = rows.device
    top_val = torch.empty((n_rows, top_k), dtype=rows.dtype, device=dev)
    top_idx = torch.empty((n_rows, top_k), dtype=torch.int32, device=dev)
    sep_val = torch.empty((n_rows, k_sep), dtype=rows.dtype, device=dev)
    sep_idx = torch.empty((n_rows, k_sep), dtype=torch.int32, device=dev)
    count = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    neg = float(torch.tensor(SUPPRESSED, dtype=rows.dtype))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_selection(
        rows.data_ptr(), int(rows.dtype == torch.bfloat16), level.data_ptr(),
        top_val.data_ptr(), top_idx.data_ptr(), sep_val.data_ptr(), sep_idx.data_ptr(),
        count.data_ptr(), n_rows, fft, top_k, k_sep, submargin, neg, stream,
    )
    check(rc, "fused_selection")
    fused_selection.launches += 1
    return top_val, top_idx, sep_val, sep_idx, count


fused_selection.launches = 0
