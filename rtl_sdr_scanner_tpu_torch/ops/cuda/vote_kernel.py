"""The history vote of compact detection: the hand-written kernel
(``csrc/vote_kernel.cu``) and its plain PyTorch version.

It replaces no TPU kernel: the JAX package leaves the vote to XLA
(``ops/detect.py``'s sliding-window tables, read at the candidates). For
each candidate of frame k, the first-max argmax of each history row k+h
(h < H, rows of prev_tail ++ raw) over the candidate's clamped window, a vote
where the window max clears the level in f32, then the mode of the votes
with the median-of-ties rule, or the candidate where none clears it:
``cand_best`` bit-equal between the kernel and the plain version
(``ops/detect.history_vote_plain``, whichever lowering ``VOTE_FORM`` picks).
"""

from __future__ import annotations

import torch

from rtl_sdr_scanner_tpu_torch.ops.detect import history_vote_plain

WARPS = 8  # candidates a block, a warp each (kWarps)
MAX_DEPTH = 512  # history rows a vote: the warps' shared slots (kMaxDepth)
DTYPES = (torch.float32, torch.bfloat16)


def check_args(
    raw: torch.Tensor, prev_tail: torch.Tensor, cand_idx: torch.Tensor, half: int, half_depth: int
) -> None:
    """Raise ValueError on what the kernel does not take."""
    if raw.dtype not in DTYPES or prev_tail.dtype not in DTYPES or raw.ndim != 3 or prev_tail.ndim != 3:
        raise ValueError(
            f"history_vote: want [NB, F, fft] and [NB, H-1, fft] rows in f32 or bf16, got {raw.dtype} "
            f"{tuple(raw.shape)} and {prev_tail.dtype} {tuple(prev_tail.shape)}"
        )
    nb, f, fft = raw.shape
    if prev_tail.shape != (nb, half_depth - 1, fft) or cand_idx.shape[:2] != (nb, f) or cand_idx.ndim != 3:
        raise ValueError(
            f"history_vote: rows {tuple(raw.shape)}, prev_tail {tuple(prev_tail.shape)} and candidates "
            f"{tuple(cand_idx.shape)} do not fit a history of {half_depth} rows"
        )
    if not 1 <= half_depth <= MAX_DEPTH or half < 0:
        raise ValueError(f"history_vote: want 1 <= half_depth <= {MAX_DEPTH} and half >= 0")
    if cand_idx.dtype != torch.int32 or not cand_idx.is_contiguous():
        raise ValueError("history_vote: candidates must be contiguous int32")
    if raw.stride(2) != 1 or prev_tail.stride(2) != 1:
        raise ValueError("history_vote: rows must have stride 1 along the bins")
    if nb * f * cand_idx.shape[2] >= 2**31:
        raise ValueError("history_vote: more than 2^31 - 1 candidates")
    if prev_tail.device != raw.device or cand_idx.device != raw.device:
        raise ValueError("history_vote: rows and candidates on different devices")


def launch_args(
    raw: torch.Tensor,
    prev_tail: torch.Tensor,
    cand_idx: torch.Tensor,
    level: torch.Tensor,
    out: torch.Tensor,
    half: int,
    half_depth: int,
    bf16: bool,
) -> tuple:
    """The C entry point's arguments but the stream (``csrc/vote_kernel.cu``
    ``history_vote``). The history is voted in bf16 where ``bf16`` or where
    the rows are bf16 (``cat`` takes prev_tail to the rows' dtype)."""
    nb, f, fft = raw.shape
    is_bf16 = lambda t: int(t.dtype == torch.bfloat16)
    return (
        prev_tail.data_ptr(), is_bf16(prev_tail), prev_tail.stride(0), prev_tail.stride(1),
        raw.data_ptr(), is_bf16(raw), raw.stride(0), raw.stride(1),
        cand_idx.data_ptr(), level.data_ptr(), out.data_ptr(),
        nb, f, cand_idx.shape[2], half_depth, fft, half, int(bf16 or raw.dtype == torch.bfloat16),
    )


def history_vote(
    raw: torch.Tensor,
    prev_tail: torch.Tensor,
    cand_idx: torch.Tensor,
    half: int,
    level: torch.Tensor,
    half_depth: int,
    bf16: bool,
) -> torch.Tensor:
    """raw [NB, F, fft] and prev_tail [NB, H-1, fft] rows (f32 or bf16, any
    band and row strides), cand_idx [NB, F, K] int32, level a 0-d f32 tensor
    -> cand_best [NB, F, K] int32.

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``history_vote.launches``); on a CPU tensor it runs the plain version.
    """
    if raw.device.type == "cpu":
        return history_vote_plain(raw, prev_tail, cand_idx, half, level, half_depth, bf16)
    if raw.device.type != "cuda":
        raise ValueError(f"history_vote: unsupported device {raw.device}")
    check_args(raw, prev_tail, cand_idx, half, half_depth)
    dev = raw.device
    out = torch.empty(cand_idx.shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lvl = level.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = library().history_vote(*launch_args(raw, prev_tail, cand_idx, lvl, out, half, half_depth, bf16), stream)
    check(rc, "history_vote")
    history_vote.launches += 1
    return out


history_vote.launches = 0
