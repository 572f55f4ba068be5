"""Decimating FIR stage: the hand-written kernel (``csrc/fir_kernel.cu``)
and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/fir_kernel.py``
(``stage_apply_pallas``): one decimation-only resampler stage on [B, 2, n]
f32 rows with an overlap-save tail,

    y[b, p] = sum_q sum_r rows[b, p + q, r] * W[r, q],

rows = (tail ++ x ++ zeros) viewed as [B, out + R - 1, M] and W the
[M, R] reversed-tap polyphase matrix (``plan.poly_kernel[0]``). The
kernel's note says what bounds it on the card and what its design does
about it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

RP = 40  # taps padded to the kernel's 5 n-tiles of 8 (R <= 34 for every decimation)


def _full_rows(x: torch.Tensor, tail: torch.Tensor, m: int, r_rows: int) -> torch.Tensor:
    """tail ++ x ++ zeros as [B*2, out + R - 1, M]."""
    b, two, n = x.shape
    need = (n // m + r_rows - 1) * m
    pad = x.new_zeros((b, two, need - n - tail.shape[-1]))
    return torch.cat([tail, x, pad], dim=-1).reshape(b * two, -1, m)


def _new_tail(x: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """(tail ++ x)[..., n : n + tail_len], a copy (no view keeps x alive)."""
    n, t = x.shape[-1], tail.shape[-1]
    if n >= t:
        return x[..., n - t :].contiguous()
    return torch.cat([tail[..., n:], x], dim=-1)


def stage_apply_fir_plain(
    x: torch.Tensor, tail: torch.Tensor, plan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z = rows @ W, then the lag-diagonal sum y[p] = sum_q Z[p + q, q]."""
    b, two, n = x.shape
    m, r_rows = plan.decim, plan.poly_rows
    out_len = n // m
    w = torch.from_numpy(plan.poly_kernel[0]).to(x.device)  # [M, R]
    z = torch.matmul(_full_rows(x, tail, m, r_rows), w)  # [B*2, out + R - 1, R]
    y = z[:, 0:out_len, 0]
    for q in range(1, r_rows):
        y = y + z[:, q : q + out_len, q]
    return y.reshape(b, two, out_len), _new_tail(x, tail)


def tf32_round(a: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties
    away from zero): the low 13 mantissa bits become zero."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_weights(decim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(W_hi, W_lo), each [Mp, RP] f32 with Mp = 8 * ceil(M / 8): W zero-padded
    to the kernel's product shape, W_hi = tf32(W), W_lo = tf32(W - W_hi).
    W - W_hi is exact in f32; its TF32 rounding drops at most two of W's 24
    significant bits (the kernel's third pass, x_hi * W_lo, needs a TF32
    operand)."""
    from rtl_sdr_scanner_tpu_torch.ops.ddc import plan_stage

    poly = plan_stage(1, decim).poly_kernel[0]  # [M, R]
    w = np.zeros((-(-decim // 8) * 8, RP), dtype=np.float32)
    w[:decim, : poly.shape[1]] = poly
    hi = tf32_round(w)
    return hi, tf32_round(w - hi)


def pack_fragments(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """[Mp, RP] halves -> [Mp / 8, RP / 8, 32, 4]: for k-step kk, n-tile nt
    and lane l (group g = l // 4, thread t = l % 4), the B operands of
    ``mma.m16n8k8`` TF32, W[kk*8 + t][nt*8 + g] and W[kk*8 + t + 4][nt*8 + g],
    of W_hi then of W_lo."""
    ks, nt = hi.shape[0] // 8, RP // 8
    lane = np.arange(32)
    t, g = lane % 4, lane // 4

    def operands(w):
        w4 = w.reshape(ks, 8, nt, 8).transpose(0, 2, 1, 3)  # [kk, nt, k in step, n in tile]
        return w4[:, :, t, g], w4[:, :, t + 4, g]  # each [kk, nt, 32]

    return np.ascontiguousarray(np.stack([*operands(hi), *operands(lo)], axis=-1))


@functools.lru_cache(maxsize=32)
def _weights(decim: int, device: torch.device) -> torch.Tensor:
    """The kernel's B fragments of W_hi and W_lo on device, uploaded once
    (``plan_stage`` is a function of (interp, decim) alone)."""
    return torch.from_numpy(pack_fragments(*split_weights(decim))).to(device)


def stage_apply_fir(
    x: torch.Tensor, tail: torch.Tensor, plan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, 2, n] f32, tail [B, 2, tail_len] -> (y [B, 2, n // M], new tail).

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``stage_apply_fir.launches``); on a CPU tensor it runs the plain version.
    The kernel takes any M (a window too large for a block's shared memory
    takes its wide form); a launch error raises.
    """
    if x.device.type == "cpu":
        return stage_apply_fir_plain(x, tail, plan)
    if x.device.type != "cuda":
        raise ValueError(f"stage_apply_fir: unsupported device {x.device}")
    if plan.interp != 1:
        raise ValueError(f"stage_apply_fir: decimation-only stages, got interp {plan.interp}")
    m, t = plan.decim, plan.tail_len
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[1] != 2 or x.shape[-1] % m != 0:
        raise ValueError(
            f"stage_apply_fir: want f32 [B, 2, n] with n % {m} == 0, got {x.dtype} {tuple(x.shape)}"
        )
    b, two, n = x.shape
    if tail.dtype != torch.float32 or tail.device != x.device or tuple(tail.shape) != (b, two, t):
        raise ValueError(f"stage_apply_fir: want an f32 tail [{b}, 2, {t}] on {x.device}")
    if not (x.is_contiguous() and tail.is_contiguous()):
        raise ValueError("stage_apply_fir: x and tail must be contiguous")
    w = _weights(m, x.device)
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    lib = library()
    out_len = n // m
    y = torch.empty((b, two, out_len), dtype=torch.float32, device=x.device)
    new_tail = torch.empty((b, two, t), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fir_decimate(
        x.data_ptr(), tail.data_ptr(), w.data_ptr(), y.data_ptr(), new_tail.data_ptr(),
        b * two, n, t, m, plan.poly_rows, out_len, stream,
    )
    check(rc, "fir_decimate")
    stage_apply_fir.launches += 1
    return y, new_tail


stage_apply_fir.launches = 0
