"""Plain analysis channelizer: one wideband stream split into B channels by
the critically sampled DFT filter bank, written from the published math
and independent of the program (float64 arithmetic).

With R the wideband rate, branch signals x_p[m] = x[mB + p] and branch
filters h_p[j] = h[jB - p] of a prototype low-pass h, channel b is

    y_b[m] = sum_p e^{-j 2 pi b p / B} (x_p conv h_p)[m],   p = 0 .. B-1,

the B-point DFT over the branches of the branch filters' outputs: the
sub-band centred at +b R / B (b above B/2 wraps to a negative offset),
mixed to 0 Hz, low-pass filtered by h and decimated by B. The prototype is
GNU Radio's ``firdes::low_pass`` (``reference/ddc.firdes_low_pass``: a
Kaiser-windowed sinc of unit DC gain) at sampling frequency B, cutoff 0.5
(half the channel spacing) and transition 0.2.

A block's channels depend on that block and the last ``history_len(B)``
input samples before it, so they are worked out from the wideband inputs
alone: the block, and the tail of the block before it.

Departures from the published math, each a choice of units or of start:
- int8 cs8 input is read as value / 127.5 (the cs8 codec), and the
  channels come out in cs8 units (times 127.5), so that ``reference/scan``
  and ``reference/ddc``, which divide by 127.5, take them unchanged;
- the stream is zero before its first sample (a bank started from rest);
- the branch filters are zero-padded to a whole number of taps, so that
  every branch has ``taps_per_branch(B)`` of them.

``tf32_operands`` rounds the input samples and the branch taps to TF32
(the control's precision, one below the configured float32) and keeps the
rest in float64: the products of a TF32 tensor-core bank, whose rounding
of its operands is what its error is made of.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from benchmark.reference.ddc import firdes_low_pass, tf32

CUTOFF, TRANSITION = 0.5, 0.2  # of the channel spacing: the critically sampled bank
CS8 = 127.5


@lru_cache(maxsize=8)
def prototype(channels: int) -> np.ndarray:
    """The prototype low-pass h (float64)."""
    return firdes_low_pass(1.0, float(channels), CUTOFF, TRANSITION)


@lru_cache(maxsize=8)
def branch_filters(channels: int) -> np.ndarray:
    """[B, T] float64: row p holds h_p[j] = h[jB - p] for j = 0 .. T-1."""
    h, b = prototype(channels), channels
    t = taps_per_branch(b)
    out = np.zeros((b, t))
    for p in range(b):
        for j in range(t):
            if 0 <= j * b - p < len(h):
                out[p, j] = h[j * b - p]
    return out


def taps_per_branch(channels: int) -> int:
    """Taps a branch filter holds: every tap of h, h_p reaching j*B - p =
    len(h) - 1 for the largest p."""
    return -(-(len(prototype(channels)) + channels - 1) // channels)


def history_len(channels: int) -> int:
    """Input samples before a block that reach its channels."""
    return (taps_per_branch(channels) - 1) * channels


def channel_offsets_hz(channels: int, rate: int) -> np.ndarray:
    """[B] int64 centre of each channel from the wideband centre, Hz:
    +b R / B, wrapped above B/2."""
    k = np.arange(channels)
    return np.where(k <= channels // 2, k, k - channels) * (rate // channels)


def _complex(x: torch.Tensor, tf32_operands: bool) -> torch.Tensor:
    """[n, 2] int8 cs8 or float in cs8 units -> [n] complex128 at 1/127.5."""
    v = x.to(torch.float64) / CS8
    if tf32_operands:
        v = tf32(v.to(torch.float32)).to(torch.float64)
    return torch.complex(v[:, 0], v[:, 1])


def channelize(block: torch.Tensor, before: Optional[torch.Tensor], channels: int,
               tf32_operands: bool = False) -> torch.Tensor:
    """The channels of one wideband block.

    block: [n, 2] int8 cs8 (n a multiple of B); before: the stream's samples
    before the block, [at least history_len(B), 2] (None or short: zeros
    before the stream's first sample). Returns [B, n / B, 2] float64 in cs8
    units, channel b centred at ``channel_offsets_hz(B, R)[b]``."""
    b = channels
    n = block.shape[0]
    if n % b:
        raise ValueError(f"a block of {n} samples does not split into {b} channels")
    hist = history_len(b)
    x = _complex(block, tf32_operands)
    prev = torch.zeros(hist, dtype=torch.complex128, device=block.device)
    if before is not None and before.shape[0]:
        have = min(hist, before.shape[0])
        prev[hist - have:] = _complex(before[-have:], tf32_operands)
    ext = torch.cat([prev, x])  # sample i of ext is stream sample i - hist
    taps = torch.from_numpy(branch_filters(b)).to(block.device)
    if tf32_operands:
        taps = tf32(taps.to(torch.float32)).to(torch.float64)
    branches = ext.reshape(-1, b).T  # [B, hist / B + n / B]: branch p, times m - hist / B ..
    m, lead = n // b, hist // b
    v = torch.zeros((b, m), dtype=torch.complex128, device=block.device)
    for j in range(taps.shape[1]):  # (x_p conv h_p)[m] = sum_j h_p[j] x_p[m - j]
        v += taps[:, j: j + 1] * branches[:, lead - j: lead - j + m]
    y = torch.fft.fft(v, dim=0)  # sum_p e^{-j 2 pi b p / B} v_p
    return torch.stack([y.real, y.imag], dim=-1) * CS8
