"""Plain recorder bank: each slot's shift to baseband and its rational
resampler cascade, written from the semantics the configuration states and
independent of the program.

A slot tuned to ``shift`` Hz rotates the full-rate stream by
exp(i * phase(n)), phase(n) = phi_c + 2 pi ((-shift mod rate) * (n - c * chunk)
mod rate) / rate for sample n of chunk c, where phi_c is the NCO phase
carried in float32 from chunk to chunk (phi_0 = 0, phi_{c+1} =
fmod(f32(phi_c + step), f32(2 pi))): the configuration's carried phase, and
the chunking of its DDC (``ddc_phase_chunk_target``). Each stage (L, M) then
computes y[o] = sum_j h[j] up(x)[o M - j] with up(x)[i L] = x[i] (zeros
between), h GNU Radio's rational_resampler default filter, causal from the
stream's first sample, and the output is round(127 y) saturated to int8.

A block's outputs depend on that block and a short history of the one before
it, so the bank runs over [history of block b-1, block b] from a zero state
and keeps the outputs of block b: no carried state of the program is read.

A slot that starts a recording at a block counts its NCO phase from that
block's first sample (phi = 0 there). In the modulated-taps form
(``ddc_restart_reads_history`` in the configuration) its stage 1 reads the
stream's samples before that block, as a filter that never stopped, with
the phase run backwards from 0, and its later stages start from zero; in
the v1 form every stage starts from zero at that block.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def firdes_low_pass(gain: float, sampling_freq: float, cutoff: float, transition_width: float,
                    beta: float = 7.0) -> np.ndarray:
    """GNU Radio firdes::low_pass: a Kaiser-windowed sinc, unit DC gain times ``gain``."""
    attenuation = beta / 0.1102 + 8.7
    ntaps = int(attenuation * sampling_freq / (22.0 * transition_width))
    if ntaps % 2 == 0:
        ntaps += 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw = 2.0 * np.pi * cutoff / sampling_freq
    taps = np.where(n == 0, fw / np.pi, np.sin(n * fw) / np.where(n == 0, 1.0, n * np.pi))
    taps = taps * np.kaiser(ntaps, beta)
    return taps * (gain / (taps[m] + 2.0 * np.sum(taps[m + 1:])))


@lru_cache(maxsize=32)
def resampler_taps(interp: int, decim: int) -> np.ndarray:
    """GNU Radio's rational_resampler default filter (fractional bandwidth 0.4)."""
    if interp == 1 and decim == 1:
        return np.ones(1)
    rate = interp / decim
    if rate >= 1.0:
        trans = 0.5 - 0.4
        mid = 0.5 - trans / 2.0
    else:
        trans = rate * (0.5 - 0.4)
        mid = rate * 0.5 - trans / 2.0
    return firdes_low_pass(interp, interp, mid, trans)


def block_multiple(stages: Sequence[Tuple[int, int]]) -> int:
    """Smallest input length that every stage consumes in whole samples."""
    need, num, den = 1, 1, 1
    for interp, decim in stages:
        num, den = num * interp, den * decim
        g = math.gcd(num, den)
        num, den = num // g, den // g
        need = need * den // math.gcd(need, den)
    return need


def output_length(n: int, stages: Sequence[Tuple[int, int]]) -> int:
    for interp, decim in stages:
        n = n * interp // decim
    return n


def phase_chunk(block: int, stages: Sequence[Tuple[int, int]], target: int) -> int:
    """The DDC's chunk: the block halved while above ``target`` and the half
    is still whole in every stage."""
    mult, chunk = block_multiple(stages), block
    while chunk > target and chunk % 2 == 0 and (chunk // 2) % mult == 0:
        chunk //= 2
    return chunk


def history(stages: Sequence[Tuple[int, int]]) -> int:
    """Input samples before a block that reach its outputs, rounded up to a
    whole multiple of the chain."""
    need, ratio = 0, 1.0  # ratio: stage-1 input samples a stage input sample
    for interp, decim in stages:
        need += math.ceil(len(resampler_taps(interp, decim)) / interp * ratio) + 1
        ratio = ratio * decim / interp
    mult = block_multiple(stages)
    return mult * -(-need // mult)


@lru_cache(maxsize=64)
def carried_phase(shift: int, rate: int, chunk: int, chunks: int) -> np.ndarray:
    """[chunks] float32 NCO phase at the start of chunks 0..chunks-1."""
    smod = (-int(shift)) % rate
    step = np.float32(((smod * chunk) % rate) * (2.0 * np.pi / rate))
    two_pi = np.float32(2.0 * math.pi)
    out = np.zeros(chunks, dtype=np.float32)
    p = np.float32(0.0)
    for c in range(1, chunks):
        p = np.fmod(np.float32(p + step), two_pi)
        out[c] = p
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _stage(x: torch.Tensor, interp: int, decim: int, tf32_operands: bool) -> torch.Tensor:
    """One causal resampler stage over rows [R, n] f32 -> [R, n * L / M]."""
    h = torch.from_numpy(resampler_taps(interp, decim)[::-1].copy()).to(x.device, torch.float32)
    if tf32_operands:
        x, h = tf32(x), tf32(h)
    if interp > 1:
        up = x.new_zeros((x.shape[0], x.shape[1] * interp))
        up[:, ::interp] = x
        x = up
    xp = F.pad(x[:, None, :], (h.numel() - 1, 0))
    return F.conv1d(xp, h.view(1, 1, -1), stride=decim)[:, 0]


def record_block(segment: torch.Tensor, seg_start: int, keep: int, shifts: np.ndarray, rate: int,
                 stages: Sequence[Tuple[int, int]], chunk: int, tf32_operands: bool = False) -> torch.Tensor:
    """The bank over one band's segment.

    segment: [n, 2] int8 cs8 samples whose first is sample ``seg_start``
    (a multiple of the chain's ``block_multiple``) counted from where the
    NCO phase starts; shifts [K] Hz; returns [K, keep, 2] float32 outputs
    scaled by 127 (before rounding), the last ``keep`` of the segment's. A
    negative ``seg_start`` is a restarted slot's history: stage 1 reads it
    with the phase run backwards, and its outputs for it are dropped before
    the later stages. ``tf32_operands`` rounds every product's operands to
    TF32 (the control's precision)."""
    dev = segment.device
    n = segment.shape[0]
    x = segment.to(torch.float64) / 127.5
    xc = torch.complex(x[:, 0], x[:, 1])
    idx = torch.arange(seg_start, seg_start + n, dtype=torch.int64, device=dev)
    chunk_of = torch.clamp(torch.div(idx, chunk, rounding_mode="floor"), min=0)
    chunks_needed = max(int((seg_start + n - 1) // chunk) + 1, 1)
    rel = idx - chunk_of * chunk
    outs = []
    for shift in shifts:
        smod = (-int(shift)) % rate
        phi = torch.from_numpy(carried_phase(int(shift), rate, chunk, chunks_needed).astype(np.float64)).to(dev)
        ang = phi[chunk_of] + torch.remainder(rel * smod, rate).to(torch.float64) * (2.0 * math.pi / rate)
        z = xc * torch.polar(torch.ones_like(ang), ang)
        rows = torch.stack([z.real, z.imag]).to(torch.float32)  # [2, n]
        for i, (interp, decim) in enumerate(stages):
            rows = _stage(rows, interp, decim, tf32_operands)
            if i == 0 and seg_start < 0:
                rows = rows[:, -seg_start * interp // decim:]
        outs.append(rows[:, -keep:].T * 127.0)
        del z, ang, rows
    return torch.stack(outs)


def stages_of(config: dict) -> List[Tuple[int, int]]:
    return [tuple(s) for s in config["ddc_stages"]]
