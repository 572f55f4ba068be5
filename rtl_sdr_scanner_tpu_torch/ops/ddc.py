"""Digital down-converter: frequency shift + staged rational resampling
(port of the JAX package's ``ops/ddc.py``: the v1 path and the
modulated-taps path).

The planners are numpy and give arrays equal to the reference's. NCO and
modulated-tap angles come from int64 modular arithmetic on the host, so f32
never sees a large argument (computing them in f32 on the device would break
the <= 1 LSB int8 contract).

v1 (NCO + resampler cascade): the full-rate stream is rotated per slot from
the two-level NCO tables, then every stage runs in turn through
``_stage_apply``: decimation-only stages go to the decimating-FIR kernel's
wrapper (``ops/cuda/fir_kernel``), interpolating stages to a zero-stuffed
conv.

Modulated taps: stage 1 filters the RAW input with complex taps
g[j] = h[j] e^{-i inc j} and the NCO rotation runs at the decimated rate:
  y1[m] = e^{i(phi0 + inc M m)} sum_j (h[j] e^{-i inc j}) x[mM-j].
Stage 1 and its rotation go to the modulated-taps kernel's wrapper
(``ops/cuda/ddc_kernel``; on CPU tensors the chunked-matmul form below).
Stages 2+ run through ``_stage_apply`` as in v1. A reset slot keeps the
shared raw-x stage-1 history (see reset_slot2).

The chunked products here are f32 matrix products held to <= 1 LSB int8, so
TF32 is switched off wherever a DDC state or a block step is made
(``no_tf32``).
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rtl_sdr_scanner_tpu_torch.ops.cuda.ddc_kernel import mod_fragments, modtap_stage1
from rtl_sdr_scanner_tpu_torch.ops.cuda.fir_kernel import stage_apply_fir
from rtl_sdr_scanner_tpu_torch.ops.window import kaiser
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import get_resamplers_factors
from rtl_sdr_scanner_tpu_torch.utils.trace import span

# ---------------------------------------------------------------------------
# Filter design (GR-compatible)
# ---------------------------------------------------------------------------


def firdes_low_pass(
    gain: float, sampling_freq: float, cutoff: float, transition_width: float, beta: float = 7.0
) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, GNU Radio firdes::low_pass semantics."""
    attenuation = beta / 0.1102 + 8.7
    ntaps = int(attenuation * sampling_freq / (22.0 * transition_width))
    if ntaps % 2 == 0:
        ntaps += 1
    m = (ntaps - 1) // 2
    w = kaiser(ntaps, beta)
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw = 2.0 * np.pi * cutoff / sampling_freq
    denom = np.where(n == 0, 1.0, n * np.pi)
    taps = np.where(n == 0, fw / np.pi, np.sin(n * fw) / denom) * w
    dc = taps[m] + 2.0 * np.sum(taps[m + 1 :])
    return (taps * (gain / dc)).astype(np.float64)


@functools.lru_cache(maxsize=64)
def design_resampler_taps(interp: int, decim: int, fractional_bw: float = 0.4) -> np.ndarray:
    """GNU Radio rational_resampler default filter (design_resampler_filter)."""
    if interp == 1 and decim == 1:
        return np.ones(1, dtype=np.float64)
    halfband = 0.5
    rate = interp / decim
    if rate >= 1.0:
        trans_width = halfband - fractional_bw
        mid = halfband - trans_width / 2.0
    else:
        trans_width = rate * (halfband - fractional_bw)
        mid = rate * halfband - trans_width / 2.0
    return firdes_low_pass(interp, interp, mid, trans_width)


# ---------------------------------------------------------------------------
# Stage / chain plumbing
# ---------------------------------------------------------------------------


class StagePlan(NamedTuple):
    interp: int
    decim: int
    ntaps: int
    tail_len: int  # input-domain overlap-save tail: ceil((ntaps-1)/interp)
    kernel: np.ndarray  # reversed taps left-padded to tail_len*interp + 1 (f32)
    poly_kernel: np.ndarray  # [1, M, R] f32, kernel[0, r, q] = h_rev[q*M + r]
    poly_rows: int  # R
    # chunked-matmul form of a decimating stage 1 (the modulated-taps path):
    # input at offset Q inside a zero-padded buffer viewed as
    # [.., n_chunks, C]; Z = chunks @ W has column order d*P + b and
    # y[P*a + b] = sum_d Z[a + d, d*P + b]
    chunk_c: int  # C (0 = form unavailable)
    chunk_d: int  # D = number of chunk lags
    chunk_q: int  # Q = aligned input offset


def _plan_chunk_matmul(m: int, r_rows: int, tail_len: int):
    """Pick chunk width C = M*P, lags D and offset Q (the JAX package's
    choice, kept so the plans compare equal)."""
    cands = []
    p = 128
    while p >= 8:
        c = m * p
        if c <= 8192 and c % 128 == 0:
            q = -(-tail_len // 128) * 128
            s = q - tail_len
            d = -(-(s + (p - 1) * m + r_rows * m) // c)
            d = max(d, 1 + -(-q // c))
            cands.append((c, p, d, q, s))
        p //= 2
    best = None
    for cap in (128, 256, 512):
        fitting = [t for t in cands if t[1] * t[2] <= cap]
        if fitting:
            best = max(fitting, key=lambda t: t[1])
            break
    if best is None:
        return 0, 0, 0
    c, _, d, q, _ = best
    return c, d, q


def plan_stage(interp: int, decim: int) -> StagePlan:
    taps = design_resampler_taps(interp, decim)
    ntaps = len(taps)
    tail_len = -(-(ntaps - 1) // interp)
    pad = tail_len * interp - (ntaps - 1)
    kernel = np.concatenate([np.zeros(pad), taps[::-1]]).astype(np.float32)

    m = decim
    r_rows = -(-(ntaps - 1) // m) + 1
    h_rev = np.zeros(r_rows * m)
    h_rev[:ntaps] = taps[::-1]
    poly = np.zeros((1, m, r_rows), dtype=np.float32)
    for q in range(r_rows):
        for rr in range(m):
            poly[0, rr, q] = h_rev[q * m + rr]
    chunk_c, chunk_d, chunk_q = _plan_chunk_matmul(m, r_rows, tail_len) if interp == 1 else (0, 0, 0)
    return StagePlan(interp, decim, ntaps, tail_len, kernel, poly, r_rows, chunk_c, chunk_d, chunk_q)


def plan_chain(sample_rate: int, bandwidth: int, threshold: int = 125) -> List[StagePlan]:
    """Stage plans from sample_rate down to bandwidth (recorder.cpp:29-33)."""
    return [plan_stage(l, m) for l, m in get_resamplers_factors(sample_rate, bandwidth, threshold)]


def chain_block_multiple(plans: Sequence[StagePlan]) -> int:
    """Smallest block length every stage consumes integrally."""
    need = 1
    num, den = 1, 1
    for p in plans:
        num *= p.interp
        den *= p.decim
        g = math.gcd(num, den)
        num //= g
        den //= g
        need = need * den // math.gcd(need, den)
    return need


def chain_output_length(plans: Sequence[StagePlan], n: int) -> int:
    for p in plans:
        if (n * p.interp) % p.decim != 0:
            raise ValueError(f"{n} samples do not pass stage {p.interp}/{p.decim} integrally")
        n = n * p.interp // p.decim
    return n


# ---------------------------------------------------------------------------
# NCO tables (host-side exact math)
# ---------------------------------------------------------------------------


class NcoTables(NamedTuple):
    """Per-slot rotation tables: angle(n) = coarse[n // Q] + fine[n % Q]
    (int64 host math), applied as a product of two unit phasors."""

    coarse_re: torch.Tensor  # [..., K, chunk//Q] f32
    coarse_im: torch.Tensor
    fine_re: torch.Tensor  # [..., K, Q] f32
    fine_im: torch.Tensor
    step: torch.Tensor  # [..., K] f32: (phase_inc * chunk) mod 2pi


NCO_Q = 8192


def _nco_q(chunk: int) -> int:
    """Largest power-of-two divisor of chunk, capped at NCO_Q."""
    q = 1
    while q < NCO_Q and chunk % (q * 2) == 0:
        q *= 2
    return q


def make_nco_tables(
    shifts: np.ndarray, sample_rate: int, chunk: int, device: torch.device
) -> NcoTables:
    """Exact NCO angle tables for per-slot shifts [..., K]:
    phase_inc = 2*pi*(-shift)/rate; angle(n) = phase_inc*n mod 2pi in int64."""
    qsize = _nco_q(chunk)
    shifts = np.asarray(shifts, dtype=np.int64)
    smod = (-shifts) % sample_rate
    two_pi_over_rate = 2.0 * np.pi / sample_rate

    r = np.arange(qsize, dtype=np.int64)
    fine = ((smod[..., None] * r) % sample_rate) * two_pi_over_rate
    q = np.arange(chunk // qsize, dtype=np.int64) * qsize
    coarse = ((smod[..., None] * q) % sample_rate) * two_pi_over_rate
    step = ((smod * chunk) % sample_rate) * two_pi_over_rate
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
    return NcoTables(
        coarse_re=f32(np.cos(coarse)),
        coarse_im=f32(np.sin(coarse)),
        fine_re=f32(np.cos(fine)),
        fine_im=f32(np.sin(fine)),
        step=f32(step),
    )


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------


def no_tf32() -> None:
    """f32 products here are held to <= 1 LSB int8; TF32 would break that.
    Process-wide: called once where a DDC state or a block step is made."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=32)
def _interp_weight(interp: int, decim: int, device: torch.device) -> torch.Tensor:
    """An interpolating stage's [1, 1, tail_len*L + 1] reversed taps on
    ``device``, uploaded once (``plan_stage`` is a function of (interp, decim))."""
    return torch.from_numpy(plan_stage(interp, decim).kernel.reshape(1, 1, -1)).to(device)


def _stage_apply(
    x: torch.Tensor, tail: torch.Tensor, plan: StagePlan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One resampler stage on [B, 2, n] f32 -> [B, 2, n*L//M]; carries the
    overlap-save tail. Decimation-only stages go to the FIR kernel's wrapper.
    Interpolating stages run the causal zero-stuffed FIR
    y[m] = sum_j h[j] * up(x)[m*M - j]."""
    if plan.interp == 1:
        return stage_apply_fir(x, tail, plan)
    k, two, n = x.shape
    full = torch.cat([tail, x], dim=-1)
    new_tail = full[..., -plan.tail_len :].contiguous()
    out_len = n * plan.interp // plan.decim
    # the reference's dilated conv: full[i] sits at i*L of the stuffed row
    # and output o reads up[o*M : o*M + tail_len*L + 1] against the reversed
    # taps; every output in range reads stuffed samples only
    ell = plan.interp
    up = full.new_zeros((k * two, (n + plan.tail_len) * ell))
    up[:, ::ell] = full.reshape(k * two, -1)
    out = F.conv1d(up[:, None, :], _interp_weight(ell, plan.decim, x.device), stride=plan.decim)
    return out[:, 0, :out_len].reshape(k, two, out_len), new_tail


# ---------------------------------------------------------------------------
# v1: NCO rotation + resampler cascade
# ---------------------------------------------------------------------------


class DdcState(NamedTuple):
    """Streaming carry of the v1 path for K slots. Banded, the leaves fold
    bands into rows: [NB*K, ...], row band*K + slot (the JAX package's
    ``fold_banded`` layout)."""

    phase: torch.Tensor  # [K] f32 NCO phase at block start (radians, mod 2pi)
    tails: Tuple[torch.Tensor, ...]  # per stage [K, 2, tail_len] f32 (re/im)


def init_ddc_state(plans: Sequence[StagePlan], num_slots: int, device: torch.device) -> DdcState:
    no_tf32()
    return DdcState(
        phase=torch.zeros((num_slots,), dtype=torch.float32, device=device),
        tails=tuple(
            torch.zeros((num_slots, 2, p.tail_len), dtype=torch.float32, device=device)
            for p in plans
        ),
    )


def reset_slot(state: DdcState, slot: int) -> DdcState:
    """Zero one row's carry (recording start/stop; recorder.cpp:58-87)."""
    phase = state.phase.clone()
    phase[slot] = 0.0
    tails = []
    for t in state.tails:
        t = t.clone()
        t[slot] = 0.0
        tails.append(t)
    return DdcState(phase=phase, tails=tuple(tails))


def _rotation(phase: torch.Tensor, rt: NcoTables, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """e^{i(phase + angle(j))} for j < n as (re, im) [..., K, n]: two complex
    products of unit table entries; only the block-start phases need cos/sin."""
    ph_re = torch.cos(phase)[..., None]
    ph_im = torch.sin(phase)[..., None]
    c_re = ph_re * rt.coarse_re - ph_im * rt.coarse_im  # [..., K, nq]
    c_im = ph_re * rt.coarse_im + ph_im * rt.coarse_re
    f_re = rt.fine_re[..., None, :]
    f_im = rt.fine_im[..., None, :]
    lead = phase.shape
    rot_re = (c_re[..., None] * f_re - c_im[..., None] * f_im).reshape(*lead, n)
    rot_im = (c_re[..., None] * f_im + c_im[..., None] * f_re).reshape(*lead, n)
    return rot_re, rot_im


def _components(iq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[NB, chunk, 2] int8 cs8 / f32 pairs, or [NB, chunk] complex ->
    (re, im) f32 [NB, chunk]."""
    if iq.dtype == torch.int8:
        x = iq.to(torch.float32) * (1.0 / 127.5)
        return x[..., 0], x[..., 1]
    if iq.is_complex():
        return iq.real, iq.imag
    return iq[..., 0], iq[..., 1]


def ddc_chunk_banded(
    iq: torch.Tensor,  # [NB, chunk, 2] int8 / f32 pairs, or [NB, chunk] complex
    state: DdcState,  # folded [NB*K, ...] leaves
    tables: NcoTables,  # folded [NB*K, ...] leaves
    plans: Sequence[StagePlan],
) -> Tuple[DdcState, torch.Tensor]:
    """v1 DDC chunk over all bands; returns int8 [NB, K, out, 2].

    Bands fold into the batch rows, so each stage is one call over
    [NB*K, 2, n]; ``_stage_apply``'s plan decides the route. TF32 is off
    from ``init_ddc_state`` or the step's build on."""
    nb, chunk = iq.shape[0], iq.shape[1]
    k = state.phase.shape[0] // nb
    fold = lambda t: t.reshape(nb, k, *t.shape[1:])
    rot_re, rot_im = _rotation(fold(state.phase), NcoTables(*map(fold, tables)), chunk)
    x_re, x_im = _components(iq)
    x_re, x_im = x_re[:, None, :], x_im[:, None, :]
    y = torch.stack(
        [x_re * rot_re - x_im * rot_im, x_re * rot_im + x_im * rot_re], dim=2
    ).reshape(nb * k, 2, chunk)
    del rot_re, rot_im

    new_tails = []
    for plan, tail in zip(plans, state.tails):
        y, new_tail = _stage_apply(y, tail, plan)
        new_tails.append(new_tail)

    out = torch.clamp(torch.round(torch.movedim(y, 1, 2) * 127.0), -128, 127).to(torch.int8)
    new_phase = torch.remainder(state.phase + tables.step, 2.0 * math.pi)
    return DdcState(phase=new_phase, tails=tuple(new_tails)), out.reshape(nb, k, -1, 2)


def ddc_chunk(
    iq: torch.Tensor,  # [chunk, 2] int8 / f32 pairs, or [chunk] complex
    state: DdcState,  # [K, ...] leaves
    tables: NcoTables,  # [K, ...] leaves
    plans: Sequence[StagePlan],
) -> Tuple[DdcState, torch.Tensor]:
    """One chunk through K rotator+resampler slots of one band (the shared
    full-rate source feeds every slot); returns int8 [K, out, 2]."""
    state, out = ddc_chunk_banded(iq[None], state, tables, plans)
    return state, out[0]


class Ddc2State(NamedTuple):
    """Streaming carry of the modulated-taps path, banded."""

    phase: torch.Tensor  # [NB, K] f32 NCO phase at block start
    x_tail: torch.Tensor  # [NB, 2, tail0] raw-x overlap-save tail
    tails: Tuple[torch.Tensor, ...]  # stages 2+: [NB, K, 2, t]


class ModTables(NamedTuple):
    """Per-retune stage-1 modulated weights + decimated-rate NCO tables."""

    w: torch.Tensor  # [NB, C, K*2*D*P] f32, column order (k, part, d*P + b)
    rot: NcoTables  # decimated-rate output rotation, leaves [NB, K, ...]
    frag: torch.Tensor  # [NB, ceil(K/2), ceil(2M/8), 20, 32, 4] f32: the kernel's B (``ddc_kernel.mod_fragments``)


def init_ddc2_state(
    plans: Sequence[StagePlan], n_bands: int, num_slots: int, device: torch.device
) -> Ddc2State:
    no_tf32()
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return Ddc2State(
        phase=zeros(n_bands, num_slots),
        x_tail=zeros(n_bands, 2, plans[0].tail_len),
        tails=tuple(zeros(n_bands, num_slots, 2, p.tail_len) for p in plans[1:]),
    )


def reset_slot2(state: Ddc2State, band: int, slot: int) -> Ddc2State:
    """Zero one slot's phase and stage-2+ tails; the shared raw-x stage-1
    tail stays, so a new recording has no zero-history transient."""
    phase = state.phase.clone()
    phase[band, slot] = 0.0
    tails = []
    for t in state.tails:
        t = t.clone()
        t[band, slot] = 0.0
        tails.append(t)
    return Ddc2State(phase=phase, x_tail=state.x_tail, tails=tuple(tails))


@functools.lru_cache(maxsize=16)
def _modtap_scatter_index(m: int, r_rows: int, tail_len: int, c: int, d: int, q: int):
    """numpy gather index [C, D*P]: w[:, k2, dp] = g_pad[idx], with the
    sentinel slot r_rows*m for out-of-range taps and the chunked-matmul
    column permutation already applied."""
    p = c // m
    s = q - tail_len
    cols = np.arange(d * c)
    rows = np.arange(p)[:, None]
    t = cols[None, :] - s - rows * m
    sentinel = r_rows * m
    t = np.where((t >= 0) & (t < r_rows * m), t, sentinel)
    idx = t.reshape(p, d, c).transpose(2, 1, 0).reshape(c, d * p)
    return idx.astype(np.int32)


def modtap_taps(w: np.ndarray, plan: StagePlan) -> np.ndarray:
    """The f32 modulated taps [..., K, 2, R*M] that ``make_mod_tables``
    gathered into its matrix w [..., C, K*2*D*P] (each tap sits there at
    least once; this reads its first place)."""
    m, r_rows = plan.decim, plan.poly_rows
    idx = _modtap_scatter_index(m, r_rows, plan.tail_len, plan.chunk_c, plan.chunk_d, plan.chunk_q)
    taps, first = np.unique(idx.ravel(), return_index=True)
    if not np.array_equal(taps[: r_rows * m], np.arange(r_rows * m)):
        raise ValueError("modtap_taps: a tap has no place in the matrix")
    rows, cols = np.divmod(first[: r_rows * m], idx.shape[1])
    w = np.asarray(w)
    k = w.shape[-1] // (2 * idx.shape[1])
    w4 = np.moveaxis(w.reshape(*w.shape[:-2], plan.chunk_c, k, 2, idx.shape[1]), -4, -2)  # [..., K, 2, C, D*P]
    return np.ascontiguousarray(w4[..., rows, cols], dtype=np.float32)


def make_mod_tables(
    plans: Sequence[StagePlan],
    shifts: np.ndarray,
    sample_rate: int,
    chunk: int,
    device: torch.device,
) -> ModTables:
    """Host-exact modulated-tap tables for per-slot shifts [..., K].

    Tap angles and the decimated-rate rotation come from int64 host math;
    the big weight matrix is gathered ON the device from the tiny
    [..., K, 2, R*M] modulated-tap vectors, and the kernel's B fragments
    are packed from the same f32 vectors on the host."""
    p0 = plans[0]
    if not (p0.interp == 1 and p0.chunk_c > 0):
        raise ValueError("modtap needs a chunked decimating stage 1")
    m = p0.decim
    shifts = np.asarray(shifts, dtype=np.int64)
    smod = (-shifts) % sample_rate
    ntaps = p0.ntaps
    rm = p0.poly_rows * m

    h_rev = np.zeros(rm)
    h_rev[:ntaps] = np.asarray(design_resampler_taps(p0.interp, p0.decim))[::-1]
    j = np.maximum(ntaps - 1 - np.arange(rm), 0)  # forward tap index
    ang = ((smod[..., None] * j) % sample_rate) * (2.0 * np.pi / sample_rate)
    g = np.stack([h_rev * np.cos(ang), -h_rev * np.sin(ang)], axis=-2).astype(np.float32)  # [..., K, 2, RM]
    pad = np.zeros(g.shape[:-1] + (1,), dtype=np.float32)
    g_pad = torch.from_numpy(np.concatenate([g, pad], axis=-1)).to(device)

    idx = _modtap_scatter_index(m, p0.poly_rows, p0.tail_len, p0.chunk_c, p0.chunk_d, p0.chunk_q)
    w = g_pad[..., torch.from_numpy(idx).long().to(device)]  # [..., K, 2, C, D*P]
    lead = w.shape[:-4]
    k = w.shape[-4]
    w = torch.movedim(w, -2, -4).reshape(*lead, p0.chunk_c, k * 2 * idx.shape[1])

    rot = make_nco_tables(-((smod * m) % sample_rate), sample_rate, chunk // m, device)
    frag = torch.from_numpy(mod_fragments(g, m, p0.poly_rows)).to(device)
    return ModTables(w=w.contiguous(), rot=rot, frag=frag)


def _modtap_stage1(
    x: torch.Tensor,  # [NB, 2, chunk] f32 raw components
    x_tail: torch.Tensor,  # [NB, 2, tail0]
    w: torch.Tensor,  # [NB, C, K*2*D*P]
    plan: StagePlan,
    k: int,
    bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Complex-tap chunked-matmul stage 1: (y_re, y_im) [NB, K, out1] and
    the new raw tail.

    bf16=True is the reference's tolerance mode: bf16 OPERANDS, f32
    accumulation and output. A bf16 ``bmm`` would round its output to bf16
    too (another function), so the operands are rounded to bf16 and the
    product runs in f32."""
    nb, two, n = x.shape
    m = plan.decim
    c, d, q = plan.chunk_c, plan.chunk_d, plan.chunk_q
    p = c // m
    out_len = n // m
    a_tiles = -(-out_len // p)
    n_chunks = a_tiles + d - 1
    full = torch.cat([x_tail, x], dim=-1)
    lhs = F.pad(full, (q - plan.tail_len, n_chunks * c - q - n)).reshape(nb, two * n_chunks, c)
    if bf16:
        lhs = lhs.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    z = torch.bmm(lhs, w).reshape(nb, two, n_chunks, k, 2, d * p)
    acc = z[:, :, 0:a_tiles, :, :, 0:p]
    for dd in range(1, d):
        acc = acc + z[:, :, dd : dd + a_tiles, :, :, dd * p : (dd + 1) * p]
    # [NB, xcomp, a, K, gcomp, P] -> [NB, xcomp, K, gcomp, out1]
    acc = torch.movedim(acc, 2, 4).reshape(nb, two, k, 2, a_tiles * p)[..., :out_len]
    y_re = acc[:, 0, :, 0] - acc[:, 1, :, 1]
    y_im = acc[:, 0, :, 1] + acc[:, 1, :, 0]
    return y_re, y_im, full[..., -plan.tail_len :].contiguous()


def ddc_chunk_modtap(
    iq: torch.Tensor,  # [NB, chunk, 2] int8 cs8 / f32 pairs, or [NB, chunk] complex
    state: Ddc2State,
    tables: ModTables,
    plans: Sequence[StagePlan],
) -> Tuple[Ddc2State, torch.Tensor]:
    """Modulated-taps DDC chunk over all bands; returns int8 [NB, K, out, 2].
    Stage 1 with its decimated-rate rotation e^{i(phi0 + inc M m)} is the
    kernel's wrapper (one launch a chunk on the card), in the span
    "ddc.stage1". TF32 is off from ``init_ddc2_state`` or the step's build on."""
    nb = iq.shape[0]
    k = state.phase.shape[-1]
    with span("ddc.stage1"):
        y, new_x_tail = modtap_stage1(iq, state.x_tail, state.phase, tables, plans[0])  # [NB*K, 2, out1]

    new_tails = []
    for plan, tail in zip(plans[1:], state.tails):
        y, new_tail = _stage_apply(y, tail.reshape(nb * k, 2, -1), plan)
        new_tails.append(new_tail.reshape(nb, k, 2, -1))

    out = torch.clamp(torch.round(torch.movedim(y, 1, 2) * 127.0), -128, 127).to(torch.int8)
    new_phase = torch.remainder(state.phase + tables.rot.step, 2.0 * math.pi)
    return (
        Ddc2State(phase=new_phase, x_tail=new_x_tail, tails=tuple(new_tails)),
        out.reshape(nb, k, -1, 2),
    )
