"""Polyphase analysis channelizer: one wideband stream -> B sub-band streams
(port of the JAX package's ``ops/channelizer.py``).

The reference can only watch sample_rate of spectrum at a time and
time-multiplexes wider ranges with 500 ms dwells (scanner.cpp:46-60). This
critically-sampled DFT filter bank splits one rate-R wideband capture into B
channels of rate R/B, each of which feeds its own band-scan pipeline.

Math (channel b, center +b*R/B, wrapped to +-R/2):
  y_b[m] = sum_p e^{-j2pi b p / B} * (x_p conv h_p)[m]
  with branch signals x_p[m] = x[mB + p] and branch filters
  h_p[j] = h[jB - p] of a prototype low-pass h (Kaiser, cutoff R/2B).

Three forms, equal within f32 rounding (atol = rtol = 2e-5), chosen by
``_bank`` from its arguments:
- on the card (every CUDA tensor, every plan), one launch of the
  hand-written kernel ``ops/cuda/channelizer_kernel.analysis_bank``: the
  int8 stream in, branch FIRs then a B-point FFT (a direct DFT off its
  powers of two) on chip, the channels out once as pairs, in f32 (the bf16
  plan's rounding is of the products G below, which the kernel never
  forms);
- on the CPU, the modulated-taps form (``ops/ddc._modtap_stage1``), as the
  JAX package computes it: channel b is a decimate-by-B FIR over the raw
  stream with complex taps G[b, t*B + p] = W[b, p] k[p, t], one
  ``[.., C] @ [C, B*2*D*P]`` product (a plain f32 ``torch.bmm``, bf16
  operands in the bf16 plan, as the JAX package leaves it to XLA's
  ``dot_general``);
- on the CPU where the plan has no matmul form: the kernel's plain
  version, a grouped ``F.conv1d`` (groups=B) then ``torch.fft.fft`` along
  the branch axis.

Streaming: an input-domain tail (overlap-save) carries across blocks, so
block-streamed output equals offline filtering. Channels travel as f32
(re, im) pairs; complex tensors live only inside the functions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.ops.cuda import channelizer_kernel
from rtl_sdr_scanner_tpu_torch.ops.ddc import (
    StagePlan,
    _modtap_scatter_index,
    _modtap_stage1,
    _plan_chunk_matmul,
    firdes_low_pass,
    no_tf32,
)


class ChannelizerPlan(NamedTuple):
    num_channels: int
    taps_per_branch: int
    branch_kernels: np.ndarray  # [B, taps_per_branch] f32, conv-ready (reversed)
    tail_len: int  # input samples carried between blocks
    mm_plan: object  # ops/ddc.StagePlan for (decim=B, r_rows=T) or None
    mm_g_pad: np.ndarray  # [B, 2, T*B + 1] f32 complex kernels (+ zero slot)
    mm_idx: np.ndarray  # [C, D*P] int32 scatter index
    # tolerance mode (tunables.channelizer_bf16): bf16 OPERANDS in the CPU's
    # matmul form, f32 accumulation (held to >= 45 dB SNR against f32); the
    # card's kernel is f32 in either mode
    bf16: bool = False


@functools.lru_cache(maxsize=16)
def plan_channelizer(
    num_channels: int,
    taps_per_branch: int = 0,
    oversample: int = 1,
    bf16: bool = False,
) -> ChannelizerPlan:
    """Design the prototype and split it into branch filters (host tables
    in f64, cast to f32: the arrays equal the JAX package's).

    Critically sampled (oversample=1): cutoff at half the channel spacing,
    20% transition. 2x-oversampled: cutoff 0.7, transition 0.35 of the
    spacing, so the whole +-half-spacing core is flat."""
    b = num_channels
    cutoff, trans = (0.5, 0.2) if oversample == 1 else (0.7, 0.35)
    proto = firdes_low_pass(gain=1.0, sampling_freq=float(b), cutoff=cutoff, transition_width=trans)
    # branch filters h_p[j] = h[j*B - p]; front-pad so j starts at 0
    g = np.concatenate([np.zeros(b - 1), proto])
    n_taps = -(-(len(proto) + b - 1) // b)
    kernels = np.zeros((b, n_taps), dtype=np.float64)
    for p in range(b):
        for j in range(n_taps):
            idx = j * b - p + (b - 1)
            if 0 <= idx < len(g):
                kernels[p, j] = g[idx]
    # conv implementation is cross-correlation with reversed kernels
    kernels = kernels[:, ::-1].copy()
    tail_len = (n_taps - 1) * b

    # chunked-matmul form: forward kernels G[b, t*B + p] = W[b,p] k[p,t];
    # with r_rows = n_taps and tail_len = (T-1)*B the stage's output m equals
    # sum_u G[u] * ext[m*B + u], exactly the conv+fft channels
    bb, pp_ = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    w_dft = np.exp(-2j * np.pi * bb * pp_ / b)  # [B, B]
    g = np.zeros((b, n_taps * b), dtype=np.complex128)
    for p in range(b):
        for t in range(n_taps):
            g[:, t * b + p] = w_dft[:, p] * kernels[p, t]
    g_pad = np.concatenate(
        [np.stack([g.real, g.imag], axis=1), np.zeros((b, 2, 1))], axis=-1
    ).astype(np.float32)

    c, d, q = _plan_chunk_matmul(b, n_taps, tail_len)
    if c > 0:
        mm_plan = StagePlan(
            1, b, n_taps * b, tail_len, np.zeros(1, np.float32), np.zeros((1, 1, 1), np.float32),
            n_taps, c, d, q,
        )
        mm_idx = np.asarray(_modtap_scatter_index(b, n_taps, tail_len, c, d, q))
    else:  # every power-of-two B fits the matmul form
        mm_plan, mm_idx = None, np.zeros((0, 0), np.int32)

    return ChannelizerPlan(
        num_channels=b,
        taps_per_branch=n_taps,
        branch_kernels=kernels.astype(np.float32),
        tail_len=tail_len,
        mm_plan=mm_plan,
        mm_g_pad=g_pad,
        mm_idx=mm_idx,
        bf16=bf16,
    )


class ChannelizerState(NamedTuple):
    tail: torch.Tensor  # [tail_len, 2] f32: the last input samples, as pairs


def init_channelizer_state(plan: ChannelizerPlan, device: DeviceLike = None) -> ChannelizerState:
    """Zero carry on ``device``; switches TF32 off (the bank's f32 product
    is held to 2e-5 of the CPU's)."""
    no_tf32()
    return ChannelizerState(tail=torch.zeros((plan.tail_len, 2), dtype=torch.float32,
                                             device=resolve_device(device)))


class Channelizer2xState(NamedTuple):
    even: ChannelizerState  # bank state on x
    odd: ChannelizerState  # bank state on x delayed by B/2
    carry: torch.Tensor  # [B/2, 2] f32: the last B/2 input samples


def init_channelizer2x_state(plan: ChannelizerPlan, device: DeviceLike = None) -> Channelizer2xState:
    dev = resolve_device(device)
    return Channelizer2xState(
        even=init_channelizer_state(plan, dev),
        odd=init_channelizer_state(plan, dev),
        carry=torch.zeros((plan.num_channels // 2, 2), dtype=torch.float32, device=dev),
    )


_ON_DEVICE: dict = {}


def _on_device(plan: ChannelizerPlan, device: torch.device, name: str, make):
    """``make(plan, device)``, made once a (plan, device, name): no block
    copies host tables to the card (a copy would synchronise the stream, and
    a graph capture refuses it)."""
    key = (id(plan), str(device), name)
    hit = _ON_DEVICE.get(key)
    if hit is not None and hit[0] is plan:
        return hit[1]
    value = make(plan, device)
    _ON_DEVICE[key] = (plan, value)
    return value


def _make_bank_weight(plan: ChannelizerPlan, device: torch.device) -> torch.Tensor:
    """The bank's [C, B*2*D*P] f32 weight, gathered on ``device`` from the
    small host table (as ``make_mod_tables``)."""
    gp = torch.from_numpy(plan.mm_g_pad).to(device)  # [B, 2, RM + 1]
    idx = torch.from_numpy(plan.mm_idx).long().to(device)
    return torch.movedim(gp[:, :, idx], 2, 0).reshape(plan.mm_plan.chunk_c, -1).contiguous()


def _bank_mm(plan: ChannelizerPlan, state: ChannelizerState, xs: torch.Tensor):
    """The production form on xs [2, n] f32 components -> (state, y_re,
    y_im) [B, n // B]: channels[b, m] = sum_u G[b, u] ext[m*B + u] with
    ext = [carried tail, x], run by the DDC's ``_modtap_stage1``."""
    b = plan.num_channels
    w = _on_device(plan, xs.device, "bank weight", _make_bank_weight)
    y_re, y_im, new_tail = _modtap_stage1(
        xs[None], state.tail.T[None], w[None], plan.mm_plan, b, bf16=plan.bf16
    )
    return ChannelizerState(tail=new_tail[0].T.contiguous()), y_re[0], y_im[0]


def _make_bank_tables(plan: ChannelizerPlan, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (and its plain version's) taps and twiddles on ``device``."""
    return tuple(torch.from_numpy(t).to(device) for t in channelizer_kernel.host_tables(plan.branch_kernels))


def _bank(plan: ChannelizerPlan, state: ChannelizerState, xs: torch.Tensor):
    """xs [2, n] components (f32, or int8 cs8 dequantized at 1/127.5; any
    strides) -> (state, channels [B, n // B, 2] f32): the kernel on a CUDA
    tensor, else the matmul form where the plan has it, else the oracle."""
    n = xs.shape[-1]
    assert n % plan.num_channels == 0, (n, plan.num_channels)
    if xs.device.type == "cuda" or plan.mm_plan is None:
        taps, twiddles = _on_device(plan, xs.device, "bank tables", _make_bank_tables)
        channels, new_tail = channelizer_kernel.analysis_bank(xs, state.tail, taps, twiddles, plan.taps_per_branch)
        return ChannelizerState(tail=new_tail), channels
    state, y_re, y_im = _bank_mm(plan, state, channelizer_kernel.dequantize(xs))
    return state, torch.stack([y_re, y_im], dim=-1)


def _components(x: torch.Tensor) -> torch.Tensor:
    """[n] complex -> [2, n] f32."""
    return torch.stack([x.real, x.imag], dim=0)


def _complex(channels: torch.Tensor) -> torch.Tensor:
    """[..., 2] f32 pairs -> [...] complex64."""
    return torch.complex(channels[..., 0], channels[..., 1])


def channelize_block(
    plan: ChannelizerPlan, state: ChannelizerState, x: torch.Tensor
) -> Tuple[ChannelizerState, torch.Tensor]:
    """x: [n] complex64, n % B == 0 -> channels [B, n // B] complex64.

    Channel b is the sub-band centered at +b*R/B relative to the wideband
    center (b >= B/2 wraps negative). The production form when the plan has
    it (``plan.mm_plan``), else the grouped-conv + FFT oracle; the kernel on
    the card (``_bank``)."""
    state, channels = _bank(plan, state, _components(x))
    return state, _complex(channels)


def _channelize_block_mm(
    plan: ChannelizerPlan, state: ChannelizerState, x: torch.Tensor
) -> Tuple[ChannelizerState, torch.Tensor]:
    """``channelize_block``'s production form, whatever the caller's plan
    would pick: [n] complex64 -> [B, n // B] complex64."""
    state, y_re, y_im = _bank_mm(plan, state, _components(x))
    return state, torch.complex(y_re, y_im)


def channelize_block_pairs(
    plan: ChannelizerPlan, state: ChannelizerState, x_pairs: torch.Tensor
) -> Tuple[ChannelizerState, torch.Tensor]:
    """channelize_block with f32 (re, im) pairs at both boundaries: x_pairs
    [n, 2] f32 (or int8 cs8, dequantized at 1/127.5) -> channels
    [B, n // B, 2] f32. The pairs reach the bank as a [2, n] view: on the
    card the kernel reads the int8 stream as it is."""
    return _bank(plan, state, x_pairs.T)


# -- 2x-oversampled analysis bank -------------------------------------------
#
# With hop h = B/2 the odd-phase outputs are a critically-sampled bank run on
# the stream DELAYED by h: y_b(tB - h) = (-1)^b * bank(x delayed by h)[b, t].
# Interleaving [odd_t, even_t] gives the uniformly h-spaced stream; the whole
# output is delayed by h samples against the even bank (a constant latency).


def _bank_2x(plan: ChannelizerPlan, state: Channelizer2xState, xs: torch.Tensor):
    """xs [2, n] f32 components -> (state, channels [B, 2 * n // B, 2] f32)
    at twice the critically-sampled channel rate."""
    b = plan.num_channels
    h = b // 2
    n = xs.shape[-1]
    assert n % b == 0, (n, b)
    even_state, even = _bank(plan, state.even, xs)
    # odd bank input: x delayed by B/2 (zeros before the first block)
    x_odd = torch.cat([state.carry.T, xs[:, : n - h]], dim=-1)
    odd_state, odd = _bank(plan, state.odd, x_odd)
    signs = torch.where(torch.arange(b, device=xs.device) % 2 == 0, 1.0, -1.0)[:, None, None]
    # odd sample y(tB - h) precedes even sample y(tB)
    channels = torch.stack([odd * signs, even], dim=2).reshape(b, 2 * (n // b), 2)
    new = Channelizer2xState(even=even_state, odd=odd_state, carry=xs[:, n - h :].T.contiguous())
    return new, channels


def channelize_block_2x(
    plan: ChannelizerPlan, state: Channelizer2xState, x: torch.Tensor
) -> Tuple[Channelizer2xState, torch.Tensor]:
    """x: [n] complex64, n % B == 0 -> channels [B, 2 * n // B] complex64.
    The odd-phase bank consumes the stream delayed by B/2 (zero-primed on
    the first block, a zero-history filter start)."""
    state, channels = _bank_2x(plan, state, _components(x))
    return state, _complex(channels)


def channelize_block_2x_pairs(
    plan: ChannelizerPlan, state: Channelizer2xState, x_pairs: torch.Tensor
) -> Tuple[Channelizer2xState, torch.Tensor]:
    """channelize_block_2x with f32 (re, im) pairs (or int8 cs8) at both
    boundaries: -> [B, 2 * n // B, 2] f32."""
    return _bank_2x(plan, state, channelizer_kernel.dequantize(x_pairs.T))


def channel_center_offsets(plan: ChannelizerPlan, sample_rate: int) -> np.ndarray:
    """Per-channel frequency offset from the wideband center (Hz), wrapped."""
    b = plan.num_channels
    k = np.arange(b)
    k = np.where(k <= b // 2, k, k - b)
    return (k * sample_rate // b).astype(np.int64)


def offline_channelize(plan: ChannelizerPlan, x: np.ndarray) -> np.ndarray:
    """Numpy reference model: per-channel downconvert -> filter -> decimate."""
    b = plan.num_channels
    proto = plan.branch_kernels[:, ::-1]  # un-reverse
    n_taps = plan.taps_per_branch
    g = np.zeros(n_taps * b)
    for p in range(b):
        for j in range(n_taps):
            idx = j * b - p + (b - 1)
            if 0 <= idx < len(g):
                g[idx] = proto[p, j]
    h = g[b - 1 :]
    n = len(x)
    out = np.zeros((b, n // b), dtype=np.complex128)
    ns = np.arange(n)
    for ch in range(b):
        mixed = x * np.exp(-2j * np.pi * ch * ns / b)
        filtered = np.convolve(mixed, h)[:n]
        out[ch] = filtered[0::b][: n // b]  # y_b[m] = (mixed conv h)[m*B]
    return out
