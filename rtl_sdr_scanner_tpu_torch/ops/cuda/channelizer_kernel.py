"""The critically sampled analysis bank of the wideband channelizer: the
hand-written kernel (``csrc/channelizer_kernel.cu``) and its plain PyTorch
version.

It replaces no TPU kernel: the JAX package leaves the bank to XLA's
``dot_general`` (the modulated-taps product over the raw stream). The
kernel computes the bank as the oracle orders it, branch FIRs then a
B-point FFT:

    ext    = [tail, x]                          (tail: (T - 1) * B samples)
    v_p[m] = sum_t k[p, t] * ext[(m + t) * B + p]
    y_b[m] = sum_p e^{-2 pi i b p / B} * v_p[m]

from the stream (int8 cs8, dequantized at 1/127.5, or f32; any element
strides) to channels [B, n / B, 2] f32 and the new tail, in one launch:
for B in ``CHANNELS`` (powers of two, 2-64) the FFT form, for any other B
up to ``MAX_CHANNELS`` the direct-DFT form. Its host tables: the branch
kernels zero-padded to a multiple of ``TAP_CHUNK`` taps, and the twiddles
e^{-2 pi i k / B} (k < B) from float64 cast to float32 (``host_tables``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

CHANNELS = (2, 4, 8, 16, 32, 64)  # the FFT form's template over B
MAX_CHANNELS = 4096  # the direct-DFT form's largest B (kMaxChannels)
MAX_TAPS = 32  # taps a branch (kMaxTaps)
TAP_CHUNK = 3  # taps a register-window step, and outputs a branch-FIR item (kU)
ITEMS = 512  # (branch, TAP_CHUNK outputs) items a thread block (kItems)
DFT_POINTS = 2048  # branch sums a direct-DFT thread block keeps (kDftPoints)
CS8_SCALE = 1.0 / 127.5


def run_length(b: int) -> int:
    """Output times a thread block takes (``kRun<B>``; ``dft_run`` off the
    template)."""
    return TAP_CHUNK * ITEMS // b if b in CHANNELS else max(1, DFT_POINTS // b)


def padded_taps(taps: int) -> int:
    return -(-taps // TAP_CHUNK) * TAP_CHUNK


def host_tables(branch_kernels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plan's [B, T] branch kernels -> (taps [B, padded_taps(T)] f32,
    zero past T; twiddles [B, 2] f32, e^{-2 pi i k / B} computed in
    float64: the FFT form reads k < B / 2)."""
    b, t = branch_kernels.shape
    taps = np.zeros((b, padded_taps(t)), dtype=np.float32)
    taps[:, :t] = branch_kernels
    w = np.exp(-2j * np.pi * np.arange(b) / b)
    return taps, np.stack([w.real, w.imag], axis=-1).astype(np.float32)


def dequantize(xs: torch.Tensor) -> torch.Tensor:
    """int8 cs8 -> f32 at 1/127.5 (as ``native.cs8_to_complex64``); f32 as it is."""
    return xs.to(torch.float32) * CS8_SCALE if xs.dtype == torch.int8 else xs


def analysis_bank_plain(
    xs: torch.Tensor, tail: torch.Tensor, taps: torch.Tensor, twiddles: torch.Tensor, n_taps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch: a grouped ``F.conv1d`` (the branch
    FIRs) then ``torch.fft.fft`` along the branch axis (``twiddles`` is the
    kernel's; the FFT makes its own)."""
    b = taps.shape[0]
    ext = torch.cat([tail.T, dequantize(xs)], dim=-1)  # [2, tail + n]
    branches = ext.reshape(2, -1, b).transpose(1, 2)  # [2, B, M + T - 1]: branch p of each part
    v = F.conv1d(branches, taps[:, None, :n_taps], groups=b)  # [2, B, n // B]
    channels = torch.fft.fft(torch.complex(v[0], v[1]), dim=0)
    new_tail = ext[:, ext.shape[-1] - tail.shape[0] :].T.contiguous()
    return torch.stack([channels.real, channels.imag], dim=-1), new_tail


def check_args(xs: torch.Tensor, tail: torch.Tensor, taps: torch.Tensor, twiddles: torch.Tensor, n_taps: int) -> None:
    """Raise ValueError on what the kernel does not take."""
    b = taps.shape[0] if taps.ndim == 2 else 0
    if not 2 <= b <= MAX_CHANNELS or not 1 <= n_taps <= MAX_TAPS:
        raise ValueError(f"analysis_bank: want 2 <= B <= {MAX_CHANNELS} and 1 <= T <= {MAX_TAPS}, got B {b}, "
                         f"T {n_taps}")
    if xs.ndim != 2 or xs.shape[0] != 2 or xs.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"analysis_bank: want [2, n] int8 or f32 components, got {xs.dtype} {tuple(xs.shape)}")
    n = xs.shape[1]
    if n == 0 or n % b:
        raise ValueError(f"analysis_bank: {n} samples are not a positive multiple of {b}")
    for name, t, shape in (("tail", tail, ((n_taps - 1) * b, 2)), ("taps", taps, (b, padded_taps(n_taps))),
                           ("twiddles", twiddles, (b, 2))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"analysis_bank: want {name} contiguous f32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != xs.device:
            raise ValueError(f"analysis_bank: {name} on {t.device}, the stream on {xs.device}")


def launch_args(
    xs: torch.Tensor, tail: torch.Tensor, taps: torch.Tensor, twiddles: torch.Tensor, out: torch.Tensor,
    new_tail: torch.Tensor, n_taps: int,
) -> tuple:
    """The C entry point's arguments but the stream (``csrc/channelizer_kernel.cu``
    ``analysis_bank``): the stream's element strides (sample, component)."""
    return (
        xs.data_ptr(), int(xs.dtype == torch.int8), xs.stride(1), xs.stride(0), xs.shape[1],
        tail.data_ptr(), taps.data_ptr(), twiddles.data_ptr(), out.data_ptr(), new_tail.data_ptr(),
        taps.shape[0], n_taps,
    )


def analysis_bank(
    xs: torch.Tensor, tail: torch.Tensor, taps: torch.Tensor, twiddles: torch.Tensor, n_taps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs [2, n] components (int8 cs8 or f32, any strides), tail [(T - 1) B,
    2] f32, the host tables on the device -> (channels [B, n / B, 2] f32,
    new tail [(T - 1) B, 2] f32, a fresh tensor).

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``analysis_bank.launches``); on a CPU tensor it runs the plain version.
    """
    if xs.device.type == "cpu":
        return analysis_bank_plain(xs, tail, taps, twiddles, n_taps)
    if xs.device.type != "cuda":
        raise ValueError(f"analysis_bank: unsupported device {xs.device}")
    check_args(xs, tail, taps, twiddles, n_taps)
    b = taps.shape[0]
    out = torch.empty((b, xs.shape[1] // b, 2), dtype=torch.float32, device=xs.device)
    new_tail = torch.empty_like(tail)
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = library().analysis_bank(*launch_args(xs, tail, taps, twiddles, out, new_tail, n_taps), stream)
    check(rc, "analysis_bank")
    analysis_bank.launches += 1
    return out, new_tail


analysis_bank.launches = 0
