"""Power-spectral-density frame transform: frame-select, window, FFT,
fftshift, 10*log10(|X|^2/rate) (reference sdr_device.cpp:161-165).

This is the plain PyTorch chain; ``ops/cuda/psd_kernel.py`` holds the
hand-written kernel that computes the same function from int8 IQ.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.ops.window import hamming

# Floor |X|^2 so log10 of an exactly-zero bin stays finite.
_EPS = 1e-30


def dequantize_cs8(iq_int8: torch.Tensor) -> torch.Tensor:
    """int8 interleaved IQ [..., 2] -> complex64, scale 1/127.5."""
    x = iq_int8.to(torch.float32) / 127.5
    return torch.complex(x[..., 0], x[..., 1])


def pairs_to_complex(iq_f32: torch.Tensor) -> torch.Tensor:
    """float32 interleaved IQ [..., 2] -> complex64."""
    return torch.complex(iq_f32[..., 0], iq_f32[..., 1])


def frame_blocks(iq: torch.Tensor, fft_size: int, decimator_factor: int) -> torch.Tensor:
    """[n*fft*decim] complex -> [n, fft]: the first fft samples of each
    fft*decim group (the reference Decimator, decimator.h:11-22)."""
    group = fft_size * decimator_factor
    n = iq.shape[0] // group
    return iq[: n * group].reshape(n, group)[:, :fft_size]


@functools.lru_cache(maxsize=8)
def shifted_window(fft_size: int) -> np.ndarray:
    """Hamming window with the fftshift folded in as (-1)^n (f32): for even
    N, FFT(x * (-1)^n)[k] = FFT(x)[(k + N/2) mod N]."""
    signs = np.where(np.arange(fft_size) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return hamming(fft_size) * signs


def psd_frames(frames: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """[..., fft] complex64 -> [..., fft] float32 PSD in dB, fftshifted
    (fft even: the shift rides in the window)."""
    fft_size = frames.shape[-1]
    if fft_size % 2:
        raise ValueError(f"psd_frames: fft size {fft_size} must be even")
    win = torch.from_numpy(shifted_window(fft_size)).to(frames.device)
    spec = torch.fft.fft(frames * win)
    power = spec.real**2 + spec.imag**2
    return (10.0 * torch.log10(torch.clamp(power, min=_EPS) / sample_rate)).to(
        torch.float32
    )
