"""PSD of int8 IQ frames: the hand-written kernel (``csrc/psd_kernel.cu``)
and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/psd_kernel.py``
(``psd_frames_int8_pallas``). The kernel's note says what bounds it on the
card and what its two-pass design does about it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from rtl_sdr_scanner_tpu_torch.ops.psd import dequantize_cs8, psd_frames, shifted_window


def _split_n(n: int) -> Tuple[int, int]:
    """N = N1*N2 with N1 >= N2, both powers of two (N a power of two)."""
    log = n.bit_length() - 1
    l1 = (log + 1) // 2
    return 1 << l1, 1 << (log - l1)


def psd_frames_int8_plain(
    iq_int8: torch.Tensor, sample_rate: float, fft_size: int, decim: int
) -> torch.Tensor:
    """[frames, fft*decim, 2] int8 -> [frames, fft] f32 PSD dB (fftshifted):
    frame select + dequantize_cs8 + psd_frames via torch.fft."""
    return psd_frames(dequantize_cs8(iq_int8[:, :fft_size]), sample_rate)


@functools.lru_cache(maxsize=8)
def _window(fft_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shifted_window(fft_size)).to(device)


def psd_frames_int8(
    iq_int8: torch.Tensor, sample_rate: float, fft_size: int, decim: int
) -> torch.Tensor:
    """[frames, fft*decim, 2] int8 -> [frames, fft] f32 PSD dB (fftshifted).

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``psd_frames_int8.launches``); on a CPU tensor it runs the plain version.
    """
    if iq_int8.device.type == "cpu":
        return psd_frames_int8_plain(iq_int8, sample_rate, fft_size, decim)
    if iq_int8.device.type != "cuda":
        raise ValueError(f"psd_frames_int8: unsupported device {iq_int8.device}")
    frames = iq_int8.shape[0]
    n1, n2 = _split_n(fft_size)
    if iq_int8.dtype != torch.int8 or iq_int8.shape[1:] != (fft_size * decim, 2):
        raise ValueError(
            f"psd_frames_int8: want int8 [frames, {fft_size * decim}, 2], "
            f"got {iq_int8.dtype} {tuple(iq_int8.shape)}"
        )
    if not iq_int8.is_contiguous():
        raise ValueError("psd_frames_int8: input must be contiguous")
    if n1 * n2 != fft_size or n2 < 16 or n1 > 1024:
        raise ValueError(f"psd_frames_int8: fft {fft_size} must be a power of two in [256, 2^20]")
    if not 0 < frames <= 65535:
        raise ValueError(f"psd_frames_int8: {frames} frames outside the grid's 1..65535")
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    lib = library()
    dev = iq_int8.device
    out = torch.empty((frames, fft_size), dtype=torch.float32, device=dev)
    scratch = torch.empty((frames, fft_size, 2), dtype=torch.float32, device=dev)
    win = _window(fft_size, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.psd_frames_int8(
        iq_int8.data_ptr(), win.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        frames, n1.bit_length() - 1, n2.bit_length() - 1, decim,
        float(sample_rate), stream,
    )
    check(rc, "psd_frames_int8")
    psd_frames_int8.launches += 1
    return out


psd_frames_int8.launches = 0
