"""PSD of int8 IQ frames: the hand-written kernel (``csrc/psd_kernel.cu``)
and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/psd_kernel.py``
(``psd_frames_int8_pallas``). The kernel's note says which form runs for
which fft (on chip up to 2^17: one block or one thread-block cluster per
frame; a global scratch above), what bounds each and what its design does
about it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rtl_sdr_scanner_tpu_torch.ops.psd import dequantize_cs8, device_window, psd_frames


def _split_n(n: int) -> Tuple[int, int]:
    """N = N1*N2 with N1 >= N2, both powers of two (N a power of two)."""
    log = n.bit_length() - 1
    l1 = (log + 1) // 2
    return 1 << l1, 1 << (log - l1)


def takes_fft(fft_size: int) -> bool:
    """Whether the kernel takes frames of ``fft_size``: a power of two in
    [256, 2^20]."""
    if fft_size <= 0 or fft_size & (fft_size - 1):
        return False
    n1, n2 = _split_n(fft_size)
    return n2 >= 16 and n1 <= 1024


def psd_frames_int8_plain(
    iq_int8: torch.Tensor, sample_rate: float, fft_size: int, decim: int
) -> torch.Tensor:
    """[frames, fft*decim, 2] int8 -> [frames, fft] f32 PSD dB (fftshifted):
    frame select + dequantize_cs8 + psd_frames via torch.fft."""
    return psd_frames(dequantize_cs8(iq_int8[:, :fft_size]), sample_rate)


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
    if n1 * n2 != fft_size or not takes_fft(fft_size):
        raise ValueError(f"psd_frames_int8: fft {fft_size} must be a power of two in [256, 2^20]")
    if not 0 < frames <= 65535:
        raise ValueError(f"psd_frames_int8: {frames} frames outside the grid's 1..65535")
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    lib = library()
    dev = iq_int8.device
    log_n1, log_n2 = n1.bit_length() - 1, n2.bit_length() - 1
    out = torch.empty((frames, fft_size), dtype=torch.float32, device=dev)
    # the library says which sizes take a device-memory intermediate (its
    # scratch form only); the on-chip forms get none
    scratch_bytes = lib.psd_scratch_bytes(log_n1, log_n2)
    scratch = torch.empty((frames, scratch_bytes), dtype=torch.uint8, device=dev) if scratch_bytes else None
    win = device_window(fft_size, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.psd_frames_int8(
        iq_int8.data_ptr(), win.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), frames, log_n1, log_n2, decim, float(sample_rate), stream,
    )
    check(rc, "psd_frames_int8")
    psd_frames_int8.launches += 1
    return out


psd_frames_int8.launches = 0
