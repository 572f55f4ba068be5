"""Spectrogram bin decimation + accumulation (reference spectrogram.cpp:45-60)."""

from __future__ import annotations

import torch

from rtl_sdr_scanner_tpu_torch.utils.radio_utils import get_fft


def spectrogram_output_size(
    fft_size: int, sample_rate: int, max_fft: int = 16384, preferred_max_step: int = 1000
) -> int:
    """min(SPECTROGRAM_MAX_FFT, getFft(rate, SPECTROGRAM_PREFERRED_MAX_STEP))."""
    return min(max_fft, get_fft(sample_rate, preferred_max_step))


def accumulate_frames(psd_frames: torch.Tensor, output_size: int) -> torch.Tensor:
    """[..., n, fft] PSD dB -> [..., output_size]: sum over the n frames of
    the per-frame bin-group means."""
    *lead, n, fft_size = psd_frames.shape
    decim = fft_size // output_size
    grouped = psd_frames.reshape(*lead, n, output_size, decim)
    return grouped.mean(dim=-1).sum(dim=-2)
