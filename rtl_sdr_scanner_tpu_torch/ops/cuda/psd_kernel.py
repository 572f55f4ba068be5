"""PSD of int8 IQ frames: the hand-written kernel (``csrc/psd_kernel.cu``)
and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/psd_kernel.py``
(``psd_frames_int8_pallas``). The kernel's note says which form runs for
which fft (up to 128: many frames a block; on chip up to 2^17: one block or
one thread-block cluster per frame; a global scratch above, two passes up
to 2^22 and three up to 2^24), what bounds each and what its design does
about it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rtl_sdr_scanner_tpu_torch.ops.psd import dequantize_cs8, device_window, psd_frames


# the largest fft the library instantiates: the three-factor scratch form's
# passes keep >= 8 sequences of <= 2048 points a block at any size memory
# holds; 2^24 is a 4.096 Gsps band at 250 Hz bins
MAX_FFT = 1 << 24
# the kernel's forms, in the order of the library's psd_form() numbers
FORMS = ("small-frame form", "one block a frame", "cluster form", "scratch form", "three-factor scratch form")
SCRATCH_BLOCK_POINTS = 8192  # a scratch pass's block (16384 where its sequences have 2048 points)
SCRATCH3_LAST = 2048  # the three-factor form's last factor C


def _split_n(n: int) -> Tuple[int, int]:
    """N = N1*N2 with N1 >= N2, both powers of two (N a power of two)."""
    log = n.bit_length() - 1
    l1 = (log + 1) // 2
    return 1 << l1, 1 << (log - l1)


def takes_fft(fft_size: int) -> bool:
    """Whether the kernel takes frames of ``fft_size``: a power of two from 2
    (the function's fftshift rides in the window, so the fft is even) to
    2^24 (a 4.096 Gsps band at 250 Hz bins)."""
    return 2 <= fft_size <= MAX_FFT and fft_size & (fft_size - 1) == 0


def scratch_passes(fft_size: int) -> Tuple[Tuple[int, int, int], ...]:
    """The scratch forms' passes at ``fft_size`` as the kernel runs them
    (the plan the CPU tests hold to a block's shared memory; the wrapper
    asks the library for the scratch itself):
    (points a sequence, sequences a block, blocks a frame) for each; () for
    the on-chip and small-frame forms (fft <= 2^17). Two passes over the
    four-step split N1 x N2 up to 2^22, three over N = A x B x C with C =
    2048 above (csrc's Scratch and Scratch3). A block holds 8192 points, or
    16384 where its sequences have 2048, so at least 8 sequences."""
    if not takes_fft(fft_size) or fft_size <= 1 << 17:
        return ()
    if fft_size <= 1 << 22:
        factors = _split_n(fft_size)
    else:
        factors = (*_split_n(fft_size // SCRATCH3_LAST), SCRATCH3_LAST)
    passes = []
    for n in factors:
        seqs = SCRATCH_BLOCK_POINTS * (2 if n == 2048 else 1) // n
        passes.append((n, seqs, fft_size // n // seqs))
    return tuple(passes)


def form(fft_size: int) -> str:
    """The kernel's form for frames of ``fft_size``, as the library (built
    on the card's machine) reports it."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import library

    number = library().psd_form(fft_size.bit_length() - 1)
    if number < 0 or not takes_fft(fft_size):
        raise ValueError(f"psd_frames_int8: no form takes fft {fft_size}")
    return FORMS[number]


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
        raise ValueError(f"psd_frames_int8: fft {fft_size} must be a power of two in [2, 2^24]")
    if not 0 < frames <= 65535:
        raise ValueError(f"psd_frames_int8: {frames} frames outside the grid's 1..65535")
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    lib = library()
    dev = iq_int8.device
    log_n1, log_n2 = n1.bit_length() - 1, n2.bit_length() - 1
    out = torch.empty((frames, fft_size), dtype=torch.float32, device=dev)
    # a device-memory intermediate for the scratch forms only, as large as
    # the library's plan needs; the on-chip forms get none
    per_frame = lib.psd_scratch_bytes(log_n1, log_n2)
    scratch = torch.empty((frames, per_frame), dtype=torch.uint8, device=dev) if per_frame else None
    # the scratch forms compute their window (csrc's HammingFrameIn, the
    # formula of ops/window.hamming); the others read shifted_window's
    win = None if per_frame else device_window(fft_size, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.psd_frames_int8(
        iq_int8.data_ptr(), None if win is None else win.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), frames, log_n1, log_n2, decim, float(sample_rate), stream,
    )
    check(rc, "psd_frames_int8")
    psd_frames_int8.launches += 1
    return out


psd_frames_int8.launches = 0
