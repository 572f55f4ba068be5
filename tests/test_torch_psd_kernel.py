"""PSD of int8 frames: the port's plain version against the JAX package's
Pallas kernel (interpret mode) and its XLA chain. The CUDA kernel is held
against the plain version in tests/test_torch_on_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.models import scan_pipeline as jsp
from rtl_sdr_scanner_tpu.ops.pallas.psd_kernel import psd_frames_int8_pallas
from rtl_sdr_scanner_tpu.ops.psd import dequantize_cs8, frame_blocks, psd_frames
from rtl_sdr_scanner_tpu_torch.constants import Tunables
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
from rtl_sdr_scanner_tpu_torch.ops import psd as tps
from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel as tpsd
from torch_checks import psd_agreement, psd_within_bar

torch.set_num_threads(2)
DECIM = 3
RATE = 256000.0


def _hold(got, want):
    """The PSD bar (torch_checks.psd_agreement): 0.02 dB on the bins within 60
    dB of their row's peak, a median of 1e-3 dB over every bin, |dP| <= 1e-5
    of the row's peak power on every bin. f32 FFTs in other summation orders
    (radix FFTs, the four-step matmul DFT) round a deep null of a noise
    spectrum apart by more than any dB bar."""
    rows = [torch.from_numpy(np.array(x, np.float32).reshape(-1, np.shape(x)[-1])) for x in (got, want)]
    agreement = psd_agreement(*rows)
    assert psd_within_bar(agreement), agreement


def _iq(frames, fft, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-100, 100, size=(frames, fft * DECIM, 2), dtype=np.int8)


def test_split_n():
    assert tpsd._split_n(1024) == (32, 32)
    assert tpsd._split_n(8192) == (128, 64)
    assert tpsd._split_n(131072) == (512, 256)


@pytest.mark.parametrize("fft", [1024, 8192])
def test_plain_matches_pallas_and_xla(fft):
    iq = _iq(3, fft, fft)
    got = tpsd.psd_frames_int8(torch.from_numpy(iq), RATE, fft, DECIM).numpy()
    assert got.shape == (3, fft) and got.dtype == np.float32

    pallas = np.asarray(psd_frames_int8_pallas(jnp.asarray(iq), RATE, fft, DECIM, interpret=True))
    xla = np.asarray(
        psd_frames(frame_blocks(dequantize_cs8(jnp.asarray(iq)).reshape(-1), fft, DECIM), RATE)
    )
    _hold(got, pallas)
    _hold(got, xla)


def test_frame_select_and_pairs_match():
    """frame_blocks + pairs_to_complex + psd_frames (the f32-pairs route)."""
    x = np.random.default_rng(7).standard_normal((5 * 64 * DECIM, 2)).astype(np.float32)
    jframes = frame_blocks(jnp.asarray(x[:, 0] + 1j * x[:, 1]).astype(jnp.complex64), 64, DECIM)
    tframes = tps.frame_blocks(tps.pairs_to_complex(torch.from_numpy(x)), 64, DECIM)
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
    _hold(tps.psd_frames(tframes, RATE).numpy(), np.asarray(psd_frames(jframes, RATE)))


@pytest.mark.parametrize("int8", [True, False])
def test_frames_power_with_the_kernel_switch_on_the_cpu(int8):
    """On the CPU the PSD (which has no switch now: cs8 always goes to the
    kernel's wrapper) runs the plain version for cs8 and the pairs chain
    for f32 pairs, as the JAX package's XLA route does."""
    cfg = jsp.ScanConfig.create(256_000, 3)
    tcfg = tsp.ScanConfig.create(256_000, 3, Tunables())
    rng = np.random.default_rng(11)
    shape = (3, cfg.fft_size * cfg.decimator_factor, 2)
    iq = _iq(3, cfg.fft_size, 11) if int8 else (0.3 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jsp._frames_power(cfg, jnp.asarray(iq)))
    got = tsp._frames_power(tcfg, torch.from_numpy(iq)[None])[0].numpy()
    _hold(got, want)


def test_zero_frames_sit_at_the_floor():
    """|X|^2 = 0 is floored at 1e-30 before the log, on every bin."""
    out = tpsd.psd_frames_int8(torch.zeros((2, 1024 * DECIM, 2), dtype=torch.int8), RATE, 1024, DECIM)
    np.testing.assert_array_equal(out.numpy(), np.float32(10.0 * np.log10(np.float32(1e-30) / np.float32(RATE))))


@pytest.mark.parametrize("fft,frames,decim", [
    (16, 5, 3), (64, 5, 3), (128, 7, 1),  # the kernel's small-frame form: a band of 32 kHz or less
    (1 << 18, 3, 2),  # its scratch form's smallest: 16 sequences a block in both passes
    (1 << 21, 2, 1), (1 << 21, 2, 3),  # its 2048-point column passes: 491.52 Msps at 234 Hz bins
    (1 << 23, 1, 1),  # its cluster scratch form (4096-point columns): 1966.08 Msps at 234 Hz bins
])
def test_plain_matches_xla_at_the_small_and_large_forms(fft, frames, decim):
    """The sizes the kernel's small-frame form and its scratch forms take,
    where the JAX package's int8 ingest runs XLA's FFT: the plain version
    (what a CPU tensor gets) within the PSD bar of it."""
    iq = np.random.default_rng(fft + decim).integers(-100, 100, size=(frames, fft * decim, 2), dtype=np.int8)
    got = tpsd.psd_frames_int8(torch.from_numpy(iq), RATE, fft, decim).numpy()
    assert got.shape == (frames, fft) and got.dtype == np.float32
    xla = psd_frames(frame_blocks(dequantize_cs8(jnp.asarray(iq)).reshape(-1), fft, decim), RATE)
    _hold(got, np.asarray(xla))


def test_kernel_takes_every_power_of_two_up_to_2_24():
    """Every power of two from 2 to 2^24 (4.096 Gsps at 250 Hz bins; the
    cluster scratch form above 2^22) has a form of the kernel; 1 (no
    fftshift by (-1)^n), 2^25 (above the sizes the library instantiates)
    and sizes that are not powers of two do not."""
    assert tpsd.MAX_FFT == 1 << 24
    assert all(tpsd.takes_fft(1 << log) for log in range(1, 25))
    assert not any(tpsd.takes_fft(fft) for fft in (0, 1, 96, 3 << 10, 1 << 25))
    assert all(n1 * n2 == fft and n1 in (n2, 2 * n2) for fft in (1 << log for log in range(1, 25))
               for n1, n2 in [tpsd._split_n(fft)])


@pytest.mark.parametrize("log_n", range(18, 25))
def test_scratch_form_window_formula_matches_shifted_window(log_n):
    """The scratch forms compute their window on the card (psd_kernel.cu's
    HammingFrameIn) where the other forms read ops.psd.shifted_window. Its
    coefficients, read from the source, evaluated as the kernel does (a
    butterfly's first point from a double cos, then R - 1 f32 rotations by
    2 pi Q N2 / (N - 1)), within 1e-6 of shifted_window at every point. The
    first pass's columns are N1 points at stride N2."""
    import re
    from pathlib import Path

    src = (Path(tpsd.__file__).resolve().parents[2] / "csrc" / "psd_kernel.cu").read_text()
    body = src[src.index("struct HammingFrameIn {"):]
    a, b = (np.float32(c) for c in re.search(r"win\[r\] = \(([\d.]+)f - ([\d.]+)f \* z\.x\) \* sign;", body).groups())
    assert "kPerN = 2.0 / (double)((1 << LOG_N) - 1);" in body  # cos(2 pi n / (N - 1)), a symmetric window
    n = 1 << log_n
    n1 = tpsd.scratch_passes(n)[0][0]  # pass 1's column length, the column stride n2 = n / n1
    n2 = n // n1
    # pass 1's first radix (next_radix_log): 4096 = 8 x 32 x 16, 2048 = 8 x 16 x 16, 128 = 16 x 8,
    # 64 = 8 x 8, else 32 first
    r_first = {4096: 8, 2048: 8, 128: 16, 64: 8}.get(n1, 32)
    q = n1 // r_first
    first = (np.arange(q)[:, None] * n2 + np.arange(n2)[None, :]) * (2.0 / (n - 1))
    z = (np.cos(np.pi * first) + 1j * np.sin(np.pi * first)).astype(np.complex64)
    step = np.complex64(np.exp(1j * np.pi * q * n2 * (2.0 / (n - 1))))
    sign = np.where(np.arange(n2) % 2 == 1, np.float32(-1.0), np.float32(1.0))
    win = np.empty((r_first, q, n2), np.float32)
    for r in range(r_first):
        win[r] = (a - b * z.real) * sign
        z = z * step
    np.testing.assert_allclose(win.reshape(n), tps.shifted_window(n), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fft,want", [
    (1 << 17, ()),  # the cluster form: on chip, no scratch
    (1 << 18, ((512, 16, 1, 32), (512, 16, 1, 32))),
    (1 << 21, ((2048, 8, 1, 128), (1024, 8, 1, 256))),
    (1 << 22, ((2048, 8, 1, 256), (2048, 8, 1, 256))),
    (1 << 23, ((4096, 4, 2, 512), (2048, 8, 1, 512))),  # 1.966 Gsps: 4096 x 2048, columns on clusters
    (1 << 24, ((4096, 4, 2, 1024), (4096, 4, 2, 1024))),  # 3.932 Gsps: 4096 x 4096, both on clusters
])
def test_scratch_pass_plan(fft, want):
    """The scratch forms' two passes as the kernel runs them: (points a
    sequence, sequences a block, blocks a cluster, blocks a frame). Each
    block holds 8192 points (16384 for 2048- and 4096-point sequences), its
    cluster (or the lone block) at least 8 sequences, and its shared memory
    (the sequences plus psd_kernel.cu's SmemPad pad after every first radix)
    within a block's 227 KB; the factors multiply to the fft. (The scratch
    the library asks for, one complex f32 frame, is held on the card:
    test_psd_kernel_takes_a_scratch_only_above_the_cluster_form.)"""
    passes = tpsd.scratch_passes(fft)
    assert passes == want
    if not want:
        return
    assert np.prod([n for n, _, _, _ in passes]) == fft and len(passes) == 2
    radix = {4096: 8, 2048: 8, 1024: 32, 512: 32, 128: 16, 64: 8}
    for n, seqs, cluster, blocks in passes:
        assert seqs * cluster >= 8 and n * seqs in (8192, 16384) and n * seqs * blocks == fft
        assert blocks % cluster == 0 and cluster == (2 if n == 4096 else 1)
        pad = n // radix[n] * seqs
        assert 8 * (n * seqs + pad) <= 232448
    assert not tpsd.scratch_passes(1 << 25)
