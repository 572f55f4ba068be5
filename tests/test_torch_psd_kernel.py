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

torch.set_num_threads(2)
DECIM = 3
RATE = 256000.0


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
    # f32 FFTs in other summation orders (radix FFTs, the four-step matmul
    # DFT): the JAX package's own tolerance for these, 0.02 dB
    np.testing.assert_allclose(got, pallas, atol=0.02)
    np.testing.assert_allclose(got, xla, atol=0.02)


def test_frame_select_and_pairs_match():
    """frame_blocks + pairs_to_complex + psd_frames (the f32-pairs route)."""
    x = np.random.default_rng(7).standard_normal((5 * 64 * DECIM, 2)).astype(np.float32)
    jframes = frame_blocks(jnp.asarray(x[:, 0] + 1j * x[:, 1]).astype(jnp.complex64), 64, DECIM)
    tframes = tps.frame_blocks(tps.pairs_to_complex(torch.from_numpy(x)), 64, DECIM)
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
    np.testing.assert_allclose(
        tps.psd_frames(tframes, RATE).numpy(), np.asarray(psd_frames(jframes, RATE)), atol=0.02
    )


@pytest.mark.parametrize("int8", [True, False])
def test_frames_power_with_the_kernel_switch_on_the_cpu(int8):
    """On the CPU the switched-on PSD runs the plain version for cs8 and the
    pairs chain for f32 pairs, as the JAX package's XLA route does."""
    cfg = jsp.ScanConfig.create(256_000, 3)
    tcfg = tsp.ScanConfig.create(256_000, 3, Tunables(use_pallas_psd=True))
    rng = np.random.default_rng(11)
    shape = (3, cfg.fft_size * cfg.decimator_factor, 2)
    iq = _iq(3, cfg.fft_size, 11) if int8 else (0.3 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jsp._frames_power(cfg, jnp.asarray(iq)))
    got = tsp._frames_power(tcfg, torch.from_numpy(iq)[None])[0].numpy()
    np.testing.assert_allclose(got, want, atol=0.02)


def test_zero_frames_sit_at_the_floor():
    """|X|^2 = 0 is floored at 1e-30 before the log, on every bin."""
    out = tpsd.psd_frames_int8(torch.zeros((2, 1024 * DECIM, 2), dtype=torch.int8), RATE, 1024, DECIM)
    np.testing.assert_array_equal(out.numpy(), np.float32(10.0 * np.log10(np.float32(1e-30) / np.float32(RATE))))
