"""The hand-written kernels on the card, against their plain versions, and
the port's main path on the card against the same path on the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere. This file imports
no JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py
"""

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu_torch.constants import Tunables
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, fused_step, scan_pipeline
from rtl_sdr_scanner_tpu_torch.ops import detect
from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel, select_kernel

pytestmark = pytest.mark.cuda
DECIM = 3
LEVEL = 8.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("fft", [1024, 8192, 131072])
def test_psd_kernel_matches_plain(fft, dev):
    rng = np.random.default_rng(fft)
    iq = torch.from_numpy(rng.integers(-100, 100, size=(4, fft * DECIM, 2), dtype=np.int8)).to(dev)
    before = psd_kernel.psd_frames_int8.launches
    got = psd_kernel.psd_frames_int8(iq, 256000.0, fft, DECIM)
    torch.cuda.synchronize()
    assert psd_kernel.psd_frames_int8.launches == before + 1
    want = psd_kernel.psd_frames_int8_plain(iq, 256000.0, fft, DECIM)
    # bins within 60 dB of their frame's peak: radix-2 f32 FFT vs cuFFT
    near = want >= want.amax(dim=1, keepdim=True) - 60.0
    diff = (got - want).abs()[near]
    assert diff.max().item() <= 0.02
    assert diff.median().item() <= 1e-3


def test_psd_kernel_rejects_what_it_does_not_take(dev):
    iq = torch.zeros((2, 1024 * DECIM, 2), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        psd_kernel.psd_frames_int8(iq.to(torch.int16), 256000.0, 1024, DECIM)
    with pytest.raises(ValueError):
        psd_kernel.psd_frames_int8(iq, 256000.0, 1024, DECIM + 1)
    with pytest.raises(ValueError):
        psd_kernel.psd_frames_int8(iq.transpose(0, 1).contiguous().transpose(0, 1), 256000.0, 1024, DECIM)


def test_switched_on_kernels_raise_on_what_they_do_not_take(dev):
    """With a kernel switch on, the card never runs the plain version in its
    place: input the kernel does not take raises."""
    fft, f = 1536, 2  # not a whole number of the selection kernel's 1024-bin segments
    rows = torch.zeros((1, f, fft), device=dev)
    with pytest.raises(ValueError):
        detect.compact_detection(
            rows, rows, torch.zeros((1, 10, fft), device=dev),
            torch.full((4,), -1, dtype=torch.int32, device=dev), torch.ones(fft, dtype=torch.bool, device=dev),
            torch.tensor(LEVEL, device=dev), 21, 8, pallas_select=True,
        )
    cfg = scan_pipeline.ScanConfig.create(256_000, f, Tunables(use_pallas_psd=True))
    pairs = torch.zeros((1, f, cfg.fft_size * cfg.decimator_factor, 2), device=dev)
    with pytest.raises(ValueError):
        scan_pipeline._frames_power(cfg, pairs)


def _rows(fft, rng):
    rows = rng.normal(0.0, 6.0, size=(12, fft)).astype(np.float32)
    rows[1:3] = np.round(rows[1:3] / 2.0)  # exact ties
    for c in (100, 1020, 1024, fft // 2, fft - 1):  # clusters across segment borders
        rows[3:5, max(0, c - 60) : c + 60] += 20.0
    rows[5, 1000:1050] = 40.0  # a flat plateau over the segment 0/1 border
    rows[6] = -3.0e38  # fully masked
    rows[7, fft // 3 :] = -3.0e38
    rows[8, :100] = LEVEL  # exactly at the level
    return rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fft,top_k,k_sep,submargin", [
    (1024, 64, 16, 52),  # zones cover the row: the all-suppressed corner
    (2048, 8, 4, 17),
    (8192, 64, 16, 52),
    (131072, 64, 16, 52),
])
def test_selection_kernel_bit_exact(fft, top_k, k_sep, submargin, dtype, dev):
    t = torch.from_numpy(_rows(fft, np.random.default_rng(fft))).to(dtype).to(dev)
    level = torch.tensor(LEVEL, device=dev)
    before = select_kernel.fused_selection.launches
    got = select_kernel.fused_selection(t, level, top_k, k_sep, submargin)
    torch.cuda.synchronize()
    assert select_kernel.fused_selection.launches == before + 1
    want = select_kernel.fused_selection_plain(t, level, top_k, k_sep, submargin)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def _tone_blocks(cfg, blocks, nb, seed):
    """int8 [blocks, nb, F, fft*decim, 2]: noise plus two bin-centred tones
    per band keyed on after noise learning (decisions far from ties)."""
    fft, group = cfg.fft_size, cfg.fft_size * cfg.decimator_factor
    f = cfg.frames_per_block
    n = blocks * f * group
    t = np.arange(n)
    tones = np.array([int(fft * 0.6), int(fft * 0.8)])
    rng = np.random.default_rng(seed)
    on = t >= int(np.ceil(cfg.noise_learning_ms / cfg.frame_interval_ms)) * group
    out = []
    for band in range(nb):
        x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for b, a in zip(tones, (0.5, 0.05) if band % 2 == 0 else (0.05, 0.5)):
            x += on * a * np.exp(2j * np.pi * (b - fft // 2) * t / fft)
        pairs = np.stack([x.real, x.imag], axis=-1)
        out.append(np.clip(np.round(pairs * 127.0), -128, 127).astype(np.int8))
    iq = np.stack(out).reshape(nb, blocks, f, group, 2).transpose(1, 0, 2, 3, 4)
    return np.ascontiguousarray(iq), tones


def test_main_path_on_card_matches_cpu(dev):
    """The banded fused step with both kernels on the card against the same
    step on the CPU (plain versions), at fft 1024."""
    rate, nb, blocks, top_k = 256_000, 2, 4, 64
    cfg = scan_pipeline.ScanConfig.create(
        rate, 10, Tunables(noise_learning_time_ms=300, use_pallas_psd=True, use_pallas_select=True)
    )
    ddc = ddc_pipeline.DdcConfig.create(rate, 16_000, 2, cfg.block_samples)
    group_size = int(np.ceil(16000 / cfg.step_hz))
    iq, tones = _tone_blocks(cfg, blocks, nb, seed=3)
    valid = np.zeros(cfg.fft_size, dtype=bool)
    valid[tones] = True
    keys = (tones - 10 - group_size // 2).astype(np.int32)
    shifts = np.tile((tones[:1] - cfg.fft_size // 2) * rate // cfg.fft_size, (nb, 2)).astype(np.int64)

    runs = {}
    for d in (torch.device("cpu"), dev):
        step = fused_step.make_banded_fused_step(cfg, ddc, group_size, top_k, device=d)
        state = [
            scan_pipeline.init_scan_state(cfg, nb, 0, device=d),
            scan_pipeline.init_spectro_acc(cfg, nb, device=d),
            ddc_pipeline.init_state(ddc, nb, device=d),
        ]
        tables = ddc_pipeline.make_tables(ddc, shifts, device=d)
        shared = [torch.from_numpy(keys).to(d), torch.from_numpy(valid).to(d),
                  torch.tensor(LEVEL, device=d), torch.tensor(1.0, device=d)]
        outs = []
        for b in range(blocks):
            now = ((b * 10 + 1 + np.arange(10)) * cfg.frame_interval_ms).astype(np.int32)
            now = torch.from_numpy(np.broadcast_to(now, (nb, 10)).copy()).to(d)
            *state, out = step(*state, torch.from_numpy(iq[b]).to(d), now, *shared, tables)
            outs.append((out.packed.cpu().numpy(), out.recording.cpu().numpy()))
        runs[d.type] = (outs, state[1].cpu().numpy())

    for (cp, cr), (gp, gr) in zip(runs["cpu"][0], runs["cuda"][0]):
        for band in range(nb):
            c = scan_pipeline.unpack_compact(cp[band], 10, top_k, len(keys))
            g = scan_pipeline.unpack_compact(gp[band], 10, top_k, len(keys))
            for i, (x, y) in enumerate(zip(c, g)):
                if i in (1, 4):  # cand_val, key_val: FFT order differences
                    np.testing.assert_allclose(y, x, atol=1e-3)
                else:
                    np.testing.assert_array_equal(y, x)
        assert np.abs(cr.astype(np.int32) - gr.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], atol=1e-3 * 10 * blocks)
    last = scan_pipeline.unpack_compact(runs["cuda"][0][-1][0][0], 10, top_k, len(keys))
    assert last[-1] and last[0][-1, 0] == tones[0]
