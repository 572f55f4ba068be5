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
from rtl_sdr_scanner_tpu_torch.ops import ddc, detect
from rtl_sdr_scanner_tpu_torch.ops.cuda import channelizer_kernel, fir_kernel, psd_kernel, select_kernel
from torch_checks import (
    RT_TONE, SPLIT_SELECT_CASES, compare_payloads, psd_agreement, psd_within_bar, recorded_tone, run_main,
    split_selection_rows, write_capture,
)

pytestmark = pytest.mark.cuda
DECIM = 3
LEVEL = 8.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("fft,decim,frames", [
    (256, 1, 5),  # one block a frame: its smallest
    (1024, DECIM, 4),
    (8192, DECIM, 4),
    (16384, 2, 4),  # one block a frame: its largest (the RTL-SDR path)
    (16384, 1, 7),
    (32768, DECIM, 5),  # a cluster a frame: its smallest
    (65536, 2, 3),
    (131072, DECIM, 4),  # a cluster a frame: its largest (path 1)
    (131072, 1, 3),
    (262144, 2, 3),  # the scratch form
])
def test_psd_kernel_matches_plain(fft, decim, frames, dev):
    rng = np.random.default_rng(fft + frames)
    iq = torch.from_numpy(rng.integers(-100, 100, size=(frames, fft * decim, 2), dtype=np.int8)).to(dev)
    before = psd_kernel.psd_frames_int8.launches
    got = psd_kernel.psd_frames_int8(iq, 256000.0, fft, decim)
    torch.cuda.synchronize()
    assert psd_kernel.psd_frames_int8.launches == before + 1
    want = psd_kernel.psd_frames_int8_plain(iq, 256000.0, fft, decim)
    # bins within 60 dB of their frame's peak: radix-2 f32 FFT vs cuFFT
    near = want >= want.amax(dim=1, keepdim=True) - 60.0
    diff = (got - want).abs()[near]
    assert diff.max().item() <= 0.02
    assert diff.median().item() <= 1e-3


@pytest.mark.parametrize("fft,decim,frames", [
    (2, 1, 3), (16, 1, 7), (32, 2, 33),  # the small-frame form: 4096 / fft frames a block
    (64, 3, 129), (128, 4, 1801), (128, 1, 1),
    (1 << 21, 1, 3), (1 << 21, 4, 3),  # the scratch form's 2048-point pass 1 (8 columns a block)
    (1 << 22, 2, 3), (1 << 22, 3, 1),  # and its 2048-point pass 2 (8 rows a block)
])
def test_psd_kernel_small_and_large_forms_match_plain(fft, decim, frames, dev):
    """The forms for fft <= 128 and 2^21-2^22 against the plain version under
    the PSD bar (psd_agreement: 0.02 dB within 60 dB of the
    frame's peak, a median of 1e-3 dB over every bin, |dP| <= 1e-5 of the
    peak power)."""
    rng = np.random.default_rng(fft + frames + decim)
    iq = torch.from_numpy(rng.integers(-100, 100, size=(frames, fft * decim, 2), dtype=np.int8)).to(dev)
    before = psd_kernel.psd_frames_int8.launches
    got = psd_kernel.psd_frames_int8(iq, 256000.0, fft, decim)
    torch.cuda.synchronize()
    assert psd_kernel.psd_frames_int8.launches == before + 1
    assert got.shape == (frames, fft) and bool(torch.isfinite(got).all())
    want = psd_kernel.psd_frames_int8_plain(iq, 256000.0, fft, decim)
    agreement = psd_agreement(got, want)
    assert psd_within_bar(agreement), agreement


@pytest.mark.parametrize("fft,decim,frames", [
    (1 << 18, 1, 17), (1 << 18, 4, 3),  # 16 columns / rows a block in both passes
    (1 << 19, 2, 1), (1 << 19, 3, 17),  # 8 columns, 16 rows
    (1 << 20, 1, 3), (1 << 20, 4, 1),  # 8 and 8
    (1 << 21, 2, 17), (1 << 21, 3, 1),  # 8 and 8: three Stockham passes in pass 1
    (1 << 22, 4, 3), (1 << 22, 1, 17),  # 8 and 8: three in both
])
def test_psd_kernel_scratch_form_matches_plain(fft, decim, frames, dev):
    """The scratch form (fft 2^18-2^22: Stockham passes of 8192 points a
    block up to 1024-point sequences, 16384 for 2048) against the plain
    version under the PSD bar, at decimations 1-4 and odd frame counts."""
    rng = np.random.default_rng(fft // 1024 + frames + decim)
    iq = torch.from_numpy(rng.integers(-100, 100, size=(frames, fft * decim, 2), dtype=np.int8)).to(dev)
    before = psd_kernel.psd_frames_int8.launches
    got = psd_kernel.psd_frames_int8(iq, 491.52e6, fft, decim)
    torch.cuda.synchronize()
    assert psd_kernel.psd_frames_int8.launches == before + 1
    assert psd_kernel.form(fft) == "scratch form"
    assert got.shape == (frames, fft) and bool(torch.isfinite(got).all())
    want = psd_kernel.psd_frames_int8_plain(iq, 491.52e6, fft, decim)
    agreement = psd_agreement(got, want)
    assert psd_within_bar(agreement), agreement


@pytest.mark.parametrize("fft,decim,frames", [
    (1 << 23, 4, 16), (1 << 23, 1, 3),  # 1966.08 Msps: 4096 x 2048, the columns on clusters
    (1 << 24, 4, 16), (1 << 24, 2, 1),  # 3932.16 Msps: 4096 x 4096; 16 frames are 2^31 B of int8
])
def test_psd_kernel_cluster_scratch_form_matches_plain(fft, decim, frames, dev):
    """The cluster scratch form (fft 2^23-2^24: two passes, the 4096-point
    ones on two-block clusters) against the plain version under the PSD
    bar, at 16 frames of decim 4 (a direct-sampling band's block) and odd
    counts."""
    rng = np.random.default_rng(fft // 1024 + frames + decim)
    iq = torch.from_numpy(rng.integers(-100, 100, size=(frames, fft * decim, 2), dtype=np.int8)).to(dev)
    before = psd_kernel.psd_frames_int8.launches
    got = psd_kernel.psd_frames_int8(iq, 1.96608e9, fft, decim)
    torch.cuda.synchronize()
    assert psd_kernel.psd_frames_int8.launches == before + 1
    assert psd_kernel.form(fft) == "cluster scratch form"
    assert got.shape == (frames, fft) and bool(torch.isfinite(got).all())
    want = psd_kernel.psd_frames_int8_plain(iq, 1.96608e9, fft, decim)
    agreement = psd_agreement(got, want)
    assert psd_within_bar(agreement), agreement


def test_psd_kernel_takes_a_scratch_only_above_the_cluster_form(dev):
    """fft <= 2^17 stays on chip (one block or one cluster a frame, no
    device-memory intermediate); only the scratch forms above need one, a
    complex f32 frame, the size the wrapper allocates."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    lib = build.library()
    for log in range(1, 25):
        logs = [n.bit_length() - 1 for n in psd_kernel._split_n(1 << log)]
        assert lib.psd_scratch_bytes(*logs) == (8 << log if log > 17 else 0)
        assert (lib.psd_max_active_clusters(*logs) > 0) == (15 <= log <= 17)
        want = 0 if log <= 7 else 1 if log <= 14 else 2 if log <= 17 else 3 if log <= 22 else 4
        assert psd_kernel.form(1 << log) == psd_kernel.FORMS[want]
    assert lib.psd_form(0) == lib.psd_form(25) == -1
    fft, frames = 131072, 8
    iq = torch.zeros((frames, fft * DECIM, 2), dtype=torch.int8, device=dev)
    psd_kernel.psd_frames_int8(iq, 256000.0, fft, DECIM)  # the window, cached
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = psd_kernel.psd_frames_int8(iq, 256000.0, fft, DECIM)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - before == out.numel() * out.element_size()


def test_psd_kernel_rejects_what_it_does_not_take(dev):
    iq = torch.zeros((2, 1024 * DECIM, 2), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        psd_kernel.psd_frames_int8(iq.to(torch.int16), 256000.0, 1024, DECIM)
    with pytest.raises(ValueError):
        psd_kernel.psd_frames_int8(iq, 256000.0, 1024, DECIM + 1)
    with pytest.raises(ValueError):
        psd_kernel.psd_frames_int8(iq.transpose(0, 1).contiguous().transpose(0, 1), 256000.0, 1024, DECIM)


def test_switched_on_kernels_raise_on_what_they_do_not_take(dev):
    """The card never runs a plain version in a kernel's place: input the
    kernel does not take raises (there are no switches: every route on the
    card is a kernel's)."""
    fft, f = 1536, 2  # 48 leaves: more than 32, not whole groups of the selection kernel's table
    rows = torch.zeros((1, f, fft), device=dev)
    with pytest.raises(ValueError):
        detect.compact_detection(
            rows, rows, torch.zeros((1, 10, fft), device=dev),
            torch.full((4,), -1, dtype=torch.int32, device=dev), torch.ones(fft, dtype=torch.bool, device=dev),
            torch.tensor(LEVEL, device=dev), 21, 8,
        )
    cfg = scan_pipeline.ScanConfig.create(256_000, f)
    pairs = torch.zeros((f, cfg.fft_size * cfg.decimator_factor, 2), device=dev)
    with pytest.raises(ValueError):
        psd_kernel.psd_frames_int8(pairs, 256000.0, cfg.fft_size, cfg.decimator_factor)
    plan = ddc.plan_stage(2, 125)  # interpolating: the FIR kernel is decimation-only
    with pytest.raises(ValueError):
        fir_kernel.stage_apply_fir(
            torch.zeros((1, 2, 1250), device=dev), torch.zeros((1, 2, plan.tail_len), device=dev), plan
        )
    plan = ddc.plan_stage(1, 75)
    with pytest.raises(ValueError):  # not contiguous
        fir_kernel.stage_apply_fir(
            torch.zeros((1, 1500, 2), device=dev).transpose(1, 2),
            torch.zeros((1, 2, plan.tail_len), device=dev), plan,
        )


def _at_offset(a: np.ndarray, dev, offset: int) -> torch.Tensor:
    """a on the card as a contiguous tensor ``offset`` floats into a larger
    buffer (offset 1-3: its data pointer is not 16-byte aligned)."""
    buf = torch.zeros(a.size + offset + 3, dtype=torch.float32, device=dev)
    t = buf[offset : offset + a.size].view(a.shape)
    t.copy_(torch.from_numpy(a))
    assert t.is_contiguous() and t.data_ptr() % 16 == 4 * (offset % 4)
    return t


@pytest.mark.parametrize("case", ["ragged", "short", "offset"])
@pytest.mark.parametrize("decim", [8, 25, 32, 40, 75, 125, 151, 157, 400])
def test_fir_kernel_matches_plain(decim, case, dev):
    """<= 2e-5 * max against the plain version (f32 sum order), the new
    tail exact, over three calls carrying the tail, at every decimation of
    a real chain. ragged: 1000 outputs, not a whole number of the kernel's
    tiles; short: 8 outputs, a chunk shorter than the tail; offset: x and
    tail at 1 and 3 floats into larger buffers (16-byte copies must
    realign). M = 151, 157 (primes the resampler planner keeps whole) and
    400 have windows too large for a block's shared memory: the wide form."""
    ddc.no_tf32()
    plan = ddc.plan_stage(1, decim)
    rng = np.random.default_rng(decim)
    out = 8 if case == "short" else 1000
    x_off, t_off = (1, 3) if case == "offset" else (0, 0)
    tail0 = rng.standard_normal((3, 2, plan.tail_len)).astype(np.float32)
    tail, ptail = _at_offset(tail0, dev, t_off), torch.from_numpy(tail0).to(dev)
    for _ in range(3):
        x = _at_offset(rng.standard_normal((3, 2, decim * out)).astype(np.float32), dev, x_off)
        before = fir_kernel.stage_apply_fir.launches
        got, tail = fir_kernel.stage_apply_fir(x, tail, plan)
        torch.cuda.synchronize()
        assert fir_kernel.stage_apply_fir.launches == before + 1
        want, ptail = fir_kernel.stage_apply_fir_plain(x, ptail, plan)
        assert got.shape == want.shape == (3, 2, out)
        assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()
        assert torch.equal(tail, ptail)
        if case == "offset":
            tail = _at_offset(tail.cpu().numpy(), dev, t_off)


def _rows(fft, rng, n_rows):
    rows = rng.normal(0.0, 6.0, size=(max(n_rows, 12), fft)).astype(np.float32)
    rows[1:3] = np.round(rows[1:3] / 2.0)  # exact ties
    for c in (100, 1020, 1024, fft // 2, fft - 1):  # clusters across segment borders
        rows[3:5, max(0, c - 60) : c + 60] += 20.0
    rows[5, 1000:1050] = 40.0  # a flat plateau over the segment 0/1 border
    rows[6] = -3.0e38  # fully masked
    rows[7, fft // 3 :] = -3.0e38
    rows[8, :100] = LEVEL  # exactly at the level
    rows[9:12] = rows[1]  # rows of one block (4 a block) whose winners tie, within and across rows
    rows[12::2] = np.round(rows[12::2] / 3.0)  # more tied rows, over many blocks
    return rows[:n_rows]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fft,top_k,k_sep,submargin,n_rows", [
    (256, 64, 16, 52, 12),  # 8 leaves: a group a leaf, 24 lanes without one
    (512, 64, 16, 64, 12),  # a 128 kHz wideband channel at 250 Hz bins: group 128
    (512, 64, 16, 64, 1100),
    (1024, 64, 16, 52, 12),  # zones cover the row: the all-suppressed corner
    (2048, 8, 4, 17, 12),
    (8192, 64, 16, 52, 12),
    (131072, 64, 16, 52, 12),
    (16384, 64, 16, 110, 12),  # the RTL-SDR path: group 219
    (16384, 64, 16, 110, 1100),  # more rows than one wave of 256-thread blocks a row
])
def test_selection_kernel_bit_exact(fft, top_k, k_sep, submargin, n_rows, dtype, dev):
    t = torch.from_numpy(_rows(fft, np.random.default_rng(fft), n_rows)).to(dtype).to(dev)
    level = torch.tensor(LEVEL, device=dev)
    before = select_kernel.fused_selection.launches
    got = select_kernel.fused_selection(t, level, top_k, k_sep, submargin)
    torch.cuda.synchronize()
    assert select_kernel.fused_selection.launches == before + 1
    want = select_kernel.fused_selection_plain(t, level, top_k, k_sep, submargin)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def _small_rows(fft, rng, n_rows):
    """Rows of at most 128 bins: ties, masked tails the top-K reaches into
    (and tails of the sentinel itself), fully masked and all-equal rows,
    values at the level, the strongest bins at the row's ends."""
    rows = rng.normal(0.0, 6.0, size=(n_rows, fft)).astype(np.float32)
    rows[1::7] = np.round(rows[1::7] / 3.0)
    rows[2::7, fft // 3 :] = -3.0e38
    rows[3::7, fft // 2 :] = -3.3e38  # SUPPRESSED itself
    rows[4::7] = -3.0e38
    rows[5::7] = LEVEL
    rows[6::7, :2] = 50.0
    rows[6::7, -2:] = 50.0
    return rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fft,top_k,k_sep,submargin,n_rows", [
    (16, 16, 16, 40, 30),  # top_k = fft, zones wider than the row
    (16, 8, 4, 0, 7),
    (32, 8, 16, 3, 30),
    (64, 64, 16, 16, 30),  # a 16 kHz band
    (64, 32, 32, 100, 30),
    (128, 64, 16, 32, 1024),  # 64 channels of 32 kHz: group 64
    (128, 64, 16, 200, 30),
    (100, 50, 16, 7, 9),  # not a power of two: the register form takes any fft up to 128
])
def test_selection_kernel_register_form_bit_exact(fft, top_k, k_sep, submargin, n_rows, dtype, dev):
    t = torch.from_numpy(_small_rows(fft, np.random.default_rng(fft + top_k), n_rows)).to(dtype).to(dev)
    level = torch.tensor(LEVEL, device=dev)
    before = select_kernel.fused_selection.launches
    got = select_kernel.fused_selection(t, level, top_k, k_sep, submargin)
    torch.cuda.synchronize()
    assert select_kernel.fused_selection.launches == before + 1
    want = select_kernel.fused_selection_plain(t, level, top_k, k_sep, submargin)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rows,fft,top_k,k_sep,submargin", SPLIT_SELECT_CASES)
def test_selection_kernel_row_split_form_bit_exact(n_rows, fft, top_k, k_sep, submargin, dtype, dev):
    """The row-split form (select_kernel.row_slices > 0: one row of 2^18 bins,
    the 491.52 Msps block's 16 of 2^21, a time shard's 45 and a band shard's
    180 of 131072, 16 of 2^23 and 2^24 on widened leaves, zones wider than a
    slice's 4096 bins, 384 rows) and the
    warp-a-row form at the boundary (385 rows), bit-exact against the plain
    version on rows with ties across every slice edge, masked tails and the
    all-suppressed corner (split_selection_rows)."""
    slices = select_kernel.row_slices(n_rows, fft)
    assert (slices > 0) == (n_rows <= select_kernel.SPLIT_MAX_ROWS)
    rows = split_selection_rows(fft, n_rows, fft // max(slices, 2), np.random.default_rng(n_rows + submargin))
    t = torch.from_numpy(rows).to(dtype).to(dev)
    level = torch.tensor(LEVEL, device=dev)
    before = select_kernel.fused_selection.launches
    got = select_kernel.fused_selection(t, level, top_k, k_sep, submargin)
    torch.cuda.synchronize()
    assert select_kernel.fused_selection.launches == before + 1
    want = select_kernel.fused_selection_plain(t, level, top_k, k_sep, submargin)
    for name, g, w in zip(("top_val", "top_idx", "sep_val", "sep_idx", "count"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), (name, (g != w).nonzero()[:5].tolist())


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


def _card_against_cpu(dev, rate, bw, frames):
    """The banded fused step with default Tunables on the card against the
    same step on the CPU (plain versions), 2 bands x 4 blocks; returns the
    card's launches of each kernel over the 4 blocks."""
    nb, blocks, top_k = 2, 4, 64
    cfg = scan_pipeline.ScanConfig.create(rate, frames, Tunables(noise_learning_time_ms=300))
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, bw, 2, cfg.block_samples)
    group_size = int(np.ceil(16000 / cfg.step_hz))
    iq, tones = _tone_blocks(cfg, blocks, nb, seed=3)
    valid = np.zeros(cfg.fft_size, dtype=bool)
    valid[tones] = True
    keys = (tones - 10 - group_size // 2).astype(np.int32)
    shifts = np.tile((tones[:1] - cfg.fft_size // 2) * rate // cfg.fft_size, (nb, 2)).astype(np.int64)
    kernels = (psd_kernel.psd_frames_int8, select_kernel.fused_selection, fir_kernel.stage_apply_fir)

    runs = {}
    for d in (torch.device("cpu"), dev):
        step = fused_step.make_banded_fused_step(cfg, ddc_cfg, group_size, top_k, device=d)
        state = [
            scan_pipeline.init_scan_state(cfg, nb, 0, device=d),
            scan_pipeline.init_spectro_acc(cfg, nb, device=d),
            ddc_pipeline.init_state(ddc_cfg, nb, device=d),
        ]
        tables = ddc_pipeline.make_tables(ddc_cfg, shifts, device=d)
        shared = [torch.from_numpy(keys).to(d), torch.from_numpy(valid).to(d),
                  torch.tensor(LEVEL, device=d), torch.tensor(1.0, device=d)]
        outs = []
        before = [k.launches for k in kernels]
        for b in range(blocks):
            now = ((b * frames + 1 + np.arange(frames)) * cfg.frame_interval_ms).astype(np.int32)
            now = torch.from_numpy(np.broadcast_to(now, (nb, frames)).copy()).to(d)
            *state, out = step(*state, torch.from_numpy(iq[b]).to(d), now, *shared, tables)
            outs.append((out.packed.cpu().numpy(), out.recording.cpu().numpy()))
        runs[d.type] = (outs, state[1].cpu().numpy(), [k.launches - n for k, n in zip(kernels, before)])

    assert runs["cpu"][2] == [0, 0, 0]
    for (cp, cr), (gp, gr) in zip(runs["cpu"][0], runs["cuda"][0]):
        for band in range(nb):
            c = scan_pipeline.unpack_compact(cp[band], frames, top_k, len(keys))
            g = scan_pipeline.unpack_compact(gp[band], frames, top_k, len(keys))
            for i, (x, y) in enumerate(zip(c, g)):
                if i in (1, 4):  # cand_val, key_val: FFT order differences
                    np.testing.assert_allclose(y, x, atol=1e-3)
                else:
                    np.testing.assert_array_equal(y, x)
        assert np.abs(cr.astype(np.int32) - gr.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], atol=1e-3 * frames * blocks)
    last = scan_pipeline.unpack_compact(runs["cuda"][0][-1][0][0], frames, top_k, len(keys))
    assert last[-1] and last[0][-1, 0] == tones[0]
    return runs["cuda"][2]


def test_main_path_on_card_matches_cpu(dev):
    """Modulated-taps DDC at fft 1024: the PSD and selection kernels."""
    assert _card_against_cpu(dev, 256_000, 16_000, 10)[:2] == [4, 4]


def test_v1_step_on_card_launches_all_three_kernels(dev):
    """v1 DDC (240 kHz -> 3.2 kHz, stage (1, 75), one chunk per block) with
    default Tunables: the PSD, selection and FIR kernels each launch once a
    block, and the card equals the CPU."""
    assert _card_against_cpu(dev, 240_000, 3_200, 75) == [4, 4, 4]


def test_modtap_stage_2_on_card_goes_through_the_fir_kernel(dev):
    """Modulated taps (512 kHz -> 3.2 kHz: stage (1, 10), then (1, 16)):
    the decimating stage 2 launches the FIR kernel once a block, and the
    card equals the CPU."""
    assert _card_against_cpu(dev, 512_000, 3_200, 10) == [4, 4, 4]


def test_session_on_card_matches_cpu(dev, tmp_path):
    """The runtime session (Scanner over a replayed 6 s RTL-SDR capture,
    2.4 Msps cs8, 32 kHz recordings) on the card through all three kernels
    and on the CPU through their plain versions: the same payload stream
    (compare_payloads: topics and order, headers, IQ within 1
    LSB, spectrogram bins within 1), the planted signal recorded."""
    import chip_smoke

    capture = tmp_path / "capture.cs8"
    write_capture(capture, chip_smoke.RT_RATE, 6.2, chip_smoke.RT_SHIFT, (3.0, 5.0))
    config = chip_smoke.runtime_config(capture, chip_smoke.RT_RATE, chip_smoke.RT_CENTER)
    wrappers = (psd_kernel.psd_frames_int8, select_kernel.fused_selection, fir_kernel.stage_apply_fir)
    before = [fn.launches for fn in wrappers]
    card, _, _, _ = chip_smoke.run_scanner(config, dev)
    assert all(fn.launches > b for fn, b in zip(wrappers, before))
    cpu, _, _, _ = chip_smoke.run_scanner(config, torch.device("cpu"))
    stats = compare_payloads(cpu, card)
    assert stats["transmissions"] > 0
    _, n, tone = recorded_tone(card, chip_smoke.RT_CENTER + chip_smoke.RT_SHIFT, 32_000)
    assert n > 32_000 and abs(tone - RT_TONE) < 40


@pytest.mark.parametrize("size", ["ragged", "8192"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("oversample", [1, 2])
@pytest.mark.parametrize("b", [2, 8, 12, 16, 64, 128])
def test_channelizer_on_card_matches_cpu(b, oversample, dtype, size, dev):
    """The bank on the card (the analysis-bank kernel, its FFT form for the
    powers of two to 64 and its direct-DFT form for 12 and 128: from the
    int8 or f32 pairs as they are, and from the [2, n] components of the 2x
    bank's even and odd phases) against the same calls on the CPU (the
    matmul form) over three streamed blocks of b * 8192 samples (many runs
    of the kernel's grid) or of n not a multiple of the kernel's run:
    channels within 2e-5 (atol = rtol, tests/test_channelizer.py's bar
    between the bank's forms), the carried tails exact, one launch a bank;
    the critically sampled bank of n not a multiple of the run also within
    2e-5 of the numpy offline model (``offline_channelize``) over the whole
    stream."""
    from rtl_sdr_scanner_tpu_torch.ops import channelizer as ch

    plan = ch.plan_channelizer(b, oversample=oversample)
    fn = ch.channelize_block_2x_pairs if oversample == 2 else ch.channelize_block_pairs
    init = ch.init_channelizer2x_state if oversample == 2 else ch.init_channelizer_state
    states = {d: init(plan, d) for d in ("cpu", dev)}
    rng = np.random.default_rng(b + oversample)
    m = channelizer_kernel.run_length(b) + 77 if size == "ragged" else 8192
    stream, outs_card = [], []
    for _ in range(3):
        pairs = torch.from_numpy(rng.integers(-100, 100, size=(b * m, 2), dtype=np.int8))
        if dtype == "float32":
            pairs = pairs.to(torch.float32) * (1.0 / 127.5)
        outs = {}
        before = channelizer_kernel.analysis_bank.launches
        for d in ("cpu", dev):
            states[d], outs[d] = fn(plan, states[d], pairs.to(d))
        torch.cuda.synchronize()
        assert channelizer_kernel.analysis_bank.launches == before + oversample
        got, want = outs[dev].cpu(), outs["cpu"]
        assert got.shape == (b, oversample * m, 2)
        assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())
        tail = states[dev].even.tail if oversample == 2 else states[dev].tail
        want_tail = states["cpu"].even.tail if oversample == 2 else states["cpu"].tail
        assert torch.equal(tail.cpu(), want_tail) and want_tail.abs().max() > 0
        stream.append(pairs.to(torch.float32) * (1.0 / 127.5 if dtype == "int8" else 1.0))
        outs_card.append(got)
    if oversample == 1 and size == "ragged":
        x = torch.cat(stream).double().numpy()
        ref = torch.from_numpy(ch.offline_channelize(plan, x[:, 0] + 1j * x[:, 1]))
        want = torch.stack([ref.real, ref.imag], dim=-1)
        got = torch.cat(outs_card, dim=1).double()
        assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())


def _wideband_capture(tmp_path, seconds=6.0):
    import chip_smoke

    capture = tmp_path / "wide.cs8"
    write_capture(capture, chip_smoke.WB_RATE, seconds, chip_smoke.WB_SIGNALS, (2.5, 5.0), seed=7)
    return capture


@pytest.mark.parametrize("form", ["serial", "fused"])
def test_wideband_session_on_card_matches_cpu(form, dev, tmp_path):
    """A wideband device (2.048 Msps into 16 channels of 128 kHz: fft 512,
    the selection kernel's 16-leaf table) on the card and on the CPU: the
    same payloads (compare_payloads), both transmissions
    recorded; the selection kernel launched, the PSD kernel not (the
    channels are f32 pairs)."""
    import chip_smoke

    tunables = dict(chip_smoke.WB_FORMS)[form]
    config = chip_smoke.runtime_config(_wideband_capture(tmp_path), chip_smoke.WB_RATE, chip_smoke.WB_CENTER,
                                       channels=chip_smoke.WB_CHANNELS, **tunables)
    before = (select_kernel.fused_selection.launches, psd_kernel.psd_frames_int8.launches)
    card, scanner, _, _ = chip_smoke.run_wideband_scanner(config, dev)
    assert select_kernel.fused_selection.launches > before[0] and psd_kernel.psd_frames_int8.launches == before[1]
    assert scanner.sessions[0].scan_cfg.fft_size == 512
    cpu, _, _, _ = chip_smoke.run_wideband_scanner(config, torch.device("cpu"))
    assert compare_payloads(cpu, card)["transmissions"] > 0
    chip_smoke.check_wideband_recordings(card)


def test_two_devices_on_one_card_match_their_single_runs(dev, tmp_path):
    """main.run with an RTL-SDR device and a wideband device: two scanner
    threads on one card, each launching the kernels. Each device's payloads
    equal its single run's (the kernels' once-per-device setup is shared
    under a lock)."""
    import json

    import chip_smoke
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner

    plain_cap = tmp_path / "plain.cs8"
    write_capture(plain_cap, chip_smoke.RT_RATE, 6.2, chip_smoke.RT_SHIFT, (3.0, 5.0))
    plain = chip_smoke.runtime_config(plain_cap, chip_smoke.RT_RATE, chip_smoke.RT_CENTER)
    wide = chip_smoke.runtime_config(_wideband_capture(tmp_path), chip_smoke.WB_RATE, chip_smoke.WB_CENTER,
                                     channels=chip_smoke.WB_CHANNELS)
    wide["devices"][0]["serial"] = "replay1"
    both = dict(plain, devices=plain["devices"] + wide["devices"])
    path = tmp_path / "config.json"
    path.write_text(json.dumps(both))
    rc, payloads = run_main(path, dev, scanners=2)
    assert rc == 0

    cfg = Config(json.loads(json.dumps(plain)))
    mqtt = NullMqtt()
    mqtt.keep_payloads = True
    scanner = Scanner(cfg, cfg.devices[0], mqtt, cfg.recorders_count(), device=dev)
    scanner.run_to_completion()
    scanner.stop()
    single_wide, _, _, _ = chip_smoke.run_wideband_scanner(wide, dev)
    for serial, single in (("replay0", mqtt.published), ("replay1", single_wide)):
        mine = [(t, p) for t, p in payloads if t.startswith(f"sdr/replay_{serial}/")]
        assert mine and compare_payloads(single, mine)["transmissions"] > 0


@pytest.mark.parametrize("form", ["split", "fused"])
def test_64_channel_session_through_main_run_matches_cpu(form, dev, tmp_path):
    """main.run on a 2.048 Msps device split into 64 channels of 32 kHz (fft
    128: the selection kernel's register form) on the card, against the
    same form's CPU run (compare_payloads); both transmissions
    recorded at their tones."""
    import json

    import chip_smoke

    capture = tmp_path / "wide64.cs8"
    write_capture(capture, chip_smoke.NW_RATE, 5.0, chip_smoke.NW_SIGNALS, (2.5, 4.5), seed=11)
    config = chip_smoke.runtime_config(capture, chip_smoke.NW_RATE, chip_smoke.WB_CENTER,
                                       channels=chip_smoke.NW_CHANNELS, recording_rate=chip_smoke.NARROW_REC_RATE,
                                       **dict(chip_smoke.NW_FORMS)[form])
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    before = select_kernel.fused_selection.launches
    rc, card = run_main(path, dev)
    assert rc == 0 and select_kernel.fused_selection.launches > before
    cpu, _, _, _ = chip_smoke.run_wideband_scanner(config, torch.device("cpu"))
    assert compare_payloads(cpu, card)["transmissions"] > 0
    for shift, tone in chip_smoke.NW_SIGNALS:
        _, n, got = recorded_tone(card, chip_smoke.WB_CENTER + shift, chip_smoke.NARROW_REC_RATE)
        assert n > chip_smoke.NARROW_REC_RATE and abs(got - tone) < 40


def test_time_shards_on_card_match_one_card(dev):
    """The time axis on a mesh of 4 copies of the card (256 kHz, 84 frames:
    21 a shard; int8 ingest, FM keyed after the noise learning): the
    time-sharded scan against the one-card compact step (counts exact,
    indices rank-equivalent but for < 0.5% near-ties, values within 2e-3
    dB) and the time-sharded modulated-taps DDC against the one-card DDC
    (within 1 LSB); the PSD and selection kernels launch once a shard, the
    FIR kernel once a shard and chunk where the chain has a decimating
    stage 2 (512 kHz -> 3.2 kHz)."""
    from rtl_sdr_scanner_tpu_torch.parallel import mesh, sharded_scan

    n, rate, frames = 4, 512_000, 84
    cfg = scan_pipeline.ScanConfig.create(rate, frames)
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, 3_200, 2, cfg.block_samples)
    assert sharded_scan.time_sharded_modtap_fits(ddc_cfg, n) and len(ddc_cfg.plans) == 2
    m = mesh.make_mesh(1, n, devices=[dev] * n)
    group = cfg.fft_size * cfg.decimator_factor
    t = np.arange(2 * cfg.block_samples) / rate
    rng = np.random.default_rng(3)
    x = 0.01 * (rng.standard_normal(t.size) + 1j * rng.standard_normal(t.size))
    x += 0.4 * np.exp(2j * np.pi * (30_000 * t + 3000 / 700 * np.sin(2 * np.pi * 700 * t))) * (t >= 2.2)
    pairs = np.clip(np.round(np.stack([x.real, x.imag], -1) * 127), -128, 127).astype(np.int8)
    blocks = torch.from_numpy(pairs).to(dev).reshape(2, frames, group, 2)
    keys = torch.full((8,), -1, dtype=torch.int32, device=dev)
    valid = torch.ones(cfg.fft_size, dtype=torch.bool, device=dev)
    level = torch.tensor(LEVEL, device=dev)
    tables = ddc_pipeline.make_tables(ddc_cfg, np.array([30_000, -50_000]), device=dev)
    scan_sh = sharded_scan.make_time_sharded_scan(cfg, m, 64, 16)
    ddc_sh = sharded_scan.make_time_sharded_modtap_ddc(ddc_cfg, m)
    scan_1 = scan_pipeline.make_compact_scan_step(cfg, 64, 16, device=dev)
    ddc_1 = ddc_pipeline.make_ddc_step(ddc_cfg, device=dev)
    s_sh = s_1 = scan_pipeline.init_scan_state(cfg, device=dev)
    d_sh = d_1 = ddc_pipeline.init_state(ddc_cfg, device=dev)
    acc = scan_pipeline.init_spectro_acc(cfg, device=dev)
    k2, row = 32, 3 * 32 + 1 + 16
    wrappers = (psd_kernel.psd_frames_int8, select_kernel.fused_selection, fir_kernel.stage_apply_fir)
    for b in range(2):
        now = torch.from_numpy(((b * frames + 1 + np.arange(frames)) * cfg.frame_interval_ms).astype(np.int32)).to(dev)
        before = [fn.launches for fn in wrappers]
        s_sh, body, spectro, ready = scan_sh(s_sh, blocks[b], now, keys, valid, level)
        d_sh, rec = ddc_sh(d_sh, blocks[b].reshape(-1, 2), tables)
        torch.cuda.synchronize()
        assert [fn.launches - b0 for fn, b0 in zip(wrappers, before)] == [n, n, n * ddc_cfg.num_chunks]
        s_1, acc, outs = scan_1(s_1, acc, blocks[b], now, keys, valid, level, 0.0)
        d_1, rec_1 = ddc_1(d_1, blocks[b].reshape(-1, 2), tables)
        got, ref = body.cpu().numpy(), outs.packed[:-1].reshape(frames, row).cpu().numpy()
        assert (got[:, :k2] != ref[:, :k2]).mean() < 0.005
        np.testing.assert_allclose(got[:, k2 : 2 * k2], ref[:, k2 : 2 * k2], atol=2e-3)
        np.testing.assert_array_equal(got[:, 3 * k2], ref[:, 3 * k2])
        np.testing.assert_allclose(spectro.cpu().numpy(), acc.cpu().numpy(), atol=5e-3)
        assert bool(ready) == bool(outs.noise_ready)
        assert (rec.int() - rec_1.int()).abs().max().item() <= 1
    assert (got[:, 3 * k2] > 0).any() and rec.abs().max().item() > 10


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_band_shards_on_card_match_one_card(fused, dev):
    """The bands axis on a mesh of 2 copies of the card (8 channels of 256
    kHz from one int8 stream, 2 slots at 3.2 kHz: a decimating stage 2):
    the wideband step (and banded DDC, or the fused step) over 2 shards
    gives the one-shard form's packed rows and recordings exactly."""
    from rtl_sdr_scanner_tpu_torch.ops import channelizer
    from rtl_sdr_scanner_tpu_torch.parallel import mesh, sharded_scan as ss

    nb, rate = 8, 256_000
    cfg = scan_pipeline.ScanConfig.create(rate, 12)
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, 3_200, 2, cfg.block_samples)
    plan = channelizer.plan_channelizer(nb)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-60, 60, size=(nb * cfg.block_samples, 2), dtype=np.int8)).to(dev)
    shifts = rng.integers(-rate // 2, rate // 2, size=(nb, 2)).astype(np.int64)
    outs = {}
    for shards in (1, 2):
        m = mesh.make_mesh(shards, 1, devices=[dev] * shards)
        args = dict(
            chan=ss.replicate(channelizer.init_channelizer_state(plan, dev), m),
            state=ss.init_banded_state(cfg, nb, m),
            acc=ss.shard_bands(torch.zeros((nb, cfg.spectro_size), device=dev), m),
        )
        ddc_state = ss.init_banded_ddc_state(ddc_cfg, nb, m)
        tables = ss.shard_bands(ddc_pipeline.make_tables(ddc_cfg, shifts, device=dev), m)
        keys = ss.shard_bands(torch.full((nb, 8), -1, dtype=torch.int32, device=dev), m)
        valid = ss.shard_bands(torch.ones((nb, cfg.fft_size), dtype=torch.bool, device=dev), m)
        level, keep = ss.replicate(torch.tensor(LEVEL, device=dev), m), ss.shard_bands(torch.ones((nb, 2), device=dev), m)
        now = ss.replicate(torch.arange(1, 13, dtype=torch.int32, device=dev) * 20, m)
        xs = ss.replicate(x, m)
        if fused:
            step = ss.make_sharded_wideband_fused_step(cfg, ddc_cfg, 64, 16, m, plan, 1, nb)
            *_, packed, rec, _ = step(args["chan"], args["state"], args["acc"], ddc_state, xs, now, keys, valid, level,
                                      1.0, tables, keep)
        else:
            wide = ss.make_sharded_wideband_step(cfg, 64, 16, m, plan, 1, nb)
            *_, packed, channels = wide(args["chan"], args["state"], args["acc"], xs, now, keys, valid, level, 1.0)
            _, rec = ss.make_sharded_banded_ddc(ddc_cfg, m, nb)(ddc_state, channels, tables, keep)
        outs[shards] = (ss.gather_bands(packed, dev).cpu(), ss.gather_bands(rec, dev).cpu())
    assert torch.equal(outs[1][0], outs[2][0]) and torch.equal(outs[1][1], outs[2][1])
    assert outs[2][1].abs().max().item() > 0


def test_two_gloo_ranks_on_one_card(dev):
    """Two processes in one group (gloo for objects; NCCL named for tensors
    but never used), both on card 0: each builds the global mesh, one band
    shard a process, and its banded scan step on its own bands equals a
    one-process run of those bands on the card (tests/test_torch_multihost.py's
    children, on the card)."""
    # the test module by its file's name: this directory is on sys.path
    # (pytest's prepend import mode), and a site package may own "tests"
    from test_torch_multihost import run_children

    logs = run_children("mesh", 2, device="cuda", env={"CUDA_VISIBLE_DEVICES": "0"})
    joined = "".join(logs)
    assert "shards=[0]" in joined and "shards=[1]" in joined, joined


def _graph_against_eager(dev, make, blocks=4, n_state=None, segments=1):
    """``make()`` -> (graphed step, its initial state as a list, ``args_of(b,
    state)``: block b's other arguments, after any change it makes to the
    state list, such as a slot reset); the step's eager ``fn`` and the step
    itself, each from a fresh ``make()`` over ``blocks`` blocks: their
    outputs and final states bit-equal, one capture a segment (a sharded
    step's ``segments`` (shard, segment) keys; ``n_state``: the states it
    returns first), each replayed once a call, and the kernels' launches over the graphed blocks equal
    to the eager blocks' (per-block launches x replays). Returns the
    launches."""
    from rtl_sdr_scanner_tpu_torch.graph import _flatten

    wrappers = (psd_kernel.psd_frames_int8, select_kernel.fused_selection, fir_kernel.stage_apply_fir,
                channelizer_kernel.analysis_bank)
    runs = {}
    for form in ("eager", "graphed"):
        step, state, args_of = make()
        call = step if form == "graphed" else step.fn
        n = len(step.donate) if n_state is None else n_state
        before = [fn.launches for fn in wrappers]
        outs = []
        for b in range(blocks):
            args = args_of(b, state)
            *state, out = _split(call(*state, *args), n)
            leaves = []
            _flatten(out, leaves)
            outs.append([x.clone() for x in leaves])
        torch.cuda.synchronize()
        final = []
        _flatten(state, final)
        runs[form] = (outs, final, [fn.launches - b0 for fn, b0 in zip(wrappers, before)], step)
    (eager, e_state, e_launch, _), (graphed, g_state, g_launch, step) = runs["eager"], runs["graphed"]
    for b, (want, got) in enumerate(zip(eager, graphed)):
        for i, (w, g) in enumerate(zip(want, got)):
            assert torch.equal(w, g), f"block {b}, output leaf {i}"
    for i, (w, g) in enumerate(zip(e_state, g_state)):
        assert torch.equal(w, g), f"state leaf {i}"
    assert step.captures == segments and len(step.graphs()) == segments
    assert all(g.graph is not None for g in step.graphs())
    assert sum(g.replays for g in step.graphs()) == blocks * segments
    assert g_launch == e_launch
    return e_launch


def _split(result, n):
    """(state x n, outputs) of a step's result, the outputs as one tuple."""
    return (*result[:n], tuple(result[n:]))


def _tone_step_inputs(cfg, blocks, nb, dev):
    iq, tones = _tone_blocks(cfg, blocks, nb, seed=11)
    return torch.from_numpy(iq).to(dev), tones


def test_graphed_fused_step_equals_eager_on_card(dev):
    """``drivers.BandedBlocks``' graphed banded fused step (modulated taps
    with a decimating stage 2: 512 kHz -> 3.2 kHz) against its eager step,
    a slot restarted on a new shift at block 2."""
    from rtl_sdr_scanner_tpu_torch import drivers

    cfg = scan_pipeline.ScanConfig.create(512_000, 10, Tunables(noise_learning_time_ms=300))
    ddc_cfg = ddc_pipeline.DdcConfig.create(512_000, 3_200, 2, cfg.block_samples)
    iq, tones = _tone_step_inputs(cfg, 4, 2, dev)
    shifts = np.tile((tones[:1] - cfg.fft_size // 2) * 512_000 // cfg.fft_size, (2, 2)).astype(np.int64)

    def make():
        blk = drivers.BandedBlocks(cfg, ddc_cfg, 32, 64, 2, shifts, dev)
        moved = ddc_pipeline.make_tables(ddc_cfg, shifts + 2500, device=dev)

        def args_of(b, state):
            if b == 2:
                state[2] = ddc.reset_slot2(state[2], 1, 1)
                blk.tables = moved
            return (iq[b], blk.now(b), *blk.shared, blk.tables)

        return blk.step, blk.state, args_of

    assert _graph_against_eager(dev, make) == [4, 4, 4, 0]


@pytest.mark.parametrize("rate,bw,frames", [(256_000, 16_000, 10), (240_000, 3_200, 75)], ids=["modtap", "v1"])
def test_graphed_session_steps_equal_eager_on_card(rate, bw, frames, dev):
    """The session's graphed steps (``SdrDevice``: the compact scan step
    donating (0, 1), the single-band DDC step donating (0,)) against their
    eager steps; the accumulator reset (spectro_keep 0.0) at block 2."""
    from rtl_sdr_scanner_tpu_torch.graph import donated_step

    cfg = scan_pipeline.ScanConfig.create(rate, frames, Tunables(noise_learning_time_ms=300))
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, bw, 2, cfg.block_samples)
    iq, tones = _tone_step_inputs(cfg, 4, 1, dev)
    keys = torch.full((16,), -1, dtype=torch.int32, device=dev)
    valid = torch.ones(cfg.fft_size, dtype=torch.bool, device=dev)
    level = torch.tensor(LEVEL, device=dev)

    def now(b):
        return torch.from_numpy(((b * frames + 1 + np.arange(frames)) * cfg.frame_interval_ms).astype(np.int32)).to(dev)

    def make_scan():
        step = donated_step(scan_pipeline.make_compact_scan_step(cfg, 32, 64, device=dev), donate=(0, 1))
        state = [scan_pipeline.init_scan_state(cfg, device=dev), scan_pipeline.init_spectro_acc(cfg, device=dev)]
        return step, state, lambda b, _: (iq[b, 0], now(b), keys, valid, level, 0.0 if b == 2 else 1.0)

    shift = (int(tones[0]) - cfg.fft_size // 2) * rate // cfg.fft_size
    tables = ddc_pipeline.make_tables(ddc_cfg, np.array([shift, -shift]), device=dev)

    def make_ddc():
        step = donated_step(ddc_pipeline.make_ddc_step(ddc_cfg, device=dev), donate=(0,))
        return step, [ddc_pipeline.init_state(ddc_cfg, device=dev)], lambda b, _: (iq[b, 0].reshape(-1, 2), tables)

    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages

    assert _graph_against_eager(dev, make_scan)[:2] == [4, 4]
    # the modulated-taps chain here has one stage: no FIR launch to count
    assert _graph_against_eager(dev, make_ddc) == [0, 0, 4 * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)), 0]


def test_graphed_wideband_fused_step_equals_eager_on_card(dev):
    """``drivers.WidebandBlocks``' graphed fused wideband step (a graph a
    band shard) on a one-card mesh (8 channels of 256 kHz from one int8 stream, 2 slots at 3.2 kHz)
    against its eager step."""
    from rtl_sdr_scanner_tpu_torch import drivers
    from rtl_sdr_scanner_tpu_torch.parallel import mesh

    nb, rate = 8, 256_000
    cfg = scan_pipeline.ScanConfig.create(rate, 12, Tunables(noise_learning_time_ms=100))
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, 3_200, 2, cfg.block_samples)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.integers(-60, 60, size=(4, nb * cfg.block_samples, 2), dtype=np.int8)).to(dev)
    shifts = rng.integers(-rate // 2, rate // 2, size=(nb, 2)).astype(np.int64)

    def make():
        blk = drivers.WidebandBlocks(cfg, ddc_cfg, 64, 16, nb, shifts, True, mesh.make_mesh(1, 1, devices=[dev]), dev)

        def args_of(b, _):
            now = [drivers.frame_times(cfg, b, dev)]
            return ([xs[b]], now, blk.keys, blk.valid, blk.level, 1.0, blk.tables, blk.keep_mask)

        return blk.step, [blk.chan, blk.scan, blk.acc, blk.ddc], args_of

    launches = _graph_against_eager(dev, make, n_state=4)
    assert launches[0] == 0 and launches[1] == 4 and launches[3] == 4


def test_graphed_time_shards_equal_eager_on_card(dev):
    """The time axis graphed (``graph.sharded_step``) on a mesh of 4 copies
    of the card (512 kHz, 84 frames: 21 a shard; 2 slots at 3.2 kHz: a
    decimating stage 2), against its eager programs: the scan (3 segments a
    shard), the modulated-taps DDC (4 chunks a block: 2 segments a shard,
    each looping over the chunks; a slot restarted at block 2) and the v1
    DDC (4 a shard) bit-equal, one capture a (shard, segment), each
    replayed once a call, launches equal."""
    from rtl_sdr_scanner_tpu_torch.graph import sharded_step
    from rtl_sdr_scanner_tpu_torch.parallel import mesh, sharded_scan as ss

    n, rate, frames = 4, 512_000, 84
    cfg = scan_pipeline.ScanConfig.create(rate, frames, Tunables(noise_learning_time_ms=300))
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, 3_200, 2, cfg.block_samples, chunk_target=1 << 18)
    assert ss.time_sharded_modtap_fits(ddc_cfg, n) and len(ddc_cfg.plans) == 2 and ddc_cfg.num_chunks == 4
    m = mesh.make_mesh(1, n, devices=[dev] * n)
    iq, tones = _tone_step_inputs(cfg, 4, 1, dev)
    keys = torch.full((16,), -1, dtype=torch.int32, device=dev)
    valid = torch.ones(cfg.fft_size, dtype=torch.bool, device=dev)
    level = torch.tensor(LEVEL, device=dev)

    def now(b):
        return torch.from_numpy(((b * frames + 1 + np.arange(frames)) * cfg.frame_interval_ms).astype(np.int32)).to(dev)

    def make_scan():
        step = sharded_step(ss.make_time_sharded_scan(cfg, m, 32, 64), "time scan")
        return step, [scan_pipeline.init_scan_state(cfg, device=dev)], lambda b, _: (
            iq[b, 0], now(b), keys, valid, level)

    shift = (int(tones[0]) - cfg.fft_size // 2) * rate // cfg.fft_size
    tables = ddc_pipeline.make_tables(ddc_cfg, np.array([shift, -shift]), device=dev)

    def make_ddc():
        def args_of(b, state):
            if b == 2:
                state[0] = ddc_pipeline.reset_slot(state[0], 1)
            return (iq[b, 0].reshape(-1, 2), tables)

        step = sharded_step(ss.make_time_sharded_modtap_ddc(ddc_cfg, m), "time DDC")
        return step, [ddc_pipeline.init_state(ddc_cfg, device=dev)], args_of

    v1_cfg = ddc_pipeline.DdcConfig.create(1_024_000, 16_000, 2, 4096 * 16)
    v1_tables = ddc.make_nco_tables(np.array([100_000, -50_000]), 1_024_000, v1_cfg.block_samples, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    v1_iq = torch.randn((4, v1_cfg.block_samples, 2), generator=gen, device=dev) * 0.3

    def make_v1():
        step = sharded_step(ss.make_time_sharded_ddc(v1_cfg, m), "time v1 DDC")
        return step, [], lambda b, _: (v1_iq[b], v1_tables)

    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages

    assert _graph_against_eager(dev, make_scan, n_state=1, segments=3 * n)[:2] == [4 * n, 4 * n]
    assert _graph_against_eager(dev, make_ddc, n_state=1, segments=n * len(ddc_cfg.plans)) == [
        0, 0, 4 * n * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)), 0]
    _graph_against_eager(dev, make_v1, n_state=0, segments=n * (len(v1_cfg.plans) + 2))


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_graphed_band_shards_equal_eager_on_card(fused, dev):
    """``drivers.WidebandBlocks`` over 2 band shards of the card (8 channels
    of 256 kHz from one int8 stream, 2 slots at 3.2 kHz), graphed (a graph a
    shard) against its eager programs, a slot zeroed by the keep mask at
    block 2: bit-equal, one capture a shard and step, launches equal."""
    from rtl_sdr_scanner_tpu_torch import drivers
    from rtl_sdr_scanner_tpu_torch.parallel import mesh, sharded_scan as ss

    nb, rate, shards = 8, 256_000, 2
    cfg = scan_pipeline.ScanConfig.create(rate, 12, Tunables(noise_learning_time_ms=100))
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, 3_200, 2, cfg.block_samples)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.integers(-60, 60, size=(4, nb * cfg.block_samples, 2), dtype=np.int8)).to(dev)
    shifts = rng.integers(-rate // 2, rate // 2, size=(nb, 2)).astype(np.int64)
    m = mesh.make_mesh(shards, 1, devices=[dev] * shards)
    zeroed = torch.ones((nb, 2), device=dev)
    zeroed[1, 1] = 0.0

    def make(which):
        blk = drivers.WidebandBlocks(cfg, ddc_cfg, 64, 16, nb, shifts, fused, m, dev)

        def wide_args(b, _):
            common = (ss.replicate(xs[b], m), ss.replicate(drivers.frame_times(cfg, b, dev), m), blk.keys, blk.valid,
                      blk.level, 1.0)
            keep = ss.shard_bands(zeroed, m) if b == 2 else blk.keep_mask
            return common + ((blk.tables, keep) if fused else ())

        if fused:
            return blk.step, [blk.chan, blk.scan, blk.acc, blk.ddc], wide_args
        if which == "wide":
            return blk.wide_step, [blk.chan, blk.scan, blk.acc], wide_args
        channels = [torch.randn((nb // shards, cfg.block_samples, 2), generator=torch.Generator(device=dev).manual_seed(b),
                                device=dev) for b in range(4)]
        return blk.ddc_step, [blk.ddc], lambda b, _: (
            [channels[b]] * shards, blk.tables, ss.shard_bands(zeroed, m) if b == 2 else blk.keep_mask)

    if fused:
        launches = _graph_against_eager(dev, lambda: make("fused"), n_state=4, segments=shards)
        assert launches[0] == 0 and launches[1] == 4 * shards and launches[3] == 4 * shards
    else:
        launches = _graph_against_eager(dev, lambda: make("wide"), n_state=3, segments=shards)
        assert launches[:2] == [0, 4 * shards] and launches[3] == 4 * shards
        _graph_against_eager(dev, lambda: make("ddc"), n_state=1, segments=shards)


def test_a_capture_that_copies_from_the_host_raises(dev):
    """A step that uploads a host tensor inside itself cannot be captured:
    every try fails, the call raises (no fallback to the eager step), and
    the card works on."""
    from rtl_sdr_scanner_tpu_torch.graph import donated_step

    def uploads(state, x):
        return state + torch.ones(4).to(x.device), x * 2

    step = donated_step(uploads, donate=(0,))
    with pytest.raises(RuntimeError, match="capture failed"):
        step(torch.zeros(4, device=dev), torch.ones(4, device=dev))
    assert step.captures == 0
    assert (torch.ones(4, device=dev) * 3).sum().item() == 12.0


def test_captures_beside_another_threads_work(dev):
    """One thread captures step after step while another launches kernels
    (its first launch of several), replays its own graphed step and reads
    results back, as two scanner threads on one card do: every capture
    succeeds (one ended by the other thread's work is taken again) and the
    other thread sees no error."""
    import threading

    from rtl_sdr_scanner_tpu_torch.graph import donated_step

    def step(state, x):
        y = torch.fft.fft(torch.complex(x @ x, x), dim=-1).abs()
        return state + y.sum(), y[:4]

    stop, errors, blocks = threading.Event(), [], [0]

    def other():
        try:
            own = donated_step(step, donate=(0,))
            state, x = torch.zeros((), device=dev), torch.ones(64, 64, device=dev)
            ops = [torch.sin, torch.erfinv, torch.lgamma, lambda t: torch.sort(t)[0], lambda t: torch.cumprod(t, 0)]
            for i in range(10_000):
                if stop.is_set():
                    break
                dtype = (torch.float64, torch.float32)[i // len(ops) % 2]
                ops[i % len(ops)](torch.ones(1000, device=dev, dtype=dtype))
                state, out = own(state, x)
                out.cpu()
                blocks[0] += 1
        except Exception as exc:  # reported below
            errors.append(exc)

    worker = threading.Thread(target=other, daemon=True)
    worker.start()
    try:
        for i in range(20):
            state, _ = donated_step(step, donate=(0,), name=f"step {i}")(
                torch.zeros((), device=dev), torch.full((64, 64), float(i), device=dev))
            assert state.isfinite().item()
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and not errors, errors
    assert blocks[0] > 0
    torch.cuda.synchronize()


def _device_trace(prof):
    """(kernels as (name, start ns, end ns), every device operation's
    (start, end)) of a profiled run, in start order."""
    from torch.autograd import DeviceType

    kernels, ops = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        kind = ev.activity_type() if hasattr(ev, "activity_type") else None
        if kind == "gpu_user_annotation":
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        ops.append((s, e))
        name = ev.name()
        if kind == "kernel" or (kind is None and not name.startswith(("Memcpy", "Memset"))):
            kernels.append((name, s, e))
    return sorted(kernels, key=lambda k: k[1]), sorted(ops)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(e, merged[-1][1]))
        else:
            merged.append((s, e))
    return merged


def test_graphed_step_replays_its_stage_markers_on_card(dev):
    """``drivers.BandedBlocks``' graphed step at the wideband receiver's
    geometry (24 bands of 45 frames of fft 131072, 2 slots at 32 kHz),
    replayed under the profiler: each ``fused_step.STAGES`` enter/exit
    marker pair once a replay, in ``STAGES`` order; every PSD kernel inside
    ``scan.psd``, every selection kernel inside ``scan.detection``, every FIR
    and matrix-product kernel inside ``ddc``; the stages plus the device's
    busy time outside them within 2% of the busy time; the kernel wrappers'
    launches as without markers."""
    import math

    from rtl_sdr_scanner_tpu_torch import drivers
    from rtl_sdr_scanner_tpu_torch.utils.trace import marker_name

    rate, nb, replays = 20_480_000, 24, 3
    cfg = scan_pipeline.ScanConfig.create(rate, 45, Tunables())
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, 32_000, 2, cfg.block_samples)
    shifts = np.tile(np.array([[250_000, -3_000_000]], dtype=np.int64), (nb, 1))
    blk = drivers.BandedBlocks(cfg, ddc_cfg, math.ceil(32_000 / cfg.step_hz), 64, nb, shifts, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    iq = torch.randint(-100, 100, (nb, 45, cfg.fft_size * cfg.decimator_factor, 2), dtype=torch.int8,
                       device=dev, generator=gen)
    for b in range(2):  # the capture, then a replay
        blk.run_block(b, iq)
    torch.cuda.synchronize()
    wrappers = drivers.kernel_wrappers()
    before = {name: fn.launches for name, fn in wrappers.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for b in range(2, 2 + replays):
            blk.run_block(b, iq)
        torch.cuda.synchronize()
    fir = ddc_cfg.num_chunks * len(drivers.fir_stages(ddc_cfg))
    want_launches = {"psd_frames_int8": replays, "fused_selection": replays, "history_vote": replays,
                     "stage_apply_fir": fir * replays, "analysis_bank": 0,
                     "modtap_stage1": ddc_cfg.num_chunks * replays}
    assert {name: fn.launches - before[name] for name, fn in wrappers.items()} == want_launches
    kernels, ops = _device_trace(prof)
    marks = [(name, s, e) for name, s, e in kernels if name.startswith("trace_")]
    order = [marker_name(stage, edge) for stage in fused_step.STAGES for edge in ("enter", "exit")]
    assert [name for name, _, _ in marks] == order * replays
    spans = {}
    for i in range(0, len(marks), 2):
        stage = fused_step.STAGES[(i // 2) % len(fused_step.STAGES)]
        spans.setdefault(stage, []).append((marks[i][2], marks[i + 1][1]))
    owners = {"psd_": "scan.psd", "selection_": "scan.detection", "fir_decimate": "ddc", "gemm": "ddc"}
    for name, s, e in kernels:
        for part, stage in owners.items():
            if part in name.lower():
                assert any(lo <= s and e <= hi for lo, hi in spans[stage]), (name, stage)
    busy = _union(ops)
    staged = _union([iv for ivs in spans.values() for iv in ivs])
    inside = sum(max(0, min(e, he) - max(s, hs)) for s, e in busy for hs, he in staged)
    total = sum(e - s for s, e in busy)
    stages = sum(sum(e - s for s, e in _union(ivs)) for ivs in spans.values())
    unstaged = total - inside
    assert abs(stages + unstaged - total) <= 0.02 * total, (stages, unstaged, total)


def test_profiled_session_traces_the_markers_of_every_replay(dev, tmp_path):
    """``Tunables.profile_dir`` on a graphed session (chip_smoke.py's runtime
    capture, FM keyed 3-5 s): the trace it writes holds each scan stage's
    markers once a scan replay and the DDC's once a DDC replay."""
    import json

    import chip_smoke

    capture = tmp_path / "capture.cs8"
    write_capture(capture, chip_smoke.RT_RATE, 6.2, chip_smoke.RT_SHIFT, (3.0, 5.0))
    config = chip_smoke.runtime_config(capture, chip_smoke.RT_RATE, chip_smoke.RT_CENTER,
                                       profile_dir=str(tmp_path / "trace"))
    _, session, _, _ = chip_smoke.run_scanner(config, dev)
    events = json.loads((tmp_path / "trace" / "trace_cuda.json").read_text())["traceEvents"]
    count = lambda name: sum(1 for ev in events if ev.get("cat") == "kernel" and ev.get("name") == name)
    replays = lambda step: sum(g.replays for g in step.graphs())
    scans, ddcs = replays(session._scan_step), replays(session._ddc_step)
    assert scans > 0 and ddcs > 0
    for stage in ("scan.psd", "scan.noise", "scan.averager", "scan.smoothing", "scan.detection",
                  "scan.spectrogram", "scan.pack"):
        for edge in ("enter", "exit"):
            assert count(f"trace_{edge}_{stage.replace('.', '_')}") == scans, stage
    assert count("trace_enter_ddc") == count("trace_exit_ddc") == ddcs
