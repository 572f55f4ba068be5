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
from rtl_sdr_scanner_tpu_torch.ops.cuda import fir_kernel, psd_kernel, select_kernel

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


def test_psd_kernel_takes_a_scratch_only_above_the_cluster_form(dev):
    """fft <= 2^17 stays on chip (one block or one cluster a frame, no
    device-memory intermediate); only the scratch form above needs one."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    lib = build.library()
    for log in range(8, 21):
        logs = [n.bit_length() - 1 for n in psd_kernel._split_n(1 << log)]
        assert (lib.psd_scratch_bytes(*logs) > 0) == (log > 17)
        assert (lib.psd_max_active_clusters(*logs) > 0) == (15 <= log <= 17)
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
    fft, f = 1536, 2  # not a whole number of the selection kernel's 1024-bin segments
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
    plan = ddc.plan_stage(1, 400)  # a window larger than a block's shared memory
    with pytest.raises(RuntimeError):
        fir_kernel.stage_apply_fir(
            torch.zeros((1, 2, 4000), device=dev), torch.zeros((1, 2, plan.tail_len), device=dev), plan
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
@pytest.mark.parametrize("decim", [8, 25, 32, 40, 75, 125])
def test_fir_kernel_matches_plain(decim, case, dev):
    """<= 2e-5 * max against the plain version (f32 sum order), the new
    tail exact, over three calls carrying the tail, at every decimation of
    a real chain. ragged: 1000 outputs, not a whole number of the kernel's
    tiles; short: 8 outputs, a chunk shorter than the tail; offset: x and
    tail at 1 and 3 floats into larger buffers (16-byte copies must
    realign)."""
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
    (chip_smoke.compare_payloads: topics and order, headers, IQ within 1
    LSB, spectrogram bins within 1), the planted signal recorded."""
    import chip_smoke

    capture = tmp_path / "capture.cs8"
    chip_smoke.write_capture(capture, chip_smoke.RT_RATE, 6.2, chip_smoke.RT_SHIFT, (3.0, 5.0))
    config = chip_smoke.runtime_config(capture, chip_smoke.RT_RATE, chip_smoke.RT_CENTER)
    wrappers = (psd_kernel.psd_frames_int8, select_kernel.fused_selection, fir_kernel.stage_apply_fir)
    before = [fn.launches for fn in wrappers]
    card, _, _, _ = chip_smoke.run_scanner(config, dev)
    assert all(fn.launches > b for fn, b in zip(wrappers, before))
    cpu, _, _, _ = chip_smoke.run_scanner(config, torch.device("cpu"))
    stats = chip_smoke.compare_payloads(cpu, card)
    assert stats["transmissions"] > 0
    _, n, tone = chip_smoke.recorded_tone(card, chip_smoke.RT_CENTER + chip_smoke.RT_SHIFT, 32_000)
    assert n > 32_000 and abs(tone - chip_smoke.RT_TONE) < 40
