"""The slice as a whole: make_banded_fused_step of the port against the JAX
package's, 2 bands x 4 blocks, from the same int8 blocks, and a port run
resumed mid-stream from the JAX state through ``convert``. Geometries:
- fft 1024 (256 kHz) and fft 8192 (2.048 MHz, eight 1024-bin segments),
  10 frames, 2 slots at 16 kHz: the modulated-taps DDC;
- 240 kHz -> 3.2 kHz (fft 1024, decim 4, 75 frames): the v1 DDC with the
  single decimation-only stage (1, 75) of the 2.4 Msps -> 32 kHz chain;
- 250 kHz -> 32 kHz (fft 1024, 125 frames): the v1 DDC with one
  interpolating stage (16, 125), and group 132 > 127, so the wide-window
  vote runs.
Also the single-band forms (make_fused_step, _ddc_block) at NB=1.

The two sides' FFTs differ by ~1e-4 dB, so the scene is built for every
selection to be decided by at least 1e-3 dB (or between exactly equal
sentinels), which the test asserts on the JAX side before comparing:
- white noise, and two bin-centred tones per band keyed on at the first
  frame after noise learning, 20 dB apart, swapped between the bands;
- the valid mask holds only the two tone bins, so top-K and the margin
  greedy rank two well-separated values, then masked bins in index order;
- each tracked key's window ends where the smoothed tone plateau starts,
  so its argmax sits on a step of (tone - noise)/21 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.constants import Tunables as JaxTunables
from rtl_sdr_scanner_tpu.models import ddc_pipeline as jdp
from rtl_sdr_scanner_tpu.models import fused_step as jfs
from rtl_sdr_scanner_tpu.models import scan_pipeline as jsp
from rtl_sdr_scanner_tpu.ops.averager import averager_block, ordered_history
from rtl_sdr_scanner_tpu.ops.noise import noise_block
from rtl_sdr_scanner_tpu.ops.smooth import sliding_average
from rtl_sdr_scanner_tpu_torch import convert
from rtl_sdr_scanner_tpu_torch.constants import Tunables
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
from rtl_sdr_scanner_tpu_torch.models import fused_step as tfs
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp

torch.set_num_threads(2)
NB, BLOCKS, SLOTS, TOP_K = 2, 4, 2, 64
LEVEL = np.float32(8.0)
MARGIN = 1e-3  # dB
EXACT = np.array([-100.0, -3.0e38, -3.3e38], dtype=np.float32)

# rate, recording bandwidth, frames per block, bf16 selection
GEOMETRIES = [
    (256_000, 16_000, 10, False),
    (2_048_000, 16_000, 10, True),
    (240_000, 3_200, 75, True),
    (250_000, 32_000, 125, False),
]


def _scene(rate, cfg, seed):
    """int8 blocks [BLOCKS, NB, F, fft*decim, 2], tone bins, keys."""
    fft, f = cfg.fft_size, cfg.frames_per_block
    group = fft * cfg.decimator_factor
    half = int(np.ceil(16000 / cfg.step_hz)) // 2
    tones = np.array([int(fft * 0.6), int(fft * 0.8)])
    amps = np.array([[0.5, 0.05], [0.05, 0.5]])
    n = BLOCKS * f * group
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    learn_frames = int(np.ceil(cfg.noise_learning_ms / cfg.frame_interval_ms))
    on = t >= learn_frames * group  # first frame after learning, at a frame boundary
    blocks = []
    for band in range(NB):
        x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for b, a in zip(tones, amps[band]):
            x += on * a * np.exp(2j * np.pi * (b - fft // 2) * t / fft)
        pairs = np.stack([x.real, x.imag], axis=-1)
        blocks.append(np.clip(np.round(pairs * 127.0), -128, 127).astype(np.int8))
    iq = np.stack(blocks).reshape(NB, BLOCKS, f, group, 2).transpose(1, 0, 2, 3, 4)
    keys = (tones - 10 - half).astype(np.int32)
    shifts = np.stack([(tones - fft // 2) * rate // fft] * NB).astype(np.int64)
    return np.ascontiguousarray(iq), tones, keys, shifts, half


def _decided(a, b):
    """Neighbouring ranked values a >= b are told apart by >= MARGIN dB, or
    are equal sentinels that both sides produce exactly."""
    return (a - b >= MARGIN) | ((a == b) & np.isin(a, EXACT))


def _assert_robust(avg, hist, cand_idx, keys, valid, half, submargin):
    """Every selection of one band's block is decided by >= MARGIN (JAX rows)."""
    f, fft = avg.shape
    masked = np.where(valid, avg, np.float32(-3.0e38))
    ranked = -np.sort(-masked, axis=1)[:, : TOP_K + 1]
    assert _decided(ranked[:, :-1], ranked[:, 1:]).all(), "top-K"
    bins = np.arange(fft)
    for row in masked:
        supp = np.zeros(fft, dtype=bool)
        for _ in range(16):
            cur = np.where(supp, np.float32(-3.3e38), row)
            top2 = -np.sort(-cur)[:2]
            assert _decided(top2[0], top2[1]), "margin greedy"
            supp |= np.abs(bins - int(np.argmax(cur))) <= submargin
    assert (np.abs(masked[:, valid] - LEVEL) >= MARGIN).all(), "count"
    w = 2 * half + 1
    depth = hist.shape[0] - f + 1
    padded = np.pad(hist, ((0, 0), (half, half)), constant_values=-np.inf)
    for k in range(f):
        win = padded[k : k + depth][:, cand_idx[k][:, None] + np.arange(w)]
        top = -np.sort(-win, axis=-1)[..., :2]
        assert ((np.abs(top[..., 0] - LEVEL) >= MARGIN) | (top[..., 0] == -100.0)).all(), "vote level"
        assert (_decided(top[..., 0], top[..., 1]) | (top[..., 0] < LEVEL)).all(), "vote argmax"
    pa = np.pad(avg, ((0, 0), (half, half)), constant_values=-np.inf)
    top = -np.sort(-pa[:, keys[:, None] + np.arange(w)], axis=-1)[..., :2]
    assert _decided(top[..., 0], top[..., 1]).all(), "key argmax"


def _jax_rows(cfg):
    """The JAX block's rows the selections read: (state, avg, hist)."""

    def rows(state, iq, now):
        power = jsp._frames_power(cfg, iq)
        half_depth = cfg.grouping_y - cfg.grouping_y // 2
        prev_tail = ordered_history(state.averager)[-(half_depth - 1) :]
        noise, raw = noise_block(state.noise, power, now, cfg.noise_learning_ms)
        avg_state, mean = averager_block(state.averager, raw)
        avg = sliding_average(mean, cfg.grouping_x)
        return jsp.ScanState(noise, avg_state), avg, jnp.concatenate([prev_tail, raw])

    return jax.jit(jax.vmap(rows))


def _compare_band(jpacked, tpacked, jrec, trec, f, s):
    """One band's packed vector and recording: index fields exact, values
    within MARGIN dB, the recording within 1 LSB."""
    want = jsp.unpack_compact(np.asarray(jpacked), f, TOP_K, s)
    got = tsp.unpack_compact(tpacked.numpy(), f, TOP_K, s)
    names = ("cand_idx", "cand_val", "cand_best", "cand_count", "key_val", "key_idx", "ready")
    for name, g, w in zip(names, got, want):
        if name in ("cand_val", "key_val"):
            np.testing.assert_allclose(g, w, atol=MARGIN, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert trec.shape == np.asarray(jrec).shape
    diff = np.abs(trec.numpy().astype(np.int32) - np.asarray(jrec).astype(np.int32))
    assert diff.max() <= 1


def _compare(jout, tout, jacc, tacc, frames_seen, f, s):
    for band in range(NB):
        _compare_band(jout.packed[band], tout.packed[band], jout.recording[band], tout.recording[band], f, s)
    # spectrogram sums: per-bin FFT differences of ~1e-4 dB, summed per frame
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=MARGIN * frames_seen)


def _configs(rate, bw, f, bf16):
    """JAX and port scan/DDC configs with default kernel routes: the JAX
    package runs its Pallas selection (its PSD kernel has no CPU route), the
    port its wrappers, which take their plain versions on the CPU."""
    kw = dict(noise_learning_time_ms=300, detection_bf16=bf16)
    jcfg = jsp.ScanConfig.create(rate, f, JaxTunables(use_pallas_select=True, **kw))
    tcfg = tsp.ScanConfig.create(rate, f, Tunables(**kw))
    jddc = jdp.DdcConfig.create(rate, bw, SLOTS, jcfg.block_samples)
    tddc = tdp.DdcConfig.create(rate, bw, SLOTS, tcfg.block_samples)
    return jcfg, tcfg, jddc, tddc, int(np.ceil(16000 / jcfg.step_hz))


def _now(cfg, b, nb=NB):
    f = cfg.frames_per_block
    return np.broadcast_to(((b * f + 1 + np.arange(f)) * cfg.frame_interval_ms).astype(np.int32), (nb, f)).copy()


@pytest.mark.parametrize(
    "rate,bw,frames,bf16", GEOMETRIES, ids=[f"{g[0]}-{g[3]}" for g in GEOMETRIES]
)
def test_banded_fused_step_matches_jax(rate, bw, frames, bf16):
    jcfg, tcfg, jddc, tddc, group_size = _configs(rate, bw, frames, bf16)
    assert tddc.modtap == jddc.modtap == (rate in (256_000, 2_048_000))
    f = jcfg.frames_per_block
    submargin = group_size // 2 + group_size % 2
    iq, tones, keys, shifts, half = _scene(rate, jcfg, seed=rate // 1000)
    fft = jcfg.fft_size
    valid = np.zeros(fft, dtype=bool)
    valid[tones] = True

    stack = lambda a: jnp.stack([a] * NB)
    jstep = jfs.make_banded_fused_step(jcfg, jddc, group_size, TOP_K)
    jstate = jax.tree.map(stack, jsp.init_scan_state(jcfg, 0))
    jacc = stack(jsp.init_spectro_acc(jcfg))
    jdstate = jdp.fold_banded(jax.tree.map(stack, jdp.init_state(jddc)))
    jtab = jdp.fold_banded(
        jax.tree.map(lambda *a: jnp.stack(a), *[jdp.make_tables(jddc, s) for s in shifts])
    )
    mirror = _jax_rows(jcfg)
    mstate = jstate

    tstep = tfs.make_banded_fused_step(tcfg, tddc, group_size, TOP_K, device="cpu")
    tstate = tsp.init_scan_state(tcfg, NB, 0, device="cpu")
    tacc = tsp.init_spectro_acc(tcfg, NB, device="cpu")
    tdstate = tdp.init_state(tddc, NB, device="cpu")
    ttab = tdp.make_tables(tddc, shifts, device="cpu")
    resumed = None
    shared = dict(keys=keys, valid=valid, level=LEVEL, keep=np.float32(1.0))
    tshared = [torch.from_numpy(np.asarray(v)) for v in shared.values()]
    jshared = [jnp.asarray(v) for v in shared.values()]

    saw_ready = False
    for b in range(BLOCKS):
        now = _now(jcfg, b)
        if b == 2:  # resume the port from the JAX state of this point
            npy = lambda tree: jax.tree.map(np.asarray, tree)
            s, d, tb = npy(jstate), npy(jdstate), npy(jtab)
            if jddc.modtap:
                dstate = convert.ddc2_state(d.phase, d.x_tail, d.tails, device="cpu")
                tables = convert.mod_tables(tb.w, tb.rot._asdict(), device="cpu")
            else:
                dstate = convert.ddc_state(d.phase, d.tails, device="cpu")
                tables = convert.nco_tables(**tb._asdict(), device="cpu")
            resumed = (
                convert.scan_state(s.noise._asdict(), s.averager._asdict(), device="cpu"),
                convert.spectro_acc(np.asarray(jacc), device="cpu"),
                dstate,
                tables,
            )
        mstate, avg, hist = mirror(mstate, jnp.asarray(iq[b]), jnp.asarray(now))
        jstate, jacc, jdstate, jout = jstep(
            jstate, jacc, jdstate, jnp.asarray(iq[b]), jnp.asarray(now), *jshared, jtab
        )
        tstate, tacc, tdstate, tout = tstep(
            tstate, tacc, tdstate, torch.from_numpy(iq[b]), torch.from_numpy(now), *tshared, ttab
        )
        for band in range(NB):
            cand_idx = jsp.unpack_compact(np.asarray(jout.packed[band]), f, TOP_K, len(keys))[0]
            _assert_robust(
                np.asarray(avg[band]), np.asarray(hist[band]), cand_idx, keys, valid, half, submargin
            )
        _compare(jout, tout, jacc, tacc, (b + 1) * f, f, len(keys))
        if resumed is not None:
            rs, racc, rd, rtab = resumed
            rs, racc, rd, rout = tstep(
                rs, racc, rd, torch.from_numpy(iq[b]), torch.from_numpy(now), *tshared, rtab
            )
            resumed = (rs, racc, rd, rtab)
            _compare(jout, rout, jacc, racc, (b + 1) * f, f, len(keys))
        saw_ready = saw_ready or bool(np.asarray(jstate.noise.ready).all())

    assert saw_ready
    # the scene reached the vote: the strong tone is a live candidate with a
    # recorded signal in both slots
    got = tsp.unpack_compact(tout.packed[0].numpy(), f, TOP_K, len(keys))
    assert got[0][-1, 0] == tones[0] and got[2][-1, 0] == tones[0]
    assert tout.recording.shape == (NB, SLOTS, tddc.out_per_block, 2)
    assert np.abs(tout.recording.numpy()).max() > 10


@pytest.mark.parametrize("rate,bw,frames,bf16", [GEOMETRIES[0], GEOMETRIES[2]], ids=["modtap", "v1"])
def test_single_band_fused_step_matches_jax(rate, bw, frames, bf16):
    """make_fused_step of the port (the banded step at NB=1, single-band
    layouts) against the JAX package's, band 0 of the banded test's scene."""
    jcfg, tcfg, jddc, tddc, group_size = _configs(rate, bw, frames, bf16)
    iq, tones, keys, shifts, _ = _scene(rate, jcfg, seed=rate // 1000)
    valid = np.zeros(jcfg.fft_size, dtype=bool)
    valid[tones] = True
    shared = dict(keys=keys, valid=valid, level=LEVEL, keep=np.float32(1.0))
    jstep = jfs.make_fused_step(jcfg, jddc, group_size, TOP_K)
    jargs = [jsp.init_scan_state(jcfg, 0), jsp.init_spectro_acc(jcfg), jdp.init_state(jddc)]
    jtab = jdp.make_tables(jddc, shifts[0])
    tstep = tfs.make_fused_step(tcfg, tddc, group_size, TOP_K, device="cpu")
    tinit = tsp.init_scan_state(tcfg, 1, 0, device="cpu")
    targs = [
        tdp._band_axis(tinit, add=False),
        tsp.init_spectro_acc(tcfg, 1, device="cpu")[0],
        tdp.init_state(tddc, device="cpu"),
    ]
    ttab = tdp.make_tables(tddc, shifts[0], device="cpu")
    for b in range(BLOCKS):
        now = _now(jcfg, b, 1)[0]
        *jargs, jout = jstep(*jargs, jnp.asarray(iq[b, 0]), jnp.asarray(now),
                             *[jnp.asarray(v) for v in shared.values()], jtab)
        *targs, tout = tstep(*targs, torch.from_numpy(iq[b, 0]), torch.from_numpy(now),
                             *[torch.from_numpy(np.asarray(v)) for v in shared.values()], ttab)
        assert tout.packed.ndim == 1 and tout.recording.shape == (SLOTS, tddc.out_per_block, 2)
        _compare_band(jout.packed, tout.packed, jout.recording, tout.recording, frames, len(keys))
        np.testing.assert_allclose(targs[1].numpy(), np.asarray(jargs[1]), atol=MARGIN * (b + 1) * frames)


@pytest.mark.parametrize("rate,bw,block", [(2_048_000, 16_000, 1 << 16), (2_400_000, 32_000, 75 * 2048)])
def test_single_band_ddc_block_matches_jax(rate, bw, block):
    """_ddc_block / make_ddc_step at one band, 2 chunks per block, 2 blocks:
    modulated taps (NB=1 through the banded code) and v1 (ddc_chunk)."""
    jcfg = jdp.DdcConfig.create(rate, bw, SLOTS, block, chunk_target=block // 2)
    tcfg = tdp.DdcConfig.create(rate, bw, SLOTS, block, chunk_target=block // 2)
    assert tcfg.num_chunks == jcfg.num_chunks == 2 and tcfg.modtap == (rate == 2_048_000)
    shifts = np.array([250_000, -333_000], dtype=np.int64)
    jstate, jtab = jdp.init_state(jcfg), jdp.make_tables(jcfg, shifts)
    step = tdp.make_ddc_step(tcfg, device="cpu")
    tstate, ttab = tdp.init_state(tcfg, device="cpu"), tdp.make_tables(tcfg, shifts, device="cpu")
    rng = np.random.default_rng(block)
    for _ in range(2):
        iq = rng.integers(-100, 100, size=(block, 2), dtype=np.int8)
        jstate, jout = jdp._ddc_block(jcfg, jstate, jnp.asarray(iq), jtab)
        tstate, tout = step(tstate, torch.from_numpy(iq), ttab)
        assert tout.shape == (SLOTS, tcfg.out_per_block, 2)
        diff = np.abs(tout.numpy().astype(np.int32) - np.asarray(jout).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    for t, j in zip(jax.tree.leaves(tstate), jax.tree.leaves(jax.tree.map(np.asarray, jstate))):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6)


def test_step_opens_its_profiler_ranges():
    """The stage ranges the profile script times are the ones one block of
    the step opens, in the order it runs them."""
    cfg = tsp.ScanConfig.create(256_000, 2, Tunables())
    ddc = tdp.DdcConfig.create(256_000, 16000, SLOTS, cfg.block_samples)
    step = tfs.make_banded_fused_step(cfg, ddc, 64, TOP_K, device="cpu")
    fft = cfg.fft_size
    args = (
        tsp.init_scan_state(cfg, 1, 0, device="cpu"),
        tsp.init_spectro_acc(cfg, 1, device="cpu"),
        tdp.init_state(ddc, 1, device="cpu"),
        torch.zeros((1, 2, fft * cfg.decimator_factor, 2), dtype=torch.int8),
        torch.zeros((1, 2), dtype=torch.int32),
        torch.full((4,), -1, dtype=torch.int32),
        torch.ones(fft, dtype=torch.bool),
        torch.tensor(LEVEL),
        torch.tensor(1.0),
        tdp.make_tables(ddc, np.zeros((1, SLOTS), dtype=np.int64), device="cpu"),
    )
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(*args)
    opened = sorted((e.time_range.start, e.name) for e in prof.events() if e.name in tfs.STAGES)
    assert [name for _, name in opened] == list(tfs.STAGES)
