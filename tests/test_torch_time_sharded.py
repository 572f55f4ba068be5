"""The time axis of the port's mesh against the JAX package's, on a mesh of
4 (or 2) copies of the CPU device (JAX: conftest's virtual CPU devices).

- ``make_time_sharded_scan`` (n = 4) over two blocks that cover the noise
  learning -> ready transition (``tests/test_parallel.py:97-178``'s scene):
  against the port's serial ``_compact_scan_block`` with that test's
  tolerances (indices rank-equivalent but for < 0.5% ~1 ulp near-ties of
  the per-shard cumsum prefixes, values within 2e-3 dB, counts exact), and
  against the JAX time-sharded scan both on that scene (the same bars: the
  two FFTs differ by ~1e-4 dB) and fed the same PSD rows, where every
  integer output and the carried state are exact (rows on a 1/16 dB grid
  keep every sum exact in f32, whatever its order) and the reported values
  within 2 ulps or 1e-5 dB (the means' division rounds differently).
- ``time_sharded_modtap_fits`` on ``tests/test_parallel.py:181-192``'s cases.
- ``make_time_sharded_modtap_ddc`` (n = 2, 4): byte-equal to the port's
  serial modulated-taps DDC over two blocks, carry included, and within
  1 LSB of the JAX time-sharded one (the stage-1 products' f32 sums differ
  in order between XLA and torch).

The scan's and the DDC's cases run each step eager and graphed
(``graph.sharded_step``), to the same bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.models import ddc_pipeline as jdp
from rtl_sdr_scanner_tpu.models import scan_pipeline as jsp
from rtl_sdr_scanner_tpu.parallel import mesh as jmesh
from rtl_sdr_scanner_tpu.parallel import sharded_scan as jss
from rtl_sdr_scanner_tpu_torch.graph import sharded_step
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
from rtl_sdr_scanner_tpu_torch.parallel import mesh as tmesh
from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as tss

torch.set_num_threads(2)
RATE = 256000
N_TIME = 4
GROUP_SIZE, TOP_K, S_KEYS = 63, 16, 4
K2 = TOP_K + 16
ROW = 3 * K2 + 1 + 2 * S_KEYS


def _cpu_mesh(n):
    return tmesh.make_mesh(1, n, devices=["cpu"] * n)


def _fm_scene(cfg):
    """test_parallel's scene: noise and FM at +30 kHz keyed from 2.2 s, two
    blocks as [F, group, 2] f32 pairs."""
    rng = np.random.default_rng(3)
    n = cfg.block_samples * 2
    t = np.arange(n) / RATE
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    phase = 2 * np.pi * 30000 * t + 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * 700 * t)) / RATE
    iq += 0.4 * np.exp(1j * phase) * (t >= 2.2)
    pairs = np.stack([iq.real, iq.imag], axis=-1).astype(np.float32)
    group = cfg.fft_size * cfg.decimator_factor
    return pairs.reshape(2, cfg.frames_per_block, group, 2)


def _now(cfg, b):
    return ((b * cfg.frames_per_block + 1 + np.arange(cfg.frames_per_block)) * cfg.frame_interval_ms).astype(np.int32)


def _port_sharded(cfg, blocks, keys, n=N_TIME, graphed=False):
    step = tss.make_time_sharded_scan(cfg, _cpu_mesh(n), GROUP_SIZE, TOP_K)
    step = sharded_step(step, "time-sharded scan") if graphed else step
    state = tsp.init_scan_state(cfg, device="cpu")
    out = []
    for b, blk in enumerate(blocks):
        state, body, spectro, ready = step(
            state, torch.from_numpy(blk), torch.from_numpy(_now(cfg, b)), torch.from_numpy(keys),
            torch.ones(cfg.fft_size, dtype=torch.bool), torch.tensor(8.0),
        )
        out.append((body.numpy(), spectro.numpy(), bool(ready), state))
    return out


def _jax_sharded(cfg, blocks, keys):
    step = jss.make_time_sharded_scan(cfg, jmesh.make_mesh(n_bands=1, n_time=N_TIME), GROUP_SIZE, TOP_K)
    state = jsp.init_scan_state(cfg, 0)
    out = []
    for b, blk in enumerate(blocks):
        state, body, spectro, ready = step(
            state, jnp.asarray(blk), jnp.asarray(_now(cfg, b)), jnp.asarray(keys),
            jnp.asarray(np.ones(cfg.fft_size, dtype=bool)), jnp.float32(8.0),
        )
        out.append((np.asarray(body), np.asarray(spectro), bool(ready), state))
    return out


def _assert_rows_close(got, ref):
    """test_parallel.py:154-167's bars between a time-sharded and a serial
    (or another package's) body."""
    gi, ri = got[:, :K2], ref[:, :K2]
    mism = gi != ri
    assert mism.mean() < 0.005, mism.mean()
    np.testing.assert_allclose(got[:, K2 : 2 * K2], ref[:, K2 : 2 * K2], atol=2e-3)  # cand_val by rank
    gb, rb = got[:, 2 * K2 : 3 * K2], ref[:, 2 * K2 : 3 * K2]
    assert ((gb != rb) & ~mism).mean() < 0.005  # votes differ only at ties
    np.testing.assert_array_equal(got[:, 3 * K2], ref[:, 3 * K2])  # count
    np.testing.assert_allclose(got[:, 3 * K2 + 1 :], ref[:, 3 * K2 + 1 :], atol=2e-3)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_time_sharded_scan_matches_serial_and_jax(graphed):
    cfg = tsp.ScanConfig.create(RATE, frames_per_block=84)  # 21 frames a shard
    jcfg = jsp.ScanConfig.create(RATE, frames_per_block=84)
    blocks = _fm_scene(cfg)
    keys = np.full(S_KEYS, -1, dtype=np.int32)
    sharded = _port_sharded(cfg, blocks, keys, graphed=graphed)
    jax_sharded = _jax_sharded(jcfg, blocks, keys)

    state = tsp.init_scan_state(cfg, 1, device="cpu")
    for b, blk in enumerate(blocks):
        acc = torch.zeros((1, cfg.spectro_size))
        state, acc, outs = tsp._compact_scan_block(
            cfg, GROUP_SIZE, TOP_K, state, acc, torch.from_numpy(blk)[None], torch.from_numpy(_now(cfg, b))[None],
            torch.from_numpy(keys), torch.ones(cfg.fft_size, dtype=torch.bool), torch.tensor(8.0), 0.0,
        )
        body, spectro, ready, st = sharded[b]
        ref = outs.packed[0, : cfg.frames_per_block * ROW].reshape(cfg.frames_per_block, ROW).numpy()
        _assert_rows_close(body, ref)
        np.testing.assert_allclose(spectro, acc[0].numpy(), atol=5e-3)
        assert ready == bool(outs.noise_ready[0])
        np.testing.assert_allclose(st.noise.threshold.numpy(), state.noise.threshold[0].numpy(), atol=2e-3)
        np.testing.assert_allclose(st.averager.ring.numpy(), state.averager.ring[0].numpy(), atol=2e-3)
        assert int(st.averager.frames) == int(state.averager.frames[0])

        jbody, jspectro, jready, jst = jax_sharded[b]
        _assert_rows_close(body, jbody)
        np.testing.assert_allclose(spectro, jspectro, atol=5e-3)
        assert ready == jready
        np.testing.assert_allclose(st.noise.threshold.numpy(), np.asarray(jst.noise.threshold), atol=2e-3)
    assert not sharded[0][2] and sharded[1][2]  # ready within block 1


def _grid_rows(cfg, seed=11):
    """Two blocks of PSD rows on a 1/16 dB grid, carried in [..., 0] of f32
    pairs: noise around -70 dB, two FM-like bumps 15-25 dB up from frame
    110 (after the 2 s learning, inside block 1's first shard)."""
    rng = np.random.default_rng(seed)
    f, fft = cfg.frames_per_block, cfg.fft_size
    rows = -70.0 + np.round(rng.normal(0.0, 2.0, size=(2 * f, fft)) * 16) / 16
    for lo, hi, gain in ((600, 640, 20.0), (300, 330, 15.0)):
        bump = gain + np.round(rng.uniform(-4, 4, size=(2 * f, hi - lo)) * 16) / 16
        rows[110:, lo:hi] += bump[110:]
    group = fft * cfg.decimator_factor
    pairs = np.zeros((2 * f, group, 2), dtype=np.float32)
    pairs[:, :fft, 0] = rows
    return pairs.reshape(2, f, group, 2)


def test_time_sharded_scan_exact_on_the_same_rows(monkeypatch):
    """Both packages' time-sharded scans fed the same PSD rows: every packed
    output, the spectrogram and the carried state are equal."""
    monkeypatch.setattr(jsp, "_frames_power", lambda cfg, iq: iq[:, : cfg.fft_size, 0])
    monkeypatch.setattr(tss, "_frames_power", lambda cfg, iq: iq[..., : cfg.fft_size, 0])
    cfg = tsp.ScanConfig.create(RATE, frames_per_block=84)
    jcfg = jsp.ScanConfig.create(RATE, frames_per_block=84)
    blocks = _grid_rows(cfg)
    keys = np.array([615, 310, 900, -1], dtype=np.int32)
    got, want = _port_sharded(cfg, blocks, keys), _jax_sharded(jcfg, blocks, keys)
    ints = np.r_[0:K2, 2 * K2 : 3 * K2 + 1, 3 * K2 + 1 + S_KEYS : ROW]  # indices, votes, count, key argmax
    vals = np.r_[K2 : 2 * K2, 3 * K2 + 1 : 3 * K2 + 1 + S_KEYS]
    for (body, spectro, ready, st), (jbody, jspectro, jready, jst) in zip(got, want):
        np.testing.assert_array_equal(body[:, ints], jbody[:, ints])
        # the reported values: the means' division rounds differently under
        # XLA (1 ulp), which the 21-bin smoothing carries to values near 0 dB
        np.testing.assert_allclose(body[:, vals], jbody[:, vals], rtol=5e-7, atol=1e-5)
        np.testing.assert_allclose(spectro, jspectro, rtol=1e-6)
        assert ready == jready
        np.testing.assert_array_equal(st.noise.threshold.numpy(), np.asarray(jst.noise.threshold))
        np.testing.assert_array_equal(st.averager.ring.numpy(), np.asarray(jst.averager.ring))
        np.testing.assert_array_equal(st.averager.total.numpy(), np.asarray(jst.averager.total))
        assert int(st.averager.frames) == int(jst.averager.frames)
    assert (got[1][0][:, 3 * K2] > 0).any(), "the scene detects nothing"


@pytest.mark.parametrize("n, fits", [(4, True), (2, True), (7, False), (4096, False)])
def test_time_sharded_modtap_fits_boundaries(n, fits):
    cfg = tdp.DdcConfig.create(256000, 16000, 2, 491520)
    jcfg = jdp.DdcConfig.create(256000, 16000, 2, 491520)
    assert cfg.modtap
    assert tss.time_sharded_modtap_fits(cfg, n) == jss.time_sharded_modtap_fits(jcfg, n) == fits
    v1 = tdp.DdcConfig.create(2_400_000, 32_000, 2, 75 * 2048)
    assert not v1.modtap and not tss.time_sharded_modtap_fits(v1, 2)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_modtap_ddc_matches_serial_and_jax(n, graphed):
    cfg = tdp.DdcConfig.create(256000, 16000, 2, 84 * 5120)  # the time-mesh session's block
    jcfg = jdp.DdcConfig.create(256000, 16000, 2, 84 * 5120)
    rng = np.random.default_rng(n)
    blocks = rng.integers(-100, 100, size=(2, cfg.block_samples, 2), dtype=np.int8)
    shifts = np.array([30_000, -52_500], dtype=np.int64)

    serial = tdp.make_ddc_step(cfg, device="cpu")
    sharded = tss.make_time_sharded_modtap_ddc(cfg, _cpu_mesh(n))
    sharded = sharded_step(sharded, "time-sharded DDC") if graphed else sharded
    tables = tdp.make_tables(cfg, shifts, device="cpu")
    s_serial = s_sharded = tdp.init_state(cfg, device="cpu")
    jstep = jss.make_time_sharded_modtap_ddc(jcfg, jmesh.make_mesh(n_bands=1, n_time=n))
    jtables = jdp.make_tables(jcfg, shifts)
    jstate = jdp.init_state(jcfg)
    for blk in blocks:
        x = torch.from_numpy(blk)
        s_serial, want = serial(s_serial, x, tables)
        s_sharded, got = sharded(s_sharded, x, tables)
        assert got.shape == (2, cfg.out_per_block, 2) and got.dtype == torch.int8
        assert torch.equal(got, want)
        for a, b in zip((s_sharded.phase, s_sharded.x_tail, *s_sharded.tails),
                        (s_serial.phase, s_serial.x_tail, *s_serial.tails)):
            assert torch.equal(a, b)
        jstate, jout = jstep(jstate, jnp.asarray(blk), jtables)
        d = np.abs(got.numpy().astype(np.int32) - np.asarray(jout).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    assert got.abs().max() > 10


CHUNKED = (2_048_000, 16_000, 2, 4 * 32768)  # two stages, (1, 8) then (1, 16) through the FIR
CHUNK_TARGET = 32768


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_time_sharded_modtap_ddc_chunk_loop_matches_serial_and_jax(n, graphed):
    """Four chunks a block through a two-stage chain, three blocks, slot 1
    restarted before block 2: each segment's chunk loop, the phase stepped
    a chunk at a time, shard 0's halos from the chunk before (from its own
    chunks on one shard) and the last shard's carry. Output and every carry
    leaf byte-equal to the port's serial DDC, the output within 1 LSB on
    under 1% of samples of the JAX time-sharded DDC."""
    cfg = tdp.DdcConfig.create(*CHUNKED, chunk_target=CHUNK_TARGET)
    jcfg = jdp.DdcConfig.create(*CHUNKED, chunk_target=CHUNK_TARGET)
    assert cfg.num_chunks == jcfg.num_chunks == 4 and len(cfg.plans) == 2 and cfg.modtap
    assert tss.time_sharded_modtap_fits(cfg, n)
    rng = np.random.default_rng(10 + n)
    blocks = rng.integers(-100, 100, size=(3, cfg.block_samples, 2), dtype=np.int8)
    shifts = np.array([250_123, -410_517], dtype=np.int64)  # the phase steps at every chunk

    serial = tdp.make_ddc_step(cfg, device="cpu")
    sharded = tss.make_time_sharded_modtap_ddc(cfg, _cpu_mesh(n))
    sharded = sharded_step(sharded, "time-sharded DDC") if graphed else sharded
    tables = tdp.make_tables(cfg, shifts, device="cpu")
    assert (tables.rot.step > 0.1).all()
    s_serial = s_sharded = tdp.init_state(cfg, device="cpu")
    jstep = jss.make_time_sharded_modtap_ddc(jcfg, jmesh.make_mesh(n_bands=1, n_time=n))
    jtables = jdp.make_tables(jcfg, shifts)
    jstate = jdp.init_state(jcfg)
    for b, blk in enumerate(blocks):
        if b == 2:  # a recording start in slot 1
            s_serial, s_sharded, jstate = (tdp.reset_slot(s_serial, 1), tdp.reset_slot(s_sharded, 1),
                                           jdp.reset_slot(jstate, 1))
        x = torch.from_numpy(blk)
        s_serial, want = serial(s_serial, x, tables)
        s_sharded, got = sharded(s_sharded, x, tables)
        assert got.shape == (2, cfg.out_per_block, 2) and got.dtype == torch.int8
        assert torch.equal(got, want), f"block {b}"
        for a, w in zip((s_sharded.phase, s_sharded.x_tail, *s_sharded.tails),
                        (s_serial.phase, s_serial.x_tail, *s_serial.tails)):
            assert torch.equal(a, w), f"block {b}"
        jstate, jout = jstep(jstate, jnp.asarray(blk), jtables)
        d = np.abs(got.numpy().astype(np.int32) - np.asarray(jout).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, f"block {b}"
    assert got.abs().max() > 10
    if graphed:
        assert sharded.captures == n * len(cfg.plans)
        assert sum(g.replays for g in sharded.graphs()) == len(blocks) * n * len(cfg.plans)
