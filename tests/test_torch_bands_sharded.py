"""The bands axis of the port's mesh: every bands step at n = 2 and 4 band
shards (a mesh of copies of the CPU device) against its n = 1 form, and
against the JAX package's multi-device forms (conftest's virtual CPU
devices).

Step level (8 channels of 256 kHz from one 2.048 Msps stream, 2 blocks of
12 frames of fft 1024, 2 slots at 16 kHz, noise learning of one frame, a
tone in channel 3 detected once the averager has filled): the full-row
step, the compact step, the wideband step, the fused step and the
banded DDC give the n = 1 form's packed rows and recordings exactly, and
the fused step equals the split pair (``tests/test_parallel.py:195``); the
JAX forms' channels agree within 2e-5 (``tests/test_channelizer.py``'s bar)
and their recordings within 1 LSB.

Session level (``tests/test_mesh_banded_ddc.py``'s method): the port's
``WidebandScanner`` with ``mesh_bands=2`` over two shards against the JAX
package's on two virtual devices, payload by payload
(``torch_checks.compare_payloads``), split and fused.

The step-level comparisons with the one-shard form and with the JAX
package, and the session, run the port's steps eager and graphed
(``graph.sharded_step``). The wideband noise
snapshots stay as the reference has them in the batched forms: the band
state is not seeded from a snapshot, and no snapshot is saved from it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.models import ddc_pipeline as jdp
from rtl_sdr_scanner_tpu.models import scan_pipeline as jsp
from rtl_sdr_scanner_tpu.ops import channelizer as jch
from rtl_sdr_scanner_tpu.parallel import mesh as jmesh
from rtl_sdr_scanner_tpu.parallel import sharded_scan as jss
from rtl_sdr_scanner_tpu_torch.graph import ShardedStep, sharded_step
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
from rtl_sdr_scanner_tpu_torch.ops import channelizer as tch
from rtl_sdr_scanner_tpu_torch.parallel import mesh as tmesh
from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as tss
from rtl_sdr_scanner_tpu_torch.runtime import sdr_device
from rtl_sdr_scanner_tpu_torch.runtime import wideband as twideband
from tests.test_torch_wideband import B, _raw, _scan, _scene, _write, captures  # noqa: F401
from torch_checks import compare_payloads

torch.set_num_threads(2)
NB, SUB_RATE, FRAMES, SLOTS, GROUP_SIZE, TOP_K, KEYS = 8, 256_000, 12, 2, 64, 16, 16


@pytest.fixture(scope="module")
def scene():
    cfg = dataclasses.replace(tsp.ScanConfig.create(SUB_RATE, frames_per_block=FRAMES), noise_learning_ms=0)
    ddc_cfg = tdp.DdcConfig.create(SUB_RATE, 16000, SLOTS, cfg.block_samples)
    assert ddc_cfg.modtap
    rng = np.random.default_rng(9)
    n = NB * cfg.block_samples
    t = np.arange(2 * n)
    x = 0.05 * rng.standard_normal((2 * n, 2))
    # a tone in channel 3 (of 8 over 2.048 Msps) from frame 1 on, after the
    # one learning frame: it detects once the averager has filled (frame 20)
    on = t >= NB * cfg.fft_size * cfg.decimator_factor
    x[:, 0] += 0.5 * on * np.cos(2 * np.pi * (3 * SUB_RATE + 20_000) * t / (NB * SUB_RATE))
    x[:, 1] += 0.5 * on * np.sin(2 * np.pi * (3 * SUB_RATE + 20_000) * t / (NB * SUB_RATE))
    pairs = x.astype(np.float32).reshape(2, n, 2)
    shifts = rng.integers(-SUB_RATE // 2, SUB_RATE // 2, size=(NB, SLOTS)).astype(np.int64)
    keep = np.ones((NB, SLOTS), dtype=np.float32)
    keep[3, 1] = 0.0  # an in-step slot reset too
    keys = np.full((NB, KEYS), -1, dtype=np.int32)
    keys[3, 0] = 600
    return cfg, ddc_cfg, pairs, shifts, keep, keys


def _now(cfg, b):
    return ((b * FRAMES + 1 + np.arange(FRAMES)) * cfg.frame_interval_ms).astype(np.int32)


def _run_port(scene, n, form, graphed=False):
    """Two blocks through the port's bands steps over n shards (graphed:
    ``graph.sharded_step``s); returns the stacked (packed, rec, channels) of
    each block and the final states."""
    cfg, ddc_cfg, pairs, shifts, keep, keys = scene
    mesh = tmesh.make_mesh(n, 1, devices=["cpu"] * n)
    plan = tch.plan_channelizer(NB)
    chan = tss.replicate(tch.init_channelizer_state(plan, "cpu"), mesh)
    state = tss.init_banded_state(cfg, NB, mesh)
    acc = tss.shard_bands(torch.zeros((NB, cfg.spectro_size)), mesh)
    ddc = tss.init_banded_ddc_state(ddc_cfg, NB, mesh)
    tables = tss.shard_bands(tdp.make_tables(ddc_cfg, shifts, device="cpu"), mesh)
    keys_s = tss.shard_bands(torch.from_numpy(keys), mesh)
    valid = tss.shard_bands(torch.ones((NB, cfg.fft_size), dtype=torch.bool), mesh)
    level = tss.replicate(torch.tensor(8.0), mesh)
    keep_s = tss.shard_bands(torch.from_numpy(keep), mesh)
    fused = tss.make_sharded_wideband_fused_step(cfg, ddc_cfg, GROUP_SIZE, TOP_K, mesh, plan, 1, NB)
    wide = tss.make_sharded_wideband_step(cfg, GROUP_SIZE, TOP_K, mesh, plan, 1, NB)
    banded = tss.make_sharded_banded_ddc(ddc_cfg, mesh, NB)
    compact = tss.make_sharded_compact_step(cfg, GROUP_SIZE, TOP_K, mesh)
    full = tss.make_sharded_scan_step(cfg, mesh)
    if graphed:
        fused, wide, banded, compact, full = (
            sharded_step(s, name) for s, name in ((fused, "fused"), (wide, "wide"), (banded, "banded"),
                                                  (compact, "compact"), (full, "full")))
    out = []
    for b in range(2):
        x = tss.replicate(torch.from_numpy(pairs[b]), mesh)
        now = tss.replicate(torch.from_numpy(_now(cfg, b)), mesh)
        if form == "fused":
            chan, state, acc, ddc, packed, rec, channels = fused(
                chan, state, acc, ddc, x, now, keys_s, valid, level, 1.0, tables, keep_s)
        elif form == "split":
            chan, state, acc, packed, channels = wide(chan, state, acc, x, now, keys_s, valid, level, 1.0)
            ddc, rec = banded(ddc, channels, tables, keep_s)
        else:  # the compact or full-row step on the one-device channelizer's channels
            channels = tss.shard_bands(_channels(plan, pairs, b), mesh)
            iq = [c.reshape(c.shape[0], FRAMES, -1, 2) for c in channels]
            nows = [n_[None].expand(c.shape[0], FRAMES) for n_, c in zip(now, channels)]
            if form == "compact":
                state, acc, outs = compact(state, acc, iq, nows, keys_s, valid, level, 1.0)
                packed = [o.packed for o in outs]
            else:
                state, outs = full(state, iq, nows)
                packed = [torch.cat([o.raw, o.avg], dim=2).reshape(o.raw.shape[0], -1) for o in outs]
                acc = [o.spectro_sum for o in outs]
            rec = [torch.zeros(c.shape[0]) for c in channels]  # no DDC
        out.append(tuple(tss.gather_bands(v, torch.device("cpu")) for v in (packed, rec, channels)))
    return out, tss.gather_bands(state, torch.device("cpu")), tss.gather_bands(acc, torch.device("cpu"))


def _channels(plan, pairs, b):
    state = tch.init_channelizer_state(plan, "cpu")
    for i in range(b + 1):
        state, ch = tch.channelize_block_pairs(plan, state, torch.from_numpy(pairs[i]))
    return ch


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("form", ["full", "compact", "split", "fused"])
@pytest.mark.parametrize("n", [2, 4])
def test_band_shards_match_one_shard(scene, form, n, graphed):
    one, state1, acc1 = _run_port(scene, 1, form)
    got, state_n, acc_n = _run_port(scene, n, form, graphed)
    for (p1, r1, c1), (pn, rn, cn) in zip(one, got):
        assert torch.equal(pn, p1) and torch.equal(rn, r1) and torch.equal(cn, c1)
    for a, b in zip(tss._leaves(state_n), tss._leaves(state1)):
        assert torch.equal(a, b)
    assert torch.equal(acc_n, acc1)
    if form == "full":  # channel 3's raw rows reach the level
        assert got[1][0][3].max() > 8.0, "channel 3 detects nothing"
    else:
        cand_count = tsp.unpack_compact(got[1][0][3].numpy(), FRAMES, TOP_K, KEYS)[3]
        assert cand_count.max() > 0, "channel 3 detects nothing"


def test_fused_equals_split_over_four_shards(scene):
    split, s_state, s_acc = _run_port(scene, 4, "split")
    fused, f_state, f_acc = _run_port(scene, 4, "fused")
    for a, b in zip(split, fused):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(s_acc, f_acc)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("n", [2, 4])
def test_band_shards_match_jax_multi_device(scene, n, graphed):
    """The JAX fused step on n virtual devices and the port's on n CPU
    shards (eager or graphed): channels within 2e-5, recordings within 1
    LSB, and the packed rows' integer columns (candidate bins, votes,
    counts) equal."""
    cfg, ddc_cfg, pairs, shifts, keep, keys = scene
    jcfg = dataclasses.replace(jsp.ScanConfig.create(SUB_RATE, frames_per_block=FRAMES), noise_learning_ms=0)
    jddc = jdp.DdcConfig.create(SUB_RATE, 16000, SLOTS, jcfg.block_samples)
    mesh = jmesh.make_mesh(n_bands=n, n_time=1)
    plan = jch.plan_channelizer(NB)
    step = jss.make_sharded_wideband_fused_step(jcfg, jddc, GROUP_SIZE, TOP_K, mesh, plan, 1, NB)
    per_band = [jdp.make_tables(jddc, shifts[b]) for b in range(NB)]
    tables = jax.device_put(jax.tree.map(lambda *xs: jnp.stack(xs), *per_band), jmesh.band_sharding(mesh))
    states = (
        jax.device_put(jch.init_channelizer_state(plan), jmesh.replicated(mesh)),
        jss.init_banded_state(jcfg, NB, mesh),
        jax.device_put(jnp.zeros((NB, jcfg.spectro_size), jnp.float32), jmesh.band_sharding(mesh)),
        jss.init_banded_ddc_state(jddc, NB, mesh),
    )
    got, _, _ = _run_port(scene, n, "fused", graphed)
    for b in range(2):
        *states, packed, rec, channels = step(
            *states, jnp.asarray(pairs[b]), jnp.asarray(_now(cfg, b)), jnp.asarray(keys),
            jnp.asarray(np.ones((NB, cfg.fft_size), dtype=bool)), jnp.float32(8.0), jnp.float32(1.0), tables, keep,
        )
        p, r, c = (v.numpy() for v in got[b])
        np.testing.assert_allclose(c, np.asarray(channels), atol=2e-5, rtol=2e-5)
        assert np.abs(r.astype(np.int32) - np.asarray(rec).astype(np.int32)).max() <= 1
        for band in range(NB):
            mine = tsp.unpack_compact(p[band], FRAMES, TOP_K, KEYS)
            theirs = tsp.unpack_compact(np.asarray(packed)[band], FRAMES, TOP_K, KEYS)
            for i in (3, 6):  # candidate count, noise ready
                np.testing.assert_array_equal(mine[i], theirs[i])
            if band == 3:  # the tone's channel: its strongest bins decided by dB
                np.testing.assert_array_equal(mine[0][:, :4], theirs[0][:, :4])
                np.testing.assert_allclose(mine[1][:, :4], theirs[1][:, :4], atol=1e-3)


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
@pytest.mark.parametrize("form", ["split", "fused"])
def test_two_shard_session_matches_jax(captures, monkeypatch, form, graphed):  # noqa: F811
    """WidebandScanner with mesh_bands=2: the port over two CPU shards (two
    visible cards patched in; its steps graphed, as the runtime runs them,
    or their eager programs), the JAX package over two virtual devices."""
    monkeypatch.setattr(sdr_device, "visible_cards", lambda device: 2)
    if not graphed:
        monkeypatch.setattr(twideband, "sharded_step", lambda program, name: program)
    raw = _raw(captures["cs8"], "cs8", {"mesh_bands": 2, "wideband_fused_dispatch": form == "fused"})
    want, jscanner = _scan("jax", raw)
    got, scanner = _scan("torch", raw)
    assert scanner._mesh.shape == {"bands": 2, "time": 1} and jscanner._mesh.devices.size == 2
    assert isinstance(scanner._wide_step, ShardedStep) == graphed
    assert len(scanner._band_state) == 2 and scanner._band_acc[1].shape[0] == B // 2
    stats = compare_payloads(want, got)
    assert stats["transmissions"] > 10


def test_noise_snapshots_neither_seed_nor_leave_the_band_shards(tmp_path, monkeypatch):
    """The batched forms keep the reference's behaviour over several shards
    too: a snapshot on disk does not seed the band state (each shard's
    floor learns from scratch), and the run saves none of its own; the JAX
    package's mesh run leaves the same files."""
    monkeypatch.setattr(sdr_device, "visible_cards", lambda device: 2)
    capture = tmp_path / "noise.cf32"
    _write(capture, _scene(secs=2.6, signals=()), "cf32")
    for pkg in ("jax", "torch"):
        base = tmp_path / pkg / "noise"
        base.parent.mkdir()
        _scan(pkg, _raw(capture, tunables={"noise_state_path": str(base), "mesh_bands": 2}))
        assert not list(base.parent.glob("*.npz")), f"{pkg}: a batched run saved a snapshot"
    # seed snapshots from a serial run, then scan over two shards
    base = tmp_path / "torch" / "noise"
    _scan("torch", _raw(capture, tunables={"noise_state_path": str(base)}))
    snaps = sorted(base.parent.glob("*.npz"))
    assert len(snaps) == B
    before = {p.name: dict(np.load(p)) for p in snaps}
    cfg = _raw(capture, tunables={"noise_state_path": str(base), "mesh_bands": 2})
    from rtl_sdr_scanner_tpu_torch.runtime import config as tconfig
    from rtl_sdr_scanner_tpu_torch.runtime import mqtt_client as tmqtt
    from rtl_sdr_scanner_tpu_torch.runtime import wideband as twideband

    config = tconfig.Config(json.loads(json.dumps(cfg)))
    scanner = twideband.WidebandScanner(config, config.devices[0], tmqtt.NullMqtt(), 4, device="cpu")
    assert len(scanner._band_state) == 2
    assert not any(bool(s.noise.ready.any()) for s in scanner._band_state)
    assert all(bool(torch.isinf(s.noise.threshold).all()) for s in scanner._band_state)
    scanner.run_to_completion()
    scanner.stop()
    for p in snaps:  # re-saved as loaded: the batched floors never reach them
        after = dict(np.load(p))
        assert after.keys() == before[p.name].keys()
        for k in after:
            np.testing.assert_array_equal(after[k], before[p.name][k])
