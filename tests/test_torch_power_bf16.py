"""power_bf16 in the port against the JAX package (``tests/test_power_bf16.py``'s
cases): the noise-subtracted rows are stored in bf16 (the averager ring,
the history-vote rows); the PSD, the noise floor and the spectrogram stay
f32, so they are bit-identical to the bf16-selection mode; reported powers
move by at most 2^-9 of the dB values entering a window (0.05 dB here);
every tracker decision matches, frame by frame, the JAX package's power_bf16
run and the port's bf16-selection run. The flag needs detection_bf16, and a
bf16 ring carried over from the JAX package converts bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.constants import Tunables as JaxTunables
from rtl_sdr_scanner_tpu.models import scan_pipeline as jsp
from rtl_sdr_scanner_tpu_torch import convert
from rtl_sdr_scanner_tpu_torch.constants import Tunables
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
from rtl_sdr_scanner_tpu_torch.runtime.transmission_tracker import TransmissionTracker
from tests.test_detect_bf16 import CENTER, GROUP, KEY_SLOTS, TOP_K, _make_iq
from tests.test_detect_bf16 import _make_tracker as _jax_tracker
from tests.test_power_bf16 import _run_blocks as _run_jax

torch.set_num_threads(2)
RATE = 256000


def _tracker(cfg):
    return TransmissionTracker(
        fft_size=cfg.fft_size, group_size=GROUP, start_level=8.0, stop_level=5.0, recording_min_time_ms=500,
        recording_timeout_ms=500, tuning_step=2500, index_to_shift=cfg.index_to_shift,
        index_to_frequency=lambda i: cfg.index_to_frequency(i, CENTER), is_index_in_range=lambda i: True,
    )


def _run_port(iq, cfg, state=None, first_block=0):
    """tests/test_power_bf16._run_blocks through the port's compact step on
    the CPU: (decision log, per-block (cand_idx, cand_val), spectrogram
    sum, noise threshold, state)."""
    group = cfg.fft_size * cfg.decimator_factor
    step = tsp.make_compact_scan_step(cfg, GROUP, TOP_K, device="cpu")
    tracker = _tracker(cfg)
    state = tsp.init_scan_state(cfg, device="cpu") if state is None else state
    acc = tsp.init_spectro_acc(cfg, device="cpu")
    valid = torch.ones(cfg.fft_size, dtype=torch.bool)
    log, values = [], []
    pairs = np.ascontiguousarray(iq).view(np.float32).reshape(-1, 2)
    for b in range(first_block, len(iq) // cfg.block_samples):
        block = pairs[b * cfg.block_samples : (b + 1) * cfg.block_samples]
        now = ((b * cfg.frames_per_block + 1 + np.arange(cfg.frames_per_block)) * cfg.frame_interval_ms).astype(
            np.int32)
        keys = tracker.current_keys(KEY_SLOTS)
        state, acc, oc = step(
            state, acc, torch.from_numpy(block).reshape(cfg.frames_per_block, group, 2), torch.from_numpy(now),
            torch.from_numpy(keys), valid, torch.tensor(8.0), 1.0,
        )
        c = oc.compact
        ci, cv, cb, cc, kv, ki = (a.numpy() for a in c)
        values.append((ci.copy(), cv.copy()))
        for k in range(cfg.frames_per_block):
            log.append((int(now[k]), sorted(tracker.process_compact(
                ci[k], cv[k], cb[k], int(cc[k]), keys, kv[k], ki[k], int(now[k])))))
    return log, values, acc.numpy(), state.noise.threshold.numpy(), state


def _cfgs(pkg):
    mod, tun = (jsp, JaxTunables) if pkg == "jax" else (tsp, Tunables)
    base = mod.ScanConfig.create(RATE, frames_per_block=10, tunables=tun())
    return dataclasses.replace(base, detection_bf16=True), dataclasses.replace(base, detection_bf16=True, power_bf16=True)


@pytest.mark.parametrize("seed", [5, 17])
def test_power_bf16_decisions_match(seed):
    rng = np.random.default_rng(seed)
    signals = [
        (int(rng.integers(-100_000, 100_000)), int(rng.integers(300, 2000)),
         float(rng.uniform(2.5, 4.5)), float(rng.uniform(5.0, 7.0)))
        for _ in range(3)
    ]
    iq = _make_iq(np.random.default_rng(seed + 100), signals)
    cfg_sel, cfg_pow = _cfgs("torch")
    log_sel, _, spec_sel, noise_sel, _ = _run_port(iq, cfg_sel)
    log_pow, _, spec_pow, noise_pow, state = _run_port(iq, cfg_pow)
    assert state.averager.ring.dtype == torch.bfloat16
    assert any(tr for _, tr in log_sel), "scene produced no detections"
    assert log_pow == log_sel, "power_bf16 changed detection decisions"
    np.testing.assert_array_equal(spec_pow, spec_sel)
    np.testing.assert_array_equal(noise_pow, noise_sel)
    jax_log, _, _, _ = _run_jax(iq, _cfgs("jax")[1])
    assert log_pow == jax_log, "the port's power_bf16 decisions differ from the JAX package's"


def test_power_bf16_reported_value_bound():
    iq = _make_iq(np.random.default_rng(7), [(30_000, 800, 2.5, 6.0)])
    cfg_sel, cfg_pow = _cfgs("torch")
    _, vals_sel, _, _, _ = _run_port(iq, cfg_sel)
    _, vals_pow, _, _, _ = _run_port(iq, cfg_pow)
    checked = 0
    for (ci_a, cv_a), (ci_b, cv_b) in zip(vals_sel, vals_pow):
        for k in range(ci_a.shape[0]):
            _, ia, ib = np.intersect1d(ci_a[k], ci_b[k], return_indices=True)
            va, vb = cv_a[k][ia], cv_b[k][ib]
            m = (va > -1e30) & (vb > -1e30)  # skip masked sentinels
            assert (np.abs(va[m] - vb[m]) <= 0.05).all(), np.abs(va[m] - vb[m]).max()
            checked += int(m.sum())
    assert checked > 1000


def test_power_bf16_requires_detection_bf16():
    cfg = tsp.ScanConfig.create(RATE, tunables=Tunables(power_bf16=True, detection_bf16=False))
    jcfg = jsp.ScanConfig.create(RATE, tunables=JaxTunables(power_bf16=True, detection_bf16=False))
    assert not cfg.power_bf16 and not jcfg.power_bf16
    cfg2 = tsp.ScanConfig.create(RATE, tunables=Tunables(power_bf16=True, detection_bf16=True))
    assert cfg2.power_bf16
    state = tsp.init_scan_state(cfg2, device="cpu")
    assert state.averager.ring.dtype == torch.bfloat16 and state.averager.total.dtype == torch.float32
    assert tsp.init_scan_state(cfg, device="cpu").averager.ring.dtype == torch.float32


def _run_jax_from(iq, cfg, state, first_block, last_block):
    """The JAX compact step over blocks [first_block, last_block) from
    ``state``, with a fresh tracker when there is one: (log, state)."""
    step = jsp.make_compact_scan_step(cfg, GROUP, TOP_K)
    acc, tracker = jsp.init_spectro_acc(cfg), _jax_tracker(cfg)
    group = cfg.fft_size * cfg.decimator_factor
    valid = jnp.asarray(np.ones(cfg.fft_size, dtype=bool))
    log = []
    for b in range(first_block, last_block):
        block = iq[b * cfg.block_samples : (b + 1) * cfg.block_samples].reshape(cfg.frames_per_block, group)
        now = ((b * cfg.frames_per_block + 1 + np.arange(cfg.frames_per_block)) * cfg.frame_interval_ms).astype(
            np.int32)
        keys = tracker.current_keys(KEY_SLOTS)
        state, acc, oc = step(state, acc, jnp.asarray(block), jnp.asarray(now), jnp.asarray(keys), valid,
                              jnp.float32(8.0), jnp.float32(1.0))
        ci, cv, cb, cc, kv, ki = (np.asarray(a) for a in oc.compact)
        for k in range(cfg.frames_per_block):
            log.append((int(now[k]), sorted(tracker.process_compact(
                ci[k], cv[k], cb[k], int(cc[k]), keys, kv[k], ki[k], int(now[k])))))
    return log, state


def test_bf16_ring_from_jax_converts_bit_for_bit():
    """A JAX power_bf16 state after 30 blocks (its bf16 ring given as the
    ml_dtypes array and as its uint16 view) becomes the port's state with
    the same bits, and the port resumes from it with the JAX run's
    decisions (both with fresh trackers from block 30)."""
    iq = _make_iq(np.random.default_rng(7), [(30_000, 800, 2.5, 6.0)])
    jcfg, cfg = _cfgs("jax")[1], _cfgs("torch")[1]
    _, jstate = _run_jax_from(iq, jcfg, jsp.init_scan_state(jcfg), 0, 30)
    ring = np.asarray(jstate.averager.ring)
    assert ring.dtype.name == "bfloat16"
    bits = ring.view(np.uint16)
    for given in (ring, bits):
        noise = {k: np.asarray(v)[None] for k, v in jstate.noise._asdict().items()}
        avg = {k: np.asarray(v)[None] for k, v in jstate.averager._asdict().items()}
        avg["ring"] = given[None]
        state = convert.scan_state(noise, avg, device="cpu")
        assert state.averager.ring.dtype == torch.bfloat16
        np.testing.assert_array_equal(state.averager.ring.view(torch.int16).numpy()[0].view(np.uint16), bits)
    single = type(state)(*(type(part)(*(t[0] for t in part)) for part in state))
    log, _, _, _, _ = _run_port(iq, cfg, state=single, first_block=30)
    want, _ = _run_jax_from(iq, jcfg, jstate, 30, len(iq) // jcfg.block_samples)
    assert any(tr for _, tr in want) and log == want
