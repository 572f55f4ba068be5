"""Stage-by-stage parity of the port with the JAX package: each stage gets
identical numpy-seeded inputs on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.models.ddc_pipeline import DdcConfig as JaxDdcConfig
from rtl_sdr_scanner_tpu.ops import averager as jav
from rtl_sdr_scanner_tpu.ops import ddc as jddc
from rtl_sdr_scanner_tpu.ops import detect as jdet
from rtl_sdr_scanner_tpu.ops import noise as jno
from rtl_sdr_scanner_tpu.ops import smooth as jsm
from rtl_sdr_scanner_tpu.ops import spectrogram as jsg
from rtl_sdr_scanner_tpu_torch import convert
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig
from rtl_sdr_scanner_tpu_torch.ops import averager as tav
from rtl_sdr_scanner_tpu_torch.ops import ddc as tddc
from rtl_sdr_scanner_tpu_torch.ops import detect as tdet
from rtl_sdr_scanner_tpu_torch.ops import noise as tno
from rtl_sdr_scanner_tpu_torch.ops import smooth as tsm
from rtl_sdr_scanner_tpu_torch.ops import spectrogram as tsg

torch.set_num_threads(2)
CPU = torch.device("cpu")
FFT = 2048
RTOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_noise_block():
    rng = np.random.default_rng(0)
    power = rng.normal(-60.0, 5.0, size=(2, 3, 10, FFT)).astype(np.float32)
    jstate = jno.init_noise_state(FFT, 0)
    tstate = tno.init_noise_state(1, FFT, 0, CPU)
    for b in range(3):  # learning ends inside block 1
        now = ((b * 10 + 1 + np.arange(10)) * 60).astype(np.int32)
        jstate, jout = jno.noise_block(jstate, jnp.asarray(power[0, b]), jnp.asarray(now), 1000)
        tstate, tout = tno.noise_block(
            tstate, torch.from_numpy(power[0, b])[None], torch.from_numpy(now)[None], 1000
        )
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout), rtol=RTOL)
        np.testing.assert_array_equal(tstate.threshold[0].numpy(), np.asarray(jstate.threshold))
        assert bool(tstate.ready[0]) == bool(jstate.ready)
    assert bool(tstate.ready[0])


def test_averager_block():
    rng = np.random.default_rng(1)
    jstate = jav.init_averager_state(FFT, 21)
    tstate = tav.init_averager_state(1, FFT, 21, CPU)
    for b in range(3):
        rows = rng.normal(0.0, 5.0, size=(15, FFT)).astype(np.float32)
        jstate, jm = jav.averager_block(jstate, jnp.asarray(rows))
        tstate, tm = tav.averager_block(tstate, torch.from_numpy(rows)[None])
        # each mean is a difference of two f32 prefix sums, whose order the
        # two frameworks' cumsums may take differently: rounding at the
        # prefix's magnitude
        scale = np.abs(rows).max()
        np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm), rtol=RTOL, atol=RTOL * scale)
        np.testing.assert_array_equal(
            tav.ordered_history(tstate)[0].numpy(), np.asarray(jav.ordered_history(jstate))
        )
        assert int(tstate.frames[0]) == int(jstate.frames)


def test_ordered_history_from_a_rotated_ring():
    """A state carried across with pos != 0 reads oldest-first."""
    ring = np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    jstate = jav.AveragerState(jnp.asarray(ring), jnp.zeros(4), jnp.int32(3), jnp.int32(5))
    tstate = tav.AveragerState(
        torch.from_numpy(ring)[None], torch.zeros(1, 4), torch.tensor([3]), torch.tensor([5])
    )
    np.testing.assert_array_equal(
        tav.ordered_history(tstate)[0].numpy(), np.asarray(jav.ordered_history(jstate))
    )


@pytest.mark.parametrize("group", [21, 23, 64])
def test_sliding_average(group):
    x = np.random.default_rng(2).normal(0.0, 5.0, size=(3, FFT)).astype(np.float32)
    want = np.asarray(jsm.sliding_average(jnp.asarray(x), group))
    got = tsm.sliding_average(torch.from_numpy(x), group).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_accumulate_frames():
    x = np.random.default_rng(3).normal(-80.0, 5.0, size=(10, FFT)).astype(np.float32)
    want = np.asarray(jsg.accumulate_frames(jnp.asarray(x), 256))
    got = tsg.accumulate_frames(torch.from_numpy(x)[None], 256)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("group", [103, 301])
def test_compact_detection(group, bf16):
    """Identical avg/raw/prev_tail rows: index fields and counts equal,
    values within rtol 1e-6 (in fact equal: the same f32 values are
    gathered), through both of the port's selection routes. Group 301 takes
    the wide-window pair-table vote."""
    rng = np.random.default_rng(group)
    f, fft, h1 = 6, 4096, 10
    avg = rng.normal(0.0, 5.0, size=(f, fft)).astype(np.float32)
    raw = rng.normal(0.0, 5.0, size=(f, fft)).astype(np.float32)
    prev = rng.normal(0.0, 5.0, size=(h1, fft)).astype(np.float32)
    avg[:, 3000:3100] += 30.0  # one strong cluster above the level
    raw[:, 3040:3060] += 30.0
    keys = np.array([5, 700, 3050, -1], dtype=np.int32)
    valid = np.ones(fft, dtype=bool)
    valid[:64] = False
    level = np.float32(8.0)

    # the JAX package pins its two selection routes equal
    # (tests/test_pallas_select.py); its Pallas route compiles faster here
    want = jdet.compact_detection(
        jnp.asarray(avg), jnp.asarray(raw), jnp.asarray(prev), jnp.asarray(keys),
        jnp.asarray(valid), jnp.asarray(level), group, 32, bf16=bf16, pallas_select=True,
    )
    assert (np.asarray(want.cand_best) != np.asarray(want.cand_idx)).any()  # votes moved something
    for pallas_select in (False, True):
        got = tdet.compact_detection(
            torch.from_numpy(avg)[None], torch.from_numpy(raw)[None], torch.from_numpy(prev)[None],
            torch.from_numpy(keys), torch.from_numpy(valid), torch.tensor(level), group, 32,
            bf16=bf16, pallas_select=pallas_select,
        )
        for name in ("cand_idx", "cand_best", "cand_count", "key_idx"):
            np.testing.assert_array_equal(
                getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)), err_msg=name
            )
        for name in ("cand_val", "key_val"):
            np.testing.assert_allclose(
                getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)), rtol=RTOL, err_msg=name
            )


@pytest.mark.parametrize("int8", [True, False])
def test_ddc_modtap_three_chunks(int8):
    """Banded modtap DDC over 3 chunks (2 bands, 2 slots, two stages): int8
    output within 1 LSB, carried tails within 1e-6, phases equal."""
    rate, chunk, nb = 2_048_000, 1 << 15, 2
    jcfg = JaxDdcConfig.create(rate, 16_000, 2, chunk)
    tcfg = DdcConfig.create(rate, 16_000, 2, chunk)
    assert jcfg.modtap and len(jcfg.plans) == 2
    shifts = np.array([[250_000, -771_300], [2_500, 1_023_999]], dtype=np.int64)
    jtab = jax.tree.map(lambda *a: jnp.stack(a), *[jddc.make_mod_tables(jcfg.plans, s, rate, chunk) for s in shifts])
    jstate = jax.tree.map(lambda a: jnp.stack([a, a]), jddc.init_ddc2_state(jcfg.plans, 2))
    ttab = tddc.make_mod_tables(tcfg.plans, shifts, rate, chunk, CPU)
    tstate = tddc.init_ddc2_state(tcfg.plans, nb, 2, CPU)
    rng = np.random.default_rng(5)
    for c in range(3):
        if int8:
            iq = rng.integers(-100, 100, size=(nb, chunk, 2), dtype=np.int8)
        else:
            iq = (0.4 * rng.standard_normal((nb, chunk, 2))).astype(np.float32)
        jstate, jout = jddc.ddc_chunk_modtap(jnp.asarray(iq), jstate, jtab, jcfg.plans)
        tstate, tout = tddc.ddc_chunk_modtap(torch.from_numpy(iq), tstate, ttab, tcfg.plans)
        diff = np.abs(tout.numpy().astype(np.int32) - np.asarray(jout).astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01
    js = _np(jstate)
    np.testing.assert_allclose(tstate.phase.numpy(), js.phase, rtol=1e-6)
    np.testing.assert_array_equal(tstate.x_tail.numpy(), js.x_tail)
    for t, j in zip(tstate.tails, js.tails):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6)


@pytest.mark.parametrize("decim", [40, 125])
def test_stage_apply_forms(decim):
    """One decimating stage, chunked-matmul form (M=40) and polyphase conv
    form (M=125, no lane-aligned chunk fits), tail carried over 2 calls."""
    plan = jddc.plan_stage(1, decim)
    assert (plan.chunk_c > 0) == (decim == 40)
    rng = np.random.default_rng(decim)
    jtail = jnp.zeros((3, 2, plan.tail_len), jnp.float32)
    ttail = torch.zeros((3, 2, plan.tail_len))
    for _ in range(2):
        x = rng.standard_normal((3, 2, decim * 400)).astype(np.float32)
        jy, jtail = jddc._stage_apply(jnp.asarray(x), jtail, plan)
        ty, ttail = tddc._stage_apply(torch.from_numpy(x), ttail, tddc.plan_stage(1, decim))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5 * np.abs(np.asarray(jy)).max())
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    with pytest.raises(NotImplementedError):
        tddc._stage_apply(torch.zeros((1, 2, 8)), torch.zeros((1, 2, 4)), tddc.plan_stage(3, 2))


def test_reset_slot2_matches():
    rate, chunk = 2_048_000, 1 << 15
    plans = jddc.plan_chain(rate, 16_000)
    rng = np.random.default_rng(9)
    state = jddc.Ddc2State(
        phase=jnp.asarray(rng.random(2).astype(np.float32)),
        x_tail=jnp.asarray(rng.random((2, plans[0].tail_len)).astype(np.float32)),
        tails=(jnp.asarray(rng.random((2, 2, plans[1].tail_len)).astype(np.float32)),),
    )
    want = _np(jddc.reset_slot2(state, 1))
    s = _np(state)
    got = tddc.reset_slot2(
        convert.ddc2_state(s.phase[None], s.x_tail[None], [t[None] for t in s.tails], CPU), 0, 1
    )
    np.testing.assert_array_equal(got.phase[0].numpy(), want.phase)
    np.testing.assert_array_equal(got.x_tail[0].numpy(), want.x_tail)
    np.testing.assert_array_equal(got.tails[0][0].numpy(), want.tails[0])
