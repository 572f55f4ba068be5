"""Stage-by-stage parity of the port with the JAX package: each stage gets
identical numpy-seeded inputs on both sides."""

import sys
from pathlib import Path

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
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
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
    gathered), through the port's selection wrapper (its plain version on
    the CPU). Group 301 takes the wide-window pair-table vote."""
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
    got = tdet.compact_detection(
        torch.from_numpy(avg)[None], torch.from_numpy(raw)[None], torch.from_numpy(prev)[None],
        torch.from_numpy(keys), torch.from_numpy(valid), torch.tensor(level), group, 32,
        bf16=bf16,
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
    """One decimating stage through the port's _stage_apply (the FIR
    wrapper, its plain version on the CPU) against both of the JAX
    package's forms: the chunked matmul (M=40) and the polyphase conv
    (M=125, no lane-aligned chunk fits), tail carried over 2 calls; and an
    interpolating stage (3, 2)."""
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
    x = rng.standard_normal((1, 2, 8)).astype(np.float32)
    t = tddc.plan_stage(3, 2).tail_len
    jy, _ = jddc._stage_apply(jnp.asarray(x), jnp.zeros((1, 2, t), jnp.float32), jddc.plan_stage(3, 2))
    ty, _ = tddc._stage_apply(torch.from_numpy(x), torch.zeros((1, 2, t)), tddc.plan_stage(3, 2))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5 * np.abs(np.asarray(jy)).max())


@pytest.mark.parametrize("interp,decim", [(5, 4), (2, 125), (16, 125), (3, 40), (2, 25)])
def test_stage_apply_interpolating(interp, decim):
    """The causal zero-stuffed FIR: output length and phase from the
    reference's dilated-lhs padding rule, tails exact, over 2 calls."""
    plan = jddc.plan_stage(interp, decim)
    rng = np.random.default_rng(interp * 1000 + decim)
    tail = rng.standard_normal((2, 2, plan.tail_len)).astype(np.float32)
    jtail, ttail = jnp.asarray(tail), torch.from_numpy(tail)
    for _ in range(2):
        x = rng.standard_normal((2, 2, decim * 96)).astype(np.float32)
        jy, jtail = jddc._stage_apply(jnp.asarray(x), jtail, plan)
        ty, ttail = tddc._stage_apply(torch.from_numpy(x), ttail, tddc.plan_stage(interp, decim))
        want = np.asarray(jy)
        assert ty.shape == want.shape == (2, 2, 96 * interp)
        np.testing.assert_allclose(ty.numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))


def _assert_int8_close(got, want):
    """Within 1 LSB, on < 1% of samples (f32 sum-order differences)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01
    return int((diff > 0).sum())


V1_CHAINS = [(2_400_000, 32_000, 75 * 1024), (2_000_000, 32_000, 125 * 512)]


@pytest.mark.parametrize("rate,bw,chunk", V1_CHAINS, ids=["decim-75", "interp-2-125"])
def test_ddc_v1_three_chunks(rate, bw, chunk):
    """Banded v1 DDC over 3 chunks (2 bands x 2 slots) against the JAX
    package's ddc_chunk_banded (its XLA stage forms): int8 within 1 LSB,
    phases rtol 1e-6, tails atol 1e-6; then a port run resumed from the JAX
    state and tables of chunk 1 through ``convert``."""
    nb, k = 2, 2
    plans = jddc.plan_chain(rate, bw)
    assert not JaxDdcConfig.create(rate, bw, k, chunk).modtap and len(plans) == 1
    shifts = np.array([[250_000, -771_300], [2_500, 1_023_999]], dtype=np.int64) % (rate // 2)
    jtab = jax.tree.map(
        lambda *a: jnp.concatenate(a), *[jddc.make_nco_tables(s, rate, chunk) for s in shifts]
    )
    jstate = jddc.init_ddc_state(plans, nb * k)
    ttab = tdp.fold_banded(tddc.make_nco_tables(shifts, rate, chunk, CPU))
    tstate = tdp.init_state(tdp.DdcConfig.create(rate, bw, k, chunk), nb, device="cpu")
    tplans = tddc.plan_chain(rate, bw)
    rng = np.random.default_rng(rate // 1000)
    resumed = None
    for c in range(3):
        iq = rng.integers(-100, 100, size=(nb, chunk, 2), dtype=np.int8)
        if c == 1:
            js, jt = _np(jstate), _np(jtab)
            resumed = (
                convert.ddc_state(js.phase, js.tails, device="cpu"),
                convert.nco_tables(**jt._asdict(), device="cpu"),
            )
        jstate, jout = jddc.ddc_chunk_banded(jnp.asarray(iq), jstate, jtab, plans, nb, False)
        tstate, tout = tddc.ddc_chunk_banded(torch.from_numpy(iq), tstate, ttab, tplans)
        assert tout.shape == (nb, k, chunk * plans[0].interp // plans[0].decim, 2)
        _assert_int8_close(tout.numpy(), np.asarray(jout))
        if resumed is not None:
            rstate, rout = tddc.ddc_chunk_banded(torch.from_numpy(iq), resumed[0], resumed[1], tplans)
            resumed = (rstate, resumed[1])
            _assert_int8_close(rout.numpy(), np.asarray(jout))
    js = _np(jstate)
    for state in (tstate, resumed[0]):
        np.testing.assert_allclose(state.phase.numpy(), js.phase, rtol=1e-6)
        for t, j in zip(state.tails, js.tails):
            np.testing.assert_allclose(t.numpy(), j, atol=1e-6)


def test_reset_slot_v1_matches():
    """ops.reset_slot on the folded banded state and the models dispatch on
    a single-band state equal the JAX package's reset_slot."""
    plans = jddc.plan_chain(2_400_000, 32_000)
    rng = np.random.default_rng(10)
    state = jddc.DdcState(
        phase=jnp.asarray(rng.random(4).astype(np.float32)),
        tails=(jnp.asarray(rng.random((4, 2, plans[0].tail_len)).astype(np.float32)),),
    )
    s = _np(state)
    for slot in (0, 3):
        want = _np(jddc.reset_slot(state, slot))
        for reset in (tddc.reset_slot, tdp.reset_slot):
            got = reset(convert.ddc_state(s.phase, s.tails, device="cpu"), slot)
            np.testing.assert_array_equal(got.phase.numpy(), want.phase)
            np.testing.assert_array_equal(got.tails[0].numpy(), want.tails[0])


def test_ddc_modtap_with_an_interpolating_stage():
    """10 Msps -> 32 kHz: modulated-taps stage (1, 25), then the
    interpolating stage (2, 25) through _stage_apply; 2 chunks, <= 1 LSB."""
    rate, bw, chunk, nb = 10_000_000, 32_000, 625 * 64, 2
    jcfg = JaxDdcConfig.create(rate, bw, 2, chunk)
    assert jcfg.modtap and [(p.interp, p.decim) for p in jcfg.plans] == [(1, 25), (2, 25)]
    shifts = np.array([[250_000, -771_300], [2_500, 3_333_333]], dtype=np.int64)
    jtab = jax.tree.map(lambda *a: jnp.stack(a), *[jddc.make_mod_tables(jcfg.plans, s, rate, chunk) for s in shifts])
    jstate = jax.tree.map(lambda a: jnp.stack([a, a]), jddc.init_ddc2_state(jcfg.plans, 2))
    tplans = tddc.plan_chain(rate, bw)
    ttab = tddc.make_mod_tables(tplans, shifts, rate, chunk, CPU)
    tstate = tddc.init_ddc2_state(tplans, nb, 2, CPU)
    rng = np.random.default_rng(12)
    for _ in range(2):
        iq = rng.integers(-100, 100, size=(nb, chunk, 2), dtype=np.int8)
        jstate, jout = jddc.ddc_chunk_modtap(jnp.asarray(iq), jstate, jtab, jcfg.plans)
        tstate, tout = tddc.ddc_chunk_modtap(torch.from_numpy(iq), tstate, ttab, tplans)
        assert tout.shape == (nb, 2, chunk * 2 // 625, 2)
        _assert_int8_close(tout.numpy(), np.asarray(jout))
    for t, j in zip(tstate.tails, _np(jstate).tails):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6)


def test_golden_recording_vector():
    """The port's single-band v1 ddc_chunk on the golden vector's complex64
    input (tests/test_recording_fidelity.py's recipe) against the checked-in
    independent float64 golden: within 1 LSB. The JAX package is byte-exact
    there; the port's CPU route runs the FIR plain version (matmul, then the
    lag-diagonal sum) in another f32 sum order, so a few samples may move by
    one code. How many is printed."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from make_golden_recording import BANDWIDTH, RATE, SHIFT, make_input

    g = np.load(Path(__file__).parent / "golden" / "recording_2048k_16k_250k.npz")
    iq = make_input()
    plans = tddc.plan_chain(RATE, BANDWIDTH)
    mult = tddc.chain_block_multiple(plans)
    chunk = mult * max(1, 65536 // mult)
    state = tddc.init_ddc_state(plans, 1, CPU)
    tables = tddc.make_nco_tables(np.array([SHIFT]), RATE, chunk, CPU)
    outs = []
    for b in range(iq.size // chunk):
        state, out = tddc.ddc_chunk(torch.from_numpy(iq[b * chunk : (b + 1) * chunk]), state, tables, plans)
        outs.append(out.numpy())
    got = np.concatenate(outs, axis=1)[0]
    gold = g["out"]
    n = min(gold.shape[0], got.shape[0])
    assert n >= 15000
    diff = np.abs(gold[:n].astype(np.int32) - got[:n].astype(np.int32))
    print(f"golden: {(diff.max(axis=1) > 0).sum()} of {n} samples not byte-equal")
    assert diff.max() <= 1


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


@pytest.mark.parametrize("scale", [127.0, 100.0])
def test_complex_to_interleaved_int8(scale):
    """ops/quantize against the JAX function: seeded values, the saturation
    ends, and round-half-to-even at the .5 edges (I then Q)."""
    from rtl_sdr_scanner_tpu.ops import quantize as jq
    from rtl_sdr_scanner_tpu_torch.ops import quantize as tq

    rng = np.random.default_rng(12)
    x = (rng.standard_normal((3, 257)) + 1j * rng.standard_normal((3, 257))).astype(np.complex64) * 0.7
    edges = np.array([0.5, 1.5, -0.5, -2.5, 127.5, -128.5, 200.0, -300.0, 126.5, -127.5], dtype=np.float32) / scale
    x[0, : edges.size] = edges + 1j * edges[::-1]
    want = np.asarray(jq.complex_to_interleaved_int8(jnp.asarray(x), scale))
    got = tq.complex_to_interleaved_int8(torch.from_numpy(x), scale)
    assert got.dtype == torch.int8 and got.shape == (3, 257, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().min() == -128 and got.numpy().max() == 127
