"""Decimating FIR stage: the port's plain version against the JAX package's
Pallas kernel (interpret mode, where the M % 128 gate is lifted) and the
route the port's v1 DDC takes for each plan. The CUDA kernel is held
against the plain version in tests/test_torch_on_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.ops import ddc as jddc
from rtl_sdr_scanner_tpu.ops.pallas.fir_kernel import stage_apply_pallas
from rtl_sdr_scanner_tpu_torch.ops import ddc as tddc
from rtl_sdr_scanner_tpu_torch.ops.cuda import fir_kernel as tfir

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "interp,decim,n",
    [(1, 32, 32 * 2048), (1, 40, 40 * 1024), (1, 8, 8 * 4096), (1, 75, 75 * 1024), (1, 125, 125 * 512)],
)
def test_plain_matches_pallas(interp, decim, n):
    """<= 2e-5 * max (f32 sum order, the JAX package's bar for its kernel
    against XLA), the new tail exact, over two calls carrying the tail."""
    plan = jddc.plan_stage(interp, decim)
    rng = np.random.default_rng(decim)
    tail = rng.standard_normal((2, 2, plan.tail_len)).astype(np.float32)
    jtail, ttail = jnp.asarray(tail), torch.from_numpy(tail)
    for _ in range(2):
        x = rng.standard_normal((2, 2, n)).astype(np.float32)
        jy, jtail = stage_apply_pallas(jnp.asarray(x), jtail, plan, interpret=True)
        ty, ttail = tfir.stage_apply_fir(torch.from_numpy(x), ttail, tddc.plan_stage(interp, decim))
        want = np.asarray(jy)
        assert ty.shape == want.shape == (2, 2, n // decim)
        assert np.abs(ty.numpy() - want).max() <= 2e-5 * np.abs(want).max()
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))


def test_plain_with_a_chunk_shorter_than_the_tail():
    """n < tail_len: the new tail takes the old tail's end, then x."""
    plan = tddc.plan_stage(1, 75)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 2, 75 * 8)).astype(np.float32)
    tail = rng.standard_normal((1, 2, plan.tail_len)).astype(np.float32)
    jy, jtail = jddc._stage_apply(jnp.asarray(x), jnp.asarray(tail), plan)
    ty, ttail = tfir.stage_apply_fir_plain(torch.from_numpy(x), torch.from_numpy(tail), plan)
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    want = np.asarray(jy)
    assert np.abs(ty.numpy() - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("interp,decim", [(1, 75), (5, 4), (16, 125)])
def test_v1_stage_route_matches_jax(interp, decim):
    """The route both DDC paths take for a plan (``_stage_apply``): the FIR
    wrapper for a decimation-only stage, the zero-stuffed conv for an
    interpolating one. Both equal JAX's _stage_apply (the XLA form of the
    same function)."""
    plan = tddc.plan_stage(interp, decim)
    rng = np.random.default_rng(interp * 1000 + decim)
    x = rng.standard_normal((3, 2, decim * 64)).astype(np.float32)
    tail = rng.standard_normal((3, 2, plan.tail_len)).astype(np.float32)
    ty, ttail = tddc._stage_apply(torch.from_numpy(x), torch.from_numpy(tail), plan)
    jy, jtail = jddc._stage_apply(jnp.asarray(x), jnp.asarray(tail), jddc.plan_stage(interp, decim))
    want = np.asarray(jy)
    assert ty.shape == want.shape
    assert np.abs(ty.numpy() - want).max() <= 2e-5 * np.abs(want).max()
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))


DECIMS = (8, 16, 25, 32, 40, 75, 120, 125)  # every decimation of a real chain (threshold 125)


def test_kernel_geometry():
    """The kernel's product shape for every decimation of a real chain:
    W [M, R] zero-padded to [Mp, RP], Mp = M rounded up to the k-step of 8,
    RP = 40 = 5 n-tiles of 8 taps (R = 34 at every M); the packed B
    fragments put W_hi[kk*8 + t][nt*8 + g] and W_hi[kk*8 + t + 4][nt*8 + g]
    (then W_lo's) at lane 4g + t."""
    for m in DECIMS:
        plan = tddc.plan_stage(1, m)
        hi, lo = tfir.split_weights(m)
        mp = -(-m // 8) * 8
        assert hi.shape == lo.shape == (mp, tfir.RP) and plan.poly_rows <= tfir.RP
        assert not hi[m:].any() and not hi[:, plan.poly_rows :].any() and not lo[m:].any()
        frag = tfir._weights(m, torch.device("cpu")).numpy()
        assert frag.shape == (mp // 8, tfir.RP // 8, 32, 4)
        for kk, nt, lane in ((0, 0, 0), (mp // 8 - 1, 4, 31), (mp // 8 // 2, 2, 13)):
            g, t = lane // 4, lane % 4
            k, n = kk * 8 + t, nt * 8 + g
            np.testing.assert_array_equal(frag[kk, nt, lane], [hi[k, n], hi[k + 4, n], lo[k, n], lo[k + 4, n]])


@pytest.mark.parametrize("m", DECIMS)
def test_weight_split_is_tf32(m):
    """W_hi and W_lo are TF32 values (the low 13 mantissa bits zero); W_hi +
    (W - W_hi) == W exactly in f32, and W_lo = tf32(W - W_hi) keeps all but
    at most the lowest 2 of W's 24 significant bits: |W - W_hi - W_lo| <=
    2^-22 |W| (two 11-bit TF32 halves cannot hold 24 bits exactly)."""
    plan = tddc.plan_stage(1, m)
    hi, lo = tfir.split_weights(m)
    w = np.zeros_like(hi)
    w[:m, : plan.poly_rows] = plan.poly_kernel[0]
    for half in (hi, lo):
        assert half.dtype == np.float32 and not (half.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi + (w - hi), w)
    np.testing.assert_array_equal(lo, tfir.tf32_round(w - hi))
    resid = np.abs(w.astype(np.float64) - hi - lo)
    assert (resid <= 2.0**-22 * np.abs(w)).all()
    assert (hi + lo == w).mean() > 0.7  # most taps split exactly


def test_tf32_round_is_round_to_nearest_ties_away():
    """tf32_round is ``cvt.rna.tf32.f32``: nearest, ties away from zero."""
    one_ulp = 2.0**-10  # TF32's spacing at 1.0
    x = np.array([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4], np.float32)
    want = np.array([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0], np.float32)
    np.testing.assert_array_equal(tfir.tf32_round(x), want)


def test_wrapper_counts_nothing_on_the_cpu():
    plan = tddc.plan_stage(1, 8)
    before = tfir.stage_apply_fir.launches
    tfir.stage_apply_fir(torch.zeros((1, 2, 64)), torch.zeros((1, 2, plan.tail_len)), plan)
    assert tfir.stage_apply_fir.launches == before
