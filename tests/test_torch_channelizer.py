"""The port's polyphase channelizer against the JAX package's, on the same
numpy inputs.

Tolerances are the JAX package's own (tests/test_channelizer.py): the two
bank forms within atol = rtol = 2e-5 of each other and of the JAX forms
(f32 sums in other orders), the carried tails within 1e-6, block streaming
within 2e-4 of the numpy offline model and the 2x bank's streaming within
1e-5 of one whole pass; the bf16-operand bank >= 45 dB SNR against f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.ops import channelizer as jch
from rtl_sdr_scanner_tpu_torch.ops import channelizer as tch

torch.set_num_threads(2)


def _x(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("b,oversample,bf16", [(2, 1, False), (4, 1, False), (8, 1, False), (16, 1, False),
                                               (8, 2, False), (16, 2, False), (8, 1, True)])
def test_plan_arrays_equal(b, oversample, bf16):
    want = jch.plan_channelizer(b, oversample=oversample, bf16=bf16)
    got = tch.plan_channelizer(b, oversample=oversample, bf16=bf16)
    assert (got.num_channels, got.taps_per_branch, got.tail_len, got.bf16) == (
        want.num_channels, want.taps_per_branch, want.tail_len, want.bf16)
    for name in ("branch_kernels", "mm_g_pad", "mm_idx"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    keys = ("interp", "decim", "ntaps", "tail_len", "poly_rows", "chunk_c", "chunk_d", "chunk_q")
    assert [getattr(got.mm_plan, k) for k in keys] == [getattr(want.mm_plan, k) for k in keys]


@pytest.mark.parametrize("form", ["matmul", "oracle"])
@pytest.mark.parametrize("b", [4, 8, 16])
def test_bank_forms_match_jax(b, form):
    """Three streamed blocks: the port's form against the JAX package's
    same form and the JAX oracle, channels and carried tails."""
    jplan, tplan = jch.plan_channelizer(b), tch.plan_channelizer(b)
    if form == "oracle":
        jplan, tplan = jplan._replace(mm_plan=None), tplan._replace(mm_plan=None)
    jref = jch.plan_channelizer(b)._replace(mm_plan=None)
    js, ts, rs = jch.init_channelizer_state(jplan), tch.init_channelizer_state(tplan, "cpu"), \
        jch.init_channelizer_state(jref)
    for blk in range(3):
        x = _x(b * 512, 40 + b + blk)
        js, jc = jch.channelize_block(jplan, js, jnp.asarray(x))
        rs, rc = jch.channelize_block(jref, rs, jnp.asarray(x))
        ts, tc = tch.channelize_block(tplan, ts, torch.from_numpy(x))
        assert tc.dtype == torch.complex64 and tc.shape == (b, 512)
        for want in (jc, rc):
            np.testing.assert_allclose(tc.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(ts.tail.numpy(), np.asarray(js.tail), atol=1e-6)
    if form == "matmul":
        _, mm = tch._channelize_block_mm(tplan, tch.init_channelizer_state(tplan, "cpu"), torch.from_numpy(x))
        _, direct = tch.channelize_block(tplan, tch.init_channelizer_state(tplan, "cpu"), torch.from_numpy(x))
        assert torch.equal(mm, direct)


def test_streaming_equals_offline():
    plan = tch.plan_channelizer(8)
    block, n_blocks = 4096, 4
    x = _x(block * n_blocks, 8)
    state, outs = tch.init_channelizer_state(plan, "cpu"), []
    for i in range(n_blocks):
        state, ch = tch.channelize_block(plan, state, torch.from_numpy(x[i * block : (i + 1) * block]))
        outs.append(ch.numpy())
    got = np.concatenate(outs, axis=1)
    ref = tch.offline_channelize(plan, x)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    np.testing.assert_allclose(ref, jch.offline_channelize(jch.plan_channelizer(8), x), atol=1e-12)


def test_2x_streaming_equals_one_pass_and_jax():
    """The 2x bank (odd phase on the stream delayed by B/2, (-1)^b sign):
    four streamed blocks equal one whole pass, and the JAX package's."""
    b = 8
    plan, jplan = tch.plan_channelizer(b, oversample=2), jch.plan_channelizer(b, oversample=2)
    x = _x(b * 512, 6)
    _, whole = tch.channelize_block_2x(plan, tch.init_channelizer2x_state(plan, "cpu"), torch.from_numpy(x))
    _, jwhole = jch.channelize_block_2x(jplan, jch.init_channelizer2x_state(jplan), jnp.asarray(x))
    np.testing.assert_allclose(whole.numpy(), np.asarray(jwhole), atol=2e-5, rtol=2e-5)
    state, parts, step = tch.init_channelizer2x_state(plan, "cpu"), [], len(x) // 4
    for i in range(4):
        state, part = tch.channelize_block_2x(plan, state, torch.from_numpy(x[i * step : (i + 1) * step]))
        parts.append(part.numpy())
    np.testing.assert_allclose(np.concatenate(parts, axis=1), whole.numpy(), atol=1e-5)
    np.testing.assert_array_equal(state.carry.numpy(), x[-b // 2 :].view(np.float32).reshape(-1, 2))


@pytest.mark.parametrize("oversample", [1, 2])
def test_pairs_from_int8_match_jax(oversample):
    """cs8 pairs dequantized at 1/127.5 on the device, two blocks, [B, n, 2]
    f32 out, against the JAX pairs forms."""
    b = 4
    plan, jplan = tch.plan_channelizer(b, oversample=oversample), jch.plan_channelizer(b, oversample=oversample)
    if oversample == 2:
        ts, js = tch.init_channelizer2x_state(plan, "cpu"), jch.init_channelizer2x_state(jplan)
        tfn, jfn = tch.channelize_block_2x_pairs, jch.channelize_block_2x_pairs
    else:
        ts, js = tch.init_channelizer_state(plan, "cpu"), jch.init_channelizer_state(jplan)
        tfn, jfn = tch.channelize_block_pairs, jch.channelize_block_pairs
    rng = np.random.default_rng(11)
    for _ in range(2):
        pairs = rng.integers(-100, 100, size=(b * 1024, 2), dtype=np.int8)
        ts, got = tfn(plan, ts, torch.from_numpy(pairs))
        js, want = jfn(jplan, js, jnp.asarray(pairs))
        assert got.dtype == torch.float32 and got.shape == (b, oversample * 1024, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    f32 = pairs.astype(np.float32) * np.float32(1.0 / 127.5)
    _, a = tch.channelize_block_pairs(tch.plan_channelizer(b), tch.init_channelizer_state(tch.plan_channelizer(b), "cpu"),
                                      torch.from_numpy(pairs))
    _, c = tch.channelize_block_pairs(tch.plan_channelizer(b), tch.init_channelizer_state(tch.plan_channelizer(b), "cpu"),
                                      torch.from_numpy(f32))
    assert torch.equal(a, c)


@pytest.mark.parametrize("b,rate", [(8, 2_048_000), (16, 2_048_000), (4, 1_024_000)])
def test_channel_center_offsets_equal(b, rate):
    got = tch.channel_center_offsets(tch.plan_channelizer(b), rate)
    want = jch.channel_center_offsets(jch.plan_channelizer(b), rate)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_channelizer_bf16_snr_bound():
    """channelizer_bf16: bf16 operands, f32 accumulation and output; >= 45 dB
    aggregate SNR against the f32 bank on a multitone scene, and within
    2e-5 of the JAX package's bf16 bank (the same rounded operands)."""
    b = 8
    plan32, planbf = tch.plan_channelizer(b), tch.plan_channelizer(b, bf16=True)
    rng = np.random.default_rng(8)
    n = 8 * 4096
    t = np.arange(n)
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f_rel, a in [(0.03, 0.3), (-0.11, 0.2), (0.27, 0.25)]:
        x = x + a * np.exp(2j * np.pi * f_rel * t)
    x = x.astype(np.complex64)
    _, c32 = tch.channelize_block(plan32, tch.init_channelizer_state(plan32, "cpu"), torch.from_numpy(x))
    _, cbf = tch.channelize_block(planbf, tch.init_channelizer_state(planbf, "cpu"), torch.from_numpy(x))
    assert cbf.dtype == torch.complex64
    resid = (c32 - cbf).numpy()
    den = float((np.abs(resid) ** 2).sum())
    assert den > 0
    snr = 10 * np.log10(float((np.abs(c32.numpy()) ** 2).sum()) / den)
    assert snr >= 45.0, f"bf16 bank SNR {snr:.1f} dB"
    jplan = jch.plan_channelizer(b, bf16=True)
    _, want = jch.channelize_block(jplan, jch.init_channelizer_state(jplan), jnp.asarray(x))
    np.testing.assert_allclose(cbf.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
