"""The gather form of the history vote (``ops/detect._vote_windows_gather``,
``VOTE_FORM = "gather"``) against the JAX package's and against the port's
table forms.

On f32 history the port's gather equals the JAX package's bit for bit in
validity, and in the voted index wherever a vote is valid, under either of
the JAX package's gather lowerings ("slice", "index"), at a 103-bin window
(the int8-code table's width) and a 193-bin one (the pair tables'), with
ties and edge windows. On bf16 history the
port compares the window maximum with the level in f32, as the code forms
do, where the JAX package's gather casts the level down to bf16: a maximum
in [round_bf16(level), level) votes there and not in the code forms. The
port holds to the code forms; the last assertion records the reference's
fault. ``compact_detection`` with the gather form equals the code form's
outputs and the JAX package's, in f32 and in bf16 detection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.ops import detect as jdetect
from rtl_sdr_scanner_tpu_torch.ops import detect as tdetect

torch.set_num_threads(2)
F_, HALF_DEPTH, FFT, K = 6, 11, 2048, 12
R = HALF_DEPTH - 1 + F_
NB = 2
LEVEL = 6.0


def _scene(half: int, seed: int):
    """Integer-valued history (many exact ties) with sparse peaks of 6-9, so
    that about a third of the windows clear a level of 6, and candidates
    that include the first and last bins (the shrunken edge windows)."""
    rng = np.random.default_rng(seed)
    hist = (rng.integers(0, 9, size=(NB, R, FFT)) - 3.0).astype(np.float32)
    peaks = rng.random((NB, R, FFT)) < 0.004
    hist[peaks] = rng.integers(6, 10, size=int(peaks.sum()))
    cand = rng.integers(0, FFT, size=(NB, F_, K)).astype(np.int32)
    cand[:, :, 0] = 0
    cand[:, :, 1] = FFT - 1
    cand[:, :, 2] = half  # the first window that does not shrink
    return hist, cand


def _port_gather(hist, cand, half, level):
    idx, valid = tdetect._vote_windows_gather(
        torch.from_numpy(hist) if isinstance(hist, np.ndarray) else hist,
        torch.from_numpy(cand), half, torch.tensor(level, dtype=torch.float32), HALF_DEPTH,
    )
    return idx.numpy(), valid.numpy()


def _jax_gather(hist, cand, half, level, lowering, monkeypatch, dtype=jnp.float32):
    monkeypatch.setattr(jdetect, "VOTE_GATHER_LOWERING", lowering)
    out = [
        jdetect._vote_windows_gather(jnp.asarray(hist[b], dtype), jnp.asarray(cand[b]), half, np.float32(level), HALF_DEPTH)
        for b in range(NB)
    ]
    return np.stack([np.asarray(i) for i, _ in out]), np.stack([np.asarray(v) for _, v in out])


def _port_tables(hist: torch.Tensor, cand, half, level):
    """The port's table form at this width: (idx, valid) [NB, F, H, K]."""
    cand_t = torch.from_numpy(cand)
    lv = torch.tensor(level, dtype=torch.float32)
    if 2 * half + 1 <= 128:
        codes = tdetect._vote_windows_code(tdetect.sliding_argmax_code(hist, half, lv), cand_t, HALF_DEPTH)
        return ((cand_t[:, :, None, :] - half) + codes.to(torch.int32)).numpy(), (codes >= 0).numpy()
    hv, hi = tdetect.sliding_argmax(hist, half)
    vv, vi = tdetect._vote_windows(hv, hi, cand_t, HALF_DEPTH)
    return vi.numpy(), (vv >= lv).numpy()


def _assert_votes_equal(a, b):
    (idx_a, valid_a), (idx_b, valid_b) = a, b
    np.testing.assert_array_equal(valid_a, valid_b)
    np.testing.assert_array_equal(idx_a[valid_a], idx_b[valid_b])


@pytest.mark.parametrize("half", [51, 96])
@pytest.mark.parametrize("lowering", ["slice", "index"])
def test_gather_matches_jax_on_f32_history(half, lowering, monkeypatch):
    hist, cand = _scene(half, seed=half)
    got = _port_gather(hist, cand, half, LEVEL)
    assert 0.1 < got[1].mean() < 0.9
    _assert_votes_equal(got, _jax_gather(hist, cand, half, LEVEL, lowering, monkeypatch))
    _assert_votes_equal(got, _port_tables(torch.from_numpy(hist), cand, half, LEVEL))


@pytest.mark.parametrize("lowering", ["slice", "index"])
def test_bf16_history_compares_in_f32(lowering, monkeypatch):
    """Window maxima of 8.0 under a level of 8.01: round_bf16(8.01) = 8.0
    <= 8.0 < 8.01. The port's gather leaves those votes invalid, as its
    code form and the JAX package's code form do; the JAX package's gather
    counts them (the level cast down to bf16)."""
    half, level = 51, 8.01
    assert float(torch.tensor(level).bfloat16()) == 8.0
    hist, cand = _scene(half, seed=3)
    hist[:, :, 600:800] = np.minimum(hist[:, :, 600:800], 5.0)  # no peak but these:
    hist[:, :, 700:720] = 8.0  # exact in bf16
    hist[:, 4:, 1500:1510] = 9.0  # a block above the level either way
    cand[:, :, 3] = 710
    cand[:, :, 4] = 1505
    h16 = torch.from_numpy(hist).bfloat16()
    got = _port_gather(h16, cand, half, level)
    _assert_votes_equal(got, _port_tables(h16, cand, half, level))
    jcode = []
    for b in range(NB):
        tbl = jdetect.sliding_argmax_code(jnp.asarray(hist[b], jnp.bfloat16), half, np.float32(level))
        codes = np.asarray(jdetect._vote_windows_code(tbl, jnp.asarray(cand[b]), HALF_DEPTH))
        jcode.append(((cand[b][:, None, :] - half) + codes.astype(np.int32), codes >= 0))
    _assert_votes_equal(got, (np.stack([i for i, _ in jcode]), np.stack([v for _, v in jcode])))
    assert got[1].any(), "no vote clears the level"
    assert not got[1][:, :, :, 3].any(), "a maximum of 8.0 voted under a level of 8.01"
    # the reference's gather form counts them: its fault, which the port does not copy
    _, jvalid = _jax_gather(hist, cand, half, level, lowering, monkeypatch, dtype=jnp.bfloat16)
    assert jvalid[:, :, :, 3].all()
    assert (jvalid & ~got[1]).any()


GROUPS = [103, 193, 205]  # 193, 205: windows over 128 bins, the pair tables' width (205: the wideband receiver's)


def _detection_inputs(seed: int):
    """Noise-subtracted rows around 0 dB with two signals near the level:
    [NB, F, fft] avg and raw, [NB, H-1, fft] previous rows."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(0.0, 3.0, size=(NB, R, FFT)).astype(np.float32)
    raw[0, :, 400:440] += 8.5
    raw[1, 5:, 1200:1260] += 7.9
    avg = raw[:, HALF_DEPTH - 1 :] + rng.normal(0.0, 0.5, size=(NB, F_, FFT)).astype(np.float32)
    keys = np.full((NB, 4), -1, dtype=np.int32)
    keys[0, 0] = 420
    valid = np.ones((NB, FFT), dtype=bool)
    valid[:, :30] = False
    return avg, raw[:, HALF_DEPTH - 1 :], raw[:, : HALF_DEPTH - 1], keys, valid


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("bf16", [False, True])
def test_compact_detection_gather_form(group, bf16, monkeypatch):
    avg, raw, prev, keys, valid = _detection_inputs(group + bf16)
    args = [torch.from_numpy(a) for a in (avg, raw, prev, keys, valid)]

    def port(form):
        monkeypatch.setattr(tdetect, "VOTE_FORM", form)
        return tdetect.compact_detection(*args, torch.tensor(8.0), group, 16, bf16=bf16)

    gather, code = port("gather"), port("code")
    for name, a, b in zip(gather._fields, gather, code):
        assert torch.equal(a, b), name
    # the JAX package's code form (its default): bit-equal candidates, votes
    # and counts; values as f32 rows give them
    jfn = jax.jit(jdetect.compact_detection, static_argnums=(6, 7, 8))
    want = [
        jfn(jnp.asarray(avg[b]), jnp.asarray(raw[b]), jnp.asarray(prev[b]), jnp.asarray(keys[b]),
            jnp.asarray(valid[b]), 8.0, group, 16, bf16)
        for b in range(NB)
    ]
    for i, name in enumerate(gather._fields):
        ref = np.stack([np.asarray(w[i]) for w in want])
        np.testing.assert_array_equal(gather[i].numpy(), ref, err_msg=name)
    assert (gather.cand_best != gather.cand_idx).any(), "no vote moved a candidate"
    if not bf16:  # on f32 history the JAX package's gather form agrees too
        monkeypatch.setattr(jdetect, "VOTE_FORM", "gather")
        jfn = jax.jit(jdetect.compact_detection, static_argnums=(6, 7, 8))
        for b in range(NB):
            jg = jfn(jnp.asarray(avg[b]), jnp.asarray(raw[b]), jnp.asarray(prev[b]), jnp.asarray(keys[b]),
                     jnp.asarray(valid[b]), 8.0, group, 16, False)
            np.testing.assert_array_equal(gather.cand_best[b].numpy(), np.asarray(jg.cand_best))
