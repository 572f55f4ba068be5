"""Fused candidate selection: the port's plain version bit-exact against the
JAX package's Pallas kernel (interpret mode on the CPU) in f32 and bf16 over
the row families of tests/test_pallas_select.py. The CUDA kernel is held
against the plain version in tests/test_torch_on_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.ops.pallas.select_kernel import fused_selection as jax_selection
from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel as tsel

torch.set_num_threads(2)
FFT = 8192
LEVEL = 8.0


def _random(rng, fft):
    return rng.normal(0.0, 6.0, size=(4, fft)).astype(np.float32)


def _tied(rng, fft):
    return np.round(rng.normal(0.0, 3.0, size=(4, fft))).astype(np.float32)


def _clustered(rng, fft):
    rows = rng.normal(0.0, 1.0, size=(3, fft)).astype(np.float32)
    for c in (100, 1023, 1024, fft // 2, fft - 1):
        rows[:, max(0, c - 60) : c + 60] += 20.0 * rng.random((3,))[:, None]
    return rows


def _sentinel(rng, fft):
    rows = rng.normal(0.0, 5.0, size=(3, fft)).astype(np.float32)
    rows[0, :] = -3.0e38  # fully masked: the all-suppressed corner
    rows[1, fft // 4 :] = -3.0e38
    return rows


def _level(rng, fft):
    rows = rng.normal(LEVEL, 2.0, size=(2, fft)).astype(np.float32)
    rows[0, :100] = LEVEL  # exactly at the level counts
    return rows


FAMILIES = {"random": _random, "tied": _tied, "clustered": _clustered, "sentinel": _sentinel, "level": _level}


def _to_torch(rows, dtype):
    return torch.from_numpy(rows).to(dtype)


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_matches_pallas_bit_exact(family, dtype):
    rng = np.random.default_rng(sorted(FAMILIES).index(family))
    rows = FAMILIES[family](rng, FFT)
    jrows = jnp.asarray(rows)
    trows = torch.from_numpy(rows)
    if dtype == "bf16":
        jrows = jrows.astype(jnp.bfloat16)
        trows = trows.to(torch.bfloat16)
    want = jax_selection(jrows, jnp.float32(LEVEL), 64, 16, 52, interpret=True)
    got = tsel.fused_selection(trows, torch.tensor(LEVEL), 64, 16, 52)
    for name, g, w in zip(("top_val", "top_idx", "sep_val", "sep_idx", "count"), got, want):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        np.testing.assert_array_equal(_as_np(g), w, err_msg=name)
        if name.endswith("val"):
            assert g.dtype == trows.dtype


def test_small_k_and_margin():
    rows = np.random.default_rng(6).normal(0.0, 4.0, size=(2, 2048)).astype(np.float32)
    want = jax_selection(jnp.asarray(rows), jnp.float32(LEVEL), 8, 4, 17, interpret=True)
    got = tsel.fused_selection(torch.from_numpy(rows), torch.tensor(LEVEL), 8, 4, 17)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_table_limits():
    """The kernel's two-level table: leaves of 32 bins (one a lane) widened
    while a row has more than 1024 of them, always whole groups of 32
    leaves; the wrapper takes any fft that is a multiple of 1024, any
    submargin (a zone may cover many leaves) and up to 32 margin winners
    (the reference's K_SEP is 16), and refuses the rest."""
    assert tsel.FFT_MULTIPLE == 1024
    for fft in (1024, 2048, 3072, 8192, 16384, 32768, 65536, 131072, 262144, 1 << 20, 33 * 1024):
        w = tsel.leaf_width(fft)
        assert w % 32 == 0 and fft % w == 0 and (fft // w) % tsel.GROUPS == 0
        assert fft // w <= 1024 or (fft // w) % (2 * tsel.GROUPS) != 0
    assert tsel.leaf_width(16384) == 32 and tsel.leaf_width(131072) == 128
    rows = torch.zeros((2, 2048))
    tsel.check_args(rows, 64, 16, 2048)  # a zone wider than the row is fine
    for bad in (torch.zeros((2, 1536)), torch.zeros((2, 2048), dtype=torch.float16), torch.zeros(2048),
                torch.zeros((2048, 2)).t(), torch.zeros(2 * 2048 + 1)[1:].view(2, 2048)):
        with pytest.raises(ValueError):
            tsel.check_args(bad, 64, 16, 52)
    tsel.check_args(rows, 64, tsel.MAX_K_SEP, 52)
    for top_k, k_sep, submargin in ((0, 16, 52), (4096, 16, 52), (64, 0, 52), (64, 33, 52), (64, 16, -1)):
        with pytest.raises(ValueError):
            tsel.check_args(rows, top_k, k_sep, submargin)
