"""Fused candidate selection: the port's plain version bit-exact against the
JAX package's Pallas kernel (interpret mode on the CPU) in f32 and bf16 over
the row families of tests/test_pallas_select.py, and against the JAX
package's XLA selection (the route its compact detection takes at every
fft) on rows of 64 and 128 bins. The CUDA kernel is held against the plain
version in tests/test_torch_on_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.ops.detect import _margin_separated_top as jax_margin_top
from rtl_sdr_scanner_tpu.ops.detect import _pooled_top_k as jax_top_k
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


def _small_rows(rng, fft):
    """Rows of a narrow band after the valid-bin mask: planted ties, masked
    (-3.0e38) tails the top-64 reaches into, fully masked and all-equal
    rows, a plateau, and values exactly at the level. No -0.0: XLA's top_k
    ranks it below 0.0, where the JAX package's Pallas kernel and the port
    take them as equal (the Pallas cases above hold that rule)."""
    rows = (np.round(rng.normal(0.0, 3.0, size=(8, fft))) + 0.0).astype(np.float32)  # many exact ties
    rows[1, fft // 3 :] = -3.0e38
    rows[2, :] = -3.0e38
    rows[3, ::2] = -3.0e38
    rows[4, :] = 5.0
    rows[5, fft // 2 - 3 : fft // 2 + 3] = 40.0
    rows[6, : fft // 4] = LEVEL
    rows[7, -2:] = 30.0  # the strongest bins at the row's end: zones clip there
    return rows


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fft,submargin", [(64, 16), (64, 200), (128, 32), (128, 0)])
def test_plain_matches_jax_xla_selection_on_small_rows(fft, submargin, dtype):
    """At fft 64 and 128 (16 and 32 kHz bands at 250 Hz bins) the JAX
    package selects through XLA (compact_detection's pooled top-k, margin
    greedy and count): the plain version is bit-exact against it, with
    zones narrower than the row and wider than it."""
    rows = _small_rows(np.random.default_rng(fft + submargin), fft)
    jrows, trows = jnp.asarray(rows), torch.from_numpy(rows)
    if dtype == "bf16":
        jrows, trows = jrows.astype(jnp.bfloat16), trows.to(torch.bfloat16)
    top_val, top_idx = jax_top_k(jrows, 64)
    sep_val, sep_idx = jax_margin_top(jrows, 16, submargin)
    count = jnp.sum(jrows >= jnp.asarray(LEVEL, jrows.dtype), axis=-1).astype(jnp.int32)
    got = tsel.fused_selection(trows, torch.tensor(LEVEL), 64, 16, submargin)
    for name, g, w in zip(("top_val", "top_idx", "sep_val", "sep_idx", "count"), got,
                          (top_val, top_idx, sep_val, sep_idx, count)):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        np.testing.assert_array_equal(_as_np(g), w, err_msg=name)


def _wide_rows(rng):
    """3 rows of 2^18 bins: planted ties 2048 bins apart (the warp-a-row
    form's leaf at 2^21, 8 of the row-split form's 256-bin leaves; equal
    maxima on both sides of every run boundary), exact ties, and a masked
    (-3.0e38) tail the top-64 reaches into."""
    fft = 1 << 18
    rows = rng.normal(0.0, 6.0, size=(3, fft)).astype(np.float32)
    edges = np.arange(2048, fft, 2048)
    rows[0, edges - 1] = 40.0
    rows[0, edges] = 40.0
    rows[1] = np.round(rows[1] / 4.0) + 0.0
    rows[1, edges[::7]] = 30.0
    rows[2, 40:] = -3.0e38
    return rows


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_on_rows_the_row_split_form_takes(dtype):
    """At 2^18 bins a row (a one-row block takes the kernel's row-split form:
    128 warps build its table) the plain version, which the card's kernel is
    held to, is bit-exact against the JAX package's Pallas kernel."""
    rows = _wide_rows(np.random.default_rng(18))
    jrows, trows = jnp.asarray(rows), torch.from_numpy(rows)
    if dtype == "bf16":
        jrows, trows = jrows.astype(jnp.bfloat16), trows.to(torch.bfloat16)
    assert tsel.row_slices(1, rows.shape[1]) > 0
    want = jax_selection(jrows, jnp.float32(LEVEL), 64, 16, 64, interpret=True)
    got = tsel.fused_selection(trows, torch.tensor(LEVEL), 64, 16, 64)
    for name, g, w in zip(("top_val", "top_idx", "sep_val", "sep_idx", "count"), got, want):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        np.testing.assert_array_equal(_as_np(g), w, err_msg=name)


@pytest.mark.parametrize("n_rows,fft,want", [
    (16, 1 << 21, 128),  # the 491.52 Msps block: 16 x 128 warps
    (1, 1 << 18, 128),  # one row: every run of 8 leaves a warp
    (45, 131072, 32), (180, 131072, 8), (360, 131072, 4),  # shards and the wideband step's rows
    (384, 131072, 4), (385, 131072, 0), (1024, 131072, 0), (1080, 131072, 0),  # path 1: a warp a row
    (1800, 16384, 0), (75, 16384, 0), (16, 65536, 0),  # below 2^17: a warp a row
    (16, 1 << 22, 128), (16, 1 << 23, 128), (16, 1 << 24, 128),  # 1.966 and 3.932 Gsps: wider leaves
    (1, 1 << 24, 2048), (16, 1 << 25, 0), (16, 3 << 17, 0),  # above 2^24 and not a power of two
])
def test_row_slices(n_rows, fft, want):
    """The row-split form's warps a row: the largest power of two up to 2048
    rows x warps, at most one a run of 8 leaves (of split_leaf_width: 256
    bins up to 2^22, wider above); 0 (a warp a row) outside 2^17-2^24 bins or
    above SPLIT_MAX_ROWS (384) rows."""
    slices = tsel.row_slices(n_rows, fft)
    assert slices == want
    if slices:
        n_leaf = fft // tsel.split_leaf_width(fft)
        assert n_leaf % tsel.GROUPS == 0 and (n_leaf // tsel.LEAVES_A_LOAD) % slices == 0
        assert n_rows * slices <= tsel.SPLIT_WARPS < 2 * n_rows * slices or slices == n_leaf // tsel.LEAVES_A_LOAD


@pytest.mark.parametrize("log_fft,want", [(17, 256), (21, 256), (22, 256), (23, 512), (24, 1024)])
def test_split_leaf_width(log_fft, want):
    """The row-split form's leaves: 256 bins up to 2^22, widened above so
    that a row's table (8 bytes a leaf), its 80 winners' log and zones and
    the 32 groups fit one block's 227 KB of shared memory, as whole 16-byte
    pieces a lane in both dtypes."""
    fft = 1 << log_fft
    width = tsel.split_leaf_width(fft)
    assert width == want
    n_leaf = fft // width
    assert n_leaf <= tsel.SPLIT_MAX_LEAVES and n_leaf % tsel.GROUPS == 0
    assert n_leaf * 8 + 64 * 12 + 16 * 4 + tsel.GROUPS * 8 <= 232448
    assert all(width % (32 * (16 // size)) == 0 for size in (2, 4))


def test_kernel_table_limits():
    """The kernel's two-level table: leaves of 32 bins (one a lane) widened
    while a row has more than 1024 of them, whole groups of 32 leaves above
    32 leaves and a group a leaf below (fft 256 and 512: 8 and 16 leaves);
    rows of at most 128 bins take the register form. The wrapper takes
    every power-of-two fft (any fft up to 128, a multiple of 256 above, and
    of 1024 above 32 leaves), any submargin (a zone may cover many leaves
    or the whole row) and up to 32 margin winners (the reference's K_SEP is
    16), and refuses the rest."""
    assert tsel.FFT_MULTIPLE == 256
    for fft in (1024, 2048, 3072, 8192, 16384, 32768, 65536, 131072, 262144, 1 << 20, 33 * 1024):
        w = tsel.leaf_width(fft)
        assert w % 32 == 0 and fft % w == 0 and (fft // w) % tsel.GROUPS == 0
        assert fft // w <= 1024 or (fft // w) % (2 * tsel.GROUPS) != 0
    assert tsel.leaf_width(16384) == 32 and tsel.leaf_width(131072) == 128
    assert tsel.leaf_width(256) == tsel.leaf_width(512) == 32
    assert all(tsel.takes_fft(1 << log) for log in range(0, 24))
    assert all(tsel.takes_fft(fft) for fft in (100, 127))
    assert not any(tsel.takes_fft(fft) for fft in (0, 129, 200, 1536, 1280))
    for fft in (128, 256, 512):
        tsel.check_args(torch.zeros((2, fft)), 64, 16, 64)
    tsel.check_args(torch.zeros((2, 16)), 16, 16, 300)  # top_k = fft, a zone wider than the row
    rows = torch.zeros((2, 2048))
    tsel.check_args(rows, 64, 16, 2048)  # a zone wider than the row is fine
    for bad in (torch.zeros((2, 1536)), torch.zeros((2, 200)), torch.zeros((2, 2048), dtype=torch.float16),
                torch.zeros(2048),
                torch.zeros((2048, 2)).t(), torch.zeros(2 * 2048 + 1)[1:].view(2, 2048)):
        with pytest.raises(ValueError):
            tsel.check_args(bad, 64, 16, 52)
    tsel.check_args(rows, 64, tsel.MAX_K_SEP, 52)
    for top_k, k_sep, submargin in ((0, 16, 52), (4096, 16, 52), (64, 0, 52), (64, 33, 52), (64, 16, -1)):
        with pytest.raises(ValueError):
            tsel.check_args(rows, top_k, k_sep, submargin)
