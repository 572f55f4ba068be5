"""Stage 1 of the modulated-taps DDC: its wrapper
(``ops/cuda/ddc_kernel.modtap_stage1``), the hand-written kernel behind it
(``csrc/ddc_kernel.cu``) and its place in ``ops/ddc.ddc_chunk_modtap``.

On the CPU: the kernel's B tables (the lag form's B, the folded form's
B_fold) hold ``make_mod_tables``'s modulated taps (the ones its matrix ``w``
holds) in the complex product's layout, split into TF32 halves; numpy
models of the lag form's runs, tiles, staged windows, carried Z rows, lag
sums and rotation, and of the folded form's runs, Hankel windows and
partial sums, agree with the matmul form within 2e-6 of max|y| at the step
cells' geometry (M 20, K 2, int8 and f32 pairs), the dongle session's (M 64,
K 4) and the direct-sampling band's (M 8, K 16 and K 4), over two chunks
with the tail carried; the form rule on each cell's stage-1 geometry; the
wrappers on CPU tensors are the matmul form and count nothing; the argument
check and the launch arguments are built without a card. On the card
(marker ``cuda``; skips elsewhere): the kernel against its plain version
and against a float64 stage 1 at each geometry, in the form each takes,
recordings within 1 LSB of the CPU, and one launch a chunk (no GEMM). This
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ddc_kernel.py
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu_torch import drivers
from rtl_sdr_scanner_tpu_torch.ops import ddc
from rtl_sdr_scanner_tpu_torch.ops.cuda import build, ddc_kernel as dk
from rtl_sdr_scanner_tpu_torch.ops.cuda.fir_kernel import tf32_round

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(dk.__file__).resolve().parents[2] / "csrc" / "ddc_kernel.cu"
TOL = 2e-6  # of max|y|: the split-TF32 product against the f32 matmul form (f32-class, sums in other orders)
RATE = 20_480_000
# (decimation, slots, bands, stream dtype, chunk outputs): the step cells'
# stage 1 on int8 (hf20m48) and on the bank's f32 channels (wb163m84), the
# dongle session's one-stage chain (rtl2m048), and 256 kHz channels recorded
# at 3.2 kHz (the band-shard scenes: the kernel's 64-row form), and the
# shapes that take the folded form: the direct-sampling band's (ds491m52: M
# 8, 16 slots), M 8 at 4 slots on f32 pairs (one n-tile), a 32 kHz band's 4
# slots at 16 kHz (M 2, R 33: the 32 kHz sessions) and 8 slots of f32 pairs
# at M 16 (the f32 fold's 256-row tiles), and 4 slots of the bank's f32
# channels at M 20, which keep the lag form (one n-tile of 5 k-steps);
# outputs a chunk cover a few tiles and a ragged last one
GEOMETRIES = {
    "m20k2_int8": (20, 2, 3, "int8", 1000),
    "m20k2_f32": (20, 2, 3, "float32", 1000),
    "m64k4_int8": (64, 4, 1, "int8", 600),
    "m80k2_f32": (80, 2, 2, "float32", 300),
    "m8k16_int8": (8, 16, 1, "int8", 1000),
    "m8k4_f32": (8, 4, 2, "float32", 1000),
    "m2k4_int8": (2, 4, 1, "int8", 1000),
    "m16k8_f32": (16, 8, 1, "float32", 1000),
    "m20k4_f32": (20, 4, 2, "float32", 1000),
}
# the folded form's cases on the CPU: M 8 at K 16 and K 4, int8 and f32, and
# the other folded geometries
FOLDED = {
    "m8k16_int8": GEOMETRIES["m8k16_int8"],
    "m8k16_f32": (8, 16, 1, "float32", 1000),
    "m8k4_int8": (8, 4, 2, "int8", 1000),
    "m8k4_f32": GEOMETRIES["m8k4_f32"],
    "m2k4_int8": GEOMETRIES["m2k4_int8"],
    "m16k8_f32": GEOMETRIES["m16k8_f32"],
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _shifts(k: int, nb: int) -> np.ndarray:
    """Per-slot shifts [NB, K] inside +-RATE/2 (not a divisor's multiple)."""
    rng = np.random.default_rng(k * 100 + nb)
    return rng.integers(-RATE // 2 + 1, RATE // 2, size=(nb, k)).astype(np.int64) // 7 * 7 + 3


def _stream(nb: int, n: int, dtype: str, seed: int) -> torch.Tensor:
    """[NB, n, 2] int8 cs8 or f32 pairs in the dequantized units."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return torch.from_numpy(rng.integers(-128, 128, size=(nb, n, 2), dtype=np.int8))
    return torch.from_numpy(rng.uniform(-0.9, 0.9, size=(nb, n, 2)).astype(np.float32))


def _setup(name: str, device="cpu"):
    """(plan, tables, phase, stream chunks) of a geometry."""
    m, k, nb, dtype, out1 = {**GEOMETRIES, **FOLDED}[name]
    plan = ddc.plan_stage(1, m)
    tables = ddc.make_mod_tables([plan], _shifts(k, nb), RATE, out1 * m, torch.device(device))
    phase = torch.from_numpy(np.random.default_rng(m).uniform(0, 2 * np.pi, size=(nb, k)).astype(np.float32))
    chunks = [_stream(nb, out1 * m, dtype, seed=m + i) for i in range(2)]
    return plan, tables, phase.to(device), [c.to(device) for c in chunks]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.cpu().double(), want.cpu().double()
    return float((got - want).abs().max() / want.abs().max())


# -- numpy models of the kernel's two forms -------------------------------------


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def kernel_model(xs: np.ndarray, tail: np.ndarray, phase: np.ndarray, tables, plan, grid: int, mt: int = 4):
    """The lag form's loops in numpy, a thread block at a time: xs [NB, n, 2]
    int8 / f32, tail [NB, 2, t0] f32 -> (y [NB*K, 2, n / M], new tail).
    Z's rows start as NaN, so an output that read a row no tile wrote (or
    carried) would show. Products in float64, cast to f32 (the tensor cores'
    sum order is their own); lag sums, scale and rotation in f32, each
    operation rounded alone."""
    int8 = xs.dtype == np.int8
    nb, n = xs.shape[0], xs.shape[1]
    k = phase.shape[1]
    m, r, t0 = plan.decim, plan.poly_rows, plan.tail_len
    out = n // m
    groups, ks = dk.groups(k), dk.k_steps(m)
    b_full = dk.mod_b(ddc.modtap_taps(tables.w.numpy(), plan), m, r)  # [NB, G, Kp, 160]
    b_hi = tf32_round(b_full)
    b_lo = tf32_round(b_full - b_hi)
    tr = dk.tile_rows(mt)
    nt_live = -(-4 * r // 8)
    zc = dk.CARRIED_ROWS
    tpr = -(-(out + r - 1) // tr)
    total = nb * groups * tpr
    y = np.full((nb * k, 2, out), np.nan, np.float32)
    for blk in range(grid):
        start, end = total * blk // grid, total * (blk + 1) // grid
        item = start - 1 if 0 < start < end and start % tpr else start
        z = np.full((zc + tr, 8 * nt_live), np.nan, np.float32)
        while item < end:
            row, t = divmod(item, tpr)
            band, grp = divmod(row, groups)
            z[zc - r + 1 : zc] = z[zc + tr - r + 1 : zc + tr]  # the carried rows
            s0 = t * tr * m
            win = _staged_window(xs, tail, band, s0, tr, plan)  # [tr, 8 ks]
            three = not int8 or s0 < t0
            hi = tf32_round(win) if three else win
            prod = hi.astype(np.float64) @ (b_hi[band, grp].astype(np.float64) + b_lo[band, grp])
            if three:
                prod += tf32_round(win - hi).astype(np.float64) @ b_hi[band, grp]
            z[zc:] = _f32(prod[:, : 8 * nt_live])
            item += 1
            if item - 1 < start:
                continue  # the run's lead-in tile
            v = np.arange(tr)
            p = t * tr - r + 1 + v
            ok = (p >= 0) & (p < out)
            for sl in range(dk.GROUP_SLOTS):
                slot = grp * dk.GROUP_SLOTS + sl
                if slot >= k:
                    continue
                rows = zc - r + 1 + v[ok]
                re, im = z[rows, 2 * sl * r], z[rows, 2 * sl * r + r]
                for q in range(1, r):
                    re = _f32(re + z[rows + q, 2 * sl * r + q])
                    im = _f32(im + z[rows + q, 2 * sl * r + r + q])
                if int8:
                    re, im = _f32(re * np.float32(dk.CS8_SCALE)), _f32(im * np.float32(dk.CS8_SCALE))
                _rotate_into(y, tables.rot, phase, band, slot, p[ok], re, im)
    return y, _new_tail(xs, tail, t0)


def _rotate_into(y: np.ndarray, rot, phase: np.ndarray, band: int, slot: int, pp: np.ndarray, re, im) -> None:
    """y[band K + slot, :, pp] = (re, im) x e^{i(phase + angle(p))} as the
    kernel forms it: (cos, sin)(phase) x coarse[p / Q], then x fine[p % Q],
    then the output, each f32 operation rounded alone."""
    k = phase.shape[1]
    q_len = rot.fine_re.shape[-1]
    co_re = rot.coarse_re[band, slot].numpy()[pp // q_len]
    co_im = rot.coarse_im[band, slot].numpy()[pp // q_len]
    f_re, f_im = rot.fine_re[band, slot].numpy()[pp % q_len], rot.fine_im[band, slot].numpy()[pp % q_len]
    a, b = np.float32(np.cos(phase[band, slot])), np.float32(np.sin(phase[band, slot]))
    c_re, c_im = _f32(_f32(a * co_re) - _f32(b * co_im)), _f32(_f32(a * co_im) + _f32(b * co_re))
    r_re = _f32(_f32(c_re * f_re) - _f32(c_im * f_im))
    r_im = _f32(_f32(c_re * f_im) + _f32(c_im * f_re))
    y[band * k + slot, 0, pp] = _f32(_f32(re * r_re) - _f32(im * r_im))
    y[band * k + slot, 1, pp] = _f32(_f32(re * r_im) + _f32(im * r_re))


def _new_tail(xs: np.ndarray, tail: np.ndarray, t0: int) -> np.ndarray:
    """full[n : n + t0] of full = tail ++ x (the plain version's units)."""
    n = xs.shape[1]
    scale = np.float32(dk.CS8_SCALE if xs.dtype == np.int8 else 1)
    full = np.concatenate([tail, np.moveaxis(xs, -1, -2).astype(np.float32) * scale], axis=-1)
    return full[..., n : n + t0]


def _staged_window(xs: np.ndarray, tail: np.ndarray, band: int, s0: int, rows: int, plan) -> np.ndarray:
    """The kernel's f32 window tile [rows, 8 k_steps(M)]: row r, column c <
    2M is full sample s0 + r M + c / 2, component c % 2 (the tail x 127.5
    on the int8 route, x, zeros past x); the columns past 2M zero."""
    m, t0, n = plan.decim, plan.tail_len, xs.shape[1]
    win = np.zeros((rows, 8 * dk.k_steps(m)), np.float32)
    s = s0 + np.arange(rows)[:, None] * m + np.arange(2 * m)[None, :] // 2
    c = np.broadcast_to(np.arange(2 * m)[None, :] % 2, s.shape)
    in_tail, in_x = s < t0, (s >= t0) & (s - t0 < n)
    win[:, : 2 * m][in_tail] = tail[band, c[in_tail], s[in_tail]] * np.float32(127.5 if xs.dtype == np.int8 else 1.0)
    win[:, : 2 * m][in_x] = xs[band, s[in_x] - t0, c[in_x]].astype(np.float32)
    return win


def fold_model(xs: np.ndarray, tail: np.ndarray, phase: np.ndarray, tables, plan, grid: int, mt: int = 4):
    """The folded kernel's loops in numpy, a thread block at a time: xs [NB,
    n, 2] int8 / f32, tail [NB, 2, t0] f32 -> (y [NB*K, 2, n / M], new tail).
    A block's run is outputs [total b / grid, total (b + 1) / grid) of the
    bands laid end to end, in tiles of up to TR within a band, each staging
    its TR + R - 1 window rows; A is the Hankel view of the tile (row p + q
    at lag q); y starts as NaN, so an output no tile wrote would show. Each
    lag's product in float64, cast to f32 (the tensor cores' sum order is
    their own), the lags added in f32 in ascending q; scale and rotation in
    f32, each operation rounded alone."""
    int8 = xs.dtype == np.int8
    nb, n = xs.shape[0], xs.shape[1]
    k = phase.shape[1]
    m, r, t0 = plan.decim, plan.poly_rows, plan.tail_len
    out, ks = n // m, dk.k_steps(m)
    kp = 8 * ks
    b = dk.mod_b_fold(ddc.modtap_taps(tables.w.numpy(), plan), m, r)  # [NB, R kp, 8 NT]
    b_hi = tf32_round(b)
    b_lo = tf32_round(b - b_hi)
    tr = dk.fold_tile_rows(mt)
    total = nb * out
    y = np.full((nb * k, 2, out), np.nan, np.float32)
    for blk in range(grid):
        at, end = total * blk // grid, total * (blk + 1) // grid
        while at < end:
            band, p0 = divmod(at, out)
            rows = min(tr, out - p0, end - at)
            win = _staged_window(xs, tail, band, p0 * m, tr + r - 1, plan)
            three = not int8 or p0 * m < t0
            hi = tf32_round(win) if three else win
            hankel = np.arange(rows)[:, None] + np.arange(r)[None, :]  # [rows, R]: window row p + q
            a_hi = hi[hankel].reshape(rows, r * kp).astype(np.float64)
            a_lo = tf32_round(win - hi)[hankel].reshape(rows, r * kp).astype(np.float64) if three else None
            acc = np.zeros((rows, b.shape[-1]), np.float32)
            for q in range(r):
                cols = slice(q * kp, (q + 1) * kp)
                part = a_hi[:, cols] @ (b_hi[band, cols].astype(np.float64) + b_lo[band, cols])
                if three:
                    part += a_lo[:, cols] @ b_hi[band, cols]
                acc = _f32(acc + _f32(part))
            for slot in range(k):
                re, im = acc[:, 2 * slot], acc[:, 2 * slot + 1]
                if int8:
                    re, im = _f32(re * np.float32(dk.CS8_SCALE)), _f32(im * np.float32(dk.CS8_SCALE))
                _rotate_into(y, tables.rot, phase, band, slot, p0 + np.arange(rows), re, im)
            at += rows
    return y, _new_tail(xs, tail, t0)


# -- the CPU --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_b_table_holds_the_modulated_taps_split_in_tf32(name):
    """``modtap_taps`` reads ``make_mod_tables``'s f32 taps back out of
    every place ``w`` holds them; B holds them in the complex product's
    layout (y_re: G_re over -G_im, y_im: G_im over G_re, R lags a column);
    the fragments are B's TF32 halves (B_hi + B_lo within 2^-21 of B) in
    ``mma.m16n8k8``'s B order, and ``make_mod_tables``'s table where the
    shape takes the lag form (the folded form's B_fold: its own test)."""
    plan, tables, _, _ = _setup(name)
    m, r, k, nb = plan.decim, plan.poly_rows, GEOMETRIES[name][1], GEOMETRIES[name][2]
    g = ddc.modtap_taps(tables.w.numpy(), plan)
    assert g.shape == (nb, k, 2, r * m) and g.dtype == np.float32
    # every entry of w is a tap of g or zero: scatter g back and compare
    idx = ddc._modtap_scatter_index(m, r, plan.tail_len, plan.chunk_c, plan.chunk_d, plan.chunk_q)
    g_pad = np.concatenate([g, np.zeros(g.shape[:-1] + (1,), np.float32)], axis=-1)
    w = np.moveaxis(g_pad[..., idx], -2, -4).reshape(tables.w.shape)
    np.testing.assert_array_equal(w, tables.w.numpy())
    assert np.count_nonzero(g[..., : plan.ntaps]) > 0.99 * g[..., : plan.ntaps].size
    b = dk.mod_b(g, m, r)
    assert b.shape == (nb, dk.groups(k), 8 * dk.k_steps(m), 8 * dk.GROUP_NTILES)
    for slot in range(k):
        grp, s = divmod(slot, dk.GROUP_SLOTS)
        for o, (re_rows, im_rows) in enumerate(((g[:, slot, 0], -g[:, slot, 1]), (g[:, slot, 1], g[:, slot, 0]))):
            col = (2 * s + o) * r
            block = b[:, grp, : 2 * m, col : col + r]  # [NB, 2M, R]
            np.testing.assert_array_equal(block[:, 0::2], re_rows.reshape(nb, r, m).swapaxes(-1, -2))
            np.testing.assert_array_equal(block[:, 1::2], im_rows.reshape(nb, r, m).swapaxes(-1, -2))
    assert not b[..., 2 * m :, :].any() and not b[..., 4 * r :].any()
    frag = dk.pack_fragments(b)
    assert frag.shape == (nb, dk.groups(k), dk.k_steps(m), dk.GROUP_NTILES, 32, 4)
    if not dk.folds(m, r, k):
        np.testing.assert_array_equal(tables.frag.numpy(), frag)
    hi, lo = tf32_round(b), tf32_round(b - tf32_round(b))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.abs(hi.astype(np.float64) + lo - b).max() <= 2.0**-21 * np.abs(b).max()
    lane, kk, nt = 13, dk.k_steps(m) - 1, 3
    t, gq = lane % 4, lane // 4
    for e, (half, row) in enumerate(((hi, t), (hi, t + 4), (lo, t), (lo, t + 4))):
        np.testing.assert_array_equal(frag[..., kk, nt, lane, e], half[..., kk * 8 + row, nt * 8 + gq])


@pytest.mark.parametrize("grid", [1, 7])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_kernel_model_matches_the_matmul_form(name, grid):
    """The lag form's runs (one block, or runs starting inside rows), tiles,
    staged windows, carried Z rows, lag sums and rotation over two chunks
    with the raw tail carried: y within 2e-6 of max|y| of the matmul form,
    the new tail equal (at the folded geometries too, where the launcher
    picks the other form)."""
    plan, tables, phase, chunks = _setup(name)
    mt, _ = dk.kernel_form(plan.decim, plan.poly_rows, chunks[0].dtype == torch.int8)
    tail = torch.zeros((phase.shape[0], 2, plan.tail_len))
    for x in chunks:
        got, got_tail = kernel_model(x.numpy(), tail.numpy(), phase.numpy(), tables, plan, grid, mt)
        want, tail = dk.modtap_stage1_plain(x, tail, phase, tables, plan)
        assert not np.isnan(got).any()
        assert _rel(torch.from_numpy(got), want) <= TOL
        np.testing.assert_array_equal(got_tail, tail.numpy())
        assert tail.abs().max() > 0


def test_wrapper_on_cpu_is_the_matmul_form():
    """On CPU tensors the wrapper runs its plain version (no launch counted),
    and ``ddc_chunk_modtap``'s stage 1 is it: the widened components through
    ``_modtap_stage1`` and ``_rotation``, bit for bit."""
    plan, tables, phase, chunks = _setup("m20k2_int8")
    tail = torch.zeros((phase.shape[0], 2, plan.tail_len))
    before = dk.modtap_stage1.launches
    y, new_tail = dk.modtap_stage1(chunks[0], tail, phase, tables, plan)
    assert dk.modtap_stage1.launches == before
    x = torch.stack(ddc._components(chunks[0]), dim=1)
    y_re, y_im, want_tail = ddc._modtap_stage1(x, tail, tables.w, plan, 2)
    rot_re, rot_im = ddc._rotation(phase, tables.rot, y.shape[-1])
    assert torch.equal(y[:, 0].reshape(y_re.shape), y_re * rot_re - y_im * rot_im)
    assert torch.equal(y[:, 1].reshape(y_re.shape), y_re * rot_im + y_im * rot_re)
    assert torch.equal(new_tail, want_tail)
    # complex samples are their f32 pairs
    xc = torch.complex(*ddc._components(chunks[0]))
    yc, _ = dk.modtap_stage1(xc, tail, phase, tables, plan)
    assert torch.equal(yc, y)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_kernel_form_fits_and_the_geometry_is_taken(name):
    """Each geometry takes a form whose shared memory fits (the step cells'
    with B in shared memory, the session's B from device memory, the 3.2
    kHz recordings' 64-row tiles, M 8 at K 16 and K 4 the folded form, whose
    lag form fits too, as at M 2 and at M 16 with K 8, whose f32 fold takes
    256-row tiles; M 20 at K 4 the lag form) and passes the argument check; every decimation of a
    chunked plan to 125 has a lag form; every lag form's tile holds the R -
    1 rows the next tile carries (a run's lead-in is one tile)."""
    plan, tables, phase, chunks = _setup(name)
    int8 = chunks[0].dtype == torch.int8
    form = dk.kernel_form(plan.decim, plan.poly_rows, int8)
    assert form == {"m20k2_int8": (4, True), "m20k2_f32": (4, True), "m64k4_int8": (4, False),
                    "m80k2_f32": (2, False), "m8k16_int8": (4, True), "m8k4_f32": (4, True),
                    "m2k4_int8": (4, True), "m16k8_f32": (4, True), "m20k4_f32": (4, True)}[name]
    assert all(dk.tile_rows(mt) >= dk.MAX_LAGS - 1 for mt, _ in dk.FORMS)
    assert dk.smem_bytes(plan.decim, plan.poly_rows, *form[:1], 1 if int8 else 4, form[1]) <= dk.MAX_SMEM
    k = phase.shape[1]
    fold = dk.fold_form(plan.decim, plan.poly_rows, k, int8)
    assert fold == {"m8k16_int8": 4, "m8k4_f32": 4, "m2k4_int8": 4, "m16k8_f32": 2}.get(name)
    if fold is not None:
        assert dk.fold_smem_bytes(plan.decim, plan.poly_rows, k, fold, 1 if int8 else 4) <= dk.MAX_SMEM
    dk.check_args(chunks[0], torch.zeros((phase.shape[0], 2, plan.tail_len)), phase, tables, plan)
    for m in range(2, 126):
        p = ddc.plan_stage(1, m)
        if p.chunk_c > 0:
            assert p.poly_rows <= dk.MAX_LAGS
            assert dk.kernel_form(m, p.poly_rows, True) and dk.kernel_form(m, p.poly_rows, False)


def test_launch_args():
    plan, tables, phase, chunks = _setup("m20k2_int8")
    tail = torch.zeros((3, 2, plan.tail_len))
    y, new_tail = torch.empty((6, 2, 1000)), torch.empty_like(tail)
    block = torch.zeros((3, 4000, 2), dtype=torch.int8)
    for xs, want in ((chunks[0], (1, 40000)), (block[:, 1000:2000], (1, 8000)),
                     (torch.complex(*ddc._components(chunks[0])), (0, 40000))):
        n = xs.shape[1]
        args = dk.launch_args(xs, tail, phase, tables, plan, y, new_tail)
        assert args[1:4] == (*want, n)
        assert args[13:] == (3, 2, plan.tail_len, 20, plan.poly_rows, n // 20, tables.rot.fine_re.shape[-1],
                             tables.rot.coarse_re.shape[-1])
        # one argument a C parameter, and the stream last; both forms' entry points take the same
        assert len(build.SIGNATURES["modtap_stage1"]) == len(args) + 1
    assert build.SIGNATURES["modtap_fold"] == build.SIGNATURES["modtap_stage1"]
    dk.check_args(chunks[0], tail, phase, tables, plan)


@pytest.mark.parametrize("case", ["interp", "lags", "dtype", "planar", "ragged", "phase", "frag", "tail",
                                  "rotation", "wide"])
def test_check_args_refuses_what_the_kernel_does_not_take(case):
    plan, tables, phase, chunks = _setup("m20k2_int8")
    xs, tail = chunks[0], torch.zeros((3, 2, plan.tail_len))
    dk.check_args(xs, tail, phase, tables, plan)
    if case == "interp":
        plan = plan._replace(interp=2)
    elif case == "lags":
        plan = plan._replace(poly_rows=dk.MAX_LAGS + 1)
    elif case == "dtype":
        xs = xs.double()
    elif case == "planar":
        xs = xs.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "ragged":
        xs = xs[:, :-4]
    elif case == "phase":
        phase = phase[:, :1]
    elif case == "frag":
        tables = tables._replace(frag=tables.frag[..., :2, :, :])
    elif case == "tail":
        tail = tail[..., 1:]
    elif case == "rotation":
        tables = tables._replace(rot=tables.rot._replace(fine_re=tables.rot.fine_re[..., :-1]))
    elif case == "wide":
        plan = plan._replace(decim=1024)
        xs = torch.zeros((3, 1024 * 1000, 2), dtype=torch.float32)
    with pytest.raises(ValueError):
        dk.check_args(xs, tail, phase, tables, plan)


def test_kernel_source_matches_its_binding():
    """The C entry points take the binding's parameters and the module's
    constants are the source's; the source carries its note; the launcher
    tries the lag and the folded forms in the module's order; no kernel's
    name holds the names the benchmark's readers match by, and both hold
    ``modtap``; the launchers return cudaGetLastError and allocate nothing;
    the wrappers count their launches among the drivers' kernel wrappers."""
    text = SOURCE.read_text()
    for fn in ("modtap_stage1", "modtap_fold"):
        entry = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
        assert entry is not None
        assert len(entry.group(1).split(",")) == len(build.SIGNATURES[fn])
    for name, value in (("kNTG", None), ("kGroupSlots", dk.GROUP_SLOTS), ("kMaxR", dk.MAX_LAGS),
                        ("kMaxSmem", dk.MAX_SMEM), ("kWN", 4), ("kNW", 5), ("kWarps", dk.WARPS),
                        ("kFoldMaxNT", dk.FOLD_MAX_NTILES)):
        found = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert found is not None
        if value is not None:
            assert found.group(1).split()[0] == str(value)
    assert "kNTG = kWN * kNW" in text and dk.GROUP_NTILES == 4 * 5
    assert "constexpr int kZC = kMaxR;" in text and dk.CARRIED_ROWS == dk.MAX_LAGS
    assert "Replaces no TPU kernel" in text and "Bound:" in text
    forms = re.findall(r"form<(int8_t|float), (\d), (true|false)>\(\)", text)
    assert [(int(mt), b == "true") for t, mt, b in forms if t == "int8_t"] == list(dk.FORMS)
    assert [(int(mt), b == "true") for t, mt, b in forms if t == "float"] == list(dk.FORMS)
    folded = re.findall(r"folded<(int8_t|float), (\d), (\d)>\(\)", text)
    for t in ("int8_t", "float"):
        assert [(int(nt), int(mt)) for e, nt, mt in folded if e == t] == [
            (nt, mt) for nt in range(1, dk.FOLD_MAX_NTILES + 1) for mt in dk.FOLD_FORMS]
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", text)
    assert kernels == ["modtap_stage1_kernel", "modtap_fold_kernel"]
    for name in kernels + ["modtap_stage1", "modtap_fold"]:
        assert "modtap" in name
        assert not any(part in name for part in ("psd_", "selection_", "fir_decimate", "trace_", "gemm"))
    assert "cudaGetLastError()" in text and "cudaMalloc" not in text and not re.search(r"\batomic\w*\(", text)
    for name, fn in (("modtap_stage1", dk.modtap_stage1), ("modtap_stage1_fold", dk.modtap_stage1_fold)):
        assert drivers.kernel_wrappers()[name] is fn
        assert isinstance(fn.launches, int)


@pytest.mark.parametrize("name", list(FOLDED))
def test_fold_table_holds_the_modulated_taps_split_in_tf32(name):
    """B_fold holds the taps in the folded product's layout (lag q's rows
    8 k_steps(M) apart, row 2r + c a window row's component; columns 2 slot
    + o, y_re: G_re over -G_im, y_im: G_im over G_re), zeros elsewhere;
    ``make_mod_tables``'s table is its TF32 halves in ``mma.m16n8k8``'s B
    order, and B_hi + B_lo reproduce every tap within 2^-21 of max|B|."""
    plan, tables, _, _ = _setup(name)
    m, r, k, nb = plan.decim, plan.poly_rows, FOLDED[name][1], FOLDED[name][2]
    ks, nt = dk.k_steps(m), dk.fold_ntiles(k)
    assert dk.folds(m, r, k)
    g = ddc.modtap_taps(tables.w.numpy(), plan)
    b = dk.mod_b_fold(g, m, r)
    assert b.shape == (nb, r * 8 * ks, 8 * nt)
    bq = b.reshape(nb, r, 8 * ks, 8 * nt)  # [NB, q, 2r + c, column]
    for slot in range(k):
        g_re, g_im = (g[:, slot, part].reshape(nb, r, m) for part in range(2))  # [NB, q, r]
        for o, (re_rows, im_rows) in enumerate(((g_re, -g_im), (g_im, g_re))):
            np.testing.assert_array_equal(bq[:, :, 0 : 2 * m : 2, 2 * slot + o], re_rows)
            np.testing.assert_array_equal(bq[:, :, 1 : 2 * m : 2, 2 * slot + o], im_rows)
    assert not bq[:, :, 2 * m :].any() and not bq[..., 2 * k :].any()
    frag = tables.frag.numpy()
    assert frag.shape == (nb, *dk.frag_shape(m, r, k)) == (nb, r * ks, nt, 32, 4)
    np.testing.assert_array_equal(frag, dk.pack_fragments(b))
    hi, lo = frag[..., :2], frag[..., 2:]
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    # the halves back in B's place: lane l holds rows t = l % 4 and t + 4 of column l // 4
    lane = np.arange(32)
    whole = frag[..., :2].astype(np.float64) + frag[..., 2:]  # [NB, R ks, NT, 32, 2]
    back = np.zeros((nb, r * ks, 8, nt, 8))
    for e in range(2):
        back[:, :, lane % 4 + 4 * e, :, lane // 4] = np.moveaxis(whole[..., e], -1, 0)
    back = back.reshape(nb, r * ks * 8, nt * 8)
    assert np.abs(back - b).max() <= 2.0**-21 * np.abs(b).max()
    # and so the taps: row 2r of lag q holds g[q M + r] (re in column 2 slot, im in 2 slot + 1)
    for part in range(2):
        taps = back.reshape(nb, r, 8 * ks, 8 * nt)[:, :, 0 : 2 * m : 2, part : 2 * k : 2]  # [NB, q, r, slot]
        err = np.abs(np.moveaxis(taps, -1, 1).reshape(nb, k, r * m) - g[:, :, part]).max()
        assert err <= 2.0**-21 * np.abs(g).max()


@pytest.mark.parametrize("grid", [1, 7])
@pytest.mark.parametrize("name", list(FOLDED))
def test_fold_model_matches_the_matmul_form(name, grid):
    """The folded form's runs (one block over both tiles of each band, or
    runs cut inside tiles), its staged windows of TR + R - 1 rows, the Hankel
    product a lag at a time and the rotation, over two chunks
    with the raw tail carried: y within 2e-6 of max|y| of the matmul form,
    the new tail equal. A band's first tile straddles the tail (three passes
    on int8), its last is ragged."""
    plan, tables, phase, chunks = _setup(name)
    k, int8 = phase.shape[1], chunks[0].dtype == torch.int8
    mt = dk.fold_form(plan.decim, plan.poly_rows, k, int8)
    out = chunks[0].shape[1] // plan.decim
    assert plan.tail_len > 0 and out % dk.fold_tile_rows(mt) and out > dk.fold_tile_rows(mt)
    tail = torch.zeros((phase.shape[0], 2, plan.tail_len))
    for x in chunks:
        got, got_tail = fold_model(x.numpy(), tail.numpy(), phase.numpy(), tables, plan, grid, mt)
        want, tail = dk.modtap_stage1_plain(x, tail, phase, tables, plan)
        assert not np.isnan(got).any()
        assert _rel(torch.from_numpy(got), want) <= TOL
        np.testing.assert_array_equal(got_tail, tail.numpy())
        assert tail.abs().max() > 0


# each step and session cell's stage 1: (configuration, M, K, int8 stream, folds)
STAGE1_CELLS = {
    "ds491m52": ("ds491m52", 8, 16, True, True),
    "hf20m48": ("hf20m48", 20, 2, True, False),  # a fold pads 4 columns to 8: twice the multiply-adds
    "wb163m84": ("wb163m84", 20, 2, False, False),  # the bank's f32 channels
    "rtl2m048_k2": ("rtl2m048", 64, 2, True, False),
    "rtl2m048_k4": ("rtl2m048", 64, 4, True, False),  # B_fold of 278 KB does not fit
}


@pytest.mark.parametrize("cell", list(STAGE1_CELLS))
def test_form_rule_on_each_cells_stage1(cell):
    """The form follows from (M, R, K) alone: ds491m52's 16 slots at M 8
    fold (equal multiply-adds, B_fold 139 KB beside the window); hf20m48's
    and wb163m84's 2 slots at M 20 keep the lag form (the fold's 8 columns
    for 4 would double the work), as the dongle session's M 64 does (B_fold
    does not fit beside a window). Each configuration's first DDC stage is
    the one named, and the step cells' slot counts."""
    config, m, k, int8, want = STAGE1_CELLS[cell]
    c = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    assert c["ddc_stages"][0] == [1, m]
    assert c["slots_per_band"] == k or config == "rtl2m048"
    r = ddc.plan_stage(1, m).poly_rows
    assert r == 34
    assert dk.folds(m, r, k) is want
    assert (dk.fold_form(m, r, k, int8) is not None) is want
    assert (dk.frag_shape(m, r, k)[1:] == (dk.fold_ntiles(k), 32, 4)) is want
    fold_macs, lag_macs = r * dk.fold_ntiles(k), dk.groups(k) * -(-4 * r // 8)
    fits = dk.fold_smem_bytes(m, r, k, dk.FOLD_FORMS[-1], 4) <= dk.MAX_SMEM
    assert (fold_macs <= lag_macs and fits) is want
    if config == "hf20m48":
        assert fold_macs == 2 * lag_macs and fits
    if cell == "rtl2m048_k4":
        assert fold_macs == lag_macs and not fits and r * dk.k_steps(m) * dk.fold_ntiles(k) * 512 == 278_528
    if want:
        assert fold_macs == lag_macs and r * dk.k_steps(m) * dk.fold_ntiles(k) * 512 == 139_264


def test_form_rule_folds_these_shapes():
    """Where the folded form runs, for every chunked first stage and up to
    32 slots: R 34 at M >= 3 (33 at M 2), K 3-4 at M <= 8 (a window row of
    at most two k-steps an n-tile), 7-8 at M <= 16, 11-12 at M <= 12, 15-16
    at M <= 8 (B_fold beside an f32 window), where 2K fills its n-tiles as
    the lag form's two-slot groups fill theirs; the lag form elsewhere, at M
    17 and above at any K."""
    top = {4: 8, 8: 16, 12: 12, 16: 8}
    for m in range(2, 126):
        p = ddc.plan_stage(1, m)
        if p.chunk_c == 0:
            continue
        assert p.poly_rows == (33 if m == 2 else 34)
        got = [k for k in range(1, 33) if dk.folds(m, p.poly_rows, k)]
        assert got == [k for k in range(1, 17) if k % 4 in (0, 3) and m <= top[-(-k // 4) * 4]], m


@pytest.mark.parametrize("case", ["lag_table", "ntiles", "depth", "ragged"])
def test_check_args_refuses_what_the_folded_form_does_not_take(case):
    """At a shape that folds, the check wants B_fold's shape: not the lag
    form's table, not one of fewer n-tiles or k-steps; and whole rows."""
    plan, tables, phase, chunks = _setup("m8k16_int8")
    xs, tail = chunks[0], torch.zeros((1, 2, plan.tail_len))
    dk.check_args(xs, tail, phase, tables, plan)
    if case == "lag_table":
        g = ddc.modtap_taps(tables.w.numpy(), plan)
        tables = tables._replace(frag=torch.from_numpy(dk.pack_fragments(dk.mod_b(g, plan.decim, plan.poly_rows))))
    elif case == "ntiles":
        tables = tables._replace(frag=tables.frag[:, :, :3].contiguous())
    elif case == "depth":
        tables = tables._replace(frag=tables.frag[:, :-2].contiguous())
    elif case == "ragged":
        xs = xs[:, :-4]
    with pytest.raises(ValueError):
        dk.check_args(xs, tail, phase, tables, plan)


def test_wrapper_on_cpu_at_a_folded_shape_is_the_matmul_form():
    """At a shape that folds, ``modtap_stage1`` on CPU tensors runs the plain
    version and counts no launch of either form."""
    plan, tables, phase, chunks = _setup("m8k4_f32")
    assert dk.folds(plan.decim, plan.poly_rows, phase.shape[1])
    tail = torch.zeros((phase.shape[0], 2, plan.tail_len))
    before = (dk.modtap_stage1.launches, dk.modtap_stage1_fold.launches)
    y, new_tail = dk.modtap_stage1(chunks[0], tail, phase, tables, plan)
    want, want_tail = dk.modtap_stage1_plain(chunks[0], tail, phase, tables, plan)
    assert torch.equal(y, want) and torch.equal(new_tail, want_tail)
    assert (dk.modtap_stage1.launches, dk.modtap_stage1_fold.launches) == before


# -- the card -------------------------------------------------------------------------


def _stage1_f64(xs: torch.Tensor, tail: torch.Tensor, phase: torch.Tensor, tables, plan) -> torch.Tensor:
    """Stage 1 and its rotation in float64 from the f32 taps: [NB*K, 2, out]."""
    m, r = plan.decim, plan.poly_rows
    g = torch.from_numpy(ddc.modtap_taps(tables.w.cpu().numpy(), plan)).double()  # [NB, K, 2, RM]
    x = xs.cpu().double()
    if xs.dtype == torch.int8:
        x = x / 127.5
    full = torch.cat([tail.cpu().double(), x.transpose(1, 2)], dim=-1)
    full = torch.complex(full[:, 0], full[:, 1])  # [NB, t0 + n]
    out = xs.shape[1] // m
    need = (out + r - 1) * m
    full = torch.cat([full, full.new_zeros((full.shape[0], need - full.shape[1]))], dim=-1)
    taps = torch.complex(g[:, :, 0], g[:, :, 1])  # [NB, K, RM]
    windows = full.unfold(-1, r * m, m)  # [NB, out, RM]
    y1 = torch.einsum("bpi,bki->bkp", windows, taps)
    rot = tables.rot
    nb, k = phase.shape
    idx = torch.arange(out)
    q_len = rot.fine_re.shape[-1]
    ang = torch.complex(rot.coarse_re.cpu().double(), rot.coarse_im.cpu().double())[..., idx // q_len] * \
        torch.complex(rot.fine_re.cpu().double(), rot.fine_im.cpu().double())[..., idx % q_len]
    y = y1 * torch.exp(1j * phase.cpu().double())[..., None] * ang
    return torch.stack([y.real, y.imag], dim=2).reshape(nb * k, 2, out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_kernel_on_card_matches_plain_and_float64(name, dev):
    """At each geometry, two chunks with the tail carried, in the form the
    shape takes (one launch each, the folded form's counted where it runs): y
    within 2e-6 of max|y| of the plain version on the card, the new tail
    equal; the error
    against a float64 stage 1 at most twice the f32 matmul form's for the
    cells' decimations (M <= 64), and f32-class (2e-6 of max|y|) at M = 80,
    whose 160-deep product leaves the split's x_lo * B_lo term 2.8x the
    matmul form's rounding (measured on an H100)."""
    plan, tables, phase, chunks = _setup(name, dev)
    tail = torch.zeros((phase.shape[0], 2, plan.tail_len), device=dev)
    plain_tail = tail
    folded = int(dk.folds(plan.decim, plan.poly_rows, phase.shape[1]))
    assert folded == (name in FOLDED)
    for x in chunks:
        before = (dk.modtap_stage1.launches, dk.modtap_stage1_fold.launches)
        got, got_tail = dk.modtap_stage1(x, tail, phase, tables, plan)
        torch.cuda.synchronize()
        assert (dk.modtap_stage1.launches, dk.modtap_stage1_fold.launches) == (before[0] + 1, before[1] + folded)
        want, want_tail = dk.modtap_stage1_plain(x, plain_tail, phase, tables, plan)
        exact = _stage1_f64(x, plain_tail, phase, tables, plan)
        assert _rel(got, want) <= TOL, name
        assert torch.equal(got_tail, want_tail)
        err, err_mm = ((got.cpu().double() - exact).abs().max(), (want.cpu().double() - exact).abs().max())
        assert err <= (2 * err_mm if plan.decim <= 64 else TOL * exact.abs().max())
        tail, plain_tail = got_tail, want_tail


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_ddc_chunk_recordings_on_card_match_cpu(name, dev):
    """``ddc_chunk_modtap`` over three chunks, the card against the CPU: the
    int8 recordings within 1 LSB, the raw tails equal."""
    m, k, nb, dtype, out1 = GEOMETRIES[name]
    cfg_plans = ddc.plan_chain(RATE, 32_000) if m == 20 else [ddc.plan_stage(1, m)]
    shifts = _shifts(k, nb)
    states = {d: ddc.init_ddc2_state(cfg_plans, nb, k, torch.device(d)) for d in ("cpu", dev)}
    tabs = {d: ddc.make_mod_tables(cfg_plans, shifts, RATE, out1 * m * 32, torch.device(d)) for d in ("cpu", dev)}
    for i in range(3):
        x = _stream(nb, out1 * m * 32, dtype, seed=i)
        outs = {}
        for d in ("cpu", dev):
            states[d], outs[d] = ddc.ddc_chunk_modtap(x.to(d), states[d], tabs[d], cfg_plans)
        diff = (outs[dev].cpu().int() - outs["cpu"].int()).abs()
        assert int(diff.max()) <= 1, name
        assert torch.equal(states[dev].x_tail.cpu(), states["cpu"].x_tail)


@pytest.mark.cuda
def test_ddc_chunk_on_card_is_one_stage1_launch(dev):
    """hf20m48's chunk (24 bands, 2 slots, int8, stages (1, 20), (1, 32)):
    one ``modtap_stage1`` launch and one FIR launch, no GEMM and no ``cat``
    on the card."""
    plans = ddc.plan_chain(RATE, 32_000)
    assert [(p.interp, p.decim) for p in plans] == [(1, 20), (1, 32)]
    chunk = 1_105_920
    state = ddc.init_ddc2_state(plans, 24, 2, dev)
    tables = ddc.make_mod_tables(plans, _shifts(2, 24), RATE, chunk, dev)
    x = _stream(24, chunk, "int8", seed=1).to(dev)
    state, _ = ddc.ddc_chunk_modtap(x, state, tables, plans)
    torch.cuda.synchronize()
    wrappers = drivers.kernel_wrappers()
    before = {name: fn.launches for name, fn in wrappers.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, out = ddc.ddc_chunk_modtap(x, state, tables, plans)
        torch.cuda.synchronize()
    counts = {name: fn.launches - before[name] for name, fn in wrappers.items()}
    assert counts == {**{name: 0 for name in wrappers}, "modtap_stage1": 1, "stage_apply_fir": 1}
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("modtap_stage1_kernel" in s for s in names) == 1, names
    assert not any("modtap_fold" in s for s in names), names
    assert not any("gemm" in s.lower() or "CatArray" in s for s in names), names
    assert out.shape == (24, 2, chunk // 640, 2) and out.dtype == torch.int8


@pytest.mark.cuda
def test_ds491m52_chunk_on_card_is_one_fold_launch(dev):
    """ds491m52's chunk (one int8 band of 1,966,080 samples, 16 slots,
    stages (1, 8), (1, 16), (1, 120)): stage 1 is one launch of the folded
    kernel (counted by ``modtap_stage1`` and ``modtap_stage1_fold``, one
    kernel whose name holds ``modtap_fold``, none of the lag form), within
    2e-6 of max|y| of the plain version with the tail equal; then one FIR
    launch a later stage, no GEMM."""
    c = json.loads((ROOT / "benchmark" / "configs" / "ds491m52.json").read_text())
    rate, k, chunk = c["sample_rate"], c["slots_per_band"], 1_966_080
    plans = [ddc.plan_stage(i, m) for i, m in c["ddc_stages"]]
    assert (plans[0].decim, k) == (8, 16) and dk.folds(8, plans[0].poly_rows, k)
    shifts = np.random.default_rng(27).integers(-rate // 2 + 1, rate // 2, size=(1, k))
    state = ddc.init_ddc2_state(plans, 1, k, dev)
    tables = ddc.make_mod_tables(plans, shifts, rate, chunk, dev)
    x = _stream(1, chunk, "int8", seed=2).to(dev)
    state, _ = ddc.ddc_chunk_modtap(x, state, tables, plans)  # the tail is carried into the timed chunk
    got, got_tail = dk.modtap_stage1(x, state.x_tail, state.phase, tables, plans[0])
    want, want_tail = dk.modtap_stage1_plain(x, state.x_tail, state.phase, tables, plans[0])
    assert _rel(got, want) <= TOL and torch.equal(got_tail, want_tail)
    del got, want
    torch.cuda.synchronize()
    wrappers = drivers.kernel_wrappers()
    before = {name: fn.launches for name, fn in wrappers.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, out = ddc.ddc_chunk_modtap(x, state, tables, plans)
        torch.cuda.synchronize()
    counts = {name: fn.launches - before[name] for name, fn in wrappers.items()}
    assert counts == {**{name: 0 for name in wrappers}, "modtap_stage1": 1, "modtap_stage1_fold": 1,
                      "stage_apply_fir": 2}
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("modtap_fold" in s for s in names) == 1, names
    assert not any("modtap_stage1_kernel" in s for s in names), names
    assert not any("gemm" in s.lower() for s in names), names
    assert out.shape == (1, k, chunk // 15_360, 2) and out.dtype == torch.int8
