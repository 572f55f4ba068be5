"""Stage 1 of the modulated-taps DDC: its wrapper
(``ops/cuda/ddc_kernel.modtap_stage1``), the hand-written kernel behind it
(``csrc/ddc_kernel.cu``) and its place in ``ops/ddc.ddc_chunk_modtap``.

On the CPU: the kernel's B table holds ``make_mod_tables``'s modulated taps
(the ones its matrix ``w`` holds) in the complex product's layout, split
into TF32 halves; a numpy model of the kernel's runs, tiles, staged windows,
carried Z rows, lag sums and rotation agrees with the matmul form within
2e-6 of max|y| at the step cells' geometry (M 20, K 2, int8 and f32 pairs)
and the dongle session's (M 64, K 4), over two chunks with the tail
carried; the wrapper on CPU tensors is the matmul form and counts nothing;
the argument check and the launch arguments are built without a card. On
the card (marker ``cuda``; skips elsewhere): the kernel against its plain
version and against a float64 stage 1 at each geometry, recordings within
1 LSB of the CPU, and one launch a chunk (no GEMM). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ddc_kernel.py
"""

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
SOURCE = Path(dk.__file__).resolve().parents[2] / "csrc" / "ddc_kernel.cu"
TOL = 2e-6  # of max|y|: the split-TF32 product against the f32 matmul form (f32-class, sums in other orders)
RATE = 20_480_000
# (decimation, slots, bands, stream dtype, chunk outputs): the step cells'
# stage 1 on int8 (hf20m48) and on the bank's f32 channels (wb163m84), the
# dongle session's one-stage chain (rtl2m048), and 256 kHz channels recorded
# at 3.2 kHz (the band-shard scenes: the kernel's 64-row form), and the
# direct-sampling band's (ds491m52: M 8, 16 slots in 8 column groups);
# outputs a chunk cover a few tiles and a ragged last one
GEOMETRIES = {
    "m20k2_int8": (20, 2, 3, "int8", 1000),
    "m20k2_f32": (20, 2, 3, "float32", 1000),
    "m64k4_int8": (64, 4, 1, "int8", 600),
    "m80k2_f32": (80, 2, 2, "float32", 300),
    "m8k16_int8": (8, 16, 1, "int8", 1000),
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
    m, k, nb, dtype, out1 = GEOMETRIES[name]
    plan = ddc.plan_stage(1, m)
    tables = ddc.make_mod_tables([plan], _shifts(k, nb), RATE, out1 * m, torch.device(device))
    phase = torch.from_numpy(np.random.default_rng(m).uniform(0, 2 * np.pi, size=(nb, k)).astype(np.float32))
    chunks = [_stream(nb, out1 * m, dtype, seed=m + i) for i in range(2)]
    return plan, tables, phase.to(device), [c.to(device) for c in chunks]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.cpu().double(), want.cpu().double()
    return float((got - want).abs().max() / want.abs().max())


# -- a numpy model of the kernel ------------------------------------------------


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def kernel_model(xs: np.ndarray, tail: np.ndarray, phase: np.ndarray, tables, plan, grid: int, mt: int = 4):
    """The kernel's loops in numpy, a thread block at a time: xs [NB, n, 2]
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
    rot = tables.rot
    q_len = rot.fine_re.shape[-1]
    ph_re, ph_im = np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)
    for blk in range(grid):
        start, end = total * blk // grid, total * (blk + 1) // grid
        item = start - 1 if 0 < start < end and start % tpr else start
        z = np.full((zc + tr, 8 * nt_live), np.nan, np.float32)
        while item < end:
            row, t = divmod(item, tpr)
            band, grp = divmod(row, groups)
            z[zc - r + 1 : zc] = z[zc + tr - r + 1 : zc + tr]  # the carried rows
            s0 = t * tr * m
            # the staged tile: [tr, 8 ks], tail (x 127.5 on the int8 route), x, zeros
            win = np.zeros((tr, 8 * ks), np.float32)
            s = s0 + np.arange(tr)[:, None] * m + np.arange(2 * m)[None, :] // 2
            c = np.broadcast_to(np.arange(2 * m)[None, :] % 2, s.shape)
            in_tail, in_x = s < t0, (s >= t0) & (s - t0 < n)
            win[:, : 2 * m][in_tail] = tail[band, c[in_tail], s[in_tail]] * np.float32(127.5 if int8 else 1.0)
            win[:, : 2 * m][in_x] = xs[band, s[in_x] - t0, c[in_x]].astype(np.float32)
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
                pp = p[ok]
                co_re = rot.coarse_re[band, slot].numpy()[pp // q_len]
                co_im = rot.coarse_im[band, slot].numpy()[pp // q_len]
                f_re, f_im = rot.fine_re[band, slot].numpy()[pp % q_len], rot.fine_im[band, slot].numpy()[pp % q_len]
                a, b = ph_re[band, slot], ph_im[band, slot]
                c_re, c_im = _f32(_f32(a * co_re) - _f32(b * co_im)), _f32(_f32(a * co_im) + _f32(b * co_re))
                r_re = _f32(_f32(c_re * f_re) - _f32(c_im * f_im))
                r_im = _f32(_f32(c_re * f_im) + _f32(c_im * f_re))
                y[band * k + slot, 0, pp] = _f32(_f32(re * r_re) - _f32(im * r_im))
                y[band * k + slot, 1, pp] = _f32(_f32(re * r_im) + _f32(im * r_re))
    full = np.concatenate([tail, np.moveaxis(xs, -1, -2).astype(np.float32) * np.float32(dk.CS8_SCALE if int8 else 1)],
                          axis=-1)
    return y, full[..., n : n + t0]


# -- the CPU --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_b_table_holds_the_modulated_taps_split_in_tf32(name):
    """``modtap_taps`` reads ``make_mod_tables``'s f32 taps back out of
    every place ``w`` holds them; B holds them in the complex product's
    layout (y_re: G_re over -G_im, y_im: G_im over G_re, R lags a column);
    the fragments are B's TF32 halves (B_hi + B_lo within 2^-21 of B) in
    ``mma.m16n8k8``'s B order."""
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
    frag = tables.frag.numpy()
    assert frag.shape == (nb, dk.groups(k), dk.k_steps(m), dk.GROUP_NTILES, 32, 4)
    np.testing.assert_array_equal(frag, dk.pack_fragments(b))
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
    """The kernel's runs (one block, or runs starting inside rows), tiles,
    staged windows, carried Z rows, lag sums and rotation over two chunks
    with the raw tail carried: y within 2e-6 of max|y| of the matmul form,
    the new tail equal."""
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
    kHz recordings' 64-row tiles) and passes the argument check; every
    decimation of a chunked plan to 125 has one; every form's tile holds
    the R - 1 rows the next tile carries (a run's lead-in is one tile)."""
    plan, tables, phase, chunks = _setup(name)
    int8 = chunks[0].dtype == torch.int8
    form = dk.kernel_form(plan.decim, plan.poly_rows, int8)
    assert form == {"m20k2_int8": (4, True), "m20k2_f32": (4, True), "m64k4_int8": (4, False),
                    "m80k2_f32": (2, False), "m8k16_int8": (4, True)}[name]
    assert all(dk.tile_rows(mt) >= dk.MAX_LAGS - 1 for mt, _ in dk.FORMS)
    assert dk.smem_bytes(plan.decim, plan.poly_rows, *form[:1], 1 if int8 else 4, form[1]) <= dk.MAX_SMEM
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
        # one argument a C parameter, and the stream last
        assert len(build.SIGNATURES["modtap_stage1"]) == len(args) + 1
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
    """The C entry point takes the binding's parameters and the module's
    constants are the source's; the source carries its note; no kernel's
    name holds the names the benchmark's readers match by; the launcher
    returns cudaGetLastError and allocates nothing; the wrapper counts its
    launches among the drivers' kernel wrappers."""
    text = SOURCE.read_text()
    entry = re.search(r'extern "C" int modtap_stage1\(([^)]*)\)', text)
    assert entry is not None
    assert len(entry.group(1).split(",")) == len(build.SIGNATURES["modtap_stage1"])
    for name, value in (("kNTG", None), ("kGroupSlots", dk.GROUP_SLOTS), ("kMaxR", dk.MAX_LAGS),
                        ("kMaxSmem", dk.MAX_SMEM), ("kWN", 4), ("kNW", 5)):
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
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", text)
    assert kernels == ["modtap_stage1_kernel"]
    for name in kernels + ["modtap_stage1"]:
        assert not any(part in name for part in ("psd_", "selection_", "fir_decimate", "trace_", "gemm"))
    assert "cudaGetLastError()" in text and "cudaMalloc" not in text and not re.search(r"\batomic\w*\(", text)
    assert drivers.kernel_wrappers()["modtap_stage1"] is dk.modtap_stage1
    assert isinstance(dk.modtap_stage1.launches, int)


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
    """At each geometry, two chunks with the tail carried: y within 2e-6 of
    max|y| of the plain version on the card, the new tail equal; the error
    against a float64 stage 1 at most twice the f32 matmul form's for the
    cells' decimations (M <= 64), and f32-class (2e-6 of max|y|) at M = 80,
    whose 160-deep product leaves the split's x_lo * B_lo term 2.8x the
    matmul form's rounding (measured on an H100)."""
    plan, tables, phase, chunks = _setup(name, dev)
    tail = torch.zeros((phase.shape[0], 2, plan.tail_len), device=dev)
    plain_tail = tail
    for x in chunks:
        before = dk.modtap_stage1.launches
        got, got_tail = dk.modtap_stage1(x, tail, phase, tables, plan)
        torch.cuda.synchronize()
        assert dk.modtap_stage1.launches == before + 1
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
    assert not any("gemm" in s.lower() or "CatArray" in s for s in names), names
    assert out.shape == (24, 2, chunk // 640, 2) and out.dtype == torch.int8
