"""The critically sampled analysis bank: its wrapper
(``ops/cuda/channelizer_kernel.analysis_bank``), the hand-written kernel
behind it (``csrc/channelizer_kernel.cu``) and the bank's routing in
``ops/channelizer._bank``.

On the CPU: the kernel's host tables are the plan's branch kernels and the
DFT; numpy models of the kernel's index arithmetic (the FFT form's
shared-memory rows, branch-FIR items, register window and bit-reversed
FFT; the direct-DFT form's runs and twiddle indices) and the wrapper's
plain version agree with the matmul form within the bar between the
bank's forms (atol = rtol = 2e-5, tests/test_torch_channelizer.py); the
launch arguments are built and checked without a card; ``_bank`` on CPU
tensors takes the matmul form. On the card (marker ``cuda``; skips
elsewhere): the bank is one launch of the kernel and nothing else, a
captured graph replays equal to eager, and the bf16 plan takes the kernel
too (``tests/test_torch_on_card.py::test_channelizer_on_card_matches_cpu``
holds the kernel's channels against the CPU). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_channelizer_kernel.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu_torch import drivers
from rtl_sdr_scanner_tpu_torch.ops import channelizer as ch
from rtl_sdr_scanner_tpu_torch.ops.cuda import build, channelizer_kernel as ck

torch.set_num_threads(2)
SOURCE = Path(ck.__file__).resolve().parents[2] / "csrc" / "channelizer_kernel.cu"
TOL = 2e-5  # atol = rtol: the bank's forms (f32 sums in other orders)
DFT_CHANNELS = (3, 12, 128)  # channel counts of the direct-DFT form


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _close(got: torch.Tensor, want: torch.Tensor) -> bool:
    got, want = got.cpu().double(), want.cpu().double()
    return bool(((got - want).abs() <= TOL + TOL * want.abs()).all())


def _blocks(b: int, dtype: str, seed: int, blocks: int = 3):
    """Consecutive [n, 2] blocks (n not a multiple of the kernel's run):
    int8 cs8, or f32 pairs in the dequantized units."""
    n = b * (ck.run_length(b) + 77)
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return [torch.from_numpy(rng.integers(-100, 101, size=(n, 2), dtype=np.int8)) for _ in range(blocks)]
    return [torch.from_numpy(rng.uniform(-0.8, 0.8, size=(n, 2)).astype(np.float32)) for _ in range(blocks)]


# -- a numpy model of the kernel's index arithmetic -----------------------------


def _row_stride(b: int, run: int, taps_pad: int) -> int:
    need = run + taps_pad
    want = 16 // b if b < 16 else 1
    return need + ((want - need % 16) + 16) % 16


def _bit_reverse(i: int, b: int) -> int:
    r, bit = 0, 1
    while bit < b:
        r, i, bit = (r << 1) | (i & 1), i >> 1, bit << 1
    return r


def kernel_model(xs: np.ndarray, tail: np.ndarray, taps: np.ndarray, tw: np.ndarray, n_taps: int) -> np.ndarray:
    """The kernel's loops in float32 numpy, a thread block at a time: xs [2, n]
    f32 components -> channels [B, n / B, 2]."""
    b, tp = taps.shape
    run, items_a_branch = ck.run_length(b), ck.ITEMS // b
    rows = _row_stride(b, run, tp)
    tail_len, n = (n_taps - 1) * b, xs.shape[1]
    ext = np.concatenate([tail.T, xs], axis=1).T.astype(np.float32)  # [tail + n, 2]
    m_all = n // b
    out = np.zeros((b, m_all, 2), np.float32)
    twc = tw[:, 0] + 1j * tw[:, 1]
    for m0 in range(0, m_all, run):
        e0 = m0 * b
        span = min((run + n_taps - 1) * b, tail_len + n - e0)
        idx = np.arange(rows * b)
        s_x = np.zeros((b * rows, 2), np.float32)
        live = idx < span
        s_x[(idx % b) * rows + idx // b] = np.where(live[:, None], ext[np.minimum(e0 + idx, len(ext) - 1)], 0)
        it = np.arange(ck.ITEMS)
        p, g = it // items_a_branch, it % items_a_branch
        base = p * rows + ck.TAP_CHUNK * g
        w = [s_x[base + u] for u in range(3)]
        acc = [np.zeros((ck.ITEMS, 2), np.float32) for _ in range(3)]
        for c in range(0, tp, ck.TAP_CHUNK):
            nxt = [s_x[base + c + 3 + u] for u in range(3)]
            window = w + nxt
            for t in range(3):
                k = taps[p, c + t][:, None]
                for u in range(3):
                    acc[u] = (acc[u] + k * window[u + t]).astype(np.float32)
            w = nxt
        s_v = np.zeros((b * run, 2), np.float32)
        for u in range(3):
            s_v[p * run + ck.TAP_CHUNK * g + u] = acc[u]
        valid = min(run, m_all - m0)
        a = [s_v[q * run : q * run + valid, 0] + 1j * s_v[q * run : q * run + valid, 1] for q in range(b)]
        a = [x.astype(np.complex64) for x in a]
        half = b // 2
        while half >= 1:
            for k0 in range(0, b, 2 * half):
                for j in range(half):
                    u, v = a[k0 + j], a[k0 + j + half]
                    a[k0 + j] = u + v
                    a[k0 + j + half] = (u - v) if j == 0 else (u - v) * np.complex64(twc[j * (b // (2 * half))])
            half //= 2
        for i in range(b):
            out[_bit_reverse(i, b), m0 : m0 + valid] = np.stack([a[i].real, a[i].imag], axis=-1)
    return out


def dft_model(xs: np.ndarray, tail: np.ndarray, taps: np.ndarray, tw: np.ndarray, n_taps: int) -> np.ndarray:
    """The direct-DFT form in float32 numpy: branch sums in ascending t, then
    y_c[m] = sum_p W^{(c p) mod B} v_p[m] in ascending p, twiddles from the
    table; xs [2, n] f32 components -> channels [B, n / B, 2]."""
    b = taps.shape[0]
    ext = np.concatenate([tail.T, xs], axis=1).T.astype(np.float32)  # [tail + n, 2]
    m_all = xs.shape[1] // b
    v = np.zeros((b, m_all, 2), np.float32)
    for t in range(n_taps):
        e = (np.arange(m_all)[None, :] + t) * b + np.arange(b)[:, None]
        v = (v + taps[:, t][:, None, None] * ext[e]).astype(np.float32)
    vc = (v[..., 0] + 1j * v[..., 1]).astype(np.complex64)
    twc = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    y = np.zeros((b, m_all), np.complex64)
    for p in range(b):
        y = y + twc[(np.arange(b) * p) % b][:, None] * vc[p][None, :]
    return np.stack([y.real, y.imag], axis=-1).astype(np.float32)


# -- the CPU ------------------------------------------------------------------------


@pytest.mark.parametrize("oversample", [1, 2])
@pytest.mark.parametrize("b", ck.CHANNELS + DFT_CHANNELS)
def test_host_tables_are_the_plans_kernels_and_the_dft(b, oversample):
    plan = ch.plan_channelizer(b, oversample=oversample)
    taps, tw = ck.host_tables(plan.branch_kernels)
    t = plan.taps_per_branch
    assert taps.dtype == tw.dtype == np.float32
    assert taps.shape == (b, ck.padded_taps(t)) and taps.shape[1] % ck.TAP_CHUNK == 0 and t <= ck.MAX_TAPS
    np.testing.assert_array_equal(taps[:, :t], plan.branch_kernels)
    assert not taps[:, t:].any()
    k = np.arange(b)
    np.testing.assert_array_equal(tw, np.stack([np.cos(-2 * np.pi * k / b), np.sin(-2 * np.pi * k / b)],
                                                axis=-1).astype(np.float32))
    # the DFT matrix from the table: W^(b p mod B) (the FFT form reads the
    # first half, W^(k + B / 2) = -W^k)
    e = np.outer(np.arange(b), np.arange(b)) % b
    twc = tw[:, 0].astype(np.float64) + 1j * tw[:, 1]
    bb, pp = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    np.testing.assert_allclose(twc[e], np.exp(-2j * np.pi * bb * pp / b), atol=1e-7)
    if b % 2 == 0:
        h = b // 2
        np.testing.assert_allclose(np.where(e < h, twc[e % h], -twc[e % h]), twc[e], atol=1e-7)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("b", ck.CHANNELS + DFT_CHANNELS)
def test_kernel_model_matches_the_matmul_form(b, dtype):
    """The kernel's index arithmetic (the FFT form's for B in its template,
    the direct-DFT form's otherwise), three streamed blocks with the tail
    carried, n not a multiple of the run: within 2e-5 of ``_bank_mm``."""
    plan = ch.plan_channelizer(b)
    taps, tw = ck.host_tables(plan.branch_kernels)
    state = ch.init_channelizer_state(plan, "cpu")
    model = kernel_model if b in ck.CHANNELS else dft_model
    for x in _blocks(b, dtype, seed=b):
        xs = ck.dequantize(x.T)
        got = model(xs.numpy(), state.tail.numpy(), taps, tw, plan.taps_per_branch)
        state, y_re, y_im = ch._bank_mm(plan, state, xs)
        assert _close(torch.from_numpy(got), torch.stack([y_re, y_im], dim=-1))
        assert state.tail.abs().max() > 0


@pytest.mark.parametrize("layout", ["pairs", "components"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("b", [2, 8, 12, 64])
def test_plain_version_matches_the_matmul_form(b, dtype, layout):
    """The wrapper on CPU tensors (its plain version) over three streamed
    blocks, from a [2, n] view of the pairs or contiguous components: the
    channels within 2e-5 of ``_bank_mm``, the tails equal."""
    plan = ch.plan_channelizer(b)
    taps, tw = (torch.from_numpy(t) for t in ck.host_tables(plan.branch_kernels))
    mm = ch.init_channelizer_state(plan, "cpu")
    tail = mm.tail
    for x in _blocks(b, dtype, seed=10 + b):
        xs = x.T if layout == "pairs" else x.T.contiguous()
        before = ck.analysis_bank.launches
        got, tail = ck.analysis_bank(xs, tail, taps, tw, plan.taps_per_branch)
        assert ck.analysis_bank.launches == before  # the plain version counts nothing
        mm, y_re, y_im = ch._bank_mm(plan, mm, ck.dequantize(x.T))
        assert got.shape == (b, x.shape[0] // b, 2) and got.dtype == torch.float32
        assert _close(got, torch.stack([y_re, y_im], dim=-1))
        assert torch.equal(tail, mm.tail)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("oversample", [1, 2])
def test_bank_on_cpu_takes_the_matmul_form(oversample, bf16, monkeypatch):
    """On CPU tensors ``_bank`` runs ``_bank_mm`` (once a critically sampled
    bank, twice a 2x bank) and never the wrapper, with the numbers it gave
    before the kernel: the channels as ``_bank_mm``'s, stacked."""
    b = 8
    plan = ch.plan_channelizer(b, oversample=oversample, bf16=bf16)
    calls = []
    real = ch._bank_mm
    monkeypatch.setattr(ch, "_bank_mm", lambda *a: calls.append(a[2].shape) or real(*a))
    monkeypatch.setattr(ch.channelizer_kernel, "analysis_bank",
                        lambda *a: pytest.fail("the wrapper ran on CPU tensors"))
    x = _blocks(b, "int8", seed=3, blocks=1)[0]
    if oversample == 2:
        _, got = ch.channelize_block_2x_pairs(plan, ch.init_channelizer2x_state(plan, "cpu"), x)
        assert len(calls) == 2 and got.shape == (b, 2 * x.shape[0] // b, 2)
        return
    _, got = ch.channelize_block_pairs(plan, ch.init_channelizer_state(plan, "cpu"), x)
    assert len(calls) == 1
    _, y_re, y_im = real(plan, ch.init_channelizer_state(plan, "cpu"), x.to(torch.float32).T * (1.0 / 127.5))
    assert torch.equal(got, torch.stack([y_re, y_im], dim=-1))


@pytest.mark.parametrize("b", [8, 12, ck.MAX_CHANNELS])
def test_check_args_takes_every_channel_count_to_the_largest(b):
    """Any B from 2 to ``MAX_CHANNELS``: the FFT form's powers of two and the
    direct-DFT form's rest (the plans' T is 10-18)."""
    plan = ch.plan_channelizer(b)
    taps, tw = (torch.from_numpy(t) for t in ck.host_tables(plan.branch_kernels))
    ck.check_args(torch.zeros((2, b * 3)), torch.zeros((plan.tail_len, 2)), taps, tw, plan.taps_per_branch)
    assert ck.run_length(b) == (1536 // b if b in ck.CHANNELS else max(1, 2048 // b))


def test_launch_args():
    plan = ch.plan_channelizer(8)
    taps, tw = (torch.from_numpy(t) for t in ck.host_tables(plan.branch_kernels))
    tail = torch.zeros((plan.tail_len, 2))
    pairs = torch.zeros((8 * 100, 2), dtype=torch.int8)
    comps = torch.zeros((2, 8 * 100))
    out, new_tail = torch.empty((8, 100, 2)), torch.empty_like(tail)
    for xs, want in ((pairs.T, (1, 2, 1)), (comps, (0, 1, 800)), (comps.T.contiguous().T, (0, 2, 1))):
        ck.check_args(xs, tail, taps, tw, plan.taps_per_branch)
        args = ck.launch_args(xs, tail, taps, tw, out, new_tail, plan.taps_per_branch)
        assert args == (xs.data_ptr(), *want, 800, tail.data_ptr(), taps.data_ptr(), tw.data_ptr(), out.data_ptr(),
                        new_tail.data_ptr(), 8, plan.taps_per_branch)
        # one argument a C parameter, and the stream last
        assert len(build.SIGNATURES["analysis_bank"]) == len(args) + 1


@pytest.mark.parametrize("case", ["b1", "b4097", "taps", "ragged", "dtype", "layout", "tail", "unpadded", "twiddles"])
def test_check_args_refuses_what_the_kernel_does_not_take(case):
    b, t = 8, 18
    xs, tail = torch.zeros((2, b * 64)), torch.zeros(((t - 1) * b, 2))
    taps, tw = torch.zeros((b, ck.padded_taps(t))), torch.zeros((b, 2))
    ck.check_args(xs, tail, taps, tw, t)
    if case in ("b1", "b4097"):
        b = 1 if case == "b1" else ck.MAX_CHANNELS + 1
        xs, tail, taps, tw = torch.zeros((2, b * 4)), torch.zeros(((t - 1) * b, 2)), torch.zeros((b, 18)), \
            torch.zeros((b, 2))
    elif case == "taps":
        t = ck.MAX_TAPS + 1
        tail, taps = torch.zeros(((t - 1) * b, 2)), torch.zeros((b, ck.padded_taps(t)))
    elif case == "ragged":
        xs = torch.zeros((2, b * 64 + 4))
    elif case == "dtype":
        xs = xs.double()
    elif case == "layout":
        xs = torch.zeros((3, b * 64))
    elif case == "tail":
        tail = tail[1:]
    elif case == "unpadded":
        taps = torch.zeros((b, t + 1))
    elif case == "twiddles":
        tw = torch.zeros((b // 2, 2))
    with pytest.raises(ValueError):
        ck.check_args(xs, tail, taps, tw, t)


def test_kernel_source_matches_its_binding():
    """The C entry point takes the binding's parameters and the module's
    constants are the source's; the source carries its note; no kernel's
    name holds the names the benchmark's readers match by; the launcher
    returns cudaGetLastError and allocates nothing; the wrapper counts its
    launches among the drivers' kernel wrappers."""
    text = SOURCE.read_text()
    entry = re.search(r'extern "C" int analysis_bank\(([^)]*)\)', text)
    assert entry is not None
    assert len(entry.group(1).split(",")) == len(build.SIGNATURES["analysis_bank"])
    for name, value in (("kItems", ck.ITEMS), ("kU", ck.TAP_CHUNK), ("kMaxTaps", ck.MAX_TAPS),
                        ("kMaxChannels", ck.MAX_CHANNELS), ("kDftPoints", ck.DFT_POINTS)):
        assert re.search(rf"constexpr int {name} = (\d+);", text).group(1) == str(value)
    assert "Replaces no TPU kernel" in text and "Bound: bytes" in text
    assert all(f"case {b}:" in text for b in ck.CHANNELS)
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", text)
    assert kernels == ["analysis_bank_kernel", "analysis_bank_dft_kernel"]
    for name in kernels + ["analysis_bank"]:
        assert not any(part in name for part in ("psd_", "selection_", "fir_decimate", "trace_"))
    assert "cudaGetLastError()" in text and "cudaMalloc" not in text
    assert drivers.kernel_wrappers()["analysis_bank"] is ck.analysis_bank
    assert isinstance(ck.analysis_bank.launches, int)


# -- the card -------------------------------------------------------------------------


@pytest.mark.cuda
def test_bank_on_card_is_one_kernel_launch(dev):
    """``channelize_block_pairs`` on the cell's geometry (8 channels, int8):
    one launch, counted, and the only kernel the card runs (no GEMM, no
    copy)."""
    plan = ch.plan_channelizer(8)
    state = ch.init_channelizer_state(plan, dev)
    x = _blocks(8, "int8", seed=5, blocks=1)[0].to(dev)
    state, _ = ch.channelize_block_pairs(plan, state, x)  # the tables reach the card here
    torch.cuda.synchronize()
    before = ck.analysis_bank.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = ch.channelize_block_pairs(plan, state, x)
        torch.cuda.synchronize()
    assert ck.analysis_bank.launches == before + 1
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "analysis_bank_kernel<8" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("oversample", [1, 2])
def test_graphed_bank_replays_equal_to_eager(oversample, dev):
    """The bank captured as a graph (``graph.donated_step``, the state
    donated) over three blocks equals the eager calls bit for bit; one
    capture, one launch a replay (two for the 2x bank)."""
    from rtl_sdr_scanner_tpu_torch import graph

    b = 8
    plan = ch.plan_channelizer(b, oversample=oversample)
    fn = ch.channelize_block_2x_pairs if oversample == 2 else ch.channelize_block_pairs
    init = ch.init_channelizer2x_state if oversample == 2 else ch.init_channelizer_state
    blocks = [x.to(dev) for x in _blocks(b, "int8", seed=7)]
    step = graph.donated_step(lambda s, x: fn(plan, s, x), donate=(0,))
    eager, graphed = init(plan, dev), init(plan, dev)
    for i, x in enumerate(blocks):
        eager, want = fn(plan, eager, x)
        before = ck.analysis_bank.launches
        graphed, got = step(graphed, x)
        torch.cuda.synchronize()
        if i > 0:
            assert ck.analysis_bank.launches == before + oversample
        assert torch.equal(got, want)
    assert step.captures == 1


@pytest.mark.cuda
def test_bf16_plan_on_card_takes_the_kernel(dev):
    """The bf16 plan (bf16 operands in the CPU's product G = W k) runs the
    f32 kernel on the card: one launch, the f32 plan's channels bit for bit."""
    x = _blocks(8, "int8", seed=9, blocks=1)[0].to(dev)
    outs = []
    for bf16 in (True, False):
        plan = ch.plan_channelizer(8, bf16=bf16)
        before = ck.analysis_bank.launches
        outs.append(ch.channelize_block_pairs(plan, ch.init_channelizer_state(plan, dev), x)[1])
        assert ck.analysis_bank.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(*outs)
