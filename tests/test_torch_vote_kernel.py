"""The history vote: its wrapper (``ops/cuda/vote_kernel.history_vote``) and
the hand-written kernel behind it (``csrc/vote_kernel.cu``).

On the CPU the wrapper runs the plain version (``ops/detect.history_vote_plain``),
held here against a loop over the reference's rule, window by window, for
every lowering ``VOTE_FORM`` picks; the launch arguments are built and
checked without a card. On the card (marker ``cuda``; skips elsewhere) the
kernel's ``cand_best`` is bit-equal to every plain lowering at the
benchmark's shapes, in f32 and bf16, with edge windows, ties, no valid vote
and strided history. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vote_kernel.py
"""

import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu_torch.ops import detect
from rtl_sdr_scanner_tpu_torch.ops.cuda import build, vote_kernel

torch.set_num_threads(2)
SOURCE = Path(vote_kernel.__file__).resolve().parents[2] / "csrc" / "vote_kernel.cu"
FORMS = ("code", "gather")
DEPTH = 11
LEVEL = 8.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def reference_vote(raw, prev, cand, half, level, depth, bf16):
    """The reference's vote, a window at a time: the first maximum of each
    history row over the clamped window, a vote where it is >= level in f32,
    the most frequent vote with the median of the tied values, else the
    candidate. Rows as ``cat(prev.to(raw dtype), raw)``, in bf16 where asked."""
    hist = torch.cat([prev.to(raw.dtype), raw], dim=1)
    if bf16:
        hist = hist.to(torch.bfloat16)
    hist = hist.float().cpu().numpy()
    cand = cand.cpu().numpy()
    fft = hist.shape[2]
    out = cand.copy()
    for b, k, c in np.ndindex(*cand.shape):
        i = cand[b, k, c]
        lo, hi = max(i - half, 0), min(i + half, fft - 1)
        votes = []
        for h in range(depth):
            seg = hist[b, k + h, lo : hi + 1]
            if seg.max() >= np.float32(level):
                votes.append(lo + int(np.argmax(seg)))
        if votes:
            counts = Counter(votes)
            most = max(counts.values())
            tied = sorted(v for v, n in counts.items() if n == most)
            out[b, k, c] = tied[len(tied) // 2]
    return out


def tie_scene(nb, frames, fft, half, seed, invalid=0.4):
    """History rows at -20 but for one peak a row near each of a few centers,
    at one of five offsets (shared by the centers of a row) and of one of
    three heights, a share of them under the level: the votes of a
    candidate near a center take few values, so counts tie between 2, 3 and
    4 of them. Candidates near the centers and at bins 0, 1, fft-2, fft-1;
    the peaks at the edges make those windows vote."""
    rng = np.random.default_rng(seed)
    rows = frames + DEPTH - 1
    hist = np.full((nb, rows, fft), -20.0, dtype=np.float32)
    centers = np.linspace(half + 8, fft - half - 8, 6).astype(int)
    offsets = rng.choice([-6, -3, 0, 3, 6], size=(nb, rows))
    heights = rng.choice([9.0, 10.0, 11.0], size=(nb, rows, len(centers)))
    heights[rng.random(heights.shape) < invalid] = 5.0
    for b, r in np.ndindex(nb, rows):
        hist[b, r, centers + offsets[b, r]] = heights[b, r]
        hist[b, r, [0, 2, fft - 1, fft - 3]] = rng.choice([5.0, 9.0, 10.0], size=4)
    cand = rng.integers(0, fft, size=(nb, frames, 16)).astype(np.int32)
    cand[..., :6] = centers + rng.integers(-4, 5, size=(nb, frames, 6))
    cand[..., 6:10] = [0, 1, fft - 2, fft - 1]
    return torch.from_numpy(hist[:, DEPTH - 1 :]), torch.from_numpy(hist[:, : DEPTH - 1]), torch.from_numpy(cand)


def vote_counts(raw, prev, cand, half, level):
    """The tied count of every candidate with a valid vote: how many values
    share the top count."""
    hist = torch.cat([prev, raw], dim=1).numpy()
    tied = []
    for b, k, c in np.ndindex(*cand.shape):
        i = int(cand[b, k, c])
        lo, hi = max(i - half, 0), min(i + half, hist.shape[2] - 1)
        votes = [lo + int(np.argmax(hist[b, k + h, lo : hi + 1])) for h in range(DEPTH)
                 if hist[b, k + h, lo : hi + 1].max() >= level]
        if votes:
            counts = Counter(votes).values()
            tied.append(sum(n == max(counts) for n in counts))
    return Counter(tied)


def plain(form, *args, monkeypatch):
    monkeypatch.setattr(detect, "VOTE_FORM", form)
    return detect.history_vote_plain(*args)


# -- the CPU: the plain version and the launch arguments ----------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("group", [103, 128, 193, 205, 615])
@pytest.mark.parametrize("rows,bf16", [("f32", False), ("f32", True), ("bf16", False), ("mixed", True)])
def test_wrapper_on_the_cpu_is_the_reference_vote(form, group, rows, bf16, monkeypatch):
    """Every lowering at the int8-code table's width (103), the pair tables'
    (the dongle session's 129, 193, the wideband receiver's 205, and 615),
    f32 and bf16 history, ties and edge windows: the wrapper's CPU route
    equals the reference's rule."""
    monkeypatch.setattr(detect, "VOTE_FORM", form)
    half = group // 2
    raw, prev, cand = tie_scene(2, 6, 2048, half, seed=group)
    if rows == "bf16":
        raw, prev = raw.bfloat16(), prev.bfloat16()
    elif rows == "mixed":
        prev = prev.bfloat16()
    level = torch.tensor(LEVEL)
    before = vote_kernel.history_vote.launches
    got = vote_kernel.history_vote(raw, prev, cand, half, level, DEPTH, bf16)
    assert vote_kernel.history_vote.launches == before  # the plain version counts nothing
    assert got.dtype == torch.int32 and got.shape == cand.shape
    np.testing.assert_array_equal(got.numpy(), reference_vote(raw, prev, cand, half, LEVEL, DEPTH, bf16))
    assert (got != cand).any(), "no vote moved a candidate"


@pytest.mark.parametrize("group", [103, 193, 615])
def test_tie_scene_ties_two_three_and_four_values(group):
    half = group // 2
    raw, prev, cand = tie_scene(2, 6, 2048, half, seed=group)
    tied = vote_counts(raw, prev, cand, half, LEVEL)
    assert all(tied[n] > 0 for n in (1, 2, 3, 4)), tied


@pytest.mark.parametrize("form", FORMS)
def test_no_valid_vote_keeps_the_candidate(form, monkeypatch):
    raw, prev, cand = tie_scene(1, 4, 1024, 51, seed=1)
    level = torch.tensor(50.0)  # above every row
    got = plain(form, raw, prev, cand, 51, level, DEPTH, False, monkeypatch=monkeypatch)
    assert torch.equal(got, cand)


@pytest.mark.parametrize("form", FORMS)
def test_strided_history_on_the_cpu(form, monkeypatch):
    """prev_tail as the scan takes it from the ordered ring (a slice of its
    rows) and as the time-sharded scan does (a slice of the rows before
    the shard); raw as a slice of a longer block: any band and row strides."""
    half, nb, frames, fft = 51, 2, 5, 1024
    raw, prev, cand = tie_scene(nb, frames, fft, half, seed=7)
    ring = torch.full((nb, 21, fft), -30.0)
    ring[:, -(DEPTH - 1) :] = prev
    block = torch.full((nb, frames + 3, fft), -30.0)
    block[:, 2 : 2 + frames] = raw
    want = reference_vote(raw, prev, cand, half, LEVEL, DEPTH, True)
    views = [(block[:, 2 : 2 + frames], ring[:, -(DEPTH - 1) :]), (raw[:1], ring[0][-(DEPTH - 1) :][None])]
    for (r, p), w, c in zip(views, [want, want[:1]], [cand, cand[:1]]):
        assert not p.is_contiguous() or p.shape[0] == 1
        got = vote_kernel.history_vote(r, p, c, half, torch.tensor(LEVEL), DEPTH, True)
        np.testing.assert_array_equal(got.numpy(), w)


def test_launch_arguments_without_a_card():
    """The C entry point's arguments from CPU tensors: pointers, the bf16
    flags, strides in elements, the shape, and the vote's dtype (bf16 where
    asked or where the rows are bf16, as ``cat`` takes prev_tail to them)."""
    nb, frames, fft = 3, 4, 512
    ring = torch.zeros((nb, 21, fft), dtype=torch.bfloat16)
    prev = ring[:, -(DEPTH - 1) :]
    raw = torch.zeros((nb, frames, fft))
    cand = torch.zeros((nb, frames, 80), dtype=torch.int32)
    out = torch.empty_like(cand)
    level = torch.tensor([LEVEL])
    vote_kernel.check_args(raw, prev, cand, 307, DEPTH)
    args = vote_kernel.launch_args(raw, prev, cand, level, out, 307, DEPTH, False)
    assert args == (
        prev.data_ptr(), 1, 21 * fft, fft, raw.data_ptr(), 0, frames * fft, fft, cand.data_ptr(),
        level.data_ptr(), out.data_ptr(), nb, frames, 80, DEPTH, fft, 307, 0,
    )
    assert vote_kernel.launch_args(raw, prev, cand, level, out, 307, DEPTH, True)[-1] == 1
    assert vote_kernel.launch_args(raw.bfloat16(), prev, cand, level, out, 307, DEPTH, False)[-1] == 1
    # one argument a C parameter, and the stream last
    assert len(build.SIGNATURES["history_vote"]) == len(args) + 1


@pytest.mark.parametrize("case", ["dtype", "prev_rows", "bands", "cand_dtype", "cand_layout", "bin_stride", "depth"])
def test_check_args_refuses_what_the_kernel_does_not_take(case):
    nb, frames, fft = 2, 3, 256
    raw, prev = torch.zeros((nb, frames, fft)), torch.zeros((nb, DEPTH - 1, fft))
    cand = torch.zeros((nb, frames, 8), dtype=torch.int32)
    depth = DEPTH
    if case == "dtype":
        raw = raw.half()
    elif case == "prev_rows":
        prev = prev[:, 1:]
    elif case == "bands":
        prev = prev[:1]
    elif case == "cand_dtype":
        cand = cand.long()
    elif case == "cand_layout":
        cand = torch.zeros((nb, 8, frames), dtype=torch.int32).transpose(1, 2)
    elif case == "bin_stride":
        raw = torch.zeros((nb, frames, 2 * fft))[..., ::2]
    elif case == "depth":
        depth, prev = vote_kernel.MAX_DEPTH + 1, torch.zeros((nb, vote_kernel.MAX_DEPTH, fft))
    with pytest.raises(ValueError):
        vote_kernel.check_args(raw, prev, cand, 10, depth)


def test_kernel_source_matches_its_binding():
    """The C entry point takes the binding's parameters, its kernel's name
    holds none of the names the benchmark's readers match by, and the
    launcher returns cudaGetLastError."""
    text = SOURCE.read_text()
    entry = re.search(r'extern "C" int history_vote\(([^)]*)\)', text)
    assert entry is not None
    assert len(entry.group(1).split(",")) == len(build.SIGNATURES["history_vote"])
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", text)
    assert kernels == ["history_vote_kernel"]
    for name in kernels + ["history_vote"]:
        assert not any(part in name for part in ("psd_", "selection_", "fir_decimate", "trace_"))
    assert "cudaGetLastError()" in text and "cudaMalloc" not in text


# -- the card -------------------------------------------------------------------------

# (bands, frames, fft, group): the wideband receiver's block (hf20m48: group
# ceil(32000 / 156.25 Hz) = 205; and 615, the group at the decimated 52 Hz
# frame bin), the dongle session's scan (rtl2m048: ceil(32000 / 250 Hz) =
# 128, a 129-bin window; and 640) and a narrow window (the int8-code table's
# width)
CARD_SHAPES = [(24, 45, 131072, 205), (24, 45, 131072, 615), (1, 16, 8192, 128), (1, 16, 8192, 640),
               (4, 16, 8192, 103)]


def _noise_scene(nb, frames, fft, dev, seed, quantum=None):
    """Rows of noise around 0 dB (3 dB rms) with a band-wide signal near the
    level in band 0, [NB, F, fft] raw and [NB, H-1, fft] prev_tail; values
    rounded to ``quantum`` (ties inside windows); top candidates and the
    edge bins."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = torch.randn((nb, frames + DEPTH - 1, fft), generator=gen, device=dev).mul_(3.0)
    hist[0, :, fft // 3 : fft // 3 + 400] += 6.0
    if quantum is not None:
        hist = torch.round(hist / quantum) * quantum
    cand = torch.randint(0, fft, (nb, frames, 80), generator=gen, device=dev, dtype=torch.int32)
    cand[..., :16] = torch.topk(hist[:, DEPTH - 1 :], 16, dim=-1).indices.to(torch.int32)
    cand[..., 16:20] = torch.tensor([0, 1, fft - 2, fft - 1], dtype=torch.int32, device=dev)
    return hist[:, DEPTH - 1 :], hist[:, : DEPTH - 1], cand


def _hold(dev, raw, prev, cand, half, level, bf16, monkeypatch, forms=FORMS):
    before = vote_kernel.history_vote.launches
    got = vote_kernel.history_vote(raw, prev, cand, half, level, DEPTH, bf16)
    torch.cuda.synchronize()
    assert vote_kernel.history_vote.launches == before + 1
    for form in forms:
        want = plain(form, raw, prev, cand, half, level, DEPTH, bf16, monkeypatch=monkeypatch)
        assert torch.equal(got, want), f"{form}: {int((got != want).sum())} of {got.numel()} votes differ"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}-w{s[3] // 2 * 2 + 1}")
@pytest.mark.parametrize("rows,bf16", [("f32", False), ("f32", True), ("bf16", False), ("bf16", True)])
def test_kernel_equals_every_plain_lowering(shape, rows, bf16, dev, monkeypatch):
    nb, frames, fft, group = shape
    raw, prev, cand = _noise_scene(nb, frames, fft, dev, seed=fft + group)
    if rows == "bf16":
        raw, prev = raw.bfloat16(), prev.bfloat16()
    got = _hold(dev, raw, prev, cand, group // 2, torch.tensor(LEVEL, device=dev), bf16, monkeypatch)
    assert (got != cand).any() and (got == cand).any()


@pytest.mark.cuda
@pytest.mark.parametrize("group", [103, 615])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_on_ties_edges_and_mixed_rows(group, bf16, dev, monkeypatch):
    """The tie scene (2, 3 and 4 values tied at the top count, edge
    windows) and noise quantised to 1/64 dB (ties in f32 and more in bf16
    inside the windows), prev_tail bf16 beside f32 rows and the reverse."""
    half = group // 2
    raw, prev, cand = (t.to(dev) for t in tie_scene(2, 6, 2048, half, seed=group))
    level = torch.tensor(LEVEL, device=dev)
    _hold(dev, raw, prev, cand, half, level, bf16, monkeypatch)
    _hold(dev, raw, prev.bfloat16(), cand, half, level, bf16, monkeypatch)
    _hold(dev, raw.bfloat16(), prev, cand, half, level, bf16, monkeypatch)
    np.testing.assert_array_equal(
        vote_kernel.history_vote(raw, prev, cand, half, level, DEPTH, bf16).cpu().numpy(),
        reference_vote(raw, prev, cand, half, LEVEL, DEPTH, bf16),
    )
    raw, prev, cand = _noise_scene(2, 16, 16384, dev, seed=group, quantum=1 / 64)
    _hold(dev, raw, prev, cand, half, level, bf16, monkeypatch)
    # values that differ in f32 and tie in bf16: 8.0 + k/256 rounds to 8.0
    raw[:, :, 5000:5100] = 8.0 + torch.arange(100, device=dev) % 2 / 256
    cand[:, :, 20] = 5050
    _hold(dev, raw, prev, cand, half, level, bf16, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [103, 615])
def test_kernel_without_a_valid_vote_keeps_the_candidates(group, dev, monkeypatch):
    raw, prev, cand = _noise_scene(2, 16, 8192, dev, seed=3)
    level = torch.tensor(100.0, device=dev)
    got = _hold(dev, raw, prev, cand, group // 2, level, True, monkeypatch)
    assert torch.equal(got, cand)


@pytest.mark.cuda
def test_kernel_reads_strided_history(dev, monkeypatch):
    """prev_tail as the scan passes it (the last H-1 rows of the ordered
    ring: band stride 21 rows), as the time-sharded scan passes it (rows of
    the previous shard's block, one band) and with every other band and
    row of a larger buffer; raw as a slice of a longer block."""
    nb, frames, fft, half = 3, 16, 8192, 307
    raw, prev, cand = _noise_scene(nb, frames, fft, dev, seed=5)
    level = torch.tensor(LEVEL, device=dev)
    want = vote_kernel.history_vote(raw.contiguous(), prev.contiguous(), cand, half, level, DEPTH, True)
    ring = torch.zeros((nb, 21, fft), device=dev)
    ring[:, -(DEPTH - 1) :] = prev
    wide = torch.zeros((2 * nb, 2 * (DEPTH - 1), fft), device=dev)
    wide[::2, ::2] = prev
    block = torch.zeros((nb, frames + 5, fft), device=dev)
    block[:, 3 : 3 + frames] = raw
    shard_rows = torch.zeros((21, fft), device=dev)
    shard_rows[-(DEPTH - 1) :] = prev[0]
    for r, p, c, w in [
        (raw, ring[:, -(DEPTH - 1) :], cand, want),
        (block[:, 3 : 3 + frames], wide[::2, ::2], cand, want),
        (raw[:1], shard_rows[-(DEPTH - 1) :][None], cand[:1].contiguous(), want[:1]),
    ]:
        got = _hold(dev, r, p, c, half, level, True, monkeypatch)
        assert torch.equal(got, w)


@pytest.mark.cuda
def test_cpu_tensors_take_the_plain_version_beside_the_card(dev, monkeypatch):
    raw, prev, cand = tie_scene(2, 5, 2048, 51, seed=9)
    before = vote_kernel.history_vote.launches
    got = vote_kernel.history_vote(raw, prev, cand, 51, torch.tensor(LEVEL), DEPTH, True)
    assert vote_kernel.history_vote.launches == before and got.device.type == "cpu"
    assert torch.equal(got, plain("code", raw, prev, cand, 51, torch.tensor(LEVEL), DEPTH, True,
                                  monkeypatch=monkeypatch))


@pytest.mark.cuda
def test_cuda_tensors_the_kernel_does_not_take_raise(dev):
    raw, prev, cand = _noise_scene(1, 4, 1024, dev, seed=2)
    level = torch.tensor(LEVEL, device=dev)
    before = vote_kernel.history_vote.launches
    for r, p, c in [(raw.half(), prev, cand), (raw, prev.double(), cand), (raw, prev, cand.long()),
                    (torch.zeros((1, 4, 2048), device=dev)[..., ::2], prev, cand)]:
        with pytest.raises(ValueError):
            vote_kernel.history_vote(r, p, c, 51, level, DEPTH, False)
    assert vote_kernel.history_vote.launches == before


@pytest.mark.cuda
def test_compact_detection_on_card_equals_the_cpu(dev):
    """``compact_detection`` at the wideband receiver's window (205 bins),
    bf16 selection over f32 rows: every output of the card's route equals
    the CPU's plain route on the same rows."""
    nb, frames, fft = 2, 16, 16384
    raw, prev, _ = _noise_scene(nb, frames, fft, dev, seed=11)
    gen = torch.Generator(device=dev).manual_seed(12)
    avg = raw + torch.randn(raw.shape, generator=gen, device=dev).mul_(0.5)
    keys = torch.tensor([[fft // 3 + 100, -1, -1, -1], [-1] * 4], dtype=torch.int32, device=dev)
    valid = torch.ones((nb, fft), dtype=torch.bool, device=dev)
    valid[:, :40] = False
    args = [avg, raw, prev, keys, valid, torch.tensor(LEVEL, device=dev)]
    got = detect.compact_detection(*args, 205, 64, bf16=True)
    want = detect.compact_detection(*[a.cpu() for a in args], 205, 64, bf16=True)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w), name
    assert (got.cand_best != got.cand_idx).any()


@pytest.mark.cuda
def test_graphed_step_runs_the_vote_kernel(dev):
    """``drivers.BandedBlocks``' graphed step at the wideband receiver's
    geometry (fft 131072, 45 frames, 2 slots at 32 kHz, the 205-bin vote
    window) on 2 bands: the kernel is launched at the capture, counted once
    a block, and its kernel replays inside ``scan.detection``."""
    import math

    from rtl_sdr_scanner_tpu_torch import drivers
    from rtl_sdr_scanner_tpu_torch.constants import Tunables
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, scan_pipeline

    rate, nb = 20_480_000, 2
    cfg = scan_pipeline.ScanConfig.create(rate, 45, Tunables())
    ddc_cfg = ddc_pipeline.DdcConfig.create(rate, 32_000, 2, cfg.block_samples)
    group = math.ceil(32_000 / cfg.step_hz)
    assert 2 * (group // 2) + 1 == 205
    shifts = np.tile(np.array([[250_000, -3_000_000]], dtype=np.int64), (nb, 1))
    blk = drivers.BandedBlocks(cfg, ddc_cfg, group, 64, nb, shifts, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    iq = torch.randint(-100, 100, (nb, 45, cfg.fft_size * cfg.decimator_factor, 2), dtype=torch.int8,
                       device=dev, generator=gen)
    before = vote_kernel.history_vote.launches
    blk.run_block(0, iq)  # the capture
    torch.cuda.synchronize()
    assert blk.step.captures == 1
    assert vote_kernel.history_vote.launches == before + 1
    graph = blk.step.graphs()[0]
    assert (vote_kernel.history_vote, 1) in graph.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        blk.run_block(1, iq)
        torch.cuda.synchronize()
    assert vote_kernel.history_vote.launches == before + 2
    from torch.autograd import DeviceType

    kernels = sorted((ev.start_ns(), ev.name()) for ev in prof.profiler.kineto_results.events()
                     if ev.device_type() == DeviceType.CUDA)
    names = [name for _, name in kernels]
    votes = [i for i, n in enumerate(names) if "history_vote" in n]
    enter, leave = names.index("trace_enter_scan_detection"), names.index("trace_exit_scan_detection")
    assert len(votes) == 1 and enter < votes[0] < leave
