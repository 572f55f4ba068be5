"""The wideband cell at a small size on the CPU: a 2.048 Msps stream into
8 channels of 256 kHz (fft 1024), added as new files only in a temporary
copy of the benchmark (as ``conftest.py`` adds its small cells), runs
through the loader and ``drivers/wideband.py``; the program agrees with the
plain reference under the cell's own limits; the control fails them; each
planted fault fails them: the bank's tail not carried, two channels
swapped, a recording sample altered, a reported value moved, a reported
vote moved. The vote is judged up to the rows' tolerance and no further.
The traffic repeats by seed and keeps its carriers where the traffic file
says."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark.harness import load_cell, metric_module
from benchmark.reference import scan, vote_ties
from benchmark.reference.channelizer import channel_offsets_hz
from benchmark.reference.scan import Geometry
from benchmark.tests.conftest import ROOT

CELL = "wb163m84.ch8.step"
SMALL = "small_wide.ch8.step"
# a 2.048 Msps front end into 8 channels of conftest's small modulated-taps band
CONFIG = dict(name="small_wide", sample_rate=2048000, channel_rate=256000, fft_size=1024, decimator_factor=5,
              frames_per_block=16, noise_learning_ms=640, recording_rate=4000, ddc_stages=[[1, 64]],
              fir_kernel_stages=[])
# the cell's offsets as shares of a channel's rate: 250 kHz and 9.5 MHz of 20.48 MHz
TRAFFIC = dict(carrier_offsets_hz=[3125, 3125, 118750], slot_shifts_hz=[3125, -7500])
SECONDS = 0.3
SEED = 2**31 + 19


def add_small_wideband(root) -> str:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    base = next(w for w in manifest["workloads"] if w["name"] == CELL)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / f"{base['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{base['traffic']}.json").read_text())
    (bench / "configs" / "small_wide.json").write_text(json.dumps(dict(config, **CONFIG)))
    (bench / "traffic" / "small_wide.json").write_text(json.dumps(dict(traffic, **TRAFFIC)))
    shutil.copy(bench / "cells" / f"{CELL}.json", bench / "cells" / f"{SMALL}.json")
    manifest["configs"].append(dict(name="small_wide", source="https://example.org/small",
                                    file="benchmark/configs/small_wide.json", reduced=[], why="a CPU test's size"))
    manifest["workloads"].append(dict(name=SMALL, config="small_wide", traffic="small_wide", chips=1,
                                      why="a CPU test's size"))
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append(SMALL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return SMALL


@pytest.fixture(scope="module")
def wide_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("wide")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_small_wideband(root)
    return root


def run_cell(root, control=False, trace=False):
    cell = load_cell(root, SMALL)
    return cell.driver().run(cell, SEED, SECONDS, trace, torch.device("cpu"), time.perf_counter(), control=control)


def test_cell_runs_and_agrees_with_the_reference(wide_root):
    out = run_cell(wide_root, control=True)
    limits = load_cell(wide_root, SMALL).spec["limits"]
    assert out.attempted > 0 and set(out.end_to_end) == {"iq_samples_per_s", "step_latency_ms_p95", "setup_s"}
    assert out.correct, out.numbers
    assert set(out.numbers) == set(limits)
    failed = [k for k, limit in limits.items() if out.control[k] > limit]
    assert failed, f"the control passes every limit: {out.control}"


def _per_shard(fn):
    """A WidebandBlocks.run_block that hands fn each (packed, rec) of one shard."""
    from rtl_sdr_scanner_tpu_torch import drivers

    orig = drivers.WidebandBlocks.run_block

    def run_block(self, b, x):
        packed, rec = orig(self, b, x)
        return tuple(map(list, zip(*(fn(p.clone(), r.clone()) for p, r in zip(packed, rec)))))

    return run_block


def tail_dropped():
    from rtl_sdr_scanner_tpu_torch import drivers

    orig = drivers.WidebandBlocks.run_block

    def run_block(self, b, x):
        self.chan = [state._replace(tail=torch.zeros_like(state.tail)) for state in self.chan]
        return orig(self, b, x)

    return run_block


def channels_swapped():
    def swap(packed, rec):
        packed[[1, 2]], rec[[1, 2]] = packed[[2, 1]], rec[[2, 1]]
        return packed, rec

    return _per_shard(swap)


def altered_recording():
    def alter(packed, rec):
        rec[0, 0, 7, 0] = torch.clamp(rec[0, 0, 7, 0].to(torch.int16) + 3, -128, 127).to(torch.int8)
        return packed, rec

    return _per_shard(alter)


def altered_value():
    def alter(packed, rec):
        packed[-1, 64 + 16 + 3] += 0.5  # frame 0's fourth candidate value, last channel
        return packed, rec

    return _per_shard(alter)


def moved_vote():
    def alter(packed, rec):
        n = 64 + scan.K_SEP
        vote = packed[-1, 2 * n + 3]  # frame 0's fourth candidate's vote, last channel
        packed[-1, 2 * n + 3] = vote + 40 if vote < 512 else vote - 40
        return packed, rec

    return _per_shard(alter)


@pytest.mark.parametrize("fault", [tail_dropped, channels_swapped, altered_recording, altered_value, moved_vote],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(wide_root, monkeypatch, fault):
    from rtl_sdr_scanner_tpu_torch import drivers

    monkeypatch.setattr(drivers.WidebandBlocks, "run_block", fault())
    out = run_cell(wide_root)
    assert not out.correct, out.numbers


def test_traffic_repeats_by_seed_and_places_its_carriers(wide_root):
    cell = load_cell(wide_root, SMALL)
    c = cell.config
    geo = Geometry.of(dict(c, sample_rate=c["channel_rate"]))
    make = lambda seed: cell.generator().WideRing(cell.traffic, geo, seed, "cpu")
    a, b, other = make(2**33 + 5), make(2**33 + 5), make(6)
    for ring in (a, b, other):
        ring.key_on()
    assert a.carrier_bands == b.carrier_bands and all(torch.equal(x, y) for x, y in zip(a.ring, b.ring))
    assert not all(torch.equal(x, y) for x, y in zip(a.ring, other.ring))
    assert torch.equal(a.reference_block(0), b.noise(0)) and a.ring[0].shape == (geo.block_samples * 8, 2)
    centres = channel_offsets_hz(8, c["sample_rate"])
    for seed in range(40):
        ring = make(seed) if seed else a
        assert len(set(ring.carrier_bands)) == 3 and ring.carrier_bands[2] != 4  # the edge carrier avoids Nyquist
        assert ring.carrier_hz == [int(centres[ch]) + off for ch, off in zip(ring.carrier_bands,
                                                                              TRAFFIC["carrier_offsets_hz"])]
    peak = max(x.abs().max().item() for x in a.ring)
    assert peak < 127  # three carriers and the noise stay under int8 full scale


def test_roofline_counts_the_published_bank():
    cell = load_cell(ROOT, CELL)
    peaks = metric_module(ROOT, "peaks")
    moved, ops = metric_module(ROOT, "channelize_stage_roofline").work(cell.config, cell.traffic)
    assert moved == 141_557_760 * 10  # 2 B in, 8 B out a sample
    assert ops == 141_557_760 // 8 * (8 * 18 * 4 + 5 * 8 * 3)
    assert round(max(moved / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS) * 1e3, 4) == 0.4226  # bytes bound


def test_readers_find_nothing_without_markers(wide_root):
    out = run_cell(wide_root, trace=True)
    for name in ("stage.channelize.device_ms_per_block", "channelize_stage_roofline"):
        assert metric_module(ROOT, name).read(out.trace) is None
    assert np.isfinite(out.end_to_end["iq_samples_per_s"])


def _rows(*bins):
    """[3, 32] rows at 0 dB but for (row, bin, value) of ``bins``."""
    rows = torch.zeros((3, 32), dtype=torch.float64)
    for r, b, v in bins:
        rows[r, b] = v
    return rows


def test_vote_ties_accepts_a_flip_within_the_tolerance_only():
    half, level, tol = 8, 8.0, 4e-3
    # bfloat16 steps are 1/32 below 8 and 1/16 above: 8 - 1/64 and 10 + 1/32 are rounding boundaries
    under = _rows((1, 20, 8.0 - 1 / 64 - 1e-4))  # rounds under the level: no row votes, the vote is the candidate
    adm = lambda rows, vote, t=tol: vote_ties.admissible(rows, 16, half, level, "bfloat16", t, vote)
    assert adm(under, 16) and adm(under, 20) and not adm(under, 20, 0.0) and not adm(under, 22)
    assert not adm(_rows((1, 20, 8.0 - 1 / 64 - 1e-2)), 20)  # a row farther from the boundary than the tolerance
    tie = _rows((0, 12, 10.0), (0, 19, 10.0 + 1 / 32 - 1e-4), (1, 12, 10.0), (2, 19, 12.0))
    want = scan.vote(scan.rounded(tie[None], "bfloat16"), torch.tensor([[[16]]]), half, level)
    assert int(want) == 12  # rows 0 and 1 vote 12 (the first of row 0's tied bins), row 2 votes 19
    assert adm(tie, 12) and adm(tie, 19) and not adm(tie, 19, 0.0) and not adm(tie, 13)


def test_vote_gap_reads_the_distance_of_a_vote_it_does_not_accept():
    half, level = 8, 8.0
    hist = _rows((0, 12, 10.0), (1, 12, 10.0), (2, 19, 12.0))[None]  # [1, H, fft], one frame
    det = scan.Detections(cand_idx=torch.tensor([[[16]]]), cand_val=None, cand_best=torch.tensor([[[19]]]),
                          cand_count=None, key_val=None, key_idx=None, ready=None)
    assert vote_ties.vote_gap(det, hist, half, level, "bfloat16", 4e-3) == 7.0
    assert vote_ties.vote_gap(det._replace(cand_best=torch.tensor([[[12]]])), hist, half, level, "bfloat16",
                              4e-3) == 0.0
