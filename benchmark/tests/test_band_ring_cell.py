"""The direct-sampling cell at a small size on the CPU: one 512 kHz band
(fft 2048) recorded by 4 slots at 4 kHz through DDC stages (1, 8) and
(1, 16), as ``ds491m52``'s stage 1 at M 8 and its first FIR stage, with
3 FM carriers from ``traffic/band_ring.py``; added as new files only in a
temporary copy of the benchmark (as ``conftest.py`` adds its small cells),
it runs through the loader and the step driver; the program agrees with
the plain reference under the cell's own limits; the control fails them;
each planted fault fails them: the DDC's carried filter history dropped,
two slots swapped, a recording sample altered. The generator puts its
carriers at their offsets and repeats by seed. The stage-1 reader reads a
span nested in ``ddc`` a chunk at a time, and None without its markers."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark.harness import load_cell, metric_module
from benchmark.reference.scan import Geometry
from benchmark.tests.conftest import ROOT
from benchmark.trace import Reduced

CELL = "ds491m52.band1.step"
SMALL = "small_band.band1.step"
CONFIG = dict(name="small_band", sample_rate=512000, fft_size=2048, decimator_factor=5, frames_per_block=16,
              noise_learning_ms=640, recording_rate=4000, slots_per_band=4, ddc_stages=[[1, 8], [1, 16]],
              fir_kernel_stages=[[1, 16]])
TRAFFIC = dict(carrier_offsets_hz=[-150000, 37500, 162500], slot_shifts_hz=[-150000, 37500, 162500, -200000])
SECONDS = 0.3
SEED = 2**31 + 27
MS = 1_000_000  # ns


def add_small_band(root) -> str:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    base = next(w for w in manifest["workloads"] if w["name"] == CELL)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / f"{base['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{base['traffic']}.json").read_text())
    (bench / "configs" / "small_band.json").write_text(json.dumps(dict(config, **CONFIG)))
    (bench / "traffic" / "small_band.json").write_text(json.dumps(dict(traffic, **TRAFFIC)))
    shutil.copy(bench / "cells" / f"{CELL}.json", bench / "cells" / f"{SMALL}.json")
    manifest["configs"].append(dict(name="small_band", source="https://example.org/small",
                                    file="benchmark/configs/small_band.json", reduced=[], why="a CPU test's size"))
    manifest["workloads"].append(dict(name=SMALL, config="small_band", traffic="small_band", chips=1,
                                      why="a CPU test's size"))
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append(SMALL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return SMALL


@pytest.fixture(scope="module")
def band_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("band")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_small_band(root)
    return root


def run_cell(root, control=False, trace=False):
    cell = load_cell(root, SMALL)
    return cell.driver().run(cell, SEED, SECONDS, trace, torch.device("cpu"), time.perf_counter(), control=control)


def test_cell_runs_and_agrees_with_the_reference(band_root):
    cell = load_cell(band_root, SMALL)
    assert cell.spec["driver"] == "step" and cell.traffic["generator"] == "band_ring"
    out = run_cell(band_root, control=True)
    limits = cell.spec["limits"]
    assert out.attempted > 0 and set(out.end_to_end) == {"iq_samples_per_s", "step_latency_ms_p95", "setup_s"}
    assert out.correct, out.numbers
    assert set(out.numbers) == set(limits)
    failed = [k for k, limit in limits.items() if out.control[k] > limit]
    assert failed, f"the control passes every limit: {out.control}"


def ddc_history_dropped(orig):
    def run_block(self, b, iq):
        ddc = self.state[2]
        self.state[2] = ddc._replace(x_tail=torch.zeros_like(ddc.x_tail),
                                     tails=tuple(torch.zeros_like(t) for t in ddc.tails))
        return orig(self, b, iq)
    return run_block


def slots_swapped(orig):
    def run_block(self, b, iq):
        outs = orig(self, b, iq)
        rec = outs.recording.clone()
        rec[:, [0, 3]] = rec[:, [3, 0]]
        return outs._replace(recording=rec)
    return run_block


def altered_recording(orig):
    def run_block(self, b, iq):
        outs = orig(self, b, iq)
        rec = outs.recording.clone()
        rec[0, 2, 5, 1] = torch.clamp(rec[0, 2, 5, 1].to(torch.int16) + 3, -128, 127).to(torch.int8)
        return outs._replace(recording=rec)
    return run_block


@pytest.mark.parametrize("fault", [ddc_history_dropped, slots_swapped, altered_recording], ids=lambda f: f.__name__)
def test_fault_is_not_correct(band_root, monkeypatch, fault):
    from rtl_sdr_scanner_tpu_torch import drivers

    monkeypatch.setattr(drivers.BandedBlocks, "run_block", fault(drivers.BandedBlocks.run_block))
    out = run_cell(band_root)
    assert not out.correct, out.numbers
    assert out.numbers["rec_excess_lsb"] > load_cell(band_root, SMALL).spec["limits"]["rec_excess_lsb"]


def test_carriers_land_at_their_offsets_and_repeat_by_seed(band_root):
    cell = load_cell(band_root, SMALL)
    geo = Geometry.of(cell.config)
    make = lambda seed: cell.generator().StepRing(cell.traffic, geo, seed, "cpu")
    a, b, other = make(2**33 + 5), make(2**33 + 5), make(6)
    assert torch.equal(a.reference_block(0), b.noise(0)) and not torch.equal(a.noise(0), other.noise(0))
    for ring in (a, b, other):
        ring.key_on()
    assert all(torch.equal(x, y) for x, y in zip(a.ring, b.ring))
    assert a.ring[0].shape == (1, geo.frames, geo.fft * geo.decim, 2) and a.carrier_bands == [0]
    assert a.shifts.tolist() == [TRAFFIC["slot_shifts_hz"]]
    x = a.ring[1].reshape(-1, 2).to(torch.float64)
    spec = torch.fft.fft(torch.complex(x[:, 0], x[:, 1])).abs() ** 2
    hz = torch.fft.fftfreq(spec.numel(), 1.0 / geo.rate)
    power = (cell.traffic["carrier_amplitude"] * 127) ** 2 * spec.numel() ** 2  # a carrier's, by Parseval
    for f in TRAFFIC["carrier_offsets_hz"]:  # each carrier's +-(deviation + 2 tones) holds its power
        near = (hz - f).abs() <= cell.traffic["deviation_hz"] + 2 * cell.traffic["tone_hz"]
        assert 0.95 * power < spec[near].sum() < 1.05 * power
    assert max(r.abs().max().item() for r in a.ring) < 127


def test_the_cells_traffic_fits_its_band():
    cell = load_cell(ROOT, CELL)
    t, rate = cell.traffic, cell.config["sample_rate"]
    assert len(t["slot_shifts_hz"]) == cell.config["slots_per_band"] and t["bands"] == 1
    assert t["slot_shifts_hz"][: len(t["carrier_offsets_hz"])] == t["carrier_offsets_hz"]
    for f in t["carrier_offsets_hz"] + t["slot_shifts_hz"]:
        assert f % 12500 == 0 and 2 * abs(f) < rate - 2 * 4e6 and abs(f) > 4e6  # on the raster, off DC and the edges
    # the carriers and the noise stay under int8 full scale
    assert len(t["carrier_offsets_hz"]) * t["carrier_amplitude"] + 6 * t["noise_rms"] < 1.0


def _stage1_trace(blocks: int, chunks: int) -> Reduced:
    """A replayed block of 0.8 ms: ``ddc`` from 0.1 ms, then ``chunks``
    stage-1 spans of 2 us in it, each followed by 2 us of later stages."""
    kernels = []
    for b in range(blocks):
        t = b * 800_000
        kernels.append(("trace_enter_ddc", t + 90_000, t + 100_000))
        for c in range(chunks):
            s = t + 100_000 + c * 5_000
            kernels += [("trace_enter_ddc_stage1", s, s + 500), ("modtap_stage1_kernel", s + 500, s + 2_500),
                        ("trace_exit_ddc_stage1", s + 2_500, s + 3_000), ("fir_decimate_kernel", s + 3_000, s + 5_000)]
        end = t + 100_000 + chunks * 5_000
        kernels.append(("trace_exit_ddc", end, end + 500))
    device = [(s, e) for _, s, e in kernels]
    return Reduced(window=(0, blocks * 800_000), kernels=kernels, device=device, host=[], blocks=blocks)


def test_stage1_reader_sums_the_nested_span_a_block():
    read = metric_module(ROOT, "stage.ddc_stage1.device_ms_per_block").read
    ddc = metric_module(ROOT, "stage.ddc.device_ms_per_block").read
    trace = _stage1_trace(blocks=2, chunks=128)
    assert read(trace) == pytest.approx(128 * 2_000 / MS)
    assert ddc(trace) == pytest.approx(128 * 5_000 / MS)
    bare = _stage1_trace(blocks=2, chunks=128)
    bare.kernels = [k for k in bare.kernels if "stage1" not in k[0] or "modtap" in k[0]]
    assert read(bare) is None and ddc(bare) == pytest.approx(128 * 5_000 / MS)
    bare.kernels = [k for k in bare.kernels if not k[0].startswith("trace_")]
    assert read(bare) is None and ddc(bare) is None


def test_stage1_reader_finds_nothing_on_the_cpu(band_root):
    out = run_cell(band_root, trace=True)
    assert metric_module(ROOT, "stage.ddc_stage1.device_ms_per_block").read(out.trace) is None
    assert np.isfinite(out.end_to_end["iq_samples_per_s"])
