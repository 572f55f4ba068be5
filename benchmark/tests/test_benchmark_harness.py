"""The harness at small sizes on the CPU: cells added as new files only run
through the loader; the plain reference agrees with the program's plain
path; the control and each fault a block step can have come out not
correct; the generators repeat by seed; the roofline counts give the
kernel table's bounds."""

import json
import time

import pytest
import torch

from benchmark.harness import load_cell, metric_module
from benchmark.tests.conftest import BASE_CELL, ROOT, SMALL
from benchmark.trace import Tracer

CELLS = [f"{name}.step" for name in SMALL]
SECONDS = 0.3


def run_cell(root, name, control=False, trace=False):
    cell = load_cell(root, name)
    return cell.driver().run(cell, 2**31 + 11, SECONDS, trace, torch.device("cpu"), time.perf_counter(),
                             control=control)


def limits():
    return json.loads((ROOT / "benchmark" / "cells" / f"{BASE_CELL}.json").read_text())["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_new_cell_runs_and_agrees_with_the_reference(small_root, name):
    out = run_cell(small_root, name, control=True)
    assert out.attempted > 0 and set(out.end_to_end) == {"iq_samples_per_s", "step_latency_ms_p95", "setup_s"}
    assert out.correct, out.numbers
    for key, limit in limits().items():
        assert out.numbers[key] <= limit, (key, out.numbers[key], limit)
    failed = [k for k, limit in limits().items() if out.control[k] > limit]
    assert failed, f"the control passes every limit: {out.control}"


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    items = [_clone(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def state_unchanged(orig):
    def run_block(self, b, iq):
        self.__dict__.setdefault("_first", _clone(self.state))
        self.state = _clone(self._first)
        return orig(self, b, iq)
    return run_block


def half_batch(orig):
    def run_block(self, b, iq):
        outs = orig(self, b, iq)
        nb = outs.packed.shape[0]
        packed, rec = outs.packed.clone(), outs.recording.clone()
        packed[nb // 2:], rec[nb // 2:] = packed[: nb - nb // 2], rec[: nb - nb // 2]
        return outs._replace(packed=packed, recording=rec)
    return run_block


def altered_recording(orig):
    def run_block(self, b, iq):
        outs = orig(self, b, iq)
        rec = outs.recording.clone()
        rec[0, 0, 7, 0] = torch.clamp(rec[0, 0, 7, 0].to(torch.int16) + 3, -128, 127).to(torch.int8)
        return outs._replace(recording=rec)
    return run_block


def altered_value(orig):
    def run_block(self, b, iq):
        outs = orig(self, b, iq)
        packed = outs.packed.clone()
        packed[-1, 64 + 16 + 3] += 0.5  # frame 0's fourth candidate value, last band
        return outs._replace(packed=packed)
    return run_block


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, altered_recording, altered_value],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(small_root, monkeypatch, name, fault):
    from rtl_sdr_scanner_tpu_torch import drivers

    monkeypatch.setattr(drivers.BandedBlocks, "run_block", fault(drivers.BandedBlocks.run_block))
    out = run_cell(small_root, name)
    assert not out.correct, out.numbers


def test_generator_repeats_by_seed(small_root):
    cell = load_cell(small_root, CELLS[0])
    from benchmark.reference.scan import Geometry

    geo = Geometry.of(cell.config)
    make = lambda seed: cell.generator().StepRing(cell.traffic, geo, seed, "cpu")
    a, b, c = make(2**33 + 5), make(2**33 + 5), make(6)
    for ring in (a, b, c):
        ring.key_on()
    assert a.carrier_bands == b.carrier_bands
    assert all(torch.equal(x, y) for x, y in zip(a.ring, b.ring))
    assert not all(torch.equal(x, y) for x, y in zip(a.ring, c.ring))
    assert torch.equal(a.reference_block(0), b.noise(0))


def test_roofline_counts_give_the_kernel_tables_bounds():
    cell = load_cell(ROOT, BASE_CELL)
    peaks = metric_module(ROOT, "peaks")
    bound_ms = lambda m: max(m[0] / peaks.HBM_BYTES_PER_S, m[1] / peaks.F32_FLOPS) * 1e3
    psd = metric_module(ROOT, "psd_kernel_roofline").work(cell.config, cell.traffic)
    sel = metric_module(ROOT, "select_kernel_roofline").work(cell.config, cell.traffic)
    assert round(bound_ms(psd), 4) == 0.2535  # 1080 x 131072
    assert round(bound_ms(sel), 4) == 0.0847


def test_trace_reduces_on_the_cpu(small_root):
    out = run_cell(small_root, CELLS[1], trace=True)
    t = out.trace
    assert t.blocks == out.attempted and len(t.host_ms) == t.blocks and t.window_s > 0
    assert any(name == "bench.dispatch" for name, _, _ in t.host)
    assert t.device == [] and metric_module(ROOT, "step.device_ms_per_block").read(t) is None
    assert set(t.breakdown()) == {"device_ops", "idle_gaps"}


def test_tracer_off_is_free():
    with Tracer(False, False) as t:
        with t.window():
            pass
    assert t.prof is None


class FakeEvent:
    def __init__(self, name, cuda):
        self._name, self._cuda = name, cuda

    def name(self):
        return self._name

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._cuda else DeviceType.CPU


def test_event_kinds_without_activity_type():
    from benchmark.trace import _kind

    notes = {"bench.window", "scan.psd"}
    assert _kind(FakeEvent("bench.window", False), notes) == "user_annotation"
    assert _kind(FakeEvent("aten::mm", False), notes) == "cpu_op"
    assert _kind(FakeEvent("Memcpy DtoH (Device -> Pinned)", True), notes) == "gpu_memcpy"
    assert _kind(FakeEvent("Memset (Device)", True), notes) == "gpu_memset"
    assert _kind(FakeEvent("scan.psd", True), notes) == "gpu_user_annotation"
    assert _kind(FakeEvent("void psd_onchip<17>(signed char const*)", True), notes) == "kernel"
