"""A small session cell on the CPU, added as new files only: it runs
through the loader, its payloads agree with the plain reference, and the
control and each fault a session can have come out not correct."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import load_cell
from benchmark.tests.conftest import ROOT, SESSION_CELL

CELL = "small_session.busy"
SECONDS = 0.6


def run_cell(root, control=False, trace=False):
    cell = load_cell(root, CELL)
    return cell.driver().run(cell, 2**31 + 13, SECONDS, trace, torch.device("cpu"), time.perf_counter(),
                             control=control)


def limits():
    return load_cell(ROOT, SESSION_CELL).spec["limits"]


def test_session_runs_and_agrees_with_the_reference(small_root):
    out = run_cell(small_root, control=True)
    assert out.attempted > 0 and set(out.end_to_end) == {"session_rtf", "session_latency_ms_p95", "setup_s"}
    assert out.correct, out.numbers
    for key, limit in limits().items():
        assert out.numbers[key] <= limit, (key, out.numbers[key], limit)
    failed = [k for k, limit in limits().items() if out.control.get(k, 0.0) > limit]
    assert failed, f"the control passes every limit: {out.control}"


def test_session_trace_reads_the_session_ranges(small_root):
    out = run_cell(small_root, trace=True)
    cell = load_cell(small_root, CELL)
    t = out.trace
    assert t.blocks == out.attempted and any(name.startswith("session.tracker") for name, _, _ in t.host)
    host = cell.readers["session.host_ms_per_block"](t)
    tracker = cell.readers["session.tracker_ms_per_block"](t)
    assert 0 < tracker < host
    assert cell.readers["device.idle_pct.session"](t) is None  # no device on the CPU


def ddc_state_unchanged(sdr):
    orig = sdr.SdrDevice._run_ddc

    def run_ddc(self, iq_dev, block_start_ms):
        before = self._ddc_state
        orig(self, iq_dev, block_start_ms)
        self._ddc_state = before
    return "_run_ddc", run_ddc


def half_the_slots(sdr):
    orig = sdr.SdrDevice.ingest_ddc_out

    def ingest(self, out_np, block_start_ms, only_slots=None):
        out = out_np.copy()
        half = out.shape[0] // 2
        out[half:] = out[: out.shape[0] - half]
        return orig(self, out, block_start_ms, only_slots)
    return "ingest_ddc_out", ingest


def altered_recording(sdr):
    orig = sdr.SdrDevice.ingest_ddc_out

    def ingest(self, out_np, block_start_ms, only_slots=None):
        out = out_np.copy()
        out[:, -7, 0] = np.clip(out[:, -7, 0].astype(np.int16) + 3, -128, 127).astype(np.int8)
        return orig(self, out, block_start_ms, only_slots)
    return "ingest_ddc_out", ingest


def altered_spectrogram(sdr):
    orig = sdr.SdrDevice._send_container

    def send(self, container, center, now_ms):
        container.sum[5] += 2.0 * container.counter
        return orig(self, container, center, now_ms)
    return "_send_container", send


@pytest.mark.parametrize("fault", [ddc_state_unchanged, half_the_slots, altered_recording, altered_spectrogram],
                         ids=lambda f: f.__name__)
def test_session_fault_is_not_correct(small_root, monkeypatch, fault):
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

    name, patched = fault(sdr_device)
    monkeypatch.setattr(sdr_device.SdrDevice, name, patched)
    out = run_cell(small_root)
    assert not out.correct, out.numbers


def test_session_capture_repeats_by_seed(small_root):
    cell = load_cell(small_root, CELL)
    make = lambda seed: cell.generator().SessionCapture(cell.traffic, cell.config, seed, "cpu", 163840)
    a, b, c = make(2**33 + 5), make(2**33 + 5), make(6)
    assert np.array_equal(a.iq, b.iq) and not np.array_equal(a.iq, c.iq)
    assert [t.shift_hz for t in a.transmitters] == [t.shift_hz for t in b.transmitters]
    # every seed keys the same set of on-intervals, in another order
    assert sorted(iv for t in a.transmitters for iv in t.intervals) == sorted(iv for t in c.transmitters for iv in t.intervals)
    assert a.iq.shape[0] % 163840 == 0 and np.abs(a.iq.astype(np.int16)).max() < 127
