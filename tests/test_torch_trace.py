"""The port's span primitive (``utils/trace.py``) on the CPU: each span is
the profiler range it always was and launches nothing outside a capture;
inside one (a capturing stream stood in for here, the kernel library by a
recorder) it writes its stage's enter and exit markers around the body,
for every span a graphed step opens, the DDC's stage 1 nested in ``ddc``
once a chunk; a span without a marker raises there; the markers' table is
the kernel file's list, and no marker's name is one the benchmark's
rooflines, or the stage-1 span's check on the card, select kernels by."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu_torch.constants import Tunables
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, fused_step, scan_pipeline
from rtl_sdr_scanner_tpu_torch.ops import ddc as ddc_ops
from rtl_sdr_scanner_tpu_torch.ops.cuda import build
from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan
from rtl_sdr_scanner_tpu_torch.runtime import sdr_device
from rtl_sdr_scanner_tpu_torch.utils import trace

PKG = Path(trace.__file__).resolve().parents[1]
SLOTS = 2
# the substrings the benchmark's roofline readers select kernels by
ROOFLINE_PARTS = ("psd_", "selection_", "fir_decimate")
# and the stage-1 kernel's, which the card's test finds inside ``ddc.stage1``
KERNEL_PARTS = ROOFLINE_PARTS + ("modtap",)
STAGE1 = [("enter", "ddc.stage1"), ("exit", "ddc.stage1")]


class Recorder:
    """The kernel library's marker entry points, recording each launch."""

    def __init__(self):
        self.launched = []

    def trace_mark(self, mark_id, stream):
        self.launched.append(mark_id)
        return 0


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for outside a capture")

    monkeypatch.setattr(build, "library", refuse)


@pytest.fixture
def capturing(monkeypatch):
    """Every span runs as if its stream were capturing; returns the
    markers launched, as (edge, span name)."""
    lib = Recorder()
    monkeypatch.setattr(trace, "_capturing_stream", lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(build, "library", lambda: lib)

    def marks():
        return [(trace.EDGES[i % 2], trace.MARKED[i // 2]) for i in lib.launched]

    return marks


def _fused_step_args(cfg, ddc):
    fft = cfg.fft_size
    return (
        scan_pipeline.init_scan_state(cfg, 1, 0, device="cpu"),
        scan_pipeline.init_spectro_acc(cfg, 1, device="cpu"),
        ddc_pipeline.init_state(ddc, 1, device="cpu"),
        torch.zeros((1, 2, fft * cfg.decimator_factor, 2), dtype=torch.int8),
        torch.zeros((1, 2), dtype=torch.int32),
        torch.full((4,), -1, dtype=torch.int32),
        torch.ones(fft, dtype=torch.bool),
        torch.tensor(8.0),
        torch.tensor(1.0),
        ddc_pipeline.make_tables(ddc, np.zeros((1, SLOTS), dtype=np.int64), device="cpu"),
    )


def _fused_step():
    cfg = scan_pipeline.ScanConfig.create(256_000, 2, Tunables())
    ddc = ddc_pipeline.DdcConfig.create(256_000, 16000, SLOTS, cfg.block_samples)
    return fused_step.make_banded_fused_step(cfg, ddc, 64, 8, device="cpu"), _fused_step_args(cfg, ddc)


def _opened(body) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    return [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)]


@pytest.mark.parametrize("name", fused_step.STAGES + sharded_scan.STAGES + sdr_device.STAGES)
def test_span_is_its_profiler_range_and_launches_nothing_on_the_cpu(name, no_library):
    def body():
        with trace.span(name):
            torch.ones(3).sum()

    assert name in _opened(body)


def test_fused_step_opens_the_same_ranges_and_launches_nothing(no_library):
    step, args = _fused_step()
    opened = [n for n in _opened(lambda: step(*args)) if n in fused_step.STAGES]
    assert opened == list(fused_step.STAGES)


def test_captured_fused_step_marks_each_stage_in_order(capturing):
    step, args = _fused_step()
    opened = [n for n in _opened(lambda: step(*args)) if n in fused_step.STAGES]
    assert opened == list(fused_step.STAGES)
    want = [(edge, name) for name in fused_step.STAGES for edge in trace.EDGES]
    assert capturing() == want[:-1] + STAGE1 + want[-1:]  # the step's one DDC chunk


def test_captured_session_ddc_step_marks_ddc(capturing):
    cfg = ddc_pipeline.DdcConfig.create(256_000, 16000, SLOTS, 1 << 13)
    step = ddc_pipeline.make_ddc_step(cfg, device="cpu")
    state = ddc_pipeline.init_state(cfg, device="cpu")
    tables = ddc_pipeline.make_tables(cfg, np.array([1000, -2000], dtype=np.int64), device="cpu")
    _, rec = step(state, torch.zeros((1 << 13, 2), dtype=torch.int8), tables)
    assert rec.shape == (SLOTS, cfg.out_per_block, 2)
    assert capturing() == [("enter", "ddc"), *STAGE1, ("exit", "ddc")]


@pytest.mark.parametrize("chunks", [1, 4])
def test_captured_ddc_marks_stage1_once_a_chunk_inside_ddc(capturing, chunks):
    cfg = ddc_pipeline.DdcConfig.create(256_000, 16000, SLOTS, 1 << 13, chunk_target=(1 << 13) // chunks)
    assert cfg.modtap and cfg.num_chunks == chunks
    step = ddc_pipeline.make_ddc_step(cfg, device="cpu")
    state = ddc_pipeline.init_state(cfg, device="cpu")
    tables = ddc_pipeline.make_tables(cfg, np.array([1000, -2000], dtype=np.int64), device="cpu")
    step(state, torch.zeros((1 << 13, 2), dtype=torch.int8), tables)
    assert capturing() == [("enter", "ddc"), *STAGE1 * chunks, ("exit", "ddc")]


def test_nested_spans_mark_inside_out(capturing):
    with trace.span("ddc"):
        with trace.span("channelize"):
            pass
    assert capturing() == [("enter", "ddc"), ("enter", "channelize"), ("exit", "channelize"), ("exit", "ddc")]


@pytest.mark.parametrize("name", ["scan.unknown", "session.scan", "DDC"])
def test_a_span_without_a_marker_raises_when_captured(name, capturing):
    with pytest.raises(ValueError, match="no marker kernel"):
        with trace.span(name):
            pass
    assert capturing() == []


def test_a_failing_body_leaves_its_exit_unmarked(capturing):
    with pytest.raises(RuntimeError):
        with trace.span("scan.pack"):
            raise RuntimeError("capture ended")
    assert capturing() == [("enter", "scan.pack")]


def _span_names(path: Path) -> set:
    return set(re.findall(r'\bspan\(\s*"([^"]+)"', path.read_text()))


@pytest.mark.parametrize("module", [fused_step, scan_pipeline, ddc_pipeline, sharded_scan, ddc_ops],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_span_a_step_opens_has_a_marker(module):
    names = _span_names(Path(module.__file__))
    assert names and names <= set(trace.MARKED), names - set(trace.MARKED)


def test_the_declared_stages_have_markers_and_the_session_ranges_none():
    assert set(fused_step.STAGES) | set(sharded_scan.STAGES) <= set(trace.MARKED)
    assert not set(sdr_device.STAGES) & set(trace.MARKED)
    assert _span_names(Path(sdr_device.__file__)) == set(sdr_device.STAGES)


def test_marker_table_is_the_kernel_files_list():
    source = (PKG / "csrc" / "trace_marks.cu").read_text()
    block = re.search(r"#define TRACE_MARKS\(X\)(.*?)\n\n", source, re.S).group(1)
    assert re.findall(r"X\((\w+)\)", block) == [n.replace(".", "_") for n in trace.MARKED]
    assert {"trace_mark", "trace_marks_load", "trace_mark_count"} <= set(build.SIGNATURES)


@pytest.mark.parametrize("name", trace.MARKED)
def test_marker_names_hold_no_roofline_kernels_name(name):
    for edge in trace.EDGES:
        marker = trace.marker_name(name, edge)
        assert re.fullmatch(r"trace_(enter|exit)_\w+", marker) and "." not in marker
        assert not any(part in marker for part in KERNEL_PARTS), marker


def test_marker_names_are_distinct():
    names = [trace.marker_name(n, e) for n in trace.MARKED for e in trace.EDGES]
    assert len(set(names)) == len(names) == 2 * len(trace.MARKED)


def test_only_the_trace_module_imports_record_function():
    importers = sorted(
        str(p.relative_to(PKG)) for p in PKG.rglob("*.py") if "record_function" in p.read_text()
    )
    assert importers == ["utils/trace.py"]
