"""The stage readers (``metrics/stage_marks.py`` and the nine metrics on it)
on synthetic traced windows: back-to-back and nested spans, a pair the
window's edge cuts, a stage opened twice in itself, no markers at all; and
on a CPU cell's traced run, where every one of them reads None."""

import pytest

from benchmark.harness import load_cell, metric_module
from benchmark.tests.conftest import BASE_CELL, ROOT, SESSION_CELL, SMALL
from benchmark.tests.test_benchmark_harness import run_cell
from benchmark.trace import Reduced

STAGES = {
    "stage.psd.device_ms_per_block": "scan.psd",
    "stage.noise.device_ms_per_block": "scan.noise",
    "stage.averager.device_ms_per_block": "scan.averager",
    "stage.smoothing.device_ms_per_block": "scan.smoothing",
    "stage.detection.device_ms_per_block": "scan.detection",
    "stage.spectrogram.device_ms_per_block": "scan.spectrogram",
    "stage.pack.device_ms_per_block": "scan.pack",
    "stage.ddc.device_ms_per_block": "ddc",
}
UNSTAGED = "graph.unstaged_device_ms_per_block"
NEW = list(STAGES) + [UNSTAGED]
MS = 1_000_000  # ns


def marks():
    return metric_module(ROOT, "stage_marks")


def reduced(kernels, copies=(), blocks=1, window=(0, 1000 * MS)):
    """A traced window of ``kernels`` (name, start ms, end ms) and device
    copies (start ms, end ms)."""
    ks = [(n, int(s * MS), int(e * MS)) for n, s, e in kernels]
    device = [(s, e) for _, s, e in ks] + [(int(s * MS), int(e * MS)) for s, e in copies]
    return Reduced(window=window, kernels=ks, device=device, host=[], blocks=blocks)


def read(name, trace):
    return metric_module(ROOT, name).read(trace)


# one block: copies in, psd and noise back to back, then the DDC with a
# channelizer nested in it, a gap of 1 ms inside the DDC, a copy out
BLOCK = [
    ("trace_enter_scan_psd", 1, 2), ("void psd_cluster<17>(signed char const*)", 2, 7), ("trace_exit_scan_psd", 7, 8),
    ("trace_enter_scan_noise", 8, 9), ("elementwise", 9, 12), ("trace_exit_scan_noise", 12, 13),
    ("trace_enter_ddc", 13, 14), ("trace_enter_channelize", 14, 15), ("gemm", 15, 20),
    ("trace_exit_channelize", 20, 21), ("fir_decimate_kernel", 22, 25), ("trace_exit_ddc", 25, 26),
]
COPIES = [(0, 1), (26, 28)]


def test_back_to_back_and_nested_spans():
    t = reduced(BLOCK, COPIES)
    found = marks().intervals(t)
    assert found == {"scan_psd": [(2 * MS, 7 * MS)], "scan_noise": [(9 * MS, 12 * MS)],
                     "channelize": [(15 * MS, 20 * MS)], "ddc": [(14 * MS, 25 * MS)]}
    assert read("stage.psd.device_ms_per_block", t) == pytest.approx(5)
    assert read("stage.noise.device_ms_per_block", t) == pytest.approx(3)
    assert read("stage.ddc.device_ms_per_block", t) == pytest.approx(11)  # its 1 ms gap included
    assert read("stage.averager.device_ms_per_block", t) is None  # no markers of its own
    # busy 27 ms (0-28 less the DDC's gap 21-22), 18 of it inside a stage
    assert read(UNSTAGED, t) == pytest.approx(9)  # the copies and the outer spans' markers


def test_stages_and_unstaged_add_up_to_the_busy_time_a_block():
    blocks = 3
    kernels = [(n, s + 30 * b, e + 30 * b) for b in range(blocks) for n, s, e in BLOCK]
    copies = [(s + 30 * b, e + 30 * b) for b in range(blocks) for s, e in COPIES]
    t = reduced(kernels, copies, blocks=blocks)
    outer = sum(read(m, t) or 0.0 for m in STAGES) + read(UNSTAGED, t)
    gaps_in_stages = 1.0  # the DDC's, a block
    assert outer == pytest.approx(t.busy_s * 1e3 / blocks + gaps_in_stages)


def test_pairs_the_window_cuts_are_dropped():
    # the window opens inside a psd span (its enter outside) and closes
    # inside a pack span (its exit outside)
    kernels = [("trace_exit_scan_psd", 0, 1), ("trace_enter_scan_psd", 2, 3), ("k", 3, 5),
               ("trace_exit_scan_psd", 5, 6), ("trace_enter_scan_pack", 7, 8), ("k", 8, 10)]
    t = reduced(kernels)
    assert marks().intervals(t) == {"scan_psd": [(3 * MS, 5 * MS)]}
    assert read("stage.psd.device_ms_per_block", t) == pytest.approx(2)
    assert read("stage.pack.device_ms_per_block", t) is None


def test_a_stage_nested_in_itself_pairs_inside_out_and_counts_once():
    kernels = [("trace_enter_ddc", 0, 1), ("trace_enter_ddc", 2, 3), ("k", 3, 4), ("trace_exit_ddc", 4, 5),
               ("trace_exit_ddc", 6, 7)]
    t = reduced(kernels)
    assert marks().intervals(t) == {"ddc": [(3 * MS, 4 * MS), (1 * MS, 6 * MS)]}
    assert read("stage.ddc.device_ms_per_block", t) == pytest.approx(5)


@pytest.mark.parametrize("name", NEW)
def test_no_markers_read_none(name):
    assert read(name, reduced([("void psd_cluster<17>()", 0, 5), ("gemm", 5, 9)], [(9, 10)])) is None
    assert read(name, reduced([])) is None
    assert read(name, reduced(BLOCK, COPIES, blocks=0)) is None


def test_marker_names_are_no_roofline_kernels():
    t = reduced(BLOCK, COPIES)
    assert t.kernel_s("psd_") == pytest.approx(5e-3)
    assert t.kernel_s("fir_decimate") == pytest.approx(3e-3)
    assert t.kernel_s("selection_") == 0


def test_the_step_cell_reads_the_new_metrics_and_the_sessions_do_not():
    step = load_cell(ROOT, BASE_CELL)
    assert set(NEW) <= set(step.readers)
    assert not set(NEW) & set(load_cell(ROOT, SESSION_CELL).readers)


def test_each_new_reader_reads_none_on_a_cpu_cell(small_root):
    out = run_cell(small_root, f"{list(SMALL)[0]}.step", trace=True)
    assert out.trace.blocks > 0
    for name in NEW:
        assert read(name, out.trace) is None, name
