"""The port's profiler spans: ``with span(name):`` around a stage.

On the host a span is a ``torch.profiler.record_function`` range of that
name, cheap when no profiler records. A range is a host event: a step
captured as a CUDA graph (``graph.py``) records it once, at the capture,
and a replay records none. So while the current CUDA stream is capturing,
a span also writes two named marker kernels into the capture, one thread
each and empty (``csrc/trace_marks.cu``): ``trace_enter_<name>`` at its
entry and ``trace_exit_<name>`` at its exit, '.' in the name written '_'
(``scan.psd``: ``trace_enter_scan_psd``). They replay with the graph, so a
device trace of replayed blocks shows each stage between its two markers
on the device's own clock. Eager runs (the CPU, a graphed step's ``.fn``)
launch none.

Only the names in ``MARKED`` have markers; a span of another name opened
inside a capture raises there. ``load_marks()`` loads the markers before a
capture (``graph.py`` calls it in the eager warm-up), never inside one.
The markers are not kernel wrappers: they count in no ``.launches``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch.profiler import record_function

# every span a captured step opens, in the order of csrc/trace_marks.cu's
# TRACE_MARKS (marker 2i enters MARKED[i], 2i + 1 leaves it)
MARKED = (
    "scan.psd",
    "scan.noise",
    "scan.averager",
    "scan.smoothing",
    "scan.detection",
    "scan.spectrogram",
    "scan.pack",
    "ddc",
    "channelize",
    "ddc.stage1",
)
EDGES = ("enter", "exit")


def marker_name(name: str, edge: str) -> str:
    """The kernel that marks the ``edge`` ("enter" or "exit") of span ``name``."""
    return f"trace_{edge}_{name.replace('.', '_')}"


def _capturing_stream() -> Optional[torch.cuda.Stream]:
    """The current CUDA stream if it is capturing a graph, else None."""
    if not torch.cuda.is_initialized() or not torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream()


def _mark(name: str, edge: str, stream: torch.cuda.Stream) -> None:
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    if name not in MARKED:
        raise ValueError(
            f"span {name!r} was opened inside a CUDA graph capture and has no marker kernel: "
            "add it to utils/trace.MARKED and to TRACE_MARKS in csrc/trace_marks.cu"
        )
    mark_id = 2 * MARKED.index(name) + EDGES.index(edge)
    check(library().trace_mark(mark_id, stream.cuda_stream), marker_name(name, edge))


def load_marks() -> None:
    """Loads the marker kernels on the current card (outside any capture)."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    lib = library()
    if lib.trace_mark_count() != len(EDGES) * len(MARKED):
        raise RuntimeError(
            f"csrc/trace_marks.cu holds {lib.trace_mark_count()} markers, utils/trace.MARKED wants "
            f"{len(EDGES) * len(MARKED)}"
        )
    check(lib.trace_marks_load(), "trace_marks_load")


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A profiler range ``name``; inside a graph capture, also its two
    marker kernels around what the body launches (module docstring)."""
    with record_function(name):
        stream = _capturing_stream()
        if stream is not None:
            _mark(name, "enter", stream)
        yield
        if stream is not None:
            _mark(name, "exit", stream)


__all__ = ["EDGES", "MARKED", "load_marks", "marker_name", "span"]
