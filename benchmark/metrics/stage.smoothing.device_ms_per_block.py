"""Scan stages: the device wall of the span ``scan.smoothing`` (the 21-bin
smoothing) in each replayed graph of the traced window, between its markers
``trace_enter_scan_smoothing`` and ``trace_exit_scan_smoothing``, in ms a
block (``stage_marks``)."""

from benchmark.metrics.stage_marks import stage_ms_per_block


def read(trace):
    return stage_ms_per_block(trace, "scan.smoothing")
