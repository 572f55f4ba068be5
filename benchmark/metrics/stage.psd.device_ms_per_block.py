"""Scan stages: the device wall of the span ``scan.psd`` (the PSD kernel) in
each replayed graph of the traced window, between its markers
``trace_enter_scan_psd`` and ``trace_exit_scan_psd``, in ms a block
(``stage_marks``)."""

from benchmark.metrics.stage_marks import stage_ms_per_block


def read(trace):
    return stage_ms_per_block(trace, "scan.psd")
