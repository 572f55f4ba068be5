"""Scan stages: the device wall of the span ``scan.pack`` (a block's detections
packed into one vector) in each replayed graph of the traced window, between
its markers ``trace_enter_scan_pack`` and ``trace_exit_scan_pack``, in ms a
block (``stage_marks``)."""

from benchmark.metrics.stage_marks import stage_ms_per_block


def read(trace):
    return stage_ms_per_block(trace, "scan.pack")
