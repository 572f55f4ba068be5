"""Detection: the device wall of the span ``scan.detection`` (the selection
kernel, the vote, the counts) in each replayed graph of the traced window,
between its markers ``trace_enter_scan_detection`` and
``trace_exit_scan_detection``, in ms a block (``stage_marks``)."""

from benchmark.metrics.stage_marks import stage_ms_per_block


def read(trace):
    return stage_ms_per_block(trace, "scan.detection")
