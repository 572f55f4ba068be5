"""DDC: the device wall of the span ``ddc`` (the recorders' modulated-taps
stage 1, the FIR kernel, the int8 output) in each replayed graph of the
traced window, between its markers ``trace_enter_ddc`` and
``trace_exit_ddc``, in ms a block (``stage_marks``)."""

from benchmark.metrics.stage_marks import stage_ms_per_block


def read(trace):
    return stage_ms_per_block(trace, "ddc")
