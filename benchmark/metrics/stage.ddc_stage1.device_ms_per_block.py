"""DDC stage 1: the device wall of the span ``ddc.stage1`` (the
modulated-taps stage 1 with its rotation, one launch a DDC chunk, nested in
the span ``ddc``) in each replayed graph of the traced window, between its
markers ``trace_enter_ddc_stage1`` and ``trace_exit_ddc_stage1``, summed
over a block's chunks, in ms a block (``stage_marks``). The rest of
``stage.ddc.device_ms_per_block`` is the later stages and each chunk's
quantisation, phase step and join. A program without the span reads None."""

from benchmark.metrics.stage_marks import stage_ms_per_block


def read(trace):
    return stage_ms_per_block(trace, "ddc.stage1")
