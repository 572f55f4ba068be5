"""Channelizer: the device wall of the span ``channelize`` (the polyphase
bank over the whole wideband stream, ``ops/channelizer.py``: the int8
stream widened to float32, the bank's product and lag sum) in each replayed
graph of the traced window, between its markers ``trace_enter_channelize``
and ``trace_exit_channelize``, in ms a block (``stage_marks``)."""

from benchmark.metrics.stage_marks import stage_ms_per_block


def read(trace):
    return stage_ms_per_block(trace, "channelize")
