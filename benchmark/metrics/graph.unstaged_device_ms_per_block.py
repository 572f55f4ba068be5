"""Graph layer (``graph.py``) on the device: the traced window's busy time
(every kernel, copy and set) outside every marked stage, in ms a block
(``stage_marks``): the inputs' loads before a replay, the state copies at
the end of a graph, the outputs' clones after it, the host fetch copies and
the marker kernels themselves."""

from benchmark.metrics.stage_marks import unstaged_ms_per_block


def read(trace):
    return unstaged_ms_per_block(trace)
