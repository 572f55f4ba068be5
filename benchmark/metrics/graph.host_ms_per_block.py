"""Graph layer (``graph.py``): the harness's host clock around each
``BandedBlocks.run_block`` of the traced window (copying the block's
inputs into the graph's static buffers and enqueueing its replay), in ms,
the mean over the window's blocks."""


def read(trace):
    if not trace.host_ms:
        return None
    return sum(trace.host_ms) / len(trace.host_ms)
