"""Block step (``models/fused_step.py``, ``scan_pipeline.py``,
``ddc_pipeline.py`` through ``drivers.BandedBlocks``): the union of the
kernels' intervals in the traced window's device trace, in ms a block."""


def read(trace):
    if not trace.blocks or not trace.kernels:
        return None
    return trace.kernel_union_s() / trace.blocks * 1e3
