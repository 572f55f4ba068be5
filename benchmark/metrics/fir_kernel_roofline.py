"""FIR kernel (``ops/cuda/fir_kernel.py``, ``csrc/fir_kernel.cu``): share of
its roofline a block. Work of a block, fixed by the cell's shapes, for each
DDC stage the configuration sends through the kernel (``fir_kernel_stages``):
bands x slots rows of complex float32 samples, the block's input of that
stage read once and its output written once (4 bytes a component), the taps
read once; 2 operations a tap and output component, at the float32 peak
(the problem's operations, not the kernel's TF32 passes)."""

from benchmark.metrics.peaks import roofline_pct
from benchmark.reference.ddc import resampler_taps


def work(c: dict, t: dict):
    """(bytes, operations) of a block."""
    rows = t["bands"] * c["slots_per_band"]
    n = c["frames_per_block"] * c["fft_size"] * c["decimator_factor"]
    fir = [tuple(s) for s in c["fir_kernel_stages"]]
    moved = ops = 0.0
    for interp, decim in (tuple(s) for s in c["ddc_stages"]):
        out = n * interp // decim
        if (interp, decim) in fir:
            taps = len(resampler_taps(interp, decim))
            moved += 4.0 * (rows * 2 * (n + out) + taps)
            ops += 2.0 * rows * 2 * out * taps
        n = out
    return moved, ops


def read(trace):
    moved, ops = work(trace.cell.config, trace.cell.traffic)
    return roofline_pct(trace, "fir_decimate", moved, ops) if moved else None
