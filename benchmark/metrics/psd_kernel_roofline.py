"""PSD kernel (``ops/cuda/psd_kernel.py``, ``csrc/psd_kernel.cu``): share of
its roofline a block. Work of a block, fixed by the cell's shapes: each of
bands x frames rows reads the fft int8 pairs of its frame (2 bytes a
sample) and writes fft float32 dB (4 bytes); a radix FFT's 5 fft log2(fft)
operations a row, at the float32 peak."""

import math

from benchmark.metrics.peaks import roofline_pct


def work(config: dict, traffic: dict):
    """(bytes, operations) of a block."""
    rows, fft = traffic["bands"] * config["frames_per_block"], config["fft_size"]
    return rows * fft * (2 + 4), rows * 5 * fft * math.log2(fft)


def read(trace):
    return roofline_pct(trace, "psd_", *work(trace.cell.config, trace.cell.traffic))
