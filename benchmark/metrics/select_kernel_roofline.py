"""Selection kernel (``ops/cuda/select_kernel.py``, ``csrc/select_kernel.cu``):
share of its roofline a block. Work of a block: each of bands x frames rows
of fft bins is read once at the selection's precision (2 bytes for
bfloat16), and each row writes its top_k + 16 candidates (an int32 index
and a float32 value each) and a count; no arithmetic bound."""

from benchmark.metrics.peaks import roofline_pct

K_SEP = 16
WIDTH = {"bfloat16": 2, "float32": 4}


def work(config: dict, traffic: dict):
    """(bytes, operations) of a block."""
    rows = traffic["bands"] * config["frames_per_block"]
    out = (config["top_k"] + K_SEP) * (4 + 4) + 4
    return rows * (config["fft_size"] * WIDTH[config["precision"]["selection"]] + out), 0.0


def read(trace):
    return roofline_pct(trace, "selection_", *work(trace.cell.config, trace.cell.traffic))
