"""Channelizer: share of its roofline a block, read from the stage's time,
not from kernel names, so that any form of the bank is held to the same
yardstick. Work of a block, from the published math (the critically
sampled DFT filter bank, ``reference/channelizer.py``), whatever implements
it: the int8 wideband stream read once (2 bytes a sample) and the channel
streams written once as float32 pairs (8 bytes a channel sample, as many
channel samples as stream samples); for each channel sample time, B branch
FIRs of ``taps_per_branch`` taps on complex input (4 operations a tap) and
one B-point FFT (5 B log2 B), at the float32 peak. The time is
``stage.channelize.device_ms_per_block``."""

import math

from benchmark.metrics.peaks import F32_FLOPS, HBM_BYTES_PER_S
from benchmark.metrics.stage_marks import stage_ms_per_block
from benchmark.reference.channelizer import taps_per_branch


def work(config: dict, traffic: dict):
    """(bytes, operations) of a block."""
    b = config["channels"]
    n = traffic["bands"] * config["frames_per_block"] * config["fft_size"] * config["decimator_factor"]
    times = n // b  # channel sample times a block
    return n * (2 + 8), times * (b * taps_per_branch(b) * 4 + 5 * b * math.log2(b))


def read(trace):
    ms = stage_ms_per_block(trace, "channelize")
    if not ms:
        return None
    moved, ops = work(trace.cell.config, trace.cell.traffic)
    return 100.0 * max(moved / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3 / ms
