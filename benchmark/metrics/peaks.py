"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the roofline share of a kernel's device time."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores


def roofline_pct(trace, kernel: str, bytes_a_block: float, flops_a_block: float):
    """100 x the least time the card could take for a block's work (bytes
    over the memory rate or operations over the f32 peak, the larger) over
    the device time a block of the kernels whose name holds ``kernel``;
    None where the window ran none."""
    seconds = trace.kernel_s(kernel)
    if seconds <= 0 or not trace.blocks:
        return None
    bound = max(bytes_a_block / HBM_BYTES_PER_S, flops_a_block / F32_FLOPS)
    return 100.0 * bound / (seconds / trace.blocks)
