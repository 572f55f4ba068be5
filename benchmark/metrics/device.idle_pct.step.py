"""Device (H100) in the block-step cells: 100 less the share of the traced
window in which an operation (kernel, copy or set) ran on the card, in %."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
