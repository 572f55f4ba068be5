"""Session layer (``runtime/scanner.py``, ``runtime/sdr_device.py``): the
host time inside the session's own ranges (``session.upload``, ``.scan``,
``.fetch``, ``.tracker``, ``.reconcile``, ``.ddc``, ``.spectrogram``) of
the traced window, in ms a block. The ranges run on the scanner's thread
and do not nest, so their sum is the session's host time."""


def read(trace):
    if not trace.blocks or not any(name.startswith("session.") for name, _, _ in trace.host):
        return None
    return trace.host_s("session.") / trace.blocks * 1e3
