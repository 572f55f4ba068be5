"""Session layer, the tracker (``runtime/transmission_tracker.py`` and the
recorder reconcile): the host time inside ``session.tracker`` and
``session.reconcile`` of the traced window, in ms a block."""


def read(trace):
    if not trace.blocks or not any(name.startswith("session.tracker") for name, _, _ in trace.host):
        return None
    return trace.host_s("session.tracker", "session.reconcile") / trace.blocks * 1e3
