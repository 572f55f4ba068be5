"""Stages of the replayed graphs, read from the marker kernels the port's
spans write into each capture (``rtl_sdr_scanner_tpu_torch/utils/trace.py``,
``csrc/trace_marks.cu``): ``trace_enter_<stage>`` and ``trace_exit_<stage>``,
the span's name with '.' written '_' (``scan.psd``: ``scan_psd``). No
``read``: the ``stage.*`` readers and ``graph.unstaged_device_ms_per_block``
share it.

A stage's interval runs from the end of its enter marker to the start of
its exit marker, so the launch gaps inside a stage count in it and the
markers themselves in no stage: the stages and the unstaged busy time add
up to the device's time a block. Each enter pairs with the next exit of its
stage that no later enter took (a span nested in one of its own name pairs
first); a marker whose partner the window cut is dropped. A window without
markers (the CPU, a program without them) reads None.
"""

from typing import Dict, List, Optional, Tuple

from benchmark.trace import total_ns, union_ns

ENTER, EXIT = "trace_enter_", "trace_exit_"


def intervals(trace) -> Dict[str, List[Tuple[int, int]]]:
    """Each marked stage's intervals in the window, ns, by its marker name
    (``scan_psd``), in order."""
    opened: Dict[str, List[int]] = {}
    found: Dict[str, List[Tuple[int, int]]] = {}
    for name, s, e in sorted(trace.kernels, key=lambda k: (k[1], k[2])):
        if name.startswith(ENTER):
            opened.setdefault(name[len(ENTER):], []).append(e)
        elif name.startswith(EXIT):
            stack = opened.get(name[len(EXIT):])
            if stack:
                found.setdefault(name[len(EXIT):], []).append((stack.pop(), s))
    return found


def stage_ms_per_block(trace, span: str) -> Optional[float]:
    """The device wall of span ``span`` (``scan.psd``, ``ddc``) a block, ms:
    the union of its intervals over the window's blocks."""
    found = intervals(trace).get(span.replace(".", "_"))
    if not found or not trace.blocks:
        return None
    return total_ns(found) / trace.blocks / 1e6


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length two merged, ordered interval lists share."""
    i = j = shared = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        shared += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def unstaged_ms_per_block(trace) -> Optional[float]:
    """The device's busy time (every kernel, copy and set) outside every
    marked stage, a block, ms."""
    found = intervals(trace)
    if not found or not trace.blocks:
        return None
    busy = union_ns(trace.device)
    staged = union_ns([iv for ivs in found.values() for iv in ivs])
    return (total_ns(busy) - _overlap_ns(busy, staged)) / trace.blocks / 1e6
