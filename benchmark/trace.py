"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer readers and the result's ``device`` and ``breakdown`` read.

The harness opens its own host ranges (``bench.*``) around its calls into
the program, and keeps the program's own host ranges whose names start with
the prefixes a driver names (the session's ``session.*``); the device's
operations come from the profiler's CUPTI records (kernels, copies and
sets), clipped to the ``bench.window`` range.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def union_ns(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged [start, end) intervals, in order."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def total_ns(intervals: List[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in union_ns(intervals))


@dataclass
class Reduced:
    """The traced window, for the readers (``benchmark/metrics``)."""

    window: Tuple[int, int]  # ns, the profiler's clock
    kernels: List[Tuple[str, int, int]]  # (name, start, end) ns, clipped to the window
    device: List[Tuple[int, int]]  # every device operation, clipped
    host: List[Tuple[str, int, int]]  # the kept host ranges (bench.* and the driver's prefixes)
    blocks: int = 0  # blocks dispatched in the window
    host_ms: List[float] = field(default_factory=list)  # the harness's clock around each dispatch
    cell: object = None  # benchmark.harness.Cell

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return total_ns(self.device) / 1e9

    def kernel_s(self, part: str) -> float:
        """Summed seconds of the kernels whose name holds ``part``."""
        return sum(e - s for name, s, e in self.kernels if part in name) / 1e9

    def host_s(self, *prefixes: str) -> float:
        """Summed seconds of the kept host ranges whose name starts with one
        of ``prefixes``."""
        return sum(e - s for name, s, e in self.host if name.startswith(prefixes)) / 1e9

    def kernel_union_s(self) -> float:
        return total_ns([(s, e) for _, s, e in self.kernels]) / 1e9

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = union_ns(self.device)
        edges = [self.window[0]] + [t for iv in busy for t in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {
            "device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[self._open_at((s + e) // 2), (e - s) / 1e9] for s, e in gaps],
        }

    def _open_at(self, t: int) -> str:
        """The innermost host range open at t."""
        best = None
        for name, s, e in self.host:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "host outside the harness's ranges"


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."


class Tracer:
    """``with Tracer(on, cuda) as t:`` profiles when on; ``t.window()`` opens
    the measured window's range; ``t.reduce()`` after the ``with``."""

    def __init__(self, on: bool, cuda: bool, hosts: Tuple[str, ...] = ("bench.",)):
        self.on, self.cuda, self.hosts = on, cuda, tuple(hosts)
        self.prof = None

    def __enter__(self):
        if self.on:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def range(self, name: str):
        return record_function(name) if self.on else contextlib.nullcontext()

    def window(self):
        return self.range(WINDOW)

    def reduce(self) -> Reduced:
        events = self.prof.profiler.kineto_results.events()
        annotations = {ev.name() for ev in events if _kind(ev) == "user_annotation"}
        window = None
        host, device, kernels = [], [], []
        for ev in events:
            kind, name = _kind(ev, annotations), ev.name()
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if kind == "user_annotation" and name.startswith(self.hosts):
                if name == WINDOW:
                    window = (s, e)
                else:
                    host.append((name, s, e))
            elif kind in DEVICE_KINDS:
                device.append((s, e))
                if kind == "kernel":
                    kernels.append((name, s, e))
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        w0, w1 = window
        clip = lambda s, e: (max(s, w0), min(e, w1))
        host = [(n, s, e) for n, s, e in host if e > w0 and s < w1]
        device = [clip(s, e) for s, e in device if e > w0 and s < w1]
        kernels = [(n, *clip(s, e)) for n, s, e in kernels if e > w0 and s < w1]
        return Reduced(window=window, kernels=kernels, device=device, host=host)


def _kind(ev, annotations=frozenset()) -> str:
    """The event's kineto activity type; where this PyTorch has no
    ``activity_type``, told from its device and name (a device record named
    as a host range is that range's mirror on the device's timeline)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    if ev.device_type() != DeviceType.CUDA:
        user = ev.is_user_annotation() if hasattr(ev, "is_user_annotation") else name.startswith(("bench.", "session."))
        return "user_annotation" if user else "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "gpu_user_annotation" if name in annotations or name.startswith("bench.") else "kernel"
