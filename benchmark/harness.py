"""The harness's loader and its shared pieces.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in files of its own, found by the names in
``BENCHMARK.json``:

- ``benchmark/configs/<config>.json`` (the configuration's ``file``);
- ``benchmark/traffic/<traffic>.json``, whose ``generator`` names a module
  ``benchmark/traffic/<generator>.py``;
- ``benchmark/cells/<cell>.json``: its ``driver`` (a module
  ``benchmark/drivers/<driver>.py``), the blocks its check reads and the
  limits of the numbers compared;
- ``benchmark/metrics/<metric>.py``: ``read(trace) -> float | None`` for
  each per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with every file it names loaded."""

    root: Path
    name: str
    workload: dict
    config: dict
    traffic: dict
    spec: dict  # benchmark/cells/<name>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.spec['driver']}")

    def generator(self):
        return importlib.import_module(f"benchmark.traffic.{self.traffic['generator']}")


def manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of the manifest under ``root``, every file loaded."""
    m = manifest(root)
    workloads = {w["name"]: w for w in m["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(workloads)})")
    w = workloads[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    spec = json.loads((root / "benchmark" / "cells" / f"{name}.json").read_text())
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    moved = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"] if x["moves"] in moved and _reports(x, name)]
    cell = Cell(root, name, w, config, traffic, spec, e2e, layer)
    for metric in layer:
        cell.readers[metric["name"]] = load_reader(root, metric["name"])
    return cell


def metric_module(root: Path, metric: str):
    """benchmark/metrics/<metric>.py as a module (a name may hold dots)."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root: Path, metric: str) -> Callable:
    """``read(trace)`` of the metric's reader."""
    return metric_module(root, metric).read


class HostFetch:
    """Double-buffered host copies of each block's outputs (as
    ``bench_torch.py``): the copies of block b go into pinned buffers right
    behind its kernels, with an event after them, and the host waits on
    block b's event only once block b+1 is enqueued. On the CPU the outputs
    are host tensors already."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs: list = [None, None]
        self.events: list = [None, None]

    def start(self, b: int, tensors: list) -> int:
        slot = b % 2
        if not self.cuda:
            self.bufs[slot] = tensors
            return slot
        bufs = self.bufs[slot]
        if bufs is None or [x.shape for x in bufs] != [t.shape for t in tensors]:
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for buf, t in zip(bufs, tensors):
            buf.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.bufs[slot], self.events[slot] = bufs, event
        return slot

    def wait(self, slot: int) -> list:
        if self.cuda:
            self.events[slot].synchronize()
        return self.bufs[slot]


@dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""

    end_to_end: Dict[str, float]
    numbers: Dict[str, float]  # compared, by name
    limits: Dict[str, float]
    attempted: int  # blocks dispatched in the window, each fetched back (or the run raises)
    memory_peak_bytes: int
    trace: Optional[object] = None  # benchmark.trace.Reduced, with --trace 1
    control: Dict[str, float] = field(default_factory=dict)  # the control's numbers, when asked for

    @property
    def correct(self) -> bool:
        return all(self.numbers.get(k, float("inf")) <= v for k, v in self.limits.items())
