"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
in a temporary directory with small cells added as new files only."""

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

# small geometries of the two DDC paths: (config changes, traffic changes)
SMALL = {
    "small_modtap": (dict(sample_rate=256000, fft_size=1024, decimator_factor=5, frames_per_block=16, recording_rate=4000,
                          ddc_stages=[[1, 64]], fir_kernel_stages=[]),
                     dict(bands=2, carrier_bands=1, carrier_offset_hz=10000, slot_shifts_hz=[10000, -20000])),
    "small_v1": (dict(sample_rate=240000, fft_size=1024, decimator_factor=4, frames_per_block=75,
                      recording_rate=3200, ddc_stages=[[1, 75]], fir_kernel_stages=[[1, 75]]),
                 dict(bands=2, carrier_bands=1, carrier_offset_hz=50000, slot_shifts_hz=[50000, -60000])),
}
BASE_CELL = "hf20m48.bands24.step"
# a small session: a 512 kHz dongle, the busy mix's transmitters within +-225 kHz
SESSION_CELL = "rtl2m048.session.busy"
SMALL_SESSION = (dict(sample_rate=512000, fft_size=2048, decimator_factor=5, ddc_stages=[[1, 16]],
                      range_hz=[144750000, 145250000]),
                 dict(max_shift_hz=225000, min_shift_hz=25000, min_spacing_hz=75000))


def add_small_cells(root: Path) -> list:
    """Add each SMALL cell to the benchmark under ``root`` by new files and
    new BENCHMARK.json entries alone; returns the cells' names."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    base = manifest["workloads"][0]
    config = json.loads((root / "benchmark" / "configs" / f"{base['config']}.json").read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{base['traffic']}.json").read_text())
    spec = json.loads((root / "benchmark" / "cells" / f"{BASE_CELL}.json").read_text())
    names = []
    for name, (c_change, t_change) in SMALL.items():
        cell = f"{name}.step"
        (root / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(dict(config, name=name, **c_change)))
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(dict(traffic, **t_change)))
        (root / "benchmark" / "cells" / f"{cell}.json").write_text(json.dumps(spec))
        manifest["configs"].append(dict(name=name, source="https://example.org/small", file=f"benchmark/configs/{name}.json",
                                        reduced=[], why="a CPU test's size"))
        manifest["workloads"].append(dict(name=cell, config=name, traffic=name, chips=1, why="a CPU test's size"))
        names.append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return names


def add_small_session(root: Path) -> str:
    """Add a small session cell to the benchmark under ``root`` by new files
    and new BENCHMARK.json entries alone; returns its name."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    base = next(w for w in manifest["workloads"] if w["name"] == SESSION_CELL)
    config = json.loads((root / "benchmark" / "configs" / f"{base['config']}.json").read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{base['traffic']}.json").read_text())
    spec = json.loads((root / "benchmark" / "cells" / f"{SESSION_CELL}.json").read_text())
    name, cell = "small_session", "small_session.busy"
    c_change, t_change = SMALL_SESSION
    (root / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(dict(config, name=name, **c_change)))
    (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(dict(traffic, **t_change)))
    (root / "benchmark" / "cells" / f"{cell}.json").write_text(json.dumps(spec))
    manifest["configs"].append(dict(name=name, source="https://example.org/small", file=f"benchmark/configs/{name}.json",
                                    reduced=[], why="a CPU test's size"))
    manifest["workloads"].append(dict(name=cell, config=name, traffic=name, chips=1, why="a CPU test's size"))
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if SESSION_CELL in metric.get("workloads", []):
            metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return cell


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_small_cells(root)
    add_small_session(root)
    return root


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
