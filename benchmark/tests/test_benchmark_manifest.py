"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re

import pytest

from benchmark.harness import load_cell, manifest, metric_module
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
M = manifest(ROOT)


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(M) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(one_line(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in M[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in M["end_to_end"] + M["per_layer"])) == len(M["end_to_end"]) + len(M["per_layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and one_line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].split("/")[0] in M["paths"]
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells and w in moved.get("workloads", cells), (m["name"], w)
        assert callable(metric_module(ROOT, m["name"]).read)


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = load_cell(ROOT, workload)
    assert cell.driver().run and cell.generator()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer and set(cell.readers) == {m["name"] for m in cell.per_layer}
    limits = cell.spec["limits"].values()
    assert all(v >= 0 for v in limits) and any(v > 0 for v in limits)
