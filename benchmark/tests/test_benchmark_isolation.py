"""Nothing the benchmark runs imports JAX or the JAX package; the reference
imports nothing of the program; without a card the harness exits non-zero
and prints no result."""

import ast
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "rtl_sdr_scanner_tpu"}
SOURCES = sorted(p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_side_import(path):
    assert not (top_level_imports(path) & JAX_SIDE)


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "rtl_sdr_scanner_tpu_torch" not in top_level_imports(path)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rtl_sdr_scanner_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rtl_sdr_scanner_tpu.fake", object())
    assert run.forbidden_modules() == ["rtl_sdr_scanner_tpu.fake"]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "hf20m48.bands24.step",
                           "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = _run(ROOT)
    assert done.returncode != 0 and done.stdout == ""


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
