"""The port stands alone: it imports without JAX, names neither JAX nor the
JAX package in its sources, builds nothing on import, and its entry points
refuse to run on a missing card unless asked for the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "rtl_sdr_scanner_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*")) + [ROOT / "chip_smoke.py"]


def _modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rtl_sdr_scanner_tpu'] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax(path):
    text = path.read_text()
    assert "rtl_sdr_scanner_tpu." not in text
    for line in text.splitlines():
        code = line.split("#")[0].strip()
        if code.startswith(("import ", "from ")):
            assert "jax" not in code, line


def test_no_build_output_in_the_package():
    assert not list(PKG.rglob("*.so"))


def test_entry_points_default_to_the_card():
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, fused_step, scan_pipeline

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = scan_pipeline.ScanConfig.create(256_000, 10)
    ddc = ddc_pipeline.DdcConfig.create(256_000, 16_000, 2, cfg.block_samples)
    calls = [
        lambda: scan_pipeline.init_scan_state(cfg, 1),
        lambda: scan_pipeline.init_spectro_acc(cfg, 1),
        lambda: ddc_pipeline.init_state(ddc, 1),
        lambda: ddc_pipeline.make_tables(ddc, np.zeros((1, 2), dtype=np.int64)),
        lambda: fused_step.make_banded_fused_step(cfg, ddc, 64),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, the same calls run
    assert scan_pipeline.init_scan_state(cfg, 1, device="cpu").noise.threshold.shape == (1, 1024)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or where CUDA is absent, it fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
