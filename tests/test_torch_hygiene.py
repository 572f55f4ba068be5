"""The port stands alone: it imports without JAX, names neither JAX nor the
JAX package in its sources, builds nothing on import, and its entry points
refuse to run on a missing card unless asked for the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "rtl_sdr_scanner_tpu_torch"
CARD_SCRIPTS = [ROOT / "scripts" / "profile_torch_main_path.py", ROOT / "scripts" / "psd_phase_split.py"]
SOURCES = (
    sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*")) + [ROOT / "chip_smoke.py"] + CARD_SCRIPTS
)


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


def test_native_build_writes_outside_the_package():
    """The host codec library builds under the repository's build/, never
    beside its sources."""
    from rtl_sdr_scanner_tpu_torch import native

    before = sorted(p for p in PKG.rglob("*") if "__pycache__" not in p.parts)
    native.native_available()
    assert native.lib_path().is_relative_to(ROOT / "build" / "native")
    assert sorted(p for p in PKG.rglob("*") if "__pycache__" not in p.parts) == before
    assert not list(PKG.rglob("*.so"))


def test_entry_points_default_to_the_card(tmp_path):
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, fused_step, scan_pipeline
    from rtl_sdr_scanner_tpu_torch.runtime import main
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config, default_config_json
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner
    from rtl_sdr_scanner_tpu_torch.runtime.sdr_device import SdrDevice

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    capture = tmp_path / "x.cs8"
    np.zeros(1 << 16, dtype=np.int8).tofile(capture)
    raw = default_config_json()
    raw["devices"] = [{
        "enabled": True, "serial": "r", "driver": "replay", "sample_rate": 256_000,
        "start_recording_level": 8, "stop_recording_level": 5,
        "ranges": [{"start": 144_900_000, "stop": 145_100_000}], "file": str(capture), "file_format": "cs8",
    }]
    config_path = tmp_path / "config.json"
    config_path.write_text(json.dumps(raw))
    config = Config(raw)
    spec = config.devices[0]
    cfg = scan_pipeline.ScanConfig.create(256_000, 10)
    ddc = ddc_pipeline.DdcConfig.create(256_000, 16_000, 2, cfg.block_samples)
    v1 = ddc_pipeline.DdcConfig.create(2_400_000, 32_000, 2, 75 * 2048)
    calls = [
        lambda: scan_pipeline.init_scan_state(cfg, 1),
        lambda: scan_pipeline.init_spectro_acc(cfg, 1),
        lambda: ddc_pipeline.init_state(ddc, 1),
        lambda: ddc_pipeline.init_state(v1),
        lambda: ddc_pipeline.make_tables(ddc, np.zeros((1, 2), dtype=np.int64)),
        lambda: ddc_pipeline.make_tables(v1, np.zeros((2,), dtype=np.int64)),
        lambda: ddc_pipeline.make_ddc_step(v1),
        lambda: fused_step.make_banded_fused_step(cfg, ddc, 64),
        lambda: fused_step.make_fused_step(cfg, ddc, 64),
        lambda: scan_pipeline.init_scan_state(cfg),
        lambda: scan_pipeline.make_scan_step(cfg),
        lambda: scan_pipeline.make_compact_scan_step(cfg, 64),
        lambda: SdrDevice(config, spec, NullMqtt(), 1),
        lambda: Scanner(config, spec, NullMqtt(), 1),
        lambda: main.run(str(config_path)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, the same calls run
    assert scan_pipeline.init_scan_state(cfg, 1, device="cpu").noise.threshold.shape == (1, 1024)
    assert scan_pipeline.init_scan_state(cfg, device="cpu").noise.threshold.shape == (1024,)
    assert SdrDevice(config, spec, NullMqtt(), 1, device="cpu").torch_device.type == "cpu"


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


@pytest.mark.parametrize("script", CARD_SCRIPTS, ids=lambda p: p.name)
def test_card_scripts_refuse_without_a_card(script):
    """The port's measurement scripts fail on a missing card; they never
    fall back to timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "needs an NVIDIA GPU" in out.stderr
