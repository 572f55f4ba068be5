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
CARD_SCRIPTS = [
    ROOT / "scripts" / "profile_torch_main_path.py", ROOT / "scripts" / "psd_phase_split.py",
    ROOT / "scripts" / "mesh_cards_torch.py",
]
SCAN_FILE = ROOT / "scripts" / "scan_file_torch.py"
CHECKS = ROOT / "tests" / "torch_checks.py"
SOURCES = (
    sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*")) + [ROOT / "chip_smoke.py"] + CARD_SCRIPTS
    + [SCAN_FILE, CHECKS]
)
# the layers under the drivers and the runtime: what they import stays below them
LOWER_LAYERS = sorted(p for d in ("ops", "ops/cuda", "models", "parallel", "utils") for p in (PKG / d).glob("*.py")) + [
    PKG / "graph.py"]
UPPER_LAYERS = ("rtl_sdr_scanner_tpu_torch.drivers", "rtl_sdr_scanner_tpu_torch.runtime", "chip_smoke")


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


def test_scan_file_torch_runs_without_jax(tmp_path):
    """The port's offline scan CLI, wideband branch included, runs with JAX
    and the JAX package made unimportable."""
    capture = tmp_path / "noise.cs8"
    rng = np.random.default_rng(0)
    np.clip(np.round(rng.standard_normal(2 * 256_000) * 1.3), -128, 127).astype(np.int8).tofile(capture)
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rtl_sdr_scanner_tpu'] = None\n"
        f"sys.argv = ['scan_file_torch.py', '--file', {str(capture)!r}, '--rate', '256000', '--center', '145e6',\n"
        "            '--json', '--cpu', '--channels', '2']\n"
        f"runpy.run_path({str(SCAN_FILE)!r}, run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"transmissions": []}


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
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner
    from rtl_sdr_scanner_tpu_torch.ops import channelizer
    from rtl_sdr_scanner_tpu_torch.parallel import mesh

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
    raw["devices"].append(dict(raw["devices"][0], serial="w", channels=2))
    config = Config(raw)
    spec, wide = config.devices
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
        lambda: WidebandScanner(config, wide, NullMqtt(), 2),
        lambda: channelizer.init_channelizer_state(channelizer.plan_channelizer(2)),
        lambda: mesh.make_mesh(1),
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


def test_multi_device_layer_is_checked():
    """The mesh layer's modules are among the modules and sources checked
    above, and chip_smoke.py's multi-device phase imports neither JAX nor
    the JAX package: its functions and the modules they import load and
    run their imports with both made unimportable."""
    for name in ("halo", "collectives", "mesh", "sharded_scan"):
        assert f"rtl_sdr_scanner_tpu_torch.parallel.{name}" in _modules()
        assert PKG / "parallel" / f"{name}.py" in SOURCES
    code = (
        "import sys, inspect, re\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rtl_sdr_scanner_tpu'] = None\n"
        "import chip_smoke\n"
        "phase = [chip_smoke.run_multi_device, chip_smoke.run_time_mesh, chip_smoke.run_band_shards,\n"
        "         chip_smoke.run_main_time_mesh, chip_smoke.time_mesh_configs, chip_smoke.WidebandStep]\n"
        "import importlib\n"
        "for fn in phase:\n"
        "    for mod in re.findall(r'from (rtl_sdr_scanner_tpu_torch[\\w.]*) import', inspect.getsource(fn)):\n"
        "        importlib.import_module(mod)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_graph_layer_is_checked():
    """``graph.py`` (the port's donate_argnums: captured CUDA graphs) is among
    the modules and sources checked above, and imports the standard
    library, torch and the port only."""
    assert "rtl_sdr_scanner_tpu_torch.graph" in _modules()
    assert PKG / "graph.py" in SOURCES
    for line in (PKG / "graph.py").read_text().splitlines():
        if line.startswith(("import ", "from ")):
            top = line.split()[1].split(".")[0]
            assert top in sys.stdlib_module_names or top in ("torch", "rtl_sdr_scanner_tpu_torch"), line


@pytest.mark.parametrize("script", CARD_SCRIPTS, ids=lambda p: p.name)
def test_card_scripts_use_only_names_chip_smoke_defines(script):
    """Every ``cs.X`` / ``chip_smoke.X`` a card script reads exists in
    chip_smoke.py, and every ``checks.X`` in ``torch_checks`` (a name moved
    to ``drivers`` or to the checks leaves no script behind)."""
    import ast

    import chip_smoke
    import torch_checks

    for node in ast.walk(ast.parse(script.read_text())):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if node.value.id in ("cs", "chip_smoke"):
                assert hasattr(chip_smoke, node.attr), f"{script.name}:{node.lineno} chip_smoke.{node.attr}"
            if node.value.id == "checks":
                assert hasattr(torch_checks, node.attr), f"{script.name}:{node.lineno} torch_checks.{node.attr}"


@pytest.mark.parametrize("path", LOWER_LAYERS, ids=lambda p: str(p.relative_to(PKG)))
def test_lower_layers_import_nothing_above_them(path):
    """The kernels' wrappers, the ops, the models, the mesh layer, the
    utilities and the graph layer import neither the drivers nor the
    runtime, nor a card script (relative imports resolved)."""
    import ast

    package = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            assert not any(name == u or name.startswith(u + ".") for u in UPPER_LAYERS), (
                f"{path.relative_to(PKG)}:{node.lineno} imports {name}")
