"""scripts/scan_file_torch.py against scripts/scan_file.py on
tests/test_scan_file_cli.py's scene (256 kHz cf32, FM at +30 kHz keyed
3-6 s): plain, and with --channels 2 (two 128 kHz channels at fft 512).

The JSON summaries must be equal but for the recording paths, and the
recording files equal within 1 LSB an IQ sample (the DDC's f32 sums run in
another order: torch_checks.compare_payloads's bound).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
RATE = 256000


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    rng = np.random.default_rng(2)
    n = int(RATE * 8.0)
    t = np.arange(n) / RATE
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    phase = 2 * np.pi * 30000 * t + 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * 800 * t)) / RATE
    iq += 0.4 * np.exp(1j * phase) * ((t >= 3.0) & (t < 6.0))
    path = tmp_path_factory.mktemp("cli") / "cli.cf32"
    iq.astype(np.complex64).view(np.float32).tofile(path)
    return path


def _run(script, capture, out_dir, channels):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    result = subprocess.run(
        [
            sys.executable, os.path.join(ROOT, "scripts", script),
            "--file", str(capture), "--rate", str(RATE), "--center", "145e6",
            "--min-time-ms", "1000", "--max-noise-time-ms", "1000",
            "--out-dir", str(out_dir), "--json", "--cpu", "--channels", str(channels),
        ],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    return json.loads(result.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("channels", [0, 2])
def test_scan_file_torch_matches_scan_file(capture, tmp_path, channels):
    want = _run("scan_file.py", capture, tmp_path / "jax", channels)
    got = _run("scan_file_torch.py", capture, tmp_path / "torch", channels)
    assert got["transmissions"], got
    strip = lambda s: [{k: v for k, v in tx.items() if k != "file"} for tx in s["transmissions"]]
    assert strip(got) == strip(want)
    tx = got["transmissions"][0]
    assert abs(tx["frequency"] - 145_030_000) <= 2500 and tx["seconds"] > 2.0
    for a, b in zip(want["transmissions"], got["transmissions"]):
        assert os.path.basename(a["file"]) == os.path.basename(b["file"])
        ja, tb = np.fromfile(a["file"], np.int8), np.fromfile(b["file"], np.int8)
        assert tb.size == b["samples"] * 2 == ja.size
        assert np.abs(ja.astype(np.int32) - tb.astype(np.int32)).max() <= 1
