"""bench_torch.py, the port's bench, held against bench.py on the CPU: the
same timing windows and spread, the same seeded data, the same JSON keys,
and both bench functions driven end to end at a shrunken geometry (as
tests/test_bench_smoke.py shrinks bench.py's)."""

import ast
import inspect
import itertools
import time

import numpy as np
import pytest
import torch

import bench
import bench_torch

torch.set_num_threads(2)


@pytest.mark.parametrize("rates", [
    [5.0],
    [10.0, 20.0, 40.0],
    [10.0, 30.0, 20.0, 25.0],
    [40.0, 10.0, 19.0, 20.0, 21.0, 33.0, 20.5],
])
def test_median_spread_matches_bench(rates):
    assert bench_torch._median_spread(rates) == bench._median_spread(rates)


def _fake_clock(steps):
    """A perf_counter that advances by the next of ``steps`` at each call."""
    t = [0.0]
    it = iter(steps)

    def clock():
        t[0] += next(it)
        return t[0]

    return clock


@pytest.mark.parametrize("noisy", [False, True])
def test_timed_windows_match_bench(monkeypatch, noisy):
    """Under one fake clock and one fake dispatch, both scripts' windows
    give the same rates and the same calls: at the spread target (a steady
    clock: 3 windows) and past it (a noisy one: windows up to MAX_REPEATS)."""
    assert (bench_torch.REPEATS, bench_torch.SPREAD_TARGET, bench_torch.MAX_REPEATS) == (
        bench.REPEATS, bench.SPREAD_TARGET, bench.MAX_REPEATS)
    runs = []
    for module in (bench, bench_torch):
        rng = np.random.default_rng(3)
        steps = rng.uniform(0.5, 1.5, 10_000) if noisy else itertools.repeat(0.01)
        monkeypatch.setattr(time, "perf_counter", _fake_clock(steps))
        calls = []

        def dispatch(block_no, pending):
            calls.append((block_no, pending))
            return None if block_no is None else f"out{block_no}"

        rates = module._timed_windows(dispatch, 0.05, module.REPEATS)
        runs.append((rates, calls))
    (want, want_calls), (got, got_calls) = runs
    assert got == want and got_calls == want_calls
    assert len(got) == (bench.MAX_REPEATS if noisy else bench.REPEATS)


def test_ring_and_shifts_match_bench_draws():
    """The rings and slot shifts are bench.py's draws (default_rng(0): the
    ring's blocks, then the shifts), read from bench.py's own lines."""
    src = inspect.getsource(bench)
    assert "rng.integers(-32, 32, size=(n_bands, frames, group, 2), dtype=np.int8)" in src
    assert "rng.integers(-32, 32, size=(n_wide, 2), dtype=np.int8)" in src
    assert "rng.integers(-RATE // 2, RATE // 2, size=SLOTS_PER_BAND)" in src
    n_bands, frames, group = 3, 5, 96
    blocks, shifts = bench_torch.bands_data(n_bands, frames, group)
    rng = np.random.default_rng(0)
    want = [rng.integers(-32, 32, size=(n_bands, frames, group, 2), dtype=np.int8) for _ in range(bench.RING)]
    want_shift = rng.integers(-bench.RATE // 2, bench.RATE // 2, size=bench.SLOTS_PER_BAND)
    assert len(blocks) == bench.RING and all(np.array_equal(a, b) for a, b in zip(blocks, want))
    np.testing.assert_array_equal(shifts, np.tile(want_shift, (n_bands, 1)))

    blocks, shifts = bench_torch.wideband_data(n_bands, 1000)
    rng = np.random.default_rng(0)
    want = [rng.integers(-32, 32, size=(1000, 2), dtype=np.int8) for _ in range(bench.RING)]
    want_shifts = [rng.integers(-bench.RATE // 2, bench.RATE // 2, size=bench.SLOTS_PER_BAND) for _ in range(n_bands)]
    assert all(np.array_equal(a, b) for a, b in zip(blocks, want))
    np.testing.assert_array_equal(shifts, np.stack(want_shifts))


def _shrink(monkeypatch):
    monkeypatch.setattr(bench_torch, "RATE", 256_000)
    monkeypatch.setattr(bench_torch, "FRAMES", 10)
    monkeypatch.setattr(bench_torch, "WARMUP", 1)
    monkeypatch.setattr(bench_torch, "MAX_REPEATS", 3)


@pytest.mark.parametrize("host_fed", [False, True])
def test_bench_bands_on_the_cpu(monkeypatch, host_fed):
    """bench_bands at a shrunken geometry (256 kHz: fft 1024, 10 frames, 2
    bands, one warm-up block) through the plain versions: positive rates,
    one a window, and no kernel launch counted (a CPU tensor never reaches
    a kernel)."""
    _shrink(monkeypatch)
    rates = bench_torch.bench_bands(2, 0.0, host_fed, 10, device="cpu")
    assert bench_torch.REPEATS <= len(rates) <= 3 and all(r > 0 for r in rates)


@pytest.mark.parametrize("fused", [True, False])
def test_bench_wideband_on_the_cpu(monkeypatch, fused):
    """bench_wideband at the same shrunken geometry, 2 channels, fused and
    split: positive rates."""
    _shrink(monkeypatch)
    rates = bench_torch.bench_wideband(2, 0.0, 10, fused=fused, device="cpu")
    assert bench_torch.REPEATS <= len(rates) <= 3 and all(r > 0 for r in rates)


def _bench_json_keys():
    """{metric: [keys]} of the JSON objects bench.py prints."""
    out = {}
    for node in ast.walk(ast.parse(inspect.getsource(bench))):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" and node.args:
            d = node.args[0]
            if isinstance(d, ast.Dict):
                keys = [k.value for k in d.keys]
                metric = d.values[keys.index("metric")].value
                out[metric] = keys
    return out


def test_json_lines_have_bench_keys():
    """Each metric's object carries exactly bench.py's keys, in its order."""
    want = _bench_json_keys()
    got = [bench_torch.bands_result(1.5e9, 0.01, 3, f32=False), bench_torch.wideband_result([2e9, 2.1e9, 2.05e9])]
    assert {r["metric"] for r in got} == set(want) == {
        "iq_samples_per_second_per_chip_scan_plus_ddc", "iq_samples_per_second_per_chip_wideband_app_path"}
    for r in got:
        assert list(r) == want[r["metric"]]
    assert got[0]["detection_dtype"] == "bf16" and bench_torch.bands_result(1.0, 0.0, 3, f32=True)[
        "detection_dtype"] == "f32"
    assert got[1]["value"] == 2.05e9 and got[1]["repeats"] == 3 and got[1]["vs_baseline"] == round(2.05e9 / 20.48e6, 2)


def test_bench_refuses_without_a_card(capsys):
    """Without a card, main() exits 2 and prints no result; it never times
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_torch.main([]) == 2
    assert bench_torch.main(["--wideband"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs an NVIDIA GPU" in out.err
