"""The port's multi-host layer (``parallel/multihost.py``) with real
``torch.distributed`` processes on the CPU (gloo), standing in for the JAX
package's ``tests/test_multihost.py``.

- ``initialize``'s environment contract: each case raises the JAX
  function's exception, with its message, on the same arguments (or, like
  it, does nothing for one process).
- Two processes build ``make_global_mesh(n_time_per_host=2)`` over 4 CPU
  "cards" each: no time row spans two processes, their bands cover the mesh
  once (``all_gather_object``), and each process's banded scan step on its
  own bands equals a one-process run of those bands.
- The runtime (``tests/test_multihost.py``'s capture and config): two
  processes run ``runtime.main.run`` through the env contract; each
  publishes exactly the one-process run's payloads of its own bands, byte
  for byte, and the one-process run (8 CPU shards) publishes what the JAX
  package's ``WidebandScanner`` does (``chip_smoke.compare_payloads``).
- ``main``'s two multihost warnings, word for word as the JAX package's,
  and the non-modulated-taps refusal.

The children are this file run as a script:

    python tests/test_torch_multihost.py child <mode> <rank> <world> <port> <device> [args]

Each child pins its "cards" to 4 copies of the CPU device on the CPU
(``sdr_device.visible_cards``), or runs on ``cuda`` (``test_torch_on_card``).
"""

import dataclasses
import json
import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
REPO = HERE.parent.parent
CHILD_TIMEOUT = 240
CHILD_CARDS = 4
RATE = 2_048_000
B = 8
CENTER = 145_000_000
CAPTURE_SECONDS = 8.0


def run_children(mode: str, world: int, *args, device: str = "cpu", env=None, timeout: float = CHILD_TIMEOUT) -> list:
    """``world`` children of this file in ``mode``, ranks 0..world-1, joined
    over a free localhost port (``chip_smoke.spawn_ranks``); returns their
    logs. A child that times out (every child's exact PID is killed) or
    exits non-zero fails the test."""
    from chip_smoke import spawn_ranks

    extra = dict(env or {})
    extra["PYTHONPATH"] = str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")
    ran = spawn_ranks(
        lambda rank, port: [sys.executable, HERE, "child", mode, rank, world, port, device, *args],
        world, timeout, env_of=lambda rank: extra, cwd=str(REPO),
    )
    for rank, (rc, out) in enumerate(ran):
        assert rc == 0, f"child {rank} exited {rc}:\n{out}"
        assert f"CHILD_OK {mode} rank={rank}/{world}" in out, out
    return [out for _, out in ran]


# -- the environment contract ---------------------------------------------------

ENV_CASES = {
    "num_not_an_integer": ({"JAX_NUM_PROCESSES": "two"}, (None, None, None)),
    "id_not_an_integer": ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "x"}, (None, None, None)),
    "id_not_an_integer_one_process": ({"JAX_PROCESS_ID": "x"}, (None, None, None)),
    "no_address": ({}, (None, 2, 0)),
    "no_address_from_env": ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}, (None, None, None)),
    "no_id": ({}, ("localhost:1", 2, None)),
    "id_too_large": ({}, ("localhost:1", 2, 2)),
    "id_negative": ({"JAX_COORDINATOR_ADDRESS": "localhost:1"}, (None, 3, -1)),
    "one_process": ({"JAX_COORDINATOR_ADDRESS": "localhost:1", "JAX_PROCESS_ID": "5"}, (None, 1, None)),
    "nothing_set": ({}, (None, None, None)),
}


def _outcome(fn, args):
    try:
        return ("returned", fn(*args))
    except Exception as exc:  # the outcome is what is compared
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_initialize_env_contract_matches_jax(case, monkeypatch):
    from chip_smoke import ENV_CONTRACT
    from rtl_sdr_scanner_tpu.parallel import multihost as jmh
    from rtl_sdr_scanner_tpu_torch.parallel import multihost as tmh

    env, args = ENV_CASES[case]
    for name in ENV_CONTRACT:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = _outcome(jmh.initialize, args)
    got = _outcome(lambda *a: tmh.initialize(*a, device="cpu"), args)
    assert got == want
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    if case in ("one_process", "nothing_set"):
        assert got == ("returned", None)
    else:
        assert got[0] == "ValueError"


# -- two processes: the global mesh and the banded scan step --------------------


def test_two_processes_build_the_global_mesh_and_scan_their_bands():
    logs = run_children("mesh", 2)
    joined = "".join(logs)
    assert "shards=[0, 1]" in joined and "shards=[2, 3]" in joined, joined


def _mesh_child(rank: int, world: int, port: int, device: str) -> str:
    from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig, _scan_block, init_scan_state
    from rtl_sdr_scanner_tpu_torch.parallel import multihost, sharded_scan
    from rtl_sdr_scanner_tpu_torch.parallel.collectives import gather

    multihost.initialize(f"localhost:{port}", world, rank, device=device)
    assert multihost.process_count() == world and multihost.process_index() == rank
    dev = torch.device(device)
    cards = CHILD_CARDS if dev.type == "cpu" else torch.cuda.device_count()
    mesh = multihost.make_global_mesh(n_time_per_host=2, cards=cards)
    n_time = 2 if cards % 2 == 0 else 1
    assert mesh.shape == {"bands": world * cards // n_time, "time": n_time}, mesh.shape
    for b, row in enumerate(mesh.grid):  # the time axis never crosses a process
        assert len({proc for proc, _ in row}) == 1, f"time row of band {b} spans processes: {row}"
    mine = multihost.local_band_indices(mesh)
    assert mine, "every process owns bands"
    cover = [None] * world
    torch.distributed.all_gather_object(cover, mine)
    assert sorted(b for part in cover for b in part) == list(range(mesh.shape["bands"])), cover

    # the banded full-row step over this process's rows, fed only its own
    # bands (data-local ingest; the rest of the global block stays zero)
    local = multihost.local_mesh(mesh, [dev] * cards)
    assert local.band_shards == tuple(mine) and local.n_band_shards == mesh.shape["bands"]
    cfg = ScanConfig.create(256000, frames_per_block=2)
    group = cfg.fft_size * cfg.decimator_factor
    n_bands = 2 * mesh.shape["bands"]
    b_loc = n_bands // mesh.shape["bands"]
    bands = [b for g in mine for b in range(g * b_loc, (g + 1) * b_loc)]
    iq = torch.zeros((n_bands, cfg.frames_per_block, group, 2))
    for b in bands:
        rng = np.random.default_rng(100 + b)
        iq[b] = torch.from_numpy(0.05 * rng.standard_normal((cfg.frames_per_block, group, 2)).astype(np.float32))
    now = torch.from_numpy((np.arange(1, cfg.frames_per_block + 1) * cfg.frame_interval_ms).astype(np.int32))
    now = now[None].expand(n_bands, -1).contiguous()
    step = sharded_scan.make_sharded_scan_step(cfg, local)
    state = sharded_scan.init_banded_state(cfg, n_bands, local)
    state, outs = step(state, sharded_scan.shard_bands(iq.to(dev), local), sharded_scan.shard_bands(now.to(dev), local))
    got = gather([o.raw for o in outs], torch.device("cpu"))
    assert got.shape[0] == len(bands)
    # one process, these bands, the unsharded step
    _, want = _scan_block(cfg, init_scan_state(cfg, len(bands), device=dev), iq[bands].to(dev), now[bands].to(dev))
    assert torch.equal(got, want.raw.cpu()), float((got - want.raw.cpu()).abs().max())
    assert float(got[:, :, cfg.fft_size // 2].abs().max()) > 0
    multihost.shutdown()
    return f"bands={bands} shards={mine}"


# -- one process's part of a global mesh: its rows by global index ---------------


@pytest.mark.parametrize("form", ["fused", "split"])
def test_a_process_part_runs_its_global_shards(form):
    """The wideband steps over a mesh that holds only global band shard 1 of
    2 (what ``local_mesh`` gives process 1) give shard 1's rows, recordings,
    channels and states of the whole 2-shard mesh: each shard slices its
    channels, tables, keys and masks by global position, never local."""
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
    from rtl_sdr_scanner_tpu_torch.ops import channelizer as tch
    from rtl_sdr_scanner_tpu_torch.parallel import multihost
    from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as tss
    from rtl_sdr_scanner_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(2)
    nb, rate, frames = 4, 256_000, 12
    cfg = dataclasses.replace(tsp.ScanConfig.create(rate, frames_per_block=frames), noise_learning_ms=0)
    ddc_cfg = tdp.DdcConfig.create(rate, 16000, 2, cfg.block_samples)
    rng = np.random.default_rng(4)
    t = np.arange(2 * nb * cfg.block_samples)
    x = 0.05 * rng.standard_normal((t.size, 2))
    # a tone in channel 3 after the one learning frame
    on = t >= nb * cfg.fft_size * cfg.decimator_factor
    x[:, 0] += 0.5 * on * np.cos(2 * np.pi * (3 * rate + 20_000) * t / (nb * rate))
    x[:, 1] += 0.5 * on * np.sin(2 * np.pi * (3 * rate + 20_000) * t / (nb * rate))
    pairs = torch.from_numpy(x.astype(np.float32)).reshape(2, -1, 2)
    shifts = rng.integers(-rate // 2, rate // 2, size=(nb, 2)).astype(np.int64)
    keys = torch.full((nb, 8), -1, dtype=torch.int32)
    keys[3, 0] = 600
    plan = tch.plan_channelizer(nb)
    world = multihost.GlobalMesh(grid=(((0, 0),), ((1, 0),)), process=1)

    def run(mesh):
        st = [tss.replicate(tch.init_channelizer_state(plan, "cpu"), mesh), tss.init_banded_state(cfg, nb, mesh),
              tss.shard_bands(torch.zeros((nb, cfg.spectro_size)), mesh)]
        ddc = tss.init_banded_ddc_state(ddc_cfg, nb, mesh)
        fixed = dict(keys=tss.shard_bands(keys, mesh), valid=tss.shard_bands(torch.ones((nb, cfg.fft_size), dtype=torch.bool), mesh),
                     level=tss.replicate(torch.tensor(8.0), mesh), tables=tss.shard_bands(tdp.make_tables(ddc_cfg, shifts, "cpu"), mesh),
                     keep=tss.shard_bands(torch.tensor([[1.0, 1.0]] * 3 + [[1.0, 0.0]]), mesh))
        fused = tss.make_sharded_wideband_fused_step(cfg, ddc_cfg, 64, 16, mesh, plan, 1, nb)
        wide = tss.make_sharded_wideband_step(cfg, 64, 16, mesh, plan, 1, nb)
        banded = tss.make_sharded_banded_ddc(ddc_cfg, mesh, nb)
        out = []
        for b in range(2):
            xs = tss.replicate(pairs[b], mesh)
            now = tss.replicate(torch.from_numpy(((b * frames + 1 + np.arange(frames)) * 20).astype(np.int32)), mesh)
            if form == "fused":
                *st, ddc, packed, rec, ch = fused(*st, ddc, xs, now, fixed["keys"], fixed["valid"], fixed["level"], 1.0,
                                                  fixed["tables"], fixed["keep"])
            else:
                *st, packed, ch = wide(*st, xs, now, fixed["keys"], fixed["valid"], fixed["level"], 1.0)
                ddc, rec = banded(ddc, ch, fixed["tables"], fixed["keep"])
            out.append([packed[-1], rec[-1], ch[-1]])  # the last shard's (global shard 1)
        return out, [tss._leaves(v[-1]) for v in (*st, ddc)]

    part = multihost.local_mesh(world, ["cpu"])
    assert part.band_shards == (1,) and part.n_band_shards == 2
    got, got_state = run(part)
    want, want_state = run(make_mesh(2, 1, devices=["cpu"] * 2))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    for a, b in zip(got_state, want_state):
        for x_, y_ in zip(a, b):
            assert torch.equal(x_, y_)
    assert (tsp.unpack_compact(got[1][0][1].numpy(), frames, 16, 8)[3] > 0).any(), "channel 3 detects nothing"


# -- two processes: the runtime ---------------------------------------------------


def write_runtime_config(tmp_path: Path, seconds: float = CAPTURE_SECONDS, **tunables) -> Path:
    """``tests/test_multihost.py``'s scene: 8 s at 2.048 Msps, FM keyed 3-6 s
    at +500 kHz (channel 2) and -750 kHz (channel 5), 8 channels over
    ``mesh_bands`` -1 with ``multihost``, 16 kHz recordings."""
    rng = np.random.default_rng(23)
    n = int(RATE * seconds)
    t = np.arange(n) / RATE
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    keyed = (t >= 3.0) & (t < 6.0)
    for f, tone in ((500_000, 800), (-750_000, 1200)):
        phase = 2 * np.pi * f * t + 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * tone * t)) / RATE
        iq += 0.4 * np.exp(1j * phase) * keyed
    capture = tmp_path / "mh.cf32"
    iq.astype(np.complex64).view(np.float32).tofile(capture)
    from rtl_sdr_scanner_tpu_torch.runtime.config import default_config_json

    raw = default_config_json()
    raw["tunables"] = {"mesh_bands": -1, "multihost": True, **tunables}
    raw["recording"] = {"max_noise_time_ms": 1000, "min_sample_rate": 16000, "min_time_ms": 1000, "step": 2500}
    raw["devices"] = [{
        "enabled": True, "serial": "mh0", "driver": "replay", "sample_rate": RATE,
        "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
        "ranges": [{"start": CENTER - RATE // 2, "stop": CENTER + RATE // 2}],
        "file": str(capture), "file_format": "cf32", "channels": B,
    }]
    path = tmp_path / "mh.json"
    path.write_text(json.dumps(raw))
    return path


def _runtime_child(rank: int, world: int, port: int, device: str, config_path: str, out_path: str) -> str:
    from chip_smoke import run_main

    os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=str(world),
                      JAX_PROCESS_ID=str(rank))
    made = []
    rc, published = run_main(Path(config_path), torch.device(device), timeout_s=CHILD_TIMEOUT, on_made=made.append)
    assert rc == 0 and len(made) == 1, (rc, made)
    scanner = made[0]
    assert scanner._multihost and scanner._mesh.n_band_shards == world * CHILD_CARDS
    mine = scanner._local_bands
    assert mine and len(mine) < len(scanner.sessions), mine
    with open(out_path, "wb") as fh:
        pickle.dump({"bands": mine, "published": published}, fh)
    return f"bands={mine} payloads={len(published)}"


def test_two_process_runtime_matches_one_process(tmp_path, monkeypatch):
    from chip_smoke import MH_CENTER, MH_CHANNELS, MH_RATE, compare_payloads, payload_band
    from rtl_sdr_scanner_tpu.runtime.config import Config as JConfig
    from rtl_sdr_scanner_tpu.runtime.mqtt_client import NullMqtt as JNullMqtt
    from rtl_sdr_scanner_tpu.runtime.wideband import WidebandScanner as JWideband
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner

    torch.set_num_threads(2)
    assert (MH_RATE, MH_CHANNELS, MH_CENTER) == (RATE, B, CENTER)  # payload_band's scene is this one
    cfg_path = write_runtime_config(tmp_path)
    outs = [tmp_path / f"child{rank}.pkl" for rank in range(2)]
    # the children first: they run while this process runs the one-process forms
    done = []

    def children_run():
        try:
            done.append(run_children("runtime", 2, cfg_path, tmp_path / "child{rank}.pkl"))
        except BaseException as exc:  # re-raised below, on the test's thread
            done.append(exc)

    children = threading.Thread(target=children_run)
    children.start()
    try:
        # one process over the same 8 shards the children build together
        monkeypatch.setattr(sdr_device, "visible_cards", lambda device: 2 * CHILD_CARDS)
        cfg = Config.load_from_file(str(cfg_path), scan_hardware=False)
        mqtt = NullMqtt()
        mqtt.keep_payloads = True
        single = WidebandScanner(cfg, cfg.devices[0], mqtt, recorders_count=8, device="cpu")
        assert single._mesh.shape == {"bands": 8, "time": 1} and not single._multihost
        single.run_to_completion()
        single.stop()
        one = list(mqtt.published)
        jcfg = JConfig.load_from_file(str(cfg_path), scan_hardware=False)
        jmqtt = JNullMqtt()
        jmqtt.keep_payloads = True
        ref = JWideband(jcfg, jcfg.devices[0], jmqtt, recorders_count=8)
        assert ref._mesh is not None and ref._mesh.devices.size == 8
        ref.run_to_completion()
        ref.stop()
    finally:
        children.join(timeout=CHILD_TIMEOUT + 30)
    assert done, "the children did not finish"
    if isinstance(done[0], BaseException):
        raise done[0]
    stats = compare_payloads(jmqtt.published, one)
    assert stats["transmissions"] >= 2, stats
    recorded = {payload_band(t, p) for t, p in one if t.endswith("/transmission/uint8")}
    assert recorded == {2, 5}, recorded

    bands_seen = []
    for rank in range(2):
        with open(outs[rank], "rb") as fh:
            child = pickle.load(fh)
        bands = set(child["bands"])
        bands_seen.extend(child["bands"])
        want = [(t, p) for t, p in one if payload_band(t, p) in bands]
        got = [tuple(x) for x in child["published"]]
        assert got, f"child {rank} published nothing"
        assert got == want, f"child {rank}: {len(got)} payloads against the one-process run's {len(want)}"
    assert sorted(bands_seen) == list(range(B)), bands_seen


# -- one process: main's warnings and the non-modtap refusal -------------------------


def _stub(mod):
    """A scanner class that ends ``mod.run``'s loop as soon as it starts."""

    class Stub:
        def __init__(self, *args, **kwargs):
            self.failed = False

        def start(self):
            mod._is_running = False

        def stop(self):
            pass

    return Stub


def _warnings_of(pkg: str, config_path: Path, monkeypatch) -> list:
    if pkg == "jax":
        from rtl_sdr_scanner_tpu.runtime import main as mod
        from rtl_sdr_scanner_tpu.runtime import wideband as wide_mod
        from rtl_sdr_scanner_tpu.utils import logger as log_mod
    else:
        from rtl_sdr_scanner_tpu_torch.runtime import main as mod
        from rtl_sdr_scanner_tpu_torch.runtime import wideband as wide_mod
        from rtl_sdr_scanner_tpu_torch.utils import logger as log_mod
    seen = []
    monkeypatch.setattr(log_mod, "warn", lambda label, fmt, *args: seen.append((label, fmt.format(*args))))
    monkeypatch.setattr(mod, "Scanner", _stub(mod))
    monkeypatch.setattr(mod, "WidebandScanner", _stub(mod), raising=False)
    monkeypatch.setattr(wide_mod, "WidebandScanner", _stub(mod))
    monkeypatch.setattr(mod, "_is_running", True)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    result = []
    # on a worker thread, so that run installs no signal handlers here
    worker = threading.Thread(target=lambda: result.append(mod.run(str(config_path), **kw)), daemon=True)
    worker.start()
    worker.join(timeout=60)
    mod._is_running = False
    assert not worker.is_alive() and result == [0], result
    return [w for w in seen if w[0] == "main"]


@pytest.mark.parametrize("setup", ["no_wideband_device", "mesh_bands_0"])
def test_main_warns_as_the_reference(setup, tmp_path, monkeypatch):
    from chip_smoke import ENV_CONTRACT

    for name in ENV_CONTRACT:
        monkeypatch.delenv(name, raising=False)
    path = write_runtime_config(tmp_path, 0.1, **({"mesh_bands": 0} if setup == "mesh_bands_0" else {}))
    raw = json.loads(path.read_text())
    if setup == "no_wideband_device":
        raw["devices"][0]["channels"] = 0
    raw["output"] = {"color_log_enabled": False, "console_log_level": "error", "file_log_level": "error"}
    raw["tunables"]["log_file_name"] = ""
    path.write_text(json.dumps(raw))
    want = _warnings_of("jax", path, monkeypatch)
    got = _warnings_of("torch", path, monkeypatch)
    assert got == want and len(got) == 1, (got, want)
    assert ("no enabled wideband" in got[0][1]) == (setup == "no_wideband_device")


def test_multihost_wideband_refuses_other_chains(tmp_path, monkeypatch):
    """A channel chain without the modulated-taps stage 1 (2 Msps channels
    to 32 kHz: stage 1 interpolates) records per channel, outside the bands
    mesh, so multi-host refuses it, as the reference does."""
    from rtl_sdr_scanner_tpu_torch.parallel import multihost
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner

    path = write_runtime_config(tmp_path, 0.1)
    raw = json.loads(path.read_text())
    raw["devices"][0]["sample_rate"] = 4_000_000
    raw["devices"][0]["channels"] = 2
    raw["devices"][0]["ranges"] = [{"start": CENTER - 2_000_000, "stop": CENTER + 2_000_000}]
    raw["recording"]["min_sample_rate"] = 32000
    cfg = Config(raw)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "make_global_mesh", lambda n_time_per_host=1, cards=1: multihost.GlobalMesh(
        grid=(((0, 0),), ((1, 0),)), process=0))
    with pytest.raises(ValueError, match="multihost wideband needs the modulated-taps chain"):
        WidebandScanner(cfg, cfg.devices[0], NullMqtt(), 2, device="cpu")
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    scanner = WidebandScanner(cfg, cfg.devices[0], NullMqtt(), 2, device="cpu")
    assert not scanner._ddc_cfg.modtap and scanner._ddc_band_step is None  # one process records per channel


# -- the children -----------------------------------------------------------------


def _child(argv) -> int:
    mode, rank, world, port, device, *rest = argv
    rank, world, port = int(rank), int(world), int(port)
    torch.set_num_threads(2)  # the parent's: CPU matmuls block by thread count
    if device == "cpu":
        from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

        sdr_device.visible_cards = lambda dev: CHILD_CARDS
    if mode == "mesh":
        said = _mesh_child(rank, world, port, device)
    elif mode == "runtime":
        said = _runtime_child(rank, world, port, device, rest[0], rest[1].format(rank=rank))
    else:
        raise ValueError(f"unknown child mode {mode!r}")
    print(f"CHILD_OK {mode} rank={rank}/{world} {said}", flush=True)
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    sys.exit(_child(sys.argv[2:]))
