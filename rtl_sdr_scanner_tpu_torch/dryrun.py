"""A dry run of the port's multi-device layer on n copies of one device.

    python -m rtl_sdr_scanner_tpu_torch.dryrun [N] [--cpu]

``dryrun_multichip(n)`` builds an (n / n_time) x n_time mesh (n_time 2
where n is even) over n copies of one device and runs each multi-device
form once, graphed as the runtime runs it (``graph.sharded_step``),
checking shapes and finite values, then prints one summary line:

- the bands-axis full-row scan step and the time-sharded v1 DDC (halo
  exchange) at toy widths;
- the runtime's bands mesh (a replay ``WidebandScanner`` with
  ``mesh_bands``) and time mesh (a replay ``Scanner`` with ``mesh_time``);
- the production geometry (20.48 Msps, fft 131072, 103-bin windows, 2
  slots at 16 kHz): the channelizer and every band's compact scan in one
  sharded step plus the banded DDC over the bands axis, and, with a time
  axis, the time-sharded detection and modulated-taps DDC at that fft.

The runtime sessions are given n copies of the device as their cards
(``cards=``), so they resolve their meshes as sessions on n cards would. The
two-process path is
``tests/test_torch_multihost.py`` (CPU) and ``chip_smoke.py`` step 11 (the
card).
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.graph import sharded_step

PROD_RATE = 20_480_000
PROD_SLOTS = 2
PROD_TOP_K = 64


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> str:
    """Every multi-device form once over n copies of ``device`` (default:
    the card). Returns the summary line it prints."""
    from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig
    from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig
    from rtl_sdr_scanner_tpu_torch.ops.ddc import make_nco_tables
    from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss
    from rtl_sdr_scanner_tpu_torch.parallel.collectives import gather
    from rtl_sdr_scanner_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n_time = 2 if n_devices % 2 == 0 else 1
    n_bands = n_devices // n_time
    mesh = make_mesh(n_bands, n_time, devices=[dev] * n_devices)

    # -- the bands-parallel scan: one band a bands coordinate ---------------
    cfg = ScanConfig.create(256000, frames_per_block=2)  # fft 1024
    rng = np.random.default_rng(0)
    group = cfg.fft_size * cfg.decimator_factor
    iq = torch.from_numpy((0.05 * rng.standard_normal((n_bands, cfg.frames_per_block, group, 2))).astype(np.float32))
    now = torch.from_numpy((np.arange(1, cfg.frames_per_block + 1) * cfg.frame_interval_ms).astype(np.int32))
    step = sharded_step(ss.make_sharded_scan_step(cfg, mesh), "dryrun scan step")
    state = ss.init_banded_state(cfg, n_bands, mesh)
    state, outs = step(state, ss.shard_bands(iq.to(dev), mesh), ss.shard_bands(now.expand(n_bands, -1).to(dev), mesh))
    raw = gather([o.raw for o in outs], torch.device("cpu"))
    if tuple(raw.shape) != (n_bands, cfg.frames_per_block, cfg.fft_size) or not torch.isfinite(raw).all():
        raise RuntimeError(f"bands-axis scan: rows {tuple(raw.shape)}")

    # -- the time-sharded v1 DDC with halo exchange -------------------------
    # a shard stays a multiple of the NCO table's coarse step (8192)
    ddc_cfg = DdcConfig.create(256000, 16000, 2, 16384 * n_time)
    n_global = ddc_cfg.block_samples
    x = rng.standard_normal((n_global, 2)).astype(np.float32)
    tables = make_nco_tables(np.array([30000, -20000]), 256000, n_global, dev)
    ddc = sharded_step(ss.make_time_sharded_ddc(ddc_cfg, mesh), "dryrun DDC")(torch.from_numpy(x).to(dev), tables)
    if ddc.shape[0] != 2 or ddc.shape[2] != 2:
        raise RuntimeError(f"time-sharded DDC: {tuple(ddc.shape)}")

    # -- the runtime's meshes --------------------------------------------------
    topics = _runtime_mesh(n_bands, dev)
    _runtime_time_mesh(n_time, dev)

    fft, p_bands, p_time, t_frames = _production_mesh(n_devices, dev)
    line = (
        f"dryrun_multichip OK: {n_devices} copies of {dev}, mesh bands={n_bands} time={n_time}, "
        f"toy scan {tuple(raw.shape)}, ddc {tuple(ddc.shape)}, runtime mesh topics={topics}, "
        f"production mesh {p_bands}x{p_time} (bands x time): bands-axis scan fft {fft}"
        + (f" + time-axis detection/DDC fft {fft} x {t_frames} frames over time={p_time}" if p_time > 1 else "")
    )
    print(line, flush=True)
    return line


def _production_mesh(n_devices: int, dev: torch.device) -> tuple:
    """The production mesh step once: the channelizer and the banded compact
    scan at 20.48 Msps / fft 131072 and the banded 2-slot DDC over the
    bands axis of an n_bands x n_time mesh of copies of ``dev``; with a time
    axis, the time-sharded detection and modulated-taps DDC too."""
    from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig, make_tables
    from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig
    from rtl_sdr_scanner_tpu_torch.ops.channelizer import init_channelizer_state, plan_channelizer
    from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss
    from rtl_sdr_scanner_tpu_torch.parallel.collectives import gather
    from rtl_sdr_scanner_tpu_torch.parallel.mesh import make_mesh

    frames = 5  # a DDC chain block-multiple at 20.48 Msps -> 16 kHz
    n_time = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_bands = n_devices // n_time
    cfg = ScanConfig.create(PROD_RATE, frames_per_block=frames)
    if cfg.fft_size != 131072 or cfg.decimator_factor != 3:
        raise RuntimeError(f"production geometry: fft {cfg.fft_size}, decimation {cfg.decimator_factor}")
    block = cfg.block_samples
    ddc_cfg = DdcConfig.create(PROD_RATE, 16000, PROD_SLOTS, block)
    group_size = int(np.ceil(16000 / cfg.step_hz))  # 103-bin windows
    plan = plan_channelizer(n_bands)
    mesh = make_mesh(n_bands, n_time, devices=[dev] * n_devices)
    wide_step = sharded_step(ss.make_sharded_wideband_step(cfg, group_size, PROD_TOP_K, mesh, plan, 1, n_bands),
                             "production wideband step")
    ddc_step = sharded_step(ss.make_sharded_banded_ddc(ddc_cfg, mesh, n_bands), "production banded DDC step")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pairs = torch.randint(-32, 32, (n_bands * block, 2), generator=gen, device=dev, dtype=torch.int8)
    rng = np.random.default_rng(0)
    shifts = rng.integers(-PROD_RATE // 2, PROD_RATE // 2, size=(n_bands, PROD_SLOTS))
    now = torch.from_numpy(((1 + np.arange(frames)) * cfg.frame_interval_ms).astype(np.int32)).to(dev)
    chan, scan, acc, packed, channels = wide_step(
        ss.replicate(init_channelizer_state(plan, dev), mesh),
        ss.init_banded_state(cfg, n_bands, mesh),
        ss.shard_bands(torch.zeros((n_bands, cfg.spectro_size), device=dev), mesh),
        ss.replicate(pairs, mesh),
        ss.replicate(now, mesh),
        ss.shard_bands(torch.full((n_bands, 16), -1, dtype=torch.int32, device=dev), mesh),
        ss.shard_bands(torch.ones((n_bands, cfg.fft_size), dtype=torch.bool, device=dev), mesh),
        ss.replicate(torch.tensor(8.0, device=dev), mesh),
        1.0,
    )
    _, rec = ddc_step(
        ss.init_banded_ddc_state(ddc_cfg, n_bands, mesh), channels,
        ss.shard_bands(make_tables(ddc_cfg, shifts, device=dev), mesh),
        ss.shard_bands(torch.ones((n_bands, PROD_SLOTS), device=dev), mesh),
    )
    packed_host = gather(packed, torch.device("cpu"))
    rec_host = gather(rec, torch.device("cpu"))
    if packed_host.shape[0] != n_bands or not torch.isfinite(packed_host).all() or rec_host.shape[0] != n_bands:
        raise RuntimeError(f"production mesh: packed {tuple(packed_host.shape)}, recordings {tuple(rec_host.shape)}")
    del chan, scan, acc, channels
    t_frames = _production_time_mesh(mesh, n_time, dev) if n_time > 1 else 0
    return cfg.fft_size, n_bands, n_time, t_frames


def _production_time_mesh(mesh, n_time: int, dev: torch.device) -> int:
    """The time axis at production shapes: one band's detection frames
    sharded over time (``make_time_sharded_scan``: 103-bin windows, the
    21-row averager ring across the seams) and the streaming modulated-taps
    DDC with its halos (``make_time_sharded_modtap_ddc``), both at 20.48
    Msps / fft 131072, int8 cs8 in (the PSD kernel on the card)."""
    from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig, make_tables
    from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import init_state as ddc_init
    from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig, init_scan_state
    from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss

    # divisible by n_time, >= grouping_y (21) frames a shard, and a DDC
    # block-multiple at 20.48 Msps -> 16 kHz
    frames = 50 if n_time == 2 else 25 * n_time
    cfg = ScanConfig.create(PROD_RATE, frames_per_block=frames)
    group = cfg.fft_size * cfg.decimator_factor
    group_size = int(np.ceil(16000 / cfg.step_hz))
    ddc_cfg = DdcConfig.create(PROD_RATE, 16000, PROD_SLOTS, cfg.block_samples)
    if not ss.time_sharded_modtap_fits(ddc_cfg, n_time):
        raise RuntimeError(f"the modulated-taps DDC does not split {n_time} ways at chunk {ddc_cfg.chunk}")
    scan_step = sharded_step(ss.make_time_sharded_scan(cfg, mesh, group_size, PROD_TOP_K), "production time scan")
    ddc_step = sharded_step(ss.make_time_sharded_modtap_ddc(ddc_cfg, mesh), "production time-sharded DDC")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    iq = torch.randint(-32, 32, (cfg.block_samples, 2), generator=gen, device=dev, dtype=torch.int8)
    now = torch.from_numpy(((1 + np.arange(frames)) * cfg.frame_interval_ms).astype(np.int32)).to(dev)
    _, body, _, _ = scan_step(
        init_scan_state(cfg, device=dev), iq.reshape(frames, group, 2), now,
        torch.full((16,), -1, dtype=torch.int32, device=dev), torch.ones(cfg.fft_size, dtype=torch.bool, device=dev),
        torch.tensor(8.0, device=dev),
    )
    tables = make_tables(ddc_cfg, np.array([250_000, -3_000_000]), device=dev)
    _, rec = ddc_step(ddc_init(ddc_cfg, device=dev), iq, tables)
    body = body.cpu()
    if body.shape[0] != frames or not torch.isfinite(body).all() or rec.shape[0] != PROD_SLOTS or rec.shape[2] != 2:
        raise RuntimeError(f"production time mesh: rows {tuple(body.shape)}, recording {tuple(rec.shape)}")
    return frames


def _replay_config(tmp: Path, rate: int, channels: int, seconds: float, seed: int, **tunables) -> dict:
    """One replay device over a noise capture of ``seconds`` at ``rate``."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import default_config_json

    center = 145_000_000
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    iq = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    cap = tmp / f"replay{seed}.cf32"
    iq.astype(np.complex64).view(np.float32).tofile(cap)
    raw = default_config_json()
    raw["tunables"] = {"frames_per_block": 4, "log_file_name": "", **tunables}
    raw["recording"] = {"max_noise_time_ms": 1000, "min_sample_rate": 16000, "min_time_ms": 1000, "step": 2500}
    span = rate // 2 if channels else 25000
    raw["devices"] = [{
        "enabled": True, "serial": "dryrun", "driver": "replay", "sample_rate": rate,
        "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
        "ranges": [{"start": center - span, "stop": center + span}],
        "file": str(cap), "file_format": "cf32", "channels": channels,
    }]
    return json.loads(json.dumps(raw))


def _runtime_mesh(n_bands: int, dev: torch.device) -> int:
    """A replay WidebandScanner with ``mesh_bands`` n over 2.5 s (past two
    spectrogram intervals); returns the count of payload topics."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner

    b = max(2, n_bands)
    with tempfile.TemporaryDirectory(prefix="dryrun_mesh_") as tmp:
        cfg = Config(_replay_config(Path(tmp), b * 64000, b, 2.5, 7, mesh_bands=n_bands))
        mqtt = NullMqtt()
        mqtt.keep_payloads = True
        scanner = WidebandScanner(cfg, cfg.devices[0], mqtt, recorders_count=b, device=dev, cards=[dev] * n_bands)
        if scanner._mesh is None or scanner._mesh.shape["bands"] != min(n_bands, b):
            raise RuntimeError("the runtime bands mesh did not engage")
        scanner.run_to_completion()
        scanner.stop()
        _sync(dev)
    topics = {t for t, _ in mqtt.published}
    if not topics:
        raise RuntimeError("the runtime bands mesh published nothing (expected spectrograms)")
    return len(topics)


def _runtime_time_mesh(n_time: int, dev: torch.device) -> None:
    """A replay Scanner with ``mesh_time`` max(2, n_time) on a 64 kHz band."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner

    n = max(2, n_time)
    with tempfile.TemporaryDirectory(prefix="dryrun_tmesh_") as tmp:
        cfg = Config(_replay_config(Path(tmp), 64000, 0, 2.5, 3, mesh_time=n))
        scanner = Scanner(cfg, cfg.devices[0], NullMqtt(), recorders_count=1, device=dev, cards=[dev] * n)
        if scanner.device._time_mesh is None or scanner.device._time_mesh.shape["time"] != n:
            raise RuntimeError("the runtime time mesh did not engage")
        scanner.run_to_completion()
        _sync(dev)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    dryrun_multichip(int(args[0]) if args else 4, device="cpu" if "--cpu" in sys.argv else None)
