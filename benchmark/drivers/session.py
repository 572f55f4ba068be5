"""Timed loop of a dongle's session: ``runtime.scanner.Scanner.step()``
(``SdrDevice``'s graphed scan and DDC steps, its tracker and
``DataController``), serial ingest, publishing through the port's ``NullMqtt`` into the harness's hands.

The scanner reads from the benchmark's own source, ``LoopedCapture``: a
seeded cs8 capture held in memory (``traffic/session_capture.py``), looped,
with a sample clock that keeps counting across the wrap as a live dongle's
does (the port's ``ReplaySource(loop=True)`` rewinds it). It is handed to
the scanner by setting ``Scanner._source`` before the first ``step()``; it
subclasses ``ReplaySource`` so that the scanner treats it as a replay (no
retune settling, no skipped block).

Set-up builds the scanner at the configuration's geometry, runs the noise
learning and ``warm_blocks`` more blocks (the DDC's first recordings among
them); then the window calls ``step()`` for ``seconds``. Once it has
closed, the scanner is freed and ``reference/payloads.py`` judges what it
published.
"""

from __future__ import annotations

import gc
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from benchmark.drivers.step import tunables as step_tunables
from benchmark.harness import Cell, Outcome
from benchmark.reference import payloads as judge
from benchmark.trace import Tracer


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def block_samples(config: dict) -> int:
    return config["frames_per_block"] * config["fft_size"] * config["decimator_factor"]


def runtime_config(config: dict, placeholder: Path) -> dict:
    """The scanner's configuration: one replay device parked on the
    configuration's range, its recording settings and pool, serial int8
    ingest, logs at warn on the console only."""
    t = step_tunables(config)
    lo, hi = config["range_hz"]
    return {
        "devices": [{
            "enabled": True, "serial": "bench0", "driver": "replay", "sample_rate": config["sample_rate"],
            "start_recording_level": config["start_level_db"], "stop_recording_level": config["stop_level_db"],
            "gains": [], "ranges": [{"start": lo, "stop": hi}], "file": str(placeholder), "file_format": "cs8",
        }],
        "ignored_frequencies": [],
        "output": {"color_log_enabled": False, "console_log_level": "warn", "file_log_level": "warn"},
        "recording": {"max_noise_time_ms": config["recording_timeout_ms"],
                      "min_sample_rate": config["recording_rate"],
                      "min_time_ms": config["recording_min_time_ms"], "step": config["tuning_step_hz"]},
        "tunables": {"log_file_name": "", "frames_per_block": config["frames_per_block"],
                     "pipelined_ingest": False, "int8_ingest": True, "compact_detection": True,
                     "detection_bf16": t.detection_bf16, "power_bf16": t.power_bf16,
                     "noise_learning_time_ms": t.noise_learning_time_ms, "grouping_x": t.grouping_x,
                     "grouping_y": t.grouping_y, "detection_top_k": t.detection_top_k,
                     "detection_key_slots": config["key_slots"]},
        "version": 2,
        "workers": config["session_slots"],
    }


def looped_source(capture, rate: int):
    """A ``ReplaySource`` over ``capture`` whose stream clock keeps counting
    across the capture's wrap; it notes the host clock as each block is taken."""
    from rtl_sdr_scanner_tpu_torch.runtime.sources import ReplaySource

    class LoopedCapture(ReplaySource):
        def __init__(self):  # no file: the capture is in memory
            self._rate, self._format, self._loop = rate, "cs8", True
            self._offset, self._center, self._exhausted = 0, 0, False
            self._total = capture.blocks * capture.block
            self.taken: List[float] = []  # host clock as each block was taken

        def read_block_int8(self, n_samples: int):
            if n_samples != capture.block:
                raise ValueError(f"the scanner reads {n_samples} samples a block, the capture holds {capture.block}")
            self.taken.append(time.perf_counter())
            k = self._offset // n_samples
            self._offset += n_samples
            return capture.block_iq(k)

        def read_block(self, n_samples: int):
            raise RuntimeError("the benchmark feeds int8 blocks only")

    return LoopedCapture()


def sink(source_blocks):
    """The port's ``NullMqtt``, keeping each payload with the number of
    blocks the source had handed out when it was published."""
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt

    class Sink(NullMqtt):
        def publish(self, topic: str, payload, qos: int = 0) -> None:
            self.published.append((topic, bytes(payload), source_blocks()))

    return Sink()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: bool = False) -> Outcome:
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner

    c = cell.config
    cuda = device.type == "cuda"
    if cuda:
        from rtl_sdr_scanner_tpu_torch.ops.cuda import build

        build.library()
    block = block_samples(c)
    capture = cell.generator().SessionCapture(cell.traffic, c, seed, device, block)
    source = looped_source(capture, c["sample_rate"])
    mqtt = sink(lambda: len(source.taken))
    with tempfile.TemporaryDirectory() as tmp:
        placeholder = Path(tmp) / "placeholder.cs8"
        placeholder.write_bytes(bytes(4))
        cfg = Config(json.loads(json.dumps(runtime_config(c, placeholder))))
        scanner = Scanner(cfg, cfg.devices[0], mqtt, cfg.recorders_count(), device=device)
    scanner._source = source
    check_geometry(scanner, c)

    for _ in range(cell.spec["warm_blocks"]):
        scanner.step()
    if cell.traffic["transmitters"] and not any(t.endswith("/transmission/uint8") for t, _, _ in mqtt.published):
        raise RuntimeError("no recording was published in the warm-up: the DDC would build inside the window")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    warm = len(source.taken)
    setup_s = time.perf_counter() - t_start

    lat_ms = []
    with Tracer(trace, cuda, hosts=("bench.", "session.")) as tracer:
        with tracer.window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with tracer.range("bench.step"):
                    scanner.step()
                lat_ms.append((time.perf_counter() - source.taken[-1]) * 1e3)
            t1 = time.perf_counter()
    blocks = len(source.taken) - warm
    launches = {name: fn.launches for name, fn in wrappers.items()}
    memory_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    reduced = None
    if trace:
        reduced = tracer.reduce()
        reduced.blocks, reduced.cell = blocks, cell
    stream_s = blocks * block / c["sample_rate"]
    e2e = {
        "session_rtf": stream_s / (t1 - t0),
        "session_latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "setup_s": setup_s,
    }
    log(f"window: {blocks} blocks ({stream_s:.2f} s of stream) in {t1 - t0:.3f} s; latency median "
        f"{np.median(lat_ms):.3f} ms, p95 {e2e['session_latency_ms_p95']:.3f} ms; launches {launches}")

    del scanner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tr = time.perf_counter()
    numbers, control_numbers, seen = judge.judge_session(
        c, cell.spec, capture, mqtt.published, warm, warm + blocks, device, control)
    log(f"reference: {seen} judged in {time.perf_counter() - tr:.1f} s")
    return Outcome(end_to_end=e2e, numbers=numbers, limits=dict(cell.spec["limits"]), attempted=blocks,
                   memory_peak_bytes=int(memory_peak), trace=reduced, control=control_numbers)


def check_geometry(scanner, c: dict) -> None:
    cfg, ddc = scanner.device.scan_cfg, scanner.device.ddc_cfg
    have = (cfg.fft_size, cfg.decimator_factor, cfg.frames_per_block, [[p.interp, p.decim] for p in ddc.plans],
            len(scanner.device._recorders))
    want = (c["fft_size"], c["decimator_factor"], c["frames_per_block"], c["ddc_stages"], c["session_slots"])
    if have != want:
        raise ValueError(f"the session plans (fft, decim, frames, DDC stages, slots) {have}, "
                         f"the configuration states {want}")
