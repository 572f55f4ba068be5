"""Band-hop scan scheduler (port of the JAX package's ``runtime/scanner.py``).

Reference: sources/scanner.cpp -- split configured ranges into <=sampleRate
hops (splitRanges over getRangeSplitSampleRate), then either park on a single
range forever or round-robin with RANGE_SCANNING_TIME dwell, holding on a
range while any recording is active (scanner.cpp:46-60).

The reference drives this from a dedicated thread against a live flowgraph;
here the scheduler is synchronous and pull-based -- each step() pulls one
block from the source through the device session -- which makes replay
deterministic and lets a thread wrapper (run()) provide the live behavior.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.runtime.config import Config, DeviceSpec
from rtl_sdr_scanner_tpu_torch.runtime.sdr_device import SdrDevice, unported_path
from rtl_sdr_scanner_tpu_torch.runtime.sources import make_source
from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import (
    format_frequency,
    get_range_split_sample_rate,
    split_ranges,
)

LABEL = "scanner"


class Scanner:
    def __init__(
        self,
        config: Config,
        device_spec: DeviceSpec,
        mqtt,
        recorders_count: int,
        loop_replay: bool = False,
        prefer_int8_ingest: Optional[bool] = None,
        device: DeviceLike = None,
        cards: Optional[Sequence[DeviceLike]] = None,
    ):
        device = resolve_device(device)  # a missing card raises before any source opens
        # refuse an unported path before the source opens its hardware
        reason = unported_path(config, device_spec, device)
        if reason is not None:
            raise NotImplementedError(reason)
        self._config = config
        self._tunables = config.tunables
        # set when the worker thread dies on a fatal source/pipeline error;
        # runtime/main.py exits on it (reference exit(1) parity)
        self.failed = False
        self._source = make_source(device_spec, loop=loop_replay, tunables=config.tunables)
        # wire clock: payload time = source epoch + stream-relative ms
        # (utils.cpp:14 getTime is epoch ms; replay sources report epoch 0 so
        # replay runs stay deterministic)
        self.device = SdrDevice(
            config,
            device_spec,
            mqtt,
            recorders_count,
            session_epoch_ms=getattr(self._source, "session_epoch_ms", 0),
            device=device,
            cards=cards,
        )
        self._noise_path = (
            f"{config.tunables.noise_state_path}.{device_spec.name}.npz"
            if config.tunables.noise_state_path
            else None
        )
        if self._noise_path:
            import os

            if os.path.exists(self._noise_path):
                self.device.load_noise_state(self._noise_path)
        self._ranges: List[Tuple[int, int]] = split_ranges(
            device_spec.ranges, get_range_split_sample_rate(device_spec.sample_rate)
        )
        self._int8_ingest = (
            prefer_int8_ingest
            if prefer_int8_ingest is not None
            else self._tunables.int8_ingest
        )
        self._range_index = -1
        self._dwell_start_ms = 0
        self._pending_skip = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # pipelined ingest: one block in flight on the device while the host
        # consumes the previous one (tunable; changes hop timing by <= 1 block)
        self._pipelined = self._tunables.pipelined_ingest
        self._inflight: Optional[tuple] = None  # (handle, end_ms)

        logger.info(LABEL, "scan ranges: {}", len(device_spec.ranges))
        for rng in device_spec.ranges:
            logger.info(
                LABEL, "scan range: {} - {}", format_frequency(rng[0]), format_frequency(rng[1])
            )
        logger.info(LABEL, "splitted scan ranges: {}", len(self._ranges))
        for rng in self._ranges:
            logger.info(
                LABEL,
                "splitted scan range: {} - {}",
                format_frequency(rng[0]),
                format_frequency(rng[1]),
            )

    # -- scheduling --------------------------------------------------------

    def _hop(self, now_ms: int) -> None:
        first_tune = self._range_index < 0
        self._range_index = (self._range_index + 1) % len(self._ranges)
        rng = self._ranges[self._range_index]
        if first_tune and not _is_replay(self._source):
            # first-tune warmup (INITIAL_DELAY, sdr_device.cpp:55-61): let the
            # front-end settle before the first samples count
            time.sleep(self._tunables.initial_delay_ms / 1000.0)
        self._source.set_center_frequency((rng[0] + rng[1]) // 2)
        self.device.set_frequency_range(rng, now_ms)
        self._dwell_start_ms = now_ms
        # drop one stale block after retune (sdr_device.cpp:78 skip) --
        # meaningful only for hardware sources whose pipeline has stale data
        self._pending_skip = not _is_replay(self._source)

    def step(self) -> bool:
        """Process one block. Returns False when the source is exhausted."""
        if not self._ranges:
            logger.warn(LABEL, "empty scanned ranges")
            return False
        now_ms = self._source.stream_time_ms()
        if self._range_index < 0:
            self._hop(now_ms)

        block = self._read_block()
        if block is None:
            if self._inflight is not None:  # drain the pipeline
                handle, end_ms = self._inflight
                self._inflight = None
                self.device.finish_block(handle)
                self._maybe_hop(end_ms)
            return False
        if self._pending_skip:
            self._pending_skip = False
            return True

        now_ms = self._source.stream_time_ms()
        start_ms = now_ms - self._block_ms()
        if not self._pipelined:
            self.device.process_block(block, block_start_ms=start_ms)
            self._maybe_hop(now_ms)
            return True

        handle = self.device.submit_block(block, start_ms)
        if self._inflight is not None:
            prev_handle, prev_end = self._inflight
            self.device.finish_block(prev_handle)
            hopped = self._maybe_hop(prev_end)
            if hopped:
                # the just-submitted block belongs to the old range; the
                # reference likewise drops stale data on retune
                self._inflight = None
                return True
        self._inflight = (handle, now_ms)
        return True

    def _maybe_hop(self, now_ms: int) -> bool:
        if len(self._ranges) > 1:
            dwell_over = (
                now_ms - self._dwell_start_ms >= self._tunables.range_scanning_time_ms
            )
            # hold while a transmission is active (scanner.cpp:52-56)
            if dwell_over and not self.device.last_notification:
                self._hop(now_ms)
                return True
        return False

    def _block_ms(self) -> int:
        cfg = self.device.scan_cfg
        return int(cfg.block_samples * 1000 / cfg.sample_rate)

    def _read_block(self):
        n = self.device.scan_cfg.block_samples
        if self._int8_ingest:
            raw = self._source.read_block_int8(n)
            if raw is not None:
                return raw
        return self._source.read_block(n)

    def manual_record(self, frequency: int, duration_ms: int) -> bool:
        """Queue a manual recording if any configured range covers frequency
        (extension; the reference stubs sdr/manual_recording)."""
        if not any(lo <= frequency <= hi for lo, hi in self._ranges):
            return False
        self.device.request_manual_recording(frequency, duration_ms)
        return True

    # -- lifecycle ---------------------------------------------------------

    def run_to_completion(self) -> None:
        """Drain a replay source synchronously. With ``tunables.profile_dir``
        the run is traced (``trace_<device>.json``): on the card the blocks
        replay captured CUDA graphs (``graph.py``), so the trace shows graph
        launches and their kernels, not the step's stage ranges, which are
        recorded once, at the capture."""
        profile_dir = self._tunables.profile_dir
        if profile_dir:
            import os

            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.torch_device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                while self.step():
                    pass
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, f"trace_{self.device.torch_device.type}.json")
            prof.export_chrome_trace(path)
            logger.info(LABEL, "profiler trace written to {}", path)
            return
        while self.step():
            pass

    def start(self) -> None:
        """Live mode: worker thread like the reference scanner thread."""
        if hasattr(self._source, "start_streaming"):
            # hardware sources decouple USB reads from the device feeder
            # through the native ingest ring (native/ring.cpp)
            self._source.start_streaming()
        self._running = True

        dev = self.device.torch_device

        def worker():
            logger.info(LABEL, "thread started")
            try:
                if dev.type == "cuda":
                    # the current card is a per-thread setting
                    torch.cuda.set_device(dev)
                while self._running:
                    if not self.step():
                        break
            except Exception as exc:
                # fatal source/pipeline error: surface it LOUDLY and mark
                # the scanner failed so the lifecycle can exit. The
                # reference exit(1)s on a stream error and relies on the
                # container supervisor to restart (sdr_source.cpp:38-41);
                # a silently-dead thread would scan nothing forever.
                self.failed = True
                logger.error(LABEL, "scanner thread failed: {}", exc)
            logger.info(LABEL, "thread stopped")

        thread = threading.Thread(target=worker, name="scanner", daemon=True)
        thread.start()
        # published once running: a watcher that reads "not alive" from it
        # then knows the worker has ended, not that it has yet to begin
        self._thread = thread

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # release the hardware: stop the reader thread and close the stream
        # (reference SdrDevice dtor stops the flowgraph, sdr_device.cpp:47-52)
        if hasattr(self._source, "stop_streaming"):
            self._source.stop_streaming()
        if hasattr(self._source, "close"):
            self._source.close()
        # final spectrogram flush: don't drop the last partial send-interval
        self.device.flush_spectrogram(self._source.stream_time_ms())
        if self._noise_path:
            self.device.save_noise_state(self._noise_path)


def _is_replay(source) -> bool:
    from rtl_sdr_scanner_tpu_torch.runtime.sources import ReplaySource

    return isinstance(source, ReplaySource)
