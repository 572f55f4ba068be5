"""Device session: owns the block steps and the recorder slot pool (port of
the JAX package's ``runtime/sdr_device.py``).

Reference: sources/radio/sdr_device.cpp (SdrDevice). The GR flowgraph becomes
two device programs a block (``models/scan_pipeline``: compact or full-row
detection; ``models/ddc_pipeline``: the K-slot recorder bank); the
dynamically attached recorder chains become K batched slots reconciled by the
same rules as SdrDevice::updateRecordings (sdr_device.cpp:82-144): stop
stale, flush active, assign free, log-once overflow.

Per-retune behavior mirrors setFrequencyRange (sdr_device.cpp:54-80): gate the
stream, retune, reset the transmission tracker + averager, drop one stale
block. Noise-floor state is keyed by center frequency and persists across
hops (NoiseLearner::resetBuffers is never called in the reference).

On the card, a block costs one asynchronous host-to-device copy of the IQ
and one of the per-block vectors (through reusable pinned buffers), the
dispatch, and one device-to-host read of the packed detector vector (plus
the recording rows while a slot records): ``submit_block`` never waits for
the card, so pipelined ingest overlaps block b+1 with block b's host work.
The one-card scan and DDC steps are ``graph.donated_step``s: each replays
one captured CUDA graph a block and carries its state in place. The time
mesh's are ``graph.sharded_step``s: a graph a shard and segment between
the exchanges, each replayed once a block (the DDC's loop over its chunks
inside).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.constants import Tunables
from rtl_sdr_scanner_tpu_torch import native
from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.graph import donated_step, sharded_step
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import (
    ScanConfig,
    ScanState,
    init_scan_state,
    init_spectro_acc,
    make_compact_scan_step,
    make_scan_step,
    unpack_compact,
)
from rtl_sdr_scanner_tpu_torch.ops.ddc import chain_block_multiple, plan_chain
from rtl_sdr_scanner_tpu_torch.ops.noise import NoiseState
from rtl_sdr_scanner_tpu_torch.runtime.config import Config, DeviceSpec
from rtl_sdr_scanner_tpu_torch.runtime.data_controller import DataController
from rtl_sdr_scanner_tpu_torch.runtime.file_sink import FileSink
from rtl_sdr_scanner_tpu_torch.runtime.transmission_tracker import FrequencyFlush, TransmissionTracker
from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.perf import PerformanceLogger
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import format_frequency, get_tuned_frequency
from rtl_sdr_scanner_tpu_torch.utils.trace import span

LABEL = "sdr"

# the host-side profiler ranges one block opens, in the order it runs them
# (cheap when no profiler records; scripts/profile_torch_main_path.py
# --path session reads them)
STAGES = (
    "session.upload",
    "session.scan",
    "session.fetch",
    "session.tracker",
    "session.reconcile",
    "session.ddc",
    "session.spectrogram",
)


def visible_cards(device: torch.device) -> int:
    """Cards a bands mesh could span from ``device``: the visible CUDA
    devices on the card, one on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def mesh_bands_cards(mesh_bands: int, channels: int, cards: int) -> int:
    """Cards a wideband device's bands mesh resolves to (the reference's
    ``WidebandScanner._setup_mesh``): all cards for -1, at most the cards
    and the channels, shrunk until it divides the channels."""
    n = cards if mesh_bands < 0 else mesh_bands
    n = max(1, min(n, cards, channels))
    while channels % n != 0:
        n -= 1
    return n


def _channel_rate(config: Config, spec: DeviceSpec) -> int:
    """The sample rate a session of this device scans: a wideband device's
    channel stream (2R/B when oversampled), else the device's rate."""
    if spec.channels < 2:
        return spec.sample_rate
    oversample = 2 if config.tunables.channelizer_oversample == 2 else 1
    return spec.sample_rate // spec.channels * oversample


def _kernel_refusal(config: Config, spec: DeviceSpec) -> Optional[str]:
    """A geometry of this device that a kernel on its card does not take:
    compact detection at an fft below ``detection_top_k`` (the JAX package's
    top-k raises on it too), an int8 fft above the PSD kernel's 2^24 (a
    band above 4.194304 Gsps at 250 Hz bins; or of 1, a band below 250 sps),
    or a wideband device of more channels than the analysis-bank kernel's
    4096. The selection kernel takes every power-of-two fft, and every fft
    here is one."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda.channelizer_kernel import MAX_CHANNELS
    from rtl_sdr_scanner_tpu_torch.ops.cuda.psd_kernel import takes_fft as psd_takes_fft

    t = config.tunables
    rate = _channel_rate(config, spec)
    fft = ScanConfig.create(rate, tunables=t).fft_size
    if t.compact_detection and fft < t.detection_top_k:
        return (
            f"device {spec.name}: fft {fft} at {rate} sps is below detection_top_k {t.detection_top_k}, "
            "which the selection kernel on the card cannot take (the JAX package's top-k raises on it too)"
        )
    # a wideband device's channels reach the scan as f32 pairs (no PSD kernel)
    if spec.channels < 2 and t.int8_ingest and not psd_takes_fft(fft):
        return (
            f"device {spec.name}: fft {fft} at {rate} sps is outside the int8 PSD kernel's [2, 2^24] "
            "on the card; set tunables.int8_ingest=false"
        )
    if spec.channels > MAX_CHANNELS:
        return f"device {spec.name}: {spec.channels} channels, above the analysis-bank kernel's {MAX_CHANNELS} on the card"
    return None


def session_cards(device: torch.device, cards: Optional[Sequence[torch.device]]) -> int:
    """Cards a session's meshes may span: its explicit ``cards`` where the
    caller gave them, else the visible cards."""
    return len(cards) if cards is not None else visible_cards(device)


def mesh_devices(
    device: torch.device, n: int, cards: Optional[Sequence[torch.device]] = None
) -> List[torch.device]:
    """The devices of an n-shard mesh a session on ``device`` builds: the
    first n of its explicit ``cards`` where the caller gave them (a dry run
    gives n copies of one card); else the session's own device for one
    shard, cards 0..n-1 on the card (the reference's ``jax.devices()[:n]``),
    and n copies of the CPU device on the CPU, where the tests reach n > 1
    by patching ``visible_cards``."""
    if cards is not None:
        return list(cards[:n])
    if n == 1:
        return [device]
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def unported_path(
    config: Config, spec: Optional[DeviceSpec] = None, device: Optional[torch.device] = None
) -> Optional[str]:
    """Why this config (and device, scanned on the torch ``device``) needs a
    path the port does not have, or a geometry its card's kernels do not
    take; None when it runs. Every path of the JAX package is ported, and
    the kernels take every geometry the JAX package scans but three:
    compact detection below ``detection_top_k`` (which the JAX package
    cannot run either), an int8 fft above 2^24 and a wideband device of
    more than 4096 channels. The time and band shards of
    a mesh run the kernels at the device's own fft (a shard holds fewer
    frames or bands, never narrower rows), so the kernel check covers them
    too, on every process of a multi-host run."""
    if spec is not None and device is not None and device.type == "cuda":
        return _kernel_refusal(config, spec)
    return None


class RecorderSlot:
    """Host bookkeeping for one DDC slot (reference Recorder, recorder.cpp)."""

    def __init__(self, index: int):
        self.index = index
        self.shift: Optional[int] = None
        self.frequency: Optional[int] = None
        self.first_ms = 0
        self.last_ms = 0
        self.pending: List[Tuple[int, np.ndarray]] = []  # (stream_ms, int8 [n,2])
        # fraction of the current block already elapsed when recording
        # started; the first DDC output is trimmed to it so the recording
        # begins at the detection frame, like the reference's blocker opening
        # mid-stream (recorder.cpp:68)
        self.start_fraction = 0.0

    @property
    def is_recording(self) -> bool:
        return self.shift is not None


class PackedOuts:
    """Stand-in for CompactScanOutputs where a step returns packed rows by
    other means (the time mesh; a wideband owner's banded step):
    finish_block reads only .packed."""

    def __init__(self, packed):
        self.packed = packed


class SpectroContainer:
    """Per-center-frequency spectrogram accumulator (spectrogram.cpp:9,45-60)."""

    def __init__(self, size: int, now_ms: int):
        self.sum = np.zeros(size, dtype=np.float64)
        self.counter = 0
        self.last_send_ms = now_ms


class HostStage:
    """Host-to-device copies through reusable pinned buffers.

    On the card a pageable copy synchronises the stream; a copy from pinned
    memory with ``non_blocking=True`` does not. Each shape keeps ``depth``
    pinned buffers; one is refilled only after the copies that last read it
    have run (an event per copy), so a caller may hold ``depth - 1`` blocks
    in flight. ``upload_to`` copies one fill to several devices (the band
    shards of a mesh). Every upload lands in a fresh device tensor the caller owns.
    On the CPU an upload is a plain copy (replay blocks are read-only
    views of the capture file).
    """

    def __init__(self, device: torch.device, depth: int = 3):
        self._dev = device
        self._depth = depth
        self._rings: Dict[tuple, list] = {}
        self._turn: Dict[tuple, int] = {}

    def upload(self, array: np.ndarray) -> torch.Tensor:
        return self.upload_to(array, [self._dev])[0]

    def upload_to(self, array: np.ndarray, devices) -> List[torch.Tensor]:
        """One copy of ``array`` on each of ``devices`` from one pinned fill
        (a device named twice gets the same tensor)."""
        if self._dev.type != "cuda":
            out = torch.from_numpy(np.array(array))
            return [out.to(d) for d in devices]
        key = (array.dtype.str, array.shape)
        ring = self._rings.setdefault(key, [])
        turn = self._turn.get(key, 0)
        self._turn[key] = (turn + 1) % self._depth
        if turn == len(ring):
            dtype = torch.from_numpy(np.empty(0, dtype=array.dtype)).dtype
            ring.append([torch.empty(array.shape, dtype=dtype, pin_memory=True), ()])
        buf, pending = ring[turn]
        for done in pending:
            done.synchronize()
        buf.numpy()[...] = array
        outs, events = {}, []
        for dev in devices:
            if dev not in outs:
                out = torch.empty(buf.shape, dtype=buf.dtype, device=dev)
                out.copy_(buf, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                outs[dev] = out
                events.append(done)
        ring[turn][1] = tuple(events)
        return [outs[dev] for dev in devices]


class SdrDevice:
    def __init__(
        self,
        config: Config,
        spec: DeviceSpec,
        mqtt,
        recorders_count: int,
        session_epoch_ms: int = 0,
        device: DeviceLike = None,
        cards: Optional[Sequence[DeviceLike]] = None,
    ):
        """``cards``: the devices this session's time mesh may span (default:
        the visible cards)."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        reason = unported_path(config, spec, dev)
        if reason is not None:
            raise NotImplementedError(reason)
        self.torch_device = dev
        self._cards = None if cards is None else [resolve_device(d) for d in cards]
        self._config = config
        self._device = spec
        self._tunables = config.tunables
        self._data_controller = DataController(mqtt, spec.name)
        self._session_epoch_ms = session_epoch_ms
        self._stage = HostStage(dev)
        # build (first run) and load the host codecs now: built at first
        # use, the g++ run would stall the block that encodes the first payload
        native.native_available()

        self.scan_cfg = ScanConfig.create(
            spec.sample_rate,
            frames_per_block=self._tunables.frames_per_block,
            tunables=self._tunables,
        )
        # block length must also satisfy the DDC chain divisibility
        self.scan_cfg = _fix_block_multiple(
            self.scan_cfg, spec.sample_rate, config.recording_bandwidth, self._tunables
        )
        self.ddc_cfg = ddc_pipeline.DdcConfig.create(
            spec.sample_rate,
            config.recording_bandwidth,
            recorders_count,
            self.scan_cfg.block_samples,
            self._tunables.resampler_threshold,
        )
        cfg = self.scan_cfg
        # groupSize = recording bandwidth in bins (sdr_device.cpp:151)
        self._group_size = int(math.ceil(config.recording_bandwidth / cfg.step_hz))
        t = self._tunables
        # debug raw-dump taps (reference sdr_device.cpp:173-181,
        # recorder.cpp:42-45); power taps need full rows, so they force
        # full-row mode
        self._power_sink = FileSink("full", "power") if t.debug_save_full_power else None
        self._raw_iq_sink = FileSink("full", "fc") if t.debug_save_full_raw_iq else None
        self._raw_iq_sink_starved_logged = False
        self._rec_sinks = (
            [FileSink("recording", "cs8") for _ in range(recorders_count)]
            if t.debug_save_recording_raw_iq
            else None
        )
        self._compact = t.compact_detection
        if self._power_sink is not None and self._compact:
            logger.warn(LABEL, "debug_save_full_power forces full-row detection mode")
            self._compact = False
        self._time_mesh = None
        self.tmesh_ddc = False
        if self._compact and t.mesh_time > 0:
            self._setup_time_mesh(config, recorders_count)
            cfg = self.scan_cfg
        elif self._compact:
            # the one-card steps carry their state in place, one captured
            # graph a geometry (graph.py; the JAX package's donate_argnums)
            self._scan_step = donated_step(
                make_compact_scan_step(cfg, self._group_size, t.detection_top_k, device=dev), donate=(0, 1),
                name="compact scan step",
            )
        else:
            if t.mesh_time > 0:
                logger.warn(LABEL, "mesh_time needs compact detection; staying serial")
            self._scan_step = donated_step(make_scan_step(cfg, device=dev), donate=(0,), name="full-row scan step")
        if not self.tmesh_ddc:  # _setup_time_mesh may install the time-sharded DDC
            self._ddc_step = donated_step(
                ddc_pipeline.make_ddc_step(self.ddc_cfg, device=dev), donate=(0,), name="DDC step"
            )
        self._valid_mask_dev = None  # per-retune device copy of the bin mask
        # the start level on the device, made once: no per-block copy
        self._start_level_dev = torch.tensor(float(spec.start_level), dtype=torch.float32, device=dev)

        logger.info(
            LABEL,
            "signal detection, fft: {}, step: {}, decimator factor: {}",
            cfg.fft_size,
            format_frequency(int(cfg.step_hz)),
            cfg.decimator_factor,
        )

        self._frequency_range: Tuple[int, int] = (0, 0)
        self._scan_state: Optional[ScanState] = None
        # per-center noise states in the single-band layout the step
        # returns: snapshots (clones) taken when the session leaves a center
        # where it scanned, since the live state is the step's donated
        # buffers, which the next center's state overwrites
        self._noise_states: Dict[int, NoiseState] = {}
        self._pending_noise_center: Optional[int] = None
        self._noise_scanned = False  # a block ran at the live center since it was tuned

        self._tracker = TransmissionTracker(
            fft_size=cfg.fft_size,
            group_size=self._group_size,
            start_level=spec.start_level,
            stop_level=spec.stop_level,
            recording_min_time_ms=config.recording_min_time_ms,
            recording_timeout_ms=config.recording_timeout_ms,
            tuning_step=config.recording_tuning_step,
            index_to_shift=cfg.index_to_shift,
            index_to_frequency=lambda i: cfg.index_to_frequency(i, self.center_frequency),
            is_index_in_range=self._is_index_in_range,
            ignored_ranges=config.ignored_ranges,
            tunables=self._tunables,
        )

        self._recorders = [RecorderSlot(i) for i in range(recorders_count)]
        self._ddc_state = ddc_pipeline.init_state(self.ddc_cfg, device=dev)
        self._ddc_tables = ddc_pipeline.make_tables(
            self.ddc_cfg, np.zeros(recorders_count, dtype=np.int64), device=dev
        )
        self._ignored_transmissions: Set[int] = set()
        # when an owner (WidebandScanner's one-dispatch forms) runs the DDC
        # for all channels at once, this session only records slot
        # start/stop events for it instead of touching its own device carry
        self.external_ddc = False
        self._slot_events: List[Tuple[int, int, bool]] = []  # (slot, shift, started)

        self._spectro_containers: Dict[int, SpectroContainer] = {}
        # compact mode accumulates the spectrogram bin sum ON DEVICE
        # (scan_pipeline.init_spectro_acc); the host fetches it only at the
        # 1 Hz send cadence / on retune instead of every block
        self._spectro_acc = None
        self._spectro_pending_frames = 0
        # after a drain the device accumulator is reset ON DEVICE: the next
        # submit passes spectro_keep=0.0 (no host->device re-upload)
        self._spectro_reset_pending = False
        # manual recordings (extension; the reference stubs sdr/manual_recording,
        # remote_controller.cpp:45): absolute frequency -> remaining duration or
        # expiry stream-ms once armed
        self._manual_requests: List[Tuple[int, int]] = []  # (frequency, duration_ms)
        self._manual_active: Dict[int, int] = {}  # frequency -> expiry stream ms
        self._last_notification: List[FrequencyFlush] = []
        self._perf = PerformanceLogger("PSD", self._tunables)

        logger.info(
            LABEL,
            "driver: {}, serial: {}, sample rate: {}, recorders: {}, device: {}",
            spec.driver,
            spec.serial,
            format_frequency(spec.sample_rate),
            recorders_count,
            dev,
        )

    # -- time-axis mesh (tunables.mesh_time) ---------------------------------

    def _setup_time_mesh(self, config: Config, recorders_count: int) -> None:
        """One band's detection frames split over an N-device time mesh
        (``parallel/sharded_scan.make_time_sharded_scan``), N = mesh_time
        resolved against the visible cards. Under multi-host too the mesh
        stays on this process's cards (the reference takes
        ``jax.devices()[:n]``, which may reach another host's): the time
        axis never crosses a process (``parallel/multihost.py``). The
        detector carries are stitched across the shard seams; the host
        consumes the same compact rows. Recording shards over the same mesh
        where the chain splits exactly (``make_time_sharded_modtap_ddc``);
        otherwise the DDC stays on one device, with a warning. The sharded
        steps run graphed (``graph.sharded_step``)."""
        from rtl_sdr_scanner_tpu_torch.parallel.mesh import make_mesh
        from rtl_sdr_scanner_tpu_torch.parallel.sharded_scan import (
            make_time_sharded_modtap_ddc,
            make_time_sharded_scan,
            time_sharded_modtap_fits,
        )

        dev = self.torch_device
        n = min(self._tunables.mesh_time, session_cards(dev, self._cards))
        cfg = self.scan_cfg
        # frames must split evenly with >= grouping_y frames a shard AND
        # keep the DDC block divisibility already folded into frames
        base = cfg.frames_per_block
        frames = base
        while frames % n != 0 or frames // n < cfg.grouping_y:
            frames += base
        if frames != base:
            logger.info(LABEL, "frames per block adjusted for time mesh: {} -> {}", base, frames)
            self.scan_cfg = cfg = dataclasses.replace(cfg, frames_per_block=frames)
            self.ddc_cfg = ddc_pipeline.DdcConfig.create(
                self._device.sample_rate,
                config.recording_bandwidth,
                recorders_count,
                cfg.block_samples,
                self._tunables.resampler_threshold,
            )
        self._time_mesh = make_mesh(n_bands=1, n_time=n, devices=mesh_devices(dev, n, self._cards))
        self._scan_step = sharded_step(
            make_time_sharded_scan(cfg, self._time_mesh, self._group_size, self._tunables.detection_top_k),
            "time-sharded scan step",
        )
        if time_sharded_modtap_fits(self.ddc_cfg, n):
            self._ddc_step = sharded_step(
                make_time_sharded_modtap_ddc(self.ddc_cfg, self._time_mesh), "time-sharded DDC step"
            )
            self.tmesh_ddc = True
            logger.info(LABEL, "time-sharded DDC active ({} shards)", n)
        else:
            logger.warn(LABEL, "DDC chain does not split {} ways; recording stays single-device", n)
        logger.info(LABEL, "time mesh: {} devices, {} frames/shard", n, frames // n)

    # -- geometry ----------------------------------------------------------

    @property
    def center_frequency(self) -> int:
        return (self._frequency_range[0] + self._frequency_range[1]) // 2

    def _is_index_in_range(self, index: int) -> bool:
        f = self.scan_cfg.index_to_frequency(index, self.center_frequency)
        return self._frequency_range[0] <= f <= self._frequency_range[1]

    @property
    def is_recording(self) -> bool:
        return any(r.is_recording for r in self._recorders)

    @property
    def last_notification(self) -> List[FrequencyFlush]:
        return self._last_notification

    def recording_slot_indices(self) -> set:
        """Indices of slots currently recording (the fused wideband dispatch
        snapshots these at dispatch time to gate ingest_ddc_out)."""
        return {rec.index for rec in self._recorders if rec.is_recording}

    def recording_slots(self) -> Dict[int, Tuple[int, int]]:
        """slot index -> (shift, start ms) of every recording slot: which
        recording a slot holds, so that a slot stopped and reused (at any
        shift) reads as another recording."""
        return {rec.index: (rec.shift, rec.first_ms) for rec in self._recorders if rec.is_recording}

    def clear_slot_start_trim(self, slots) -> None:
        """Void the in-block start trim for ``slots`` (fused dispatch: a slot
        started during this block's host processing records from the NEXT
        block, which is wholly post-start)."""
        for rec in self._recorders:
            if rec.index in slots:
                rec.start_fraction = 0.0

    def wants_raw_iq(self) -> bool:
        """True when the debug raw-IQ file sink is live and recording, i.e.
        an owner that can supply an f32 IQ stream should keep feeding one."""
        return self._raw_iq_sink is not None and self._raw_iq_sink.recording

    # -- retune ------------------------------------------------------------

    def set_frequency_range(self, frequency_range: Tuple[int, int], now_ms: int) -> None:
        """sdr_device.cpp:54-80 minus the hardware-source blocking dance
        (gating is implicit: the host does not feed blocks while retuning)."""
        if self._power_sink is not None:
            self._power_sink.stop()
        if self._raw_iq_sink is not None:
            self._raw_iq_sink.stop()
        # fold the device spectrogram accumulator into the OLD center's
        # container before the center changes (per-center containers persist
        # across hops, spectrogram.cpp:29-43)
        self._drain_spectro_acc(now_ms)
        self._frequency_range = frequency_range
        center = self.center_frequency
        if self._power_sink is not None:
            self._power_sink.start(center, self._device.sample_rate)
        if self._raw_iq_sink is not None:
            self._raw_iq_sink.start(center, self._device.sample_rate)
        self._tracker.reset()
        for rec in self._recorders:
            if rec.is_recording:
                self._stop_slot(rec)
        self._snapshot_noise()
        # averager resets on retune; noise floor persists per center
        # frequency. The reset ring keeps init_scan_state's dtype (bf16 in
        # power_bf16 mode; the reference resets to an f32 ring, and zeros and
        # the bf16 rows stored in it are the same values in both), so the
        # step keeps one signature across hops
        fresh = init_scan_state(self.scan_cfg, start_ms=now_ms, device=self.torch_device)
        noise = self._noise_states.get(center, fresh.noise)
        self._scan_state = ScanState(noise=noise, averager=fresh.averager)
        self._pending_noise_center = center
        self._valid_mask_dev = None  # recomputed lazily for the new range

    # -- per-block processing ---------------------------------------------

    def process_block(self, iq, block_start_ms: int) -> List[FrequencyFlush]:
        """Run one block through detection (+ DDC when recording).

        iq: [block_samples] complex64, int8 [block_samples, 2] cs8, or a
        tensor of int8 / f32 (re, im) pairs. Returns the last detection
        notification of the block.
        """
        return self.finish_block(self.submit_block(iq, block_start_ms))

    def _upload_iq(self, iq) -> torch.Tensor:
        """The block as [block_samples, 2] int8 or f32 pairs on the device.
        complex64 never crosses the host->device boundary: its free f32
        (re, im) view goes up instead."""
        if isinstance(iq, torch.Tensor):
            return iq.reshape(-1, 2).to(self.torch_device)
        if iq.dtype != np.int8:
            iq = np.ascontiguousarray(iq, dtype=np.complex64).view(np.float32)
        return self._stage.upload(iq.reshape(-1, 2))

    def submit_block(self, iq, block_start_ms: int) -> dict:
        """Dispatch the device work for one block without waiting.

        Pipelined ingest: the host can submit block b+1 while still consuming
        block b's outputs. In compact mode the tracked-key slots are sampled
        at submit time, so signals added while a later block is already in
        flight fall back to the candidate-based update path for one extra
        block.
        """
        cfg = self.scan_cfg
        assert self._scan_state is not None, "set_frequency_range first"
        group = cfg.fft_size * cfg.decimator_factor
        frame_ms = cfg.frame_interval_ms
        now_arr = (
            block_start_ms + ((1 + np.arange(cfg.frames_per_block)) * frame_ms)
        ).astype(np.int32)

        slot_keys = None
        with span("session.upload"):
            iq_dev = self._upload_iq(iq)
            if self._compact:
                if self._valid_mask_dev is None:
                    self._valid_mask_dev = torch.from_numpy(self._tracker._compute_valid_mask()).to(
                        self.torch_device
                    )
                slot_keys = self._tracker.current_keys(self._tunables.detection_key_slots)
                # the frame times and the tracked keys go up as one copy
                small = self._stage.upload(np.concatenate([now_arr, slot_keys]))
            else:
                now_dev = self._stage.upload(now_arr)
        framed = iq_dev.reshape(cfg.frames_per_block, group, 2)
        if self._time_mesh is not None:
            with span("session.scan"):
                self._scan_state, body, spectro_sum, ready = self._scan_step(
                    self._scan_state,
                    framed,
                    small[: cfg.frames_per_block],
                    small[cfg.frames_per_block :],
                    self._valid_mask_dev,
                    self._start_level_dev,
                )
                packed = torch.cat([body.reshape(-1), ready.to(torch.float32)[None]])
            self._noise_scanned = True
            return {
                "outs": PackedOuts(packed),
                "iq_dev": iq_dev,
                "now_arr": now_arr,
                "slot_keys": slot_keys,
                "block_start_ms": block_start_ms,
                "spectro_sum": spectro_sum,
            }
        if self._compact:
            if self._spectro_acc is None:
                self._spectro_acc = init_spectro_acc(cfg, device=self.torch_device)
            keep = 0.0 if self._spectro_reset_pending else 1.0
            self._spectro_reset_pending = False
            with span("session.scan"):
                self._scan_state, self._spectro_acc, outs = self._scan_step(
                    self._scan_state,
                    self._spectro_acc,
                    framed,
                    small[: cfg.frames_per_block],
                    small[cfg.frames_per_block :],
                    self._valid_mask_dev,
                    self._start_level_dev,
                    keep,
                )
            self._spectro_pending_frames += cfg.frames_per_block
        else:
            with span("session.scan"):
                self._scan_state, outs = self._scan_step(self._scan_state, framed, now_dev)
        self._noise_scanned = True
        return {
            "outs": outs,
            "iq_dev": iq_dev,  # kept for the DDC dispatch after the reconcile
            "now_arr": now_arr,
            "slot_keys": slot_keys,
            "block_start_ms": block_start_ms,
        }

    def finish_block(self, handle: dict) -> List[FrequencyFlush]:
        """Consume a submitted block: tracker, reconcile, DDC, spectrogram."""
        cfg = self.scan_cfg
        outs = handle["outs"]
        now_arr = handle["now_arr"]
        block_start_ms = handle["block_start_ms"]

        flush_any: Dict[int, bool] = {}
        notification: List[FrequencyFlush] = []
        first_seen_frame: Dict[int, int] = {}
        if self._compact:
            slot_keys = handle["slot_keys"]
            # single device->host transfer for the whole block's detector data
            with span("session.fetch"):
                packed = _host(outs.packed)
            with span("session.tracker"):
                (
                    cand_idx,
                    cand_val,
                    cand_best,
                    cand_count,
                    key_val,
                    key_idx,
                    _noise_ready,
                ) = unpack_compact(
                    packed,
                    cfg.frames_per_block,
                    self._tunables.detection_top_k,
                    self._tunables.detection_key_slots,
                )
                for k in range(cfg.frames_per_block):
                    notification = self._tracker.process_compact(
                        cand_idx[k],
                        cand_val[k],
                        cand_best[k],
                        int(cand_count[k]),
                        slot_keys,
                        key_val[k],
                        key_idx[k],
                        int(now_arr[k]),
                    )
                    for shift, flush in notification:
                        flush_any[shift] = flush_any.get(shift, False) or flush
                        first_seen_frame.setdefault(shift, k)
        else:
            with span("session.fetch"):
                raw = outs.raw.cpu().numpy()
                avg = outs.avg.cpu().numpy()
                if self._power_sink is not None and self._power_sink.recording:
                    # reference taps raw PSD pre-noise (sdr_device.cpp:175)
                    self._power_sink.write(outs.power.cpu().numpy())
            with span("session.tracker"):
                for k in range(cfg.frames_per_block):
                    notification = self._tracker.process(raw[k], avg[k], int(now_arr[k]))
                    for shift, flush in notification:
                        flush_any[shift] = flush_any.get(shift, False) or flush
                        first_seen_frame.setdefault(shift, k)
        self._last_notification = notification
        for _ in range(cfg.frames_per_block):
            self._perf.kick()
        if self._raw_iq_sink is not None and self._raw_iq_sink.recording:
            if handle["iq_dev"] is not None and handle["iq_dev"].dtype == torch.float32:
                pairs = handle["iq_dev"].cpu().numpy()
                self._raw_iq_sink.write(pairs.reshape(-1).view(np.complex64))
            elif not self._raw_iq_sink_starved_logged:
                # int8 direct ingest keeps no f32 stream to tap; log once
                # instead of silently writing an empty capture
                self._raw_iq_sink_starved_logged = True
                logger.warn(
                    LABEL,
                    "debug_save_full_raw_iq is enabled but this ingest path "
                    "carries no f32 IQ stream (int8 direct ingest); raw "
                    "capture will be empty for this session",
                )

        # merge per-frame flush flags into the block-level reconcile
        with span("session.reconcile"):
            merged = [(shift, flush_any.get(shift, False)) for shift, _ in notification]
            merged = self._merge_manual(merged, int(now_arr[-1]))
            self._last_notification = notification = merged
            self.update_recordings(
                merged, int(now_arr[-1]),
                start_fractions={
                    s: f / cfg.frames_per_block for s, f in first_seen_frame.items()
                },
            )

        if self.is_recording and not handle.get("skip_ddc"):
            with span("session.ddc"):
                self._run_ddc(handle["iq_dev"], block_start_ms)

        with span("session.spectrogram"):
            if handle.get("skip_spectro"):
                # an owner's banded accumulator: it feeds ingest_spectro at
                # the send cadence
                pass
            elif "spectro_sum" in handle:
                # the time mesh returns the block's spectrogram sum itself
                self._accumulate_spectrogram(handle["spectro_sum"].cpu().numpy(), int(now_arr[-1]))
            elif self._compact:
                self._maybe_send_spectrogram(int(now_arr[-1]))
            else:
                self._accumulate_spectrogram(outs.spectro_sum.cpu().numpy(), int(now_arr[-1]))
        return notification

    # -- manual recordings (extension over remote_controller.cpp:45 stub) ---

    def request_manual_recording(self, frequency: int, duration_ms: int) -> None:
        """Force-record `frequency` for `duration_ms` of stream time.

        The recording arms when the scan range covers the frequency (the
        band-hop scheduler naturally reaches it) and then streams through a
        recorder slot like a detected transmission, holding the scanner on the
        range until it expires (hold-while-recording, scanner.cpp:52-56).
        """
        self._manual_requests.append((int(frequency), int(duration_ms)))
        logger.info(
            LABEL,
            "manual recording requested, frequency: {}, duration: {} ms",
            format_frequency(int(frequency)),
            int(duration_ms),
        )

    def _merge_manual(
        self, merged: List[FrequencyFlush], now_ms: int
    ) -> List[FrequencyFlush]:
        lo, hi = self._frequency_range
        # arm pending requests whose frequency the current range covers
        still_pending = []
        for freq, duration in self._manual_requests:
            if lo <= freq <= hi and lo != hi:
                self._manual_active[freq] = now_ms + duration
                logger.info(
                    LABEL, "manual recording armed, frequency: {}", format_frequency(freq)
                )
            else:
                still_pending.append((freq, duration))
        self._manual_requests = still_pending

        # expire / emit active manual recordings as always-flushing shifts
        center = self.center_frequency
        shifts = {s for s, _ in merged}
        out = list(merged)
        for freq in list(self._manual_active):
            if self._manual_active[freq] <= now_ms or not (lo <= freq <= hi):
                logger.info(
                    LABEL, "manual recording done, frequency: {}", format_frequency(freq)
                )
                del self._manual_active[freq]
                continue
            shift = get_tuned_frequency(freq - center, self._config.recording_tuning_step)
            if shift in shifts:
                out = [(s, True if s == shift else f) for s, f in out]
            else:
                out.append((shift, True))
        return out

    @property
    def has_manual_recording(self) -> bool:
        return bool(self._manual_active)

    # -- recorder reconcile (sdr_device.cpp:82-144) ------------------------

    def update_recordings(
        self,
        sorted_shifts: List[FrequencyFlush],
        now_ms: int,
        start_fractions: Optional[Dict[int, float]] = None,
    ) -> None:
        waiting = {shift for shift, _ in sorted_shifts}
        start_fractions = start_fractions or {}

        for rec in self._recorders:
            if rec.is_recording and rec.shift not in waiting:
                logger.info(
                    LABEL,
                    "stop recorder, frequency: {}, time: {} ms",
                    format_frequency(self.center_frequency + rec.shift),
                    rec.last_ms - rec.first_ms,
                )
                self._stop_slot(rec)

        for shift, flush in sorted_shifts:
            rec = next((r for r in self._recorders if r.shift == shift), None)
            if rec is not None:
                if flush:
                    self._flush_slot(rec)
            else:
                free = next((r for r in self._recorders if not r.is_recording), None)
                if free is not None:
                    self._start_slot(
                        free, shift, now_ms, start_fractions.get(shift, 0.0)
                    )
                    logger.info(
                        LABEL,
                        "start recorder, frequency: {}",
                        format_frequency(self.center_frequency + shift),
                    )
                elif shift not in self._ignored_transmissions:
                    logger.info(
                        LABEL,
                        "no recorders available, frequency: {}",
                        format_frequency(self.center_frequency + shift),
                    )
                    self._ignored_transmissions.add(shift)

        self._ignored_transmissions = {
            s for s in self._ignored_transmissions if s in waiting
        }

    def _start_slot(
        self, rec: RecorderSlot, shift: int, now_ms: int, start_fraction: float = 0.0
    ) -> None:
        rec.shift = shift
        rec.frequency = self.center_frequency
        rec.first_ms = now_ms
        rec.last_ms = now_ms
        rec.pending = []
        rec.start_fraction = start_fraction
        if self.external_ddc:
            self._slot_events.append((rec.index, shift, True))
            return
        self._ddc_state = ddc_pipeline.reset_slot(self._ddc_state, rec.index)
        shifts = np.array(
            [r.shift if r.is_recording else 0 for r in self._recorders], dtype=np.int64
        )
        self._ddc_tables = ddc_pipeline.make_tables(self.ddc_cfg, shifts, device=self.torch_device)

    def _stop_slot(self, rec: RecorderSlot) -> None:
        if self.external_ddc and rec.is_recording:
            self._slot_events.append((rec.index, 0, False))
        rec.shift = None
        rec.frequency = None
        rec.pending = []

    def drain_slot_events(self) -> List[Tuple[int, int, bool]]:
        """Pop pending (slot, shift, started) events (external_ddc mode)."""
        events, self._slot_events = self._slot_events, []
        return events

    def _flush_slot(self, rec: RecorderSlot) -> None:
        """Drain buffered DDC output to the wire (recorder.cpp:89-97)."""
        if not rec.pending:
            return
        rec.last_ms = max(rec.last_ms, rec.pending[-1][0])
        for stream_ms, samples in rec.pending:
            self._data_controller.push_transmission(
                self._session_epoch_ms + stream_ms,
                rec.frequency + rec.shift,
                self._config.recording_bandwidth,
                samples,
            )
        rec.pending = []

    def _run_ddc(self, iq_dev: torch.Tensor, block_start_ms: int) -> None:
        """The recorder bank over the block's IQ, still on the device from
        submit_block (no second upload)."""
        self._ddc_state, out = self._ddc_step(self._ddc_state, iq_dev, self._ddc_tables)
        self.ingest_ddc_out(out.cpu().numpy(), block_start_ms)

    def ingest_ddc_out(self, out_np: np.ndarray, block_start_ms: int, only_slots=None) -> None:
        """Distribute one block's [K, out, 2] int8 DDC rows to the recording
        slots' pending buffers. An owner running the DDC for all channels
        (WidebandScanner) feeds each session its channel's rows here.

        only_slots (fused dispatch): the slots whose recording was active
        when this block was DISPATCHED; any other recording slot started
        during this block's host processing and has no valid output in it:
        it is skipped and its in-block start trim cleared."""
        # pending entries are RECORDER_FLUSH_INTERVAL-sized chunks so the MQTT
        # stream keeps the reference's ~100 ms payload cadence (recorder.cpp:35
        # stream_to_vector of flush-interval length feeding the Buffer)
        flush_samples = max(
            1, int(self.ddc_cfg.bandwidth * self._tunables.recorder_flush_interval_ms / 1000)
        )
        for rec in self._recorders:
            if rec.is_recording:
                if only_slots is not None and rec.index not in only_slots:
                    rec.start_fraction = 0.0
                    continue
                samples = out_np[rec.index]
                trimmed = 0
                if rec.start_fraction > 0.0:
                    # first captured block: trim to the detection frame
                    trimmed = int(rec.start_fraction * samples.shape[0])
                    samples = samples[trimmed:]
                    rec.start_fraction = 0.0
                for off in range(0, samples.shape[0], flush_samples):
                    stamp = block_start_ms + int(
                        (trimmed + off) * 1000 / self.ddc_cfg.bandwidth
                    )
                    rec.pending.append((stamp, samples[off : off + flush_samples]))
                if self._rec_sinks is not None:
                    sink = self._rec_sinks[rec.index]
                    if not sink.recording:
                        sink.start(rec.frequency + rec.shift, self._config.recording_bandwidth)
                    sink.write(out_np[rec.index])

    # -- noise-floor snapshot/resume ---------------------------------------
    #
    # The reference relearns the noise floor (2 s per hop) after every
    # restart because thresholds are in-memory only (noise_learner.cpp:69-72).
    # Persisting the per-frequency max-hold state makes restarts resume
    # scanning immediately. The file format is the JAX package's: one f32
    # [fft] threshold per center under ``t_{center}``, so a snapshot moves
    # between the two packages in both directions.

    def _snapshot_noise(self) -> None:
        """Keep the live center's noise state (a clone) once a block has
        scanned there: the reference's per-center dictionary as of now."""
        if self._noise_scanned:
            noise = self._scan_state.noise
            self._noise_states[self._pending_noise_center] = NoiseState(*(t.clone() for t in noise))
            self._noise_scanned = False

    def save_noise_state(self, path: str) -> None:
        self._snapshot_noise()
        data = {}
        for freq, state in self._noise_states.items():
            if bool(state.ready):
                data[f"t_{freq}"] = state.threshold.cpu().numpy().astype(np.float32)
        if data:
            np.savez_compressed(path, **data)
            logger.info(LABEL, "noise state saved: {} ranges -> {}", len(data), path)

    def load_noise_state(self, path: str) -> None:
        dev = self.torch_device
        try:
            with np.load(path) as archive:
                for name in archive.files:
                    freq = int(name[2:])
                    threshold = archive[name]
                    if threshold.shape != (self.scan_cfg.fft_size,):
                        continue  # geometry changed; relearn
                    self._noise_states[freq] = NoiseState(
                        threshold=torch.from_numpy(threshold.astype(np.float32)).to(dev),
                        ready=torch.tensor(True, device=dev),
                        start_ms=torch.tensor(0, dtype=torch.int32, device=dev),
                    )
            logger.info(LABEL, "noise state loaded: {} ranges", len(self._noise_states))
        except (OSError, ValueError) as exc:
            logger.warn(LABEL, "noise state load failed: {}", exc)

    # -- spectrogram egress (spectrogram.cpp:62-75) ------------------------

    def _get_spectro_container(self, now_ms: int) -> SpectroContainer:
        center = self.center_frequency
        container = self._spectro_containers.get(center)
        if container is None:
            container = SpectroContainer(self.scan_cfg.spectro_size, now_ms)
            self._spectro_containers[center] = container
        return container

    def _drain_spectro_acc(self, now_ms: int) -> None:
        """Fetch the device spectrogram accumulator into the current center's
        host container (compact mode): one small transfer at the send
        cadence, not one a block."""
        if self._spectro_acc is None or self._spectro_pending_frames == 0:
            return
        container = self._get_spectro_container(now_ms)
        container.sum += self._spectro_acc.cpu().numpy().astype(np.float64)
        container.counter += self._spectro_pending_frames
        self._spectro_pending_frames = 0
        self._spectro_reset_pending = True

    def _send_container(self, container: SpectroContainer, center: int, now_ms: int) -> None:
        # C++ float -> int8 conversion truncates toward zero
        bins = np.trunc(container.sum / container.counter)
        bins = np.clip(bins, -128, 127).astype(np.int8)
        self._data_controller.push_spectrogram(
            self._session_epoch_ms + now_ms,
            center,
            self._device.sample_rate,
            bins,
        )
        container.sum[:] = 0.0
        container.counter = 0

    def _maybe_send_spectrogram(self, now_ms: int) -> None:
        """Compact-mode egress: fetch + send only at the reference's cadence
        (spectrogram.cpp:62-75)."""
        container = self._get_spectro_container(now_ms)
        if container.last_send_ms + self._tunables.spectrogram_send_interval_ms < now_ms:
            self._drain_spectro_acc(now_ms)
            if container.counter:
                self._send_container(container, self.center_frequency, now_ms)
            container.last_send_ms = now_ms

    def flush_spectrogram(self, now_ms: int) -> None:
        """Final flush on session stop: drain the device accumulator and send
        whatever every center's container holds, cadence ignored, each under
        its own center frequency, so the last partial send-interval of
        waterfall data is not lost when the scanner stops."""
        self._drain_spectro_acc(now_ms)
        for center, container in self._spectro_containers.items():
            if not container.counter:
                continue
            self._send_container(container, center, now_ms)
            container.last_send_ms = now_ms

    def _accumulate_spectrogram(self, spectro_sum: np.ndarray, now_ms: int) -> None:
        self.ingest_spectro(spectro_sum, self.scan_cfg.frames_per_block, now_ms)

    def ingest_spectro(self, spectro_sum: np.ndarray, n_frames: int, now_ms: int) -> None:
        """Add PSD bin sums of n_frames frames and send at the 1 Hz cadence
        (spectrogram.cpp:62-75)."""
        container = self._get_spectro_container(now_ms)
        container.sum += spectro_sum
        container.counter += n_frames
        if container.last_send_ms + self._tunables.spectrogram_send_interval_ms < now_ms:
            self._send_container(container, self.center_frequency, now_ms)
            container.last_send_ms = now_ms


def _host(a) -> np.ndarray:
    """A device tensor read to the host; a host array as it is."""
    return a if isinstance(a, np.ndarray) else a.cpu().numpy()


def _fix_block_multiple(
    cfg: ScanConfig, sample_rate: int, bandwidth: int, tunables: Tunables
) -> ScanConfig:
    """Grow frames_per_block minimally so block_samples divides the DDC chain
    (static shapes through every resampler stage)."""
    mult = chain_block_multiple(plan_chain(sample_rate, bandwidth, tunables.resampler_threshold))
    group = cfg.fft_size * cfg.decimator_factor
    frames = cfg.frames_per_block
    lcm = mult // math.gcd(group, mult)  # block = frames*group must have lcm | frames
    if frames % lcm != 0:
        frames = ((frames // lcm) + 1) * lcm
    if frames != cfg.frames_per_block:
        logger.info(LABEL, "frames per block adjusted: {} -> {}", cfg.frames_per_block, frames)
        cfg = dataclasses.replace(cfg, frames_per_block=frames)
    return cfg
