"""Wideband concurrent-band scanner (port of the JAX package's
``runtime/wideband.py``).

The reference time-multiplexes spectrum wider than one sample rate with
500 ms dwells (scanner.cpp:46-60) and so misses transmissions on the ranges
it is not watching. This mode watches everything at once: one wideband
front-end (or capture) is split by the polyphase channelizer
(``ops/channelizer.py``) into B sub-bands, each driven through its own
detection/recording session (its own noise floor, tracker, recorder slots,
spectrogram container and egress).

Enable with ``"channels": B`` on a device config entry. Two forms:
- serial (default): one channelizer call a block, then B sessions'
  ``submit_block`` / ``finish_block`` on the channel streams, which stay on
  the card;
- ``tunables.mesh_bands``: the B channels split over N band shards, N
  resolved against the visible cards (``sdr_device.mesh_bands_cards``; on
  one card, that card). One step a block covers the channelizer (run on
  every shard) and all channels' compact scan (``parallel/sharded_scan``),
  and, while a slot records, one banded DDC step for all channels (split),
  or all of it in one step (``tunables.wideband_fused_dispatch``,
  modulated-taps chains). Band state, accumulators, valid masks and DDC
  tables live on their shards (``sharded_scan``'s per-shard lists); the
  wideband block is uploaded to every shard, and packed rows and
  recordings are fetched shard by shard. Trackers, recorders and egress
  stay per channel on the host. On one band shard each of these steps
  replays one captured CUDA graph a block (``graph.donated_step``).

Multi-host (``tunables.multihost``, the process group ``runtime/main.py``
joins): the bands mesh spans every process's cards (``mesh_bands`` -1 =
all of them, ``parallel/multihost.py``); each process runs only its own
band shards, feeds and publishes only their channels (``_local_bands``),
and arms a manual recording only where it owns the channel. Every process
reads the whole wideband stream (each shard channelizes it). No data
crosses a process.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.graph import donated_step
from rtl_sdr_scanner_tpu_torch.ops.channelizer import (
    channel_center_offsets,
    channelize_block_2x_pairs,
    channelize_block_pairs,
    init_channelizer2x_state,
    init_channelizer_state,
    plan_channelizer,
)
from rtl_sdr_scanner_tpu_torch.runtime.config import Config, DeviceSpec
from rtl_sdr_scanner_tpu_torch.runtime.sdr_device import (
    HostStage,
    PackedOuts,
    SdrDevice,
    mesh_bands_cards,
    mesh_devices,
    session_cards,
    unported_path,
)
from rtl_sdr_scanner_tpu_torch.runtime.sources import make_source
from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import format_frequency

LABEL = "wideband"


class WidebandScanner:
    def __init__(
        self,
        config: Config,
        device_spec: DeviceSpec,
        mqtt,
        recorders_count: int,
        loop_replay: bool = False,
        device: DeviceLike = None,
        cards: Optional[Sequence[DeviceLike]] = None,
    ):
        """``cards``: the devices this process's bands mesh may span
        (default: the visible cards; a dry run gives copies of one card)."""
        if device_spec.channels < 2:
            raise ValueError("wideband mode needs channels >= 2")
        if not device_spec.ranges:
            raise ValueError("wideband mode needs a frequency range")
        b = device_spec.channels
        rate = device_spec.sample_rate
        if rate % b != 0:
            raise ValueError(f"sample_rate {rate} not divisible by channels {b}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # refuse an unported path before the source opens its hardware
        reason = unported_path(config, device_spec, dev)
        if reason is not None:
            raise NotImplementedError(reason)
        self.torch_device = dev
        self._cards = None if cards is None else [resolve_device(d) for d in cards]
        self._stage = HostStage(dev)

        self._config = config
        # set when the worker thread dies on a fatal error; main exits on it
        self.failed = False
        self._source = make_source(device_spec, loop=loop_replay, tunables=config.tunables)
        self._oversample = 2 if config.tunables.channelizer_oversample == 2 else 1
        self._plan = plan_channelizer(b, oversample=self._oversample, bf16=config.tunables.channelizer_bf16)
        if self._oversample == 2:
            self._chan_state = init_channelizer2x_state(self._plan, dev)
        else:
            self._chan_state = init_channelizer_state(self._plan, dev)
        core = rate // b  # each channel OWNS an R/B-wide core range
        sub_rate = core * self._oversample  # stream rate (2R/B when oversampled)
        center = (device_spec.ranges[0][0] + device_spec.ranges[0][1]) // 2
        offsets = channel_center_offsets(self._plan, rate)

        per_band_recorders = max(1, recorders_count // b)
        self._sessions: List[SdrDevice] = []
        self._noise_path = (
            f"{config.tunables.noise_state_path}.{device_spec.name}"
            if config.tunables.noise_state_path
            else None
        )
        for ch in range(b):
            sub_center = center + int(offsets[ch])
            # ranges stay the CORE (R/B) even when the stream is 2R/B wide:
            # detection is gated to the core, so every frequency is owned by
            # exactly one session (edge dedup)
            sub_spec = dataclasses.replace(
                device_spec,
                sample_rate=sub_rate,
                ranges=[(sub_center - core // 2, sub_center + core // 2)],
                channels=0,
            )
            session = SdrDevice(config, sub_spec, mqtt, per_band_recorders, device=dev)
            if self._noise_path:
                path = f"{self._noise_path}.ch{ch}.npz"
                if os.path.exists(path):
                    session.load_noise_state(path)
            session.set_frequency_range(sub_spec.ranges[0], now_ms=0)
            self._sessions.append(session)
            logger.info(
                LABEL,
                "channel {}: {} - {} ({} sps)",
                ch,
                format_frequency(sub_spec.ranges[0][0]),
                format_frequency(sub_spec.ranges[0][1]),
                sub_rate,
            )

        # all sessions share geometry; wideband block = B * sub-band block
        # (halved when oversampled: each input sample yields 2/B outputs
        # per channel)
        self._wide_block = self._sessions[0].scan_cfg.block_samples * b // self._oversample
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._mesh = None
        self._local_bands = list(range(b))
        self._multihost = False
        self._int8_ingest = config.tunables.int8_ingest
        # pipelined ingest: one wideband block in flight on the card while
        # the host consumes the previous block's packed rows (same contract
        # as SdrDevice.submit_block: keys sampled at submit time)
        self._pipelined = config.tunables.pipelined_ingest
        self._mesh_inflight: Optional[tuple] = None
        if config.tunables.mesh_bands:
            self._setup_mesh(config.tunables.mesh_bands)
        logger.info(
            LABEL,
            "watching {} concurrently as {} channels (block {} samples)",
            format_frequency(device_spec.ranges[0][1] - device_spec.ranges[0][0]),
            b,
            self._wide_block,
        )

    # -- the one-dispatch forms (tunables.mesh_bands) ------------------------

    def _setup_mesh(self, mesh_bands: int) -> None:
        """One step a wideband block for the channelizer and all B
        channels' compact scan, plus (split) one banded DDC step for all
        channels while any records, or (fused) all of it in one step, over
        N band shards. The reference runs its recorder chains concurrently
        off one source (sdr_device.cpp:39-41); B serial per-band dispatches
        would not. Under multi-host N counts every process's cards and this
        process runs its own shards of the N."""
        from rtl_sdr_scanner_tpu_torch.parallel import multihost
        from rtl_sdr_scanner_tpu_torch.parallel.mesh import make_mesh
        from rtl_sdr_scanner_tpu_torch.parallel.sharded_scan import (
            init_banded_ddc_state,
            init_banded_state,
            make_sharded_banded_ddc,
            make_sharded_wideband_fused_step,
            make_sharded_wideband_step,
            replicate,
            shard_bands,
        )

        b = len(self._sessions)
        dev = self.torch_device
        session = self._sessions[0]
        cards = session_cards(dev, self._cards)
        # multi-host (tunables.multihost + the joined group): the mesh spans
        # every process's cards and THIS process feeds and publishes only
        # the bands of the shards it owns (parallel/multihost.py placement);
        # in a single process that is every band
        self._multihost = multihost.process_count() > 1
        if self._multihost:
            world = multihost.make_global_mesh(1, cards=cards)
            n = mesh_bands_cards(mesh_bands, b, world.shape["bands"])
        else:
            n = mesh_bands_cards(mesh_bands, b, cards)
        if not self._config.tunables.compact_detection:
            logger.warn(LABEL, "mesh_bands needs compact detection; staying serial")
            return
        if self._multihost and not session.ddc_cfg.modtap:
            # other chains record per channel, outside the bands mesh
            raise ValueError("multihost wideband needs the modulated-taps chain")
        cfg = session.scan_cfg
        if self._multihost:
            mesh = multihost.local_mesh(world.bands(n), mesh_devices(dev, cards, self._cards))
        else:
            mesh = make_mesh(n_bands=n, n_time=1, devices=mesh_devices(dev, n, self._cards))
        self._mesh = mesh
        self._b_loc = b_loc = b // n
        # global band shard -> its place in this process's per-shard lists
        self._shard_pos = {g: i for i, g in enumerate(mesh.band_shards)}
        self._local_bands = [band for g in mesh.band_shards for band in range(g * b_loc, (g + 1) * b_loc)]
        if self._multihost:
            logger.info(
                LABEL,
                "multihost process {}/{}: feeding bands {}",
                multihost.process_index(),
                multihost.process_count(),
                self._local_bands,
            )
        top_k = self._config.tunables.detection_top_k

        # on one band shard the steps are graphed (graph.py), donating what
        # the JAX package's donate; across shards they stay eager
        def graphed(fn, donate, name):
            return donated_step(fn, donate, name) if mesh.n_band_shards == 1 else fn

        self._wide_step = graphed(
            make_sharded_wideband_step(cfg, session._group_size, top_k, mesh, self._plan, self._oversample, b),
            (0, 1, 2), "wideband step",
        )
        self._band_state = init_banded_state(cfg, b, mesh)
        self._chan_state = replicate(self._chan_state, mesh)
        self._band_acc = [
            torch.zeros((b_loc, cfg.spectro_size), dtype=torch.float32, device=d) for d in mesh.band_devices
        ]
        # parked sessions: ranges never change, so masks are computed once
        masks = np.stack([s._tracker._compute_valid_mask() for s in self._sessions])
        self._band_valid = shard_bands(torch.from_numpy(masks), mesh)
        self._start_level = replicate(
            torch.tensor(float(session._device.start_level), dtype=torch.float32), mesh
        )
        self._acc_pending_frames = 0
        self._acc_reset_pending = False
        self._last_spectro_ms = 0

        # banded recording: one K*B-slot DDC (modulated-taps chains only --
        # every production rate; other chains keep per-channel DDC)
        self._ddc_cfg = session.ddc_cfg
        self._fused = False
        if self._ddc_cfg.modtap:
            self._band_shifts = np.zeros((b, self._ddc_cfg.num_slots), dtype=np.int64)
            self._band_tables = self._build_band_tables()
            self._ddc_band_state = init_banded_ddc_state(self._ddc_cfg, b, mesh)
            if self._config.tunables.wideband_fused_dispatch:
                # ONE step a block: channelize + scan + banded DDC. Slot
                # reconcile applies from the NEXT block (the reference's
                # notification timing, recorder.cpp:58-73); the split form
                # records the triggering block itself, as the serial one does
                self._fused = True
                self._ddc_band_step = None
                self._fused_step = graphed(
                    make_sharded_wideband_fused_step(
                        cfg, self._ddc_cfg, session._group_size, top_k, mesh, self._plan, self._oversample, b,
                    ),
                    (0, 1, 2, 3), "wideband fused step",
                )
            else:
                self._ddc_band_step = graphed(make_sharded_banded_ddc(self._ddc_cfg, mesh, b), (0,), "banded DDC step")
            for s_ in self._sessions:
                s_.external_ddc = True
        else:
            self._ddc_band_step = None  # (under multi-host refused above)
            if self._config.tunables.wideband_fused_dispatch:
                logger.warn(LABEL, "wideband_fused_dispatch needs the modulated-taps chain")
            logger.warn(LABEL, "non-modtap DDC chain: recording stays per-band")
        logger.info(
            LABEL,
            "bands mesh: {} sub-bands over {} device(s){}",
            b,
            n,
            " (fused single dispatch)" if self._fused else "",
        )

    def _fetch_band_rows(self, shards) -> dict:
        """This process's rows of a band-stacked per-shard list, read to the
        host shard by shard and keyed by global band (with one process,
        every band)."""
        rows = {}
        b_loc = self._b_loc
        for g, a in zip(self._mesh.band_shards, shards):
            data = a.cpu().numpy()
            for off in range(data.shape[0]):
                rows[g * b_loc + off] = data[off]
        return rows

    def _build_band_tables(self) -> list:
        """Each of this process's band shards' DDC tables (host-exact math)
        for its rows of the [B, K] shifts, made on its device; rebuilt only
        when some channel's recorder slots changed (recorder start/stop,
        human-timescale events)."""
        from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline

        b_loc = self._b_loc
        return [
            ddc_pipeline.make_tables(self._ddc_cfg, self._band_shifts[g * b_loc : (g + 1) * b_loc], device=d)
            for g, d in zip(self._mesh.band_shards, self._mesh.band_devices)
        ]

    def _upload_shards(self, array: np.ndarray, banded: bool) -> list:
        """``array`` on every band shard's device from one pinned fill: the
        whole of it (replicated), or (banded) each shard's rows."""
        devs = self._mesh.band_devices
        copies = self._stage.upload_to(array, devs)
        if not banded:
            return copies
        b_loc = self._b_loc
        return [c[g * b_loc : (g + 1) * b_loc] for g, c in zip(self._mesh.band_shards, copies)]

    def _drain_slot_events(self) -> list:
        """Apply the sessions' slot start/stop events to the banded shifts
        (rebuilding the tables if any) and return the [B, K] keep mask per
        band shard: 0 where a slot started (its carry zeroed before the
        block)."""
        keep_mask = np.ones((len(self._sessions), self._ddc_cfg.num_slots), np.float32)
        dirty = False
        for ch in self._local_bands:
            for slot, shift, started in self._sessions[ch].drain_slot_events():
                if started:
                    keep_mask[ch, slot] = 0.0
                self._band_shifts[ch, slot] = shift
                dirty = True
        if dirty:
            self._band_tables = self._build_band_tables()
        return self._upload_shards(keep_mask, banded=True)

    def _step_mesh(self, pairs: np.ndarray, start_ms: int, now_ms: int) -> None:
        handle = self._submit_mesh(pairs, start_ms)
        if not self._pipelined:
            self._finish_mesh(handle, now_ms)
            return
        if self._mesh_inflight is not None:
            prev_handle, prev_now = self._mesh_inflight
            self._finish_mesh(prev_handle, prev_now)
        self._mesh_inflight = (handle, now_ms)

    def _drain_mesh(self) -> None:
        if self._mesh_inflight is not None:
            handle, now_ms = self._mesh_inflight
            self._mesh_inflight = None
            self._finish_mesh(handle, now_ms)

    def _submit_mesh(self, pairs: np.ndarray, start_ms: int) -> dict:
        """Dispatch one wideband block without waiting: one step covers the
        channelizer and all channels' compact scan (and, fused, the DDC)."""
        cfg = self._sessions[0].scan_cfg
        s = self._config.tunables.detection_key_slots
        frames = cfg.frames_per_block
        now_arr = (start_ms + ((1 + np.arange(frames)) * cfg.frame_interval_ms)).astype(np.int32)
        keys = np.stack([session._tracker.current_keys(s) for session in self._sessions])
        keep = 0.0 if self._acc_reset_pending else 1.0
        self._acc_reset_pending = False
        # the wideband block goes to every band shard (each channelizes it)
        x_dev = self._upload_shards(pairs, banded=False)
        # the frame times and every channel's tracked keys go up as one copy
        small = self._upload_shards(np.concatenate([now_arr, keys.reshape(-1).astype(np.int32)]), banded=False)
        b_loc = self._b_loc
        now_dev = [c[:frames] for c in small]
        keys_dev = [
            c[frames:].reshape(keys.shape)[g * b_loc : (g + 1) * b_loc] for g, c in zip(self._mesh.band_shards, small)
        ]

        if self._fused:
            # reconcile BEFORE the dispatch: slot events drained here came
            # from the PREVIOUS block's host processing, so this block's DDC
            # runs with tables and keeps already right for it
            keep_mask = self._drain_slot_events()
            # each slot recording as of THIS dispatch, with the recording it
            # belongs to: only those rows are valid in this block's DDC output
            # (a slot started, or stopped and restarted, during this block's
            # host processing gets its first valid rows next block)
            active = {ch: self._sessions[ch].recording_slots() for ch in self._local_bands}
            (
                self._chan_state,
                self._band_state,
                self._band_acc,
                self._ddc_band_state,
                packed_dev,
                rec_dev,
                channels,
            ) = self._fused_step(
                self._chan_state, self._band_state, self._band_acc, self._ddc_band_state, x_dev,
                now_dev, keys_dev, self._band_valid, self._start_level, keep, self._band_tables, keep_mask,
            )
            self._acc_pending_frames += frames
            return {
                "packed_dev": packed_dev,
                "channels": channels,
                "rec_dev": rec_dev,
                "active": active,
                "now_arr": now_arr,
                "keys": keys,
                "start_ms": start_ms,
            }

        (
            self._chan_state,
            self._band_state,
            self._band_acc,
            packed_dev,
            channels,
        ) = self._wide_step(
            self._chan_state, self._band_state, self._band_acc, x_dev, now_dev, keys_dev,
            self._band_valid, self._start_level, keep,
        )
        self._acc_pending_frames += frames
        return {
            "packed_dev": packed_dev,
            "channels": channels,
            "now_arr": now_arr,
            "keys": keys,
            "start_ms": start_ms,
        }

    def _finish_mesh(self, handle: dict, now_ms: int) -> None:
        channels = handle["channels"]
        now_arr = handle["now_arr"]
        keys = handle["keys"]
        start_ms = handle["start_ms"]
        packed = self._fetch_band_rows(handle["packed_dev"])
        banded_ddc = self._fused or self._ddc_band_step is not None
        for ch in self._local_bands:
            session = self._sessions[ch]
            # the banded DDC leaves a session's channel stream unused, but
            # the debug raw-IQ sink consumes it
            feed_sink = session.wants_raw_iq()
            session.finish_block(
                {
                    "outs": PackedOuts(packed[ch]),
                    "iq_dev": (
                        channels[self._shard_pos[ch // self._b_loc]][ch % self._b_loc]
                        if (not banded_ddc or feed_sink)
                        else None
                    ),
                    "now_arr": now_arr,
                    "slot_keys": keys[ch],
                    "block_start_ms": start_ms,
                    "skip_spectro": True,
                    "skip_ddc": banded_ddc,
                }
            )

        if self._fused:
            # the DDC ran inside the submit dispatch: ingest rows only for
            # the slots recording at dispatch time that still hold the same
            # recording (a slot stopped and reused since holds rows computed
            # with the old shift); slots started since get their first valid
            # rows next block, so their in-block start trim is void
            active = handle["active"]
            fetch = any(active.get(ch) for ch in self._local_bands)
            rec = self._fetch_band_rows(handle["rec_dev"]) if fetch else None
            for ch in self._local_bands:
                session = self._sessions[ch]
                then = active.get(ch, {})
                same = {slot for slot, ident in session.recording_slots().items() if then.get(slot) == ident}
                started_since = session.recording_slot_indices() - same
                if started_since:
                    session.clear_slot_start_trim(started_since)
                if rec is not None and session.is_recording:
                    session.ingest_ddc_out(rec[ch], start_ms, only_slots=same)
        elif self._ddc_band_step is not None:
            # reconcile the banded DDC slots from the sessions' slot events,
            # then run recording as ONE dispatch over all channels; slot
            # resets ride the keep mask. The step runs while a band of THIS
            # process records, under multi-host too: the reference runs it
            # every block there only because every process must issue the
            # same SPMD program, while here each process runs its own
            # shards and waits on no peer
            keep_mask = self._drain_slot_events()
            recording = any(self._sessions[ch].is_recording for ch in self._local_bands)
            if recording:
                self._ddc_band_state, rec_dev = self._ddc_band_step(
                    self._ddc_band_state, channels, self._band_tables, keep_mask
                )
                rec = self._fetch_band_rows(rec_dev)
                for ch in self._local_bands:
                    if self._sessions[ch].is_recording:
                        self._sessions[ch].ingest_ddc_out(rec[ch], start_ms)
        # (non-modtap chains: finish_block above ran each recording channel's
        # own DDC because skip_ddc was False and iq_dev was its stream)

        interval = self._config.tunables.spectrogram_send_interval_ms
        if self._last_spectro_ms + interval < now_ms and self._acc_pending_frames:
            acc = self._fetch_band_rows(self._band_acc)
            for ch in self._local_bands:
                self._sessions[ch].ingest_spectro(acc[ch].astype(np.float64), self._acc_pending_frames, now_ms)
            self._acc_pending_frames = 0
            self._acc_reset_pending = True
            self._last_spectro_ms = now_ms

    @property
    def sessions(self) -> List[SdrDevice]:
        return self._sessions

    def manual_record(self, frequency: int, duration_ms: int) -> bool:
        """Route a manual recording to the sub-band session covering it.

        Under multi-host every process receives the MQTT request; only the
        process that owns the covering band arms it (its sessions are the
        only ones fed), so exactly one recording happens."""
        for ch in self._local_bands:
            session = self._sessions[ch]
            lo, hi = session._frequency_range
            if lo <= frequency <= hi:
                session.request_manual_recording(frequency, duration_ms)
                return True
        return False

    def _read_pairs(self) -> Optional[np.ndarray]:
        """Next wideband block as [n, 2] pairs: int8 cs8 when the source
        offers it (a quarter of the upload; the channelizer dequantizes on
        the card) else f32."""
        if self._int8_ingest and hasattr(self._source, "read_block_int8"):
            raw = self._source.read_block_int8(self._wide_block)
            if raw is not None:
                return raw
        block = self._source.read_block(self._wide_block)
        if block is None:
            return None
        pairs = np.ascontiguousarray(block, dtype=np.complex64).view(np.float32)
        return pairs.reshape(-1, 2)

    def _channelize(self, pairs: np.ndarray) -> torch.Tensor:
        """The serial form's channelizer call: [B, n_sub, 2] f32 on the card."""
        fn = channelize_block_2x_pairs if self._oversample == 2 else channelize_block_pairs
        self._chan_state, channels = fn(self._plan, self._chan_state, self._stage.upload(pairs))
        return channels

    def step(self) -> bool:
        pairs = self._read_pairs()
        if pairs is None:
            if self._mesh is not None:
                self._drain_mesh()  # consume the pipelined tail block
            return False
        now_ms = self._source.stream_time_ms()
        start_ms = int(now_ms - self._wide_block * 1000 / self._source.sample_rate)
        if self._mesh is not None:
            self._step_mesh(pairs, start_ms, now_ms)
            return True
        channels = self._channelize(pairs)
        # every channel's session consumes its stream on the card; submit all
        # first so the card's work queues up, then finish
        handles = [session.submit_block(channels[ch], start_ms) for ch, session in enumerate(self._sessions)]
        for session, handle in zip(self._sessions, handles):
            session.finish_block(handle)
        return True

    def run_to_completion(self) -> None:
        while self.step():
            pass

    def start(self) -> None:
        self._running = True
        dev = self.torch_device

        def worker():
            logger.info(LABEL, "thread started")
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)  # the current card is a per-thread setting
                while self._running:
                    if not self.step():
                        break
            except Exception as exc:
                # fatal error: mark failed so main exits (reference exit(1)
                # parity, sdr_source.cpp:38-41); never die silently
                self.failed = True
                logger.error(LABEL, "wideband scanner thread failed: {}", exc)
            logger.info(LABEL, "thread stopped")

        thread = threading.Thread(target=worker, name="wideband", daemon=True)
        thread.start()
        # published once running: a watcher that reads "not alive" from it
        # then knows the worker has ended, not that it has yet to begin
        self._thread = thread

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._drain_mesh()
        # release the hardware like Scanner.stop (SdrDevice dtor parity,
        # sdr_device.cpp:47-52)
        if hasattr(self._source, "stop_streaming"):
            self._source.stop_streaming()
        if hasattr(self._source, "close"):
            self._source.close()
        now_ms = self._source.stream_time_ms()
        # final spectrogram flush: with the banded step the pending bin sums
        # live in the device accumulator -- fold them into the sessions first
        if self._mesh is not None and self._acc_pending_frames:
            acc = self._fetch_band_rows(self._band_acc)
            for ch in self._local_bands:
                container = self._sessions[ch]._get_spectro_container(now_ms)
                container.sum += acc[ch].astype(np.float64)
                container.counter += self._acc_pending_frames
            self._acc_pending_frames = 0
            self._acc_reset_pending = True
        for ch in self._local_bands:
            self._sessions[ch].flush_spectrogram(now_ms)
            if self._noise_path:
                self._sessions[ch].save_noise_state(f"{self._noise_path}.ch{ch}.npz")

