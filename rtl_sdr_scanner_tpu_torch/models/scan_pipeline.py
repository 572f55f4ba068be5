"""The detection pipeline of a block (port of the JAX package's
``models/scan_pipeline.py``):

  int8 cs8 -> PSD dB -> noise max-hold -> 21-row averager -> 21-bin
  smoothing -> compact detection -> one packed f32 vector per band
  (compact mode), or the raw and smoothed rows themselves (full-row mode).

Bands are a leading batch dimension ([NB, F, ...]) where the JAX package
vmaps a single-band function. The single-band steps the runtime session
dispatches (``make_scan_step``, ``make_compact_scan_step``) take and return
the JAX package's single-band layouts (no band axis) and run the banded
code at NB=1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.constants import DEFAULT, Tunables
from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import _band_axis
from rtl_sdr_scanner_tpu_torch.ops.averager import (
    AveragerState,
    averager_block,
    init_averager_state,
    ordered_history,
)
from rtl_sdr_scanner_tpu_torch.ops.detect import K_SEP, CompactOutputs, compact_detection
from rtl_sdr_scanner_tpu_torch.ops.noise import NoiseState, init_noise_state, noise_block
from rtl_sdr_scanner_tpu_torch.ops.psd import pairs_to_complex, psd_frames
from rtl_sdr_scanner_tpu_torch.ops.smooth import sliding_average
from rtl_sdr_scanner_tpu_torch.ops.spectrogram import accumulate_frames, spectrogram_output_size
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import get_fft
from rtl_sdr_scanner_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Static geometry of one band's detection pipeline
    (SdrDevice::setupChains, sdr_device.cpp:148-159)."""

    sample_rate: int
    fft_size: int
    decimator_factor: int
    frames_per_block: int
    spectro_size: int
    grouping_x: int = 21
    grouping_y: int = 21
    noise_learning_ms: int = 2000
    # tolerance mode: the selection sweeps read bf16 copies of the rows;
    # reported values stay f32 (ops/detect.compact_detection)
    detection_bf16: bool = False
    # deeper tolerance: the noise-subtracted rows are STORED in bf16 (the
    # averager ring, the history-vote rows); the PSD, the noise floor and
    # the spectrogram stay f32. Only with detection_bf16: create() clears
    # it otherwise, so state dtypes stay consistent
    power_bf16: bool = False

    @classmethod
    def create(
        cls, sample_rate: int, frames_per_block: int = 16, tunables: Tunables = DEFAULT
    ) -> "ScanConfig":
        fft_size = get_fft(sample_rate, tunables.signal_detection_max_step)
        step = sample_rate / fft_size
        decim = 1 if tunables.dense_detection else max(
            1, int(step / tunables.signal_detection_fps)
        )
        return cls(
            sample_rate=sample_rate,
            fft_size=fft_size,
            decimator_factor=decim,
            frames_per_block=frames_per_block,
            spectro_size=spectrogram_output_size(
                fft_size,
                sample_rate,
                tunables.spectrogram_max_fft,
                tunables.spectrogram_preferred_max_step,
            ),
            grouping_x=tunables.grouping_x,
            grouping_y=tunables.grouping_y,
            noise_learning_ms=tunables.noise_learning_time_ms,
            detection_bf16=tunables.detection_bf16,
            power_bf16=tunables.power_bf16 and tunables.detection_bf16,
        )

    @property
    def step_hz(self) -> float:
        return self.sample_rate / self.fft_size

    @property
    def block_samples(self) -> int:
        return self.frames_per_block * self.fft_size * self.decimator_factor

    @property
    def frame_interval_ms(self) -> float:
        return self.fft_size * self.decimator_factor * 1000.0 / self.sample_rate

    def index_to_shift(self, index: int) -> int:
        """Bin index -> frequency shift from center (sdr_device.cpp:154)."""
        return int(self.step_hz * (index + 0.5)) - self.sample_rate // 2

    def index_to_frequency(self, index: int, center: int) -> int:
        return center + self.index_to_shift(index)


class ScanState(NamedTuple):
    noise: NoiseState
    averager: AveragerState


class ScanOutputs(NamedTuple):
    """Full-row mode outputs (band axis leading, or none for one band)."""

    raw: torch.Tensor  # [F, fft] power - noise floor (or the NO_DATA sentinel)
    avg: torch.Tensor  # [F, fft] time+frequency smoothed (or sentinel)
    spectro_sum: torch.Tensor  # [spectro_size] PSD bin-mean sum over frames
    noise_ready: torch.Tensor  # bool AFTER this block
    power: torch.Tensor  # [F, fft] PSD before the noise floor (debug tap,
    # sdr_device.cpp:175 taps the PSD block output before NoiseLearner)


class CompactScanOutputs(NamedTuple):
    compact: CompactOutputs
    noise_ready: torch.Tensor  # [NB] bool AFTER this block
    # per band, one f32 vector: [frames * (3K + 1 + 2S)] frame rows
    # (cand_idx, cand_val, cand_best, cand_count, key_val, key_idx), then
    # noise_ready. Index values are < 2^24, exact in f32.
    packed: torch.Tensor  # [NB, packed_len]


def init_scan_state(
    cfg: ScanConfig, n_bands: Optional[int] = None, start_ms: int = 0, device: DeviceLike = None
) -> ScanState:
    """Zero carry: single band (``n_bands`` None, no band axis) or banded;
    a bf16 averager ring in power_bf16 mode."""
    dev = resolve_device(device)
    ring_dtype = torch.bfloat16 if cfg.power_bf16 else torch.float32
    state = ScanState(
        noise=init_noise_state(n_bands or 1, cfg.fft_size, start_ms, dev),
        averager=init_averager_state(n_bands or 1, cfg.fft_size, cfg.grouping_y, dev, ring_dtype),
    )
    return state if n_bands is not None else _band_axis(state, add=False)


def init_spectro_acc(
    cfg: ScanConfig, n_bands: Optional[int] = None, device: DeviceLike = None
) -> torch.Tensor:
    """Device-side spectrogram accumulator, [NB, spectro_size] f32 (or
    [spectro_size] for one band)."""
    shape = (cfg.spectro_size,) if n_bands is None else (n_bands, cfg.spectro_size)
    return torch.zeros(shape, dtype=torch.float32, device=resolve_device(device))


def _frames_power(cfg: ScanConfig, iq: torch.Tensor) -> torch.Tensor:
    """[NB, F, fft*decim, 2] int8 cs8 or f32 pairs -> [NB, F, fft] PSD dB.

    int8 ingest is the function the PSD kernel computes, so it always goes
    to the kernel's wrapper (CPU: the plain version; CUDA: the kernel, or it
    raises). f32-pair ingest is another function, which the JAX package
    leaves to XLA too: it keeps the plain FFT chain on every device."""
    nb, f = iq.shape[:2]
    if iq.dtype == torch.int8:
        from rtl_sdr_scanner_tpu_torch.ops.cuda.psd_kernel import psd_frames_int8

        flat = iq.reshape(nb * f, *iq.shape[2:])
        power = psd_frames_int8(flat, float(cfg.sample_rate), cfg.fft_size, cfg.decimator_factor)
        return power.reshape(nb, f, cfg.fft_size)
    return psd_frames(pairs_to_complex(iq[:, :, : cfg.fft_size]), float(cfg.sample_rate))


def _scan_block(
    cfg: ScanConfig, state: ScanState, iq: torch.Tensor, now_ms: torch.Tensor
) -> Tuple[ScanState, ScanOutputs]:
    """Full-row block over all bands: iq [NB, F, fft*decim, 2] int8 or f32
    pairs, now_ms [NB, F] i32."""
    with span("scan.psd"):
        power = _frames_power(cfg, iq)
    with span("scan.noise"):
        noise_state, raw_rows = noise_block(state.noise, power, now_ms, cfg.noise_learning_ms)
    with span("scan.averager"):
        avg_state, mean_rows = averager_block(state.averager, raw_rows)
    with span("scan.smoothing"):
        avg_rows = sliding_average(mean_rows, cfg.grouping_x)
    with span("scan.spectrogram"):
        spectro = accumulate_frames(power, cfg.spectro_size)
    state = ScanState(noise_state, avg_state)
    return state, ScanOutputs(
        raw=raw_rows, avg=avg_rows, spectro_sum=spectro, noise_ready=state.noise.ready, power=power
    )


def _check_device(dev: torch.device, iq: torch.Tensor) -> None:
    if iq.device.type != dev.type:
        raise ValueError(f"step built for {dev}, got iq on {iq.device}")


def make_scan_step(cfg: ScanConfig, device: DeviceLike = None):
    """Single-band full-row step (state, iq [F, fft*decim, 2], now_ms [F])
    -> (state, ScanOutputs), single-band layouts, on ``device``."""
    dev = resolve_device(device)

    def step(state: ScanState, iq: torch.Tensor, now_ms: torch.Tensor):
        _check_device(dev, iq)
        state, outs = _scan_block(cfg, _band_axis(state, add=True), iq[None], now_ms[None])
        return _band_axis(state, add=False), _band_axis(outs, add=False)

    return step


def make_compact_scan_step(cfg: ScanConfig, group_size: int, top_k: int = 64, device: DeviceLike = None):
    """Single-band compact step: (state, spectro_acc, iq, now_ms, keys,
    valid_mask, start_level, spectro_keep) -> (state, spectro_acc,
    CompactScanOutputs), the JAX signature in single-band layouts on
    ``device``. start_level is a 0-d f32 tensor on the device (the session
    makes it once), spectro_keep a Python float (1.0 accumulate, 0.0 reset
    first); neither costs a host-to-device copy."""
    dev = resolve_device(device)

    def step(state, spectro_acc, iq, now_ms, keys, valid_mask, start_level, spectro_keep):
        _check_device(dev, iq)
        state, spectro_acc, outs = _compact_scan_block(
            cfg, group_size, top_k, _band_axis(state, add=True), spectro_acc[None], iq[None],
            now_ms[None], keys, valid_mask, start_level, spectro_keep,
        )
        return _band_axis(state, add=False), spectro_acc[0], _band_axis(outs, add=False)

    return step


def unpack_compact(packed: np.ndarray, frames: int, top_k: int, key_slots: int):
    """Host-side decode of one band's packed vector."""
    n_cand = top_k + K_SEP
    row = 3 * n_cand + 1 + 2 * key_slots
    body = packed[: frames * row].reshape(frames, row)
    cand_idx = body[:, :n_cand].astype(np.int32)
    cand_val = body[:, n_cand : 2 * n_cand]
    cand_best = body[:, 2 * n_cand : 3 * n_cand].astype(np.int32)
    cand_count = body[:, 3 * n_cand].astype(np.int32)
    key_val = body[:, 3 * n_cand + 1 : 3 * n_cand + 1 + key_slots]
    key_idx = body[:, 3 * n_cand + 1 + key_slots :].astype(np.int32)
    noise_ready = bool(packed[frames * row] > 0.5)
    return cand_idx, cand_val, cand_best, cand_count, key_val, key_idx, noise_ready


def _compact_scan_block(
    cfg: ScanConfig,
    group_size: int,
    top_k: int,
    state: ScanState,
    spectro_acc: torch.Tensor,  # [NB, spectro_size] f32
    iq: torch.Tensor,  # [NB, F, fft*decim, 2] int8
    now_ms: torch.Tensor,  # [NB, F] i32
    keys: torch.Tensor,  # [S] i32 tracked keys (shared), or [NB, S] (a band's own)
    valid_mask: torch.Tensor,  # [fft] bool (shared), or [NB, fft]
    start_level: torch.Tensor,  # 0-d f32
    spectro_keep,  # 0-d f32 tensor or float: 1 = accumulate, 0 = reset first
) -> Tuple[ScanState, torch.Tensor, CompactScanOutputs]:
    # each stage is a span (fused_step.STAGES): a profiler range, cheap when
    # no profiler records, and under a graph capture two marker kernels
    # that replay with the graph (utils/trace.py)
    with span("scan.psd"):
        power = _frames_power(cfg, iq)

    with span("scan.noise"):
        # newest (depth - depth//2 - 1) ring rows BEFORE this block feed the vote
        half_depth = cfg.grouping_y - cfg.grouping_y // 2
        prev_tail = ordered_history(state.averager)[:, -(half_depth - 1) :]
        noise_state, raw_rows = noise_block(state.noise, power, now_ms, cfg.noise_learning_ms)
        if cfg.power_bf16:
            # the rows are stored and voted in bf16 (one quantization); the
            # sums, means and reported values stay f32 arithmetic over them
            raw_rows = raw_rows.to(torch.bfloat16)
    with span("scan.averager"):
        avg_state, mean_rows = averager_block(state.averager, raw_rows)
    state = ScanState(noise_state, avg_state)
    with span("scan.smoothing"):
        avg_rows = sliding_average(mean_rows, cfg.grouping_x)

    with span("scan.detection"):
        compact = compact_detection(
            avg_rows,
            raw_rows,
            prev_tail,
            keys,
            valid_mask,
            start_level,
            group_size,
            top_k,
            bf16=cfg.detection_bf16,
        )
    with span("scan.spectrogram"):
        spectro_acc = spectro_acc * spectro_keep + accumulate_frames(power, cfg.spectro_size)
    with span("scan.pack"):
        f32 = lambda a: a.to(torch.float32)
        nb = power.shape[0]
        body = torch.cat(
            [
                f32(compact.cand_idx),
                compact.cand_val,
                f32(compact.cand_best),
                f32(compact.cand_count)[..., None],
                compact.key_val,
                f32(compact.key_idx),
            ],
            dim=2,
        ).reshape(nb, -1)
        packed = torch.cat([body, f32(state.noise.ready)[:, None]], dim=1)
    return state, spectro_acc, CompactScanOutputs(
        compact=compact, noise_ready=state.noise.ready, packed=packed
    )
