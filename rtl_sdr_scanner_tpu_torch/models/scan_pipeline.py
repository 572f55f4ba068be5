"""The detection pipeline over all bands of a block (port of the JAX
package's ``models/scan_pipeline.py``, compact mode):

  int8 cs8 -> PSD dB -> noise max-hold -> 21-row averager -> 21-bin
  smoothing -> compact detection -> one packed f32 vector per band.

Bands are a leading batch dimension ([NB, F, ...]) where the JAX package
vmaps a single-band function.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from rtl_sdr_scanner_tpu_torch.constants import DEFAULT, Tunables
from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.ops.averager import (
    AveragerState,
    averager_block,
    init_averager_state,
    ordered_history,
)
from rtl_sdr_scanner_tpu_torch.ops.detect import K_SEP, CompactOutputs, compact_detection
from rtl_sdr_scanner_tpu_torch.ops.noise import NoiseState, init_noise_state, noise_block
from rtl_sdr_scanner_tpu_torch.ops.psd import dequantize_cs8, pairs_to_complex, psd_frames
from rtl_sdr_scanner_tpu_torch.ops.smooth import sliding_average
from rtl_sdr_scanner_tpu_torch.ops.spectrogram import accumulate_frames, spectrogram_output_size
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import get_fft


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
    use_pallas_psd: bool = False  # the hand-written PSD kernel (int8 ingest)
    detection_bf16: bool = False
    use_pallas_select: bool = False  # the hand-written selection kernel

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
            use_pallas_psd=tunables.use_pallas_psd,
            detection_bf16=tunables.detection_bf16,
            use_pallas_select=tunables.use_pallas_select,
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


class ScanState(NamedTuple):
    noise: NoiseState
    averager: AveragerState


class CompactScanOutputs(NamedTuple):
    compact: CompactOutputs
    noise_ready: torch.Tensor  # [NB] bool AFTER this block
    # per band, one f32 vector: [frames * (3K + 1 + 2S)] frame rows
    # (cand_idx, cand_val, cand_best, cand_count, key_val, key_idx), then
    # noise_ready. Index values are < 2^24, exact in f32.
    packed: torch.Tensor  # [NB, packed_len]


def init_scan_state(
    cfg: ScanConfig, n_bands: int, start_ms: int = 0, device: DeviceLike = None
) -> ScanState:
    dev = resolve_device(device)
    return ScanState(
        noise=init_noise_state(n_bands, cfg.fft_size, start_ms, dev),
        averager=init_averager_state(n_bands, cfg.fft_size, cfg.grouping_y, dev),
    )


def init_spectro_acc(cfg: ScanConfig, n_bands: int, device: DeviceLike = None) -> torch.Tensor:
    """Device-side spectrogram accumulator [NB, spectro_size] f32."""
    return torch.zeros((n_bands, cfg.spectro_size), dtype=torch.float32, device=resolve_device(device))


def _frames_power(cfg: ScanConfig, iq: torch.Tensor) -> torch.Tensor:
    """[NB, F, fft*decim, 2] int8 cs8 or f32 pairs -> [NB, F, fft] PSD dB.

    With the kernel switch on, every input off the CPU goes to the kernel's
    wrapper, which raises on what the kernel does not take (f32 pairs)."""
    nb, f = iq.shape[:2]
    if cfg.use_pallas_psd and (iq.dtype == torch.int8 or iq.device.type != "cpu"):
        from rtl_sdr_scanner_tpu_torch.ops.cuda.psd_kernel import psd_frames_int8

        flat = iq.reshape(nb * f, *iq.shape[2:])
        power = psd_frames_int8(flat, float(cfg.sample_rate), cfg.fft_size, cfg.decimator_factor)
        return power.reshape(nb, f, cfg.fft_size)
    iq = iq[:, :, : cfg.fft_size]  # Decimator first: dequant only what the FFT eats
    x = dequantize_cs8(iq) if iq.dtype == torch.int8 else pairs_to_complex(iq)
    return psd_frames(x, float(cfg.sample_rate))


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
    keys: torch.Tensor,  # [S] i32 tracked keys
    valid_mask: torch.Tensor,  # [fft] bool
    start_level: torch.Tensor,  # 0-d f32
    spectro_keep: torch.Tensor,  # 0-d f32: 1 = accumulate, 0 = reset first
) -> Tuple[ScanState, torch.Tensor, CompactScanOutputs]:
    # each stage is a named profiler range (fused_step.STAGES), cheap when
    # no profiler records; scripts/profile_torch_main_path.py times them
    with record_function("scan.psd"):
        power = _frames_power(cfg, iq)

    with record_function("scan.noise"):
        # newest (depth - depth//2 - 1) ring rows BEFORE this block feed the vote
        half_depth = cfg.grouping_y - cfg.grouping_y // 2
        prev_tail = ordered_history(state.averager)[:, -(half_depth - 1) :]
        noise_state, raw_rows = noise_block(state.noise, power, now_ms, cfg.noise_learning_ms)
    with record_function("scan.averager"):
        avg_state, mean_rows = averager_block(state.averager, raw_rows)
    state = ScanState(noise_state, avg_state)
    with record_function("scan.smoothing"):
        avg_rows = sliding_average(mean_rows, cfg.grouping_x)

    with record_function("scan.detection"):
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
            pallas_select=cfg.use_pallas_select,
        )
    with record_function("scan.spectrogram"):
        spectro_acc = spectro_acc * spectro_keep + accumulate_frames(power, cfg.spectro_size)
    with record_function("scan.pack"):
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
