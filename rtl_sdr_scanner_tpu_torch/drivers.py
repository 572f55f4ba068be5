"""The block-step drivers of the benchmark (``benchmark/drivers/``) and of
the smoke run on the card (``chip_smoke.py``).

Each holds one geometry's block step with everything a caller feeds it
besides the IQ: the carried state, the DDC tables of its slot shifts, the
detection keys (none pinned), the valid mask (every bin), the start level,
the spectrogram keep, and the frame times of block b (made on the device).
Both build their steps here, so the benchmark times the step the smoke
run checks. The steps are graphed (``graph.donated_step``: one captured
CUDA graph a geometry, the state carried in place; a wideband band mesh's
``graph.sharded_step``: one a band shard); ``.step.fn`` is the eager step.
``kernel_wrappers`` is ``ops.cuda``'s registry, named here for the drivers'
callers.
"""

from __future__ import annotations

import subprocess
from typing import List, Tuple

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.graph import donated_step, sharded_step
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, fused_step, scan_pipeline
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig
from rtl_sdr_scanner_tpu_torch.ops.cuda import kernel_wrappers  # noqa: F401

KEY_SLOTS = 16  # detection keys a band, none pinned (-1)
LEVEL = 8.0  # start_recording_level, dB


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def fir_stages(ddc_cfg: DdcConfig, shards: int = 1) -> list:
    """(plan, input samples a row) of each stage one chunk sends through the
    FIR kernel: every decimation-only stage but a modulated-taps stage 1
    (a time shard's part of the chunk when ``shards`` > 1)."""
    stages, n = [], ddc_cfg.chunk // shards
    for i, plan in enumerate(ddc_cfg.plans):
        if plan.interp == 1 and not (i == 0 and ddc_cfg.modtap):
            stages.append((plan, n))
        n = n * plan.interp // plan.decim
    return stages


def frame_times(cfg: ScanConfig, b: int, device: torch.device) -> torch.Tensor:
    """[F] int32 ms stamps of block b's frames (the first frame of block 0
    at one frame interval), made on ``device``: (b*F + 1 + k) * interval in
    f64, truncated, as numpy's ``astype(np.int32)`` does, with no
    host-to-device copy."""
    f = cfg.frames_per_block
    frames = torch.arange(b * f + 1, b * f + 1 + f, dtype=torch.float64, device=device)
    return (frames * cfg.frame_interval_ms).to(torch.int32)


class BandedBlocks:
    """``make_banded_fused_step`` for ``n_bands`` bands, its slots tuned to
    ``shifts`` [n_bands, K] Hz, driven one block at a time on ``device``."""

    def __init__(
        self,
        cfg: ScanConfig,
        ddc_cfg: DdcConfig,
        group_size: int,
        top_k: int,
        n_bands: int,
        shifts: np.ndarray,
        device: DeviceLike = None,
    ):
        dev = self.device = resolve_device(device)
        self.cfg, self.ddc_cfg, self.n_bands = cfg, ddc_cfg, n_bands
        self.step = donated_step(
            fused_step.make_banded_fused_step(cfg, ddc_cfg, group_size, top_k, device=dev), donate=(0, 1, 2),
            name="banded fused step",
        )
        self.state = [
            scan_pipeline.init_scan_state(cfg, n_bands, 0, device=dev),
            scan_pipeline.init_spectro_acc(cfg, n_bands, device=dev),
            ddc_pipeline.init_state(ddc_cfg, n_bands, device=dev),
        ]
        self.tables = ddc_pipeline.make_tables(ddc_cfg, shifts, device=dev)
        self.shared = [
            torch.full((KEY_SLOTS,), -1, dtype=torch.int32, device=dev),  # keys
            torch.ones(cfg.fft_size, dtype=torch.bool, device=dev),  # valid mask
            torch.tensor(LEVEL, device=dev),  # start level
            torch.tensor(1.0, device=dev),  # spectro keep
        ]

    def now(self, b: int) -> torch.Tensor:
        """[n_bands, F] int32 frame times of block b on the device."""
        return frame_times(self.cfg, b, self.device).expand(self.n_bands, -1).contiguous()

    def run_block(self, b: int, iq: torch.Tensor):
        """Block b of int8 IQ [n_bands, F, fft*decim, 2] through the step;
        returns its FusedOutputs (packed rows, recording), the state carried."""
        *self.state, outs = self.step(*self.state, iq, self.now(b), *self.shared, self.tables)
        return outs


class WidebandBlocks:
    """``bench.py``'s wideband app path: the channelizer splitting one int8
    wideband stream into ``n_bands`` channels, every channel's compact scan
    and their K-slot modulated-taps DDC (slots tuned to ``shifts`` [n_bands,
    K] Hz), fused in one dispatch or split in two, over a band ``mesh``
    (``parallel/sharded_scan``'s per-shard lists)."""

    def __init__(
        self,
        cfg: ScanConfig,
        ddc_cfg: DdcConfig,
        group_size: int,
        top_k: int,
        n_bands: int,
        shifts: np.ndarray,
        fused: bool,
        mesh,
        device: DeviceLike = None,
        chan_bf16: bool = False,
    ):
        from rtl_sdr_scanner_tpu_torch.ops.channelizer import init_channelizer_state, plan_channelizer
        from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss

        dev = self.device = resolve_device(device)
        self.cfg, self.ddc_cfg, self.n_bands, self.fused, self.mesh = cfg, ddc_cfg, n_bands, fused, mesh
        plan = plan_channelizer(n_bands, bf16=chan_bf16)
        m = mesh
        # a graph a band shard, each donating its part of what the JAX package's donate
        if fused:
            self.step = sharded_step(
                ss.make_sharded_wideband_fused_step(cfg, ddc_cfg, group_size, top_k, m, plan, 1, n_bands),
                "wideband fused step",
            )
        else:
            self.wide_step = sharded_step(
                ss.make_sharded_wideband_step(cfg, group_size, top_k, m, plan, 1, n_bands), "wideband step"
            )
            self.ddc_step = sharded_step(ss.make_sharded_banded_ddc(ddc_cfg, m, n_bands), "banded DDC step")
        self.chan = ss.replicate(init_channelizer_state(plan, dev), m)
        self.scan = ss.init_banded_state(cfg, n_bands, m)
        self.acc = ss.shard_bands(torch.zeros((n_bands, cfg.spectro_size), dtype=torch.float32, device=dev), m)
        self.ddc = ss.init_banded_ddc_state(ddc_cfg, n_bands, m)
        self.tables = ss.shard_bands(ddc_pipeline.make_tables(ddc_cfg, shifts, device=dev), m)
        self.keys = ss.shard_bands(torch.full((n_bands, KEY_SLOTS), -1, dtype=torch.int32, device=dev), m)
        self.valid = ss.shard_bands(torch.ones((n_bands, cfg.fft_size), dtype=torch.bool, device=dev), m)
        self.level = ss.replicate(torch.tensor(LEVEL, device=dev), m)
        self.keep_mask = ss.shard_bands(torch.ones(shifts.shape, dtype=torch.float32, device=dev), m)

    def run_block(self, b: int, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Block b of the wideband int8 stream [n_bands * block_samples, 2]
        through the step; returns (packed, rec) as per-shard lists."""
        from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss

        now = ss.replicate(frame_times(self.cfg, b, self.device), self.mesh)
        x = ss.replicate(x, self.mesh)
        if self.fused:
            self.chan, self.scan, self.acc, self.ddc, packed, rec, _ = self.step(
                self.chan, self.scan, self.acc, self.ddc, x, now, self.keys, self.valid, self.level, 1.0,
                self.tables, self.keep_mask)
        else:
            self.chan, self.scan, self.acc, packed, channels = self.wide_step(
                self.chan, self.scan, self.acc, x, now, self.keys, self.valid, self.level, 1.0)
            self.ddc, rec = self.ddc_step(self.ddc, channels, self.tables, self.keep_mask)
        return packed, rec
