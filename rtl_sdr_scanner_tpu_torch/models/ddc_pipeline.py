"""The recorder bank: K-slot DDC over a block, all bands at once (port of
the JAX package's ``models/ddc_pipeline.py``, modulated-taps path)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.ops.ddc import (
    Ddc2State,
    ModTables,
    StagePlan,
    chain_block_multiple,
    chain_output_length,
    ddc_chunk_modtap,
    init_ddc2_state,
    make_mod_tables,
    plan_chain,
)


@dataclasses.dataclass(frozen=True)
class DdcConfig:
    sample_rate: int
    bandwidth: int  # recording.min_sample_rate (config.cpp:79)
    num_slots: int  # recorder pool size per band
    chunk: int  # samples per inner chunk
    num_chunks: int  # chunks per block
    plans: Tuple[StagePlan, ...]

    @classmethod
    def create(
        cls,
        sample_rate: int,
        bandwidth: int,
        num_slots: int,
        block_samples: int,
        resampler_threshold: int = 125,
        chunk_target: int = 1 << 21,
    ) -> "DdcConfig":
        plans = tuple(plan_chain(sample_rate, bandwidth, resampler_threshold))
        mult = chain_block_multiple(plans)
        chunk = block_samples
        num_chunks = 1
        while chunk > chunk_target and chunk % 2 == 0 and (chunk // 2) % mult == 0:
            chunk //= 2
            num_chunks *= 2
        if block_samples % mult != 0:
            raise ValueError(
                f"block_samples {block_samples} not divisible by resampler multiple {mult}"
            )
        return cls(sample_rate, bandwidth, num_slots, chunk, num_chunks, plans)

    @property
    def block_samples(self) -> int:
        return self.chunk * self.num_chunks

    @property
    def out_per_block(self) -> int:
        return chain_output_length(self.plans, self.block_samples)

    @property
    def modtap(self) -> bool:
        """True when the modulated-taps path applies: a decimation-only first
        stage with the chunked-matmul form available."""
        return self.plans[0].interp == 1 and self.plans[0].chunk_c > 0


def _require_modtap(cfg: DdcConfig) -> None:
    if not cfg.modtap:
        raise NotImplementedError("only the modulated-taps DDC path is ported yet")


def init_state(cfg: DdcConfig, n_bands: int, device: DeviceLike = None) -> Ddc2State:
    _require_modtap(cfg)
    return init_ddc2_state(cfg.plans, n_bands, cfg.num_slots, resolve_device(device))


def make_tables(cfg: DdcConfig, shifts: np.ndarray, device: DeviceLike = None) -> ModTables:
    """Modulated-tap tables for per-slot shifts [NB, K] (recorder.cpp:58-73)."""
    _require_modtap(cfg)
    return make_mod_tables(cfg.plans, shifts, cfg.sample_rate, cfg.chunk, resolve_device(device))


def fold_banded(tree):
    """Stack-of-bands -> banded-DDC layout. For the modulated-taps state and
    tables the banded layout IS the stacked [NB, ...] layout."""
    if not isinstance(tree, (Ddc2State, ModTables)):
        raise TypeError(f"fold_banded: unsupported {type(tree).__name__}")
    return tree


def _ddc_block_banded(
    cfg: DdcConfig,
    state: Ddc2State,
    iq: torch.Tensor,  # [NB, block_samples, 2] int8 or f32 pairs
    tables: ModTables,
) -> Tuple[Ddc2State, torch.Tensor]:
    """All-bands DDC block, one chunk at a time: int8 [NB, K, out_per_block, 2]."""
    _require_modtap(cfg)
    nb = iq.shape[0]
    chunks = iq.reshape(nb, cfg.num_chunks, cfg.chunk, 2)
    outs = []
    for c in range(cfg.num_chunks):
        state, out = ddc_chunk_modtap(chunks[:, c], state, tables, cfg.plans)
        outs.append(out)
    return state, torch.cat(outs, dim=2)
