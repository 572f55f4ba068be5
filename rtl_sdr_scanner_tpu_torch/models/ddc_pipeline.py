"""The recorder bank: K-slot DDC over a block (port of the JAX package's
``models/ddc_pipeline.py``), single band or all bands at once.

Two paths, chosen by the chain's plan (``DdcConfig.modtap``):
- modulated taps, when stage 1 is a decimation with the chunked-matmul
  form: ``Ddc2State`` / ``ModTables``, banded leaves [NB, ...];
- v1 (NCO + resampler cascade) otherwise: ``DdcState`` / ``NcoTables``,
  banded leaves folded to [NB*K, ...] (``fold_banded``).
Single-band layouts are the JAX package's: no band axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.ops.ddc import (
    Ddc2State,
    DdcState,
    ModTables,
    NcoTables,
    StagePlan,
    chain_block_multiple,
    chain_output_length,
    ddc_chunk,
    ddc_chunk_banded,
    ddc_chunk_modtap,
    init_ddc2_state,
    init_ddc_state,
    make_mod_tables,
    make_nco_tables,
    no_tf32,
    plan_chain,
    reset_slot2,
)
from rtl_sdr_scanner_tpu_torch.ops.ddc import reset_slot as _reset_slot_v1
from rtl_sdr_scanner_tpu_torch.utils.trace import span

State = Union[DdcState, Ddc2State]
Tables = Union[NcoTables, ModTables]


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


def _band_axis(tree, add: bool):
    """Add (or drop) a leading band axis of size 1 on every leaf."""
    if isinstance(tree, torch.Tensor):
        return tree[None] if add else tree[0]
    items = [_band_axis(v, add) for v in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def init_state(cfg: DdcConfig, n_bands: Optional[int] = None, device: DeviceLike = None) -> State:
    """Zero carry: single band (``n_bands`` None) or banded."""
    dev = resolve_device(device)
    if cfg.modtap:
        state = init_ddc2_state(cfg.plans, n_bands or 1, cfg.num_slots, dev)
        return state if n_bands is not None else _band_axis(state, add=False)
    return init_ddc_state(cfg.plans, (n_bands or 1) * cfg.num_slots, dev)


def reset_slot(state: State, slot: int) -> State:
    """Zero one slot's carry of a single-band state (dispatches on the state
    type; a v1 banded state takes its folded row band*K + slot)."""
    if isinstance(state, Ddc2State):
        return _band_axis(reset_slot2(_band_axis(state, add=True), 0, slot), add=False)
    return _reset_slot_v1(state, slot)


def make_tables(cfg: DdcConfig, shifts: np.ndarray, device: DeviceLike = None) -> Tables:
    """Per-slot tables for shifts [K] (single band) or [NB, K] (banded), made
    again when a slot's shift changes (recorder.cpp:58-73)."""
    dev = resolve_device(device)
    if cfg.modtap:
        return make_mod_tables(cfg.plans, shifts, cfg.sample_rate, cfg.chunk, dev)
    return fold_banded(make_nco_tables(shifts, cfg.sample_rate, cfg.chunk, dev))


def fold_banded(tree):
    """Stack-of-bands -> banded-DDC layout. v1 (``DdcState``/``NcoTables``):
    [NB, K, ...] leaves fold to [NB*K, ...] (a [K, ...] single-band tree is
    left as it is). Modulated taps: the banded layout IS the stacked
    [NB, ...] layout; returned unchanged."""
    if isinstance(tree, (Ddc2State, ModTables)):
        return tree
    if isinstance(tree, NcoTables):
        if tree.step.ndim == 1:
            return tree
        return NcoTables(*(t.reshape((-1,) + t.shape[2:]) for t in tree))
    if isinstance(tree, DdcState):
        if tree.phase.ndim == 1:
            return tree
        return DdcState(
            phase=tree.phase.reshape(-1),
            tails=tuple(t.reshape((-1,) + t.shape[2:]) for t in tree.tails),
        )
    raise TypeError(f"fold_banded: unsupported {type(tree).__name__}")


def _ddc_block_banded(
    cfg: DdcConfig,
    state: State,
    iq: torch.Tensor,  # [NB, block_samples, 2] int8 / f32 pairs, or [NB, block_samples] complex
    tables: Tables,
) -> Tuple[State, torch.Tensor]:
    """All-bands DDC block, one chunk at a time: int8 [NB, K, out_per_block, 2]."""
    nb = iq.shape[0]
    chunks = iq.reshape(nb, cfg.num_chunks, cfg.chunk, *iq.shape[2:])
    outs = []
    for c in range(cfg.num_chunks):
        if cfg.modtap:
            state, out = ddc_chunk_modtap(chunks[:, c], state, tables, cfg.plans)
        else:
            state, out = ddc_chunk_banded(chunks[:, c], state, tables, cfg.plans)
        outs.append(out)
    return state, torch.cat(outs, dim=2)


def _ddc_block(
    cfg: DdcConfig,
    state: State,
    iq: torch.Tensor,  # [block_samples, 2] int8 / f32 pairs, or [block_samples] complex
    tables: Tables,
) -> Tuple[State, torch.Tensor]:
    """Single-band DDC block: int8 [K, out_per_block, 2]. Modulated taps run
    as NB=1 through the banded code; v1 through ``ddc_chunk``."""
    if cfg.modtap:
        state_b, out = _ddc_block_banded(
            cfg, _band_axis(state, add=True), iq[None], _band_axis(tables, add=True)
        )
        return _band_axis(state_b, add=False), out[0]
    chunks = iq.reshape(cfg.num_chunks, cfg.chunk, *iq.shape[1:])
    outs = []
    for c in range(cfg.num_chunks):
        state, out = ddc_chunk(chunks[c], state, tables, cfg.plans)
        outs.append(out)
    return state, torch.cat(outs, dim=1)


def make_ddc_step(cfg: DdcConfig, device: DeviceLike = None):
    """Single-band block step (state, iq, tables) -> (state, int8
    [K, out_per_block, 2]) on ``device``, in the span "ddc"; building it
    switches TF32 off."""
    resolve_device(device)
    no_tf32()

    def step(state: State, iq: torch.Tensor, tables: Tables) -> Tuple[State, torch.Tensor]:
        with span("ddc"):
            return _ddc_block(cfg, state, iq, tables)

    return step


__all__ = [
    "DdcConfig",
    "DdcState",
    "Ddc2State",
    "ModTables",
    "NcoTables",
    "fold_banded",
    "init_state",
    "make_tables",
    "make_ddc_step",
    "reset_slot",
]
