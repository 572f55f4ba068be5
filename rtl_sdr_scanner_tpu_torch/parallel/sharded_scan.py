"""The wideband block steps over all channels of one card (port of the JAX
package's ``parallel/sharded_scan.py``, one-card forms).

The JAX package shards the B channels over a "bands" mesh axis with
``shard_map``; on one card the whole band axis lives on the card, and each
step is the same sequence of operations over all B channels at once:
- ``make_sharded_wideband_step``: the channelizer, then the banded compact
  scan of every channel (each with its own tracked keys and valid mask);
- ``make_sharded_banded_ddc``: every channel's K-slot modulated-taps DDC
  in one call, slot resets riding a keep mask;
- ``make_sharded_wideband_fused_step``: the two in one dispatch.

Argument order and layouts are the JAX functions'. Building a step switches
TF32 off (the channelizer's and the DDC's f32 products). More than one card
is the multi-device layer (ROADMAP.md section 1, slice 8): ``make_mesh``
refuses it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig, _ddc_block_banded
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import (
    ScanConfig,
    ScanState,
    _compact_scan_block,
    init_scan_state,
)
from rtl_sdr_scanner_tpu_torch.ops.channelizer import (
    ChannelizerPlan,
    channelize_block_2x_pairs,
    channelize_block_pairs,
)
from rtl_sdr_scanner_tpu_torch.ops.ddc import Ddc2State, no_tf32
from rtl_sdr_scanner_tpu_torch.parallel.mesh import Mesh

# the profiler ranges a wideband block opens beyond the scan's own
# (fused_step.STAGES) and "ddc"
STAGES = ("channelize",)


def init_banded_state(cfg: ScanConfig, n_bands: int, mesh: Mesh, start_ms: int = 0) -> ScanState:
    """Band-stacked scan state on the mesh's card."""
    return init_scan_state(cfg, n_bands, start_ms, device=mesh.device)


def init_banded_ddc_state(cfg: DdcConfig, n_bands: int, mesh: Mesh) -> Ddc2State:
    """Band-stacked DDC carry (leading NB axis on every leaf) on the card."""
    return ddc_pipeline.init_state(cfg, n_bands, device=mesh.device)


def _channelizer(plan: ChannelizerPlan, oversample: int):
    fn = channelize_block_2x_pairs if oversample == 2 else channelize_block_pairs
    return lambda state, x_pairs: fn(plan, state, x_pairs)


def _keep_slots(state: Ddc2State, keep: torch.Tensor) -> Ddc2State:
    """Zero the phase and stage-2+ tails of slots whose keep is 0 (a slot
    reset; the shared raw-x tail persists, as ``reset_slot2``)."""
    return Ddc2State(
        phase=state.phase * keep,
        x_tail=state.x_tail,
        tails=tuple(t * keep[..., None, None] for t in state.tails),
    )


def _scan_channels(cfg, group_size, top_k, n_bands, state, acc, channels, now, keys, valid, level, keep):
    frames = cfg.frames_per_block
    group = cfg.fft_size * cfg.decimator_factor
    iq = channels.reshape(n_bands, frames, group, 2)
    now_b = now[None, :].expand(n_bands, frames)
    return _compact_scan_block(cfg, group_size, top_k, state, acc, iq, now_b, keys, valid, level, keep)


def make_sharded_wideband_step(
    cfg: ScanConfig,
    group_size: int,
    top_k: int,
    mesh: Mesh,
    plan: ChannelizerPlan,
    oversample: int,
    n_bands: int,
):
    """Channelizer + banded compact scan in one dispatch:
    (chan_state, scan_state[B,..], acc[B,S], x_pairs[n,2], now[F],
     keys[B,S], valid[B,fft], level, keep) ->
      (chan_state, scan_state, acc, packed[B,L], channels[B, n_sub, 2])
    x_pairs f32 pairs or int8 cs8; level a 0-d f32 tensor; keep a float."""
    no_tf32()
    chan_fn = _channelizer(plan, oversample)

    def step(chan_state, state, acc, x_pairs, now, keys, valid, level, keep):
        with record_function("channelize"):
            chan_state, channels = chan_fn(chan_state, x_pairs)  # [B, n_sub, 2]
        state, acc, outs = _scan_channels(
            cfg, group_size, top_k, n_bands, state, acc, channels, now, keys, valid, level, keep
        )
        return chan_state, state, acc, outs.packed, channels

    return step


def make_sharded_wideband_fused_step(
    cfg: ScanConfig,
    ddc_cfg: DdcConfig,
    group_size: int,
    top_k: int,
    mesh: Mesh,
    plan: ChannelizerPlan,
    oversample: int,
    n_bands: int,
):
    """Channelizer + banded compact scan + banded K*B-slot DDC in one
    dispatch. ``keep_mask`` and ``tables`` are inputs: the host supplies
    the slot reconcile it derived from the previous block's detections (the
    reference's notification timing, recorder.cpp:58-73).

    (chan_state, scan_state[B,..], acc[B,S], ddc_state[B,..], x_pairs[n,2],
     now[F], keys[B,S], valid[B,fft], level, keep, tables[B,..],
     keep_mask[B,K]) ->
      (chan_state, scan_state, acc, ddc_state, packed[B,L],
       rec[B,K,out,2] i8, channels[B, n_sub, 2])"""
    assert ddc_cfg.modtap, "fused wideband step requires the modulated-taps chain"
    no_tf32()
    chan_fn = _channelizer(plan, oversample)

    def step(chan_state, state, acc, ddc_state, x_pairs, now, keys, valid, level, keep, tables, keep_mask):
        with record_function("channelize"):
            chan_state, channels = chan_fn(chan_state, x_pairs)
        state, acc, outs = _scan_channels(
            cfg, group_size, top_k, n_bands, state, acc, channels, now, keys, valid, level, keep
        )
        with record_function("ddc"):
            ddc_state, rec = _ddc_block_banded(ddc_cfg, _keep_slots(ddc_state, keep_mask), channels, tables)
        return chan_state, state, acc, ddc_state, outs.packed, rec, channels

    return step


def make_sharded_banded_ddc(cfg: DdcConfig, mesh: Mesh, n_bands: int):
    """All channels' K-slot DDC in one dispatch; slot resets ride a keep
    mask (0 = zero that slot's carry before the block):
    (state[NB,..], channels[NB, n, 2] f32 pairs, tables[NB,..], keep[NB, K])
      -> (state, int8 [NB, K, out_per_block, 2])"""
    assert cfg.modtap, "banded sharded DDC requires the modulated-taps chain"
    no_tf32()

    def step(state, channels, tables, keep) -> Tuple[Ddc2State, torch.Tensor]:
        with record_function("ddc"):
            return _ddc_block_banded(cfg, _keep_slots(state, keep), channels, tables)

    return step


__all__ = [
    "STAGES",
    "init_banded_ddc_state",
    "init_banded_state",
    "make_sharded_banded_ddc",
    "make_sharded_wideband_fused_step",
    "make_sharded_wideband_step",
]
