"""Fused scan+DDC block step: the per-block device program (port of the
JAX package's ``models/fused_step``), over all bands or one.

Both halves consume the same int8 block: the compact scan with bands as a
leading batch dimension, and the banded DDC (modulated taps or v1, as the
chain's plan says).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import (
    DdcConfig,
    _band_axis,
    _ddc_block_banded,
)
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig, _check_device, _compact_scan_block
from rtl_sdr_scanner_tpu_torch.ops.ddc import no_tf32
from rtl_sdr_scanner_tpu_torch.utils.trace import span

# the step's profiler ranges, in the order one block runs them
STAGES = (
    "scan.psd",
    "scan.noise",
    "scan.averager",
    "scan.smoothing",
    "scan.detection",
    "scan.spectrogram",
    "scan.pack",
    "ddc",
)


class FusedOutputs(NamedTuple):
    packed: torch.Tensor  # [NB, packed_len] compact scan outputs
    recording: torch.Tensor  # [NB, num_slots, out_per_block, 2] int8 IQ


def make_banded_fused_step(
    scan_cfg: ScanConfig,
    ddc_cfg: DdcConfig,
    group_size: int,
    top_k: int = 64,
    device: DeviceLike = None,
):
    """Step over ALL bands: (scan_state, spectro_acc, ddc_state, iq, now_ms,
    keys, valid_mask, start_level, spectro_keep, tables) ->
    (scan_state, spectro_acc, ddc_state, FusedOutputs).

    Band axis on scan_state, spectro_acc, iq ([NB, F, fft*decim, 2] int8)
    and now_ms ([NB, F] i32); ddc_state and tables in the banded DDC layout
    (``ddc_pipeline``: [NB, ...] for modulated taps, folded [NB*K, ...] for
    v1); keys, valid_mask, start_level and spectro_keep are shared. Every
    tensor lies on ``device``. Building the step switches TF32 off (the
    DDC's f32 products).
    """
    dev = resolve_device(device)
    no_tf32()

    def banded(
        scan_state, spectro_acc, ddc_state, iq, now_ms, keys, valid_mask,
        start_level, spectro_keep, tables,
    ):
        _check_device(dev, iq)
        scan_state, spectro_acc, outs = _compact_scan_block(
            scan_cfg, group_size, top_k, scan_state, spectro_acc, iq, now_ms,
            keys, valid_mask, start_level, spectro_keep,
        )
        nb = iq.shape[0]
        with span("ddc"):
            ddc_state, rec = _ddc_block_banded(ddc_cfg, ddc_state, iq.reshape(nb, -1, 2), tables)
        return scan_state, spectro_acc, ddc_state, FusedOutputs(
            packed=outs.packed, recording=rec
        )

    return banded


def make_fused_step(
    scan_cfg: ScanConfig,
    ddc_cfg: DdcConfig,
    group_size: int,
    top_k: int = 64,
    device: DeviceLike = None,
):
    """The same step for one band, in the JAX package's single-band layouts
    (no band axis): iq [F, fft*decim, 2], now_ms [F], the DDC state and
    tables of ``ddc_pipeline.init_state(cfg)`` / ``make_tables(cfg, [K])``;
    outputs packed [packed_len] and recording [K, out_per_block, 2]. It
    runs the banded step at NB=1."""
    banded = make_banded_fused_step(scan_cfg, ddc_cfg, group_size, top_k, device)
    # the v1 banded layout folds bands into rows: at NB=1 it is the single one
    ddc_axis = _band_axis if ddc_cfg.modtap else (lambda tree, add: tree)

    def single(
        scan_state, spectro_acc, ddc_state, iq, now_ms, keys, valid_mask,
        start_level, spectro_keep, tables,
    ):
        scan_state, spectro_acc, ddc_state, outs = banded(
            _band_axis(scan_state, add=True), spectro_acc[None], ddc_axis(ddc_state, add=True),
            iq[None], now_ms[None], keys, valid_mask, start_level, spectro_keep,
            ddc_axis(tables, add=True),
        )
        return (
            _band_axis(scan_state, add=False),
            spectro_acc[0],
            ddc_axis(ddc_state, add=False),
            _band_axis(outs, add=False),
        )

    return single


__all__ = ["STAGES", "FusedOutputs", "make_banded_fused_step", "make_fused_step"]
