"""Fused scan+DDC block step over all bands: the per-block device program
(port of the JAX package's ``models/fused_step.make_banded_fused_step``).

Both halves consume the same int8 block: the compact scan with bands as a
leading batch dimension, and the banded modulated-taps DDC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig, _ddc_block_banded
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig, _compact_scan_block
from rtl_sdr_scanner_tpu_torch.ops.ddc import no_tf32

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

    Band axis on scan_state, spectro_acc, ddc_state, tables, iq
    ([NB, F, fft*decim, 2] int8) and now_ms ([NB, F] i32); keys, valid_mask,
    start_level and spectro_keep are shared. Every tensor lies on ``device``.
    Building the step switches TF32 off (the DDC's f32 products).
    """
    dev = resolve_device(device)
    no_tf32()

    def banded(
        scan_state, spectro_acc, ddc_state, iq, now_ms, keys, valid_mask,
        start_level, spectro_keep, tables,
    ):
        if iq.device.type != dev.type:
            raise ValueError(f"step built for {dev}, got iq on {iq.device}")
        scan_state, spectro_acc, outs = _compact_scan_block(
            scan_cfg, group_size, top_k, scan_state, spectro_acc, iq, now_ms,
            keys, valid_mask, start_level, spectro_keep,
        )
        nb = iq.shape[0]
        with record_function("ddc"):
            ddc_state, rec = _ddc_block_banded(ddc_cfg, ddc_state, iq.reshape(nb, -1, 2), tables)
        return scan_state, spectro_acc, ddc_state, FusedOutputs(
            packed=outs.packed, recording=rec
        )

    return banded


__all__ = ["STAGES", "FusedOutputs", "make_banded_fused_step"]
