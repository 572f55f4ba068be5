"""Overlap-save halo exchange for time-sharded filtering (port of the JAX
package's ``parallel/halo.py``).

When one band's IQ stream is split into consecutive time shards, every FIR
stage needs the last (ntaps-1) input-domain samples of the previous shard
to produce exact outputs at the seam: the distributed form of the
per-block tails ``ops/ddc.py`` carries.

Convention: shard s processes samples [s*n, (s+1)*n) of the global stream
and its tensor lives on ``devices[s]``. Shard 0 receives zeros (a causal
stream start, as the single-device streaming state starts).
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import torch

from rtl_sdr_scanner_tpu_torch.graph import eager_segment
from rtl_sdr_scanner_tpu_torch.ops.ddc import StagePlan, _stage_apply
from rtl_sdr_scanner_tpu_torch.parallel.collectives import on, ppermute_right


def halo_from_left(
    xs: Sequence[torch.Tensor], halo_len: int, devices: Sequence[torch.device]
) -> List[torch.Tensor]:
    """Each shard's left halo: the last ``halo_len`` samples (last axis) of
    the previous shard's tensor, on this shard's device; zeros on shard 0."""
    left = ppermute_right([x[..., -halo_len:].contiguous() for x in xs], devices)
    x0 = xs[0]
    left[0] = torch.zeros((*x0.shape[:-1], halo_len), dtype=x0.dtype, device=x0.device)
    return left


def resample_chain_sharded(
    xs: Sequence[torch.Tensor], plans: Sequence[StagePlan], devices: Sequence[torch.device], segment=eager_segment
) -> List[torch.Tensor]:
    """The staged resampler on a time-sharded stream, with halo exchange.

    xs: each shard's samples as [K, 2, n] f32 (the single-device chain's
    layout). The outputs equal the single-device streaming chain run over
    the concatenated stream, split at the shard boundaries. Each stage goes
    through ``ops/ddc._stage_apply``: a decimation-only stage launches the
    FIR kernel once on each shard. Each (shard, stage) is a segment of a
    ``graph.Program`` (``segment``: eager by default), the halos exchanged
    between them."""
    xs = list(xs)
    for i, plan in enumerate(plans):
        tails = halo_from_left(xs, plan.tail_len, devices)
        for s, dev in enumerate(devices):
            with on(dev):
                xs[s], _ = segment(f"shard {s} stage {i + 1}", partial(_stage_apply, plan=plan), (), dev)(xs[s], tails[s])
    return xs


__all__ = ["halo_from_left", "resample_chain_sharded"]
