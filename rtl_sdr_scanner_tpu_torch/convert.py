"""Carry state across from the JAX package: its state given as numpy
arrays (banded, [NB, ...] leaves) becomes the port's tensors on a device,
so a run can resume mid-stream in the port.

The caller flattens the JAX NamedTuples to numpy first (e.g.
``jax.tree.map(np.asarray, state)._asdict()``); this module never sees a
JAX type.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanState
from rtl_sdr_scanner_tpu_torch.ops.averager import AveragerState
from rtl_sdr_scanner_tpu_torch.ops.ddc import Ddc2State, ModTables, NcoTables
from rtl_sdr_scanner_tpu_torch.ops.noise import NoiseState


def to_tensor(a, device: DeviceLike = None) -> torch.Tensor:
    """numpy array -> a copy on device."""
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def scan_state(
    noise: Mapping[str, np.ndarray], averager: Mapping[str, np.ndarray], device: DeviceLike = None
) -> ScanState:
    """noise: threshold/ready/start_ms; averager: ring/total/pos/frames."""
    t = lambda a: to_tensor(a, device)
    return ScanState(
        noise=NoiseState(
            threshold=t(noise["threshold"]),
            ready=t(noise["ready"]).to(torch.bool),
            start_ms=t(noise["start_ms"]).to(torch.int32),
        ),
        averager=AveragerState(
            ring=t(averager["ring"]),
            total=t(averager["total"]),
            pos=t(averager["pos"]).to(torch.int32),
            frames=t(averager["frames"]).to(torch.int32),
        ),
    )


def spectro_acc(acc: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    return to_tensor(acc, device).to(torch.float32)


def ddc2_state(
    phase: np.ndarray, x_tail: np.ndarray, tails: Sequence[np.ndarray], device: DeviceLike = None
) -> Ddc2State:
    return Ddc2State(
        phase=to_tensor(phase, device),
        x_tail=to_tensor(x_tail, device),
        tails=tuple(to_tensor(t, device) for t in tails),
    )


def mod_tables(
    w: np.ndarray, rot: Mapping[str, np.ndarray], device: DeviceLike = None
) -> ModTables:
    """rot: coarse_re/coarse_im/fine_re/fine_im/step of the NCO tables."""
    return ModTables(
        w=to_tensor(w, device),
        rot=NcoTables(**{name: to_tensor(rot[name], device) for name in NcoTables._fields}),
    )
