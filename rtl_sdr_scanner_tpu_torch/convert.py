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
from rtl_sdr_scanner_tpu_torch.ops.cuda.ddc_kernel import mod_fragments
from rtl_sdr_scanner_tpu_torch.ops.ddc import Ddc2State, DdcState, ModTables, NcoTables, StagePlan, modtap_taps
from rtl_sdr_scanner_tpu_torch.ops.noise import NoiseState


def to_tensor(a, device: DeviceLike = None) -> torch.Tensor:
    """numpy array -> a copy on device."""
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def bf16_tensor(a, device: DeviceLike = None) -> torch.Tensor:
    """A bf16 array -> the same bits as a bf16 tensor on device. numpy has
    no bf16 of its own: ``a`` is a ``bfloat16`` array of the ml_dtypes kind
    or its uint16 view (the bit patterns)."""
    bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(resolve_device(device))


def scan_state(
    noise: Mapping[str, np.ndarray], averager: Mapping[str, np.ndarray], device: DeviceLike = None
) -> ScanState:
    """noise: threshold/ready/start_ms; averager: ring/total/pos/frames. A
    bf16 ring (power_bf16 mode) comes as a ``bfloat16`` array or its uint16
    view and stays bf16, bit for bit."""
    t = lambda a: to_tensor(a, device)
    ring = np.asarray(averager["ring"])
    return ScanState(
        noise=NoiseState(
            threshold=t(noise["threshold"]),
            ready=t(noise["ready"]).to(torch.bool),
            start_ms=t(noise["start_ms"]).to(torch.int32),
        ),
        averager=AveragerState(
            ring=bf16_tensor(ring, device) if ring.dtype.itemsize == 2 else t(ring),
            total=t(averager["total"]),
            pos=t(averager["pos"]).to(torch.int32),
            frames=t(averager["frames"]).to(torch.int32),
        ),
    )


def spectro_acc(acc: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    return to_tensor(acc, device).to(torch.float32)


def ddc_state(
    phase: np.ndarray, tails: Sequence[np.ndarray], device: DeviceLike = None
) -> DdcState:
    """The v1 carry, in whatever layout it comes (folded [NB*K, ...] or one band)."""
    return DdcState(
        phase=to_tensor(phase, device), tails=tuple(to_tensor(t, device) for t in tails)
    )


def nco_tables(
    coarse_re: np.ndarray,
    coarse_im: np.ndarray,
    fine_re: np.ndarray,
    fine_im: np.ndarray,
    step: np.ndarray,
    device: DeviceLike = None,
) -> NcoTables:
    """The v1 NCO tables (e.g. ``nco_tables(**tables._asdict())``)."""
    t = lambda a: to_tensor(a, device)
    return NcoTables(t(coarse_re), t(coarse_im), t(fine_re), t(fine_im), t(step))


def ddc2_state(
    phase: np.ndarray, x_tail: np.ndarray, tails: Sequence[np.ndarray], device: DeviceLike = None
) -> Ddc2State:
    return Ddc2State(
        phase=to_tensor(phase, device),
        x_tail=to_tensor(x_tail, device),
        tails=tuple(to_tensor(t, device) for t in tails),
    )


def mod_tables(
    w: np.ndarray, rot: Mapping[str, np.ndarray], plan: StagePlan, device: DeviceLike = None
) -> ModTables:
    """rot: coarse_re/coarse_im/fine_re/fine_im/step of the NCO tables; plan:
    stage 1's, whose modulated taps are read back out of w for the kernel's
    B fragments."""
    frag = mod_fragments(modtap_taps(w, plan), plan.decim, plan.poly_rows)
    return ModTables(w=to_tensor(w, device), rot=nco_tables(**rot, device=device), frag=to_tensor(frag, device))
