"""Device placement for the bands layer (port of the JAX package's
``parallel/mesh.py``, one-card form).

The JAX package lays devices out as a 2D (bands, time) mesh. On one card
that mesh is the card itself: every band's state and every dispatch live
there, and the placements ``band_sharding`` / ``replicated`` name that
card. A mesh of more than one card (bands or time) is the multi-device
layer, ROADMAP.md section 1, slice 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device

BANDS_AXIS = "bands"
TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (bands, time) layout of cards; here always 1 x 1 on ``device``."""

    device: torch.device
    shape: dict


def make_mesh(n_bands: Optional[int] = None, n_time: int = 1, device: DeviceLike = None) -> Mesh:
    """The one-card mesh on ``device`` (default the card). More than one
    card on either axis raises NotImplementedError."""
    n_bands = 1 if n_bands is None else n_bands
    if n_bands != 1 or n_time != 1:
        raise NotImplementedError(
            f"a {n_bands}x{n_time} mesh spans more than one card: the multi-device layer is not "
            "ported yet (ROADMAP.md section 1, slice 8)"
        )
    return Mesh(device=resolve_device(device), shape={BANDS_AXIS: 1, TIME_AXIS: 1})


def band_sharding(mesh: Mesh) -> torch.device:
    """Where a band-stacked tensor lives: on one card, the card."""
    return mesh.device


def replicated(mesh: Mesh) -> torch.device:
    """Where a replicated tensor lives: on one card, the card."""
    return mesh.device
