"""The (bands, time) device mesh (port of the JAX package's
``parallel/mesh.py``).

The reference time-multiplexes bands on one SDR thread (scanner.cpp:46-60);
the mesh scans them at once:
- axis "bands": frequency bands scanned concurrently; each band's carry
  state lives with its shard, and the shards exchange nothing;
- axis "time": one band's block split into consecutive time shards, the FIR
  stages and the detector carries stitched at the seams
  (``parallel/halo.py``, ``parallel/collectives.py``).

A mesh is a ``[n_bands, n_time]`` grid of ``torch.device``s: by default
the visible cards ``cuda:0..count-1``. An explicit ``devices`` list may name
one device more than once (``["cpu"] * 4``, ``[cuda:0] * 4``): every shard
then runs on that device, in turn, which is how the tests and a one-card
smoke run reach n > 1. The runtime never builds such a mesh: it resolves
its shard count against the visible cards, as the reference resolves it
against ``jax.devices()``.

Under multi-host (``parallel/multihost.py``) a process holds only its own
rows of a global bands mesh: ``band_shards`` names the global index of each
row and ``n_band_shards`` the global count, so that a bands step slices its
rows of a band-stacked value (``parallel/sharded_scan.py``) by global
position. A mesh built by ``make_mesh`` is the whole of it: rows
0..n-1 of n.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device

BANDS_AXIS = "bands"
TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[b][t]``: the device of band shard b, time shard t."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    # the global index of each band shard (row) here, and the band shards
    # of the whole (global) mesh: 0..n-1 and n unless this is one
    # process's part of a multi-host mesh
    band_shards: Tuple[int, ...]
    n_band_shards: int

    @property
    def shape(self) -> dict:
        return {BANDS_AXIS: len(self.devices), TIME_AXIS: len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The first device: where a step's whole-block inputs and outputs
        live (a time-sharded step's state, a session's uploads)."""
        return self.devices[0][0]

    @property
    def band_devices(self) -> List[torch.device]:
        """One device a band shard (time shard 0)."""
        return [row[0] for row in self.devices]

    @property
    def time_devices(self) -> List[torch.device]:
        """One device a time shard (band shard 0)."""
        return list(self.devices[0])


def _default_devices(device: DeviceLike) -> List[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(
    n_bands: Optional[int] = None,
    n_time: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: DeviceLike = None,
) -> Mesh:
    """A (bands, time) mesh over the first n_bands * n_time ``devices``
    (default: every visible card, or ``device`` alone when it names one
    device or the CPU). ``n_bands`` None takes every device on the bands
    axis. Fewer devices than the mesh needs raises ValueError."""
    if devices is None:
        devs = _default_devices(device)
    else:
        devs = [resolve_device(d) for d in devices]
    if n_bands is None:
        n_bands = max(1, len(devs) // n_time)
    if n_bands < 1 or n_time < 1 or n_bands * n_time > len(devs):
        raise ValueError(f"mesh {n_bands}x{n_time} exceeds {len(devs)} devices")
    grid = tuple(tuple(devs[b * n_time : (b + 1) * n_time]) for b in range(n_bands))
    return Mesh(devices=grid, band_shards=tuple(range(n_bands)), n_band_shards=n_bands)


def band_sharding(mesh: Mesh) -> List[torch.device]:
    """Where each band shard of a band-stacked tensor lives."""
    return mesh.band_devices


def replicated(mesh: Mesh) -> List[torch.device]:
    """Where the copies of a replicated tensor live: every mesh device."""
    return [d for row in mesh.devices for d in row]
