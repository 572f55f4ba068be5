"""Multi-host scaling over ``torch.distributed`` (port of the JAX package's
``parallel/multihost.py``).

The reference is a single process; its only networking is MQTT to a broker.
The framework scales past one host by running the same config in one
process a host, joined in one process group. Placement policy (the JAX
package's, SURVEY.md section 2):

- the "bands" axis maps across processes: per-band pipelines exchange no
  data, so nothing crosses a process in steady state;
- the "time" axis stays within one process's cards: overlap-save halos
  (``parallel/halo.py``) are latency-sensitive neighbour exchanges.

JAX sees every process's devices in ``jax.devices()``; a torch process sees
only its own. So ``make_global_mesh`` gathers each process's card count
once (an object collective, which the process group sends through gloo on
the CPU) and lays a global ``[bands, time]`` grid of (process, local card)
out in rank order; each process then runs only its own rows
(``local_mesh``). No collective runs on the data path: there is none to
run, and NCCL refuses two ranks on one card, which is how one card stands
for two hosts.

Each process feeds the bands whose mesh rows it owns from its own front end
or replay file and publishes them to the shared MQTT broker under its own
device names: the broker contract is unchanged.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.parallel.mesh import BANDS_AXIS, TIME_AXIS, Mesh
from rtl_sdr_scanner_tpu_torch.utils import logger

LABEL = "multihost"
# how long a process waits for its peers to join (jax.distributed's default)
JOIN_TIMEOUT = datetime.timedelta(seconds=300)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> None:
    """Join the process group (a no-op for a single process).

    Arguments default to the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID environment contract, the launch interface of the
    config-driven runtime (``tunables.multihost``, ``runtime/main.py``):
    start the same config on every host with those three variables set.
    The address is host:port of process 0, which serves the rendezvous.
    ``device`` is where this process scans: the card (the default) joins
    with gloo for objects and NCCL for tensors, the CPU with gloo. A group
    that does not form within JOIN_TIMEOUT raises.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        raw = os.environ.get("JAX_NUM_PROCESSES", "1")
        try:
            num_processes = int(raw)
        except ValueError:
            raise ValueError(f"JAX_NUM_PROCESSES must be an integer, got {raw!r}") from None
    if process_id is None and os.environ.get("JAX_PROCESS_ID") is not None:
        raw = os.environ["JAX_PROCESS_ID"]
        try:
            process_id = int(raw)
        except ValueError:
            raise ValueError(f"JAX_PROCESS_ID must be an integer, got {raw!r}") from None
    if num_processes is None or num_processes <= 1:
        return
    # validate the env contract up front: a rendezvous without an address or
    # a rank fails opaquely, or waits for a peer that never comes
    if not coordinator_address:
        raise ValueError(
            "multihost launch requires JAX_COORDINATOR_ADDRESS "
            "(host:port of process 0) when JAX_NUM_PROCESSES > 1"
        )
    if process_id is None:
        raise ValueError(
            "multihost launch requires JAX_PROCESS_ID "
            "(0..JAX_NUM_PROCESSES-1) when JAX_NUM_PROCESSES > 1"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"JAX_PROCESS_ID {process_id} out of range for JAX_NUM_PROCESSES {num_processes}")
    dev = resolve_device(device)
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=JOIN_TIMEOUT,
    )
    logger.info(LABEL, "joined distributed runtime: process {}/{}", process_index(), process_count())


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank: 0 while no group exists."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes in the group: 1 while no group exists."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class GlobalMesh:
    """``grid[b][t]`` = (process, local card index) of band shard b, time
    shard t, over every process's cards; ``process`` is this process."""

    grid: Tuple[Tuple[Tuple[int, int], ...], ...]
    process: int

    @property
    def shape(self) -> dict:
        return {BANDS_AXIS: len(self.grid), TIME_AXIS: len(self.grid[0])}

    def bands(self, n: int) -> "GlobalMesh":
        """The first n band rows (a mesh over fewer cards than the world's,
        as the reference takes the first n of ``jax.devices()``)."""
        if not 1 <= n <= len(self.grid):
            raise ValueError(f"{n} band shards of a {len(self.grid)}-row mesh")
        return dataclasses.replace(self, grid=self.grid[:n])


def make_global_mesh(n_time_per_host: int = 1, cards: int = 1) -> GlobalMesh:
    """The (bands, time) mesh over every process's cards (``cards``: this
    process's), each time row inside one process. Every process of the
    group must call it, in the same order as its other collectives. If any
    process's count does not divide by ``n_time_per_host``, the time axis
    falls back to 1, as the reference's does."""
    counts = [cards]
    if process_count() > 1:
        counts = [None] * process_count()
        # an object collective: gloo on the CPU even in a group whose
        # tensors go through NCCL
        dist.all_gather_object(counts, cards)
    n_time = n_time_per_host
    if n_time < 1 or any(c % n_time for c in counts):
        n_time = 1
    rows = []
    for proc, count in enumerate(counts):
        for first in range(0, count - count % n_time, n_time):
            rows.append(tuple((proc, first + t) for t in range(n_time)))
    if not rows:
        raise ValueError(f"no process holds {n_time} cards: {counts}")
    return GlobalMesh(grid=tuple(rows), process=process_index())


def local_band_indices(mesh: GlobalMesh) -> List[int]:
    """Band rows whose first card this process owns: the bands this process
    feeds with IQ."""
    return [b for b, row in enumerate(mesh.grid) if row[0][0] == mesh.process]


def local_mesh(mesh: GlobalMesh, devices: Sequence[DeviceLike]) -> Mesh:
    """This process's part of ``mesh``: a ``Mesh`` over its own rows, local
    card index i standing for ``devices[i]``, that knows the global index
    of each of its band shards and the global shard count. A process that
    owns no band shard raises: it would feed nothing."""
    mine = local_band_indices(mesh)
    if not mine:
        raise ValueError(
            f"process {mesh.process} owns no band shard of the {len(mesh.grid)}-shard mesh; "
            "give the mesh at least one card of every process (mesh_bands -1)"
        )
    devs = [resolve_device(d) for d in devices]
    try:
        grid = tuple(tuple(devs[local] for _, local in mesh.grid[b]) for b in mine)
    except IndexError:
        raise ValueError(f"process {mesh.process}: the mesh names cards beyond its {len(devs)} devices") from None
    return Mesh(devices=grid, band_shards=tuple(mine), n_band_shards=len(mesh.grid))


__all__ = [
    "GlobalMesh",
    "initialize",
    "local_band_indices",
    "local_mesh",
    "make_global_mesh",
    "process_count",
    "process_index",
    "shutdown",
]
