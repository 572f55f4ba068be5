"""The collectives of the time axis as explicit steps in one process.

The JAX package gets them from ``shard_map`` (``jax.lax.ppermute``,
``pmax``, ``psum``). Here a sharded value is a list with one tensor per
shard, each on its shard's device, and every collective is a few small
exact copies:
- ``ppermute_right``: shard s's tensor to shard s + 1 (a peer copy);
- ``pmax``: every shard's tensor stacked on the first device, the max taken
  there and copied back to each shard;
- ``psum``: the shards' tensors added in shard order on the first device;
- the JAX package's "masked psum" of the last shard's value (``x *
  is_last`` summed over shards) is simply the last shard's tensor, copied:
  exact, where multiplying by a 0/1 mask would turn an infinity into NaN.

Copies go through ``Tensor.to(device, non_blocking=True)``. A copy between
two cards is ordered on both cards' current streams: the source stream
waits for the destination's pending work before the copy, and the
destination stream waits for the copy before anything it runs next. A copy
to the tensor's own device returns the tensor itself.

``on(device)`` makes a card current for the work of its shard, so that a
kernel launches on the stream of the card that holds its tensors.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch


def on(device: torch.device):
    """Make ``device`` current for the block (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` (itself when it is there already)."""
    return x.to(device, non_blocking=True)


def ppermute_right(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[Optional[torch.Tensor]]:
    """out[s + 1] = xs[s] on shard s + 1's device; out[0] is None."""
    return [None] + [to(x, d) for x, d in zip(xs[:-1], devices[1:])]


def pmax(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The elementwise max over shards, on every shard's device."""
    home = devices[0]
    m = torch.stack([to(x, home) for x in xs]).amax(dim=0)
    return [to(m, d) for d in devices]


def psum(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The shards' tensors added in shard order, on ``device``."""
    total = to(xs[0], device)
    for x in xs[1:]:
        total = total + to(x, device)
    return total


def last(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The last shard's tensor on ``device`` (the JAX package's psum of
    ``x * is_last``, exactly)."""
    return to(xs[-1], device)


def gather(xs: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` on ``device``."""
    return torch.cat([to(x, device) for x in xs], dim=dim)


__all__ = ["gather", "last", "on", "pmax", "ppermute_right", "psum", "to"]
