"""Time-domain boxcar averager (reference averager.cpp): a ring of
GROUPING_Y frames; NO_DATA until the ring has filled once. The ring also
feeds the detector's history vote.

Bands are a leading batch dimension: every state field carries [NB, ...].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rtl_sdr_scanner_tpu_torch.constants import NO_DATA


class AveragerState(NamedTuple):
    ring: torch.Tensor  # [NB, depth, fft] f32 (bf16 in power_bf16 mode)
    total: torch.Tensor  # [NB, fft] f32 running column sum
    pos: torch.Tensor  # [NB] i32 next write slot
    frames: torch.Tensor  # [NB] i32, saturates at depth


def init_averager_state(
    n_bands: int, fft_size: int, depth: int, device: torch.device, dtype: torch.dtype = torch.float32
) -> AveragerState:
    """``dtype`` is the ring's storage (bf16 in power_bf16 mode); the
    running sum stays f32."""
    return AveragerState(
        ring=torch.zeros((n_bands, depth, fft_size), dtype=dtype, device=device),
        total=torch.zeros((n_bands, fft_size), dtype=torch.float32, device=device),
        pos=torch.zeros((n_bands,), dtype=torch.int32, device=device),
        frames=torch.zeros((n_bands,), dtype=torch.int32, device=device),
    )


def ordered_history(state: AveragerState) -> torch.Tensor:
    """Ring rows oldest-first [NB, depth, fft] (averager.cpp data())."""
    nb, depth, fft = state.ring.shape
    idx = (state.pos[:, None].long() + torch.arange(depth, device=state.ring.device)) % depth
    return torch.gather(state.ring, 1, idx[:, :, None].expand(nb, depth, fft))


def averager_block(
    state: AveragerState, rows: torch.Tensor
) -> Tuple[AveragerState, torch.Tensor]:
    """All frames of a block at once: each mean is a depth-row sum taken as
    a difference of one f32 cumsum over (history ++ block) -- the JAX
    package's order, kept so the stage compares at f32 rounding.

    rows: [NB, F, fft] -> means [NB, F, fft]. The returned ring is stored
    oldest-first with pos=0. Rows are stored in the ring's dtype (one bf16
    quantization in power_bf16 mode); the sums stay f32.
    """
    nb, depth, fft = state.ring.shape
    f = rows.shape[1]
    all_rows = torch.cat([ordered_history(state), rows.to(state.ring.dtype)], dim=1)
    cs = torch.cat(
        [
            torch.zeros((nb, 1, fft), dtype=torch.float32, device=rows.device),
            torch.cumsum(all_rows.to(torch.float32), dim=1),
        ],
        dim=1,
    )
    sums = cs[:, depth + 1 : depth + 1 + f] - cs[:, 1 : 1 + f]  # [NB, F, fft]
    frames = torch.clamp(
        state.frames[:, None]
        + 1
        + torch.arange(f, dtype=torch.int32, device=rows.device),
        max=depth,
    )  # [NB, F]
    means = torch.where((frames >= depth)[..., None], sums / depth, NO_DATA)
    new_state = AveragerState(
        ring=all_rows[:, f : f + depth],
        total=sums[:, -1],
        pos=torch.zeros_like(state.pos),
        frames=frames[:, -1].to(torch.int32),
    )
    return new_state, means
