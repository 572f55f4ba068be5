"""Noise-floor learner (reference noise_learner.cpp): per-bin max-hold over
the learning window, then output = power - threshold. While learning --
including the frame on which learning completes -- the output is NO_DATA.

Bands are a leading batch dimension: every state field carries [NB, ...].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rtl_sdr_scanner_tpu_torch.constants import NO_DATA


class NoiseState(NamedTuple):
    threshold: torch.Tensor  # [NB, fft] f32 max-hold; -inf until learned
    ready: torch.Tensor  # [NB] bool
    start_ms: torch.Tensor  # [NB] i32 first-frame arrival (ms from the stream epoch)


def init_noise_state(
    n_bands: int, fft_size: int, start_ms: int, device: torch.device
) -> NoiseState:
    return NoiseState(
        threshold=torch.full((n_bands, fft_size), -torch.inf, device=device),
        ready=torch.zeros((n_bands,), dtype=torch.bool, device=device),
        start_ms=torch.full((n_bands,), start_ms, dtype=torch.int32, device=device),
    )


def noise_block(
    state: NoiseState, power: torch.Tensor, now_ms: torch.Tensor, learning_time_ms: int
) -> Tuple[NoiseState, torch.Tensor]:
    """All frames of a block at once.

    power: [NB, F, fft]; now_ms: [NB, F] i32, nondecreasing. Readiness only
    depends on time, so the learning frames form a prefix and the frozen
    threshold is max(threshold_in, max-hold over that prefix).
    """
    cond = state.start_ms[:, None] + learning_time_ms <= now_ms  # [NB, F]
    # readiness ENTERING frame k = ready_in | cond_{k-1}
    entering = torch.cat([torch.zeros_like(cond[:, :1]), cond[:, :-1]], dim=1)
    was_ready = state.ready[:, None] | entering
    learning = ~was_ready
    held = torch.where(learning[..., None], power, -torch.inf).amax(dim=1)
    threshold = torch.maximum(state.threshold, held)
    out = torch.where(was_ready[..., None], power - threshold[:, None, :], NO_DATA)
    ready = state.ready | cond[:, -1]
    return NoiseState(threshold=threshold, ready=ready, start_ms=state.start_ms), out
