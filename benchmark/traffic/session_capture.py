"""Generator of a session's traffic: one cs8 capture held in host memory,
looped by the session driver with a stream clock that keeps counting.

The capture is ``capture_s`` seconds (rounded up to whole blocks) of complex
noise at ``noise_rms`` and ``transmitters`` FM transmitters (a ``tone_hz``
tone at ``deviation_hz`` deviation, amplitude ``carrier_amplitude``), each
at its own shift from the range's center on a ``raster_hz`` raster within
+-``max_shift_hz``, at least ``min_spacing_hz`` apart and ``min_shift_hz``
off the center. Each keys on and off by a timeline: on for ``on_s`` seconds
(a range), off for ``off_s``, nothing before ``lead_s`` (the noise
learning) or after ``capture_s - tail_s``; a transmitter keys on only
while fewer than ``max_busy`` others are on or within ``hold_s`` after
their key-off, so that a recorder pool of that size always has a slot.

The timelines are drawn once from ``schedule_seed``, so every seed gives the
same set of on-intervals and the same work; ``--seed`` draws the noise, the
shifts, which transmitter takes which timeline and the tone phases. Made on
the device in a few large calls, then copied to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

SEED_MOD = 1 << 62
STEP_S = 0.01  # the occupancy grid of the schedule


@dataclass
class Transmitter:
    shift_hz: int
    intervals: List[Tuple[float, float]]  # (on, off) seconds into the capture


def timelines(t: dict) -> List[List[Tuple[float, float]]]:
    """The on-intervals of each timeline, the same for every seed: stepping
    through the capture, a transmitter whose off time has passed keys on
    while fewer than ``max_busy`` others are on or within ``hold_s`` of
    their key-off."""
    rng = np.random.default_rng(t["schedule_seed"])
    n, end = t["transmitters"], t["capture_s"] - t["tail_s"]
    kept: List[List[Tuple[float, float]]] = [[] for _ in range(n)]
    free_at = [t["lead_s"] + rng.uniform(0.0, t["off_s"][1]) for _ in range(n)]
    hold_end = [-1.0] * n
    for step in range(int(round(t["lead_s"] / STEP_S)), int(end / STEP_S)):
        at = step * STEP_S
        for i in rng.permutation(n):
            others = sum(1 for j in range(n) if j != i and hold_end[j] > at)
            if free_at[i] > at or others >= t["max_busy"]:
                continue
            off = min(at + rng.uniform(*t["on_s"]), end)
            if off - at < t["on_s"][0]:
                continue
            kept[i].append((round(at, 2), round(off, 2)))
            free_at[i] = off + rng.uniform(*t["off_s"])
            hold_end[i] = off + t["hold_s"]
    return kept


def shifts(t: dict, rng: np.random.Generator) -> List[int]:
    n = t["transmitters"]
    if n == 0:
        return []
    raster = np.arange(-t["max_shift_hz"], t["max_shift_hz"] + 1, t["raster_hz"])
    raster = raster[np.abs(raster) >= t["min_shift_hz"]]
    while True:
        pick = np.sort(rng.choice(raster, n, replace=False))
        if n < 2 or np.diff(pick).min() >= t["min_spacing_hz"]:
            return [int(x) for x in pick]


class SessionCapture:
    """``iq`` [n, 2] int8 (host), n a whole number of ``block`` samples;
    ``transmitters`` with their shifts and on-intervals."""

    def __init__(self, traffic: dict, config: dict, seed: int, device, block: int):
        self.t, self.rate, self.block = traffic, int(config["sample_rate"]), int(block)
        self.seed = int(seed) % SEED_MOD
        rng = np.random.default_rng([self.seed, 3])
        lines = timelines(traffic)
        order = rng.permutation(len(lines))
        self.transmitters = [Transmitter(s, lines[j]) for s, j in zip(shifts(traffic, rng), order)]
        phases = rng.uniform(0.0, 2.0 * math.pi, size=len(self.transmitters))
        self.blocks = int(math.ceil(traffic["capture_s"] * self.rate / self.block))
        n = self.blocks * self.block
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed % (1 << 63))
        x = torch.randn((n, 2), generator=gen, device=dev).mul_(traffic["noise_rms"] * 127.0)
        a = traffic["carrier_amplitude"] * 127.0
        for tx, phi in zip(self.transmitters, phases):
            for on, off in tx.intervals:
                s0, s1 = int(round(on * self.rate)), int(round(off * self.rate))
                x[s0:s1] += self._fm(tx.shift_hz, s0, s1 - s0, float(phi), dev).mul_(a)
        self.iq = x.round_().clamp_(-128, 127).to(torch.int8).cpu().numpy()
        del x

    def _fm(self, shift: int, start: int, n: int, phi: float, dev) -> torch.Tensor:
        """[n, 2] float32 unit FM at ``shift`` Hz from sample ``start``; the
        carrier's phase from int64 sample arithmetic, exact at any length."""
        t = self.t
        idx = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        carrier = (idx * shift) % self.rate
        audio = (idx * int(t["tone_hz"])) % self.rate
        phase = (2.0 * math.pi * carrier.to(torch.float64) / self.rate + phi
                 + t["deviation_hz"] / t["tone_hz"] * (1.0 - torch.cos(2.0 * math.pi * audio.to(torch.float64) / self.rate)))
        return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1).to(torch.float32)

    def block_iq(self, k: int) -> np.ndarray:
        """Stream block k (the capture looped): [block, 2] int8, a view."""
        j = k % self.blocks
        return self.iq[j * self.block: (j + 1) * self.block]

    def on_intervals(self, shift: int, t0: float, t1: float) -> List[Tuple[float, float]]:
        """The stream-time on-intervals of the transmitter at ``shift`` that
        meet [t0, t1], across the capture's loops."""
        length = self.blocks * self.block / self.rate
        tx = next(x for x in self.transmitters if x.shift_hz == shift)
        out = []
        for loop in range(max(0, int(t0 // length) - 1), int(t1 // length) + 1):
            for on, off in tx.intervals:
                a, b = loop * length + on, loop * length + off
                if b >= t0 and a <= t1:
                    out.append((a, b))
        return out
