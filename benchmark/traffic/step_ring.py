"""Generator of the block steps' traffic: a ring of int8 cs8 blocks made on
the device from the seed, noise at ``noise_rms`` in every band and an FM
carrier (a ``tone_hz`` tone at ``deviation_hz`` deviation, amplitude
``carrier_amplitude``, at ``carrier_offset_hz`` from the band's center) in
``carrier_bands`` bands drawn from the seed. The carriers key on from the
first block after the noise learning: the learning blocks read the ring's
noise alone, and the carriers are added to the ring once they have run.
Slot k of every band is tuned to ``slot_shifts_hz[k]``.

Parameters come from the traffic file (``benchmark/traffic/<name>.json``);
the geometry from the configuration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.scan import Geometry

SEED_MOD = 1 << 62


class StepRing:
    def __init__(self, traffic: dict, geo: Geometry, seed: int, device):
        self.t, self.geo, self.device = traffic, geo, torch.device(device)
        self.seed = int(seed) % SEED_MOD
        self.bands = traffic["bands"]
        rng = np.random.default_rng([self.seed, 1])
        self.carrier_bands = sorted(int(b) for b in rng.choice(self.bands, traffic["carrier_bands"], replace=False))
        self.carrier_phase = float(rng.uniform(0.0, 2.0 * math.pi))
        self.learning = geo.learning_blocks()
        self.ring = [self.noise(i) for i in range(traffic["ring_blocks"])]
        self.keyed = False

    @property
    def shifts(self) -> np.ndarray:
        """[bands, slots] int64 slot shifts in Hz."""
        return np.tile(np.asarray(self.t["slot_shifts_hz"], dtype=np.int64), (self.bands, 1))

    def noise(self, i: int) -> torch.Tensor:
        """Ring block i's noise [bands, F, fft*decim, 2] int8 (one draw)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 64 + i) % (1 << 63))
        g = self.geo
        x = torch.randn((self.bands, g.frames, g.fft * g.decim, 2), generator=gen, device=self.device)
        x.mul_(self.t["noise_rms"] * 127.0).round_().clamp_(-128, 127)
        return x.to(torch.int8)

    def carrier(self, i: int) -> torch.Tensor:
        """[block_samples, 2] float32 FM carrier of ring block i, in cs8 units."""
        n = self.geo.block_samples
        t = (torch.arange(n, dtype=torch.float64, device=self.device) + i * n) / self.geo.rate
        tone = 2.0 * math.pi * self.t["tone_hz"]
        phase = (2.0 * math.pi * self.t["carrier_offset_hz"] * t + self.carrier_phase
                 + self.t["deviation_hz"] / self.t["tone_hz"] * (1.0 - torch.cos(tone * t)))
        a = self.t["carrier_amplitude"] * 127.0
        return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1).mul_(a).to(torch.float32)

    def key_on(self) -> None:
        """Add the carriers to the ring, in place (after the learning blocks)."""
        for i, block in enumerate(self.ring):
            c = self.carrier(i)
            flat = block.view(self.bands, -1, 2)
            for band in self.carrier_bands:
                flat[band] = (flat[band].to(torch.float32) + c).round_().clamp_(-128, 127).to(torch.int8)
        self.keyed = True

    def block(self, b: int) -> torch.Tensor:
        """The program's input at block b (the ring as it stands)."""
        if (b < self.learning) == self.keyed:
            raise RuntimeError(f"block {b} asked with the carriers {'on' if self.keyed else 'off'}")
        return self.ring[b % len(self.ring)]

    def reference_block(self, b: int) -> torch.Tensor:
        """What the program read at block b, once the carriers are on."""
        return self.noise(b % len(self.ring)) if b < self.learning else self.ring[b % len(self.ring)]
