"""Generator of the wideband step's traffic: a ring of int8 cs8 blocks of
one wideband stream (the whole front end: ``bands`` channels of the
configuration's channel rate), made on the device from the seed. Noise at
``noise_rms`` over the whole band, and one FM carrier (a ``tone_hz`` tone
at ``deviation_hz`` deviation, amplitude ``carrier_amplitude``) for each
entry of ``carrier_offsets_hz``, at that offset from the centre of a
channel drawn from the seed, each carrier in a channel of its own. A
carrier whose offset lies outside the bank's pass band (beyond 0.4 of the
channel spacing, in the transition band that two adjacent channels share)
is kept out of channel ``bands / 2``, which straddles the stream's Nyquist
edge. The carriers key on from the first block after the noise learning:
the learning blocks read the ring's noise alone, and the carriers are added
to the ring once they have run. Slot k of every channel is tuned to
``slot_shifts_hz[k]``.

Parameters come from the traffic file (``benchmark/traffic/<name>.json``);
the geometry from the configuration: ``geo`` is a channel's, and the
stream's rate and block are ``bands`` times a channel's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.channelizer import CUTOFF, TRANSITION, channel_offsets_hz
from benchmark.reference.scan import Geometry

SEED_MOD = 1 << 62


class WideRing:
    def __init__(self, traffic: dict, geo: Geometry, seed: int, device):
        self.t, self.geo, self.device = traffic, geo, torch.device(device)
        self.seed = int(seed) % SEED_MOD
        self.bands = traffic["bands"]
        self.rate = geo.rate * self.bands
        self.block_samples = geo.block_samples * self.bands
        rng = np.random.default_rng([self.seed, 1])
        centres = channel_offsets_hz(self.bands, self.rate)
        pass_edge = (CUTOFF - TRANSITION / 2) * geo.rate
        self.carrier_bands, self.carrier_hz = [], []
        for offset in traffic["carrier_offsets_hz"]:
            free = [b for b in range(self.bands) if b not in self.carrier_bands
                    and not (abs(offset) > pass_edge and b == self.bands // 2)]
            band = int(rng.choice(free))
            self.carrier_bands.append(band)
            self.carrier_hz.append(int(centres[band]) + int(offset))
        self.carrier_phase = [float(p) for p in rng.uniform(0.0, 2.0 * math.pi, len(self.carrier_hz))]
        self.learning = geo.learning_blocks()
        self.ring = [self.noise(i) for i in range(traffic["ring_blocks"])]
        self.keyed = False

    @property
    def shifts(self) -> np.ndarray:
        """[bands, slots] int64 slot shifts in Hz."""
        return np.tile(np.asarray(self.t["slot_shifts_hz"], dtype=np.int64), (self.bands, 1))

    def noise(self, i: int) -> torch.Tensor:
        """Ring block i's noise [block_samples, 2] int8 (one draw)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 64 + i) % (1 << 63))
        x = torch.randn((self.block_samples, 2), generator=gen, device=self.device)
        x.mul_(self.t["noise_rms"] * 127.0).round_().clamp_(-128, 127)
        return x.to(torch.int8)

    def carriers(self, i: int) -> torch.Tensor:
        """[block_samples, 2] float32 sum of the FM carriers over ring block
        i, in cs8 units. The carrier's own phase is taken from the integer
        product f * n mod rate, exact at any stream index."""
        n = self.block_samples
        idx = torch.arange(n, dtype=torch.int64, device=self.device) + i * n
        t = idx.to(torch.float64) / self.rate
        fm = self.t["deviation_hz"] / self.t["tone_hz"] * (1.0 - torch.cos(2.0 * math.pi * self.t["tone_hz"] * t))
        del t
        out = torch.zeros((n, 2), dtype=torch.float32, device=self.device)
        a = self.t["carrier_amplitude"] * 127.0
        for f, phi in zip(self.carrier_hz, self.carrier_phase):
            cycles = torch.remainder(idx * (f % self.rate), self.rate).to(torch.float64)
            phase = cycles * (2.0 * math.pi / self.rate) + (phi + fm)
            out[:, 0] += (torch.cos(phase) * a).to(torch.float32)
            out[:, 1] += (torch.sin(phase) * a).to(torch.float32)
            del cycles, phase
        return out

    def key_on(self) -> None:
        """Add the carriers to the ring, in place (after the learning blocks)."""
        for i, block in enumerate(self.ring):
            block.copy_((block.to(torch.float32) + self.carriers(i)).round_().clamp_(-128, 127).to(torch.int8))
        self.keyed = True

    def block(self, b: int) -> torch.Tensor:
        """The program's input at block b (the ring as it stands)."""
        if (b < self.learning) == self.keyed:
            raise RuntimeError(f"block {b} asked with the carriers {'on' if self.keyed else 'off'}")
        return self.ring[b % len(self.ring)]

    def reference_block(self, b: int) -> torch.Tensor:
        """What the program read at block b, once the carriers are on."""
        return self.noise(b % len(self.ring)) if b < self.learning else self.ring[b % len(self.ring)]
