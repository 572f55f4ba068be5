"""Generator of a band that holds many carriers at once: a ring of int8 cs8
blocks made on the device from the seed, noise at ``noise_rms`` in every
band (``step_ring``'s draw) and an FM carrier (a ``tone_hz`` tone at
``deviation_hz`` deviation, amplitude ``carrier_amplitude``, each at a
phase drawn from the seed) at each of ``carrier_offsets_hz`` from every
band's center. The carriers key on from the first block after the noise
learning, as ``step_ring``'s do. Slot k of every band is tuned to
``slot_shifts_hz[k]``.

A carrier's phase is 2 pi ((offset * n) mod rate) / rate at stream sample n,
in int64 before the float64 angle, so an offset of hundreds of MHz lands
where the traffic file puts it at any point of the stream; the carriers are
summed a slice of ``SLICE`` samples at a time, so a long block needs no
more than a few of its own size in float32 besides.

Parameters come from the traffic file (``benchmark/traffic/<name>.json``);
the geometry from the configuration. ``StepRing`` is the name the step
driver (``drivers/step.py``) asks the generator for.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.scan import Geometry
from benchmark.traffic import step_ring

SLICE = 1 << 24


class StepRing(step_ring.StepRing):
    def __init__(self, traffic: dict, geo: Geometry, seed: int, device):
        self.t, self.geo, self.device = traffic, geo, torch.device(device)
        self.seed = int(seed) % step_ring.SEED_MOD
        self.bands = traffic["bands"]
        self.carrier_hz = [int(f) for f in traffic["carrier_offsets_hz"]]
        if any(2 * abs(f) >= geo.rate for f in self.carrier_hz):
            raise ValueError(f"carrier offsets {self.carrier_hz} do not all lie inside a {geo.rate} sps band")
        rng = np.random.default_rng([self.seed, 1])
        self.carrier_phases = [float(p) for p in rng.uniform(0.0, 2.0 * math.pi, len(self.carrier_hz))]
        self.carrier_bands = list(range(self.bands))  # every band holds every carrier
        self.learning = geo.learning_blocks()
        self.ring = [self.noise(i) for i in range(traffic["ring_blocks"])]
        self.keyed = False

    def carrier(self, i: int) -> torch.Tensor:
        """[block_samples, 2] float32: the sum of the FM carriers over ring
        block i, in cs8 units."""
        n, rate = self.geo.block_samples, self.geo.rate
        out = torch.empty((n, 2), dtype=torch.float32, device=self.device)
        tone = 2.0 * math.pi * self.t["tone_hz"]
        a = self.t["carrier_amplitude"] * 127.0
        for lo in range(0, n, SLICE):
            idx = torch.arange(lo, min(lo + SLICE, n), dtype=torch.int64, device=self.device) + i * n
            fm = self.t["deviation_hz"] / self.t["tone_hz"] * (1.0 - torch.cos(tone * (idx.to(torch.float64) / rate)))
            re = torch.zeros(idx.shape, dtype=torch.float64, device=self.device)
            im = torch.zeros_like(re)
            for f, phi in zip(self.carrier_hz, self.carrier_phases):
                phase = torch.remainder(idx * f, rate).to(torch.float64) * (2.0 * math.pi / rate) + phi + fm
                re += torch.cos(phase)
                im += torch.sin(phase)
            out[lo: lo + idx.numel(), 0] = (re * a).to(torch.float32)
            out[lo: lo + idx.numel(), 1] = (im * a).to(torch.float32)
        return out
