"""The port's production channelizer bank (``ops/channelizer.channelize_block_pairs``,
the DDC's modulated-taps stage 1 over the raw stream) against the
benchmark's plain float64 bank (``benchmark/reference/channelizer.py``), on
seeded samples streamed in two consecutive blocks, so that the tail the
port carries from one block to the next is part of what is compared.

Tolerance: ``CHAN_TOL`` = 2e-5 absolute, in the channels' own units (input
at 1/127.5 of cs8), on channels whose samples reach about 1. The port sums
144 products a channel sample in float32 with TF32 off (the bank's
``bmm``, an order other than the reference's), so its rounding is a few
float32 ulps of the largest terms, 2e-7 to 3e-7 here: the port's own
tests hold its two forms to the same 2e-5 (``tests/test_torch_channelizer.py``).
A bank that lost its carried tail is off by the whole contribution of the
missing history, 1e-2 or more on the block's first samples.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import channelizer as ref
from rtl_sdr_scanner_tpu_torch.ops import channelizer as tch

torch.set_num_threads(2)

CHAN_TOL = 2e-5
BLOCK = 512  # channel samples a block


def _blocks(b: int, dtype: str, seed: int):
    """Two consecutive wideband blocks of [b * BLOCK, 2] samples: int8 cs8,
    or float32 pairs in the channels' units."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return [torch.from_numpy(rng.integers(-100, 101, size=(b * BLOCK, 2), dtype=np.int8)) for _ in range(2)]
    return [torch.from_numpy(rng.uniform(-0.8, 0.8, size=(b * BLOCK, 2)).astype(np.float32)) for _ in range(2)]


def _cs8_units(x: torch.Tensor) -> torch.Tensor:
    """The reference's input: int8 as it is, float pairs times 127.5."""
    return x if x.dtype == torch.int8 else x.to(torch.float64) * ref.CS8


def _port(b: int, blocks, carry: bool = True):
    plan = tch.plan_channelizer(b)
    state = tch.init_channelizer_state(plan, "cpu")
    outs = []
    for x in blocks:
        if not carry:
            state = tch.init_channelizer_state(plan, "cpu")
        state, y = tch.channelize_block_pairs(plan, state, x)
        outs.append(y.to(torch.float64))
    return outs


def _reference(b: int, blocks):
    outs, before = [], None
    for x in blocks:
        outs.append(ref.channelize(_cs8_units(x), before, b) / ref.CS8)
        before = _cs8_units(x)
    return outs


def test_plan_sizes_agree():
    plan = tch.plan_channelizer(8)
    assert (ref.taps_per_branch(8), ref.history_len(8)) == (plan.taps_per_branch, plan.tail_len) == (18, 136)
    np.testing.assert_array_equal(ref.channel_offsets_hz(8, 163840000), tch.channel_center_offsets(plan, 163840000))


@pytest.mark.parametrize("b", [4, 8, 16])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_port_bank_matches_reference(b, dtype):
    blocks = _blocks(b, dtype, seed=20 + b)
    got, want = _port(b, blocks), _reference(b, blocks)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (b, BLOCK, 2)
        assert w.abs().max() > 0.3  # channels of about unit size: the tolerance is absolute
        assert (g - w).abs().max().item() <= CHAN_TOL


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_tail_left_at_zero_fails(dtype):
    """A bank that starts each block from a zero tail agrees on the first
    block and fails the comparison on the second."""
    blocks = _blocks(8, dtype, seed=7)
    got, want = _port(8, blocks, carry=False), _reference(8, blocks)
    assert (got[0] - want[0]).abs().max().item() <= CHAN_TOL
    gap = (got[1] - want[1]).abs()
    assert gap.max().item() > 1e3 * CHAN_TOL
    # only the samples the history reaches: the first taps_per_branch - 1 of each channel
    assert gap[:, ref.taps_per_branch(8) - 1:].max().item() <= CHAN_TOL


@pytest.mark.parametrize("channel", [0, 3, 4, 5, 7])
def test_reference_tone_lands_in_its_channel(channel):
    """A tone at +channel R/B + df (the wrapped centre) comes out of that
    channel alone, at df and unit gain: the reference's order and sign."""
    b, rate, m = 8, 8 * 640, 4096
    df = 40  # Hz, inside the pass band (0.4 of the 640 Hz spacing)
    f = int(ref.channel_offsets_hz(b, rate)[channel]) + df
    n = torch.arange(b * m, dtype=torch.float64)
    tone = torch.exp(2j * np.pi * f * n / rate)
    x = torch.stack([tone.real, tone.imag], dim=-1) * 0.5 * ref.CS8
    y = ref.channelize(x, None, b) / ref.CS8
    z = torch.complex(y[..., 0], y[..., 1])[:, 200:]  # past the bank's start from rest
    power = (z.abs() ** 2).mean(dim=1)
    assert int(torch.argmax(power)) == channel
    assert torch.allclose(z[channel].abs(), torch.full_like(z[channel].abs(), 0.5), atol=1e-3)
    others = torch.cat([power[:channel], power[channel + 1:]])
    assert others.max() < 1e-6 * power[channel]
    k = torch.arange(200, m, dtype=torch.float64)
    want = torch.exp(2j * np.pi * df * k * b / rate)
    rot = z[channel] / want  # a constant phase where the channel is the tone at df
    assert (rot - rot[0]).abs().max() < 1e-3
