"""``rtl_sdr_scanner_tpu_torch/graph.py`` on the CPU: the static-buffer and
donation layer every graphed step runs through (on the CPU the eager step
runs in place of the replay; ``tests/test_torch_on_card.py`` holds the
captured graphs against eager on the card).

- the layer itself, on a small step: the state advances once a call and is
  the donated buffers, outputs and inputs are never aliased, a Python
  number is no new signature and a new dtype is one;
- the banded fused step graphed against the same step eager (bit-equal, 6
  blocks, a slot start and a spectrogram reset inside) and against the JAX
  package's ``make_banded_fused_step`` (``tests/test_torch_fused_step.py``'s
  scene and bars: index fields exact, values within 1e-3 dB, recordings
  within 1 LSB);
- the session, whose scan and DDC steps are graphed: pipelined ingest
  across hops with slot starts, a ``power_bf16`` session that hops, and
  the noise snapshots written after hops, each against the JAX package's
  payloads or files (``torch_checks.compare_payloads``' bars).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.models import ddc_pipeline as jdp
from rtl_sdr_scanner_tpu.models import fused_step as jfs
from rtl_sdr_scanner_tpu.models import scan_pipeline as jsp
from rtl_sdr_scanner_tpu_torch import drivers
from rtl_sdr_scanner_tpu_torch.graph import GraphedStep, donated_step
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
from rtl_sdr_scanner_tpu_torch.ops.ddc import reset_slot2
from tests.test_torch_fused_step import GEOMETRIES, LEVEL, NB, TOP_K, _compare, _configs, _now, _scene
from tests.test_torch_runtime import CENTER, _fm, _noise, _raw, _scan, _write
from torch_checks import compare_payloads

torch.set_num_threads(2)
BLOCKS = 6


class Toy(NamedTuple):
    acc: torch.Tensor
    count: torch.Tensor


def _toy(state, x, keep):
    """A step in the shape of the port's: (state, x, keep) -> (state, out)."""
    acc = state.acc * keep + x
    return Toy(acc, state.count + 1), acc * 2.0


def _toy_state():
    return Toy(torch.zeros(4), torch.zeros((), dtype=torch.int32))


def test_state_advances_once_a_call_and_is_the_donated_buffers():
    step = donated_step(_toy, donate=(0,))
    first = _toy_state()
    state, out = step(first, torch.ones(4), 1.0)
    assert state.count.item() == 1 and out.tolist() == [2.0] * 4
    # the caller's state is copied in, never aliased or advanced
    assert first.count.item() == 0 and first.acc.tolist() == [0.0] * 4
    buffers = state
    for n in range(2, 5):
        state, out = step(state, torch.ones(4), 1.0)
        assert state.count.item() == n and state.acc.tolist() == [float(n)] * 4
        assert state.acc is buffers.acc and state.count is buffers.count
    # other tensors passed as the state are copied into the buffers
    state, _ = step(Toy(torch.full((4,), 10.0), torch.tensor(7, dtype=torch.int32)), torch.ones(4), 1.0)
    assert state.acc is buffers.acc and state.acc.tolist() == [11.0] * 4 and state.count.item() == 8
    assert step.captures == 1


def test_outputs_are_fresh_and_inputs_are_never_aliased():
    step = donated_step(_toy, donate=(0,))
    x = torch.ones(4)
    state, out0 = step(_toy_state(), x, 1.0)
    x.fill_(5.0)  # the caller changes its input after the call
    assert out0.tolist() == [2.0] * 4 and state.acc.tolist() == [1.0] * 4
    state, out1 = step(state, x, 1.0)
    assert out1.tolist() == [12.0] * 4 and out0.tolist() == [2.0] * 4
    state, out2 = step(state, torch.zeros(4), 1.0)
    assert out2.tolist() == [12.0] * 4 and out1 is not out2 and out1.tolist() == [12.0] * 4


def test_output_that_is_the_state_is_taken_before_the_state_moves():
    """An output that reads the state (here the old state itself) is copied
    before the new state is written into the buffers."""
    step = donated_step(lambda state, x: (Toy(state.acc + x, state.count + 1), state.acc), donate=(0,))
    state, old = step(_toy_state(), torch.ones(4))
    state, old = step(state, torch.ones(4))
    assert old.tolist() == [1.0] * 4 and state.acc.tolist() == [2.0] * 4


def test_a_number_is_no_new_signature_and_a_dtype_is_one():
    step = donated_step(_toy, donate=(0,))
    state, _ = step(_toy_state(), torch.ones(4), 1.0)
    state, out = step(state, torch.ones(4), 0.0)  # the accumulator reset, as spectro_keep 0.0
    assert out.tolist() == [2.0] * 4 and step.captures == 1
    # a new input dtype is a new signature: captured again, never cast
    with pytest.raises(TypeError, match="new state 0"):
        step(state, torch.ones(4, dtype=torch.float64), 1.0)  # f32 state + f64 input is an f64 state
    step_bf16 = donated_step(lambda s, x, keep: (Toy(s.acc * keep + x.float(), s.count + 1), x * 2), donate=(0,))
    s, _ = step_bf16(_toy_state(), torch.ones(4), 1.0)
    s, out = step_bf16(s, torch.ones(4, dtype=torch.bfloat16), 1.0)
    assert out.dtype == torch.bfloat16 and step_bf16.captures == 2
    assert [c["signature"] for c in step_bf16.capture_log] == [
        "torch.float32[4], torch.int32[], torch.float32[4], float",
        "torch.float32[4], torch.int32[], torch.bfloat16[4], float",
    ]
    assert s.count.item() == 2  # the state moved on through both signatures


def test_refusals():
    with pytest.raises(ValueError, match="increasing"):
        donated_step(_toy, donate=(1, 0))
    with pytest.raises(TypeError, match="holds a number"):
        donated_step(lambda a, b: (a, b), donate=(0,))(1.0, torch.ones(1))
    with pytest.raises(TypeError, match="cannot take"):
        donated_step(_toy, donate=(0,))(_toy_state(), torch.ones(4), "1")
    with pytest.raises(TypeError, match="want"):
        donated_step(lambda s, x: x, donate=(0,))(_toy_state(), torch.ones(4))


@pytest.mark.parametrize("b", [0, 1, 7, 1000])
@pytest.mark.parametrize("rate,frames", [(20_480_000, 45), (2_400_000, 75), (256_000, 10)])
def test_frame_times_on_the_device_equal_the_host_formula(rate, frames, b):
    """``drivers.frame_times`` (made on the device, no copy) equals the
    numpy formula the runtime session and the tests use."""
    cfg = tsp.ScanConfig.create(rate, frames)
    want = ((b * frames + 1 + np.arange(frames)) * cfg.frame_interval_ms).astype(np.int32)
    np.testing.assert_array_equal(drivers.frame_times(cfg, b, torch.device("cpu")).numpy(), want)


def _fused_runs(rate, bw, frames, bf16, blocks=BLOCKS):
    """The banded fused step over ``blocks`` blocks of the fused-step test's
    scene, eager and graphed (``drivers.BandedBlocks`` on the CPU), slot 1
    of band 1 restarted at block 3 on a new shift and the spectrogram
    accumulator reset at block 4. Returns {form: [(packed, recording,
    spectro_acc)]} and the graphed step."""
    _, tcfg, _, tddc, group_size = _configs(rate, bw, frames, bf16)
    iq, tones, keys, shifts, _ = _scene(rate, tcfg, seed=rate // 1000)
    valid = np.zeros(tcfg.fft_size, dtype=bool)
    valid[tones] = True
    runs = {}
    for form in ("eager", "graphed"):
        blk = drivers.BandedBlocks(tcfg, tddc, group_size, TOP_K, NB, shifts, "cpu")
        blk.shared[:2] = [torch.from_numpy(keys), torch.from_numpy(valid)]
        step = blk.step if form == "graphed" else blk.step.fn
        out = []
        for b in range(blocks):
            if b == 3:
                moved = shifts.copy()
                moved[1, 1] += 2500
                blk.tables = tdp.make_tables(tddc, moved, device="cpu")
                state = blk.state[2]
                blk.state[2] = reset_slot2(state, 1, 1) if tddc.modtap else tdp.reset_slot(state, 1 * 2 + 1)
            keep = torch.tensor(0.0 if b == 4 else 1.0)
            *blk.state, outs = step(*blk.state, torch.from_numpy(iq[b % len(iq)]), blk.now(b), *blk.shared[:3], keep,
                                    blk.tables)
            out.append((outs.packed.clone(), outs.recording.clone(), blk.state[1].clone()))
        runs[form] = out
        if form == "graphed":
            graphed = blk.step
    return runs, graphed


@pytest.mark.parametrize("rate,bw,frames,bf16", [GEOMETRIES[0], GEOMETRIES[2]], ids=["modtap", "v1"])
def test_graphed_fused_step_is_bit_equal_to_eager(rate, bw, frames, bf16):
    runs, graphed = _fused_runs(rate, bw, frames, bf16)
    assert isinstance(graphed, GraphedStep) and graphed.captures == 1
    for b, (want, got) in enumerate(zip(runs["eager"], runs["graphed"])):
        for w, g in zip(want, got):
            assert torch.equal(w, g), f"block {b}"
    assert runs["graphed"][-1][1].abs().max() > 10  # the scene recorded


@pytest.mark.parametrize("rate,bw,frames,bf16", [GEOMETRIES[0], GEOMETRIES[2]], ids=["modtap", "v1"])
def test_graphed_fused_step_matches_jax(rate, bw, frames, bf16):
    """The graphed step against the JAX package's make_banded_fused_step
    over the fused-step test's scene, to that test's bars."""
    jcfg, tcfg, jddc, tddc, group_size = _configs(rate, bw, frames, bf16)
    iq, tones, keys, shifts, _ = _scene(rate, jcfg, seed=rate // 1000)
    valid = np.zeros(jcfg.fft_size, dtype=bool)
    valid[tones] = True
    stack = lambda a: jnp.stack([a] * NB)
    jstep = jfs.make_banded_fused_step(jcfg, jddc, group_size, TOP_K)
    jstate = jax.tree.map(stack, jsp.init_scan_state(jcfg, 0))
    jacc = stack(jsp.init_spectro_acc(jcfg))
    jdstate = jdp.fold_banded(jax.tree.map(stack, jdp.init_state(jddc)))
    jtab = jdp.fold_banded(jax.tree.map(lambda *a: jnp.stack(a), *[jdp.make_tables(jddc, s) for s in shifts]))
    shared = [keys, valid, LEVEL, np.float32(1.0)]

    blk = drivers.BandedBlocks(tcfg, tddc, group_size, TOP_K, NB, shifts, "cpu")
    for b, block in enumerate(iq):
        now = _now(jcfg, b)
        jstate, jacc, jdstate, jout = jstep(
            jstate, jacc, jdstate, jnp.asarray(block), jnp.asarray(now), *map(jnp.asarray, shared), jtab
        )
        *blk.state, tout = blk.step(*blk.state, torch.from_numpy(block), torch.from_numpy(now),
                                    *map(torch.from_numpy, map(np.asarray, shared)), blk.tables)
        _compare(jout, tout, jacc, blk.state[1], (b + 1) * jcfg.frames_per_block, jcfg.frames_per_block, len(keys))
    assert blk.step.captures == 1


def _hop_raw(capture, **tunables):
    """Two ranges the scanner hops between, 5 frames a block (the runtime
    test's round-robin scene)."""
    ranges = [(CENTER - 100000, CENTER + 100000), (CENTER + 100000, CENTER + 300000)]
    return _raw(capture, ranges=ranges, tunables={"frames_per_block": 5, **tunables}, min_time_ms=500)


@pytest.fixture(scope="module")
def hop_capture(tmp_path_factory):
    """FM at +30 kHz keyed 2.5-5 s over noise, 7 s: slot starts at the
    first range's center, hops around them."""
    path = tmp_path_factory.mktemp("graph") / "hop.cf32"
    t, iq = _noise(7.0, 3)
    _write(path, iq + _fm(t, 30_000, 700, 2.5, 5.0), "cf32")
    return path


def _graphed_session(scanner):
    device = scanner.device
    assert isinstance(device._scan_step, GraphedStep) and isinstance(device._ddc_step, GraphedStep)
    return device._scan_step.captures, device._ddc_step.captures


def _hops_and_payloads(raw, recorders=2):
    out = {pkg: _scan(pkg, raw, recorders=recorders, spy_hops=True) for pkg in ("jax", "torch")}
    assert out["torch"][2] == out["jax"][2]
    stats = compare_payloads(out["jax"][0], out["torch"][0])
    return stats, out["torch"][1], out["torch"][2]


def test_pipelined_session_across_hops_and_slot_starts_matches_jax(hop_capture):
    """Pipelined ingest (block b+1 dispatched before block b is read) through
    the graphed steps, with hops and slot starts: the JAX package's payloads."""
    raw = _hop_raw(hop_capture, pipelined_ingest=True, compact_detection=True, range_scanning_time_ms=1000)
    stats, scanner, hops = _hops_and_payloads(raw)
    assert len(hops) >= 4 and stats["transmissions"] > 0
    assert _graphed_session(scanner) == (1, 1)  # one signature each, across hops and slot starts


def test_power_bf16_session_that_hops_matches_jax(hop_capture):
    """power_bf16 keeps a bf16 averager ring across hops (the reference
    resets to an f32 one; the values are the same), so the scan step keeps
    one signature; the payloads equal the JAX package's."""
    tunables = dict(compact_detection=True, detection_bf16=True, power_bf16=True)
    stats, scanner, hops = _hops_and_payloads(_hop_raw(hop_capture, **tunables))
    assert len(hops) >= 4 and stats["transmissions"] > 0
    assert scanner.device.scan_cfg.power_bf16
    assert scanner.device._scan_state.averager.ring.dtype == torch.bfloat16
    assert _graphed_session(scanner) == (1, 1)


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_noise_snapshots_after_hops_match_jax(hop_capture, tmp_path, compact):
    """Each center's floor is a snapshot taken when the session leaves it
    (the live state is the step's buffers, which the next center's state
    overwrites): after the hops, the files equal the JAX package's."""
    files = {}
    for pkg in ("jax", "torch"):
        base = tmp_path / pkg / "noise"
        base.parent.mkdir()
        raw = _hop_raw(hop_capture, noise_state_path=str(base), compact_detection=compact)
        _, scanner, hops = _scan(pkg, raw, stop=True, spy_hops=True)
        assert len(hops) >= 3
        files[pkg] = tmp_path / pkg / "noise.replay_replay0.npz"
    with np.load(files["jax"]) as a, np.load(files["torch"]) as b:
        assert a.files == b.files and len(b.files) == 2
        for name in a.files:
            np.testing.assert_allclose(b[name], a[name], atol=1e-3)  # FFT rounding
    # the snapshot of a center is a copy: the live buffers moved on since
    device = scanner.device
    for center, noise in device._noise_states.items():
        if center == device._pending_noise_center:
            continue
        assert noise.threshold.data_ptr() != device._scan_state.noise.threshold.data_ptr()

