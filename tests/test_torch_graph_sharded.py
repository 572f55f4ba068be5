"""The sharded steps graphed (``graph.sharded_step``: a graph a shard and
segment between the exchanges) against the same programs eager, on meshes
of 2 and 4 copies of the CPU device. On the CPU each segment's body runs
eagerly on its graph's static buffers, so these reach everything but the
capture (``tests/test_torch_on_card.py`` holds the captured graphs).

Each of the eight builders of ``parallel/sharded_scan.py`` runs 4 blocks
graphed and eager from the same state: the returned state passed back
(block 1), a copy of it passed in (block 2: copied into the donated
buffers), a state reset at a retune and a slot reset (block 3), and, where
the step takes one, a keep mask that zeroes a slot's carry before block 2.
Every output and the final state must be bit-equal, and each (shard,
segment) captured once and replayed once a call. Two shards of equal shapes on one device keep
distinct state.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu_torch.graph import GraphedStep, Program, _flatten, sharded_step
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
from rtl_sdr_scanner_tpu_torch.ops import channelizer as tch
from rtl_sdr_scanner_tpu_torch.ops import ddc as tddc
from rtl_sdr_scanner_tpu_torch.parallel import mesh as tmesh
from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as tss

torch.set_num_threads(2)
NB, SUB_RATE, FRAMES, SLOTS, GROUP_SIZE, TOP_K, KEYS = 4, 256_000, 12, 2, 64, 16, 8
TIME_RATE, TIME_FRAMES = 256_000, 84
BLOCKS = 4
CPU = torch.device("cpu")


def _mesh(n_bands, n_time=1):
    return tmesh.make_mesh(n_bands, n_time, devices=["cpu"] * (n_bands * n_time))


def _copy(tree):
    """The tree's tensors copied (a state that is not the donated buffers)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    items = [_copy(v) for v in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _leaves(tree) -> list:
    leaves = []
    _flatten(tree, leaves)
    return leaves


def _against_eager(make, n_state: int, segments: int):
    """``make()`` -> (program, its state as a list, ``args_of(b, state)``:
    block b's other arguments after any change it makes to the state list).
    The program eager and graphed, each from a fresh ``make()``: outputs
    and final states bit-equal, ``segments`` segments captured once each.
    Returns the eager blocks' outputs."""
    runs, results = {}, []
    for form in ("eager", "graphed"):
        program, state, args_of = make()
        step = sharded_step(program, "step") if form == "graphed" else program
        outs = []
        for b in range(BLOCKS):
            args = args_of(b, state)
            result = step(*state, *args)
            result = result if isinstance(result, tuple) else (result,)
            state[:] = result[:n_state]
            outs.append([x.clone() for x in _leaves(result[n_state:])])
            if form == "eager":
                results.append(result[n_state:])
        runs[form] = (outs, [x.clone() for x in _leaves(state)], step)
    (eager, e_state, _), (graphed, g_state, step) = runs["eager"], runs["graphed"]
    for b, (want, got) in enumerate(zip(eager, graphed)):
        assert len(want) == len(got)
        for i, (w, g) in enumerate(zip(want, got)):
            assert w.dtype == g.dtype and torch.equal(w, g), f"block {b}, output leaf {i}"
    assert len(e_state) == len(g_state)
    for i, (w, g) in enumerate(zip(e_state, g_state)):
        assert torch.equal(w, g), f"state leaf {i}"
    assert len(step.segments) == segments and step.captures == segments, step.capture_log
    assert all(s.captures == 1 for s in step.segments.values())
    assert sum(g.replays for g in step.graphs()) == BLOCKS * segments  # each segment once a call
    return results


@pytest.fixture(scope="module")
def bands_scene():
    cfg = dataclasses.replace(tsp.ScanConfig.create(SUB_RATE, frames_per_block=FRAMES), noise_learning_ms=0)
    ddc_cfg = tdp.DdcConfig.create(SUB_RATE, 16000, SLOTS, cfg.block_samples)
    assert ddc_cfg.modtap
    rng = np.random.default_rng(9)
    n = NB * cfg.block_samples
    x = rng.integers(-6, 6, size=(BLOCKS, n, 2), dtype=np.int8)
    t = np.arange(n)
    # a tone in channel 1 of 4 over 1.024 Msps, on from block 1
    tone = 100 * np.exp(2j * np.pi * (SUB_RATE + 20_000) * t / (NB * SUB_RATE))
    x[1:, :, 0] = np.clip(x[1:, :, 0] + np.round(tone.real), -128, 127)
    x[1:, :, 1] = np.clip(x[1:, :, 1] + np.round(tone.imag), -128, 127)
    shifts = rng.integers(-SUB_RATE // 2, SUB_RATE // 2, size=(NB, SLOTS)).astype(np.int64)
    return cfg, ddc_cfg, torch.from_numpy(x), shifts


def _now(cfg, b):
    return torch.from_numpy(((b * cfg.frames_per_block + 1 + np.arange(cfg.frames_per_block))
                             * cfg.frame_interval_ms).astype(np.int32))


def _bands_inputs(scene, mesh):
    cfg, ddc_cfg, x, shifts = scene
    plan = tch.plan_channelizer(NB)
    keys = torch.full((NB, KEYS), -1, dtype=torch.int32)
    keys[1, 0] = 300
    return dict(
        plan=plan,
        chan=tss.replicate(tch.init_channelizer_state(plan, CPU), mesh),
        scan=tss.init_banded_state(cfg, NB, mesh),
        acc=tss.shard_bands(torch.zeros((NB, cfg.spectro_size)), mesh),
        ddc=tss.init_banded_ddc_state(ddc_cfg, NB, mesh),
        tables=tss.shard_bands(tdp.make_tables(ddc_cfg, shifts, device=CPU), mesh),
        keys=tss.shard_bands(keys, mesh),
        valid=tss.shard_bands(torch.ones((NB, cfg.fft_size), dtype=torch.bool), mesh),
        level=tss.replicate(torch.tensor(8.0), mesh),
    )


def _keep_mask(mesh, b):
    """Ones, but slot 1 of band 1 zeroed before block 2."""
    keep = torch.ones((NB, SLOTS))
    if b == 2:
        keep[1, 1] = 0.0
    return tss.shard_bands(keep, mesh)


def _retune(state, mesh, cfg, i):
    """Block 3's reset: shard i's scan state fresh (a retune)."""
    state[i] = tsp.init_scan_state(cfg, NB // mesh.n_band_shards, start_ms=500, device=CPU)


def _restart(ddc_state, i):
    """Block 3's reset: slot 0 of shard i's first band restarted."""
    ddc_state[i] = tddc.reset_slot2(ddc_state[i], 0, 0)


def _channels(scene, mesh, b):
    """Block b's channels of the one-device channelizer, as the compact and
    full-row steps' per-shard [B/n, F, group, 2] f32 frames."""
    cfg, _, x, _ = scene
    plan = tch.plan_channelizer(NB)
    state = tch.init_channelizer_state(plan, CPU)
    for i in range(b + 1):
        state, ch = tch.channelize_block_pairs(plan, state, x[i])
    return [c.reshape(c.shape[0], FRAMES, -1, 2) for c in tss.shard_bands(ch, mesh)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["scan", "compact", "wideband", "fused", "banded_ddc"])
def test_bands_steps_graphed_equal_eager(bands_scene, form, n):
    cfg, ddc_cfg, x, shifts = bands_scene
    mesh = _mesh(n)
    b_loc = NB // n

    def make():
        inp = _bands_inputs(bands_scene, mesh)
        now = lambda b: tss.replicate(_now(cfg, b), mesh)
        per_band_now = lambda b: [t[None].expand(b_loc, FRAMES) for t in now(b)]
        if form == "scan":
            def args_of(b, state):
                if b == 2:
                    state[0] = [_copy(s) for s in state[0]]
                if b == 3:
                    _retune(state[0], mesh, cfg, n - 1)
                return (_channels(bands_scene, mesh, b), per_band_now(b))

            return tss.make_sharded_scan_step(cfg, mesh), [inp["scan"]], args_of
        if form == "compact":
            def args_of(b, state):
                if b == 2:
                    state[:] = [[_copy(s) for s in part] for part in state]
                if b == 3:
                    _retune(state[0], mesh, cfg, 0)
                return (_channels(bands_scene, mesh, b), per_band_now(b), inp["keys"], inp["valid"], inp["level"],
                        0.0 if b == 2 else 1.0)

            step = tss.make_sharded_compact_step(cfg, GROUP_SIZE, TOP_K, mesh)
            return step, [inp["scan"], inp["acc"]], args_of
        if form == "banded_ddc":
            def args_of(b, state):
                if b == 2:
                    state[0] = [_copy(s) for s in state[0]]
                if b == 3:
                    _restart(state[0], n - 1)
                channels = [c.reshape(c.shape[0], -1, 2) for c in _channels(bands_scene, mesh, b)]
                return (channels, inp["tables"], _keep_mask(mesh, b))

            return tss.make_sharded_banded_ddc(ddc_cfg, mesh, NB), [inp["ddc"]], args_of
        plan = inp["plan"]

        def args_of(b, state):
            if b == 2:
                state[:] = [[_copy(s) for s in part] for part in state]
            if b == 3:
                _retune(state[1], mesh, cfg, 0)
                if form == "fused":
                    _restart(state[3], n - 1)
            common = (tss.replicate(x[b], mesh), now(b), inp["keys"], inp["valid"], inp["level"],
                      0.0 if b == 2 else 1.0)
            return common + ((inp["tables"], _keep_mask(mesh, b)) if form == "fused" else ())

        if form == "wideband":
            step = tss.make_sharded_wideband_step(cfg, GROUP_SIZE, TOP_K, mesh, plan, 1, NB)
            return step, [inp["chan"], inp["scan"], inp["acc"]], args_of
        step = tss.make_sharded_wideband_fused_step(cfg, ddc_cfg, GROUP_SIZE, TOP_K, mesh, plan, 1, NB)
        return step, [inp["chan"], inp["scan"], inp["acc"], inp["ddc"]], args_of

    n_state = {"scan": 1, "compact": 2, "wideband": 3, "fused": 4, "banded_ddc": 1}[form]
    outs = _against_eager(make, n_state, n)
    if form in ("compact", "wideband", "fused"):  # the tone's channel detects in block 2
        packed = [o.packed for o in outs[2][0]] if form == "compact" else outs[2][0]
        counts = [tsp.unpack_compact(band.numpy(), FRAMES, TOP_K, KEYS)[3].max() for p in packed for band in p]
        assert max(counts) > 0, "no channel detects"


@pytest.fixture(scope="module")
def time_scene():
    cfg = tsp.ScanConfig.create(TIME_RATE, frames_per_block=TIME_FRAMES)  # 21 frames a shard at n = 4
    ddc_cfg = tdp.DdcConfig.create(TIME_RATE, 16000, 2, cfg.block_samples)
    assert ddc_cfg.modtap
    rng = np.random.default_rng(3)
    n = cfg.block_samples * BLOCKS
    t = np.arange(n) / TIME_RATE
    iq = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq += 0.4 * np.exp(2j * np.pi * (30000 * t + 3000 / 700 * np.sin(2 * np.pi * 700 * t))) * (t >= 2.2)
    pairs = np.clip(np.round(np.stack([iq.real, iq.imag], -1) * 127), -128, 127).astype(np.int8)
    return cfg, ddc_cfg, torch.from_numpy(pairs).reshape(BLOCKS, cfg.block_samples, 2)


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_scan_graphed_equals_eager(time_scene, n):
    cfg, _, x = time_scene
    group = cfg.fft_size * cfg.decimator_factor
    keys = torch.tensor([-1, 100, -1, -1], dtype=torch.int32)

    def make():
        def args_of(b, state):
            if b == 2:
                state[0] = _copy(state[0])
            if b == 3:  # a retune: the floor learns again from the block's start
                state[0] = tsp.init_scan_state(cfg, start_ms=int(_now(cfg, b)[0]), device=CPU)
            return (x[b].reshape(TIME_FRAMES, group, 2), _now(cfg, b), keys,
                    torch.ones(cfg.fft_size, dtype=torch.bool), torch.tensor(8.0))

        step = tss.make_time_sharded_scan(cfg, _mesh(1, n), GROUP_SIZE, TOP_K)
        return step, [tsp.init_scan_state(cfg, device=CPU)], args_of

    outs = _against_eager(make, 1, 3 * n)
    assert not bool(outs[0][-1]) and bool(outs[2][-1]) and not bool(outs[3][-1])  # ready in block 1, relearning
    assert outs[2][0][:, 3 * (TOP_K + 16)].max() > 0, "the scene detects nothing"


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_modtap_ddc_graphed_equals_eager(time_scene, n):
    cfg, ddc_cfg, x = time_scene
    assert tss.time_sharded_modtap_fits(ddc_cfg, n)
    tables = tdp.make_tables(ddc_cfg, np.array([30_000, -52_500]), device=CPU)

    def make():
        def args_of(b, state):
            if b == 2:
                state[0] = _copy(state[0])
            if b == 3:
                state[0] = tdp.reset_slot(state[0], 1)  # a recording start
            return (x[b], tables)

        return tss.make_time_sharded_modtap_ddc(ddc_cfg, _mesh(1, n)), [tdp.init_state(ddc_cfg, device=CPU)], args_of

    outs = _against_eager(make, 1, n * len(ddc_cfg.plans))
    assert outs[-1][0].abs().max() > 10


@pytest.mark.parametrize("n", [1, 2, 4])
def test_time_sharded_modtap_ddc_chunk_loop_graphed_equals_eager(n):
    """Four chunks a block through two stages ((1, 8) then (1, 16)): graphed
    bit-equal to eager, and a (shard, segment) captured once and replayed
    once a call, each segment looping over the chunks inside: n x
    len(plans) captures and replays a call, not x num_chunks."""
    cfg = tdp.DdcConfig.create(2_048_000, 16_000, 2, 4 * 32768, chunk_target=32768)
    assert cfg.num_chunks == 4 and len(cfg.plans) == 2 and tss.time_sharded_modtap_fits(cfg, n)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(-100, 100, size=(BLOCKS, cfg.block_samples, 2), dtype=np.int8))
    tables = tdp.make_tables(cfg, np.array([250_123, -410_517]), device=CPU)

    def make():
        def args_of(b, state):
            if b == 2:
                state[0] = _copy(state[0])
            if b == 3:
                state[0] = tdp.reset_slot(state[0], 1)  # a recording start
            return (x[b], tables)

        return tss.make_time_sharded_modtap_ddc(cfg, _mesh(1, n)), [tdp.init_state(cfg, device=CPU)], args_of

    outs = _against_eager(make, 1, n * len(cfg.plans))
    assert outs[-1][0].shape == (2, cfg.out_per_block, 2) and outs[-1][0].abs().max() > 10


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_v1_ddc_graphed_equals_eager(n):
    cfg = tdp.DdcConfig.create(sample_rate=1024000, bandwidth=16000, num_slots=2, block_samples=4096 * 16)
    rng = np.random.default_rng(4)
    tables = tddc.make_nco_tables(np.array([100000, -50000]), cfg.sample_rate, cfg.block_samples, CPU)
    blocks = torch.from_numpy((rng.standard_normal((BLOCKS, cfg.block_samples, 2)) * 0.3).astype(np.float32))

    def make():
        return tss.make_time_sharded_ddc(cfg, _mesh(1, n)), [], lambda b, _: (blocks[b], tables)

    outs = _against_eager(make, 0, n * (len(cfg.plans) + 2))
    assert outs[0][0].abs().max() > 10


def test_two_shards_of_equal_shape_on_one_device_keep_their_own_state():
    """Shards 0 and 1 on one device, the same shapes and other data: each
    has its own segment, buffers and state, and neither's overwrites the
    other's."""

    def shard(state, x):
        return state + x, state * 2.0

    def run(segment, states, xs):
        results = [segment(f"shard {i}", shard, (0,), CPU)(states[i], xs[i]) for i in range(2)]
        return tuple(list(r) for r in zip(*results))

    program = Program(run)
    step = sharded_step(program, "toy")
    states = [torch.zeros(3), torch.full((3,), 10.0)]
    e_states = list(states)
    for b in range(3):
        xs = [torch.full((3,), float(b + 1)), torch.full((3,), -float(b + 1))]
        states, outs = step(states, xs)
        e_states, e_outs = program(e_states, xs)
        for got, want in zip(states + outs, e_states + e_outs):
            assert torch.equal(got, want)
    assert states[0].tolist() == [6.0] * 3 and states[1].tolist() == [4.0] * 3
    assert states[0].untyped_storage().data_ptr() != states[1].untyped_storage().data_ptr()
    (s0, s1) = step.segments.values()
    assert isinstance(s0, GraphedStep) and s0 is not s1 and step.captures == 2
    assert states[0] is s0.graphs()[0].buffers[0][0] and states[1] is s1.graphs()[0].buffers[0][0]
