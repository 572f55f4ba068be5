"""The direct-sampling deployment ``ds491m52`` (``benchmark/configs/ds491m52.json``)
on the CPU: the configuration's sizes are the ones the port plans for a
491.52 Msps band, and the port's modulated-taps DDC at that rate, over the
deployment's 16 slots, records what the benchmark's float64 recorder bank
(``benchmark/reference/ddc.py``) records, judged as the cell judges it
(``reference/judge.judge_recording`` against the cell's limit), over two
consecutive blocks of one 1,966,080-sample chunk each (one of the cell's
128 chunks a block). Planted faults fail: stage 1's raw tail not carried
into the second block, two slots' tables swapped.

No card and no JAX; a block is one chunk, so the file stays small."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.drivers.step import tunables
from benchmark.reference import ddc as ref_ddc
from benchmark.reference import judge
from rtl_sdr_scanner_tpu_torch.drivers import fir_stages
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig
from rtl_sdr_scanner_tpu_torch.ops.ddc import Ddc2State
from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CELL = "ds491m52.band1.step"
CHUNK = 1_966_080  # one DDC chunk of the deployment's block


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _config() -> dict:
    entry = next(c for c in _manifest()["configs"] if c["name"] == "ds491m52")
    return json.loads((ROOT / entry["file"]).read_text())


def _traffic() -> dict:
    w = next(w for w in _manifest()["workloads"] if w["name"] == CELL)
    return json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())


def _limit() -> float:
    return json.loads((ROOT / "benchmark" / "cells" / f"{CELL}.json").read_text())["limits"]["rec_excess_lsb"]


def test_configuration_is_what_the_port_plans():
    """fft 2^21 at decim 4; the runtime grows its default 16 frames to the
    file's 30; the DDC chain, its 128 chunks a block and the stages the FIR
    kernel takes; the vote's 137-bin group."""
    c = _config()
    assert c["reduced"] == [] and len(c["assumed"]) >= 3
    rate, tun = c["sample_rate"], tunables(c)
    default = ScanConfig.create(rate, 16, tun)
    assert (default.fft_size, default.decimator_factor) == (c["fft_size"], c["decimator_factor"]) == (1 << 21, 4)
    grown = sdr_device._fix_block_multiple(default, rate, c["recording_rate"], tun)
    assert grown.frames_per_block == c["frames_per_block"] == 30
    cfg = ScanConfig.create(rate, c["frames_per_block"], tun)
    assert cfg.block_samples == 251_658_240 and cfg.step_hz == 234.375
    ddc_cfg = DdcConfig.create(rate, c["recording_rate"], c["slots_per_band"], cfg.block_samples,
                               chunk_target=c["ddc_phase_chunk_target"])
    assert [[p.interp, p.decim] for p in ddc_cfg.plans] == c["ddc_stages"]
    assert ddc_cfg.modtap and (ddc_cfg.chunk, ddc_cfg.num_chunks) == (CHUNK, 128)
    assert [[p.interp, p.decim] for p, _ in fir_stages(ddc_cfg)] == c["fir_kernel_stages"]
    assert [p.ntaps for p in ddc_cfg.plans] == [263, 525, 3939]
    stages = ref_ddc.stages_of(c)
    assert ref_ddc.phase_chunk(cfg.block_samples, stages, c["ddc_phase_chunk_target"]) == CHUNK
    assert math.ceil(c["recording_rate"] / cfg.step_hz) == 137
    assert len(_traffic()["slot_shifts_hz"]) == c["slots_per_band"] == 16


@pytest.fixture(scope="module")
def scene():
    """(DdcConfig of a one-chunk block, shifts [16], two int8 blocks [n, 2],
    the reference's 127 y [16, out, 2] of each)."""
    c = _config()
    rate, stages = c["sample_rate"], ref_ddc.stages_of(c)
    cfg = DdcConfig.create(rate, c["recording_rate"], c["slots_per_band"], CHUNK)
    assert cfg.num_chunks == 1
    t = _traffic()
    shifts = np.asarray(t["slot_shifts_hz"], dtype=np.int64)
    rng = np.random.default_rng(2**31 + 27)
    n = np.arange(2 * CHUNK, dtype=np.int64)
    x = 0.01 * (rng.standard_normal(2 * CHUNK) + 1j * rng.standard_normal(2 * CHUNK))
    for f in t["carrier_offsets_hz"][:4]:  # four CW carriers, each under a slot, at phases of their own
        x += 0.2 * np.exp(1j * (2 * np.pi * ((f * n) % rate) / rate + rng.uniform(0, 2 * np.pi)))
    # a full-scale burst under slot 0 over the first block's last samples: what
    # stage 1's carried raw tail brings into the second block's recordings
    burst = slice(CHUNK - 2 * cfg.plans[0].tail_len, CHUNK)
    x[burst] = 0.99 * np.exp(1j * 2 * np.pi * ((shifts[0] * n[burst]) % rate) / rate)
    iq = np.clip(np.round(np.stack([x.real, x.imag], axis=-1) * 127), -128, 127).astype(np.int8)
    blocks = [torch.from_numpy(iq[:CHUNK]), torch.from_numpy(iq[CHUNK:])]
    hist, keep = ref_ddc.history(stages), ref_ddc.output_length(CHUNK, stages)
    want = [ref_ddc.record_block(blocks[0], 0, keep, shifts, rate, stages, CHUNK),
            ref_ddc.record_block(torch.cat([blocks[0][-hist:], blocks[1]]), CHUNK - hist, keep, shifts, rate,
                                 stages, CHUNK)]
    return cfg, shifts, blocks, want


def _record(cfg, shifts, blocks, fault=None):
    """The port's DDC step over the blocks: int8 [16, out, 2] a block."""
    step = ddc_pipeline.make_ddc_step(cfg, device="cpu")
    state = ddc_pipeline.init_state(cfg, device="cpu")
    if fault == "swapped":
        shifts = shifts[[15] + list(range(1, 15)) + [0]]
    tables = ddc_pipeline.make_tables(cfg, shifts, device="cpu")
    recs = []
    for b, block in enumerate(blocks):
        if fault == "tail" and b == 1:
            state = Ddc2State(phase=state.phase, x_tail=torch.zeros_like(state.x_tail), tails=state.tails)
        state, rec = step(state, block, tables)
        recs.append(rec)
    return recs


def test_port_records_what_the_reference_records(scene):
    cfg, shifts, blocks, want = scene
    for rec, ref in zip(_record(cfg, shifts, blocks), want):
        assert rec.shape == ref.shape == (16, CHUNK // 15_360, 2) and rec.dtype == torch.int8
        assert judge.judge_recording(rec, ref)["rec_excess_lsb"] <= _limit()
        assert rec[:4].abs().max() > 16 and rec[4:].abs().max() < 4  # the carriers' slots, then the empty ones


@pytest.mark.parametrize("fault", ["tail", "swapped"])
def test_planted_fault_is_not_recorded_as_the_reference(scene, fault):
    cfg, shifts, blocks, want = scene
    worst = max(judge.judge_recording(rec, ref)["rec_excess_lsb"]
                for rec, ref in zip(_record(cfg, shifts, blocks, fault), want))
    assert worst > _limit(), worst
