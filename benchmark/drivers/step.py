"""Timed loop of a batched block step: ``drivers.BandedBlocks.run_block``
(``make_banded_fused_step`` captured as one CUDA graph and replayed, its
state carried in place), closed loop with one block in flight, each
block's packed detections and int8 recordings fetched into pinned host
buffers behind its kernels.

Set-up builds the step at the configuration's geometry and precision, makes
the traffic's ring on the device from the seed, runs the noise-learning
blocks on the ring's noise, keys the carriers on and runs ``warm_blocks``
more; then the window measures for ``seconds``. Once it has closed, the
program's step is freed and the plain reference works out the learning and
warm-up blocks and ``checked_blocks`` window blocks drawn from the seed
(reservoir sampling over every block of the window), from the traffic's
inputs alone, and judges what the program returned for them.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import Cell, HostFetch, Outcome
from benchmark.reference import ddc as ref_ddc
from benchmark.reference import judge
from benchmark.reference import scan as ref_scan
from benchmark.trace import Tracer

CONTROL = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def tunables(config: dict):
    from rtl_sdr_scanner_tpu_torch.constants import Tunables

    p = config["precision"]
    return Tunables(
        detection_bf16=p["selection"] == "bfloat16",
        power_bf16=p["rows"] == "bfloat16",
        noise_learning_time_ms=config["noise_learning_ms"],
        grouping_x=config["grouping_x"],
        grouping_y=config["grouping_y"],
        detection_top_k=config["top_k"],
    )


def build_step(cell: Cell, shifts: np.ndarray, device: torch.device):
    """(BandedBlocks, ScanConfig, DdcConfig, group size) of the cell, each
    size checked against the configuration's file."""
    from rtl_sdr_scanner_tpu_torch.drivers import BandedBlocks
    from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig
    from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig

    c = cell.config
    cfg = ScanConfig.create(c["sample_rate"], c["frames_per_block"], tunables(c))
    if (cfg.fft_size, cfg.decimator_factor) != (c["fft_size"], c["decimator_factor"]):
        raise ValueError(f"the program plans fft {cfg.fft_size} decim {cfg.decimator_factor}, "
                         f"the configuration states {c['fft_size']} and {c['decimator_factor']}")
    ddc_cfg = DdcConfig.create(c["sample_rate"], c["recording_rate"], c["slots_per_band"], cfg.block_samples)
    stages = [[p.interp, p.decim] for p in ddc_cfg.plans]
    if stages != c["ddc_stages"]:
        raise ValueError(f"the program plans DDC stages {stages}, the configuration states {c['ddc_stages']}")
    group = math.ceil(c["recording_rate"] / cfg.step_hz)
    blocks = BandedBlocks(cfg, ddc_cfg, group, c["top_k"], cell.traffic["bands"], shifts, device)
    return blocks, cfg, ddc_cfg, group


class Reservoir:
    """A uniform sample of ``k`` of the window's blocks, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([seed, 2])
        self.kept: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.seen = 0

    def offer(self, b: int, outs: List[torch.Tensor]) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[b] = tuple(t.clone() for t in outs)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[b] = tuple(t.clone() for t in outs)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: bool = False) -> Outcome:
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages, kernel_wrappers

    c, t = cell.config, cell.traffic
    geo = ref_scan.Geometry.of(c)
    cuda = device.type == "cuda"
    if cuda:
        from rtl_sdr_scanner_tpu_torch.ops.cuda import build

        build.library()
    ring = cell.generator().StepRing(t, geo, seed, device)
    steps, _, ddc_cfg, group = build_step(cell, ring.shifts, device)
    fetch = HostFetch(device)
    kept: Dict[int, Tuple[torch.Tensor, ...]] = {}

    def block(b: int) -> List[torch.Tensor]:
        outs = steps.run_block(b, ring.block(b))
        return [outs.packed, outs.recording]

    learning = ring.learning
    warm = learning + cell.spec["warm_blocks"]
    for b in range(warm):
        if b == learning:
            ring.key_on()
        kept[b] = tuple(x.clone() for x in fetch.wait(fetch.start(b, block(b))))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    setup_s = time.perf_counter() - t_start

    sample = Reservoir(cell.spec["checked_blocks"], ring.seed)
    lat_ms, host_ms = [], []
    b = warm
    with Tracer(trace, cuda) as tracer:
        with tracer.window():
            t0 = time.perf_counter()
            pending = None  # (block, slot, dispatch time)
            while True:
                done = time.perf_counter() - t0 >= seconds
                if not done:
                    with tracer.range("bench.dispatch"):
                        td = time.perf_counter()
                        slot = fetch.start(b, block(b))
                        host_ms.append((time.perf_counter() - td) * 1e3)
                if pending is not None:
                    pb, ps, pt = pending
                    with tracer.range("bench.wait"):
                        outs = fetch.wait(ps)
                    lat_ms.append((time.perf_counter() - pt) * 1e3)
                    sample.offer(pb, outs)
                if done:
                    break
                pending = (b, slot, td)
                b += 1
            t1 = time.perf_counter()
    window_blocks = b - warm
    launches = {name: fn.launches for name, fn in wrappers.items()}
    memory_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    reduced = None
    if trace:
        reduced = tracer.reduce()
        reduced.blocks, reduced.host_ms, reduced.cell = window_blocks, host_ms, cell
    want = {"psd_frames_int8": 1, "fused_selection": 1,
            "stage_apply_fir": ddc_cfg.num_chunks * len(fir_stages(ddc_cfg))}
    if cuda and launches != {k: n * window_blocks for k, n in want.items()}:
        log(f"kernel launches {launches} over {window_blocks} blocks (per block {want})")
    samples = window_blocks * t["bands"] * geo.block_samples
    e2e = {
        "iq_samples_per_s": samples / (t1 - t0),
        "step_latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "setup_s": setup_s,
    }
    log(f"window: {window_blocks} blocks in {t1 - t0:.3f} s; latency median {np.median(lat_ms):.3f} ms, "
        f"p95 {e2e['step_latency_ms_p95']:.3f} ms; host ms a dispatch median {np.median(host_ms):.3f}")

    del steps, fetch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept.update(sample.kept)
    tr = time.perf_counter()
    numbers, control_numbers = check(cell, ring, geo, group, kept, device, control)
    log(f"reference: {len(kept)} blocks {sorted(kept)} judged in {time.perf_counter() - tr:.1f} s")
    out = Outcome(end_to_end=e2e, numbers=numbers, limits=dict(cell.spec["limits"]), attempted=window_blocks,
                  memory_peak_bytes=int(memory_peak), trace=reduced, control=control_numbers)
    return out


def check(cell: Cell, ring, geo: ref_scan.Geometry, group: int, kept: dict, device, control: bool):
    """Worst numbers of the program's kept blocks against the reference
    (and of the control put in the program's place, with ``control``)."""
    c = cell.config
    prec = c["precision"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stages = ref_ddc.stages_of(c)
    floor = ref_scan.noise_floor([ring.reference_block(b) for b in range(geo.learning_blocks())], geo)
    keys = torch.full((c["key_slots"],), -1, dtype=torch.int64, device=device)
    level = float(c["start_level_db"])
    chunk = ref_ddc.phase_chunk(geo.block_samples, stages, c["ddc_phase_chunk_target"])
    hist = ref_ddc.history(stages)
    keep = ref_ddc.output_length(geo.block_samples, stages)
    last_learning = geo.last_learning_frame()
    shifts = ring.shifts
    numbers: Dict[str, float] = {}
    ctl: Dict[str, float] = {}
    live = np.zeros(len(shifts), dtype=np.int64)  # rows with a bin at or above the level, a band
    for b in sorted(kept):
        packed, rec = (x.to(device) for x in kept[b])
        before = [ring.reference_block(j) for j in range(max(0, b - -(-(geo.grouping_y - 1) // geo.frames)), b)]
        prev = before[-1] if before else None
        cur = ring.reference_block(b)
        ready = (b + 1) * geo.frames - 1 >= last_learning
        frames_before = torch.cat(before, dim=1) if before else None
        rows = ref_scan.block_rows(frames_before, cur, b, floor, geo, prec["rows"])
        got = judge.unpack(packed, geo.frames, c["top_k"], c["key_slots"])
        live += (got.cand_count > 0).sum(dim=1).cpu().numpy()
        judge.worst(numbers, judge.judge_scan(got, rows, ready, keys, level, group, c["top_k"], prec["selection"]))
        if control:
            low = ref_scan.block_rows(frames_before, cur, b, floor, geo, CONTROL[prec["rows"]])
            det = ref_scan.detect(low, ready, keys, level, group, c["top_k"], CONTROL[prec["selection"]])
            judge.worst(ctl, judge.judge_scan(det, rows, ready, keys, level, group, c["top_k"], prec["selection"]))
        for band in range(cur.shape[0]):
            seg, start = _segment(prev, cur, band, b, geo.block_samples, hist)
            want = ref_ddc.record_block(seg, start, keep, shifts[band], geo.rate, stages, chunk)
            judge.worst(numbers, judge.judge_recording(rec[band], want))
            if control:
                low = ref_ddc.record_block(seg, start, keep, shifts[band], geo.rate, stages, chunk,
                                           tf32_operands=True)
                judge.worst(ctl, judge.judge_recording(torch.clamp(torch.round(low), -128, 127), want))
    log(f"rows at or above the level a band over the checked blocks: {live.tolist()} "
        f"(carriers in bands {ring.carrier_bands})")
    return numbers, ctl


def _segment(prev, cur, band: int, b: int, block: int, hist: int):
    """Band ``band``'s [history of block b-1, block b] as [n, 2] int8, and
    the stream index of its first sample."""
    now = cur[band].reshape(-1, 2)
    if prev is None or hist == 0:
        return now, b * block
    return torch.cat([prev[band].reshape(-1, 2)[-hist:], now]), b * block - hist
