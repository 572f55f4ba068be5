"""Timed loop of the wideband step: ``drivers.WidebandBlocks.run_block``
with ``fused=True`` on a one-card band mesh (the channelizer splitting one
int8 wideband stream into the configuration's channels, every channel's
compact scan and K-slot modulated-taps DDC, captured as one CUDA graph and
replayed, its state carried in place), closed loop with one block in
flight, each block's packed detections and int8 recordings fetched into
pinned host buffers behind its kernels (``drivers/step.py``'s loop).

Set-up builds the step at a channel's geometry and the configuration's
precision, makes the traffic's ring of wideband blocks on the device from
the seed, runs the noise-learning blocks on the ring's noise, keys the
carriers on and runs ``warm_blocks`` more; then the window measures for
``seconds``. Once it has closed, the program's step is freed, the plain
reference channelizer (``reference/channelizer.py``) splits the learning
and warm-up blocks and ``checked_blocks`` window blocks drawn from the
seed, and the blocks before them that their rows and recordings reach,
from the traffic's wideband inputs alone; each channel is then judged as
a band of the step cell (``reference/judge.py``), the worst over channels
reported, but for the history vote, which is judged up to the rows'
tolerance (``reference/vote_ties.py``): a float32 bank's channels carry
enough rounding into their rows to flip a bfloat16 tie, or a window's max
across the level, where the int8 PSD's rows do not.

The control (``control=True``) is the reference one precision down in the
program's place: the bank's operands in TF32, then rows, selection and DDC
as the step cell's control. The bank alone in TF32 (the rest at the
configured precision) is judged beside it and logged.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers.step import CONTROL, Reservoir, _segment, log, tunables
from benchmark.harness import Cell, HostFetch, Outcome
from benchmark.reference import channelizer as ref_chan
from benchmark.reference import ddc as ref_ddc
from benchmark.reference import judge
from benchmark.reference import scan as ref_scan
from benchmark.reference import vote_ties
from benchmark.trace import Tracer


def channel_config(config: dict) -> dict:
    """The configuration as one channel sees it: ``sample_rate`` the channel
    rate."""
    return dict(config, sample_rate=config["channel_rate"])


def build_step(cell: Cell, shifts: np.ndarray, device: torch.device):
    """(WidebandBlocks, DdcConfig, group size) of the cell, each size
    checked against the configuration's file."""
    from rtl_sdr_scanner_tpu_torch.drivers import WidebandBlocks
    from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig
    from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig
    from rtl_sdr_scanner_tpu_torch.parallel.mesh import make_mesh

    c = cell.config
    b, rate = c["channels"], c["channel_rate"]
    if c["sample_rate"] != b * rate or cell.traffic["bands"] != b:
        raise ValueError(f"a {c['sample_rate']} sps stream, {b} channels of {rate} sps and "
                         f"{cell.traffic['bands']} traffic bands do not agree")
    if c["channelizer_oversample"] != 1 or c["precision"]["channelizer"] != "float32":
        raise ValueError("the cell runs the critically sampled bank (channelizer_oversample 1) in float32")
    cfg = ScanConfig.create(rate, c["frames_per_block"], tunables(c))
    if (cfg.fft_size, cfg.decimator_factor) != (c["fft_size"], c["decimator_factor"]):
        raise ValueError(f"the program plans fft {cfg.fft_size} decim {cfg.decimator_factor} at {rate} sps, "
                         f"the configuration states {c['fft_size']} and {c['decimator_factor']}")
    ddc_cfg = DdcConfig.create(rate, c["recording_rate"], c["slots_per_band"], cfg.block_samples)
    stages = [[p.interp, p.decim] for p in ddc_cfg.plans]
    if stages != c["ddc_stages"]:
        raise ValueError(f"the program plans DDC stages {stages}, the configuration states {c['ddc_stages']}")
    group = math.ceil(c["recording_rate"] / cfg.step_hz)
    mesh = make_mesh(1, 1, devices=[device])
    blocks = WidebandBlocks(cfg, ddc_cfg, group, c["top_k"], b, shifts, True, mesh, device)
    return blocks, ddc_cfg, group


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: bool = False) -> Outcome:
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages, kernel_wrappers

    t = cell.traffic
    geo = ref_scan.Geometry.of(channel_config(cell.config))
    cuda = device.type == "cuda"
    if cuda:
        from rtl_sdr_scanner_tpu_torch.ops.cuda import build

        build.library()
    ring = cell.generator().WideRing(t, geo, seed, device)
    steps, ddc_cfg, group = build_step(cell, ring.shifts, device)
    fetch = HostFetch(device)
    kept: Dict[int, tuple] = {}

    def block(b: int) -> List[torch.Tensor]:
        packed, rec = steps.run_block(b, ring.block(b))
        return [packed[0], rec[0]]

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
    want = {"psd_frames_int8": 0, "fused_selection": 1, "history_vote": 1,
            "stage_apply_fir": ddc_cfg.num_chunks * len(fir_stages(ddc_cfg))}
    if cuda and launches != {k: n * window_blocks for k, n in want.items()}:
        log(f"kernel launches {launches} over {window_blocks} blocks (per block {want})")
    e2e = {
        "iq_samples_per_s": window_blocks * ring.block_samples / (t1 - t0),
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
    return Outcome(end_to_end=e2e, numbers=numbers, limits=dict(cell.spec["limits"]), attempted=window_blocks,
                   memory_peak_bytes=int(memory_peak), trace=reduced, control=control_numbers)


class Channels:
    """The reference bank's channels of the ring's blocks, [B, F, fft*decim,
    2] float64 in cs8 units, the last few kept."""

    KEEP = 3

    def __init__(self, ring, geo: ref_scan.Geometry, tf32_operands: bool):
        self.ring, self.geo, self.tf32 = ring, geo, tf32_operands
        self.hist = ref_chan.history_len(ring.bands)
        self.cache: Dict[int, torch.Tensor] = {}

    def block(self, b: int) -> torch.Tensor:
        if b not in self.cache:
            before = self.ring.reference_block(b - 1)[-self.hist:] if b > 0 else None
            y = ref_chan.channelize(self.ring.reference_block(b), before, self.ring.bands, self.tf32)
            g = self.geo
            self.cache[b] = y.reshape(self.ring.bands, g.frames, g.fft * g.decim, 2)
            while len(self.cache) > self.KEEP:  # the first made goes first
                del self.cache[next(k for k in self.cache if k != b)]
        return self.cache[b]

    def floor(self) -> torch.Tensor:
        return ref_scan.noise_floor([self.block(b) for b in range(self.geo.learning_blocks())], self.geo)


def judge_scan(got, rows: ref_scan.Rows, ready: bool, keys: torch.Tensor, level: float, group: int, top: int,
               sel_precision: str, tol_db: float) -> Dict[str, float]:
    """``judge.judge_scan``'s numbers, ``vote_bins`` read by
    ``vote_ties.vote_gap`` with the rows held to ``tol_db``."""
    numbers = judge.judge_scan(got, rows, ready, keys, level, group, top, sel_precision)
    if math.isfinite(numbers["vote_bins"]):
        numbers["vote_bins"] = vote_ties.vote_gap(got, rows.hist, group // 2, level, sel_precision, tol_db)
    return numbers


def check(cell: Cell, ring, geo: ref_scan.Geometry, group: int, kept: dict, device, control: bool):
    """Worst numbers of the program's kept blocks against the reference
    (and of the control put in the program's place, with ``control``)."""
    c = cell.config
    prec = c["precision"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stages = ref_ddc.stages_of(c)
    keys = torch.full((c["key_slots"],), -1, dtype=torch.int64, device=device)
    level = float(c["start_level_db"])
    tol_db = float(cell.spec["limits"]["rows_db"])  # a stored row's tolerance in the vote
    chunk = ref_ddc.phase_chunk(geo.block_samples, stages, c["ddc_phase_chunk_target"])
    hist = ref_ddc.history(stages)
    keep = ref_ddc.output_length(geo.block_samples, stages)
    last_learning = geo.last_learning_frame()
    shifts = ring.shifts
    span = -(-(geo.grouping_y - 1) // geo.frames)  # blocks before a block that its rows reach
    sources = {"reference": Channels(ring, geo, False)}
    # the controls: (channels, rows, selection, DDC operands in TF32)
    variants = {}
    if control:
        sources["tf32"] = Channels(ring, geo, True)
        variants = {"control": ("tf32", CONTROL[prec["rows"]], CONTROL[prec["selection"]], True),
                    "bank alone in TF32": ("tf32", prec["rows"], prec["selection"], False)}
    floors = {name: src.floor() for name, src in sources.items()}
    numbers: Dict[str, float] = {}
    judged: Dict[str, Dict[str, float]] = {name: {} for name in variants}
    live = np.zeros(len(shifts), dtype=np.int64)  # rows with a bin at or above the level, a channel
    for b in sorted(kept):
        packed, rec = (x.to(device) for x in kept[b])
        ready = (b + 1) * geo.frames - 1 >= last_learning
        got = judge.unpack(packed, geo.frames, c["top_k"], c["key_slots"])
        live += (got.cand_count > 0).sum(dim=1).cpu().numpy()
        scenes = {}
        for name, src in sources.items():
            before = [src.block(j) for j in range(max(0, b - span), b)]
            scenes[name] = (torch.cat(before, dim=1) if before else None, src.block(b))
        frames_before, cur = scenes["reference"]
        rows = ref_scan.block_rows(frames_before, cur, b, floors["reference"], geo, prec["rows"])
        judge.worst(numbers, judge_scan(got, rows, ready, keys, level, group, c["top_k"], prec["selection"], tol_db))
        for name, (src, rows_p, sel_p, _) in variants.items():
            low = ref_scan.block_rows(*scenes[src], b, floors[src], geo, rows_p)
            det = ref_scan.detect(low, ready, keys, level, group, c["top_k"], sel_p)
            judge.worst(judged[name], judge_scan(det, rows, ready, keys, level, group, c["top_k"],
                                                 prec["selection"], tol_db))
        del rows
        for band in range(cur.shape[0]):
            prev = sources["reference"].block(b - 1) if b > 0 else None
            seg, start = _segment(prev, cur, band, b, geo.block_samples, hist)
            want = ref_ddc.record_block(seg, start, keep, shifts[band], geo.rate, stages, chunk)
            judge.worst(numbers, judge.judge_recording(rec[band], want))
            for name, (src, _, _, tf32) in variants.items():
                low_prev = sources[src].block(b - 1) if b > 0 else None
                seg, start = _segment(low_prev, sources[src].block(b), band, b, geo.block_samples, hist)
                low = ref_ddc.record_block(seg, start, keep, shifts[band], geo.rate, stages, chunk,
                                           tf32_operands=tf32)
                judge.worst(judged[name], judge.judge_recording(torch.clamp(torch.round(low), -128, 127), want))
    log(f"rows at or above the level a channel over the checked blocks: {live.tolist()} "
        f"(carriers in channels {ring.carrier_bands} at {ring.carrier_hz} Hz)")
    for name, got in judged.items():
        log(f"{name}: {got}")
    return numbers, judged.get("control", {})
