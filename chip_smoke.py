"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                          # everything below
    python3 chip_smoke.py --kernels-only [--root DIR]

1. Builds the hand-written kernels from ``rtl_sdr_scanner_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/kernels``).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes each path and the runtime session give it: the PSD within 0.02 dB on every bin within
   60 dB of its frame's peak (median |diff| <= 1e-3 dB) and the selection
   bit-exact in bf16 and f32, at each path's fft, decimation and
   submargin; the PSD also at the ends of each of its forms (one block a
   frame: fft 256 and 16384; a cluster: 32768 and 131072; the scratch form:
   262144), decimations 1-3, odd frame counts; the selection also at the
   wideband channels' fft 512 and at fft 256; the decimating FIR within
   2e-5 * max|y| (f32 sum order) with the new tail exact, at each path's
   and the session's decimating stages and at M = 125, 32, 151, 157 and
   400 (the last three in its wide form).
3. Path 1: ``make_banded_fused_step`` at full width, 24 bands x 45 frames x
   fft 131072 at 20.48 Msps with 2 recorder slots at 16 kHz (the
   modulated-taps DDC; its decimating stage 2 through the FIR kernel),
   default Tunables, 6 blocks from a device-resident ring of synthetic
   cs8. Band 5 carries an FM signal keyed on after the 2 s noise-learning
   window; the run must report the noise floor learned, that signal
   detected in its band only, and a recording.
4. Path 2: the same step at an RTL-SDR deployment, 24 bands x 75 frames x
   fft 16384 (decim 2) at 2.4 Msps with 2 slots at the reference's default
   32 kHz: the v1 DDC, one decimation-only stage (1, 75) through the FIR
   kernel, 2 chunks a block; group 219 takes the wide-window vote. Same
   checks, plus slot 0 of the signal band (tuned to the signal) >= 10 dB
   above slot 0 of a quiet band.
5. Interpolating stages on the card (DDC only, 4 bands, 2 chunks): 2.0 Msps
   -> 32 kHz (v1, stage (2, 125)) and 10 Msps -> 32 kHz (modulated taps,
   stage 2 (2, 25)), each within 1 LSB of the same call on the CPU.
6. The runtime session, the user's entry points: an 8.2 s RTL-SDR capture
   (cs8 at 2.4 Msps, noise and an FM signal at +250 kHz keyed 3-6 s) behind
   one replay device with one parked range, 4 recorder slots at 32 kHz,
   default Tunables. ``Scanner.run_to_completion()`` on the card (the PSD
   and selection kernels once a block, the FIR once a chunk for each stage
   while a slot records), then on the CPU through the plain versions: the
   two MQTT payload streams must agree (same topics in the same order,
   equal headers, IQ within 1 LSB, spectrogram bins within 1), and the
   transmission must be recorded at its frequency and FM-demodulate to its
   800 Hz tone. Then ``runtime.main.run(config)`` on a worker thread,
   stopped through ``main._is_running`` once its scanner has drained (rc 0,
   payloads as the card's). Prints ms per block split into device (CUDA
   events around the scan and DDC dispatches: a span that includes the
   card's waits for the host's launches) and host (the rest of the wall),
   and the real-time factor (stream seconds per wall second), serial and
   with ``pipelined_ingest``.
7. The wideband step: ``bench.py``'s wideband app path at full width, one
   163.84 Msps int8 stream (141,557,760 samples a block, a device-resident
   ring of 2 blocks) split by the channelizer into 8 channels of path 1's
   geometry (45 x fft 131072 at 20.48 Msps), every channel's compact scan
   and 2-slot modulated-taps DDC at 16 kHz (stages (1, 32), (1, 40): the
   FIR kernel 16 times a block), in the fused form (one dispatch) and the
   split form (two), 5 blocks each. Noise learning ends inside block 0;
   ring block 1 carries an FM signal in channel 3, which must be detected
   there only and whose slot-0 rows must demodulate to its tone. Before it,
   the channelizer is held against the CPU on 2^20 samples of that block
   (two streamed halves) within 2e-5 (atol = rtol). Prints ms a block and
   wideband samples/s.
8. The wideband session: an 8 s RTL-SDR capture at 2.048 Msps (cs8, two FM
   signals in channels 3 and 12 keyed 3-6 s) behind one replay device with
   ``"channels": 16`` (128 kHz channels: fft 512, decim 5, 16 frames), the
   reference's recording defaults (32 kHz: one modulated-taps stage, so the
   FIR kernel launches 0 times), in the serial form, then ``mesh_bands=1``
   split and fused: each on the card and on the CPU, payloads compared as
   in step 6, both transmissions recorded and demodulated; ``main.run`` on
   the serial config. Prints ms a block (device span, host) and the
   real-time factor of each form. The channels reach the scan as f32
   pairs, so the PSD kernel launches 0 times in steps 7 and 8 (the JAX
   package's PSD kernel is int8-only too).
9. Times kernel, plain version, library call and bound for every kernel at
   every path's and the session's shapes (``ms_by_path`` and the like in
   the record, ``runtime`` for the session's, the wideband phases' for the
   selection and the FIR; the
   top-level numbers are path 1's for PSD and selection, path 2's for the
   FIR). ``ms`` is the wrapper's pace (CUDA events around back-to-back
   calls), ``device_ms`` the kernel's own device time (torch.profiler's
   kernel records), ``host_us`` the host time a wrapper call takes to
   enqueue. It comes last: once the profiler has traced, every later
   launch of the process is slower. The time mesh's and the band shards'
   per-shard shapes (step 10) are checked and timed here too.
10. The multi-device layer on one card (it runs before step 9): (a) path
   1's band (20.48 Msps, fft 131072, decim 3, 2 slots at 16 kHz, modulated
   taps) time-sharded over a mesh of 4 copies of the card, frames grown 45
   -> 180 by the reference's rule (141.6 MB of int8 a block), 4 blocks of a
   device-resident ring with FM keyed after the noise learning, through
   ``make_time_sharded_scan`` (the PSD and selection kernels once a shard)
   and ``make_time_sharded_modtap_ddc`` (the FIR kernel once a shard a
   chunk), held against the one-card compact step and DDC at the same
   geometry (counts exact; indices equal but for < 0.5% near-ties, whose
   top-K values lie within two bf16 steps of the selection; values within
   2e-3 dB where the bins agree; recordings within 1 LSB), the signal
   detected and recorded; (b) step 7's wideband step over a band mesh of 2 copies of
   the card (the channelizer on each shard), fused and split, 3 blocks,
   against the one-card form (indices, votes and counts equal, values
   within 1e-3 dB, recordings within 1 LSB, FM in channel 3 only); (c)
   ``main.run`` with ``mesh_time`` 4 and ``power_bf16`` on step 6's
   capture (one visible card: the mesh resolves to 1 shard), payloads
   against the same config's CPU run. Prints ms a block of each form next
   to its one-card counterpart.

Each path (and each phase's or form's card run) runs with every kernel's
launch count set to 0 just before it and read just after. Every failure
raises. The last lines are the card's name and power limit, the kernels' JSON record and ``{"ok": true, "device":
{...}}``. Without CUDA it exits non-zero and prints no result.

``--kernels-only`` runs steps 1, 2 and 9 and ends with the kernels' record;
``--root DIR`` takes the package from another checkout (an older tree
unpacked under ``build/``), so that two trees' kernels are timed by the
same code on the same card: old, new, new, old.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

TOP_K = 64
KEY_SLOTS = 16
LEVEL = 8.0
CHECK_ROWS = 45 * 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
PSD_TOL_DB = 0.02
PSD_MEDIAN_TOL_DB = 1e-3
FIR_REL_TOL = 2e-5


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One deployment driven at full width: a ring of ``blocks`` blocks,
    band ``signal_band`` carrying an FM signal from ``signal_from_block``
    on (after the 2 s noise learning); slot 0 of every band tuned to it."""

    key: str  # its name in the JSON record
    name: str
    rate: int
    frames: int  # per block, as the runtime sizes it for the DDC chain
    bandwidth: int  # recording rate (min_sample_rate)
    other_shift: int  # slot 1's shift
    bands: int = 24
    slots: int = 2
    blocks: int = 6
    signal_band: int = 5
    signal_offset_hz: int = 250_000
    signal_from_block: int = 3
    # a time-sharded geometry: ``frames`` a shard, the DDC block and chunk
    # those of all ``time_shards`` shards, each shard a chunk's 1/time_shards
    time_shards: int = 1


# block 3 starts at 2592 ms (path 1) and 3072 ms (path 2)
PATH1 = Geometry("path1", "path 1 (20.48 Msps, modulated-taps DDC)", 20_480_000, 45, 16_000, -1_000_000)
PATH2 = Geometry("path2", "path 2 (2.4 Msps -> 32 kHz, v1 DDC)", 2_400_000, 75, 32_000, -600_000)
# the runtime phase's capture: an RTL-SDR at 2.4 Msps parked on one 2 MHz
# range, an FM signal keyed after the 2 s noise learning
RT_RATE = 2_400_000
RT_SECONDS = 8.2
RT_CENTER = 145_000_000
RT_SHIFT = 250_000
RT_KEY = (3.0, 6.0)
RT_TONE = 800.0
# the session's kernel shapes (one band, 4 slots), timed beside the paths'
RUNTIME = Geometry("runtime", "runtime session (one 2.4 Msps device, 4 slots at 32 kHz)", RT_RATE, 75, 32_000,
                   -600_000, bands=1, slots=4)
# (fft, decim, frames): the ends of the PSD kernel's forms beyond the paths' shapes
PSD_FORM_CASES = ((256, 1, 7), (16384, 3, 5), (32768, 3, 5), (131072, 1, 3), (262144, 2, 3))
# (fft, submargin): the selection kernel's smallest table (8 leaves) beyond the paths' shapes
SELECT_EXTRA_CASES = ((256, 52),)
# decimations the FIR kernel is held at beyond the paths' stages: 151, 157
# (primes the resampler planner keeps whole) and 400 take its wide form
FIR_EXTRA_M = (125, 32, 151, 157, 400)
# the wideband step: bench.py's app path (bench.py:219-268) at full width, 8
# channels of path 1's per-band geometry split from one 163.84 Msps stream;
# the signal rides ring block 1 of 2, so noise learning ends inside block 0
WIDE = Geometry("wideband_step", "wideband step (163.84 Msps -> 8 x 20.48 Msps channels, modulated-taps DDC)",
                20_480_000, 45, 16_000, -1_000_000, bands=8, blocks=5, signal_band=3, signal_from_block=1)
WIDE_RING = 2
WIDE_LEARN_MS = 500
WIDE_CHECK_SAMPLES = 1 << 20  # the channelizer held card vs CPU on this much of a block
CHAN_TOL = 2e-5  # atol = rtol, tests/test_channelizer.py's bar between the bank's forms
# the wideband session: an RTL-SDR at 2.048 Msps split into 16 channels of
# 128 kHz (fft 512, decim 5, 16 frames: 0.32 s a block), two FM signals in
# different channels keyed after the 2 s noise learning, 32 kHz recordings
WB_RATE = 2_048_000
WB_CHANNELS = 16
WB_SECONDS = 8.0
WB_CENTER = 145_000_000
WB_SIGNALS = ((404_000, 800.0), (-542_000, 1300.0))  # channels 3 and 12
WB_KEY = (3.0, 6.0)
WB_FORMS = (("serial", {}), ("split", {"mesh_bands": 1}),
            ("fused", {"mesh_bands": 1, "wideband_fused_dispatch": True}))
WIDE_RT = Geometry("wideband_runtime", "wideband session (16 x 128 kHz channels, 1 slot each at 32 kHz)",
                   WB_RATE // WB_CHANNELS, 16, 32_000, 0, bands=WB_CHANNELS, slots=1)
# step 10, the multi-device layer on one card: path 1's band time-sharded 4
# ways (180 frames a block, the reference's rule from 45: 45 a shard), and
# the wideband step's 8 channels over 2 band shards (4 channels a shard).
# Their geometries give the kernels' per-shard shapes.
TMESH_SHARDS = 4
TMESH = Geometry("time_mesh", "time mesh (path 1's band, 4 time shards of 45 frames, modulated-taps DDC)",
                 20_480_000, 45, 16_000, -1_000_000, bands=1, blocks=4, signal_band=0, signal_from_block=1,
                 time_shards=TMESH_SHARDS)
BAND_SHARDS = 2
WIDE_SHARD = dataclasses.replace(WIDE, key="wideband_step_2_shards", bands=WIDE.bands // BAND_SHARDS,
                                 name="wideband step over 2 band shards (4 channels a shard)")
MESH_BLOCKS = 3  # the bands-sharded wideband step's blocks


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over reps launches, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time a call of the kernels whose name holds ``kernel``,
    from torch.profiler's kernel records over reps calls (after a warm-up
    call): the kernel alone, whatever the host's pace."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if not us:
        raise RuntimeError(f"the profiler saw no launch of *{kernel}* in {reps} calls")
    # mean a record times records a call: a record the profiler dropped
    # (it happens, rarely) leaves the mean as it is
    return sum(us) / len(us) * max(1, round(len(us) / reps)) / 1e3


def host_us(fn, reps: int) -> float:
    """Mean host time a call takes to return (enqueue only: reps launches
    stay far below the launch queue's depth, so the card never holds the
    host back)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def timings(fn, plain, reps: int, kernel: str, plain_reps: int) -> dict:
    """The wrapper's pace, its kernel's device time and its host time, and
    the plain version's pace, in ms (host in µs)."""
    return dict(ms=cuda_ms(fn, reps), device_ms=device_ms(fn, reps, kernel), host_us=host_us(fn, reps),
                plain_ms=cuda_ms(plain, plain_reps))


def bound(bytes_moved: float, flops: float, peak: float = F32_FLOPS):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and the operations over the peak rate of their type (f32 by default)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def noise_cs8(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """[n, 2] int8 complex white noise, 0.01 rms per component."""
    x = torch.randn((n, 2), generator=gen, device=dev) * (0.01 * 127.0)
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


def fm_cs8(geo: Geometry, start: int, n: int, dev) -> torch.Tensor:
    """[n, 2] f32 FM at the signal offset: 800 Hz tone, 3 kHz deviation, 0.4
    amplitude, in cs8 units. Band-wide on purpose: the 21-bin smoothing
    would dilute a pure tone ~13 dB."""
    t = (torch.arange(n, device=dev, dtype=torch.float64) + start) / geo.rate
    phase = 2 * math.pi * geo.signal_offset_hz * t + (3000.0 / 800.0) * (1 - torch.cos(2 * math.pi * 800 * t))
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1).float() * (0.4 * 127.0)


def random_cs8(shape, gen: torch.Generator, dev) -> torch.Tensor:
    """Uniform int8 IQ in [-100, 100), the JAX package's PSD test input."""
    return torch.randint(-100, 100, shape, generator=gen, device=dev, dtype=torch.int8)


def make_ring(geo: Geometry, cfg, dev) -> list:
    """geo.blocks device-resident blocks [bands, F, fft*decim, 2] int8."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    group = cfg.fft_size * cfg.decimator_factor
    n = geo.frames * group
    ring = []
    for b in range(geo.blocks):
        block = torch.empty((geo.bands, n, 2), dtype=torch.int8, device=dev)
        for band in range(geo.bands):
            block[band] = noise_cs8(n, gen, dev)
            if band == geo.signal_band and b >= geo.signal_from_block:
                x = block[band].float() + fm_cs8(geo, b * n, n, dev)
                block[band] = torch.clamp(torch.round(x), -128, 127).to(torch.int8)
        ring.append(block.reshape(geo.bands, geo.frames, group, 2))
    torch.cuda.synchronize()
    return ring


def configs(geo: Geometry):
    """(ScanConfig, DdcConfig, group size) of one geometry, default Tunables."""
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, scan_pipeline

    cfg = scan_pipeline.ScanConfig.create(geo.rate, geo.frames)
    block = cfg.block_samples * geo.time_shards
    ddc_cfg = ddc_pipeline.DdcConfig.create(geo.rate, geo.bandwidth, geo.slots, block)
    return cfg, ddc_cfg, int(np.ceil(geo.bandwidth / cfg.step_hz))


def fir_stages(ddc_cfg, shards: int = 1) -> list:
    """(plan, input samples a row) of each stage one chunk sends through the
    FIR kernel: every decimation-only stage but a modulated-taps stage 1
    (a time shard's part of the chunk when ``shards`` > 1)."""
    stages, n = [], ddc_cfg.chunk // shards
    for i, plan in enumerate(ddc_cfg.plans):
        if plan.interp == 1 and not (i == 0 and ddc_cfg.modtap):
            stages.append((plan, n))
        n = n * plan.interp // plan.decim
    return stages


def selection_rows(fft: int, dtype, dev) -> torch.Tensor:
    """CHECK_ROWS rows: random, tied, clustered, zones across a segment
    border, all-masked, and values exactly at the level."""
    rng = np.random.default_rng(1)
    rows = rng.normal(0.0, 6.0, size=(CHECK_ROWS, fft)).astype(np.float32)
    r = CHECK_ROWS // 6
    rows[r : 2 * r] = np.round(rows[r : 2 * r] / 2.0)  # many exact ties
    for c in (100, 1020, 1024, 1030, fft // 2, fft - 1):  # clusters, segment borders
        rows[2 * r : 3 * r, max(0, c - 60) : c + 60] += 20.0 * rng.random((r, 1))
    rows[3 * r : 4 * r, 1000:1050] = 40.0  # a flat plateau straddling segment 0/1
    rows[4 * r : 4 * r + 4] = -3.0e38  # fully masked rows
    rows[4 * r + 4 : 5 * r, fft // 3 :] = -3.0e38
    rows[5 * r :, : fft // 2] = LEVEL  # exactly at the level
    return torch.from_numpy(rows).to(dev).to(dtype)


def psd_form(fft: int) -> str:
    """Which form of the PSD kernel takes fft, as the library reports it."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build, psd_kernel

    lib = build.library()
    logs = [n.bit_length() - 1 for n in psd_kernel._split_n(fft)]
    if lib.psd_scratch_bytes(*logs):
        return "scratch form"
    clusters = lib.psd_max_active_clusters(*logs)
    if clusters < 0:
        raise RuntimeError(f"psd kernel: cudaOccupancyMaxActiveClusters failed at fft {fft}: {-clusters}")
    return f"cluster form, {clusters} clusters resident" if clusters else "one block a frame"


def check_psd(fft: int, decim: int, rows: int, gen, dev, rate: float = 2.048e7) -> float:
    """PSD kernel against its plain version on ``rows`` random frames;
    returns the max |diff| (dB) that is held."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel

    iq = random_cs8((rows, fft * decim, 2), gen, dev)
    got = psd_kernel.psd_frames_int8(iq, rate, fft, decim)
    want = psd_kernel.psd_frames_int8_plain(iq, rate, fft, decim)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == want.shape):
        raise RuntimeError("psd kernel: non-finite output or wrong shape")
    near = want >= want.amax(dim=1, keepdim=True) - 60.0
    diff = (got - want).abs()
    psd_max = diff[near].max().item()
    psd_med = diff[near].median().item()
    log(f"psd kernel vs plain [{rows}, {fft * decim}, 2] (fft {fft}, decim {decim}; {psd_form(fft)}): "
        f"max {psd_max:.3g} dB, median {psd_med:.3g} dB on bins within 60 dB of the peak; "
        f"all-bin max {diff.max().item():.3g} dB")
    if psd_max > PSD_TOL_DB or psd_med > PSD_MEDIAN_TOL_DB:
        raise RuntimeError(f"psd kernel disagrees at fft {fft}: max {psd_max} dB, median {psd_med} dB")
    return psd_max


def check_selection(fft: int, submargin: int, dev) -> float:
    """Selection kernel bit-exact against its plain version in bf16 and f32
    on CHECK_ROWS rows at one path's fft and submargin; returns 0.0."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel

    level = torch.tensor(LEVEL, device=dev)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        t = selection_rows(fft, dtype, dev)
        got = select_kernel.fused_selection(t, level, TOP_K, 16, submargin)
        want = select_kernel.fused_selection_plain(t, level, TOP_K, 16, submargin)
        torch.cuda.synchronize()
        for name, g, w in zip(("top_val", "top_idx", "sep_val", "sep_idx", "count"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise RuntimeError(f"selection kernel {dtype} {name} disagrees at fft {fft}: {bad}")
            err = max(err, (g.float() - w.float()).abs().max().item())
        log(f"selection kernel vs plain [{CHECK_ROWS}, {fft}] submargin {submargin} {dtype}: bit-exact")
    return err


def check_psd_and_selection(psd_geos, sel_geos, dev):
    """PSD and selection against their plain versions at every shape the
    paths give them (the PSD at the int8 paths', the selection at every
    path's, the wideband channels' included), the PSD at each of its forms'
    ends and the selection at its smallest table; returns the PSD's and the
    selection's max |diff|."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    psd_err = sel_err = 0.0
    for geo in psd_geos:
        cfg, _, _ = configs(geo)
        rows = geo.frames if geo.time_shards > 1 else CHECK_ROWS  # a time shard's frames
        psd_err = max(psd_err, check_psd(cfg.fft_size, cfg.decimator_factor, rows, gen, dev,
                                         float(cfg.sample_rate)))
    for fft, decim, rows in PSD_FORM_CASES:
        psd_err = max(psd_err, check_psd(fft, decim, rows, gen, dev))
    cases = {}
    for geo in sel_geos:
        cfg, _, group_size = configs(geo)
        cases.setdefault((cfg.fft_size, group_size // 2 + group_size % 2), None)
    for fft, submargin in list(cases) + list(SELECT_EXTRA_CASES):
        sel_err = max(sel_err, check_selection(fft, submargin, dev))
    return psd_err, sel_err


def time_psd_and_selection(geos, dev, card: str, psd_err: float, sel_err: float, sel_only=()) -> list:
    """PSD and selection timed at every path's shapes (the selection alone at
    ``sel_only``'s: the wideband channels reach the scan as f32 pairs, no
    PSD kernel): rows = bands x frames a block. The records' top level holds
    the first path's numbers, ``*_by_path`` every path's."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel, select_kernel
    from rtl_sdr_scanner_tpu_torch.ops.psd import shifted_window

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    psd = dict(
        name="psd_frames_int8", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/psd_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/psd_kernel.py:108", launches=None, max_abs_err=psd_err,
    )
    sel = dict(
        name="fused_selection", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/select_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/select_kernel.py:189", launches=None, max_abs_err=sel_err,
    )
    for geo in tuple(geos) + tuple(sel_only):
        cfg, _, group_size = configs(geo)
        fft, decim, rate = cfg.fft_size, cfg.decimator_factor, float(cfg.sample_rate)
        rows = geo.bands * geo.frames
        if geo in sel_only:
            time_selection(sel, geo, rows, fft, group_size, gen, dev, card)
            continue
        big = random_cs8((rows, fft * decim, 2), gen, dev)
        win = torch.from_numpy(shifted_window(fft)).to(dev)
        frames_c = torch.complex(big[:, :fft, 0].float() / 127.5, big[:, :fft, 1].float() / 127.5) * win
        t = timings(lambda: psd_kernel.psd_frames_int8(big, rate, fft, decim),
                    lambda: psd_kernel.psd_frames_int8_plain(big, rate, fft, decim), 20, "psd_", 5)
        library_ms = cuda_ms(lambda: torch.fft.fft(frames_c), 20)
        # int8 pairs of the selected frame in, f32 dB out; a radix FFT's operations
        bound_ms, bound_by = bound(rows * fft * (2 + 4), rows * 5 * fft * math.log2(fft))
        log(f"psd [{rows}, {fft * decim}, 2] ({geo.name}; {psd_form(fft)}): {fmt(t)}, torch.fft.fft alone "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) on {card}")
        record_time(psd, geo, **t, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        del big, frames_c
        time_selection(sel, geo, rows, fft, group_size, gen, dev, card)
    return [psd, sel]


def time_selection(sel: dict, geo: Geometry, rows: int, fft: int, group_size: int, gen, dev, card: str) -> None:
    from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel

    submargin = group_size // 2 + group_size % 2
    level = torch.tensor(LEVEL, device=dev)
    spec = torch.randn((rows, fft), generator=gen, device=dev).mul_(6.0).to(torch.bfloat16)
    t = timings(lambda: select_kernel.fused_selection(spec, level, TOP_K, 16, submargin),
                lambda: select_kernel.fused_selection_plain(spec, level, TOP_K, 16, submargin), 20,
                "selection_kernel", 3)
    bound_ms, bound_by = bound(rows * fft * 2 + rows * ((TOP_K + 16) * (2 + 4) + 4), 0.0)
    log(f"selection [{rows}, {fft}] bf16 ({geo.name}): {fmt(t)}, bound {bound_ms:.4f} ms ({bound_by}) "
        f"on {card}")
    record_time(sel, geo, **t, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def fmt(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms a call (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us), "
            f"plain {t['plain_ms']:.3f} ms")


def record_time(record: dict, geo: Geometry, **numbers) -> None:
    """Put one path's timings in a kernel's record: under ``<key>_by_path``
    for every path, and at the top level for the first path recorded."""
    for key, value in numbers.items():
        record.setdefault(key, value)
        record.setdefault(f"{key}_by_path", {})[geo.key] = value


def fir_cases(geos):
    """(geometry, plan, samples a row) of every stage a path sends through
    the FIR kernel, then FIR_EXTRA_M at 16384 outputs a row (no path)."""
    from rtl_sdr_scanner_tpu_torch.ops import ddc

    cases = [(geo, plan, n) for geo in geos for plan, n in fir_stages(configs(geo)[1], geo.time_shards)]
    return cases + [(None, ddc.plan_stage(1, m), 16384 * m) for m in FIR_EXTRA_M]


def check_fir(geos, dev) -> float:
    """The decimating FIR against its plain version at every stage a path
    sends through it, on its band x slot rows x 2 components (path 1: stage
    2 (1, 40) on 34,560 samples a chunk, 48 rows; path 2: (1, 75) on
    1,228,800, 48 rows; the session: the same stage on 4 rows; the wideband
    step: path 1's on 16 rows) and at FIR_EXTRA_M (48 rows; 151, 157 and 400
    in the wide form); returns the max |diff|."""
    from rtl_sdr_scanner_tpu_torch.ops import ddc
    from rtl_sdr_scanner_tpu_torch.ops.cuda import fir_kernel

    ddc.no_tf32()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    err = 0.0
    for geo, plan, n in fir_cases(geos):
        m = plan.decim
        rows = geo.bands * geo.slots if geo is not None else PATH2.bands * PATH2.slots
        x = torch.randn((rows, 2, n), generator=gen, device=dev)
        tail = torch.randn((rows, 2, plan.tail_len), generator=gen, device=dev)
        got, got_tail = fir_kernel.stage_apply_fir(x, tail, plan)
        want, want_tail = fir_kernel.stage_apply_fir_plain(x, tail, plan)
        torch.cuda.synchronize()
        d = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"fir kernel vs plain [{rows}, 2, {n}] M={m}: max |diff| {d:.3g} "
            f"({d / scale:.3g} of max |y|), tail {'exact' if torch.equal(got_tail, want_tail) else 'DIFFERS'}")
        if not (torch.isfinite(got).all() and d <= FIR_REL_TOL * scale and torch.equal(got_tail, want_tail)):
            raise RuntimeError(f"fir kernel disagrees at M={m}: max |diff| {d}, max |y| {scale}")
        err = max(err, d)
        del got, want, x, tail
    return err


def time_fir(geos, timed: Geometry, dev, card: str, err: float) -> dict:
    """Each path's FIR stage timed, with plain, library and bound beside
    it; the record's top level holds ``timed``'s."""
    import torch.nn.functional as F

    from rtl_sdr_scanner_tpu_torch.ops import ddc
    from rtl_sdr_scanner_tpu_torch.ops.cuda import fir_kernel

    ddc.no_tf32()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    times = {}
    for geo, plan, n in fir_cases(geos):
        if geo is None:
            continue
        rows = geo.bands * geo.slots
        m, out_len = plan.decim, n // plan.decim
        x = torch.randn((rows, 2, n), generator=gen, device=dev)
        tail = torch.randn((rows, 2, plan.tail_len), generator=gen, device=dev)
        t = timings(lambda: fir_kernel.stage_apply_fir(x, tail, plan),
                    lambda: fir_kernel.stage_apply_fir_plain(x, tail, plan), 20, "fir_decimate", 5)
        poly_rows = fir_kernel._full_rows(x, tail, m, plan.poly_rows).transpose(1, 2).contiguous()
        w = torch.from_numpy(plan.poly_kernel).to(dev)
        library_ms = cuda_ms(lambda: F.conv1d(poly_rows, w), 20)
        del poly_rows
        # x and the tail read once, y and the new tail written once, f32;
        # 2 operations per tap and output, three TF32 tensor-core passes
        bytes_moved = 4 * (rows * 2 * (n + 2 * plan.tail_len + out_len) + m * plan.poly_rows)
        flops = 3 * 2.0 * rows * 2 * out_len * plan.poly_rows * m
        bound_ms, bound_by = bound(bytes_moved, flops, TF32_FLOPS)
        log(f"fir [{rows}, 2, {n}] M={m} R={plan.poly_rows} ({geo.name}): {fmt(t)}, F.conv1d on the "
            f"polyphase view {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {bytes_moved / 1e6:.1f} "
            f"MB, {flops / 1e9:.2f} GFLOP TF32) on {card}")
        times[geo.key] = (geo, dict(**t, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
        del x, tail
    record = dict(
        name="stage_apply_fir", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/fir_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/fir_kernel.py:98", launches=None, max_abs_err=err,
    )
    for key in sorted(times, key=lambda k: k != timed.key):  # the timed path first: the top level
        geo, numbers = times[key]
        record_time(record, geo, **numbers)
    return record


class MainPath:
    """One geometry at full width: configs, the step with default Tunables,
    a ring of synthetic cs8 on the card, and the carried state."""

    def __init__(self, dev, geo: Geometry):
        from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, fused_step, scan_pipeline

        self.dev, self.geo = dev, geo
        self.cfg, self.ddc_cfg, self.group_size = configs(geo)
        cfg = self.cfg
        self.step = fused_step.make_banded_fused_step(cfg, self.ddc_cfg, self.group_size, TOP_K, device=dev)
        t0 = time.perf_counter()
        self.ring = make_ring(geo, cfg, dev)
        log(f"ring: {geo.blocks} blocks of [{geo.bands}, {geo.frames}, {cfg.fft_size * cfg.decimator_factor}, 2] "
            f"int8 on the card in {time.perf_counter() - t0:.1f} s")
        self.state = [
            scan_pipeline.init_scan_state(cfg, geo.bands, 0, device=dev),
            scan_pipeline.init_spectro_acc(cfg, geo.bands, device=dev),
            ddc_pipeline.init_state(self.ddc_cfg, geo.bands, device=dev),
        ]
        shifts = np.tile(np.array([geo.signal_offset_hz, geo.other_shift], dtype=np.int64), (geo.bands, 1))
        self.tables = ddc_pipeline.make_tables(self.ddc_cfg, shifts, device=dev)
        self.shared = [
            torch.full((KEY_SLOTS,), -1, dtype=torch.int32, device=dev),  # keys
            torch.ones(cfg.fft_size, dtype=torch.bool, device=dev),  # valid mask
            torch.tensor(LEVEL, device=dev),  # start level
            torch.tensor(1.0, device=dev),  # spectro keep
        ]

    def now(self, b: int) -> torch.Tensor:
        f = self.geo.frames
        ms = (b * f + 1 + np.arange(f)) * self.cfg.frame_interval_ms
        return torch.from_numpy(ms.astype(np.int32)).to(self.dev).expand(self.geo.bands, f).contiguous()

    def run_block(self, b: int):
        """One block through the step (ring slot b % blocks); returns FusedOutputs."""
        *self.state, outs = self.step(
            *self.state, self.ring[b % self.geo.blocks], self.now(b), *self.shared, self.tables
        )
        return outs


def kernel_wrappers() -> dict:
    from rtl_sdr_scanner_tpu_torch.ops.cuda import fir_kernel, psd_kernel, select_kernel

    return {
        "psd_frames_int8": psd_kernel.psd_frames_int8,
        "fused_selection": select_kernel.fused_selection,
        "stage_apply_fir": fir_kernel.stage_apply_fir,
    }


def run_path(dev, card: str, geo: Geometry) -> dict:
    """Drive one geometry for geo.blocks blocks with the launch counts set to
    0 just before; check the counts (PSD and selection once a block, the FIR
    once a chunk for each stage it takes), then what came out; return the
    counts."""
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline

    log(f"---- {geo.name}")
    path = MainPath(dev, geo)
    cfg, ddc_cfg, group_size = path.cfg, path.ddc_cfg, path.group_size
    log(f"fft {cfg.fft_size} decim {cfg.decimator_factor} frames {geo.frames}, DDC stages "
        f"{[(p.interp, p.decim) for p in ddc_cfg.plans]} ({'modulated taps' if ddc_cfg.modtap else 'v1'}), "
        f"{ddc_cfg.num_chunks} chunks of {ddc_cfg.chunk}, group {group_size}")
    wrappers = kernel_wrappers()
    packed, block_ms = [], []
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    for b in range(geo.blocks):
        t0 = time.perf_counter()
        outs = path.run_block(b)
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        packed.append(outs.packed.cpu().numpy())
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"launches over {geo.blocks} blocks: {launches}")
    want_launches = {
        "psd_frames_int8": 1,
        "fused_selection": 1,
        "stage_apply_fir": ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
    }
    for name, per_block in want_launches.items():
        if launches[name] != per_block * geo.blocks:
            raise RuntimeError(f"{name} launched {launches[name]} times in {geo.blocks} blocks")

    # ---- what came out is right
    rec = outs.recording
    want_shape = (geo.bands, geo.slots, ddc_cfg.out_per_block, 2)
    if tuple(rec.shape) != want_shape or rec.dtype != torch.int8:
        raise RuntimeError(f"recording {tuple(rec.shape)} {rec.dtype}, want {want_shape} int8")
    if not rec.any() or not rec[geo.signal_band, 0].any():
        raise RuntimeError("recording is all zero where the signal is")
    planted = cfg.fft_size // 2 + round(geo.signal_offset_hz / cfg.step_hz)
    hits = {}
    for b in range(geo.signal_from_block, geo.blocks):
        for band in range(geo.bands):
            out = scan_pipeline.unpack_compact(packed[b][band], geo.frames, TOP_K, KEY_SLOTS)
            cand_idx, cand_val, _, cand_count, _, _, ready = out
            if not np.isfinite(packed[b][band]).all() or not ready:
                raise RuntimeError(f"block {b} band {band}: non-finite output or noise not learned")
            live = cand_val >= LEVEL
            if live.any():
                hits.setdefault(band, []).append(np.abs(cand_idx[live] - planted).min())
    log(f"bands with candidates above {LEVEL} dB in blocks {geo.signal_from_block}..{geo.blocks - 1}: "
        f"{ {k: int(min(v)) for k, v in hits.items()} } (bins from the planted {planted})")
    if set(hits) != {geo.signal_band} or min(hits[geo.signal_band]) > group_size:
        raise RuntimeError(f"planted signal not detected in band {geo.signal_band} only: {hits}")
    power = rec.float().square().sum(dim=-1).mean(dim=-1)  # [bands, slots]
    quiet = (geo.signal_band + 1) % geo.bands
    gain_db = 10 * math.log10(power[geo.signal_band, 0].item() / max(power[quiet, 0].item(), 1e-3))
    log(f"recording {want_shape} int8: slot 0 power {power[geo.signal_band, 0].item():.1f} in band "
        f"{geo.signal_band}, {power[quiet, 0].item():.3g} in quiet band {quiet} ({gain_db:.1f} dB apart)")
    if gain_db < 10.0:
        raise RuntimeError(f"signal slot only {gain_db:.1f} dB above a quiet band's")

    steady = block_ms[1:]
    ms = float(np.mean(steady))
    rate = geo.bands * cfg.block_samples / (ms / 1e3)
    log(f"{geo.name}: {ms:.1f} ms per block (blocks 1..{geo.blocks - 1}; first {block_ms[0]:.1f} ms), "
        f"{rate / 1e6:.1f} M samples/s through scan + {geo.slots}-slot DDC at {geo.bands} bands "
        f"(real time {geo.bands * geo.rate / 1e6:.1f} M), on {card}")
    del path
    torch.cuda.empty_cache()
    return launches


def check_interpolating_stages(dev) -> None:
    """DDC only, 4 bands x 2 slots, 2 chunks: chains with an interpolating
    stage on the card against the same calls on the CPU, within 1 LSB."""
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline

    cpu = torch.device("cpu")
    for rate, chunk in ((2_000_000, 125 * 8192), (10_000_000, 625 * 1024)):
        cfg = ddc_pipeline.DdcConfig.create(rate, 32_000, 2, 2 * chunk, chunk_target=chunk)
        shifts = np.array([[250_000, -400_000]] * 4, dtype=np.int64) + np.arange(4)[:, None] * 1_000
        gen = np.random.default_rng(rate // 1000)
        iq = torch.from_numpy(gen.integers(-100, 100, size=(4, cfg.block_samples, 2), dtype=np.int8))
        outs = []
        for d in (cpu, dev):
            state = ddc_pipeline.init_state(cfg, 4, device=d)
            tables = ddc_pipeline.make_tables(cfg, shifts, device=d)
            _, out = ddc_pipeline._ddc_block_banded(cfg, state, iq.to(d), tables)
            outs.append(out.cpu().numpy().astype(np.int32))
        diff = np.abs(outs[1] - outs[0])
        log(f"{rate / 1e6:g} Msps -> 32 kHz, stages {[(p.interp, p.decim) for p in cfg.plans]} "
            f"({'modulated taps' if cfg.modtap else 'v1'}), out {outs[1].shape}: card vs CPU "
            f"max {diff.max()} LSB, {(diff > 0).mean():.2%} of samples differ")
        if diff.max() > 1 or not outs[1].any():
            raise RuntimeError(f"interpolating chain at {rate}: card and CPU differ by {diff.max()} LSB")


def write_capture(path: Path, rate: int, seconds: float, shift, key, seed: int = 5) -> None:
    """cs8 capture: 0.01 rms complex noise and, while key[0] <= t < key[1],
    a 0.4-amplitude FM signal at ``shift`` Hz (an RT_TONE Hz tone at 3 kHz
    deviation: band-wide, as the 21-bin smoothing needs), one second at a
    time. ``shift`` may instead be a list of (shift, tone) signals."""
    signals = [(shift, RT_TONE)] if np.isscalar(shift) else list(shift)
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    with open(path, "wb") as f:
        for s0 in range(0, n, rate):
            t = (s0 + np.arange(min(rate, n - s0))) / rate
            x = 0.01 * (rng.standard_normal(t.size) + 1j * rng.standard_normal(t.size))
            for sig_shift, tone in signals:
                phase = 2 * np.pi * sig_shift * t + (3000.0 / tone) * (1 - np.cos(2 * np.pi * tone * t))
                x += 0.4 * np.exp(1j * phase) * ((t >= key[0]) & (t < key[1]))
            pairs = np.stack([x.real, x.imag], axis=-1) * 127.0
            np.clip(np.round(pairs), -128, 127).astype(np.int8).tofile(f)


def runtime_config(capture: Path, rate: int, center: int, channels: int = 0, **tunables) -> dict:
    """One replay device parked on one range (width <= the hop split rate;
    with ``channels`` >= 2 a wideband device over the whole capture), 4
    recorder slots, the reference's recording defaults (32 kHz), logs at
    warn on the console only."""
    half = rate // 2 if channels >= 2 else 1_000_000 if rate >= 2_000_000 else 100_000
    return {
        "devices": [{
            "enabled": True, "serial": "replay0", "driver": "replay", "sample_rate": rate,
            "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
            "ranges": [{"start": center - half, "stop": center + half}],
            "file": str(capture), "file_format": "cs8", "channels": channels,
        }],
        "ignored_frequencies": [],
        "output": {"color_log_enabled": False, "console_log_level": "warn", "file_log_level": "warn"},
        "recording": {"max_noise_time_ms": 2000, "min_sample_rate": 32000, "min_time_ms": 2000, "step": 2500},
        "tunables": {"log_file_name": "", **tunables},
        "version": 2,
        "workers": 4,
    }


def compare_payloads(want: list, got: list) -> dict:
    """Two MQTT payload streams [(topic, bytes)]: the same topics in the same
    order, equal transmission and spectrogram headers, IQ within 1 LSB and
    spectrogram bins within 1. Raises AssertionError where they differ;
    returns counts and the largest differences."""
    from rtl_sdr_scanner_tpu_torch.runtime.data_controller import decode_spectrogram, decode_transmission

    assert [t for t, _ in got] == [t for t, _ in want], "payload topics or their order differ"
    stats = dict(payloads=len(want), transmissions=0, iq_samples=0, iq_differ=0, iq_max_lsb=0, spectro_max=0)
    for i, ((topic, a), (_, b)) in enumerate(zip(want, got)):
        if topic.endswith("/transmission/uint8"):
            ha, hb = decode_transmission(a), decode_transmission(b)
            assert ha[:4] == hb[:4] and ha[4].shape == hb[4].shape, f"payload {i}: header {ha[:4]} != {hb[:4]}"
            d = np.abs(ha[4].astype(np.int32) - hb[4].astype(np.int32))
            stats["transmissions"] += 1
            stats["iq_samples"] += d.size
            stats["iq_differ"] += int((d > 0).sum())
            stats["iq_max_lsb"] = max(stats["iq_max_lsb"], int(d.max(initial=0)))
        else:
            ha, hb = decode_spectrogram(a), decode_spectrogram(b)
            assert ha[:4] == hb[:4], f"payload {i}: spectrogram header {ha[:4]} != {hb[:4]}"
            d = np.abs(ha[4].astype(np.int32) - hb[4].astype(np.int32))
            stats["spectro_max"] = max(stats["spectro_max"], int(d.max(initial=0)))
    assert stats["iq_max_lsb"] <= 1, f"IQ differs by {stats['iq_max_lsb']} LSB"
    assert stats["spectro_max"] <= 1, f"spectrogram bins differ by {stats['spectro_max']}"
    return stats


def recorded_tone(payloads: list, frequency: int, rate: int, step: int = 2500):
    """(recording center, its sample count, the FM-demodulated tone in Hz) of
    the most-recorded transmission within one tuning step of ``frequency``."""
    from rtl_sdr_scanner_tpu_torch.runtime.data_controller import decode_transmission

    by_center = {}
    for topic, p in payloads:
        if topic.endswith("/transmission/uint8"):
            _, start, stop, r, iq = decode_transmission(p)
            assert r == rate, f"transmission at {r} Hz, want {rate}"
            by_center.setdefault((start + stop) // 2, []).append(iq)
    near = [c for c in by_center if abs(c - frequency) <= step]
    assert near, f"no transmission within {step} Hz of {frequency}: {sorted(by_center)}"
    center = max(near, key=lambda c: sum(len(x) for x in by_center[c]))
    iq = np.concatenate(by_center[center])
    z = iq[:, 0].astype(np.float32) + 1j * iq[:, 1].astype(np.float32)
    z = z[len(z) // 4 :]
    d = np.angle(z[1:] * np.conj(z[:-1]))
    sp = np.abs(np.fft.rfft(d - d.mean()))
    return center, len(iq), float(np.argmax(sp) / len(d) * rate)


class SessionTimer:
    """Times a session's blocks: CUDA events around each scan and DDC
    dispatch (device ms), the host clock around each synchronised
    ``process_block`` (wall ms); host ms = wall - device."""

    def __init__(self, session):
        self.block = 0
        self.spans = []  # (block, start event, end event)
        self.walls = []
        self.ddc_calls = 0
        for name in ("_scan_step", "_ddc_step"):
            setattr(session, name, self._timed(getattr(session, name), name == "_ddc_step"))
        process = session.process_block

        def process_block(*args, **kwargs):
            t0 = time.perf_counter()
            out = process(*args, **kwargs)
            torch.cuda.synchronize()
            self.walls.append((time.perf_counter() - t0) * 1e3)
            self.block += 1
            return out

        session.process_block = process_block

    def _timed(self, fn, is_ddc: bool):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.spans.append((self.block, start, end))
            self.ddc_calls += is_ddc
            return out

        return call

    def device_ms(self) -> list:
        torch.cuda.synchronize()
        per_block = [0.0] * max(self.block, 1)
        for b, start, end in self.spans:
            per_block[min(b, len(per_block) - 1)] += start.elapsed_time(end)
        return per_block


def run_scanner(config: dict, device, timer: bool = False):
    """One replay scan through ``Scanner.run_to_completion()``: (payloads,
    session, wall seconds, SessionTimer or None)."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner

    cfg = Config(json.loads(json.dumps(config)))
    mqtt = NullMqtt()
    mqtt.keep_payloads = True
    scanner = Scanner(cfg, cfg.devices[0], mqtt, cfg.recorders_count(), device=device)
    clock = SessionTimer(scanner.device) if timer else None
    t0 = time.perf_counter()
    scanner.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return mqtt.published, scanner.device, time.perf_counter() - t0, clock


def run_main(config_path: Path, device=None, timeout_s: float = 300.0, scanners: int = 1):
    """``runtime.main.run(config)`` on a worker thread, as a user runs it;
    stopped through ``main._is_running`` once its ``scanners`` scanners
    (``Scanner`` or ``WidebandScanner``, a thread each) have drained their
    replays. Returns (rc, payloads)."""
    from rtl_sdr_scanner_tpu_torch.runtime import main as rt_main
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt

    made, mqtts, result = [], [], []
    real = {name: getattr(rt_main, name) for name in ("Scanner", "WidebandScanner", "make_mqtt")}

    def watched(cls):
        class Watched(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        return Watched

    def make_mqtt(config):
        mqtt = NullMqtt()
        mqtt.keep_payloads = True
        mqtts.append(mqtt)
        return mqtt

    rt_main.Scanner, rt_main.WidebandScanner = watched(real["Scanner"]), watched(real["WidebandScanner"])
    rt_main.make_mqtt = make_mqtt
    rt_main._is_running = True
    worker = threading.Thread(target=lambda: result.append(rt_main.run(str(config_path), device)), daemon=True)
    try:
        worker.start()
        deadline = time.time() + timeout_s
        drained = lambda: len(made) == scanners and all(
            s._thread is not None and not s._thread.is_alive() for s in made)
        while worker.is_alive() and not drained() and time.time() < deadline:
            time.sleep(0.05)
        if not drained():
            raise RuntimeError(f"main.run: the scanners did not drain the replay in {timeout_s} s")
    finally:
        rt_main._is_running = False
        worker.join(timeout=60)
        for name, value in real.items():
            setattr(rt_main, name, value)
    if worker.is_alive() or not result:
        raise RuntimeError("main.run did not return after main._is_running was cleared")
    if any(s.failed for s in made):
        raise RuntimeError("main.run: a scanner thread failed")
    return result[0], mqtts[0].published


def run_runtime(dev, card: str) -> dict:
    """The runtime phase (docstring step 6); returns the kernels' launch
    counts of its card run."""
    log("---- runtime session (Scanner / main.run)")
    wrappers = kernel_wrappers()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rt_") as tmp:
        capture = Path(tmp) / "capture.cs8"
        write_capture(capture, RT_RATE, RT_SECONDS, RT_SHIFT, RT_KEY)
        config = runtime_config(capture, RT_RATE, RT_CENTER)

        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        card_payloads, session, wall_s, clock = run_scanner(config, dev, timer=True)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        cfg, ddc_cfg = session.scan_cfg, session.ddc_cfg
        blocks = clock.block
        log(f"fft {cfg.fft_size} decim {cfg.decimator_factor} frames {cfg.frames_per_block} a block, "
            f"{ddc_cfg.num_slots} slots, DDC stages {[(p.interp, p.decim) for p in ddc_cfg.plans]}, "
            f"{ddc_cfg.num_chunks} chunks; {blocks} blocks, DDC dispatched in {clock.ddc_calls}")
        log(f"launches over the card run: {launches}")
        want = {
            "psd_frames_int8": blocks,
            "fused_selection": blocks,
            "stage_apply_fir": clock.ddc_calls * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
        }
        if launches != want or not all(launches.values()):
            raise RuntimeError(f"session launches {launches}, want {want} (all > 0)")

        cpu_payloads, _, cpu_s, _ = run_scanner(config, torch.device("cpu"))
        stats = compare_payloads(cpu_payloads, card_payloads)
        log(f"card vs CPU payloads: {stats} (CPU run {cpu_s:.1f} s)")
        center, n_rec, tone = recorded_tone(card_payloads, RT_CENTER + RT_SHIFT, 32_000)
        log(f"recorded {n_rec} samples at {center} Hz (planted {RT_CENTER + RT_SHIFT}), "
            f"FM-demodulated tone {tone:.1f} Hz (planted {RT_TONE})")
        if abs(tone - RT_TONE) >= 40 or n_rec < 2 * 32_000:
            raise RuntimeError(f"the planted transmission was not recorded: {n_rec} samples, tone {tone} Hz")

        config_path = Path(tmp) / "config.json"
        config_path.write_text(json.dumps(config))
        rc, main_payloads = run_main(config_path)
        if rc != 0:
            raise RuntimeError(f"main.run returned {rc}")
        main_stats = compare_payloads(card_payloads, main_payloads)
        log(f"main.run: rc {rc}, {main_stats['payloads']} payloads, as the card's Scanner run")

        stream_s = blocks * cfg.block_samples / cfg.sample_rate
        device = clock.device_ms()
        steady = slice(1, None)
        wall_ms = float(np.mean(clock.walls[steady]))
        device_ms = float(np.mean(device[steady]))
        log(f"runtime serial: {wall_ms:.2f} ms per block (blocks 1..{blocks - 1}; first {clock.walls[0]:.1f}), "
            f"device {device_ms:.2f} ms (CUDA events around the dispatches: the span includes the card's "
            f"waits for launches), host {wall_ms - device_ms:.2f} ms; real-time factor "
            f"{stream_s / wall_s:.2f} ({stream_s:.3f} s of stream in {wall_s:.3f} s, {blocks} blocks of "
            f"{cfg.block_samples / cfg.sample_rate * 1e3:.1f} ms) on {card}")
        log(f"runtime serial, per block: wall {[round(w, 2) for w in clock.walls]} ms, device "
            f"{[round(d, 2) for d in device]} ms")

        piped = runtime_config(capture, RT_RATE, RT_CENTER, pipelined_ingest=True)
        piped_payloads, _, piped_s, piped_clock = run_scanner(piped, dev, timer=True)
        piped_device = float(np.sum(piped_clock.device_ms()))
        n = sum(1 for t, _ in piped_payloads if t.endswith("/transmission/uint8"))
        log(f"runtime pipelined_ingest: real-time factor {stream_s / piped_s:.2f} ({stream_s:.3f} s of "
            f"stream in {piped_s:.3f} s), device {piped_device / blocks:.2f} ms per block, {n} "
            f"transmission payloads (serial {stats['transmissions']}) on {card}")
    return launches


def fm_wide(freq: int, rate: int, start: int, n: int, dev) -> torch.Tensor:
    """[n, 2] f32 FM at ``freq`` Hz of a ``rate`` stream (800 Hz tone, 3 kHz
    deviation, 0.4 amplitude, cs8 units), sample ``start`` on; the carrier's
    phase from int64 sample arithmetic, exact at any length."""
    idx = torch.arange(start, start + n, device=dev, dtype=torch.int64)
    carrier = (idx * freq) % rate
    audio = (idx * int(RT_TONE)) % rate
    phase = 2 * math.pi * carrier.double() / rate + (3000.0 / RT_TONE) * (
        1 - torch.cos(2 * math.pi * audio.double() / rate))
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1).float() * (0.4 * 127.0)


class WidebandStep:
    """bench.py's wideband app path at full width on the card: the
    channelizer, every channel's compact scan and their 2-slot modulated-taps
    DDC, fused in one dispatch or split in two, over a device-resident ring
    of WIDE_RING int8 wideband blocks (block 0 noise, block 1 noise and an
    FM signal in channel ``signal_band``), on a band mesh of ``shards``
    copies of the card or of the cards ``devices`` names
    (``parallel/sharded_scan``'s per-shard lists: the channelizer runs on
    every shard, each keeps its own channels)."""

    def __init__(self, dev, geo: Geometry, fused: bool, ring: list, shards: int = 1, devices=None):
        from rtl_sdr_scanner_tpu_torch.constants import Tunables
        from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, scan_pipeline
        from rtl_sdr_scanner_tpu_torch.ops.channelizer import init_channelizer_state, plan_channelizer
        from rtl_sdr_scanner_tpu_torch.parallel import mesh, sharded_scan as ss

        self.dev, self.geo, self.fused, self.ring = dev, geo, fused, ring
        cfg = scan_pipeline.ScanConfig.create(geo.rate, geo.frames, Tunables(noise_learning_time_ms=WIDE_LEARN_MS))
        ddc_cfg = ddc_pipeline.DdcConfig.create(geo.rate, geo.bandwidth, geo.slots, cfg.block_samples)
        self.cfg, self.ddc_cfg = cfg, ddc_cfg
        self.group_size = int(np.ceil(geo.bandwidth / cfg.step_hz))
        b = geo.bands
        plan = plan_channelizer(b)
        devices = list(devices) if devices else [dev] * shards  # distinct cards, or copies of one
        m = self.mesh = mesh.make_mesh(len(devices), 1, devices=devices)
        if fused:
            self.step = ss.make_sharded_wideband_fused_step(cfg, ddc_cfg, self.group_size, TOP_K, m, plan, 1, b)
        else:
            self.wide_step = ss.make_sharded_wideband_step(cfg, self.group_size, TOP_K, m, plan, 1, b)
            self.ddc_step = ss.make_sharded_banded_ddc(ddc_cfg, m, b)
        self.chan = ss.replicate(init_channelizer_state(plan, dev), m)
        self.scan = ss.init_banded_state(cfg, b, m)
        self.acc = ss.shard_bands(torch.zeros((b, cfg.spectro_size), dtype=torch.float32, device=dev), m)
        self.ddc = ss.init_banded_ddc_state(ddc_cfg, b, m)
        shifts = np.tile(np.array([geo.signal_offset_hz, geo.other_shift], dtype=np.int64), (b, 1))
        self.tables = ss.shard_bands(ddc_pipeline.make_tables(ddc_cfg, shifts, device=dev), m)
        self.keys = ss.shard_bands(torch.full((b, KEY_SLOTS), -1, dtype=torch.int32, device=dev), m)
        self.valid = ss.shard_bands(torch.ones((b, cfg.fft_size), dtype=torch.bool, device=dev), m)
        self.level = ss.replicate(torch.tensor(LEVEL, device=dev), m)
        self.keep_mask = ss.shard_bands(torch.ones((b, geo.slots), dtype=torch.float32, device=dev), m)

    def run_block(self, blk: int):
        """One block (ring slot blk % WIDE_RING); returns (packed, rec), all
        channels' rows gathered on the card."""
        from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss

        f = self.geo.frames
        now = torch.from_numpy(((blk * f + 1 + np.arange(f)) * self.cfg.frame_interval_ms).astype(np.int32))
        now = ss.replicate(now.to(self.dev), self.mesh)
        x = ss.replicate(self.ring[blk % WIDE_RING], self.mesh)
        if self.fused:
            self.chan, self.scan, self.acc, self.ddc, packed, rec, _ = self.step(
                self.chan, self.scan, self.acc, self.ddc, x, now, self.keys, self.valid, self.level, 1.0,
                self.tables, self.keep_mask)
        else:
            self.chan, self.scan, self.acc, packed, channels = self.wide_step(
                self.chan, self.scan, self.acc, x, now, self.keys, self.valid, self.level, 1.0)
            self.ddc, rec = self.ddc_step(self.ddc, channels, self.tables, self.keep_mask)
        return ss.gather_bands(packed, self.dev), ss.gather_bands(rec, self.dev)


def wide_ring(geo: Geometry, block_samples: int, dev) -> list:
    """WIDE_RING wideband blocks [bands * block_samples, 2] int8 on the card:
    noise, and in block 1 an FM signal at channel signal_band's center plus
    the signal offset (channel b is centered at b * rate of the stream)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, wide_rate = geo.bands * block_samples, geo.bands * geo.rate
    ring = []
    for b in range(WIDE_RING):
        block = noise_cs8(n, gen, dev)
        if b == 1:
            x = block.float() + fm_wide(geo.signal_band * geo.rate + geo.signal_offset_hz, wide_rate, 0, n, dev)
            block = torch.clamp(torch.round(x), -128, 127).to(torch.int8)
            del x
        ring.append(block)
    torch.cuda.synchronize()
    return ring


def fm_tone(rec: np.ndarray, rate: int) -> float:
    """The FM-demodulated tone (Hz) of int8 IQ [n, 2] at ``rate``."""
    z = rec[:, 0].astype(np.float32) + 1j * rec[:, 1].astype(np.float32)
    z = z[len(z) // 4 :]
    d = np.angle(z[1:] * np.conj(z[:-1]))
    sp = np.abs(np.fft.rfft(d - d.mean()))
    return float(np.argmax(sp) / len(d) * rate)


def check_channelizer(ring: list, geo: Geometry, dev) -> float:
    """The channelizer on the card against the same calls on the CPU, over
    two streamed halves of WIDE_CHECK_SAMPLES of the signal block: within
    CHAN_TOL (atol = rtol); returns the max |diff|."""
    from rtl_sdr_scanner_tpu_torch.ops.channelizer import (
        channelize_block_pairs, init_channelizer_state, plan_channelizer)

    plan = plan_channelizer(geo.bands)
    x = ring[1][:WIDE_CHECK_SAMPLES]
    half = WIDE_CHECK_SAMPLES // 2
    outs = []
    for d in (torch.device("cpu"), dev):
        state, parts = init_channelizer_state(plan, d), []
        for i in range(2):
            state, ch = channelize_block_pairs(plan, state, x[i * half : (i + 1) * half].to(d))
            parts.append(ch.cpu())
        outs.append(torch.cat(parts, dim=1))
    want, got = outs
    diff = (got - want).abs()
    err = diff.max().item()
    log(f"channelizer [{WIDE_CHECK_SAMPLES}, 2] int8 -> {list(got.shape)} B={geo.bands}, card vs CPU in two "
        f"blocks: max |diff| {err:.3g} (max |y| {want.abs().max().item():.3g})")
    if not (torch.isfinite(got).all() and bool((diff <= CHAN_TOL + CHAN_TOL * want.abs()).all())):
        raise RuntimeError(f"channelizer: card and CPU differ by {err}")
    return err


def run_wideband_step(dev, card: str) -> dict:
    """The wideband step phase (docstring step 6): the channelizer held card
    vs CPU, then the fused and the split forms for WIDE.blocks blocks each,
    each with the launch counts set to 0 just before and read just after;
    returns {form: counts}."""
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline

    geo = WIDE
    log(f"---- {geo.name}")
    cfg = scan_pipeline.ScanConfig.create(geo.rate, geo.frames)
    t0 = time.perf_counter()
    ring = wide_ring(geo, cfg.block_samples, dev)
    n_wide = geo.bands * cfg.block_samples
    log(f"ring: {WIDE_RING} blocks of [{n_wide}, 2] int8 ({n_wide * 2 / 1e6:.0f} MB each) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    check_channelizer(ring, geo, dev)
    wrappers = kernel_wrappers()
    launches = {}
    for fused in (True, False):
        form = "fused" if fused else "split"
        step = WidebandStep(dev, geo, fused, ring)
        cfg, ddc_cfg = step.cfg, step.ddc_cfg
        if fused:
            log(f"fft {cfg.fft_size} decim {cfg.decimator_factor} frames {geo.frames} a channel, {geo.bands} "
                f"channels, DDC stages {[(p.interp, p.decim) for p in ddc_cfg.plans]}, {ddc_cfg.num_chunks} "
                f"chunks, group {step.group_size}, noise learning {WIDE_LEARN_MS} ms")
        block_ms, packed = [], []
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        for b in range(geo.blocks):
            t0 = time.perf_counter()
            p, rec = step.run_block(b)
            torch.cuda.synchronize()
            block_ms.append((time.perf_counter() - t0) * 1e3)
            packed.append(p.cpu().numpy())
            if b % WIDE_RING == 1:
                signal_rec = rec.cpu().numpy()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        want = {"psd_frames_int8": 0, "fused_selection": geo.blocks,
                "stage_apply_fir": geo.blocks * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg))}
        log(f"{form}: launches over {geo.blocks} blocks: {counts} (the channels are f32 pairs: no PSD kernel)")
        if counts != want:
            raise RuntimeError(f"wideband {form} launches {counts}, want {want}")
        launches[f"wideband_step_{form}"] = counts

        planted = cfg.fft_size // 2 + round(geo.signal_offset_hz / cfg.step_hz)
        hits = {}
        for b in range(geo.blocks):
            for band in range(geo.bands):
                out = scan_pipeline.unpack_compact(packed[b][band], geo.frames, TOP_K, KEY_SLOTS)
                cand_idx, cand_val, _, _, _, _, ready = out
                if not np.isfinite(packed[b][band]).all() or not ready:
                    raise RuntimeError(f"block {b} channel {band}: non-finite output or noise not learned")
                live = cand_val >= LEVEL
                if live.any():
                    hits.setdefault(band, set()).add(b)
                    if band == geo.signal_band and np.abs(cand_idx[live] - planted).min() > step.group_size:
                        raise RuntimeError(f"block {b}: detection away from the planted bin {planted}")
        # the signal's blocks, and the averager's 21 rows carry it into the next
        signal_blocks = {b for b in range(geo.blocks) if b % WIDE_RING == 1}
        log(f"{form}: channels with candidates above {LEVEL} dB: { {k: sorted(v) for k, v in hits.items()} } "
            f"(signal in blocks {sorted(signal_blocks)})")
        if set(hits) != {geo.signal_band} or not signal_blocks <= hits[geo.signal_band]:
            raise RuntimeError(f"planted signal not detected in channel {geo.signal_band} only: {hits}")
        power = (signal_rec.astype(np.float32) ** 2).sum(axis=-1).mean(axis=-1)  # [bands, slots]
        quiet = (geo.signal_band + 1) % geo.bands
        gain_db = 10 * math.log10(power[geo.signal_band, 0] / max(power[quiet, 0], 1e-3))
        tone = fm_tone(signal_rec[geo.signal_band, 0], geo.bandwidth)
        log(f"{form}: recording {list(signal_rec.shape)} int8, slot 0 of channel {geo.signal_band} "
            f"{gain_db:.1f} dB above channel {quiet}'s, FM-demodulates to {tone:.1f} Hz (planted {RT_TONE})")
        if gain_db < 10.0 or abs(tone - RT_TONE) >= 40:
            raise RuntimeError(f"wideband {form}: the signal slot is {gain_db:.1f} dB up, tone {tone} Hz")
        ms = float(np.mean(block_ms[1:]))
        log(f"wideband {form}: {ms:.1f} ms per block (blocks 1..{geo.blocks - 1}; first {block_ms[0]:.1f} ms; "
            f"{cfg.block_samples / cfg.sample_rate * 1e3:.0f} ms of stream), {n_wide / (ms / 1e3) / 1e6:.1f} M "
            f"wideband samples/s (real time {geo.bands * geo.rate / 1e6:.2f} M) on {card}")
        del step
        torch.cuda.empty_cache()
    del ring
    torch.cuda.empty_cache()
    return launches


class WidebandTimer(SessionTimer):
    """SessionTimer for a WidebandScanner: CUDA events around each dispatch
    (serial: the channelizer and every session's scan and DDC; batched: the
    wideband step, the fused step or the banded DDC), the host clock around
    each synchronised ``step`` that processed a block."""

    def __init__(self, scanner):
        self.block = 0
        self.spans, self.walls, self.ddc_calls = [], [], 0
        targets = [(scanner, "_channelize")]
        for session in scanner.sessions:
            targets += [(session, "_scan_step"), (session, "_ddc_step")]
        targets += [(scanner, n) for n in ("_wide_step", "_fused_step", "_ddc_band_step")
                    if getattr(scanner, n, None) is not None]
        for obj, name in targets:
            setattr(obj, name, self._timed(getattr(obj, name), "ddc" in name))
        step = scanner.step

        def timed_step():
            t0 = time.perf_counter()
            more = step()
            torch.cuda.synchronize()
            if more:
                self.walls.append((time.perf_counter() - t0) * 1e3)
                self.block += 1
            return more

        scanner.step = timed_step


def run_wideband_scanner(config: dict, device, timer: bool = False):
    """One replay scan through ``WidebandScanner.run_to_completion()`` and
    ``stop()``: (payloads, scanner, wall seconds, WidebandTimer or None)."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner

    cfg = Config(json.loads(json.dumps(config)))
    mqtt = NullMqtt()
    mqtt.keep_payloads = True
    scanner = WidebandScanner(cfg, cfg.devices[0], mqtt, cfg.recorders_count(), device=device)
    clock = WidebandTimer(scanner) if timer else None
    t0 = time.perf_counter()
    scanner.run_to_completion()
    scanner.stop()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return mqtt.published, scanner, time.perf_counter() - t0, clock


def check_wideband_recordings(payloads: list) -> list:
    """Both planted transmissions recorded at their frequencies and
    FM-demodulating to their tones; returns [(center, samples, tone)]."""
    found = []
    for shift, tone in WB_SIGNALS:
        center, n_rec, got = recorded_tone(payloads, WB_CENTER + shift, 32_000)
        if abs(got - tone) >= 40 or n_rec < 2 * 32_000:
            raise RuntimeError(f"the transmission at +{shift} Hz was not recorded: {n_rec} samples, tone {got} Hz")
        found.append((center, n_rec, round(got, 1)))
    return found


def run_wideband_runtime(dev, card: str) -> dict:
    """The wideband session phase (docstring step 8): each form on the card
    (launch counts set to 0 just before, read just after) and on the CPU,
    payloads compared; main.run on the serial config. Returns {form: counts}."""
    log("---- wideband session (WidebandScanner / main.run)")
    wrappers = kernel_wrappers()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wb_") as tmp:
        capture = Path(tmp) / "wide.cs8"
        write_capture(capture, WB_RATE, WB_SECONDS, WB_SIGNALS, WB_KEY, seed=7)
        for form, tunables in WB_FORMS:
            config = runtime_config(capture, WB_RATE, WB_CENTER, channels=WB_CHANNELS, **tunables)
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            card_payloads, scanner, wall_s, clock = run_wideband_scanner(config, dev, timer=True)
            counts = {name: fn.launches for name, fn in wrappers.items()}
            session = scanner.sessions[0]
            cfg, blocks = session.scan_cfg, clock.block
            if form == "serial":
                log(f"{WB_CHANNELS} channels of {cfg.sample_rate} sps: fft {cfg.fft_size} decim "
                    f"{cfg.decimator_factor} frames {cfg.frames_per_block}, {session.ddc_cfg.num_slots} slot(s) a "
                    f"channel, DDC stages {[(p.interp, p.decim) for p in session.ddc_cfg.plans]}; {blocks} blocks")
            want = {"psd_frames_int8": 0, "fused_selection": blocks * (WB_CHANNELS if form == "serial" else 1),
                    "stage_apply_fir": 0}
            log(f"{form}: launches over the card run: {counts} (the 128 kHz -> 32 kHz chain is one modulated-"
                f"taps stage: no FIR kernel stage; f32 channels: no PSD kernel)")
            if counts != want:
                raise RuntimeError(f"wideband session {form} launches {counts}, want {want}")
            launches[f"wideband_runtime_{form}"] = counts
            cpu_payloads, _, cpu_s, _ = run_wideband_scanner(config, torch.device("cpu"))
            stats = compare_payloads(cpu_payloads, card_payloads)
            log(f"{form}: card vs CPU payloads: {stats} (CPU run {cpu_s:.1f} s); recorded "
                f"{check_wideband_recordings(card_payloads)}")
            stream_s = blocks * cfg.block_samples * WB_CHANNELS / WB_RATE
            device = clock.device_ms()
            wall_ms = float(np.mean(clock.walls[1:]))
            device_ms = float(np.mean(device[1:]))
            log(f"wideband {form}: {wall_ms:.2f} ms per block (blocks 1..{blocks - 1}; first {clock.walls[0]:.1f}), "
                f"device {device_ms:.2f} ms (CUDA events around the dispatches), host {wall_ms - device_ms:.2f} ms; "
                f"real-time factor {stream_s / wall_s:.2f} ({stream_s:.2f} s of stream in {wall_s:.3f} s, "
                f"{blocks} blocks of {stream_s / blocks * 1e3:.0f} ms) on {card}")
            if form == "serial":
                config_path = Path(tmp) / "config.json"
                config_path.write_text(json.dumps(config))
                rc, main_payloads = run_main(config_path, dev)
                if rc != 0:
                    raise RuntimeError(f"main.run returned {rc}")
                compare_payloads(card_payloads, main_payloads)
                log(f"main.run (wideband device): rc {rc}, {len(main_payloads)} payloads, as the card's run")
    return launches


def time_mesh_configs(dev):
    """Path 1's band as SdrDevice._setup_time_mesh sizes it for TMESH_SHARDS
    shards: frames grow by whole 45-frame blocks until each shard holds
    grouping_y (45 -> 180: 141,557,760 int8 bytes a block); the DDC config
    of that block. Returns (ScanConfig, DdcConfig, group size)."""
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, scan_pipeline

    base = scan_pipeline.ScanConfig.create(TMESH.rate, TMESH.frames)
    frames = base.frames_per_block
    while frames % TMESH_SHARDS != 0 or frames // TMESH_SHARDS < base.grouping_y:
        frames += base.frames_per_block
    cfg = dataclasses.replace(base, frames_per_block=frames)
    ddc_cfg = ddc_pipeline.DdcConfig.create(TMESH.rate, TMESH.bandwidth, TMESH.slots, cfg.block_samples)
    return cfg, ddc_cfg, int(np.ceil(TMESH.bandwidth / cfg.step_hz))


class TimeMesh:
    """Path 1's band at the time mesh's 180 frames on the card: the
    time-sharded scan and modulated-taps DDC over a mesh of TMESH_SHARDS
    copies of the card, or of the cards ``devices`` names (``sharded``), or
    the one-card compact step and DDC; a device-resident ring of
    TMESH.blocks blocks on ``dev``, FM keyed from block 1."""

    def __init__(self, dev, sharded: bool, ring=None, devices=None):
        from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, scan_pipeline
        from rtl_sdr_scanner_tpu_torch.parallel import mesh, sharded_scan as ss

        geo = TMESH
        self.dev, self.sharded = dev, sharded
        self.cfg, self.ddc_cfg, self.group_size = cfg, ddc_cfg, group_size = time_mesh_configs(dev)
        n = TMESH_SHARDS
        if not ss.time_sharded_modtap_fits(ddc_cfg, n):
            raise RuntimeError(f"the time-sharded DDC does not split {n} ways at {cfg.frames_per_block} frames")
        if sharded:
            m = mesh.make_mesh(1, n, devices=list(devices) if devices else [dev] * n)
            self.scan_step = ss.make_time_sharded_scan(cfg, m, group_size, TOP_K)
            self.ddc_step = ss.make_time_sharded_modtap_ddc(ddc_cfg, m)
        else:
            self.scan_step = scan_pipeline.make_compact_scan_step(cfg, group_size, TOP_K, device=dev)
            self.ddc_step = ddc_pipeline.make_ddc_step(ddc_cfg, device=dev)
        if ring is None:
            ring = [blk[0] for blk in make_ring(dataclasses.replace(geo, frames=cfg.frames_per_block), cfg, dev)]
        self.ring = ring
        self.keys = torch.full((KEY_SLOTS,), -1, dtype=torch.int32, device=dev)
        self.valid = torch.ones(cfg.fft_size, dtype=torch.bool, device=dev)
        self.level = torch.tensor(LEVEL, device=dev)
        self.tables = ddc_pipeline.make_tables(
            ddc_cfg, np.array([geo.signal_offset_hz, geo.other_shift], dtype=np.int64), device=dev)
        self.state = scan_pipeline.init_scan_state(cfg, device=dev)
        self.acc = scan_pipeline.init_spectro_acc(cfg, device=dev)
        self.ddc = ddc_pipeline.init_state(ddc_cfg, device=dev)

    def run_block(self, b: int):
        """One block (ring slot b % TMESH.blocks): (rows [F, 3K+1+2S], the
        block's spectrogram sum, noise ready, recording [K, out, 2])."""
        f = self.cfg.frames_per_block
        now = torch.from_numpy(((b * f + 1 + np.arange(f)) * self.cfg.frame_interval_ms).astype(np.int32))
        iq = self.ring[b % len(self.ring)]
        now = now.to(self.dev)
        if self.sharded:
            self.state, rows, spectro, ready = self.scan_step(self.state, iq, now, self.keys, self.valid, self.level)
        else:
            self.state, self.acc, outs = self.scan_step(
                self.state, self.acc, iq, now, self.keys, self.valid, self.level, 0.0)
            rows, spectro, ready = outs.packed[:-1].reshape(f, -1), self.acc, outs.noise_ready
        self.ddc, rec = self.ddc_step(self.ddc, iq.reshape(-1, 2), self.tables)
        return rows, spectro, ready, rec


def run_time_mesh(dev, card: str, devices=None) -> dict:
    """Step 10a: one band at path 1's geometry time-sharded over a mesh of
    TMESH_SHARDS copies of the card (make_time_sharded_scan +
    make_time_sharded_modtap_ddc), then the one-card compact step and DDC
    at the same 180-frame geometry, each with the launch counts set to 0
    just before; held against each other and checked for the planted
    signal. ``devices``: TMESH_SHARDS distinct cards in place of copies of
    ``dev``. Returns {form: counts}."""
    log(f"---- {TMESH.name}" + (f" on cards {[d.index for d in devices]}" if devices else ""))
    geo, n = TMESH, TMESH_SHARDS
    where = f"cards {[d.index for d in devices]}" if devices else f"{n} shards of one card"
    t0 = time.perf_counter()
    paths = {"time_mesh": TimeMesh(dev, True, devices=devices)}
    paths["time_mesh_one_card"] = TimeMesh(dev, False, paths["time_mesh"].ring)
    cfg, ddc_cfg, group_size = time_mesh_configs(dev)
    ring = paths["time_mesh"].ring
    log(f"fft {cfg.fft_size} decim {cfg.decimator_factor}, frames {TMESH.frames} -> {cfg.frames_per_block} a block "
        f"({cfg.frames_per_block // n} a shard, {ring[0].numel() / 1e6:.1f} MB of int8), DDC stages "
        f"{[(p.interp, p.decim) for p in ddc_cfg.plans]}, {ddc_cfg.num_chunks} chunks of {ddc_cfg.chunk} "
        f"({ddc_cfg.chunk // n} a shard); ring of {geo.blocks} blocks in {time.perf_counter() - t0:.1f} s")
    wrappers = kernel_wrappers()
    results, launches, block_ms = {}, {}, {}
    for form, path in paths.items():
        out, times = [], []
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        for b in range(geo.blocks):
            t0 = time.perf_counter()
            rows, spectro, ready, rec = path.run_block(b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append((rows.cpu().numpy(), spectro.cpu().numpy(), bool(ready), rec.cpu().numpy()))
        launches[form] = {name: fn.launches for name, fn in wrappers.items()}
        results[form], block_ms[form] = out, times
        shards = n if form == "time_mesh" else 1
        want = {"psd_frames_int8": shards * geo.blocks, "fused_selection": shards * geo.blocks,
                "stage_apply_fir": shards * geo.blocks * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg))}
        log(f"{form}: launches over {geo.blocks} blocks: {launches[form]}")
        if launches[form] != want:
            raise RuntimeError(f"{form} launches {launches[form]}, want {want}")

    k2 = TOP_K + 16
    planted = cfg.fft_size // 2 + round(geo.signal_offset_hz / cfg.step_hz)
    worst = dict(idx_mismatch=0.0, val=0.0, tie_val=0.0, rec_lsb=0, rec_differ=0, spectro=0.0)
    for b, ((body, spectro, ready, rec), (ref, ref_spectro, ref_ready, ref_rec)) in enumerate(
            zip(results["time_mesh"], results["time_mesh_one_card"])):
        if not (np.isfinite(body).all() and body.shape == ref.shape) or ready != ref_ready:
            raise RuntimeError(f"time mesh block {b}: non-finite rows, wrong shape or readiness")
        mism = body[:, :k2] != ref[:, :k2]
        vals, ref_vals = body[:, k2 : 2 * k2], ref[:, k2 : 2 * k2]
        val_diff = np.abs(vals - ref_vals)
        # a near-tie the selection decides in bf16 (detection_bf16) flips
        # when the shards' f32 sums round the other way: in the top-K, the
        # values at a flipped rank stay within two bf16 steps (2^-6
        # relative); after a flipped margin winner the greedy follows other
        # zones, so those ranks are counted in the 0.5%, not compared
        top = np.zeros_like(mism)
        top[:, :TOP_K] = mism[:, :TOP_K]
        tie = val_diff[top].max(initial=0.0)
        tie_ok = bool((val_diff[top] <= 2.0**-6 * np.maximum(np.abs(vals), np.abs(ref_vals))[top]).all())
        val = max(val_diff[~mism].max(initial=0.0), np.abs(body[:, 3 * k2 + 1 :] - ref[:, 3 * k2 + 1 :]).max())
        d = np.abs(rec.astype(np.int32) - ref_rec.astype(np.int32))
        worst = dict(idx_mismatch=max(worst["idx_mismatch"], float(mism.mean())), val=max(worst["val"], float(val)),
                     tie_val=max(worst["tie_val"], float(tie)),
                     rec_lsb=max(worst["rec_lsb"], int(d.max())), rec_differ=worst["rec_differ"] + int((d > 0).sum()),
                     spectro=max(worst["spectro"], float(np.abs(spectro - ref_spectro).max())))
        if not np.array_equal(body[:, 3 * k2], ref[:, 3 * k2]):
            raise RuntimeError(f"time mesh block {b}: candidate counts differ from the one-card step's")
        if mism.mean() >= 0.005 or val > 2e-3 or not tie_ok or d.max() > 1:
            diffs = [(int(r), int(c), float(vals[r, c]), float(ref_vals[r, c])) for r, c in zip(*np.nonzero(mism))][:8]
            raise RuntimeError(f"time mesh block {b}: {worst} against the one-card step; differing (frame, rank, "
                               f"value, one-card value): {diffs}")
    log(f"time mesh vs one card over {geo.blocks} blocks: counts equal; {worst['idx_mismatch']:.4%} of candidate "
        f"indices differ at most in a block (bar 0.5%: near-ties; in the top-K their values within "
        f"{worst['tie_val']:.3g} dB, two bf16 steps of the selection), values where the bins agree and key values "
        f"within {worst['val']:.3g} dB "
        f"(bar 2e-3), recordings within {worst['rec_lsb']} LSB ({worst['rec_differ']} samples differ), spectrogram "
        f"sums within {worst['spectro']:.3g}")
    hits = []
    for b in range(geo.signal_from_block, geo.blocks):
        body = results["time_mesh"][b][0]
        live = body[:, k2 : 2 * k2] >= LEVEL
        if live.any():
            hits.append(int(np.abs(body[:, :k2][live] - planted).min()))
    rec = results["time_mesh"][-1][3]
    power = (rec.astype(np.float32) ** 2).sum(axis=-1).mean(axis=-1)  # [slots]
    gain_db = 10 * math.log10(power[0] / max(power[1], 1e-3))
    tone = fm_tone(rec[0], geo.bandwidth)
    log(f"time mesh: the planted signal in blocks {geo.signal_from_block}..{geo.blocks - 1}: nearest candidate "
        f"{hits} bins from {planted}; slot 0 {gain_db:.1f} dB above slot 1, FM-demodulates to {tone:.1f} Hz")
    if len(hits) != geo.blocks - geo.signal_from_block or max(hits) > group_size or gain_db < 10 or abs(tone - RT_TONE) >= 40:
        raise RuntimeError(f"time mesh: the planted signal was not detected and recorded: {hits}, {gain_db} dB, {tone} Hz")
    sharded, one = (float(np.mean(block_ms[k][1:])) for k in ("time_mesh", "time_mesh_one_card"))
    log(f"time mesh: {sharded:.1f} ms a {cfg.block_samples / cfg.sample_rate * 1e3:.0f} ms block on {where} "
        f"vs {one:.1f} ms one-card (blocks 1..{geo.blocks - 1}; first {block_ms['time_mesh'][0]:.1f} / "
        f"{block_ms['time_mesh_one_card'][0]:.1f} ms) on {card}")
    del paths, ring
    torch.cuda.empty_cache()
    return launches


def run_band_shards(dev, card: str, devices=None) -> dict:
    """Step 10b: the wideband step (step 7's stream and channels) over a
    band mesh of BAND_SHARDS copies of the card, fused and split, MESH_BLOCKS
    blocks, each against the one-card form on the same ring, the launch
    counts set to 0 just before each run. ``devices``: distinct cards in
    place of copies of ``dev``. Returns {form: counts}."""
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline

    n_shards = len(devices) if devices else BAND_SHARDS
    where = f"cards {[d.index for d in devices]}" if devices else f"{n_shards} shards of one card"
    log(f"---- wideband step over {where}")
    geo = WIDE
    cfg = scan_pipeline.ScanConfig.create(geo.rate, geo.frames)
    ring = wide_ring(geo, cfg.block_samples, dev)
    wrappers = kernel_wrappers()
    launches = {}
    for fused in (True, False):
        form = "fused" if fused else "split"
        runs = {}
        for shards in (1, n_shards):
            step = WidebandStep(dev, geo, fused, ring, shards, devices if shards > 1 else None)
            ddc_cfg = step.ddc_cfg
            out, times = [], []
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            for b in range(MESH_BLOCKS):
                t0 = time.perf_counter()
                packed, rec = step.run_block(b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                out.append((packed.cpu().numpy(), rec.cpu().numpy()))
            counts = {name: fn.launches for name, fn in wrappers.items()}
            want = {"psd_frames_int8": 0, "fused_selection": shards * MESH_BLOCKS,
                    "stage_apply_fir": shards * MESH_BLOCKS * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg))}
            if counts != want:
                raise RuntimeError(f"wideband {form} over {shards} shard(s): launches {counts}, want {want}")
            key = f"wideband_step_{shards}_shards_{form}" if shards > 1 else f"wideband_step_one_card_{form}"
            launches[key] = counts
            runs[shards] = (out, times)
            del step
            torch.cuda.empty_cache()
        (got, t_n), (ref, t_1) = runs[n_shards], runs[1]
        k2 = TOP_K + 16
        worst_val, worst_lsb, hits = 0.0, 0, {}
        for b, ((p, rec), (rp, rrec)) in enumerate(zip(got, ref)):
            for band in range(geo.bands):
                mine = scan_pipeline.unpack_compact(p[band], geo.frames, TOP_K, KEY_SLOTS)
                theirs = scan_pipeline.unpack_compact(rp[band], geo.frames, TOP_K, KEY_SLOTS)
                for i in (0, 2, 3, 5, 6):  # indices, votes, counts, key argmax, readiness
                    if not np.array_equal(mine[i], theirs[i]):
                        raise RuntimeError(f"wideband {form} block {b} channel {band}: output {i} differs from one card")
                worst_val = max(worst_val, float(np.abs(mine[1] - theirs[1]).max()), float(np.abs(mine[4] - theirs[4]).max()))
                if (mine[1] >= LEVEL).any():
                    hits.setdefault(band, set()).add(b)
            worst_lsb = max(worst_lsb, int(np.abs(rec.astype(np.int32) - rrec.astype(np.int32)).max()))
        if worst_val > 1e-3 or worst_lsb > 1 or set(hits) != {geo.signal_band} or 1 not in hits[geo.signal_band]:
            raise RuntimeError(f"wideband {form} over {where}: values {worst_val} dB, recordings "
                               f"{worst_lsb} LSB, detections {hits}")
        log(f"wideband {form} over {where} vs one card, {MESH_BLOCKS} blocks: indices, votes and counts "
            f"equal, values within {worst_val:.3g} dB, recordings within {worst_lsb} LSB; channels with candidates "
            f"above {LEVEL} dB: { {k: sorted(v) for k, v in hits.items()} }; launches {launches[f'wideband_step_{n_shards}_shards_{form}']}")
        log(f"wideband {form}: {np.mean(t_n[1:]):.1f} ms a block over {where} (the "
            f"channelizer on each) vs {np.mean(t_1[1:]):.1f} ms one-card (blocks 1..{MESH_BLOCKS - 1}) on {card}")
    del ring
    torch.cuda.empty_cache()
    return launches


def cpu_cards(cards: int):
    """A context in which a CPU session resolves its meshes against
    ``cards`` visible cards (copies of the CPU device), as a session on
    that many cards does: the CPU run a card run is held against."""
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

    real = sdr_device.visible_cards

    class Patch:
        def __enter__(self):
            sdr_device.visible_cards = lambda device: cards if device.type == "cpu" else real(device)

        def __exit__(self, *exc):
            sdr_device.visible_cards = real

    return Patch()


def run_main_time_mesh(dev, card: str, cards: int = 1) -> dict:
    """Step 10c: main.run with mesh_time 4 and power_bf16 on step 6's
    capture; the time mesh resolves to the visible cards (1 here: one
    card). Its payloads against the same config's CPU run on as many
    copies of the CPU (step 6's bars). Returns {form: counts}."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner

    log("---- main.run with mesh_time 4 and power_bf16")
    shards = min(4, cards)
    # over several cards the reference's rule grows a block to 300 frames
    # (4.1 s); a recording is reconciled at block ends, so the signal stays
    # on across two of them and the stream runs two blocks past it
    seconds, key = (RT_SECONDS, RT_KEY) if shards == 1 else (2 * RT_SECONDS, (3.0, 14.0))
    wrappers = kernel_wrappers()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tm_") as tmp:
        capture = Path(tmp) / "capture.cs8"
        write_capture(capture, RT_RATE, seconds, RT_SHIFT, key)
        config = runtime_config(capture, RT_RATE, RT_CENTER, mesh_time=4, power_bf16=True)
        cfg = Config(json.loads(json.dumps(config)))
        session = Scanner(cfg, cfg.devices[0], NullMqtt(), cfg.recorders_count(), device=dev).device
        mesh_shape, tmesh_ddc = session._time_mesh.shape, session.tmesh_ddc
        blocks = int(RT_RATE * seconds) // session.scan_cfg.block_samples
        config_path = Path(tmp) / "config.json"
        config_path.write_text(json.dumps(config))
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc, payloads = run_main(config_path)
        wall_s = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in wrappers.items()}
        if rc != 0:
            raise RuntimeError(f"main.run returned {rc}")
        with cpu_cards(cards):
            cpu_payloads, _, cpu_s, _ = run_scanner(config, torch.device("cpu"))
        stats = compare_payloads(cpu_payloads, payloads)
        center, n_rec, tone = recorded_tone(payloads, RT_CENTER + RT_SHIFT, 32_000)
    log(f"main.run (mesh_time 4 -> mesh {mesh_shape}, {session.scan_cfg.frames_per_block} frames a block, "
        f"time-sharded DDC {tmesh_ddc}, power_bf16): rc {rc}, launches {counts}; card vs CPU payloads: {stats} (CPU "
        f"run {cpu_s:.1f} s); recorded {n_rec} samples at {center} Hz, tone {tone:.1f} Hz; {wall_s:.1f} s wall with "
        f"startup on {card}")
    want = blocks * shards
    if mesh_shape != {"bands": 1, "time": shards} or counts["psd_frames_int8"] != want or counts["fused_selection"] != want:
        raise RuntimeError(f"main.run with mesh_time: mesh {mesh_shape}, launches {counts} for {blocks} blocks")
    if counts["stage_apply_fir"] == 0 or abs(tone - RT_TONE) >= 40 or n_rec < 2 * 32_000:
        raise RuntimeError(f"main.run with mesh_time: FIR launches {counts}, recording {n_rec} samples, tone {tone}")
    return {"main_mesh_time_power_bf16": counts}


def run_multi_device(dev, card: str) -> dict:
    """Step 10, the multi-device layer on one card: the time-sharded scan
    and DDC, the bands-sharded wideband step, main.run with mesh_time and
    power_bf16. Returns {form: counts}."""
    launches = run_time_mesh(dev, card)
    launches.update(run_band_shards(dev, card))
    launches.update(run_main_time_mesh(dev, card))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true", help="hold and time the kernels, drive no path")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent,
                    help="checkout whose package to run (default: this script's)")
    args = ap.parse_args()
    # the run uses one card: show it only the first, before CUDA starts, so
    # that the device count it reports is the count it used
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print("chip_smoke: needs exactly one visible card (CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2
    root = args.root.resolve()
    if not (root / "rtl_sdr_scanner_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(f"card: {card}; package from {root}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")
    from rtl_sdr_scanner_tpu_torch import native

    t0 = time.perf_counter()
    if not native.native_available():
        raise RuntimeError("the native host codecs did not build (g++)")
    log(f"native host codecs built and loaded in {time.perf_counter() - t0:.1f} s: {native.lib_path()}")

    geos = (PATH1, PATH2)
    timed = geos + (RUNTIME, TMESH)  # the kernels at every shape the paths, the session and a time shard give them
    wide = (WIDE, WIDE_RT, WIDE_SHARD)  # the wideband phases' shapes: selection, and the FIR's stage 2
    psd_err, sel_err = check_psd_and_selection(timed, timed + wide, dev)
    fir_err = check_fir(timed + (WIDE, WIDE_SHARD), dev)
    if not args.kernels_only:
        # the paths before any timing: the profiler's tracing, once started,
        # slows every later launch of the process
        launches = {geo.key: run_path(dev, card, geo) for geo in geos}
        check_interpolating_stages(dev)
        launches["runtime"] = run_runtime(dev, card)
        log(f"[{time.perf_counter() - t_start:.1f} s]")
        launches.update(run_wideband_step(dev, card))
        launches.update(run_wideband_runtime(dev, card))
        log(f"[{time.perf_counter() - t_start:.1f} s]")
        launches.update(run_multi_device(dev, card))
        log(f"[{time.perf_counter() - t_start:.1f} s]")
    records = time_psd_and_selection(timed, dev, card, psd_err, sel_err, sel_only=wide)
    records.append(time_fir(timed + (WIDE, WIDE_SHARD), PATH2, dev, card, fir_err))
    if args.kernels_only:
        log(card)
        log(json.dumps({"kernels": records}))
        return 0
    for r in records:
        r["launches"] = sum(counts[r["name"]] for counts in launches.values())
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in launches.items()}
        if r["launches"] == 0:
            raise RuntimeError(f"{r['name']} never launched on the main paths")
        if r["launches_by_path"]["runtime"] == 0:
            raise RuntimeError(f"{r['name']} never launched by the runtime session")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
