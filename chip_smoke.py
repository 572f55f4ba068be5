"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                          # everything below
    python3 chip_smoke.py --kernels-only [--root DIR]
    python3 chip_smoke.py --child MODE RANK WORLD PORT ROOT ...  # a step 11 process; the script starts them

1. Builds the hand-written kernels from ``rtl_sdr_scanner_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/kernels``).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes each path and the runtime session give it: the PSD within 0.02 dB on every bin within
   60 dB of its frame's peak, median |diff| <= 1e-3 dB over every bin, |dP| <= 1e-5 of the
   frame's peak power on every bin (``psd_agreement``), and the selection
   bit-exact in bf16 and f32, at each path's fft, decimation and
   submargin; the PSD also at the ends of each of its forms (one block a
   frame: fft 256 and 16384; a cluster: 32768 and 131072) and at every size
   of its scratch forms (2^18-2^22, and 2^23-2^24 on clusters, 16
   frames at decim 4 there), decimations 1-4, odd frame counts (1, 3,
   17); the selection also at the wideband channels' fft 512, at fft 256 and
   at SPLIT_SELECT_CASES (its row-split form: [1, 2^18], [16, 2^21], [45,
   131072], [180, 131072], [16, 2^23] and [16, 2^24] (widened leaves),
   zones wider than a slice, and the boundary to a
   warp a row at 384 / 385 rows, on rows with ties across every slice
   edge, masked tails and fully masked rows); the decimating FIR within
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
   kernel, 2 chunks a block; a 219-bin vote window. Same
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
   the channelizer (on the card the analysis-bank kernel, one launch a
   block) is held against the CPU and against the kernel's plain version
   on the card on 2^20 samples of that block (two streamed halves) within
   2e-5 (atol = rtol). Prints ms a block and wideband samples/s.
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
   FIR; the history vote kernel at the benchmark's hf20m48 block and
   rtl2m048 scan and at each path's, held bit-equal to its plain version
   first, top level hf20m48's; the analysis bank at step 7's block, held
   against its plain version there, the matmul form it replaced timed as
   its ``library_ms``; the modulated-taps stage-1 kernel at DDC_TIMED's
   chunks (the step cells' 24 int8 bands, 8 f32 channels and one band at
   M = 8, K = 16, the dongle session's one band at M = 64, K = 4, step
   12c's at M = 2, K = 4, two shapes of the form rule at K = 4 and 8), in
   the form the shape takes and each form alone where it fits, each held
   within 2e-6 of max|y| of its plain version (today's chain before it:
   the matmul form with its operand handling and the rotation) with the
   new tail exact, the matmul form's ``bmm`` alone its ``library_ms``,
   top level hf20m48's).
   ``ms`` is the wrapper's pace (CUDA events around back-to-back
   calls), ``device_ms`` the kernel's own device time (torch.profiler's
   kernel records), ``host_us`` the host time a wrapper call takes to
   enqueue. It comes last: once the profiler has traced, every later
   launch of the process is slower. The time mesh's and the band shards'
   per-shard shapes (step 10) are checked and timed here too, the PSD's
   scratch forms at 16 frames of each size 2^18-2^24 (``scratch_2^N``) and
   the selection at [16, 2^24] (``split_2^24``; [16, 2^23] is step 12e's);
   beside every PSD timing torch.fft.fft's pace (``library_ms``) and device
   time (``library_device_ms``) on the same complex frames.
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
   to its one-card counterpart. The sharded steps run graphed
   (``graph.sharded_step``: a graph a shard and segment between the
   exchanges).
11. The multi-host layer (``parallel/multihost.py``), two processes of this
   script (``--child``) joined in one process group through the env
   contract, both on card 0 (each on its own card where the machine has
   one a process); a child that fails or outlives its time fails the run.
   No CUDA collective runs. (a) The session: ``runtime.main.run`` in each
   process on ``tests/test_multihost.py``'s scene (8 s at 2.048 Msps cs8,
   8 channels, FM keyed 3-6 s in channels 2 and 5, ``mesh_bands`` -1,
   ``multihost``, 16 kHz recordings); each process's payloads equal the
   one-process card run's on 2 band shards of copies of the card, filtered
   to its bands, to step 8's bars; together the processes cover every
   channel once, and both transmissions are recorded and demodulate to
   their tones. Prints each process's ms a block and real-time factor. (b)
   Full width: step 7's wideband step, each process running its 4 channels
   (one of 2 global band shards) on its card, fused and split, 3 blocks;
   packed rows and recordings bit-equal to the matching shard of the
   one-process 2-shard form, the FM in channel 3 found by its owner only.
   (c) ``dryrun.dryrun_multichip(4)`` on 4 copies of the card. (d) The
   history vote kernel (``ops/cuda/vote_kernel``): paths 1 and 2, 3 blocks,
   in f32 and bf16 detection, each block's votes bit-equal to each plain
   lowering's (``ops/detect.VOTE_FORM``, the code and the gather form,
   called on the same rows on the card) and to the packed output's; prints
   ms a block (CUDA events) of ``compact_detection``, the kernel and each
   plain lowering.
12. Every fft the JAX package scans. (a) The kernels' forms beyond steps 2's
   shapes against their plain versions: the PSD's small-frame form at fft
   16-128 (decimations 1-4, odd frame counts up to 1801) and its
   scratch form at 2^21 and 2^22; the selection's register
   form at fft 16-128 (top_k 8-64, zones narrower and wider than the row,
   masked tails) and its table at 2^21, bit-exact in bf16 and f32. (b)
   ``runtime.main.run`` on a 6 s capture at 2.048 Msps with ``"channels":
   64`` (32 kHz channels: fft 128, decim 5, 16 frames, 0.32 s blocks; FM in
   channels 3 and 57 keyed 3-5 s; 16 kHz recordings), in the split and the
   fused form, each against the same form's CPU run (step 6's bars), both
   transmissions recorded at their tones, the selection kernel launched.
   (c) One int8 band of 32 kHz (fft 128: the PSD's small-frame form and the
   selection's register form, 4 slots at 16 kHz) through ``Scanner`` on the
   card against the CPU, its transmission recorded. (d) The single-band
   block step at 491.52 Msps (fft 2^21, decim 4, 16 frames: 268 MB of
   int8 a 0.273 s block; 2 slots at 30 kHz, FIR stages (1, 8), (1, 16),
   (1, 16)) for 3 blocks, the noise learning cut to 200 ms so that it ends
   in block 0; FM at +50 MHz from block 1 must be detected there and
   recorded (slot 0 >= 10 dB above slot 1, its tone); the first 2 blocks
   through the same step on the CPU (the plain versions), held against
   the card's: counts and readiness equal, candidate indices and voted
   bins equal but for < 0.5% near-ties, values within the PSD bar's 0.02
   dB, recordings within 1 LSB; each block's PSD rows held against the
   plain version under step 2's bar; prints ms a block and the PSD
   kernel's ms. (e) The same at 1966.08 Msps (an RFSoC-class
   direct-sampling band: fft 2^23, the PSD's cluster scratch form and the
   selection's row-split form on widened leaves; 1.07 GB of int8 a 0.273 s
   block, FIR stages (1, 16) x 3 on 256 chunks a block), 3 blocks, without
   the CPU run ((d) holds these stages card against CPU). Step 2 holds the
   PSD and the selection at (b)'s to (e)'s shapes too, and step 9
   times them there.
13. The graphed steps against eager (before step 9): path 1, path 2 and the
   491.52 Msps band (``drivers.BandedBlocks``), the fused wideband step
   (``drivers.WidebandBlocks``, one-card mesh), GRAPH_BLOCKS blocks each,
   slot 1 of the signal's band restarted on a new shift before block
   GRAPH_SLOT_BLOCK; and step 6's session on two ranges (it hops, and
   records the FM) through ``Scanner.run_to_completion()``, serial and
   pipelined. Each runs its steps' eager ``fn``, then the graphed step,
   from a fresh state: packed rows and recordings (the session's payloads,
   byte for byte, and its hops) equal, each step captured once, the
   kernels' launches equal between the forms and to the per-block counts
   x blocks. Prints ms a block eager and graphed (wall of synchronised
   blocks, host until the call returns, and back to back: GRAPH_BLOCKS
   more blocks with one synchronisation, or the pipelined session), the
   card's busy share (the captured graphs' device span a block, CUDA
   events around replays alone, over each form's synchronised wall), the
   capture time and the pool's bytes. Then the sharded steps
   (``graph.sharded_step``: a graph a (shard, segment) between the
   exchanges) the same way: 10a's time mesh (4 shards of the card: the
   scan and the modulated-taps DDC, slot 1 restarted before block
   GRAPH_SLOT_BLOCK), 10b's wideband step over 2 band shards (fused and
   split), 10c's session (``mesh_time`` 4 and ``power_bf16``) and 11a's
   one-process session on 2 band shards (payloads byte for byte), each
   (shard, segment) captured once, with the number of captures; 11b's
   processes hold their own graphed steps against eager (rows and
   recordings bit-equal) and report the same numbers.

Every block step runs graphed: a one-card step as a ``graph.donated_step``
(captured once a geometry as a CUDA graph and replayed), a step over
shards (10, 11) as a ``graph.sharded_step``; step 11d's runs eager (it
times ``compact_detection`` around its own launches, which a graph would
run unseen).

Each path (and each phase's or form's card run) runs with every kernel's
launch count set to 0 just before it and read just after. Every failure
raises. The last lines are the card's name and power limit, the kernels' JSON record and ``{"ok": true, "device":
{...}}``. Without CUDA it exits non-zero and prints no result.

``--kernels-only`` runs steps 1, 2, 12a and 9 and ends with the kernels' record;
``--root DIR`` takes the package from another checkout (an older tree
unpacked under ``build/``), so that two trees' kernels are timed by the
same code on the same card: old, new, new, old.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# the bars and scenes the CPU tests share live in tests/torch_checks.py
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_checks import (  # noqa: E402
    MH_CENTER, MH_CHANNELS, MH_RATE, PSD_NEAR_DB, PSD_TOL_DB, RT_TONE, SPLIT_SELECT_CASES, band_of, compare_payloads,
    payload_band, psd_agreement, psd_within_bar, recorded_tone, run_main, spawn_ranks, split_selection_rows,
    write_capture,
)

TOP_K = 64
CHECK_ROWS = 45 * 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
FIR_REL_TOL = 2e-5
PROFILE_TRIES = 3


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
# the session's kernel shapes (one band, 4 slots), timed beside the paths'
RUNTIME = Geometry("runtime", "runtime session (one 2.4 Msps device, 4 slots at 32 kHz)", RT_RATE, 75, 32_000,
                   -600_000, bands=1, slots=4)
# (fft, decim, frames): the ends of the PSD kernel's forms beyond the paths' shapes, and every
# size of its scratch forms (fft 2^18-2^22, 2^23-2^24 on clusters) at
# decimations 1-4 and odd frame counts; 16 frames at decim 4 (a direct-sampling
# band's block) at 2^23 and 2^24
PSD_FORM_CASES = ((256, 1, 7), (16384, 3, 5), (32768, 3, 5), (131072, 1, 3), (262144, 2, 3),
                  (1 << 18, 1, 17), (1 << 18, 4, 3), (1 << 19, 2, 1), (1 << 19, 3, 17), (1 << 20, 1, 3),
                  (1 << 20, 4, 1), (1 << 21, 2, 17), (1 << 21, 3, 1), (1 << 22, 4, 3), (1 << 22, 1, 17),
                  (1 << 23, 4, 16), (1 << 23, 1, 3), (1 << 24, 4, 16), (1 << 24, 2, 1))
# (frames, fft, decim): the scratch forms timed at each size, 16 frames (the
# 491.52 Msps block's count) at decim 4
SCRATCH_PSD_TIMED = tuple((16, 1 << log, 4) for log in range(18, 25))
# (rows, fft, submargin): the selection timed beyond the paths' shapes (the
# 1966.08 Msps block's [16, 2^23] is step 12e's)
SPLIT_SELECT_TIMED = ((16, 1 << 24, 64),)
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
# the modulated-taps stage 1 timed (key, name, bands, slots, decimation,
# samples a chunk, int8): a chunk of the step cells' DDC (hf20m48's 24 int8
# bands, wb163m84's 8 f32 channels, ds491m52's one band at M 8 with 16
# slots), the dongle session's one-stage chain (rtl2m048: one chunk a
# block), step 12c's 32 kHz session (M 2, K 4, the folded form), and two
# shapes at the form rule's edges: wb163m84's channels with 4 slots (M 20,
# K 4: the lag form) and 24 int8 bands with 8 slots at M 16 (the folded
# form's largest M at K 8). Each in the form its shape takes, and both
# forms where each fits; the form taken may take at most FORM_SLACK more
# device time than the other, unless a call's host time paces both
DDC_TIMED = (
    ("hf20m48", "24 int8 bands at 20.48 Msps", 24, 2, 20, 1_105_920, True),
    ("wb163m84", "8 f32 channels at 20.48 Msps", 8, 2, 20, 1_105_920, False),
    ("ds491m52", "one int8 band at 491.52 Msps", 1, 16, 8, 1_966_080, True),
    ("rtl2m048", "one int8 band at 2.048 Msps", 1, 4, 64, 655_360, True),
    ("narrow_session", "one int8 band at 32 kHz", 1, 4, 2, 10_240, True),
    ("m20k4_f32", "8 f32 channels at 20.48 Msps, 4 slots", 8, 4, 20, 1_105_920, False),
    ("m16k8_int8", "24 int8 bands, 8 slots at M 16", 24, 8, 16, 1_105_920, True),
)
DDC_REL_TOL = 2e-6  # of max |y|: split TF32 against the f32 matmul form
FORM_SLACK = 0.15  # the stage-1 form taken against the other form's kernel device time
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
# step 11, the multi-host layer: MH_WORLD processes; the session's scene is
# tests/test_multihost.py's (its rate, channels and center: torch_checks'
# MH_*; +500 kHz in channel 2, -750 kHz in channel 5)
MH_WORLD = 2
MH_SECONDS = 8.0
MH_SIGNALS = ((500_000, 800.0), (-750_000, 1200.0))
MH_KEY = (3.0, 6.0)
MH_RECORDING = {"max_noise_time_ms": 1000, "min_sample_rate": 16000, "min_time_ms": 1000, "step": 2500}
CHILD_TIMEOUT_S = 300
# a process's band shard in the session: 4 channels of 256 kHz (fft 1024, 16
# frames, 16 kHz recordings: the selection kernel's shape there)
MH_SHARD = Geometry("multihost_session", "multi-host session (a process's 4 channels of 256 kHz)",
                    MH_RATE // MH_CHANNELS, 16, 16_000, 0, bands=MH_CHANNELS // MH_WORLD, slots=1)
# step 11d: blocks a run; the noise learning (WIDE_LEARN_MS) ends inside
# block 0, so the signal keyed from block 1 clears the floor
VOTE_BLOCKS = 3
# the history vote kernel timed (step 9) at the benchmark's two shapes (key,
# name, bands, frames, fft, group = ceil(32 kHz / bin)): the wideband
# receiver's block (205-bin windows) and the dongle session's scan (129),
# besides the paths'
VOTE_TIMED = (("hf20m48", "hf20m48 block", 24, 45, 131072, 205), ("rtl2m048", "rtl2m048 session", 1, 16, 8192, 128))
# step 12, every fft the JAX package scans: the kernels' small forms (fft <=
# 128) and the PSD's scratch form at fft 2^21-2^22.
# (fft, decim, frames): odd frame counts, decimations 1-4
NARROW_PSD_CASES = ((16, 1, 7), (32, 2, 33), (64, 3, 129), (128, 4, 1801), (128, 1, 1),
                    (1 << 21, 1, 3), (1 << 22, 2, 3))  # step 2 holds the 491.52 Msps block's and the rest
# (fft, top_k, k_sep, submargin, rows): top_k 8-64, zones narrower and wider
# than the row, masked tails the top-K reaches into; the 491.52 Msps rows
NARROW_SELECT_CASES = ((16, 16, 16, 40, CHECK_ROWS), (32, 8, 4, 3, CHECK_ROWS), (64, 64, 16, 16, CHECK_ROWS),
                       (64, 32, 16, 100, CHECK_ROWS), (128, 64, 16, 32, 1024), (128, 64, 16, 0, CHECK_ROWS),
                       (1 << 21, 64, 16, 64, 16))
# 12b: an RTL-SDR at 2.048 Msps split into 64 channels of 32 kHz (fft 128,
# decim 5, 16 frames: 0.32 s blocks), FM in channels 3 and 57 keyed after
# the noise learning, 16 kHz recordings (one modulated-taps stage)
NW_RATE = 2_048_000
NW_CHANNELS = 64
NW_SECONDS = 6.0
NW_SIGNALS = ((100_000, 800.0), (-230_000, 1300.0))
NW_KEY = (3.0, 5.0)
NW_FORMS = (("split", {"mesh_bands": 1}), ("fused", {"mesh_bands": 1, "wideband_fused_dispatch": True}))
NARROW_REC_RATE = 16_000
# 12c: one int8 band of 32 kHz (fft 128), FM at +3 kHz keyed 3-6 s
NB_RATE = 32_000
NB_SECONDS = 8.2
NB_SHIFT = 3_000
NB_KEY = (3.0, 6.0)
NARROW_WIDE = Geometry("narrow_wideband", "64-channel session (64 x 32 kHz channels, fft 128)",
                       NW_RATE // NW_CHANNELS, 16, NARROW_REC_RATE, 0, bands=NW_CHANNELS, slots=1)
NARROW_RT = Geometry("narrow_session", "32 kHz session (one int8 band, fft 128, 4 slots at 16 kHz)", NB_RATE, 16,
                     NARROW_REC_RATE, 0, bands=1, slots=4)
# 12d: one band at 491.52 Msps (an RFSoC/X410-class receiver): fft 2^21,
# decim 4, 16 frames (268 MB of int8 a 0.273 s block); 30 kHz recordings,
# a power-of-two chain (8, 8, 16, 16), so the block keeps its 16 frames
BAND_491 = Geometry("band_491", "one band at 491.52 Msps (fft 2^21, decim 4, 16 frames, 2 slots at 30 kHz)",
                    491_520_000, 16, 30_000, -100_000_000, bands=1, blocks=3, signal_band=0,
                    signal_offset_hz=50_000_000, signal_from_block=1)
# its depth is cut to 3 blocks, so its noise learning to 200 ms (it ends at
# frame 12 of block 0, 17.1 ms a frame), as step 7's is; and its first
# blocks go through the same step on the CPU (the plain versions): block 0
# and block 1, the signal's first (depth cut: the CPU's time)
BAND_491_LEARN_MS = 200
BAND_491_CPU_BLOCKS = 2
# 12e: one band at 1966.08 Msps (an RFSoC-class direct-sampling front end):
# fft 2^23 (the PSD's cluster scratch form), decim 4, 16 frames (1.07 GB of
# int8 a 0.273 s block); 30 kHz recordings, chain (16, 16, 16, 16), 256
# chunks a block; depth and noise learning cut as 12d's, no CPU run (12d
# holds these stages card against CPU)
BAND_1966 = Geometry("band_1966", "one band at 1966.08 Msps (fft 2^23, decim 4, 16 frames, 2 slots at 30 kHz)",
                     1_966_080_000, 16, 30_000, -100_000_000, bands=1, blocks=3, signal_band=0,
                     signal_offset_hz=50_000_000, signal_from_block=1)
# step 13: each one-card block step graphed against the same step eager,
# GRAPH_BLOCKS blocks a form, slot 1 of the signal's band restarted on a new
# shift before block GRAPH_SLOT_BLOCK; the session on two ranges, so that it
# hops (its noise learning cut to GRAPH_LEARN_MS, so that a range learns
# within its first dwells and the FM keyed at 3 s is recorded: 4 tunes, the
# last held while it records); a captured graph's device span from
# GRAPH_REPLAYS replays alone
GRAPH_BLOCKS = 6
GRAPH_SLOT_BLOCK = 3
GRAPH_REPLAYS = 5
GRAPH_RANGES = ((RT_CENTER - 1_000_000, RT_CENTER + 1_000_000), (RT_CENTER + 1_000_000, RT_CENTER + 3_000_000))
GRAPH_LEARN_MS = 500


def log(*args):
    print(*args, flush=True)


def free_card() -> None:
    """Give the card back what the finished phases held: collect the
    reference cycles that keep a finished session's graphs alive (a timer
    that wraps a scanner's methods makes one), whose private pools stay
    reserved until then, and empty the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


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
    # a session whose kernel records the profiler dropped whole (seen once
    # on an H100, late in step 9's sessions) is traced again
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_name:
            break
    else:
        raise RuntimeError(f"the profiler saw no launch of *{kernel}* in {PROFILE_TRIES} x {reps} calls")
    # each kernel's mean record times its records a call (a call may launch
    # several kernels: the PSD's scratch passes, cuFFT's), summed: a record
    # the profiler dropped (it happens, rarely) leaves the means as they are
    return sum(sum(us) / len(us) * max(1, round(len(us) / reps)) for us in by_name.values()) / 1e3


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


def selection_rows(fft: int, dtype, dev, n_rows: int = CHECK_ROWS) -> torch.Tensor:
    """n_rows rows: random, tied, clustered, zones across a segment border,
    all-masked and masked tails, and values exactly at the level."""
    from rtl_sdr_scanner_tpu_torch.drivers import LEVEL

    rng = np.random.default_rng(1)
    rows = rng.normal(0.0, 6.0, size=(n_rows, fft)).astype(np.float32)
    r = n_rows // 6
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

    form = psd_kernel.form(fft)
    if form != "cluster form":
        return form
    clusters = build.library().psd_max_active_clusters(*(n.bit_length() - 1 for n in psd_kernel._split_n(fft)))
    if clusters <= 0:
        raise RuntimeError(f"psd kernel: cudaOccupancyMaxActiveClusters gave {clusters} at fft {fft}")
    return f"cluster form, {clusters} clusters resident"


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
    a = psd_agreement(got, want)
    log(f"psd kernel vs plain [{rows}, {fft * decim}, 2] (fft {fft}, decim {decim}; {psd_form(fft)}): "
        f"max {a['max_db']:.3g} dB on bins within {PSD_NEAR_DB:g} dB of the peak; all-bin median "
        f"{a['median_db']:.3g} dB, max {a['all_max_db']:.3g} dB, |dP| {a['linear']:.3g} of the peak")
    if not psd_within_bar(a):
        raise RuntimeError(f"psd kernel disagrees at fft {fft}: {a}")
    return a["max_db"]


def check_selection(fft: int, submargin: int, dev, top_k: int = TOP_K, k_sep: int = 16,
                    n_rows: int = CHECK_ROWS, rows: np.ndarray = None) -> float:
    """Selection kernel bit-exact against its plain version in bf16 and f32
    on n_rows rows (``rows``, or selection_rows') at one path's fft and
    submargin; returns 0.0."""
    from rtl_sdr_scanner_tpu_torch.drivers import LEVEL
    from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel

    level = torch.tensor(LEVEL, device=dev)
    err = 0.0
    rows32 = selection_rows(fft, torch.float32, dev, n_rows) if rows is None else torch.from_numpy(rows).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        t = rows32.to(dtype)
        got = select_kernel.fused_selection(t, level, top_k, k_sep, submargin)
        want = select_kernel.fused_selection_plain(t, level, top_k, k_sep, submargin)
        torch.cuda.synchronize()
        for name, g, w in zip(("top_val", "top_idx", "sep_val", "sep_idx", "count"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise RuntimeError(f"selection kernel {dtype} {name} disagrees at fft {fft}: {bad}")
            err = max(err, (g.float() - w.float()).abs().max().item())
        slices = select_kernel.row_slices(n_rows, fft) if fft > select_kernel.SMALL_MAX_FFT else 0
        form = f"row-split form, {slices} warps a row" if slices else "a warp a row"
        log(f"selection kernel vs plain [{n_rows}, {fft}] top_k {top_k} k_sep {k_sep} submargin {submargin} "
            f"{dtype} ({form}): bit-exact")
    return err


def check_psd_and_selection(psd_geos, sel_geos, dev):
    """PSD and selection against their plain versions at every shape the
    paths give them (the PSD at the int8 paths', the selection at every
    path's, the wideband channels' included), the PSD at each of its forms'
    ends and at every size of its scratch form, the selection at its
    smallest table and at SPLIT_SELECT_CASES (its row-split form and the
    boundary to a warp a row); returns the PSD's and the selection's max
    |diff|."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    psd_err = sel_err = 0.0
    for geo in psd_geos:
        cfg, _, _ = configs(geo)
        # a time shard's frames, or a block's where a frame is 2^21 points
        rows = geo.frames if geo.time_shards > 1 or cfg.fft_size > 1 << 20 else CHECK_ROWS
        psd_err = max(psd_err, check_psd(cfg.fft_size, cfg.decimator_factor, rows, gen, dev,
                                         float(cfg.sample_rate)))
    for fft, decim, rows in PSD_FORM_CASES:
        psd_err = max(psd_err, check_psd(fft, decim, rows, gen, dev))
    # each path's selection at its own rows (bands x frames a block): the
    # form (select_kernel.row_slices) depends on the row count
    cases = {}
    for geo in sel_geos:
        cfg, _, group_size = configs(geo)
        cases.setdefault((cfg.fft_size, group_size // 2 + group_size % 2, geo.bands * geo.frames), None)
    for fft, submargin, n_rows in list(cases) + [(fft, sub, CHECK_ROWS) for fft, sub in SELECT_EXTRA_CASES]:
        sel_err = max(sel_err, check_selection(fft, submargin, dev, n_rows=n_rows))
    from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel

    for n_rows, fft, top_k, k_sep, submargin in SPLIT_SELECT_CASES:
        slices = select_kernel.row_slices(n_rows, fft)
        rows = split_selection_rows(fft, n_rows, fft // max(slices, 2), np.random.default_rng(n_rows + submargin))
        sel_err = max(sel_err, check_selection(fft, submargin, dev, top_k, k_sep, n_rows, rows))
    return psd_err, sel_err


def time_psd_and_selection(geos, dev, card: str, psd_err: float, sel_err: float, sel_only=()) -> list:
    """PSD and selection timed at every path's shapes (the selection alone at
    ``sel_only``'s: the wideband channels reach the scan as f32 pairs, no
    PSD kernel): rows = bands x frames a block. The records' top level holds
    the first path's numbers, ``*_by_path`` every path's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    psd = dict(
        name="psd_frames_int8", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/psd_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/psd_kernel.py:108", launches=None, max_abs_err=psd_err,
        session_path="runtime",
    )
    sel = dict(
        name="fused_selection", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/select_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/select_kernel.py:189", launches=None, max_abs_err=sel_err,
        session_path="runtime",
    )
    for geo in tuple(geos) + tuple(sel_only):
        cfg, _, group_size = configs(geo)
        fft, decim, rate = cfg.fft_size, cfg.decimator_factor, float(cfg.sample_rate)
        rows = geo.bands * geo.frames
        if geo not in sel_only:
            time_psd(psd, geo.key, geo.name, rows, fft, decim, rate, gen, dev, card)
        time_selection(sel, geo.key, geo.name, rows, fft, group_size // 2 + group_size % 2, gen, dev, card)
    for frames, fft, decim in SCRATCH_PSD_TIMED:
        time_psd(psd, f"scratch_2^{fft.bit_length() - 1}", f"{frames} frames, decim {decim}", frames, fft, decim,
                 BAND_491.rate, gen, dev, card)
    for rows, fft, submargin in SPLIT_SELECT_TIMED:
        time_selection(sel, f"split_2^{fft.bit_length() - 1}", f"{rows} rows", rows, fft, submargin, gen, dev, card)
    return [psd, sel]


def time_psd(psd: dict, key: str, name: str, rows: int, fft: int, decim: int, rate: float, gen, dev,
             card: str) -> None:
    """The PSD kernel at [rows, fft * decim, 2] int8, with its plain version,
    torch.fft.fft on the same complex frames (pace and device time) and the
    bound, into ``psd`` under ``key``."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel
    from rtl_sdr_scanner_tpu_torch.ops.psd import shifted_window

    big = random_cs8((rows, fft * decim, 2), gen, dev)
    win = torch.from_numpy(shifted_window(fft)).to(dev)
    frames_c = torch.complex(big[:, :fft, 0].float() / 127.5, big[:, :fft, 1].float() / 127.5) * win
    t = timings(lambda: psd_kernel.psd_frames_int8(big, rate, fft, decim),
                lambda: psd_kernel.psd_frames_int8_plain(big, rate, fft, decim), 20, "psd_", 5)
    library_ms = cuda_ms(lambda: torch.fft.fft(frames_c), 20)
    library_device_ms = device_ms(lambda: torch.fft.fft(frames_c), 20, "")  # every record: cuFFT's kernels
    # int8 pairs of the selected frame in, f32 dB out; a radix FFT's operations
    bound_ms, bound_by = bound(rows * fft * (2 + 4), rows * 5 * fft * math.log2(fft))
    log(f"psd [{rows}, {fft * decim}, 2] ({name}; {psd_form(fft)}): {fmt(t)}, torch.fft.fft alone "
        f"{library_ms:.4f} ms (device {library_device_ms:.4f} ms), bound {bound_ms:.4g} ms ({bound_by}) on {card}")
    record_time(psd, key, **t, library_ms=library_ms, library_device_ms=library_device_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def time_selection(sel: dict, key: str, name: str, rows: int, fft: int, submargin: int, gen, dev,
                   card: str) -> None:
    """The selection kernel on [rows, fft] bf16 rows, with its plain version
    and the bound, into ``sel`` under ``key``."""
    from rtl_sdr_scanner_tpu_torch.drivers import LEVEL
    from rtl_sdr_scanner_tpu_torch.ops.cuda import select_kernel

    level = torch.tensor(LEVEL, device=dev)
    spec = torch.randn((rows, fft), generator=gen, device=dev).mul_(6.0).to(torch.bfloat16)
    t = timings(lambda: select_kernel.fused_selection(spec, level, TOP_K, 16, submargin),
                lambda: select_kernel.fused_selection_plain(spec, level, TOP_K, 16, submargin), 20,
                "selection_", 3)  # the table form (selection_kernel) or the register form (selection_small)
    bound_ms, bound_by = bound(rows * fft * 2 + rows * ((TOP_K + 16) * (2 + 4) + 4), 0.0)
    slices = select_kernel.row_slices(rows, fft) if fft > select_kernel.SMALL_MAX_FFT else 0
    form = f"row-split form, {slices} warps a row" if slices else "a warp a row"
    log(f"selection [{rows}, {fft}] bf16 ({name}; {form}): {fmt(t)}, bound {bound_ms:.4g} ms ({bound_by}) "
        f"on {card}")
    record_time(sel, key, **t, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def fmt(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms a call (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us), "
            f"plain {t['plain_ms']:.3f} ms")


def record_time(record: dict, path: str, **numbers) -> None:
    """Put one path's (or shape's) timings in a kernel's record: under
    ``<key>_by_path`` for every path, and at the top level for the first
    path recorded."""
    for key, value in numbers.items():
        record.setdefault(key, value)
        record.setdefault(f"{key}_by_path", {})[path] = value


def fir_cases(geos):
    """(geometry, plan, samples a row) of every stage a path sends through
    the FIR kernel, then FIR_EXTRA_M at 16384 outputs a row (no path)."""
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages
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
        # a path's first (widest) stage stands for it in the record
        times.setdefault(geo.key, (geo, dict(**t, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)))
        del x, tail
    record = dict(
        name="stage_apply_fir", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/fir_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/fir_kernel.py:98", launches=None, max_abs_err=err,
        session_path="runtime",
    )
    for key in sorted(times, key=lambda k: k != timed.key):  # the timed path first: the top level
        geo, numbers = times[key]
        record_time(record, geo.key, **numbers)
    return record


def time_vote(geos, dev, card: str) -> dict:
    """The history vote kernel at VOTE_TIMED's shapes and each path's (bf16
    votes over f32 rows, as ``detection_bf16`` runs them), held bit-equal
    to the plain version (the code form) and timed beside it and its bound;
    the record's top level holds the first shape's."""
    from rtl_sdr_scanner_tpu_torch.drivers import LEVEL
    from rtl_sdr_scanner_tpu_torch.ops import detect
    from rtl_sdr_scanner_tpu_torch.ops.cuda import vote_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    level = torch.tensor(LEVEL, device=dev)
    record = dict(
        name="history_vote", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/vote_kernel.cu",
        replaces=None, launches=None, max_abs_err=0,
        session_path="runtime",
    )
    shapes = list(VOTE_TIMED)
    for geo in geos:
        cfg, _, group = configs(geo)
        shapes.append((geo.key, geo.name, geo.bands, geo.frames, cfg.fft_size, group))
    depth, n_cand = 11, TOP_K + detect.K_SEP
    for key, name, nb, frames, fft, group in shapes:
        raw = torch.randn((nb, frames, fft), generator=gen, device=dev).mul_(3.0)
        prev = torch.randn((nb, depth - 1, fft), generator=gen, device=dev).mul_(3.0)
        cand = torch.randint(0, fft, (nb, frames, n_cand), generator=gen, device=dev, dtype=torch.int32)
        args = (raw, prev, cand, group // 2, level, depth, True)
        got = vote_kernel.history_vote(*args)
        want = detect.history_vote_plain(*args)
        bad = int((got != want).sum())
        if bad:
            raise RuntimeError(f"history_vote ({name}): {bad} votes differ from the plain version")
        t = timings(lambda: vote_kernel.history_vote(*args), lambda: detect.history_vote_plain(*args), 20,
                    "history_vote", 3)
        # the history rows read once (f32), the candidates read and the votes written once
        bound_ms, bound_by = bound(nb * (depth - 1 + frames) * fft * 4 + 2 * cand.numel() * 4, 0.0)
        log(f"history vote [{nb}, {depth - 1} + {frames}, {fft}] window {2 * (group // 2) + 1}, {n_cand} "
            f"candidates ({name}): {fmt(t)}, bound {bound_ms:.4g} ms ({bound_by}) on {card}")
        record_time(record, key, **t, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        del raw, prev, cand
    return record


def modtap_launches(ddc_cfg, calls: int) -> dict:
    """Launches of the modulated-taps stage-1 kernel in ``calls`` DDC blocks
    of one step: one a chunk on the modulated-taps path, none on v1; its
    folded form's count the same where the shape folds, else none."""
    n = calls * ddc_cfg.num_chunks if ddc_cfg.modtap else 0
    return {"modtap_stage1": n, "modtap_stage1_fold": n if n and stage1_folds(ddc_cfg) else 0}


def stage1_folds(ddc_cfg) -> bool:
    """Whether the DDC's stage 1 runs the kernel's folded form."""
    from rtl_sdr_scanner_tpu_torch.ops.cuda.ddc_kernel import folds

    p = ddc_cfg.plans[0]
    return bool(ddc_cfg.modtap) and folds(p.decim, p.poly_rows, ddc_cfg.num_slots)


def detection_launches(n) -> dict:
    """Launch counts of ``n`` calls of ``compact_detection``: the selection
    kernel and the history vote kernel, once each a call."""
    return {"fused_selection": n, "history_vote": n}


def geo_shifts(geo: Geometry) -> np.ndarray:
    """[bands, slots] slot shifts: slot 0 on the signal's offset, slot 1 at
    ``other_shift``, in every band."""
    return np.tile(np.array([geo.signal_offset_hz, geo.other_shift], dtype=np.int64), (geo.bands, 1))


class MainPath:
    """One geometry at full width: configs, the step with default Tunables
    and its carried state (``drivers.BandedBlocks``, as
    ``benchmark/drivers/step.py`` drives it), and a ring of synthetic cs8
    on the card."""

    def __init__(self, dev, geo: Geometry, ring=None, learn_ms: int = 0):
        """``ring``: blocks to copy to ``dev`` in place of a new ring;
        ``learn_ms``: the noise learning, where not the default."""
        from rtl_sdr_scanner_tpu_torch.drivers import BandedBlocks

        self.dev, self.geo = dev, geo
        self.cfg, self.ddc_cfg, self.group_size = configs(geo)
        if learn_ms:
            self.cfg = dataclasses.replace(self.cfg, noise_learning_ms=learn_ms)
        t0 = time.perf_counter()
        if ring is not None:
            self.ring = [block.to(dev) for block in ring]
        else:
            self.ring = make_ring(geo, self.cfg, dev)
            log(f"ring: {geo.blocks} blocks of [{geo.bands}, {geo.frames}, "
                f"{self.cfg.fft_size * self.cfg.decimator_factor}, 2] int8 on the card in "
                f"{time.perf_counter() - t0:.1f} s")
        self.blocks = BandedBlocks(self.cfg, self.ddc_cfg, self.group_size, TOP_K, geo.bands, geo_shifts(geo), dev)

    def run_block(self, b: int):
        """One block through the step (ring slot b % blocks); returns FusedOutputs."""
        return self.blocks.run_block(b, self.ring[b % self.geo.blocks])


def run_path(dev, card: str, geo: Geometry) -> dict:
    """Drive one geometry for geo.blocks blocks with the launch counts set to
    0 just before; check the counts (PSD and selection once a block, the FIR
    once a chunk for each stage it takes), then what came out; return the
    counts."""
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages, kernel_wrappers

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
        **detection_launches(1),
        "stage_apply_fir": ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
        **modtap_launches(ddc_cfg, 1),
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
    check_detected(packed, geo, cfg, group_size)
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
    free_card()
    return launches


def check_detected(packed: list, geo: Geometry, cfg, group_size: int) -> None:
    """The step's packed rows of each block (a list): from the signal's
    first block on, finite, the noise learned, and candidates above LEVEL
    in the signal's band only, within a group of the planted bin."""
    from rtl_sdr_scanner_tpu_torch.drivers import KEY_SLOTS, LEVEL
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline

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


def runtime_config(capture: Path, rate: int, center: int, channels: int = 0, recording_rate: int = 32_000,
                   **tunables) -> dict:
    """One replay device parked on one range (width <= the hop split rate
    and the band; with ``channels`` >= 2 a wideband device over the whole
    capture), 4 recorder slots, the reference's recording defaults (32 kHz
    unless ``recording_rate`` says), logs at warn on the console only."""
    half = rate // 2 if channels >= 2 else min(1_000_000 if rate >= 2_000_000 else 100_000, rate // 2)
    return {
        "devices": [{
            "enabled": True, "serial": "replay0", "driver": "replay", "sample_rate": rate,
            "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
            "ranges": [{"start": center - half, "stop": center + half}],
            "file": str(capture), "file_format": "cs8", "channels": channels,
        }],
        "ignored_frequencies": [],
        "output": {"color_log_enabled": False, "console_log_level": "warn", "file_log_level": "warn"},
        "recording": {"max_noise_time_ms": 2000, "min_sample_rate": recording_rate, "min_time_ms": 2000,
                      "step": 2500},
        "tunables": {"log_file_name": "", **tunables},
        "version": 2,
        "workers": 4,
    }


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


def run_scanner(config: dict, device, timer: bool = False, on_made=None):
    """One replay scan through ``Scanner.run_to_completion()`` (``on_made``
    runs on the scanner first): (payloads, session, wall seconds,
    SessionTimer or None)."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner

    cfg = Config(json.loads(json.dumps(config)))
    mqtt = NullMqtt()
    mqtt.keep_payloads = True
    scanner = Scanner(cfg, cfg.devices[0], mqtt, cfg.recorders_count(), device=device)
    if on_made is not None:
        on_made(scanner)
    clock = SessionTimer(scanner.device) if timer else None
    t0 = time.perf_counter()
    scanner.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return mqtt.published, scanner.device, time.perf_counter() - t0, clock


def run_runtime(dev, card: str) -> dict:
    """The runtime phase (docstring step 6); returns the kernels' launch
    counts of its card run."""
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages, kernel_wrappers

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
            **detection_launches(blocks),
            "stage_apply_fir": clock.ddc_calls * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
            "analysis_bank": 0,
            **modtap_launches(ddc_cfg, clock.ddc_calls),
        }
        if launches != want or not (blocks and clock.ddc_calls):
            raise RuntimeError(f"session launches {launches}, want {want} (blocks and DDC calls > 0)")

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

    def __init__(self, dev, geo: Geometry, fused: bool, ring: list, shards: int = 1, devices=None, mesh=None):
        from rtl_sdr_scanner_tpu_torch.constants import Tunables
        from rtl_sdr_scanner_tpu_torch.drivers import WidebandBlocks
        from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, scan_pipeline
        from rtl_sdr_scanner_tpu_torch.parallel import mesh as mesh_mod

        self.dev, self.geo, self.fused, self.ring = dev, geo, fused, ring
        cfg = scan_pipeline.ScanConfig.create(geo.rate, geo.frames, Tunables(noise_learning_time_ms=WIDE_LEARN_MS))
        ddc_cfg = ddc_pipeline.DdcConfig.create(geo.rate, geo.bandwidth, geo.slots, cfg.block_samples)
        self.cfg, self.ddc_cfg = cfg, ddc_cfg
        self.group_size = int(np.ceil(geo.bandwidth / cfg.step_hz))
        devices = list(devices) if devices else [dev] * shards  # distinct cards, or copies of one
        # ``mesh``: this process's part of a multi-host bands mesh (its shards only)
        self.mesh = mesh or mesh_mod.make_mesh(len(devices), 1, devices=devices)
        self.blocks = WidebandBlocks(cfg, ddc_cfg, self.group_size, TOP_K, geo.bands, geo_shifts(geo), fused,
                                     self.mesh, dev)

    def run_block(self, blk: int):
        """One block (ring slot blk % WIDE_RING); returns (packed, rec), the
        mesh's channels' rows gathered on the card."""
        from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss

        packed, rec = self.blocks.run_block(blk, self.ring[blk % WIDE_RING])
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
    """The channelizer on the card (the analysis-bank kernel) against the
    same calls on the CPU (the matmul form) and against the kernel's plain
    version on the card, over two streamed halves of WIDE_CHECK_SAMPLES of
    the signal block: within CHAN_TOL (atol = rtol); returns the max |diff|."""
    from rtl_sdr_scanner_tpu_torch.ops import channelizer as ch
    from rtl_sdr_scanner_tpu_torch.ops.cuda import channelizer_kernel

    plan = ch.plan_channelizer(geo.bands)
    x = ring[1][:WIDE_CHECK_SAMPLES]
    half = WIDE_CHECK_SAMPLES // 2
    taps, twiddles = ch._on_device(plan, dev, "bank tables", ch._make_bank_tables)

    def bank(state, part):
        return ch.channelize_block_pairs(plan, state, part)

    def plain(state, part):
        y, tail = channelizer_kernel.analysis_bank_plain(part.T, state.tail, taps, twiddles, plan.taps_per_branch)
        return ch.ChannelizerState(tail=tail), y

    def streamed(fn, d):
        state, parts = ch.init_channelizer_state(plan, d), []
        for i in range(2):
            state, y = fn(state, x[i * half : (i + 1) * half].to(d))
            parts.append(y.cpu())
        return torch.cat(parts, dim=1)

    got = streamed(bank, dev)
    err = 0.0
    for name, ref in (("CPU", streamed(bank, torch.device("cpu"))),
                      ("the plain version on the card", streamed(plain, dev))):
        diff = (got - ref).abs()
        err = max(err, diff.max().item())
        log(f"channelizer [{WIDE_CHECK_SAMPLES}, 2] int8 -> {list(got.shape)} B={geo.bands}, the kernel vs {name} in "
            f"two blocks: max |diff| {diff.max().item():.3g} (max |y| {ref.abs().max().item():.3g})")
        if not (torch.isfinite(got).all() and bool((diff <= CHAN_TOL + CHAN_TOL * ref.abs()).all())):
            raise RuntimeError(f"channelizer: the kernel and {name} differ by {diff.max().item()}")
    return err


def time_bank(dev, card: str) -> dict:
    """The analysis-bank kernel at the wideband step's block (WIDE: 8
    channels of 141,557,760 int8 samples), held against its plain version
    there, timed beside it, its bound and the matmul form it replaced
    (``_bank_mm`` with the int8 widening and the final stack: ``library_ms``)."""
    from rtl_sdr_scanner_tpu_torch.ops import channelizer as ch
    from rtl_sdr_scanner_tpu_torch.ops.cuda import channelizer_kernel as ck

    cfg, _, _ = configs(WIDE)
    b, n = WIDE.bands, WIDE.bands * WIDE.frames * cfg.fft_size * cfg.decimator_factor
    plan = ch.plan_channelizer(b)
    state = ch.init_channelizer_state(plan, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    xs = random_cs8((n, 2), gen, dev).T
    tail = torch.randn((plan.tail_len, 2), generator=gen, device=dev)
    taps, tw = ch._on_device(plan, dev, "bank tables", ch._make_bank_tables)
    t_ = plan.taps_per_branch
    got, got_tail = ck.analysis_bank(xs, tail, taps, tw, t_)
    want, want_tail = ck.analysis_bank_plain(xs, tail, taps, tw, t_)
    diff = (got - want).abs()
    err = diff.max().item()
    if not (bool((diff <= CHAN_TOL + CHAN_TOL * want.abs()).all()) and torch.equal(got_tail, want_tail)):
        raise RuntimeError(f"analysis_bank at [{n}, 2]: the kernel and its plain version differ by {err}")
    del got, want, diff
    t = timings(lambda: ck.analysis_bank(xs, tail, taps, tw, t_),
                lambda: ck.analysis_bank_plain(xs, tail, taps, tw, t_), 20, "analysis_bank", 3)
    library_ms = cuda_ms(lambda: torch.stack(ch._bank_mm(plan, state, ck.dequantize(xs))[1:], dim=-1), 5)
    # the stream read once (int8), the channels written once (f32 pairs);
    # B branch FIRs of T complex taps and a B-point FFT a channel sample time
    bound_ms, bound_by = bound(n * (2 + 8), n // b * (b * t_ * 4 + 5 * b * math.log2(b)))
    log(f"analysis bank [{n}, 2] int8 -> [{b}, {n // b}, 2] T={t_}: {fmt(t)}, the matmul form it replaced "
        f"{library_ms:.3f} ms, bound {bound_ms:.4g} ms ({bound_by}) on {card}")
    # the dongle's session runs no channelizer: the wideband session launches it
    record = dict(name="analysis_bank", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/channelizer_kernel.cu",
                  replaces=None, launches=None, session_path="wideband_runtime_serial", max_abs_err=err)
    record_time(record, WIDE.key, **t, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    del xs, tail
    free_card()
    return record


def time_ddc(dev, card: str, rows=DDC_TIMED) -> dict:
    """The modulated-taps stage-1 kernel at each row's chunk, held against
    its plain version (the matmul form with its operand handling and the
    rotation: today's chain before the kernel) there and timed beside it,
    its bound and the matmul form's ``bmm`` alone on its prepared operands
    (``library_ms``); the form the shape takes (``form``) and each form's
    kernel device time through its own entry point where it fits
    (``lag_device_ms``, ``fold_device_ms``: a small chunk's pace is the
    host's), each held as the wrapper is; the record's top level holds the
    first row's."""
    import torch.nn.functional as F

    from rtl_sdr_scanner_tpu_torch.ops import ddc
    from rtl_sdr_scanner_tpu_torch.ops.cuda import ddc_kernel as dk

    ddc.no_tf32()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rate = 20_480_000
    record = dict(name="modtap_stage1", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/ddc_kernel.cu",
                  replaces=None, launches=None, session_path="wideband_runtime_serial", max_abs_err=0.0)
    for key, name, nb, k, m, n, int8 in rows:
        plan = ddc.plan_stage(1, m)
        r = plan.poly_rows
        shifts = np.random.default_rng(m).integers(-rate // 2, rate // 2, size=(nb, k))
        tables = ddc.make_mod_tables([plan], shifts, rate, n, dev)
        if int8:
            x = random_cs8((nb, n, 2), gen, dev)
        else:
            x = torch.rand((nb, n, 2), generator=gen, device=dev).mul_(1.6).sub_(0.8)
        tail = torch.rand((nb, 2, plan.tail_len), generator=gen, device=dev).sub_(0.5)
        phase = torch.rand((nb, k), generator=gen, device=dev).mul_(2 * math.pi)
        args = (x, tail, phase, tables, plan)
        want, want_tail = dk.modtap_stage1_plain(*args)
        scale = want.abs().max().item()

        def held(got, got_tail, form) -> float:
            d = (got - want).abs().max().item()
            if not (torch.isfinite(got).all() and d <= DDC_REL_TOL * scale and torch.equal(got_tail, want_tail)):
                raise RuntimeError(f"modtap_stage1 ({name}, {form}): max |diff| {d} against max |y| {scale}, or the "
                                   f"tail differs")
            return d

        form = "fold" if dk.folds(m, r, k) else "lag"
        d = held(*dk.modtap_stage1(*args), form)
        record["max_abs_err"] = max(record["max_abs_err"], d)
        t = timings(lambda: dk.modtap_stage1(*args), lambda: dk.modtap_stage1_plain(*args), 20, "modtap", 5)
        # each form through its own entry point, its B in that form's layout
        g = ddc.modtap_taps(tables.w.cpu().numpy(), plan)
        fits = {"lag": dk.kernel_form(m, r, int8) is not None,
                "fold": dk.fold_ntiles(k) <= dk.FOLD_MAX_NTILES and any(
                    dk.fold_smem_bytes(m, r, k, mt, 1 if int8 else 4) <= dk.MAX_SMEM for mt in dk.FOLD_FORMS)}
        forms_ms = {}
        for each, entry, b, kernel in (("lag", "modtap_stage1", dk.mod_b, "modtap_stage1_kernel"),
                                       ("fold", "modtap_fold", dk.mod_b_fold, "modtap_fold_kernel")):
            if not fits[each]:
                forms_ms[f"{each}_device_ms"] = None
                continue
            forced = tables._replace(frag=torch.from_numpy(dk.pack_fragments(b(g, m, r))).to(dev))
            fargs = (entry, x, tail, phase, forced, plan)
            record["max_abs_err"] = max(record["max_abs_err"], held(*dk.launch(*fargs), each))
            forms_ms[f"{each}_device_ms"] = device_ms(lambda: dk.launch(*fargs), 20, kernel)
            del forced
        del want
        # the matmul form's product alone, on the operands it pads and chunks
        c, dd, q = plan.chunk_c, plan.chunk_d, plan.chunk_q
        out = n // m
        n_chunks = -(-out // (c // m)) + dd - 1
        full = torch.cat([tail, torch.stack(ddc._components(x), dim=1)], dim=-1)
        lhs = F.pad(full, (q - plan.tail_len, n_chunks * c - q - n)).reshape(nb, 2 * n_chunks, c)
        library_ms = cuda_ms(lambda: torch.bmm(lhs, tables.w), 5)
        del full, lhs
        # the chunk read once (int8 or f32 pairs), y written once, the tails
        # and B fragments; the tensor cores' passes (two on integers, three
        # on f32): the lag form's over each column group's 4R live columns
        # of Z, the folded form's over the 2K live columns of its R 2M deep
        # product
        passes = 2 if int8 else 3
        bytes_moved = nb * n * 2 * x.element_size() + nb * k * 2 * out * 4 + 2 * nb * 2 * plan.tail_len * 4 \
            + tables.frag.numel() * 4
        if form == "fold":
            flops = passes * 2.0 * nb * out * r * 2 * m * 2 * k
        else:
            flops = passes * 2.0 * nb * dk.groups(k) * (out + r - 1) * 2 * m * 4 * r
        bound_ms, bound_by = bound(bytes_moved, flops, TF32_FLOPS)
        paces = ", ".join(f"{f} {v:.4f} ms" for f, v in forms_ms.items() if v is not None)
        both = [v for v in forms_ms.values() if v is not None]
        # a chunk whose kernels take less device time than a call's host time is paced by the host: the forms tie
        if max(both) * 1e3 >= t["host_us"] and min(both) * (1 + FORM_SLACK) < forms_ms[f"{form}_device_ms"]:
            raise RuntimeError(f"modtap_stage1 ({name}): the {form} form taken is the slower: {paces}")
        log(f"modtap stage 1 [{nb}, {n}, 2] {x.dtype} M={m} K={k} R={r} ({name}), {form} form: {fmt(t)}; each form "
            f"alone {paces}; the matmul form's bmm alone {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP TF32); max |diff| {d:.3g} ({d / scale:.3g} of "
            f"max |y|) on {card}")
        record_time(record, key, **t, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, form=form,
                    **forms_ms)
        del x, tail, tables
        free_card()
    return record


def run_wideband_step(dev, card: str) -> dict:
    """The wideband step phase (docstring step 6): the channelizer held card
    vs CPU, then the fused and the split forms for WIDE.blocks blocks each,
    each with the launch counts set to 0 just before and read just after;
    returns {form: counts}."""
    from rtl_sdr_scanner_tpu_torch.drivers import KEY_SLOTS, LEVEL, fir_stages, kernel_wrappers
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
        want = {"psd_frames_int8": 0, **detection_launches(geo.blocks),
                "stage_apply_fir": geo.blocks * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
                "analysis_bank": geo.blocks, **modtap_launches(ddc_cfg, geo.blocks)}
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
        free_card()
    del ring
    free_card()
    return launches


class WidebandTimer(SessionTimer):
    """SessionTimer for a WidebandScanner: CUDA events around each dispatch
    (serial: the channelizer and every session's scan and DDC; batched: the
    wideband step, the fused step or the banded DDC), the host clock around
    each synchronised ``step`` that processed a block."""

    def __init__(self, scanner):
        self.block = 0
        self.spans, self.walls, self.ddc_calls = [], [], 0
        self.stamps = []  # (start, end) of each block on the host's epoch clock
        targets = [(scanner, "_channelize")]
        for session in scanner.sessions:
            targets += [(session, "_scan_step"), (session, "_ddc_step")]
        targets += [(scanner, n) for n in ("_wide_step", "_fused_step", "_ddc_band_step")
                    if getattr(scanner, n, None) is not None]
        for obj, name in targets:
            setattr(obj, name, self._timed(getattr(obj, name), "ddc" in name))
        step = scanner.step

        def timed_step():
            t0, e0 = time.perf_counter(), time.time()
            more = step()
            torch.cuda.synchronize()
            if more:
                self.walls.append((time.perf_counter() - t0) * 1e3)
                self.stamps.append((e0, time.time()))
                self.block += 1
            return more

        scanner.step = timed_step


def run_wideband_scanner(config: dict, device, timer: bool = False, cards=None, on_made=None):
    """One replay scan through ``WidebandScanner.run_to_completion()`` and
    ``stop()`` (its meshes over ``cards`` where given, else the visible
    cards; ``on_made`` runs on the scanner first): (payloads, scanner, wall
    seconds, WidebandTimer or None)."""
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner

    cfg = Config(json.loads(json.dumps(config)))
    mqtt = NullMqtt()
    mqtt.keep_payloads = True
    scanner = WidebandScanner(cfg, cfg.devices[0], mqtt, cfg.recorders_count(), device=device, cards=cards)
    if on_made is not None:
        on_made(scanner)
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
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers

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
            # the modulated-taps kernel runs a chunk's launch for each DDC
            # dispatch, whose count the session keeps to itself
            ddc_runs = counts["modtap_stage1"]
            if not session.ddc_cfg.modtap or ddc_runs == 0 or ddc_runs % session.ddc_cfg.num_chunks:
                raise RuntimeError(f"wideband session {form}: {ddc_runs} modulated-taps launches")
            want = {"psd_frames_int8": 0, **detection_launches(blocks * (WB_CHANNELS if form == "serial" else 1)),
                    "stage_apply_fir": 0, "analysis_bank": blocks,
                    **modtap_launches(session.ddc_cfg, ddc_runs // session.ddc_cfg.num_chunks)}
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
    time-sharded scan and modulated-taps DDC (graphed) over a mesh of
    TMESH_SHARDS copies of the card, or of the cards ``devices`` names
    (``sharded``), or the one-card compact step and DDC; a device-resident ring of
    TMESH.blocks blocks on ``dev``, FM keyed from block 1."""

    def __init__(self, dev, sharded: bool, ring=None, devices=None):
        from rtl_sdr_scanner_tpu_torch.drivers import KEY_SLOTS, LEVEL
        from rtl_sdr_scanner_tpu_torch.graph import sharded_step
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
            self.scan_step = sharded_step(ss.make_time_sharded_scan(cfg, m, group_size, TOP_K), "time-sharded scan")
            self.ddc_step = sharded_step(ss.make_time_sharded_modtap_ddc(ddc_cfg, m), "time-sharded DDC")
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
    from rtl_sdr_scanner_tpu_torch.drivers import LEVEL, fir_stages, kernel_wrappers

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
        if form == "time_mesh":
            hold_captures(form, [path.scan_step, path.ddc_step])
            replays = {k: hold_replays(form, [step], geo.blocks)
                       for k, step in (("scan", path.scan_step), ("DDC", path.ddc_step))}
        # the time-sharded DDC keeps stage 1's matmul form
        want = {"psd_frames_int8": shards * geo.blocks, **detection_launches(shards * geo.blocks),
                "stage_apply_fir": shards * geo.blocks * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
                "analysis_bank": 0, **modtap_launches(ddc_cfg, 0 if form == "time_mesh" else geo.blocks)}
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
    log(f"time mesh: {sharded:.1f} ms a {cfg.block_samples / cfg.sample_rate * 1e3:.0f} ms block on {where}, "
        f"{sum(replays.values())} graph replays a block ({replays['scan']} scan + {replays['DDC']} DDC), "
        f"vs {one:.1f} ms one-card (blocks 1..{geo.blocks - 1}; first {block_ms['time_mesh'][0]:.1f} / "
        f"{block_ms['time_mesh_one_card'][0]:.1f} ms) on {card}")
    del paths, ring
    free_card()
    return launches


def run_band_shards(dev, card: str, devices=None) -> dict:
    """Step 10b: the wideband step (step 7's stream and channels) over a
    band mesh of BAND_SHARDS copies of the card, fused and split, MESH_BLOCKS
    blocks, each against the one-card form on the same ring, the launch
    counts set to 0 just before each run. ``devices``: distinct cards in
    place of copies of ``dev``. Returns {form: counts}."""
    from rtl_sdr_scanner_tpu_torch.drivers import KEY_SLOTS, LEVEL, fir_stages, kernel_wrappers
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
            hold_captures(f"wideband {form}", [step.blocks.step] if fused else [step.blocks.wide_step,
                                                                               step.blocks.ddc_step])
            want = {"psd_frames_int8": 0, **detection_launches(shards * MESH_BLOCKS),
                    "stage_apply_fir": shards * MESH_BLOCKS * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
                    "analysis_bank": shards * MESH_BLOCKS, **modtap_launches(ddc_cfg, shards * MESH_BLOCKS)}
            if counts != want:
                raise RuntimeError(f"wideband {form} over {shards} shard(s): launches {counts}, want {want}")
            key = f"wideband_step_{shards}_shards_{form}" if shards > 1 else f"wideband_step_one_card_{form}"
            launches[key] = counts
            runs[shards] = (out, times)
            del step
            free_card()
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
    free_card()
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
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers
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


# -- step 11: the multi-host layer -------------------------------------------------


def machine_cards() -> int:
    """The machine's cards (``nvidia-smi -L``; CUDA_VISIBLE_DEVICES does not
    hide any from it)."""
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, check=True, timeout=60)
    return sum(1 for line in out.stdout.splitlines() if line.startswith("GPU "))


def run_children(mode: str, root: Path, *args, timeout_s: float = CHILD_TIMEOUT_S) -> list:
    """MH_WORLD processes of this script in child ``mode`` (ranks 0..n-1,
    one process group), each rank on its own card where the machine has one
    a rank, else all on card 0. Returns their output; a child that exits
    non-zero, or outlives ``timeout_s``, raises."""
    own_cards = machine_cards() >= MH_WORLD
    ran = spawn_ranks(
        lambda rank, port: [sys.executable, Path(__file__).resolve(), "--child", mode, rank, MH_WORLD, port, root, *args],
        MH_WORLD, timeout_s, env_of=lambda rank: {"CUDA_VISIBLE_DEVICES": str(rank) if own_cards else "0"},
    )
    outs = [out for _, out in ran]
    for rank, (rc, out) in enumerate(ran):
        if rc != 0:
            raise RuntimeError(f"{mode} child {rank} exited {rc}:\n{out[-4000:]}")
        for line in out.splitlines():
            if line.startswith("child "):
                log(f"[rank {rank}] {line}")
    return outs


def session_pace(walls: list, device_ms: list, block_samples: int) -> str:
    """ms a block (wall, device span) of a timed wideband session's blocks
    1.., and its real-time factor over them and over every block (the
    first holds the cuBLAS and allocator warm-up)."""
    wall, device = float(np.mean(walls[1:])), float(np.mean(device_ms[1:]))
    block_s = block_samples / MH_RATE
    return (f"{wall:.2f} ms a block (device {device:.2f}, host {wall - device:.2f}; blocks 1..{len(walls) - 1}; "
            f"first {walls[0]:.1f}), real-time factor {block_s / (wall / 1e3):.2f} over blocks 1.. and "
            f"{len(walls) * block_s / (sum(walls) / 1e3):.2f} over all")


def run_multihost_session(dev, card: str, root: Path) -> dict:
    """Step 11a: the one-process card run on 2 band shards of copies of the
    card, then MH_WORLD processes through main.run; each process's payloads
    against the one-process run's of its bands. Returns {form: counts}."""
    import pickle

    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers

    log(f"---- step 11a: the multi-host session, {MH_WORLD} processes through main.run")
    wrappers = kernel_wrappers()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as tmp:
        capture = Path(tmp) / "mh.cs8"
        write_capture(capture, MH_RATE, MH_SECONDS, MH_SIGNALS, MH_KEY, seed=23)
        config = runtime_config(capture, MH_RATE, MH_CENTER, channels=MH_CHANNELS, mesh_bands=-1, multihost=True)
        config["recording"] = dict(MH_RECORDING)
        config_path = Path(tmp) / "config.json"
        config_path.write_text(json.dumps(config))
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        one, scanner, _, clock = run_wideband_scanner(config, dev, timer=True, cards=[dev] * MH_WORLD)
        launches["multihost_one_process"] = {name: fn.launches for name, fn in wrappers.items()}
        if scanner._mesh.shape != {"bands": MH_WORLD, "time": 1}:
            raise RuntimeError(f"the one-process run's mesh is {scanner._mesh.shape}")
        wide_block = scanner._wide_block
        recorded = []
        for shift, tone in MH_SIGNALS:
            center, n_rec, got = recorded_tone(one, MH_CENTER + shift, 16_000)
            if abs(got - tone) >= 40 or n_rec < 2 * 16_000:
                raise RuntimeError(f"one process: the transmission at {shift:+d} Hz was not recorded ({n_rec}, {got} Hz)")
            recorded.append((band_of(center), n_rec, round(got, 1)))
        log(f"one process, {MH_WORLD} band shards of one card: {len(one)} payloads, recorded (channel, samples, tone) "
            f"{recorded}; {session_pace(clock.walls, clock.device_ms(), wide_block)}; launches "
            f"{launches['multihost_one_process']} on {card}")
        run_children("session", root, config_path, Path(tmp) / "session{rank}.pkl")
        children = []
        for rank in range(MH_WORLD):
            with open(Path(tmp) / f"session{rank}.pkl", "rb") as fh:
                children.append(pickle.load(fh))
        # the span in which every process ran its blocks after the first
        together = (max(c["stamps"][1][0] for c in children), min(c["stamps"][-1][1] for c in children))
        seen = []
        for rank, child in enumerate(children):
            bands = set(child["bands"])
            seen += child["bands"]
            want = [(t, p) for t, p in one if payload_band(t, p) in bands]
            if not child["multihost"] or not child["published"]:
                raise RuntimeError(f"process {rank}: multihost {child['multihost']}, {len(child['published'])} payloads")
            stats = compare_payloads(want, child["published"])
            launches[f"multihost_session_rank{rank}"] = child["launches"]
            if child["launches"]["fused_selection"] != child["blocks"]:
                raise RuntimeError(f"process {rank}: launches {child['launches']} over {child['blocks']} blocks")
            both = [w for w, (t0, t1) in zip(child["walls"][1:], child["stamps"][1:])
                    if together[0] <= t0 and t1 <= together[1]]
            log(f"process {rank}/{MH_WORLD}: channels {child['bands']} (global band shards {child['shards']} of "
                f"{child['n_shards']}), {len(child['published'])} payloads against the one-process run's of its "
                f"channels: {stats}; {session_pace(child['walls'], child['device_ms'], wide_block)}; of these, "
                f"{len(both)} blocks while every process ran its own: "
                f"{np.mean(both) if both else float('nan'):.2f} ms a block; launches {child['launches']} on {card}")
        if sorted(seen) != list(range(MH_CHANNELS)):
            raise RuntimeError(f"the processes' channels {sorted(seen)} do not cover the {MH_CHANNELS} once")
    return launches


def run_multihost_step(dev, card: str, root: Path) -> dict:
    """Step 11b: step 7's wideband step, the one-process 2-shard form on
    copies of the card, then each of MH_WORLD processes on its own shard;
    each process's rows and recordings against its shard's. Returns
    {form: counts}."""
    import pickle

    from rtl_sdr_scanner_tpu_torch.drivers import KEY_SLOTS, LEVEL, kernel_wrappers
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline

    log(f"---- step 11b: the wideband step at full width, {MH_WORLD} processes of one band shard each")
    geo = WIDE
    cfg = scan_pipeline.ScanConfig.create(geo.rate, geo.frames)
    ring = wide_ring(geo, cfg.block_samples, dev)
    wrappers = kernel_wrappers()
    ref, launches = {}, {}
    for fused in (True, False):
        form = "fused" if fused else "split"
        step = WidebandStep(dev, geo, fused, ring, MH_WORLD)
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        ref[form] = run_step_blocks(step)
        launches[f"multihost_step_one_process_{form}"] = {name: fn.launches for name, fn in wrappers.items()}
        del step
        free_card()
    del ring
    free_card()
    b_loc = geo.bands // MH_WORLD
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mhs_") as tmp:
        run_children("step", root, Path(tmp) / "step{rank}.pkl")
        children = []
        for rank in range(MH_WORLD):
            with open(Path(tmp) / f"step{rank}.pkl", "rb") as fh:
                children.append(pickle.load(fh))
    for form in ("fused", "split"):
        packed_1, rec_1, ms_1, _ = ref[form]
        hits, paces = {}, []
        for rank, child in enumerate(children):
            (g,) = child["shards"]
            packed, rec, ms, host = child[form]["run"]
            rows = slice(g * b_loc, (g + 1) * b_loc)
            if not (np.array_equal(packed, packed_1[:, rows]) and np.array_equal(rec, rec_1[:, rows])):
                raise RuntimeError(f"wideband {form}: process {rank}'s rows or recordings differ from band shard {g} "
                                   "of the one-process run")
            eager = child[form]["eager"]
            e_packed, e_rec, e_ms, e_host = eager["run"]
            if not (np.array_equal(packed, e_packed) and np.array_equal(rec, e_rec)):
                raise RuntimeError(f"wideband {form}: process {rank}'s graphed rows or recordings differ from eager")
            if eager["launches"] != child[form]["launches"] or child[form]["captures"] != (1 if form == "fused" else 2):
                raise RuntimeError(f"wideband {form}: process {rank} launches eager {eager['launches']}, graphed "
                                   f"{child[form]['launches']}, {child[form]['captures']} captures")
            median = lambda xs: float(np.median(xs[1:]))
            c = child[form]
            log(f"wideband {form}, process {rank}: graphed equal to eager bit for bit; eager {median(e_ms):.3f} ms a "
                f"block (host {median(e_host):.3f}), graphed {median(ms):.3f} (host {median(host):.3f}), median of "
                f"blocks 1.. each synchronised; back to back eager {eager['pace_ms']:.3f}, graphed {c['pace_ms']:.3f}; "
                f"the graphs' device span {c['device_ms']:.3f} ms a block: busy {c['device_ms'] / median(e_ms):.1%} "
                f"eager, {c['device_ms'] / median(ms):.1%} graphed; {c['captures']} captures in {c['capture_s']:.3f} "
                f"s, pool {c['pool_bytes']} bytes ({c['pool_bytes'] / 2**20:.1f} MiB) on {card} (both processes on it)")
            counts = child[form]["launches"]
            ddc_cfg = child["ddc"]
            want = {"psd_frames_int8": 0, **detection_launches(MESH_BLOCKS),
                    "stage_apply_fir": MESH_BLOCKS * ddc_cfg[0] * ddc_cfg[1], "analysis_bank": MESH_BLOCKS,
                    "modtap_stage1": MESH_BLOCKS * ddc_cfg[0] * ddc_cfg[2],
                    "modtap_stage1_fold": MESH_BLOCKS * ddc_cfg[0] * ddc_cfg[3]}
            if counts != want:
                raise RuntimeError(f"wideband {form}: process {rank} launches {counts}, want {want}")
            launches[f"multihost_step_rank{rank}_{form}"] = counts
            for b in range(MESH_BLOCKS):
                for ch in range(b_loc):
                    if (scan_pipeline.unpack_compact(packed[b, ch], geo.frames, TOP_K, KEY_SLOTS)[1] >= LEVEL).any():
                        hits.setdefault(rank, set()).add(g * b_loc + ch)
            paces.append(f"process {rank} {np.mean(ms[1:]):.1f}")
        owner = geo.signal_band // b_loc
        if hits != {owner: {geo.signal_band}}:
            raise RuntimeError(f"wideband {form}: channels with candidates above {LEVEL} dB by process: {hits}")
        log(f"wideband {form}: each process's rows and recordings bit-equal to its shard of the one-process run; "
            f"FM in channel {geo.signal_band} found by process {owner} only; ms a block (blocks 1..{MESH_BLOCKS - 1}): "
            f"{', '.join(paces)} vs one process on {MH_WORLD} shards {np.mean(ms_1[1:]):.1f} on {card}")
    return launches


def run_step_blocks(step) -> tuple:
    """MESH_BLOCKS blocks of a WidebandStep, each synchronised: (packed
    [blocks, B, L], rec [blocks, B, K, out, 2], ms a block, host ms until
    the call returned)."""
    packed, rec, ms, host = [], [], [], []
    for b in range(MESH_BLOCKS):
        t0 = time.perf_counter()
        p, r = step.run_block(b)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        packed.append(p.cpu().numpy())
        rec.append(r.cpu().numpy())
    return np.stack(packed), np.stack(rec), ms, host


def run_dryrun(dev, card: str) -> dict:
    """Step 11c: dryrun_multichip(4) on 4 copies of the card."""
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers
    from rtl_sdr_scanner_tpu_torch.dryrun import dryrun_multichip

    log("---- step 11c: dryrun_multichip(4) on 4 copies of the card")
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    dryrun_multichip(4, device=dev)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    log(f"dryrun_multichip(4): {time.perf_counter() - t0:.1f} s, launches {counts} on {card}")
    return {"dryrun_multichip": counts}


def run_vote_forms(dev, card: str) -> dict:
    """Step 11d: paths 1 and 2 (VOTE_BLOCKS blocks, the signal from block 1)
    through the eager fused step in f32 and bf16 detection, the history vote
    on its kernel. Each call of compact_detection is held against each plain
    lowering of the vote (``ops/detect.VOTE_FORM``: the code and the gather
    form, ``history_vote_plain`` called on the same rows on the card): the
    voted bins bit-equal, and the packed output's votes are the kernel's.
    Times compact_detection, the kernel alone and each plain lowering with
    CUDA events. Returns {run: counts}."""
    from rtl_sdr_scanner_tpu_torch.drivers import KEY_SLOTS, LEVEL, BandedBlocks, kernel_wrappers
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline
    from rtl_sdr_scanner_tpu_torch.ops import detect
    from rtl_sdr_scanner_tpu_torch.ops.cuda.vote_kernel import history_vote

    log("---- step 11d: the history vote kernel against the plain lowerings")
    wrappers = kernel_wrappers()
    launches = {}
    real = scan_pipeline.compact_detection

    def events_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    try:
        for geo in (PATH1, PATH2):
            g = dataclasses.replace(geo, blocks=VOTE_BLOCKS, signal_from_block=1)
            path = MainPath(dev, g)
            for bf16 in (False, True):
                cfg = dataclasses.replace(path.cfg, detection_bf16=bf16, noise_learning_ms=WIDE_LEARN_MS)
                dtype = "bf16" if bf16 else "f32"
                calls = []

                def timed(avg, raw, prev_tail, keys, valid_mask, start_level, group_size, top_k, bf16=False):
                    out, ms = events_ms(lambda: real(avg, raw, prev_tail, keys, valid_mask, start_level,
                                                     group_size, top_k, bf16=bf16))
                    calls.append((raw, prev_tail, start_level, group_size, bf16, out, ms))
                    return out

                scan_pipeline.compact_detection = timed
                path.blocks = BandedBlocks(cfg, path.ddc_cfg, path.group_size, TOP_K, g.bands, geo_shifts(g), dev)
                # the eager step: compact_detection is timed around its own
                # launches, which a captured graph runs unseen
                path.blocks.step = path.blocks.step.fn
                torch.cuda.synchronize()
                for fn in wrappers.values():
                    fn.launches = 0
                packed = [path.run_block(b).packed.cpu().numpy() for b in range(VOTE_BLOCKS)]
                launches[f"vote_kernel_{dtype}_{geo.key}"] = {name: fn.launches for name, fn in wrappers.items()}
                scan_pipeline.compact_detection = real
                ms = {"compact_detection": [], "history_vote": [], "code": [], "gather": []}
                moved = live = 0
                for b, (raw, prev_tail, level, group_size, vote_bf16, out, call_ms) in enumerate(calls):
                    args = (raw, prev_tail, out.cand_idx, group_size // 2, level.to(torch.float32),
                            prev_tail.shape[1] + 1, vote_bf16)
                    kernel, kernel_ms = events_ms(lambda: history_vote(*args))
                    ms["compact_detection"].append(call_ms)
                    ms["history_vote"].append(kernel_ms)
                    if not torch.equal(kernel, out.cand_best):
                        raise RuntimeError(f"{geo.name}, {dtype} detection, block {b}: the kernel's votes differ "
                                           "from one call to the next")
                    for form in ("code", "gather"):
                        detect.VOTE_FORM = form
                        plain, plain_ms = events_ms(lambda: detect.history_vote_plain(*args))
                        ms[form].append(plain_ms)
                        if not torch.equal(plain, out.cand_best):
                            bad = int((plain != out.cand_best).sum())
                            raise RuntimeError(f"{geo.name}, {dtype} detection, block {b}: the kernel's votes "
                                               f"differ from the plain {form} form's at {bad} candidates")
                    detect.VOTE_FORM = "code"
                    best = out.cand_best.cpu().numpy()
                    for band in range(g.bands):
                        idx, val, got = scan_pipeline.unpack_compact(packed[b][band], g.frames, TOP_K, KEY_SLOTS)[:3]
                        if not np.array_equal(got, best[band]):
                            raise RuntimeError(f"{geo.name}, {dtype} detection, block {b}, band {band}: the packed "
                                               "votes are not the kernel's")
                        moved += int((got != idx).sum())
                        live += int((val >= LEVEL).sum()) if band == g.signal_band else 0
                if moved == 0 or live == 0:
                    raise RuntimeError(f"{geo.name}, {dtype} detection: no vote moved a candidate ({moved}) or no "
                                       f"candidate cleared the level in the signal's band ({live})")
                mean = {k: np.mean(v[1:]) for k, v in ms.items()}
                log(f"{geo.name}, {dtype} detection: the kernel's votes bit-equal to the code and gather forms' "
                    f"over {VOTE_BLOCKS} blocks ({moved} candidates moved by their vote, {live} above {LEVEL} dB "
                    f"in band {g.signal_band}); ms a block (CUDA events, blocks 1..{VOTE_BLOCKS - 1}): "
                    f"compact_detection {mean['compact_detection']:.3f}, the vote kernel "
                    f"{mean['history_vote']:.3f}, plain code form {mean['code']:.2f}, plain gather form "
                    f"{mean['gather']:.2f} on {card}")
                del calls
            del path
            free_card()
    finally:
        scan_pipeline.compact_detection = real
        detect.VOTE_FORM = "code"
    return launches


def run_multi_host(dev, card: str, root: Path) -> dict:
    """Step 11: the session and the wideband step over MH_WORLD processes,
    the dry run on 4 copies of the card, the history vote kernel. Returns
    {form: counts}."""
    free_card()
    launches = run_multihost_session(dev, card, root)
    launches.update(run_multihost_step(dev, card, root))
    launches.update(run_dryrun(dev, card))
    launches.update(run_vote_forms(dev, card))
    return launches


# -- step 12: every fft the JAX package scans --------------------------------------


def check_narrow_kernels(dev) -> tuple:
    """Step 12a: the PSD kernel's small-frame form and its scratch form at
    2^21-2^22, and the selection kernel's register form (and its row-split
    form at 2^21), against their plain versions; returns the max |diff| of
    each."""
    log("---- step 12a: the kernels' forms for fft <= 128 and 2^21-2^22")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    psd_err = max(check_psd(fft, decim, frames, gen, dev) for fft, decim, frames in NARROW_PSD_CASES)
    sel_err = max(check_selection(fft, submargin, dev, top_k, k_sep, n_rows)
                  for fft, top_k, k_sep, submargin, n_rows in NARROW_SELECT_CASES)
    return psd_err, sel_err


def run_narrow_wideband(dev, card: str, tmp: Path) -> dict:
    """Step 12b: the 64-channel session through main.run on the card in
    each batched form, against the same form's CPU run; returns {form:
    counts}."""
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers

    log(f"---- step 12b: {NARROW_WIDE.name}, main.run")
    wrappers = kernel_wrappers()
    capture = tmp / "narrow_wide.cs8"
    write_capture(capture, NW_RATE, NW_SECONDS, NW_SIGNALS, NW_KEY, seed=11)
    launches = {}
    for form, tunables in NW_FORMS:
        config = runtime_config(capture, NW_RATE, WB_CENTER, channels=NW_CHANNELS, recording_rate=NARROW_REC_RATE,
                                **tunables)
        config_path = tmp / f"narrow_wide_{form}.json"
        config_path.write_text(json.dumps(config))
        sessions = []
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc, card_payloads = run_main(config_path, dev, on_made=sessions.append)
        wall_s = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in wrappers.items()}
        if rc != 0:
            raise RuntimeError(f"main.run returned {rc}")
        scanner = sessions[0]
        cfg = scanner.sessions[0].scan_cfg
        blocks = counts["fused_selection"]
        log(f"{form}: {NW_CHANNELS} channels of {cfg.sample_rate} sps, fft {cfg.fft_size} decim "
            f"{cfg.decimator_factor} frames {cfg.frames_per_block}; launches over the card run: {counts} (f32 "
            f"channels: no PSD kernel; 32 -> 16 kHz is one modulated-taps stage: no FIR stage)")
        if counts["fused_selection"] == 0 or counts["psd_frames_int8"] != 0 or counts["analysis_bank"] == 0:
            raise RuntimeError(f"64-channel session {form} launches {counts}")
        launches[f"narrow_wideband_{form}"] = counts
        cpu_payloads, _, cpu_s, _ = run_wideband_scanner(config, torch.device("cpu"))
        stats = compare_payloads(cpu_payloads, card_payloads)
        found = []
        for shift, tone in NW_SIGNALS:
            center, n_rec, got = recorded_tone(card_payloads, WB_CENTER + shift, NARROW_REC_RATE)
            if abs(got - tone) >= 40 or n_rec < NARROW_REC_RATE:
                raise RuntimeError(f"the transmission at {shift} Hz was not recorded: {n_rec} samples, tone {got}")
            found.append((center, n_rec, round(got, 1)))
        stream_s = blocks * cfg.block_samples * NW_CHANNELS / NW_RATE
        log(f"{form}: card (main.run) vs CPU payloads: {stats} (CPU run {cpu_s:.1f} s); recorded {found}; "
            f"{blocks} blocks, {stream_s:.2f} s of stream in {wall_s:.2f} s of main.run (session set-up "
            f"included) on {card}")
    return launches


def run_narrow_session(dev, card: str, tmp: Path) -> dict:
    """Step 12c: one int8 32 kHz band (fft 128: the PSD's small-frame form
    and the selection's register form) through Scanner on the card against
    the CPU; returns the card run's counts."""
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers

    log(f"---- step 12c: {NARROW_RT.name}")
    wrappers = kernel_wrappers()
    capture = tmp / "narrow.cs8"
    write_capture(capture, NB_RATE, NB_SECONDS, NB_SHIFT, NB_KEY)
    config = runtime_config(capture, NB_RATE, RT_CENTER, recording_rate=NARROW_REC_RATE)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    card_payloads, session, wall_s, clock = run_scanner(config, dev, timer=True)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    cfg, ddc_cfg, blocks = session.scan_cfg, session.ddc_cfg, clock.block
    log(f"fft {cfg.fft_size} decim {cfg.decimator_factor} frames {cfg.frames_per_block}, DDC stages "
        f"{[(p.interp, p.decim) for p in ddc_cfg.plans]} ({'folded' if stage1_folds(ddc_cfg) else 'lag'} stage-1 "
        f"form), {ddc_cfg.num_slots} slots; {blocks} blocks, DDC dispatched in {clock.ddc_calls}; launches {counts}")
    want = modtap_launches(ddc_cfg, clock.ddc_calls)
    if (counts["psd_frames_int8"] != blocks or counts["fused_selection"] != blocks or not clock.ddc_calls
            or {name: counts[name] for name in want} != want):
        raise RuntimeError(f"32 kHz session launches {counts}, want PSD and selection {blocks} each and {want} "
                           f"(DDC calls > 0)")
    cpu_payloads, _, cpu_s, _ = run_scanner(config, torch.device("cpu"))
    stats = compare_payloads(cpu_payloads, card_payloads)
    center, n_rec, tone = recorded_tone(card_payloads, RT_CENTER + NB_SHIFT, NARROW_REC_RATE)
    if abs(tone - RT_TONE) >= 40 or n_rec < 2 * NARROW_REC_RATE:
        raise RuntimeError(f"the 32 kHz band's transmission was not recorded: {n_rec} samples, tone {tone} Hz")
    stream_s = blocks * cfg.block_samples / cfg.sample_rate
    wall_ms = float(np.mean(clock.walls[1:]))
    log(f"card vs CPU payloads: {stats} (CPU run {cpu_s:.2f} s); recorded {n_rec} samples at {center} Hz, tone "
        f"{tone:.1f} Hz; {wall_ms:.2f} ms a block (blocks 1..{blocks - 1}), real-time factor "
        f"{stream_s / wall_s:.1f} on {card}")
    return counts


def hold_step_against_cpu(got: list, want: list, frames: int) -> dict:
    """The compact step's (packed, recording) blocks from the card against
    the same blocks through the step on the CPU: noise readiness and the
    counts at level equal; candidate indices and voted bins equal but for <
    0.5% near-ties, where the top-K values at a differing rank lie within the
    PSD bar (PSD_TOL_DB: the values are functions of PSD rows held to it);
    values where the indices agree and key values within PSD_TOL_DB;
    recordings within 1 LSB. Raises where they differ; returns the worst."""
    from rtl_sdr_scanner_tpu_torch.drivers import KEY_SLOTS
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline

    def close(a, b):
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        d[a == b] = 0.0  # equal sentinels (inf) included
        return d

    worst = dict(idx_mismatch=0.0, tie_val=0.0, val=0.0, rec_lsb=0, rec_differ=0)
    for b, ((packed, rec), (ref_packed, ref_rec)) in enumerate(zip(got, want)):
        for band in range(packed.shape[0]):
            g = scan_pipeline.unpack_compact(packed[band], frames, TOP_K, KEY_SLOTS)
            w = scan_pipeline.unpack_compact(ref_packed[band], frames, TOP_K, KEY_SLOTS)
            (idx, val, best, count, key_val, key_idx, ready) = g
            (r_idx, r_val, r_best, r_count, r_key_val, r_key_idx, r_ready) = w
            if not np.isfinite(packed[band]).all() or ready != r_ready or not np.array_equal(count, r_count):
                raise RuntimeError(f"block {b} band {band}: non-finite, readiness {ready}/{r_ready} or counts differ "
                                   f"from the CPU's")
            mism = (idx != r_idx) | (best != r_best)
            d_val = close(val, r_val)
            tie = d_val[:, :TOP_K][mism[:, :TOP_K]].max(initial=0.0)
            agree = max(d_val[~mism].max(initial=0.0), close(key_val, r_key_val).max(initial=0.0))
            d = np.abs(rec[band].astype(np.int32) - ref_rec[band].astype(np.int32))
            worst = dict(idx_mismatch=max(worst["idx_mismatch"], float(mism.mean())),
                         tie_val=max(worst["tie_val"], float(tie)), val=max(worst["val"], float(agree)),
                         rec_lsb=max(worst["rec_lsb"], int(d.max())),
                         rec_differ=worst["rec_differ"] + int((d > 0).sum()))
            if (mism.mean() >= 0.005 or tie > PSD_TOL_DB or agree > PSD_TOL_DB or not np.array_equal(key_idx, r_key_idx)
                    or d.max() > 1):
                diffs = [(int(r), int(c), int(idx[r, c]), int(r_idx[r, c]), float(val[r, c]), float(r_val[r, c]))
                         for r, c in zip(*np.nonzero(mism))][:8]
                raise RuntimeError(f"block {b} band {band}: {worst} against the CPU; differing (frame, rank, index, "
                                   f"CPU index, value, CPU value): {diffs}")
    return worst


def run_one_band(dev, card: str, step: str, geo: Geometry, cpu_blocks: int) -> dict:
    """Steps 12d and 12e: the single-band block step at ``geo`` on the card
    for geo.blocks blocks (launch counts set to 0 just before, read just
    after), the planted signal detected and recorded, its first
    ``cpu_blocks`` blocks (if any) through the same step on the CPU and held
    against the card's (``hold_step_against_cpu``), and each card block's
    PSD rows (the step's first stage) against the plain version under the
    PSD bar; returns the counts."""
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages, kernel_wrappers
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline
    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel

    log(f"---- step {step}: {geo.name}")
    path = MainPath(dev, geo, learn_ms=BAND_491_LEARN_MS)
    cfg, ddc_cfg = path.cfg, path.ddc_cfg
    log(f"fft {cfg.fft_size} decim {cfg.decimator_factor} frames {geo.frames} ({cfg.block_samples * 2 / 1e6:.1f} MB "
        f"of int8, {cfg.block_samples / cfg.sample_rate * 1e3:.1f} ms a block), DDC stages "
        f"{[(p.interp, p.decim) for p in ddc_cfg.plans]}, {ddc_cfg.num_chunks} chunks of {ddc_cfg.chunk}, noise "
        f"learning {cfg.noise_learning_ms} ms")
    wrappers = kernel_wrappers()
    block_ms, card_out = [], []
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    for b in range(geo.blocks):
        t0 = time.perf_counter()
        outs = path.run_block(b)
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        card_out.append((outs.packed.cpu().numpy(), outs.recording.cpu().numpy()))
    counts = {name: fn.launches for name, fn in wrappers.items()}
    want = {"psd_frames_int8": geo.blocks, **detection_launches(geo.blocks),
            "stage_apply_fir": geo.blocks * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)), "analysis_bank": 0,
            **modtap_launches(ddc_cfg, geo.blocks)}
    log(f"launches over {geo.blocks} blocks: {counts}")
    if counts != want:
        raise RuntimeError(f"{geo.name}: step launches {counts}, want {want}")
    check_detected([packed for packed, _ in card_out], geo, cfg, path.group_size)
    rec = card_out[-1][1]
    if rec.shape != (geo.bands, geo.slots, ddc_cfg.out_per_block, 2):
        raise RuntimeError(f"recording {rec.shape}, want {(geo.bands, geo.slots, ddc_cfg.out_per_block, 2)}")
    power = (rec[0].astype(np.float32) ** 2).sum(axis=-1).mean(axis=-1)  # [slots]
    gain_db = 10 * math.log10(power[0] / max(power[1], 1e-3))
    tone = fm_tone(rec[0, 0], geo.bandwidth)
    log(f"recording, last block: slot 0 (on the signal) {gain_db:.1f} dB above slot 1, FM-demodulates to "
        f"{tone:.1f} Hz")
    if gain_db < 10 or abs(tone - RT_TONE) >= 40:
        raise RuntimeError(f"{geo.name}: the signal was not recorded: {gain_db:.1f} dB, {tone:.1f} Hz")

    if cpu_blocks:
        t0 = time.perf_counter()
        ref = MainPath(torch.device("cpu"), geo, ring=path.ring[:cpu_blocks], learn_ms=BAND_491_LEARN_MS)
        ref_out = []
        for b in range(cpu_blocks):
            outs = ref.run_block(b)
            ref_out.append((outs.packed.numpy(), outs.recording.numpy()))
        cpu_s = time.perf_counter() - t0
        del ref
        held = hold_step_against_cpu(card_out[:cpu_blocks], ref_out, geo.frames)
        log(f"card vs CPU step, blocks 0..{cpu_blocks - 1} ({cpu_s:.1f} s on the CPU): counts and readiness "
            f"equal; {held['idx_mismatch']:.4%} of candidate indices and voted bins differ at most in a block (bar "
            f"0.5%: near-ties; top-K values there within {held['tie_val']:.3g} dB), values where they agree and key "
            f"values within {held['val']:.3g} dB (bar {PSD_TOL_DB:g}), recordings within {held['rec_lsb']} LSB "
            f"({held['rec_differ']} samples differ)")
    worst = {}
    for b in range(geo.blocks):
        block = path.ring[b]
        got = scan_pipeline._frames_power(cfg, block)[0]
        want_rows = psd_kernel.psd_frames_int8_plain(block[0], float(cfg.sample_rate), cfg.fft_size,
                                                     cfg.decimator_factor)
        a = psd_agreement(got, want_rows)
        if not psd_within_bar(a):
            raise RuntimeError(f"block {b}: the step's PSD rows are off the plain version's: {a}")
        worst = max(worst, a, key=lambda x: x.get("max_db", -1.0))
    frames = path.ring[0][0]
    psd_ms = cuda_ms(lambda: psd_kernel.psd_frames_int8(frames, float(cfg.sample_rate), cfg.fft_size,
                                                         cfg.decimator_factor), 5)
    steady = float(np.mean(block_ms[1:]))
    log(f"PSD rows vs plain, worst block: max {worst['max_db']:.3g} dB within {PSD_NEAR_DB:g} dB of the peak, "
        f"all-bin median {worst['median_db']:.3g} dB, |dP| {worst['linear']:.3g} of the peak")
    log(f"{geo.name}: {steady:.1f} ms a block (blocks 1..{geo.blocks - 1}; first {block_ms[0]:.1f}), real time "
        f"{cfg.block_samples / cfg.sample_rate * 1e3:.1f} ms; the PSD kernel {psd_ms:.3f} ms a block (CUDA events) "
        f"on {card}")
    del path
    free_card()
    return counts


def run_every_fft(dev, card: str) -> dict:
    """Step 12b-e; returns {phase: counts}."""
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_narrow_") as tmp:
        launches.update(run_narrow_wideband(dev, card, Path(tmp)))
        launches["narrow_session"] = run_narrow_session(dev, card, Path(tmp))
    launches["band_491"] = run_one_band(dev, card, "12d", BAND_491, BAND_491_CPU_BLOCKS)
    launches["band_1966"] = run_one_band(dev, card, "12e", BAND_1966, 0)
    return launches


# -- step 13: the graphed steps against eager ---------------------------------------


def replay_ms(step, calls: int = 0) -> float:
    """Device span of one call of ``step`` from its captured graphs alone:
    for each graph, CUDA events around GRAPH_REPLAYS back-to-back replays
    (its kernels back to back, no host in the loop), the mean, weighted by
    its replays a call over the ``calls`` calls made so far (a session's
    DDC step replays only in the blocks that record; default: one replay
    a call). The replays advance the step's state and count no launch."""
    total = 0.0
    for captured in step.graphs():
        weight = captured.replays / calls if calls else 1.0
        with torch.cuda.device(captured.device):
            captured.graph.replay()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(GRAPH_REPLAYS):
                captured.graph.replay()
            end.record()
            end.synchronize()
        total += start.elapsed_time(end) / GRAPH_REPLAYS * weight
    return total


def timed_blocks(run, blocks: int) -> tuple:
    """``run(b)`` -> output tensors, for b < ``blocks``, each block
    synchronised: (outputs on the host, wall ms, host ms until the call
    returned), a list each."""
    outs, wall, host = [], [], []
    for b in range(blocks):
        t0 = time.perf_counter()
        out = run(b)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
        outs.append([x.cpu().numpy() for x in out])
    return outs, wall, host


def pace_ms(run, first: int, blocks: int) -> float:
    """ms a block of ``blocks`` blocks from block ``first`` run back to back,
    one synchronisation at the end: the host's enqueue of a block overlaps
    the card's work on the one before."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(first, first + blocks):
        run(b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / blocks


def hold_outputs(name: str, runs: dict) -> None:
    """The graphed form's outputs bit-equal to the eager form's, block by block."""
    for b, (e, g) in enumerate(zip(runs["eager"][0], runs["graphed"][0])):
        for i, (x, y) in enumerate(zip(e, g)):
            if x.shape != y.shape or not np.array_equal(x, y):
                where = np.argwhere(x != y)[:3].tolist() if x.shape == y.shape else (x.shape, y.shape)
                raise RuntimeError(f"{name}: block {b}, output {i}: graphed differs from eager at {where}")


def hold_counts(name: str, counts: dict, want: dict, steps: list) -> None:
    """The graphed form's launch counts equal to the eager form's and to
    ``want`` (per-block launches x blocks), and each of ``steps`` captured
    once (a sharded step: each of its (shard, segment) keys)."""
    if not counts["graphed"] == counts["eager"] == want:
        raise RuntimeError(f"{name}: launches graphed {counts['graphed']}, eager {counts['eager']}, want {want}")
    hold_captures(name, steps)


def hold_captures(name: str, steps: list) -> None:
    """Each of ``steps`` captured once (a sharded step: each of its (shard,
    segment) keys, whichever cards its arguments came from)."""
    for step in steps:
        for part in getattr(step, "segments", {"": step}).values():
            if part.captures != 1:
                raise RuntimeError(f"{name}: {part.name} captured {part.captures} times: {part.capture_log}")


def hold_replays(name: str, steps: list, calls: int) -> int:
    """Each graph of ``steps`` replayed once a call over ``calls`` calls (a
    sharded step's segments too: a loop over a block's chunks runs inside
    a segment); returns the replays a call."""
    graphs = [g for step in steps for g in step.graphs()]
    if any(g.replays != calls for g in graphs):
        raise RuntimeError(f"{name}: replays {[g.replays for g in graphs]} over {calls} calls, want one a call")
    return len(graphs)


def graph_report(name: str, card: str, walls: dict, hosts: dict, paces: dict, device_ms: float,
                 steps: list, calls: int = 0) -> dict:
    """Log and return one path's eager and graphed ms a block (the median of
    blocks 1.. each synchronised: block 0 holds the graphed form's warm-up
    and capture, and the session captures its DDC step in the block that
    first records), host ms, ms a block back to back (``paces``: None for
    a session whose blocks are all synchronised), the
    card's busy share and the captures' time and pool bytes (``calls``: the
    steps' calls so far, for the graphs' replays a block). Busy is the
    captured graphs' device span a block (the same kernels both forms run)
    over each form's synchronised wall."""
    median = lambda xs: float(np.median(xs[1:]))
    rec = {
        "eager_ms": median(walls["eager"]), "graphed_ms": median(walls["graphed"]),
        "eager_host_ms": median(hosts["eager"]), "graphed_host_ms": median(hosts["graphed"]),
        "eager_pace_ms": paces["eager"], "graphed_pace_ms": paces["graphed"], "device_ms": device_ms,
        "captures": sum(s.captures for s in steps),
        "capture_s": sum(c["seconds"] for s in steps for c in s.capture_log),
        "pool_bytes": sum(c["pool_bytes"] for s in steps for c in s.capture_log),
    }
    rec["busy_eager"], rec["busy_graphed"] = device_ms / rec["eager_ms"], device_ms / rec["graphed_ms"]
    pace = "" if paces["eager"] is None else (
        f" back to back eager {rec['eager_pace_ms']:.3f}, graphed {rec['graphed_pace_ms']:.3f};")
    if calls:
        rec["replays"] = sum(g.replays for s in steps for g in s.graphs()) / calls
        pace += f" {rec['replays']:g} graph replays a block;"
    log(f"{name}: eager {rec['eager_ms']:.3f} ms a block (host {rec['eager_host_ms']:.3f}), graphed "
        f"{rec['graphed_ms']:.3f} (host {rec['graphed_host_ms']:.3f}), median of blocks 1.. each synchronised;{pace} "
        f"the graphs' device span {device_ms:.3f} ms a block: card busy {rec['busy_eager']:.1%} eager, "
        f"{rec['busy_graphed']:.1%} graphed; {rec['captures']} captures in {rec['capture_s']:.3f} s, pool "
        f"{rec['pool_bytes']} bytes ({rec['pool_bytes'] / 2**20:.1f} MiB) on {card}")
    return rec


def restart_slot(ddc_cfg, state, band: int, slot: int):
    """A banded DDC state with one band's slot zeroed (a recording start)."""
    from rtl_sdr_scanner_tpu_torch.ops import ddc

    if ddc_cfg.modtap:
        return ddc.reset_slot2(state, band, slot)
    return ddc.reset_slot(state, band * ddc_cfg.num_slots + slot)


def zero_counts() -> dict:
    from rtl_sdr_scanner_tpu_torch.drivers import kernel_wrappers

    torch.cuda.synchronize()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def graph_banded(dev, card: str, geo: Geometry, learn_ms: int = 0) -> tuple:
    """A path's banded fused step (``drivers.BandedBlocks``) eager, then
    graphed, from a fresh state each; returns ({form: counts}, report)."""
    from rtl_sdr_scanner_tpu_torch.drivers import BandedBlocks, fir_stages
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline

    log(f"-- {geo.name}")
    path = MainPath(dev, geo, learn_ms=learn_ms)
    cfg, ddc_cfg = path.cfg, path.ddc_cfg
    moved = geo_shifts(geo)
    moved[geo.signal_band, 1] += 2500
    runs, counts, paces, blocks_of = {}, {}, {}, {}
    for form in ("eager", "graphed"):
        blocks = blocks_of[form] = BandedBlocks(cfg, ddc_cfg, path.group_size, TOP_K, geo.bands, geo_shifts(geo), dev)
        step = blocks.step if form == "graphed" else blocks.step.fn

        def run(b, blocks=blocks, step=step):
            if b == GRAPH_SLOT_BLOCK:
                blocks.tables = ddc_pipeline.make_tables(ddc_cfg, moved, device=dev)
                blocks.state[2] = restart_slot(ddc_cfg, blocks.state[2], geo.signal_band, 1)
            *blocks.state, outs = step(*blocks.state, path.ring[b % len(path.ring)], blocks.now(b), *blocks.shared,
                                       blocks.tables)
            return outs.packed, outs.recording

        wrappers = zero_counts()
        runs[form] = timed_blocks(run, GRAPH_BLOCKS)
        counts[form] = {name: fn.launches for name, fn in wrappers.items()}
        paces[form] = pace_ms(run, GRAPH_BLOCKS, GRAPH_BLOCKS)
    want = {"psd_frames_int8": GRAPH_BLOCKS, **detection_launches(GRAPH_BLOCKS),
            "stage_apply_fir": GRAPH_BLOCKS * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)), "analysis_bank": 0,
            **modtap_launches(ddc_cfg, GRAPH_BLOCKS)}
    step = blocks_of["graphed"].step
    hold_outputs(geo.name, runs)
    hold_counts(geo.name, counts, want, [step])
    report = graph_report(geo.name, card, {f: r[1] for f, r in runs.items()}, {f: r[2] for f, r in runs.items()},
                          paces, replay_ms(step), [step])
    del path, blocks_of, runs
    free_card()
    return counts, report


def graph_wideband(dev, card: str, fused: bool = True, shards: int = 1) -> tuple:
    """Step 7's wideband step (``drivers.WidebandBlocks``), fused or split,
    on a band mesh of ``shards`` copies of the card (a graph a shard and
    step), eager, then graphed; returns ({form: counts}, report)."""
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline
    from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as ss

    geo = WIDE
    name = f"{geo.name}, {'fused' if fused else 'split'}" + (f", {shards} band shards" if shards > 1 else "")
    log(f"-- {name}")
    step_names = ("step",) if fused else ("wide_step", "ddc_step")
    ring = None
    runs, counts, paces, steps = {}, {}, {}, {}
    for form in ("eager", "graphed"):
        wide = WidebandStep(dev, geo, fused, ring or [], shards)
        if ring is None:
            ring = wide.ring = wide_ring(geo, wide.cfg.block_samples, dev)
        blocks = wide.blocks
        if form == "eager":
            for attr in step_names:
                setattr(blocks, attr, getattr(blocks, attr).fn)
        steps[form] = wide
        moved = geo_shifts(geo)
        moved[geo.signal_band, 1] += 2500
        ones = blocks.keep_mask

        def run(b, wide=wide, blocks=blocks, ones=ones):
            if b == GRAPH_SLOT_BLOCK:  # the slot's carry zeroed by the keep mask, this block only
                keep = torch.ones(moved.shape, dtype=torch.float32, device=dev)
                keep[geo.signal_band, 1] = 0.0
                blocks.keep_mask = ss.shard_bands(keep, wide.mesh)
                blocks.tables = ss.shard_bands(ddc_pipeline.make_tables(wide.ddc_cfg, moved, device=dev), wide.mesh)
            else:
                blocks.keep_mask = ones
            return wide.run_block(b)

        wrappers = zero_counts()
        runs[form] = timed_blocks(run, GRAPH_BLOCKS)
        counts[form] = {name: fn.launches for name, fn in wrappers.items()}
        paces[form] = pace_ms(run, GRAPH_BLOCKS, GRAPH_BLOCKS)
    ddc_cfg = steps["graphed"].ddc_cfg
    want = {"psd_frames_int8": 0, **detection_launches(shards * GRAPH_BLOCKS),
            "stage_apply_fir": shards * GRAPH_BLOCKS * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)),
            "analysis_bank": shards * GRAPH_BLOCKS, **modtap_launches(ddc_cfg, shards * GRAPH_BLOCKS)}
    graphed = [getattr(steps["graphed"].blocks, attr) for attr in step_names]
    hold_outputs(name, runs)
    hold_counts(name, counts, want, graphed)
    calls = 2 * GRAPH_BLOCKS
    report = graph_report(name, card, {f: r[1] for f, r in runs.items()}, {f: r[2] for f, r in runs.items()}, paces,
                          sum(replay_ms(step, calls) for step in graphed), graphed, calls)
    del steps, runs, ring
    free_card()
    return counts, report


def graph_time_mesh(dev, card: str) -> tuple:
    """Step 10a's time mesh (path 1's band, 180 frames, TMESH_SHARDS shards
    of the card: the time-sharded scan and modulated-taps DDC) eager, then
    graphed, slot 1 restarted before block GRAPH_SLOT_BLOCK; returns ({form:
    counts}, report)."""
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages
    from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline

    name = f"{TMESH.name}, {TMESH_SHARDS} time shards"
    log(f"-- {name}")
    ring = None
    runs, counts, paces, meshes = {}, {}, {}, {}
    for form in ("eager", "graphed"):
        path = meshes[form] = TimeMesh(dev, True, ring)
        ring = path.ring
        if form == "eager":
            path.scan_step, path.ddc_step = path.scan_step.fn, path.ddc_step.fn

        def run(b, path=path):
            if b == GRAPH_SLOT_BLOCK:
                path.ddc = ddc_pipeline.reset_slot(path.ddc, 1)
            return path.run_block(b)

        wrappers = zero_counts()
        runs[form] = timed_blocks(run, GRAPH_BLOCKS)
        counts[form] = {name: fn.launches for name, fn in wrappers.items()}
        paces[form] = pace_ms(run, GRAPH_BLOCKS, GRAPH_BLOCKS)
    graphed = meshes["graphed"]
    ddc_cfg, n = graphed.ddc_cfg, TMESH_SHARDS
    want = {"psd_frames_int8": n * GRAPH_BLOCKS, **detection_launches(n * GRAPH_BLOCKS),
            "stage_apply_fir": n * GRAPH_BLOCKS * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)), "analysis_bank": 0,
            "modtap_stage1": 0, "modtap_stage1_fold": 0}  # the time-sharded DDC keeps stage 1's matmul form
    steps = [graphed.scan_step, graphed.ddc_step]
    hold_outputs(name, runs)
    hold_counts(name, counts, want, steps)
    calls = 2 * GRAPH_BLOCKS
    hold_replays(name, steps, calls)
    report = graph_report(name, card, {f: r[1] for f, r in runs.items()}, {f: r[2] for f, r in runs.items()}, paces,
                          sum(replay_ms(step, calls) for step in steps), steps, calls)
    del meshes, runs, ring, path
    free_card()
    return counts, report


def graph_sharded_session(dev, card: str, tmp: Path, key: str) -> tuple:
    """A session whose steps are sharded, eager (each step's ``fn``), then
    graphed, through ``run_to_completion()``: ``key`` "mesh_time" is 10c's
    (step 6's capture, ``mesh_time`` 4 and ``power_bf16``; one card: the
    mesh resolves to 1 shard), "multihost" 11a's one-process session on
    MH_WORLD band shards of the card. Payloads byte for byte, each (shard,
    segment) captured once, launches equal; returns ({form: counts},
    report, with no back-to-back pace: its blocks are each synchronised)."""
    if key == "mesh_time":
        capture = tmp / "capture_tm.cs8"
        write_capture(capture, RT_RATE, RT_SECONDS, RT_SHIFT, RT_KEY)
        config = runtime_config(capture, RT_RATE, RT_CENTER, mesh_time=4, power_bf16=True)
        name, names = "session, mesh_time 4, power_bf16", ("_scan_step", "_ddc_step")
    else:
        capture = tmp / "mh.cs8"
        write_capture(capture, MH_RATE, MH_SECONDS, MH_SIGNALS, MH_KEY, seed=23)
        config = runtime_config(capture, MH_RATE, MH_CENTER, channels=MH_CHANNELS, mesh_bands=-1, multihost=True)
        config["recording"] = dict(MH_RECORDING)
        name, names = f"multi-host session, one process on {MH_WORLD} band shards", (
            "_wide_step", "_fused_step", "_ddc_band_step")
    log(f"-- {name}")
    runs = {}
    for form in ("eager", "graphed"):
        steps = []

        def made(obj, form=form, steps=steps):
            target = obj.device if key == "mesh_time" else obj
            for attr in names:
                step = getattr(target, attr, None)
                if step is not None:
                    steps.append(step)
                    if form == "eager":
                        setattr(target, attr, step.fn)

        wrappers = zero_counts()
        if key == "mesh_time":
            payloads, session, _, clock = run_scanner(config, dev, timer=True, on_made=made)
            blocks, shards = clock.block, session._time_mesh.shape["time"]
        else:
            payloads, scanner, _, clock = run_wideband_scanner(config, dev, timer=True, cards=[dev] * MH_WORLD,
                                                               on_made=made)
            blocks, shards = clock.block, scanner._mesh.shape["bands"]
        counts = {name_: fn.launches for name_, fn in wrappers.items()}
        runs[form] = (payloads, counts, clock, steps, blocks, shards)
    (e_pay, e_counts, e_clock, _, blocks, shards), (g_pay, g_counts, g_clock, steps, g_blocks, _) = (
        runs["eager"], runs["graphed"])
    trans = sum(1 for t, _ in g_pay if t.endswith("/transmission/uint8"))
    if g_pay != e_pay or g_blocks != blocks or trans == 0:
        raise RuntimeError(f"{name}: graphed payloads differ from eager ({compare_payloads(e_pay, g_pay)}), blocks "
                           f"{g_blocks} / {blocks}, {trans} transmissions")
    if g_counts["fused_selection"] != blocks * shards:
        raise RuntimeError(f"{name}: {g_counts} over {blocks} blocks of {shards} shards")
    log(f"{name}: {blocks} blocks on {shards} shard(s), {len(g_pay)} payloads ({trans} transmissions), graphed equal "
        "to eager byte for byte")
    counts = {"eager": e_counts, "graphed": g_counts}
    hold_counts(name, counts, e_counts, steps)
    walls = {"eager": e_clock.walls, "graphed": g_clock.walls}
    hosts = {f: list(np.array(c.walls) - np.array(c.device_ms())) for f, c in (("eager", e_clock), ("graphed", g_clock))}
    device_ms = sum(replay_ms(step, blocks) for step in steps)
    report = graph_report(name, card, walls, hosts, {"eager": None, "graphed": None}, device_ms, steps, blocks)
    del runs
    free_card()
    return counts, report


def graph_session(dev, card: str, tmp: Path) -> tuple:
    """Step 6's session (``Scanner.run_to_completion()`` on its capture) on
    GRAPH_RANGES, so that it hops, eager (its steps' ``fn``), then graphed,
    serial and then with ``pipelined_ingest``: payloads equal byte for byte
    and the same hops in each mode; returns ({form: counts}, report of the
    serial runs, with the pipelined runs' median ms a ``Scanner.step`` as
    the pace)."""
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages
    from rtl_sdr_scanner_tpu_torch.runtime.config import Config
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner

    log("-- runtime session on two ranges")
    capture = tmp / "capture.cs8"
    write_capture(capture, RT_RATE, RT_SECONDS, RT_SHIFT, RT_KEY)

    def run(form: str, pipelined: bool):
        config = runtime_config(capture, RT_RATE, RT_CENTER, noise_learning_time_ms=GRAPH_LEARN_MS,
                                pipelined_ingest=pipelined)
        config["devices"][0]["ranges"] = [{"start": a, "stop": b} for a, b in GRAPH_RANGES]
        cfg = Config(json.loads(json.dumps(config)))
        mqtt = NullMqtt()
        mqtt.keep_payloads = True
        scanner = Scanner(cfg, cfg.devices[0], mqtt, cfg.recorders_count(), device=dev)
        session = scanner.device
        steps = [session._scan_step, session._ddc_step]
        if form == "eager":
            session._scan_step, session._ddc_step = session._scan_step.fn, session._ddc_step.fn
        hops = []
        real = session.set_frequency_range
        session.set_frequency_range = lambda rng, now: (hops.append((now, rng)), real(rng, now))[1]
        clock = None if pipelined else SessionTimer(session)
        stamps = []
        real_step = scanner.step
        scanner.step = lambda: (real_step(), stamps.append(time.perf_counter()))[0]
        wrappers = zero_counts()
        scanner.run_to_completion()
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        # a step's ms, the median over the run: a block's submit and the
        # previous one's finish (pipelined), robust to the captures' steps
        step_ms = float(np.median(np.diff(stamps))) * 1e3
        return mqtt.published, hops, counts, clock, steps, session, step_ms

    runs = {(form, piped): run(form, piped) for piped in (False, True) for form in ("eager", "graphed")}
    for piped in (False, True):
        e, g = runs[("eager", piped)], runs[("graphed", piped)]
        trans = sum(1 for t, _ in g[0] if t.endswith("/transmission/uint8"))
        mode = "pipelined" if piped else "serial"
        if g[0] != e[0] or g[1] != e[1]:
            raise RuntimeError(f"session, {mode}: graphed payloads differ from eager ({compare_payloads(e[0], g[0])}) "
                               f"or hops ({len(g[1])} vs {len(e[1])})")
        if len(g[1]) < (2 if piped else 3) or trans == 0:  # a hop, or (serial) two
            raise RuntimeError(f"session, {mode}: {len(g[1])} tunes, {trans} transmissions: the scene should hop and "
                               "record")
        log(f"session, {mode}: {len(g[1])} tunes, {trans} transmission payloads; graphed payloads equal eager byte "
            "for byte")
    (_, _, e_counts, e_clock, _, _, _), (_, _, g_counts, g_clock, steps, session, _) = (
        runs[("eager", False)], runs[("graphed", False)])
    ddc_cfg = session.ddc_cfg
    blocks = g_clock.block
    if e_clock.block != blocks or g_clock.ddc_calls == 0:
        raise RuntimeError(f"session: {e_clock.block} blocks eager, {blocks} graphed, the DDC in {g_clock.ddc_calls}")
    want = {"psd_frames_int8": blocks, **detection_launches(blocks),
            "stage_apply_fir": g_clock.ddc_calls * ddc_cfg.num_chunks * len(fir_stages(ddc_cfg)), "analysis_bank": 0,
            **modtap_launches(ddc_cfg, g_clock.ddc_calls)}
    counts = {"eager": e_counts, "graphed": g_counts}
    hold_counts("session", counts, want, steps)
    log(f"session, serial: {blocks} blocks, the DDC in {g_clock.ddc_calls}")
    device_ms = replay_ms(steps[0]) + replay_ms(steps[1]) * g_clock.ddc_calls / blocks
    walls = {"eager": e_clock.walls, "graphed": g_clock.walls}
    # the session's host ms: wall less the CUDA-event span of its dispatches
    hosts = {f: list(np.array(c.walls) - np.array(c.device_ms())) for f, c in (("eager", e_clock), ("graphed", g_clock))}
    paces = {form: runs[(form, True)][6] for form in ("eager", "graphed")}
    report = graph_report("runtime session", card, walls, hosts, paces, device_ms, steps)
    del runs
    free_card()
    return counts, report


def run_graphs(dev, card: str) -> tuple:
    """Step 14: path 1, path 2, the session, the 491.52 Msps band and the
    fused wideband step, then the sharded forms (10a, 10b fused and split,
    10c, 11a), each eager and graphed. Returns ({phase: counts}, {path:
    report})."""
    log("---- step 13: the steps graphed (CUDA graphs, donated state) against eager")
    launches, reports = {}, {}
    for key, geo, learn_ms in (("path1", PATH1, 0), ("path2", PATH2, 0), ("band_491", BAND_491, BAND_491_LEARN_MS)):
        counts, reports[key] = graph_banded(dev, card, geo, learn_ms)
        launches.update({f"graphs_{form}_{key}": c for form, c in counts.items()})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        counts, reports["session"] = graph_session(dev, card, Path(tmp))
        launches.update({f"graphs_{form}_session": c for form, c in counts.items()})
        for key in ("mesh_time", "multihost"):
            counts, reports[f"session_{key}"] = graph_sharded_session(dev, card, Path(tmp), key)
            launches.update({f"graphs_{form}_session_{key}": c for form, c in counts.items()})
    counts, reports["wideband_fused"] = graph_wideband(dev, card)
    launches.update({f"graphs_{form}_wideband_fused": c for form, c in counts.items()})
    counts, reports["time_mesh"] = graph_time_mesh(dev, card)
    launches.update({f"graphs_{form}_time_mesh": c for form, c in counts.items()})
    for fused in (True, False):
        key = f"wideband_{BAND_SHARDS}_shards_{'fused' if fused else 'split'}"
        counts, reports[key] = graph_wideband(dev, card, fused, BAND_SHARDS)
        launches.update({f"graphs_{form}_{key}": c for form, c in counts.items()})
    log(f"step 13 ({card}): {json.dumps(reports)}")
    return launches, reports


def child_main(argv) -> int:
    """A step 11 process: ``--child MODE RANK WORLD PORT ROOT ARGS``, on card
    0 of what CUDA_VISIBLE_DEVICES shows it."""
    import pickle

    mode, rank, world, port, root, *rest = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, root)
    from rtl_sdr_scanner_tpu_torch.drivers import fir_stages, kernel_wrappers
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build
    from rtl_sdr_scanner_tpu_torch.parallel import multihost

    build.library()  # built by the parent
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    if mode == "session":
        # the runtime's launch contract: main.run joins the group itself
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=str(world),
                          JAX_PROCESS_ID=str(rank))
        config_path, out_path = rest
        watch = []

        def on_made(scanner):
            watch.append((scanner, WidebandTimer(scanner)))
            # start both scanners together (an object collective: gloo), so
            # that their blocks run on the card at the same time
            torch.distributed.all_gather_object([None] * world, rank)

        rc, payloads = run_main(Path(config_path), dev, on_made=on_made)
        if rc != 0 or len(watch) != 1:
            raise RuntimeError(f"main.run returned {rc} with {len(watch)} wideband scanner(s)")
        scanner, clock = watch[0]
        result = dict(bands=scanner._local_bands, multihost=scanner._multihost, shards=list(scanner._mesh.band_shards),
                      n_shards=scanner._mesh.n_band_shards, published=payloads, walls=clock.walls, stamps=clock.stamps,
                      device_ms=clock.device_ms(), blocks=clock.block,
                      launches={name: fn.launches for name, fn in wrappers.items()})
        said = f"channels {scanner._local_bands}, {len(payloads)} payloads"
    elif mode == "step":
        from rtl_sdr_scanner_tpu_torch.models import scan_pipeline

        (out_path,) = rest
        multihost.initialize(f"localhost:{port}", world, rank, device=dev)
        try:
            local = multihost.local_mesh(multihost.make_global_mesh(1, cards=1), [dev])
            geo = WIDE
            cfg = scan_pipeline.ScanConfig.create(geo.rate, geo.frames)
            ring = wide_ring(geo, cfg.block_samples, dev)
            result = {"shards": list(local.band_shards)}
            for fused in (True, False):
                names = ("step",) if fused else ("wide_step", "ddc_step")
                runs = {}
                for form in ("eager", "graphed"):
                    step = WidebandStep(dev, geo, fused, ring, mesh=local)
                    graphed = [getattr(step.blocks, n) for n in names]
                    if form == "eager":
                        for n, g in zip(names, graphed):
                            setattr(step.blocks, n, g.fn)
                    result["ddc"] = (step.ddc_cfg.num_chunks, len(fir_stages(step.ddc_cfg)), int(step.ddc_cfg.modtap),
                                     int(stage1_folds(step.ddc_cfg)))
                    torch.cuda.synchronize()
                    for fn in wrappers.values():
                        fn.launches = 0
                    run = run_step_blocks(step)
                    runs[form] = {"run": run, "launches": {name: fn.launches for name, fn in wrappers.items()},
                                  "pace_ms": pace_ms(lambda b, step=step: step.run_block(b), MESH_BLOCKS, MESH_BLOCKS)}
                    if form == "graphed":
                        runs[form].update(
                            device_ms=sum(replay_ms(g, 2 * MESH_BLOCKS) for g in graphed),
                            captures=sum(g.captures for g in graphed),
                            capture_s=sum(c["seconds"] for g in graphed for c in g.capture_log),
                            pool_bytes=sum(c["pool_bytes"] for g in graphed for c in g.capture_log))
                    del step, graphed
                result["fused" if fused else "split"] = dict(runs["graphed"], eager=runs["eager"])
        finally:
            multihost.shutdown()
        said = f"band shard {result['shards']}"
    else:
        raise ValueError(f"unknown child mode {mode!r}")
    with open(out_path.format(rank=rank), "wb") as fh:
        pickle.dump(result, fh)
    print(f"child {mode} {rank}/{world}: {said}", flush=True)
    return 0


def main() -> int:

    if sys.argv[1:2] == ["--child"]:
        return child_main(sys.argv[2:])
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
    from rtl_sdr_scanner_tpu_torch.drivers import card_line
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
    # the wideband phases' shapes: selection, and the FIR's stage 2 (a
    # multi-host process's session shard takes no FIR stage)
    wide = (WIDE, WIDE_RT, WIDE_SHARD, MH_SHARD)
    # step 12's paths are held at their own shapes here too (each path's
    # selection at its own rows)
    psd_err, sel_err = check_psd_and_selection(timed + (NARROW_RT, BAND_491, BAND_1966),
                                               timed + wide + (NARROW_WIDE, NARROW_RT, BAND_1966), dev)
    fir_err = check_fir(timed + (WIDE, WIDE_SHARD, BAND_491, BAND_1966), dev)
    narrow_psd_err, narrow_sel_err = check_narrow_kernels(dev)
    psd_err, sel_err = max(psd_err, narrow_psd_err), max(sel_err, narrow_sel_err)
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
        launches.update(run_multi_host(dev, card, root))
        log(f"[{time.perf_counter() - t_start:.1f} s]")
        launches.update(run_every_fft(dev, card))
        log(f"[{time.perf_counter() - t_start:.1f} s]")
        launches.update(run_graphs(dev, card)[0])
        log(f"[{time.perf_counter() - t_start:.1f} s]")
    records = time_psd_and_selection(timed + (NARROW_RT, BAND_491, BAND_1966), dev, card, psd_err, sel_err,
                                     sel_only=wide + (NARROW_WIDE,))
    records.append(time_fir(timed + (WIDE, WIDE_SHARD, BAND_491, BAND_1966), PATH2, dev, card, fir_err))
    records.append(time_vote(geos, dev, card))
    records.append(time_bank(dev, card))
    records.append(time_ddc(dev, card))
    if args.kernels_only:
        log(card)
        log(json.dumps({"kernels": records}))
        return 0
    for r in records:
        r["launches"] = sum(counts[r["name"]] for counts in launches.values())
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in launches.items()}
        if r["launches"] == 0:
            raise RuntimeError(f"{r['name']} never launched on the main paths")
        if r["launches_by_path"][r["session_path"]] == 0:
            raise RuntimeError(f"{r['name']} never launched by the {r['session_path']} session")
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
