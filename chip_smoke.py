"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``rtl_sdr_scanner_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/kernels``).
2. Holds each kernel against its plain PyTorch version on the card: the PSD
   within 0.02 dB on every bin within 60 dB of its frame's peak (median
   |diff| <= 1e-3 dB), the selection bit-exact in bf16 and f32; then times
   kernel, plain version and library call at the main path's shapes.
3. Drives the main path, ``make_banded_fused_step``, at full width: 24 bands
   x 45 frames x fft 131072 at 20.48 Msps with 2 recorder slots at 16 kHz,
   the PSD and selection kernels on and bf16 selection, for 6 blocks from a
   device-resident ring of synthetic cs8. Band 5 carries an FM signal keyed
   on after the 2 s noise-learning window; the run must report the noise
   floor learned, that signal detected in its band only, and a recording.

Every failure raises. The last lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RATE = 20_480_000
FRAMES = 45
BANDS = 24
SLOTS = 2
BLOCKS = 6
TOP_K = 64
KEY_SLOTS = 16
LEVEL = 8.0
SIGNAL_BAND = 5
SIGNAL_OFFSET_HZ = 250_000
SIGNAL_FROM_BLOCK = 3  # block 3 starts at 2592 ms, after the 2000 ms learning
CHECK_ROWS = 45 * 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PSD_TOL_DB = 0.02
PSD_MEDIAN_TOL_DB = 1e-3


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


def noise_cs8(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """[n, 2] int8 complex white noise, 0.01 rms per component."""
    x = torch.randn((n, 2), generator=gen, device=dev) * (0.01 * 127.0)
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


def fm_cs8(start: int, n: int, dev) -> torch.Tensor:
    """[n, 2] f32 FM at +250 kHz: 800 Hz tone, 3 kHz deviation, 0.4 amplitude,
    in cs8 units. Band-wide on purpose: the 21-bin smoothing would dilute a
    pure tone ~13 dB."""
    t = (torch.arange(n, device=dev, dtype=torch.float64) + start) / RATE
    phase = 2 * math.pi * SIGNAL_OFFSET_HZ * t + (3000.0 / 800.0) * (1 - torch.cos(2 * math.pi * 800 * t))
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1).float() * (0.4 * 127.0)


def random_cs8(shape, gen: torch.Generator, dev) -> torch.Tensor:
    """Uniform int8 IQ in [-100, 100), the JAX package's PSD test input."""
    return torch.randint(-100, 100, shape, generator=gen, device=dev, dtype=torch.int8)


def make_ring(cfg, dev) -> list:
    """BLOCKS device-resident blocks [BANDS, F, fft*decim, 2] int8."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    group = cfg.fft_size * cfg.decimator_factor
    n = FRAMES * group
    ring = []
    for b in range(BLOCKS):
        block = torch.empty((BANDS, n, 2), dtype=torch.int8, device=dev)
        for band in range(BANDS):
            block[band] = noise_cs8(n, gen, dev)
            if band == SIGNAL_BAND and b >= SIGNAL_FROM_BLOCK:
                x = block[band].float() + fm_cs8(b * n, n, dev)
                block[band] = torch.clamp(torch.round(x), -128, 127).to(torch.int8)
        ring.append(block.reshape(BANDS, FRAMES, group, 2))
    torch.cuda.synchronize()
    return ring


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


def check_kernels(cfg, dev, card: str) -> list:
    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel, select_kernel
    from rtl_sdr_scanner_tpu_torch.ops.psd import shifted_window

    fft, decim = cfg.fft_size, cfg.decimator_factor
    rate = float(cfg.sample_rate)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    records = []

    # ---- PSD: correctness at [45*4, fft*decim, 2], timing at the main path's [24*45, ...]
    iq = random_cs8((CHECK_ROWS, fft * decim, 2), gen, dev)
    got = psd_kernel.psd_frames_int8(iq, rate, fft, decim)
    want = psd_kernel.psd_frames_int8_plain(iq, rate, fft, decim)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == want.shape):
        raise RuntimeError("psd kernel: non-finite output or wrong shape")
    near = want >= want.amax(dim=1, keepdim=True) - 60.0
    diff = (got - want).abs()
    psd_max = diff[near].max().item()
    psd_med = diff[near].median().item()
    log(f"psd kernel vs plain [{CHECK_ROWS}, {fft * decim}, 2]: max {psd_max:.3g} dB, "
        f"median {psd_med:.3g} dB on bins within 60 dB of the peak; all-bin max {diff.max().item():.3g} dB")
    if psd_max > PSD_TOL_DB or psd_med > PSD_MEDIAN_TOL_DB:
        raise RuntimeError(f"psd kernel disagrees: max {psd_max} dB, median {psd_med} dB")

    rows = BANDS * FRAMES
    big = random_cs8((rows, fft * decim, 2), gen, dev)
    win = torch.from_numpy(shifted_window(fft)).to(dev)
    frames_c = torch.complex(big[:, :fft, 0].float() / 127.5, big[:, :fft, 1].float() / 127.5) * win
    ms = cuda_ms(lambda: psd_kernel.psd_frames_int8(big, rate, fft, decim), 20)
    plain_ms = cuda_ms(lambda: psd_kernel.psd_frames_int8_plain(big, rate, fft, decim), 5)
    library_ms = cuda_ms(lambda: torch.fft.fft(frames_c), 20)
    bytes_moved = rows * fft * (2 + 4)  # int8 pairs of the selected frame in, f32 dB out
    flops = rows * 5 * fft * math.log2(fft)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    log(f"psd [{rows}, {fft * decim}, 2]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"torch.fft.fft alone {library_ms:.3f} ms, bound {bound_ms:.3f} ms (bytes) on {card}")
    records.append(dict(
        name="psd_frames_int8", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/psd_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/psd_kernel.py:108", launches=None,
        max_abs_err=psd_max, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations",
        library_ms=library_ms,
    ))
    del big, frames_c

    # ---- selection: bit-exact in bf16 and f32, timing on the main path's bf16 rows
    group_size = int(np.ceil(16000 / cfg.step_hz))
    submargin = group_size // 2 + group_size % 2
    level = torch.tensor(LEVEL, device=dev)
    sel_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        t = selection_rows(fft, dtype, dev)
        got = select_kernel.fused_selection(t, level, TOP_K, 16, submargin)
        want = select_kernel.fused_selection_plain(t, level, TOP_K, 16, submargin)
        torch.cuda.synchronize()
        for name, g, w in zip(("top_val", "top_idx", "sep_val", "sep_idx", "count"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise RuntimeError(f"selection kernel {dtype} {name} disagrees at {bad}")
            sel_err = max(sel_err, (g.float() - w.float()).abs().max().item())
        log(f"selection kernel vs plain [{CHECK_ROWS}, {fft}] {dtype}: bit-exact")
    t = torch.randn((rows, fft), generator=gen, device=dev).mul_(6.0).to(torch.bfloat16)
    ms = cuda_ms(lambda: select_kernel.fused_selection(t, level, TOP_K, 16, submargin), 20)
    plain_ms = cuda_ms(lambda: select_kernel.fused_selection_plain(t, level, TOP_K, 16, submargin), 3)
    bytes_moved = rows * fft * 2 + rows * ((TOP_K + 16) * (2 + 4) + 4)
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    log(f"selection [{rows}, {fft}] bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms (bytes) on {card}")
    records.append(dict(
        name="fused_selection", route="cuda", source="rtl_sdr_scanner_tpu_torch/csrc/select_kernel.cu",
        replaces="rtl_sdr_scanner_tpu/ops/pallas/select_kernel.py:189", launches=None,
        max_abs_err=sel_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None,
    ))
    return records


class MainPath:
    """The main path at full width: configs, the step, a ring of synthetic
    cs8 on the card, and the carried state."""

    def __init__(self, dev):
        from rtl_sdr_scanner_tpu_torch.constants import Tunables
        from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline, fused_step, scan_pipeline

        self.dev = dev
        self.cfg = cfg = scan_pipeline.ScanConfig.create(
            RATE, FRAMES, Tunables(use_pallas_psd=True, use_pallas_select=True)
        )
        self.ddc_cfg = ddc_pipeline.DdcConfig.create(RATE, 16_000, SLOTS, cfg.block_samples)
        self.group_size = int(np.ceil(16000 / cfg.step_hz))
        self.step = fused_step.make_banded_fused_step(cfg, self.ddc_cfg, self.group_size, TOP_K, device=dev)
        t0 = time.perf_counter()
        self.ring = make_ring(cfg, dev)
        log(f"ring: {BLOCKS} blocks of [{BANDS}, {FRAMES}, {cfg.fft_size * cfg.decimator_factor}, 2] "
            f"int8 on the card in {time.perf_counter() - t0:.1f} s")
        self.state = [
            scan_pipeline.init_scan_state(cfg, BANDS, 0, device=dev),
            scan_pipeline.init_spectro_acc(cfg, BANDS, device=dev),
            ddc_pipeline.init_state(self.ddc_cfg, BANDS, device=dev),
        ]
        shifts = np.tile(np.array([SIGNAL_OFFSET_HZ, -1_000_000], dtype=np.int64), (BANDS, 1))
        self.tables = ddc_pipeline.make_tables(self.ddc_cfg, shifts, device=dev)
        self.shared = [
            torch.full((KEY_SLOTS,), -1, dtype=torch.int32, device=dev),  # keys
            torch.ones(cfg.fft_size, dtype=torch.bool, device=dev),  # valid mask
            torch.tensor(LEVEL, device=dev),  # start level
            torch.tensor(1.0, device=dev),  # spectro keep
        ]

    def now(self, b: int) -> torch.Tensor:
        ms = (b * FRAMES + 1 + np.arange(FRAMES)) * self.cfg.frame_interval_ms
        return torch.from_numpy(ms.astype(np.int32)).to(self.dev).expand(BANDS, FRAMES).contiguous()

    def run_block(self, b: int):
        """One block through the step (ring slot b % BLOCKS); returns FusedOutputs."""
        *self.state, outs = self.step(
            *self.state, self.ring[b % BLOCKS], self.now(b), *self.shared, self.tables
        )
        return outs


def run_main_path(dev, card: str) -> dict:
    from rtl_sdr_scanner_tpu_torch.models import scan_pipeline
    from rtl_sdr_scanner_tpu_torch.ops.cuda import psd_kernel, select_kernel

    path = MainPath(dev)
    cfg, ddc_cfg, group_size = path.cfg, path.ddc_cfg, path.group_size
    packed, block_ms = [], []
    torch.cuda.synchronize()
    psd_kernel.psd_frames_int8.launches = 0
    select_kernel.fused_selection.launches = 0
    for b in range(BLOCKS):
        t0 = time.perf_counter()
        outs = path.run_block(b)
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        packed.append(outs.packed.cpu().numpy())
    launches = {
        "psd_frames_int8": psd_kernel.psd_frames_int8.launches,
        "fused_selection": select_kernel.fused_selection.launches,
    }
    log(f"launches over {BLOCKS} blocks: {launches}")
    for name, n in launches.items():
        if n != BLOCKS:
            raise RuntimeError(f"{name} launched {n} times in {BLOCKS} blocks")

    # ---- what came out is right
    rec = outs.recording
    want_shape = (BANDS, SLOTS, ddc_cfg.out_per_block, 2)
    if tuple(rec.shape) != want_shape or rec.dtype != torch.int8:
        raise RuntimeError(f"recording {tuple(rec.shape)} {rec.dtype}, want {want_shape} int8")
    if not rec.any() or not rec[SIGNAL_BAND, 0].any():
        raise RuntimeError("recording is all zero where the signal is")
    planted = cfg.fft_size // 2 + round(SIGNAL_OFFSET_HZ / cfg.step_hz)
    hits = {}
    for b in range(SIGNAL_FROM_BLOCK, BLOCKS):
        for band in range(BANDS):
            out = scan_pipeline.unpack_compact(packed[b][band], FRAMES, TOP_K, KEY_SLOTS)
            cand_idx, cand_val, _, cand_count, _, _, ready = out
            if not np.isfinite(packed[b][band]).all() or not ready:
                raise RuntimeError(f"block {b} band {band}: non-finite output or noise not learned")
            live = cand_val >= LEVEL
            if live.any():
                hits.setdefault(band, []).append(np.abs(cand_idx[live] - planted).min())
    log(f"bands with candidates above {LEVEL} dB in blocks {SIGNAL_FROM_BLOCK}..{BLOCKS - 1}: "
        f"{ {k: int(min(v)) for k, v in hits.items()} } (bins from the planted {planted})")
    if set(hits) != {SIGNAL_BAND} or min(hits[SIGNAL_BAND]) > group_size:
        raise RuntimeError(f"planted signal not detected in band {SIGNAL_BAND} only: {hits}")

    steady = block_ms[1:]
    ms = float(np.mean(steady))
    rate = BANDS * cfg.block_samples / (ms / 1e3)
    log(f"main path: {ms:.1f} ms per block (blocks 1..{BLOCKS - 1}; first {block_ms[0]:.1f} ms), "
        f"{rate / 1e6:.1f} M samples/s through scan + {SLOTS}-slot DDC at {BANDS} bands, on {card}")
    return launches


def main() -> int:
    # the run uses one card: show it only the first, before CUDA starts, so
    # that the device count it reports is the count it used
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print("chip_smoke: needs exactly one visible card (CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "rtl_sdr_scanner_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import ScanConfig
    from rtl_sdr_scanner_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")

    cfg = ScanConfig.create(RATE, FRAMES)
    records = check_kernels(cfg, dev, card)
    launches = run_main_path(dev, card)
    for r in records:
        r["launches"] = launches[r["name"]]
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
