"""The numbers that decide ``correct`` for a session: what the scanner
published during the window, judged by what each payload says against the
capture the benchmark made and the plain reference (``scan.py``, ``ddc.py``).
The wire format is the upstream's (data_controller.cpp:27-57):
transmission ``u64 time_ms | i32 start | i32 stop | u32 rate | IQ ^ 0x80``,
spectrogram ``u64 time_ms | i32 start | i32 stop | i32 step | u32 size |
int8 dB``, little-endian.

Stream block k (0-based) starts at ``(k + 1) B 1000 // rate - B 1000 //
rate`` ms (the stream clock in whole ms after the block is read, less a
block); a payload belongs to the block whose span holds its time.

- ``rec_excess_lsb``: for every transmission payload of ``checked_blocks``
  blocks drawn from the seed, the IQ against the reference's recorder at the
  payload's frequency, as ``judge.judge_recording``. A recording's slot
  starts at its first block (the block of its first payload: the payloads
  of one recording cover consecutive blocks, the first block's trimmed to
  the frames after the detection) as ``ddc.record_block`` says of a
  restarted slot, so its block k is the reference bank over [history of
  block k-1, block k] with the NCO phase counted from the first block's
  first sample.
- ``spectro_db``: for ``checked_spectrograms`` spectrogram payloads drawn
  from the seed, each int8 bin against the mean over the frames since the
  payload before it of the PSD dB averaged over the bin's group: the
  distance from that mean to the values that truncate to the bin (dB).
- ``stray_payloads``: payloads whose header is not what the configuration
  states (rate, span, step, size), or whose frequency lies more than
  ``freq_tolerance_hz`` from every transmitter, or whose span lies more than
  ``late_s`` after that transmitter's on-intervals or before them (two
  on-intervals less than the recording timeout and ``late_s`` apart count
  as one: the recording holds through the silence).
- ``missed_transmissions``: on-intervals of at least ``min_on_s`` inside the
  window (ending ``settle_s`` before it closes) with no payload of the
  window at that transmitter's frequency stamped within ``[on, off + late_s]``.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import ddc as ref_ddc
from benchmark.reference import judge
from benchmark.reference import scan as ref_scan

TX, SPECTRO = "/transmission/uint8", "/spectrogram"


def decode_transmission(payload: bytes):
    time_ms, start, stop, rate = struct.unpack_from("<QiiI", payload)
    body = np.frombuffer(payload, dtype=np.uint8, offset=20)
    return time_ms, start, stop, rate, (body ^ np.uint8(0x80)).view(np.int8).reshape(-1, 2)


def decode_spectrogram(payload: bytes):
    time_ms, start, stop, step, size = struct.unpack_from("<QiiiI", payload)
    return time_ms, start, stop, step, size, np.frombuffer(payload, dtype=np.int8, offset=24)


def spectro_size(rate: int, max_fft: int = 16384, max_step: int = 1000) -> int:
    """min(SPECTROGRAM_MAX_FFT, the power-of-two fft whose bins are at most
    SPECTROGRAM_PREFERRED_MAX_STEP Hz) (config.h:36-38)."""
    return min(max_fft, 1 << math.ceil(math.log2(rate / max_step)))


def truncating_gap(bins: np.ndarray, mean: np.ndarray) -> float:
    """Largest distance from ``mean`` to the values that an int8 cast with
    truncation (saturated) turns into ``bins``."""
    b = bins.astype(np.float64)
    lo = np.where(b >= 1, b, np.where(b == 0, -1.0, b - 1.0))
    hi = np.where(b >= 1, b + 1.0, np.where(b == 0, 1.0, b))
    lo = np.where(b <= -128, -np.inf, lo)
    hi = np.where(b >= 127, np.inf, hi)
    return float(np.maximum(np.maximum(lo - mean, mean - hi), 0.0).max(initial=0.0))


class Stream:
    """The stream's clock and geometry, from the configuration alone."""

    def __init__(self, c: dict, capture):
        self.c, self.capture = c, capture
        self.rate, self.bw = c["sample_rate"], c["recording_rate"]
        self.block = capture.block
        self.geo = ref_scan.Geometry.of(c)
        self.block_ms = int(self.block * 1000 / self.rate)
        self.n_out = self.block * self.bw // self.rate
        self.center = sum(c["range_hz"]) // 2
        self.frame_ms = self.geo.fft * self.geo.decim * 1000.0 / self.rate

    def start_ms(self, k: int) -> int:
        return (k + 1) * self.block * 1000 // self.rate - self.block_ms

    def end_ms(self, k: int) -> int:
        """The stamp of block k's last frame, when its spectrogram is sent."""
        return int(self.start_ms(k) + self.geo.frames * self.frame_ms)

    def block_of(self, time_ms: int) -> int:
        k = max(0, time_ms * self.rate // (self.block * 1000) - 1)
        while self.start_ms(k + 1) <= time_ms:
            k += 1
        while k > 0 and self.start_ms(k) > time_ms:
            k -= 1
        return k

    def iq(self, k: int, device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self.capture.block_iq(k))).to(device)


def judge_session(c: dict, spec: dict, capture, published: list, w0: int, w1: int, device,
                  control: bool) -> Tuple[Dict[str, float], Dict[str, float], str]:
    """(numbers, the control's numbers, what was judged) over the payloads
    published while the scanner read blocks w0 .. w1 - 1."""
    s = Stream(c, capture)
    rng = np.random.default_rng([capture.seed, 4])
    numbers: Dict[str, float] = {"stray_payloads": 0.0}
    ctl: Dict[str, float] = {}
    tx: Dict[Tuple[int, int], List[np.ndarray]] = {}  # (block, frequency) -> IQ, every payload
    window_tx: List[Tuple[int, int, int, int]] = []  # (block, frequency, stamp, samples) published in the window
    spectros: List[Tuple[int, np.ndarray, bool]] = []  # (block, bins, in the window)
    size = spectro_size(s.rate)
    ends = {s.end_ms(k): k for k in range(w1 + 1)}
    for topic, payload, read in published:
        in_window = w0 < read <= w1
        if topic.endswith(TX):
            t, start, stop, rate, iq = decode_transmission(payload)
            f = start + rate // 2
            if rate != s.bw or stop - start != 2 * (rate // 2):
                numbers["stray_payloads"] += in_window
                continue
            k = s.block_of(t)
            tx.setdefault((k, f), []).append(iq)
            if in_window:
                window_tx.append((k, f, t, len(iq)))
        elif topic.endswith(SPECTRO):
            t, start, stop, step, n, bins = decode_spectrogram(payload)
            ok = (start, stop, step, n, bins.size) == (s.center - s.rate // 2, s.center + s.rate // 2,
                                                       s.rate // size, size, size) and t in ends
            if not ok:
                numbers["stray_payloads"] += in_window
                continue
            spectros.append((ends[t], bins, in_window))
        else:
            numbers["stray_payloads"] += in_window

    strays = stray(s, spec, window_tx)
    numbers["stray_payloads"] += len(strays)
    numbers["missed_transmissions"] = float(missed(s, spec, window_tx, w0, w1))
    seen = [f"stray {strays[:8]}"] if strays else []
    seen += [f"{len(window_tx)} transmission and {sum(w for _, _, w in spectros)} spectrogram payloads"]
    if capture.transmitters:
        blocks = sorted({k for k, _, _, _ in window_tx})
        pick = sorted(rng.choice(blocks, min(spec["checked_blocks"], len(blocks)), replace=False)) if blocks else []
        pairs = sorted({(k, f) for k, f, _, _ in window_tx if k in set(pick)})
        for k, f in pairs:
            recording(s, tx, k, f, device, numbers, ctl, control)
        seen.append(f"IQ of {len(pairs)} (block, frequency) pairs in blocks {[int(k) for k in pick]}")
    idx = [i for i, (_, _, w) in enumerate(spectros) if w]
    pick = sorted(rng.choice(idx, min(spec["checked_spectrograms"], len(idx)), replace=False)) if idx else []
    for i in pick:
        first = spectros[i - 1][0] + 1 if i > 0 else 0
        spectrogram(s, range(first, spectros[i][0] + 1), spectros[i][1], device, numbers, ctl, control)
    seen.append(f"{len(pick)} spectrograms")
    return numbers, ctl, "; ".join(seen)


def stray(s: Stream, spec: dict, window_tx: list) -> list:
    """The window's transmission payloads that match no transmitter: (block,
    shift, stamp ms, why)."""
    out = []
    shifts = [x.shift_hz for x in s.capture.transmitters]
    for k, f, t, n in window_tx:
        if not shifts:
            out.append((k, f - s.center, t, "no transmitter"))
            continue
        shift = min(shifts, key=lambda x: abs(s.center + x - f))
        if abs(s.center + shift - f) > spec["freq_tolerance_hz"]:
            out.append((k, f - s.center, t, f"nearest transmitter {shift}"))
            continue
        a, b = t / 1000.0, t / 1000.0 + n / s.bw
        ons = held(s.capture.on_intervals(shift, a - 60, b + 60), s.c["recording_timeout_ms"] / 1000.0 + spec["late_s"])
        if not any(on <= b and a <= off + spec["late_s"] for on, off in ons):
            near = min(ons, key=lambda iv: min(abs(iv[0] - b), abs(a - iv[1])), default=None)
            out.append((k, f - s.center, t, f"outside the on-intervals, nearest {near}"))
    return out


def held(intervals: list, gap: float) -> list:
    """On-intervals with the gaps of at most ``gap`` s between them closed:
    a recording holds through a silence shorter than its timeout."""
    out = []
    for on, off in sorted(intervals):
        if out and on - out[-1][1] <= gap:
            out[-1] = (out[-1][0], max(out[-1][1], off))
        else:
            out.append((on, off))
    return out


def missed(s: Stream, spec: dict, window_tx: list, w0: int, w1: int) -> int:
    t0, t1 = s.start_ms(w0) / 1000.0, s.start_ms(w1) / 1000.0 - spec["settle_s"]
    n = 0
    for x in s.capture.transmitters:
        for on, off in s.capture.on_intervals(x.shift_hz, t0, t1):
            if on < t0 or off > t1 or off - on < spec["min_on_s"]:
                continue
            hit = any(abs(f - s.center - x.shift_hz) <= spec["freq_tolerance_hz"]
                      and on <= t / 1000.0 <= off + spec["late_s"] for _, f, t, _ in window_tx)
            n += not hit
    return n


def recording(s: Stream, tx: dict, k: int, f: int, device, numbers: dict, ctl: dict, control: bool) -> None:
    got = np.concatenate(tx[(k, f)])
    first = k
    while (first - 1, f) in tx and sum(len(x) for x in tx[(first, f)]) == s.n_out:
        first -= 1
    trimmed = s.n_out - len(got)
    if trimmed < 0 or (k != first and trimmed != 0):
        judge.worst(numbers, {"rec_excess_lsb": float("inf")})
        return
    stages = ref_ddc.stages_of(s.c)
    chunk = ref_ddc.phase_chunk(s.block, stages, s.c["ddc_phase_chunk_target"])
    hist = ref_ddc.history(stages)
    if k == first and (k == 0 or not s.c["ddc_restart_reads_history"]):
        seg, seg_start = s.iq(k, device), 0
    else:
        seg = torch.cat([s.iq(k - 1, device)[-hist:], s.iq(k, device)])
        seg_start = (k - first) * s.block - hist
    shift = np.array([f - s.center], dtype=np.int64)
    want = ref_ddc.record_block(seg, seg_start, s.n_out, shift, s.rate, stages, chunk)[0, trimmed:]
    judge.worst(numbers, judge.judge_recording(torch.from_numpy(got).to(device), want))
    if control:
        low = ref_ddc.record_block(seg, seg_start, s.n_out, shift, s.rate, stages, chunk, tf32_operands=True)[0, trimmed:]
        judge.worst(ctl, judge.judge_recording(torch.clamp(torch.round(low), -128, 127), want))


def spectrogram(s: Stream, blocks: range, bins: np.ndarray, device, numbers: dict, ctl: dict, control: bool) -> None:
    g = s.geo
    size = bins.size
    total = low = 0.0
    for k in blocks:
        power = ref_scan.psd_db(s.iq(k, device).reshape(g.frames, g.fft * g.decim, 2), g)  # [F, fft]
        total = total + power.reshape(g.frames, size, -1).mean(dim=-1).sum(dim=0)
        if control:
            low = low + ref_scan.rounded(power, "bfloat16").reshape(g.frames, size, -1).mean(dim=-1).sum(dim=0)
    frames = len(blocks) * g.frames
    mean = (total / frames).cpu().numpy()
    judge.worst(numbers, {"spectro_db": truncating_gap(bins, mean)})
    if control:
        guess = np.clip(np.trunc((low / frames).cpu().numpy()), -128, 127).astype(np.int8)
        judge.worst(ctl, {"spectro_db": truncating_gap(guess, mean)})
