"""The bars the port is held to, shared by the CPU tests, the card tests,
``chip_smoke.py`` and the card scripts under ``scripts/``: the PSD bar, the
payload comparison, the FM tone check, the selection's row-split scenes,
the synthetic cs8 captures, ``runtime.main.run`` driven on a worker thread,
and the multi-host launch (ranks over a free localhost port, the env
contract taken out). It imports neither JAX nor ``chip_smoke``.

Tests import it as ``torch_checks`` (pytest puts ``tests/`` on the path);
``chip_smoke.py`` and the card scripts put ``tests/`` on ``sys.path``
themselves.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

PSD_TOL_DB = 0.02
PSD_MEDIAN_TOL_DB = 1e-3
PSD_NEAR_DB = 60.0  # the dB bars hold on the bins within this of their row's peak
PSD_LINEAR_TOL = 1e-5  # |dP| over the row's peak power, on every bin
# the FM signal's tone in the synthetic captures (write_capture)
RT_TONE = 800.0
# (rows, fft, top_k, k_sep, submargin): the selection's row-split form and the
# boundary to the warp-a-row form (at most 384 rows of 2^17-2^24 split),
# on rows with ties across every slice edge (split_selection_rows); its
# widened leaves at [16, 2^23] (512 bins) and [16, 2^24] (1024)
SPLIT_SELECT_CASES = ((1, 1 << 18, 64, 16, 64), (16, 1 << 21, 64, 16, 64), (45, 131072, 64, 16, 52),
                      (45, 131072, 64, 16, 5000), (180, 131072, 64, 16, 52), (384, 131072, 64, 16, 52),
                      (385, 131072, 64, 16, 52), (6, 1 << 22, 8, 4, 3), (16, 1 << 23, 64, 16, 64),
                      (16, 1 << 24, 64, 16, 64))
# the multi-host scene (tests/test_multihost.py's): channel b's core is
# centered at (b mod 8) * 256 kHz from the center
MH_RATE = 2_048_000
MH_CHANNELS = 8
MH_CENTER = 145_000_000
ENV_CONTRACT = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def psd_agreement(got_db: torch.Tensor, want_db: torch.Tensor) -> dict:
    """Two PSD dB arrays [rows, fft] under the PSD bar: the max |diff| (dB)
    on the bins within PSD_NEAR_DB of their row's peak, the median |diff|
    and the max over every bin, and the largest |dP| over the row's peak
    power on any bin (f32 FFTs that round differently agree in power; at a
    deep null a dB difference has no bound)."""
    got, want = got_db.double(), want_db.double()
    diff = (got - want).abs()
    peak = want.amax(dim=1, keepdim=True)
    near = want >= peak - PSD_NEAR_DB
    d_power = (torch.pow(10.0, got / 10) - torch.pow(10.0, want / 10)).abs()
    return dict(max_db=diff[near].max().item(), median_db=diff.median().item(),
                all_max_db=diff.max().item(), linear=(d_power / torch.pow(10.0, peak / 10)).max().item())


def psd_within_bar(agreement: dict) -> bool:
    return (agreement["max_db"] <= PSD_TOL_DB and agreement["median_db"] <= PSD_MEDIAN_TOL_DB
            and agreement["linear"] <= PSD_LINEAR_TOL)


def split_selection_rows(fft: int, n_rows: int, slice_bins: int, rng) -> np.ndarray:
    """Rows for the selection's row-split form: ties across every slice edge
    (equal maxima on both sides of it), exact ties everywhere, a masked
    (-3.0e38) tail the top-K reaches into, fully masked rows (the
    all-suppressed corner), values at the level, clusters straddling slice
    edges."""
    from rtl_sdr_scanner_tpu_torch.drivers import LEVEL

    rows = rng.normal(0.0, 6.0, size=(max(n_rows, 6), fft)).astype(np.float32)
    edges = np.arange(slice_bins, fft, slice_bins)
    rows[0::6, edges - 1] = 60.0
    rows[0::6, edges] = 60.0
    rows[1::6] = np.round(rows[1::6] / 4.0)
    rows[2::6, 40:] = -3.0e38
    rows[3::6] = -3.0e38
    rows[4::6, fft // 2 :] = LEVEL
    for e in edges[::3]:
        rows[5::6, e - 30 : e + 30] += 25.0
    return rows[:n_rows]


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


def run_main(config_path: Path, device=None, timeout_s: float = 300.0, scanners: int = 1, on_made=None):
    """``runtime.main.run(config)`` on a worker thread, as a user runs it;
    stopped through ``main._is_running`` once its ``scanners`` scanners
    (``Scanner`` or ``WidebandScanner``, a thread each) have drained their
    replays. ``on_made(scanner)`` runs on each scanner before it starts.
    Returns (rc, payloads)."""
    from rtl_sdr_scanner_tpu_torch.runtime import main as rt_main
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt

    made, mqtts, result = [], [], []
    real = {name: getattr(rt_main, name) for name in ("Scanner", "WidebandScanner", "make_mqtt")}

    def watched(cls):
        class Watched(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)
                if on_made is not None:
                    on_made(self)

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


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(argv_of, world: int, timeout_s: float, env_of=lambda rank: {}, cwd=None) -> list:
    """``world`` processes, rank r running ``argv_of(r, port)`` (``port``: a
    free localhost port for their process group) in this environment with
    ``env_of(r)`` over it and the env contract taken out. Returns each
    rank's (exit code, output). If they outlive ``timeout_s``, every child
    is killed by its PID and this raises with their output."""
    port = free_port()
    procs, outs = [], [None] * world
    try:
        for rank in range(world):
            env = dict(os.environ, **env_of(rank))
            for name in ENV_CONTRACT:
                env.pop(name, None)
            procs.append(subprocess.Popen(
                [str(a) for a in argv_of(rank, port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd,
            ))
        deadline = time.monotonic() + timeout_s
        for rank, p in enumerate(procs):
            outs[rank] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [out if out is not None else p.communicate()[0] for p, out in zip(procs, outs)]
        raise RuntimeError(f"children outlived {timeout_s} s:\n" + "\n---\n".join(o[-4000:] for o in logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def band_of(frequency: int) -> int:
    """The multi-host scene's channel whose core holds ``frequency``."""
    core = MH_RATE // MH_CHANNELS
    return int(round((frequency - MH_CENTER) / core) % MH_CHANNELS)


def payload_band(topic: str, payload: bytes) -> int:
    from rtl_sdr_scanner_tpu_torch.runtime.data_controller import decode_spectrogram, decode_transmission

    decode = decode_transmission if topic.endswith("/transmission/uint8") else decode_spectrogram
    _, s0, s1, _, _ = decode(payload)
    return band_of((s0 + s1) // 2)
