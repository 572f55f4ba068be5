"""The port's wideband session against the JAX package's: the same replayed
wideband captures through the JAX ``WidebandScanner`` and the port's
``WidebandScanner(..., device="cpu")``, compared payload by payload, in the
serial form (cf32, int8 cs8 ingest, 2x-oversampled bank) and the one-card
batched forms (``mesh_bands=1``: split, fused, pipelined; JAX on conftest's
virtual CPU devices, where mesh_bands=1 resolves to one device too).

Tolerances (``torch_checks.compare_payloads``): the same MQTT topics in the
same order, equal headers, IQ within 1 LSB and spectrogram bins within 1.
Scenes: 1.024 Msps split into 4 channels of 256 kHz (fft 1024), band-wide
FM signals keyed after the 2 s noise learning, 16 kHz recordings.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.runtime import config as jconfig
from rtl_sdr_scanner_tpu.runtime import mqtt_client as jmqtt
from rtl_sdr_scanner_tpu.runtime import wideband as jwideband
from rtl_sdr_scanner_tpu_torch.runtime import config as tconfig
from rtl_sdr_scanner_tpu_torch.runtime import main as tmain
from rtl_sdr_scanner_tpu_torch.runtime import mqtt_client as tmqtt
from rtl_sdr_scanner_tpu_torch.runtime import wideband as twideband
from rtl_sdr_scanner_tpu_torch.runtime.data_controller import decode_transmission
from torch_checks import compare_payloads, recorded_tone

torch.set_num_threads(2)
RATE = 1_024_000
B = 4
CENTER = 145_000_000
SIGNALS = ((300_000, 800), (-300_000, 1300))  # channels 1 and 3


def _write(path, iq, fmt):
    pairs = iq.astype(np.complex64).view(np.float32)
    if fmt == "cf32":
        pairs.tofile(path)
    else:
        np.clip(np.round(pairs * 127.0), -128, 127).astype(np.int8).tofile(path)


def _scene(secs=5.0, signals=SIGNALS, key=(2.5, 4.5), seed=9, amp=0.4):
    rng = np.random.default_rng(seed)
    n = int(RATE * secs)
    t = np.arange(n) / RATE
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f, tone in signals:
        phase = 2 * np.pi * f * t + 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * tone * t)) / RATE
        iq += amp * np.exp(1j * phase) * ((t >= key[0]) & (t < key[1]))
    return iq


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wide")
    iq = _scene()
    paths = {}
    for fmt in ("cf32", "cs8"):
        paths[fmt] = tmp / f"wide.{fmt}"
        _write(paths[fmt], iq, fmt)
    return paths


def _raw(capture, fmt="cf32", tunables=None, workers=4):
    raw = jconfig.default_config_json()
    raw["tunables"] = dict(tunables or {})
    raw["recording"] = {"max_noise_time_ms": 1000, "min_sample_rate": 16000, "min_time_ms": 1000, "step": 2500}
    raw["devices"] = [{
        "enabled": True, "serial": "wide0", "driver": "replay", "sample_rate": RATE,
        "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
        "ranges": [{"start": CENTER - RATE // 2, "stop": CENTER + RATE // 2}],
        "file": str(capture), "file_format": fmt, "channels": B,
    }]
    raw["workers"] = workers
    return raw


def _scan(pkg, raw, manual=(), stop=True):
    """One replay through one package's WidebandScanner: (payloads, scanner)."""
    config_mod, mqtt_mod, wide_mod = (
        (jconfig, jmqtt, jwideband) if pkg == "jax" else (tconfig, tmqtt, twideband)
    )
    cfg = config_mod.Config(json.loads(json.dumps(raw)))
    mqtt = mqtt_mod.NullMqtt()
    mqtt.keep_payloads = True
    kw = {} if pkg == "jax" else {"device": "cpu"}
    scanner = wide_mod.WidebandScanner(cfg, cfg.devices[0], mqtt, recorders_count=cfg.recorders_count(), **kw)
    for frequency, duration in manual:
        assert scanner.manual_record(frequency, duration)
    scanner.run_to_completion()
    if stop:
        scanner.stop()
    return mqtt.published, scanner


def _both(raw, **kw):
    want, jscan = _scan("jax", raw, **kw)
    got, tscan = _scan("torch", raw, **kw)
    return got, compare_payloads(want, got), tscan, jscan


def _transmissions(payloads):
    return [decode_transmission(p) for t, p in payloads if t.endswith("/transmission/uint8")]


def _both_recorded(payloads):
    for f, tone in SIGNALS:
        _, n, got = recorded_tone(payloads, CENTER + f, 16000)
        assert n > 16000 and abs(got - tone) < 50, (f, n, got)


@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
def test_serial_matches_jax(captures, fmt):
    """The serial form: one channelizer call, then B sessions; cs8 goes in
    as int8 (int8_ingest, the default) and is dequantized by the bank."""
    got, stats, scanner, _ = _both(_raw(captures[fmt], fmt))
    assert scanner._mesh is None and stats["transmissions"] > 10
    _both_recorded(got)
    assert sum(1 for t, _ in got if t.endswith("/spectrogram")) >= 4 * B


def test_serial_oversampled_matches_jax(captures):
    got, stats, scanner, _ = _both(_raw(captures["cf32"], tunables={"channelizer_oversample": 2}))
    assert scanner._oversample == 2 and scanner.sessions[0].scan_cfg.sample_rate == 2 * RATE // B
    _both_recorded(got)


@pytest.mark.parametrize("form", ["split", "fused", "pipelined"])
def test_one_card_batched_forms_match_jax(captures, form):
    """mesh_bands=1: one dispatch a block for the channelizer and every
    channel's scan, then one banded DDC dispatch (split), or all of it in
    one dispatch (fused: slots reconciled before the dispatch), or split
    with one block in flight (pipelined)."""
    tunables = {"mesh_bands": 1, "wideband_fused_dispatch": form == "fused", "pipelined_ingest": form == "pipelined"}
    got, stats, scanner, jscanner = _both(_raw(captures["cs8"], "cs8", tunables))
    assert scanner._mesh is not None and scanner._mesh.shape == {"bands": 1, "time": 1}
    assert scanner._fused == (form == "fused") == jscanner._fused
    assert all(s.external_ddc for s in scanner.sessions)
    _both_recorded(got)


def test_noise_snapshots_and_final_flush_match_jax(tmp_path):
    """Per-channel noise snapshots under the JAX file names, in both
    directions, and the final partial spectrogram flushed on stop (one per
    channel)."""
    capture = tmp_path / "noise.cf32"
    _write(capture, _scene(secs=2.6, signals=()), "cf32")
    snaps = {}
    for pkg in ("jax", "torch"):
        base = tmp_path / pkg / "noise"
        base.parent.mkdir()
        payloads, scanner = _scan(pkg, _raw(capture, tunables={"noise_state_path": str(base)}), stop=False)
        before = sum(1 for t, _ in payloads if t.endswith("/spectrogram"))
        scanner.stop()
        assert sum(1 for t, _ in payloads if t.endswith("/spectrogram")) == before + B
        snaps[pkg] = payloads, [tmp_path / pkg / f"noise.replay_wide0.ch{ch}.npz" for ch in range(B)]
    compare_payloads(snaps["jax"][0], snaps["torch"][0])
    for a, b in zip(snaps["jax"][1], snaps["torch"][1]):
        with np.load(a) as ja, np.load(b) as tb:
            assert ja.files == tb.files and len(tb.files) == 1
            np.testing.assert_allclose(tb[tb.files[0]], ja[ja.files[0]], atol=1e-3)  # FFT rounding
    # a JAX snapshot resumes in the port: every channel's floor is ready
    cfg = tconfig.Config(_raw(capture, tunables={"noise_state_path": str(tmp_path / "jax" / "noise")}))
    scanner = twideband.WidebandScanner(cfg, cfg.devices[0], tmqtt.NullMqtt(), 4, device="cpu")
    for session in scanner.sessions:
        noise = session._noise_states.get(session.center_frequency)
        assert noise is not None and bool(noise.ready)


def test_manual_record_routes_to_its_channel(tmp_path):
    """A manual recording under the start level, routed to the channel whose
    core covers it; a frequency outside every core is refused."""
    t = np.arange(int(RATE * 4.0)) / RATE
    iq = _scene(secs=4.0, signals=()) + 0.02 * np.exp(2j * np.pi * 310_000 * t)
    capture = tmp_path / "manual.cf32"
    _write(capture, iq, "cf32")
    got, stats, scanner, _ = _both(_raw(capture), manual=[(CENTER + 310_000, 1500)])
    assert not scanner.manual_record(CENTER + 10_000_000, 1000)
    trans = _transmissions(got)
    assert trans and stats["transmissions"] == len(trans)
    assert all(abs((a + b) // 2 - CENTER - 310_000) <= 2500 for _, a, b, _, _ in trans)
    assert scanner.sessions[1].center_frequency == CENTER + 256_000


def test_fused_slot_restarted_within_a_pass_ingests_no_old_shift_block(captures):
    """The fused dispatch computes a block's DDC rows with the shifts of
    dispatch time. A slot stopped and started again at another shift during
    that block's host pass must not receive that block's rows (they belong
    to the old shift); its next block's rows arrive."""
    cfg = tconfig.Config(_raw(captures["cf32"], tunables={"mesh_bands": 1, "wideband_fused_dispatch": True}))
    scanner = twideband.WidebandScanner(cfg, cfg.devices[0], tmqtt.NullMqtt(), 4, device="cpu")
    session = scanner.sessions[1]  # the channel of the +300 kHz signal
    while not session.is_recording:
        assert scanner.step(), "the signal was never recorded"
    scanner.step()  # the slot's recording is now active at dispatch time
    rec = next(r for r in session._recorders if r.is_recording)
    real_update = session.update_recordings

    def restart_after(*args, **kwargs):
        real_update(*args, **kwargs)
        session._stop_slot(rec)
        session._start_slot(rec, rec_shift + 10_000, args[1])

    rec_shift = rec.shift
    assert session.recording_slots()[rec.index][0] == rec_shift
    session.update_recordings = restart_after
    scanner.step()
    session.update_recordings = real_update
    assert rec.shift == rec_shift + 10_000 and rec.pending == [] and rec.start_fraction == 0.0
    events = session._slot_events
    assert events[-2:] == [(rec.index, 0, False), (rec.index, rec_shift + 10_000, True)]
    scanner.step()  # reconciled before this dispatch: its rows use the new shift
    assert scanner._band_shifts[1, rec.index] == rec_shift + 10_000


def test_thread_failure_sets_flag(captures):
    cfg = tconfig.Config(_raw(captures["cf32"]))
    scanner = twideband.WidebandScanner(cfg, cfg.devices[0], tmqtt.NullMqtt(), 4, device="cpu")

    def boom():
        raise RuntimeError("injected fatal pipeline error")

    scanner.step = boom
    scanner.start()
    deadline = time.time() + 10
    while not scanner.failed and time.time() < deadline:
        time.sleep(0.05)
    assert scanner.failed
    scanner.stop()


def test_main_run_with_a_wideband_device(captures, tmp_path, monkeypatch):
    """main.run opens a WidebandScanner for a channels >= 2 device, drains
    the replay on its worker thread and returns 0 when stopped, with the
    payloads of the same session run directly."""
    raw = _raw(captures["cs8"], "cs8")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    made, mqtts, result = [], [], {}
    real = tmain.WidebandScanner

    class Watched(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def make_mqtt(config):
        m = tmqtt.NullMqtt()
        m.keep_payloads = True
        mqtts.append(m)
        return m

    monkeypatch.setattr(tmain, "WidebandScanner", Watched)
    monkeypatch.setattr(tmain, "make_mqtt", make_mqtt)
    monkeypatch.setattr(tmain, "Scanner", lambda *a, **k: pytest.fail("a wideband device opened a Scanner"))
    tmain._is_running = True
    thread = threading.Thread(target=lambda: result.setdefault("rc", tmain.run(str(path), device="cpu")))
    thread.start()
    try:
        deadline = time.time() + 120
        while not (made and made[0]._thread is not None and not made[0]._thread.is_alive()):
            assert time.time() < deadline and thread.is_alive(), "the wideband scanner did not drain"
            time.sleep(0.05)
    finally:
        tmain._is_running = False
        thread.join(timeout=60)
    assert result.get("rc") == 0 and not made[0].failed
    direct, _ = _scan("torch", raw)
    compare_payloads(direct, mqtts[0].published)
