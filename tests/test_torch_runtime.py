"""The port's runtime session against the JAX package's: the same replayed
captures through the JAX ``Scanner`` and the port's ``Scanner(...,
device="cpu")``, compared payload by payload, and the port's ``main.run``
lifecycle.

Tolerances (``chip_smoke.compare_payloads``): the same MQTT topics in the
same order, equal transmission and spectrogram headers, IQ within 1 LSB
(the DDC's f32 sums differ in order) and spectrogram bins within 1 (the
two FFTs differ by ~1e-4 dB, and a bin mean can sit on a truncation
boundary). Every scene decides its detections by a clear margin: band-wide
FM signals keyed after the 2 s noise learning (tests/test_end_to_end.py).
Geometries are the JAX tests' (256 kHz, fft 1024, 16 kHz recordings).
"""

import json
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import compare_payloads, psd_agreement, psd_within_bar, recorded_tone
from rtl_sdr_scanner_tpu.runtime import config as jconfig
from rtl_sdr_scanner_tpu.runtime import mqtt_client as jmqtt
from rtl_sdr_scanner_tpu.runtime import scanner as jscanner
from rtl_sdr_scanner_tpu_torch.runtime import config as tconfig
from rtl_sdr_scanner_tpu_torch.runtime import main as tmain
from rtl_sdr_scanner_tpu_torch.runtime import mqtt_client as tmqtt
from rtl_sdr_scanner_tpu_torch.runtime import scanner as tscanner
from rtl_sdr_scanner_tpu_torch.runtime.data_controller import decode_spectrogram, decode_transmission
from rtl_sdr_scanner_tpu_torch.runtime.sdr_device import SdrDevice, SpectroContainer

torch.set_num_threads(2)
RATE = 256000
CENTER = 145_000_000
SHIFT = 30_000


def _write(path, iq, fmt):
    pairs = iq.astype(np.complex64).view(np.float32)
    if fmt == "cf32":
        pairs.tofile(path)
    else:
        np.clip(np.round(pairs * 127.0), -128, 127).astype(np.int8).tofile(path)


def _noise(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(RATE * seconds)
    return np.arange(n) / RATE, 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


def _fm(t, shift, tone, t_on, t_off):
    phase = 2 * np.pi * shift * t + 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * tone * t)) / RATE
    return 0.4 * np.exp(1j * phase) * ((t >= t_on) & (t < t_off))


def _raw(capture, fmt="cf32", ranges=None, tunables=None, min_time_ms=1000, workers=2):
    raw = jconfig.default_config_json()
    raw["tunables"] = dict(tunables or {})
    raw["recording"] = {"max_noise_time_ms": 1000, "min_sample_rate": 16000, "min_time_ms": min_time_ms, "step": 2500}
    raw["devices"] = [{
        "enabled": True, "serial": "replay0", "driver": "replay", "sample_rate": RATE,
        "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
        "ranges": [{"start": a, "stop": b} for a, b in (ranges or [(CENTER - 100000, CENTER + 100000)])],
        "file": str(capture), "file_format": fmt,
    }]
    raw["workers"] = workers
    return raw


def _scan(pkg, raw, recorders=2, manual=(), spy_hops=False, stop=False):
    """One replay through one package's Scanner: (payloads, scanner, hops)."""
    config_mod, mqtt_mod, scanner_mod = (jconfig, jmqtt, jscanner) if pkg == "jax" else (tconfig, tmqtt, tscanner)
    cfg = config_mod.Config(json.loads(json.dumps(raw)))
    mqtt = mqtt_mod.NullMqtt()
    mqtt.keep_payloads = True
    kw = {} if pkg == "jax" else {"device": "cpu"}
    scanner = scanner_mod.Scanner(cfg, cfg.devices[0], mqtt, recorders_count=recorders, **kw)
    for frequency, duration in manual:
        assert scanner.manual_record(frequency, duration)
    hops = []
    if spy_hops:
        real = scanner.device.set_frequency_range
        scanner.device.set_frequency_range = lambda rng, now: (hops.append((now, rng)), real(rng, now))[1]
    scanner.run_to_completion()
    if stop:
        scanner.stop()
    return mqtt.published, scanner, hops


def _both(raw, **kw):
    """JAX and port runs of one config; their payload streams must agree."""
    want, jscan, jhops = _scan("jax", raw, **kw)
    got, tscan, thops = _scan("torch", raw, **kw)
    stats = compare_payloads(want, got)
    assert thops == jhops
    return got, stats, tscan, thops


def _transmissions(payloads):
    return [decode_transmission(p) for t, p in payloads if t.endswith("/transmission/uint8")]


def _spectrograms(payloads):
    return [decode_spectrogram(p) for t, p in payloads if t.endswith("/spectrogram")]


@pytest.fixture(scope="module")
def fm_captures(tmp_path_factory):
    """test_end_to_end's scene in cf32 and cs8: FM at +30 kHz keyed 3-7 s."""
    tmp = tmp_path_factory.mktemp("fm")
    t, iq = _noise(10.0, 9)
    iq = iq + _fm(t, SHIFT, 800, 3.0, 7.0)
    paths = {}
    for fmt in ("cf32", "cs8"):
        paths[fmt] = tmp / f"fm.{fmt}"
        _write(paths[fmt], iq, fmt)
    return paths


@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_end_to_end_matches_jax(fm_captures, fmt, compact):
    got, stats, scanner, _ = _both(_raw(fm_captures[fmt], fmt, tunables={"compact_detection": compact}))
    assert stats["transmissions"] > 10 and len(_spectrograms(got)) > 5
    center, n, tone = recorded_tone(got, CENTER + SHIFT, 16000)
    assert n > 2.0 * 16000 and abs(tone - 800) < 40
    _, start, stop, step, bins = _spectrograms(got)[0]
    assert (start, stop) == (CENTER - RATE // 2, CENTER + RATE // 2)
    assert len(bins) == scanner.device.scan_cfg.spectro_size and np.median(bins) < 0
    assert scanner.device._compact == compact


def test_no_signal_matches_jax(tmp_path):
    capture = tmp_path / "noise.cf32"
    _write(capture, _noise(5.0, 2)[1], "cf32")
    got, stats, _, _ = _both(_raw(capture))
    assert stats["transmissions"] == 0 and stats["payloads"] > 0


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_two_concurrent_recordings_match_jax(tmp_path, compact):
    t, iq = _noise(9.0, 21)
    iq = iq + _fm(t, 30_000, 800, 3.0, 7.0) + _fm(t, -60_000, 1300, 3.5, 6.5)
    capture = tmp_path / "two.cf32"
    _write(capture, iq, "cf32")
    got, _, _, _ = _both(_raw(capture, tunables={"compact_detection": compact}), recorders=3)
    for shift, tone in ((30_000, 800), (-60_000, 1300)):
        assert abs(recorded_tone(got, CENTER + shift, 16000)[2] - tone) < 50


def test_round_robin_hops_match_jax(tmp_path):
    """Two hops, a transmission at 4-7 s: the same hop times and payloads."""
    t, iq = _noise(10.0, 1)
    capture = tmp_path / "hop.cf32"
    _write(capture, iq + _fm(t, 30_000, 600, 4.0, 7.0), "cf32")
    raw = _raw(capture, ranges=[(CENTER - 100000, CENTER + 100000), (CENTER + 100000, CENTER + 300000)],
               tunables={"frames_per_block": 5}, min_time_ms=500)
    _, _, _, hops = _both(raw, spy_hops=True)
    assert len(hops) >= 6 and all(r0 != r1 for (_, r0), (_, r1) in zip(hops, hops[1:]))
    gaps = [t1 - t0 for (t0, _), (t1, _) in zip(hops, hops[1:])]
    assert max(gaps) >= 2500 and all(400 <= g <= 1100 for g in gaps if g < 1500), gaps


def test_manual_recording_matches_jax(tmp_path):
    t, iq = _noise(6.0, 5)
    iq = iq + 0.02 * np.exp(2j * np.pi * 30_000 * t)  # far below the start level
    capture = tmp_path / "manual.cf32"
    _write(capture, iq, "cf32")
    got, stats, scanner, _ = _both(_raw(capture, tunables={"compact_detection": True}), manual=[(CENTER + 30_000, 2000)])
    assert not scanner.manual_record(CENTER + 10_000_000, 1000)  # out of range
    trans = _transmissions(got)
    assert trans and all(r == 16000 and abs((a + b) // 2 - CENTER - 30_000) <= 2500 for _, a, b, r, _ in trans)
    assert 16000 <= sum(len(x[4]) for x in trans) <= 4 * 16000
    assert not scanner.device.has_manual_recording and not scanner.device.is_recording


def test_noise_snapshot_moves_both_ways(tmp_path):
    """A floor learned by either package resumes in the other: the tone
    keyed from t=0 (which a learner would bake into its floor) is detected,
    with the payloads of the JAX package resuming its own snapshot."""
    _, noise = _noise(3.0, 0)
    noise_cap = tmp_path / "noise.cf32"
    _write(noise_cap, noise, "cf32")
    t, iq = _noise(3.0, 5)
    tone_cap = tmp_path / "tone.cf32"
    _write(tone_cap, iq + _fm(t, 30_000, 700, 0.0, 3.0), "cf32")
    snaps = {}
    for pkg in ("jax", "torch"):
        base = tmp_path / pkg / "noise"
        base.parent.mkdir()
        _scan(pkg, _raw(noise_cap, tunables={"noise_state_path": str(base)}, min_time_ms=500), recorders=1, stop=True)
        snaps[pkg] = tmp_path / pkg / "noise.replay_replay0.npz"
        assert snaps[pkg].exists()
    with np.load(snaps["jax"]) as a, np.load(snaps["torch"]) as b:
        assert a.files == b.files == [f"t_{CENTER}"]
        assert a.files[0] and b[b.files[0]].dtype == np.float32 and b[b.files[0]].shape == (1024,)
        np.testing.assert_allclose(b[b.files[0]], a[a.files[0]], atol=1e-3)  # FFT rounding

    def resume(pkg, snapshot):
        base = tmp_path / f"resume_{pkg}_{snapshot.parent.name}" / "noise"
        base.parent.mkdir()
        shutil.copy(snapshot, f"{base}.replay_replay0.npz")
        raw = _raw(tone_cap, tunables={"noise_state_path": str(base)}, min_time_ms=500)
        return _scan(pkg, raw, recorders=1)[0]

    reference = resume("jax", snaps["jax"])
    assert _transmissions(reference), "the resumed floor should detect the always-on transmission"
    compare_payloads(reference, resume("torch", snaps["jax"]))  # JAX snapshot -> port
    compare_payloads(reference, resume("jax", snaps["torch"]))  # port snapshot -> JAX


def test_pipelined_ingest(fm_captures):
    """Pipelined ingest: the port's payloads equal the JAX package's
    pipelined run, and stay within test_pipelined_ingest.py's bounds of the
    port's serial run (the tracked keys reach the device one block later)."""
    serial = _transmissions(_scan("torch", _raw(fm_captures["cf32"]))[0])
    piped, _, _, _ = _both(_raw(fm_captures["cf32"], tunables={"pipelined_ingest": True}))
    piped = _transmissions(piped)
    assert serial and piped
    assert serial[0][1:4] == piped[0][1:4]
    total_s, total_p = (sum(x[4].shape[0] for x in s) for s in (serial, piped))
    assert abs(total_s - total_p) <= max(total_s, total_p) * 0.1
    np.testing.assert_array_equal(serial[0][4][:100], piped[0][4][:100])


def test_debug_sinks_match_jax(fm_captures, tmp_path, monkeypatch):
    """The three debug raw dumps (full power forces full-row mode): the same
    files, the power rows within the PSD bar (``chip_smoke.psd_agreement``:
    0.02 dB on every bin within 60 dB of its row's peak, a median of 1e-3
    dB over every bin, |dP| <= 1e-5 of the row's peak power on every bin;
    looser than a max |dB| only on bins more than 60 dB down; the two f32
    FFTs round a deep null's few dB apart, and which way depends on the
    CPU's SIMD paths), raw IQ equal, recordings within 1 LSB."""
    tun = {"debug_save_full_power": True, "debug_save_full_raw_iq": True, "debug_save_recording_raw_iq": True}
    files = {}
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        _, scanner, _ = _scan(pkg, _raw(fm_captures["cf32"], tunables=tun))
        assert not scanner.device._compact
        fft = scanner.device.scan_cfg.fft_size
        for sink in [scanner.device._power_sink, scanner.device._raw_iq_sink, *scanner.device._rec_sinks]:
            sink.stop()
        files[pkg] = {"_".join(p.name.split("_")[3:]): p for p in (tmp_path / pkg).glob("*.raw")}
    assert sorted(files["torch"]) == sorted(files["jax"]) and len(files["jax"]) >= 3
    for key, path in files["torch"].items():
        want = files["jax"][key]
        if key.endswith("power.raw"):
            rows = [torch.from_numpy(np.fromfile(p, np.float32).reshape(-1, fft)) for p in (path, want)]
            agreement = psd_agreement(*rows)
            assert psd_within_bar(agreement), agreement
        elif key.endswith("fc.raw"):
            assert path.read_bytes() == want.read_bytes()
        else:
            d = np.fromfile(path, np.int8).astype(int) - np.fromfile(want, np.int8).astype(int)
            assert np.abs(d).max() <= 1


def test_profile_dir_writes_a_torch_trace(tmp_path):
    capture = tmp_path / "noise.cs8"
    _write(capture, _noise(1.0, 3)[1], "cs8")
    _scan("torch", _raw(capture, "cs8", tunables={"profile_dir": str(tmp_path / "prof")}))
    trace = tmp_path / "prof" / "trace_cpu.json"
    assert trace.exists() and "scan.psd" in trace.read_text()


def test_flush_spectrogram_covers_all_hop_centers():
    """Session stop sends every center's partial spectrogram under its own
    center frequency."""
    raw = jconfig.default_config_json()
    raw["devices"] = [{
        "enabled": True, "serial": "flushdev", "driver": "rtlsdr", "sample_rate": 2048000,
        "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
        "ranges": [{"start": 144000000, "stop": 146000000}],
    }]
    cfg = tconfig.Config(raw)
    mqtt = tmqtt.NullMqtt()
    mqtt.keep_payloads = True
    dev = SdrDevice(cfg, cfg.devices[0], mqtt, recorders_count=1, device="cpu")
    dev.set_frequency_range((144_000_000, 146_000_000), now_ms=0)
    for center, level in ((dev.center_frequency, 10.0), (147_000_000, 20.0)):
        container = SpectroContainer(dev.scan_cfg.spectro_size, 0)
        container.sum[:] = level
        container.counter = 1
        dev._spectro_containers[center] = container
    dev.flush_spectrogram(5000)
    spectro = _spectrograms(mqtt.published)
    assert sorted(s[1] + (s[2] - s[1]) // 2 for s in spectro) == [145_000_000, 147_000_000]
    assert all(c.counter == 0 for c in dev._spectro_containers.values())


# -- main.run lifecycle (tests/test_main_lifecycle.py's cases) -----------------


def _config_file(tmp_path, raw):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    return path


@pytest.fixture
def short_capture(tmp_path):
    path = tmp_path / "cap.cf32"
    _write(path, _noise(2.0, 0)[1], "cf32")
    return path


def _run_in_thread(path, **kw):
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("rc", tmain.run(str(path), **kw)))
    thread.start()
    return thread, result


def test_main_run_reload_and_stop(tmp_path, short_capture, monkeypatch):
    mqtts = []

    def make_mqtt(config):
        m = tmqtt.NullMqtt()
        m.keep_payloads = True
        mqtts.append(m)
        return m

    monkeypatch.setattr(tmain, "make_mqtt", make_mqtt)
    path = _config_file(tmp_path, _raw(short_capture))
    tmain._is_running = True
    thread, result = _run_in_thread(path, device="cpu")
    try:
        deadline = time.time() + 60
        while not mqtts and time.time() < deadline:
            time.sleep(0.05)
        assert mqtts, "runtime did not start"
        topic = next(t for t, _ in mqtts[0]._callbacks if t.startswith("sdr/config/"))
        new_cfg = _raw(short_capture, workers=3)
        mqtts[0].inject(topic, json.dumps(new_cfg))
        deadline = time.time() + 60
        while len(mqtts) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(mqtts) >= 2, "reload did not rebuild the runtime"
        assert json.loads(path.read_text())["workers"] == 3
        assert any(t.endswith("/success") for t, _ in mqtts[0].published)
    finally:
        tmain._is_running = False
        thread.join(timeout=60)
    assert result.get("rc") == 0


def test_main_skips_disabled_and_empty_devices(tmp_path, short_capture, monkeypatch):
    raw = _raw(short_capture)
    raw["devices"][0]["enabled"] = False
    raw["devices"].append(dict(raw["devices"][0], enabled=True, serial="r2", ranges=[]))
    made = []
    monkeypatch.setattr(tmain, "Scanner", lambda *a, **k: made.append(1))
    monkeypatch.setattr(tmain, "make_mqtt", lambda cfg: tmqtt.NullMqtt())
    tmain._is_running = True
    threading.Timer(0.5, lambda: setattr(tmain, "_is_running", False)).start()
    assert tmain.run(str(_config_file(tmp_path, raw)), device="cpu") == 0
    assert made == []


def test_main_exits_on_fatal_scanner_failure(tmp_path, short_capture, monkeypatch):
    class FailingScanner:
        def __init__(self, *a, **k):
            self.failed = False

        def start(self):
            threading.Timer(0.2, lambda: setattr(self, "failed", True)).start()

        def stop(self):
            pass

    monkeypatch.setattr(tmain, "Scanner", FailingScanner)
    monkeypatch.setattr(tmain, "make_mqtt", lambda cfg: tmqtt.NullMqtt())
    tmain._is_running = True
    thread, result = _run_in_thread(_config_file(tmp_path, _raw(short_capture)), device="cpu")
    thread.join(timeout=10)
    assert not thread.is_alive() and tmain._is_running is False
    assert result["rc"] == 1


# the multi-device paths and power_bf16 (lifted by slice 8) and multihost
# (slice 9: one process here, so initialize joins no group, over the bands mesh of
# a wideband device) run, with two visible cards patched in (the CPU mesh:
# copies of the CPU device); no path is refused any more
UNPORTED = {
    "wideband": ({"mesh_bands": 2}, {"channels": 4}, None),
    "mesh_time": ({"mesh_time": 2}, {}, None),
    "mesh_bands": ({"mesh_bands": -1}, {"channels": 4}, None),
    "multihost": ({"multihost": True, "mesh_bands": -1}, {"channels": 4}, None),
    "power_bf16": ({"power_bf16": True}, {}, None),
}


def _run_main_until_drained(path, monkeypatch):
    """main.run on a worker thread until its one scanner has drained the
    replay: (rc, payloads, scanner)."""
    made, mqtts, result = [], [], {}
    for name in ("Scanner", "WidebandScanner"):
        real = getattr(tmain, name)
        watched = type("Watched", (real,), {"__init__": lambda self, *a, _r=real, **k: (_r.__init__(self, *a, **k), made.append(self))[0]})
        monkeypatch.setattr(tmain, name, watched)

    def make_mqtt(config):
        m = tmqtt.NullMqtt()
        m.keep_payloads = True
        mqtts.append(m)
        return m

    monkeypatch.setattr(tmain, "make_mqtt", make_mqtt)
    tmain._is_running = True
    thread, result = _run_in_thread(path, device="cpu")
    try:
        deadline = time.time() + 120
        while not (made and made[0]._thread is not None and not made[0]._thread.is_alive()):
            assert time.time() < deadline and thread.is_alive(), "the scanner did not drain"
            time.sleep(0.05)
    finally:
        tmain._is_running = False
        thread.join(timeout=60)
    return result.get("rc"), mqtts[0].published, made[0]


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_paths_are_refused(tmp_path, short_capture, monkeypatch, case):
    """A path the port lacks: main.run logs one error naming the ROADMAP
    item and returns 1 before any scanner starts; Scanner and SdrDevice
    raise NotImplementedError. A path slices 8 and 9 ported: main.run runs
    it to the end of the replay (rc 0, payloads published) in the mode
    asked for."""
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

    tunables, device_fields, slice_name = UNPORTED[case]
    raw = _raw(short_capture, tunables=tunables)
    raw["devices"][0].update(device_fields)
    monkeypatch.setattr(sdr_device, "visible_cards", lambda device: 2)
    path = _config_file(tmp_path, raw)
    cfg = tconfig.Config(raw)
    if slice_name is None:
        rc, payloads, scanner = _run_main_until_drained(path, monkeypatch)
        assert rc == 0 and not scanner.failed and payloads
        assert any(t.endswith("/spectrogram") for t, _ in payloads)
        if case == "mesh_time":
            assert scanner.device._time_mesh.shape == {"bands": 1, "time": 2}
        elif case == "power_bf16":
            assert scanner.device.scan_cfg.power_bf16
        else:
            assert scanner._mesh.shape == {"bands": 2, "time": 1}
        return
    errors, made = [], []
    monkeypatch.setattr(tmain.logger, "error", lambda label, msg, *a: errors.append(msg.format(*a)))
    monkeypatch.setattr(tmain, "Scanner", lambda *a, **k: made.append(1))
    monkeypatch.setattr(tmain, "make_mqtt", lambda cfg: made.append("mqtt"))
    tmain._is_running = True
    assert tmain.run(str(path), device="cpu") == 1
    assert made == [] and len(errors) == 1 and slice_name in errors[0] and "ROADMAP.md" in errors[0]
    with pytest.raises(NotImplementedError, match=slice_name):
        tscanner.Scanner(cfg, cfg.devices[0], tmqtt.NullMqtt(), 1, device="cpu")
    with pytest.raises(NotImplementedError, match=slice_name):
        SdrDevice(cfg, cfg.devices[0], tmqtt.NullMqtt(), 1, device="cpu")


def test_mesh_bands_on_one_card_or_without_a_wideband_device_runs(tmp_path, short_capture, monkeypatch):
    """mesh_bands resolves as the reference's does (at most the cards and
    the channels): on one card a wideband device takes the one-card batched
    form; a device without channels ignores it (only a wideband scanner
    reads it), and main.run starts its scanner and returns 0. A mesh builds
    on explicit devices (one device named more than once), and one asking
    for more devices than it is given raises."""
    from rtl_sdr_scanner_tpu_torch.parallel import mesh
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner

    assert sdr_device.mesh_bands_cards(-1, 16, 1) == 1 and sdr_device.mesh_bands_cards(3, 4, 8) == 2
    assert sdr_device.mesh_bands_cards(-1, 16, 4) == 4 and sdr_device.mesh_bands_cards(8, 16, 4) == 4
    cuda1 = torch.device("cuda", 1)
    assert sdr_device.mesh_devices(cuda1, 1) == [cuda1]  # one shard: the session's own device
    assert sdr_device.mesh_devices(cuda1, 3) == [torch.device("cuda", i) for i in range(3)]
    assert sdr_device.mesh_devices(torch.device("cpu"), 3) == [torch.device("cpu")] * 3
    raw = _raw(short_capture, tunables={"mesh_bands": -1})
    cfg = tconfig.Config(raw)
    assert sdr_device.unported_path(cfg, cfg.devices[0], torch.device("cpu")) is None
    made = []
    monkeypatch.setattr(tmain, "Scanner", lambda *a, **k: made.append(1) or _Idle())
    monkeypatch.setattr(tmain, "make_mqtt", lambda c: tmqtt.NullMqtt())
    tmain._is_running = True
    threading.Timer(0.5, lambda: setattr(tmain, "_is_running", False)).start()
    assert tmain.run(str(_config_file(tmp_path, raw)), device="cpu") == 0 and made == [1]
    wide = _raw(short_capture, tunables={"mesh_bands": -1})
    wide["devices"][0].update(channels=4, sample_rate=1_024_000)
    wcfg = tconfig.Config(wide)
    assert sdr_device.unported_path(wcfg, wcfg.devices[0], torch.device("cpu")) is None
    scanner = WidebandScanner(wcfg, wcfg.devices[0], tmqtt.NullMqtt(), 4, device="cpu")
    assert scanner._mesh is not None and scanner._mesh.device.type == "cpu"
    assert mesh.band_sharding(scanner._mesh) == mesh.replicated(scanner._mesh) == [torch.device("cpu")]
    cpu = torch.device("cpu")
    for bands, time_ in ((2, 1), (1, 2)):
        m = mesh.make_mesh(bands, time_, devices=["cpu"] * 2)
        assert m.shape == {"bands": bands, "time": time_} and mesh.replicated(m) == [cpu, cpu]
        assert mesh.band_sharding(m) == [cpu] * bands and m.time_devices == [cpu] * time_
        with pytest.raises(ValueError, match="exceeds 1 devices"):
            mesh.make_mesh(bands, time_, devices=["cpu"])


def _time_mesh_capture(tmp_path):
    """tests/test_mesh_runtime.py:135-146's scene: 8 s, FM at +30 kHz keyed 3-6 s."""
    rng = np.random.default_rng(21)
    n = int(RATE * 8.0)
    t = np.arange(n) / RATE
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    phase = 2 * np.pi * 30000 * t + 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * 900 * t)) / RATE
    iq += 0.4 * np.exp(1j * phase) * ((t >= 3.0) & (t < 6.0))
    capture = tmp_path / "one.cf32"
    _write(capture, iq, "cf32")
    return capture


def test_time_mesh_session_matches_serial_and_jax(tmp_path, monkeypatch):
    """mesh_time=4 over four CPU shards (four visible cards patched in):
    the time-sharded scan and modulated-taps DDC give the serial session's
    transmission payloads byte for byte and its spectrogram bins within 1
    (tests/test_mesh_runtime.py:129-200), and the JAX package's serial
    session's payloads within compare_payloads' bars."""
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

    monkeypatch.setattr(sdr_device, "visible_cards", lambda device: 4)
    capture = _time_mesh_capture(tmp_path)
    serial_raw = _raw(capture, tunables={"frames_per_block": 96, "mesh_time": 0})
    meshed, scanner, _ = _scan("torch", _raw(capture, tunables={"frames_per_block": 96, "mesh_time": 4}))
    assert scanner.device._time_mesh.shape == {"bands": 1, "time": 4}
    assert scanner.device.tmesh_ddc, "time-sharded DDC did not engage"
    assert scanner.device.scan_cfg.frames_per_block == 96
    serial, _, _ = _scan("torch", serial_raw)
    s_trans = [p for t_, p in serial if t_.endswith("/transmission/uint8")]
    m_trans = [p for t_, p in meshed if t_.endswith("/transmission/uint8")]
    assert s_trans and m_trans == s_trans, "transmission payloads diverged (time mesh vs serial)"
    s_spec, m_spec = _spectrograms(serial), _spectrograms(meshed)
    assert len(s_spec) == len(m_spec) > 0
    for (ts, a0, a1, st, sb), (tm, b0, b1, mt, mb) in zip(s_spec, m_spec):
        assert (ts, a0, a1, st) == (tm, b0, b1, mt)
        assert np.abs(sb.astype(np.int32) - mb.astype(np.int32)).max() <= 1
    jax_serial, _, _ = _scan("jax", serial_raw)
    assert compare_payloads(jax_serial, meshed)["transmissions"] == len(m_trans)
    assert abs(recorded_tone(meshed, CENTER + 30_000, 16000)[2] - 900) < 40


@pytest.mark.parametrize("form", ["split", "fused"])
@pytest.mark.parametrize("mesh_bands", [2, -1])
def test_wideband_band_shards_match_one_card(tmp_path, monkeypatch, mesh_bands, form):
    """A wideband session over band shards (four visible cards patched in:
    mesh_bands 2 -> 2 shards, -1 -> 4) gives the one-card batched run's
    payloads byte for byte, in the split and the fused form."""
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device
    from tests.test_torch_wideband import _raw as wide_raw
    from tests.test_torch_wideband import _scan as wide_scan
    from tests.test_torch_wideband import _scene as wide_scene
    from tests.test_torch_wideband import _write as wide_write

    capture = tmp_path / "wide.cs8"
    wide_write(capture, wide_scene(), "cs8")
    tun = {"wideband_fused_dispatch": form == "fused"}
    one, one_scanner = wide_scan("torch", wide_raw(capture, "cs8", {**tun, "mesh_bands": 1}))
    monkeypatch.setattr(sdr_device, "visible_cards", lambda device: 4)
    got, scanner = wide_scan("torch", wide_raw(capture, "cs8", {**tun, "mesh_bands": mesh_bands}))
    assert one_scanner._mesh.shape["bands"] == 1
    assert scanner._mesh.shape == {"bands": 2 if mesh_bands == 2 else 4, "time": 1} and scanner._fused == (form == "fused")
    assert got == one and sum(1 for t, _ in got if t.endswith("/transmission/uint8")) > 10


class _Idle:
    failed = False

    def start(self):
        pass

    def stop(self):
        pass


@pytest.mark.parametrize("case", ["select_fft_128", "wideband_select_fft_128", "psd_fft_128", "runs",
                                  "psd_fft_2_23", "psd_fft_2_25", "select_below_top_k"])
def test_unported_path_names_kernel_geometries_on_the_card(short_capture, case):
    """On a CUDA device, unported_path names only what the JAX package
    cannot run either (compact detection below detection_top_k) and an int8
    fft above the PSD kernel's 2^24; the selection at fft 128 (a single
    32 kHz band, 64 channels of 2.048 Msps), the int8 PSD at fft 128 and at
    fft 2^23 (a 2 Gsps direct-sampling band) run there. It reads only the
    config, so it launches nothing here. On the CPU the same configs run the
    plain versions."""
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

    rate, channels, tunables, want = {
        "select_fft_128": (32_000, 0, {}, None),  # fft 128 at 250 Hz bins
        "wideband_select_fft_128": (2_048_000, 64, {}, None),  # 32 kHz channels
        "psd_fft_128": (32_000, 0, {"compact_detection": False}, None),
        "runs": (2_048_000, 16, {}, None),  # 128 kHz channels: fft 512
        "psd_fft_2_23": (2_000_000_000, 0, {}, None),  # fft 2^23: the cluster scratch form
        "psd_fft_2_25": (8_000_000_000, 0, {}, "int8 PSD kernel's [2, 2^24]"),  # fft 2^25
        "select_below_top_k": (8_000, 0, {}, "detection_top_k 64"),  # fft 32
    }[case]
    raw = _raw(short_capture, tunables=tunables)
    raw["devices"][0].update(sample_rate=rate, channels=channels)
    cfg = tconfig.Config(raw)
    reason = sdr_device.unported_path(cfg, cfg.devices[0], torch.device("cuda"))
    assert (reason is None) if want is None else (want in reason and "on the card" in reason)
    assert tmain._refusal(cfg, torch.device("cuda")) == reason
    assert sdr_device.unported_path(cfg, cfg.devices[0], torch.device("cpu")) is None
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("compact", [False, True])
def test_unported_path_takes_every_fft_the_jax_package_scans(short_capture, compact):
    """Every power-of-two fft from 16 to 2^24 (a 4.096 Gsps band at 250 Hz
    bins) on an int8 single-band device runs on the card, in full-row mode
    and with compact detection at a detection_top_k the fft holds (the JAX
    package's top-k needs k <= fft); fft 2^25, above the PSD kernel's
    largest instantiated size, is refused."""
    from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

    for log in range(4, 26):
        fft = 1 << log
        tunables = {"compact_detection": compact, "detection_top_k": min(64, fft)}
        raw = _raw(short_capture, tunables=tunables)
        raw["devices"][0].update(sample_rate=250 * fft)  # 250 Hz bins
        cfg = tconfig.Config(raw)
        reason = sdr_device.unported_path(cfg, cfg.devices[0], torch.device("cuda"))
        assert (reason is None) == (log <= 24), (fft, reason)
    assert not torch.cuda.is_initialized()


def test_scanner_thread_failure_sets_flag(tmp_path, monkeypatch):
    from tests.fake_soapy import make_fake_soapy

    monkeypatch.setitem(sys.modules, "SoapySDR", make_fake_soapy(
        total_samples=RATE * 30, short_read_max=8192, inject_results={6: -7}))
    raw = _raw("ignored", tunables={"initial_delay_ms": 10})
    for key in ("file", "file_format"):
        del raw["devices"][0][key]
    raw["devices"][0]["driver"] = "rtlsdr"
    cfg = tconfig.Config(raw)
    scanner = tscanner.Scanner(cfg, cfg.devices[0], tmqtt.NullMqtt(), recorders_count=1, device="cpu")
    scanner.start()
    deadline = time.time() + 20
    while not scanner.failed and time.time() < deadline:
        time.sleep(0.05)
    assert scanner.failed, "scanner did not surface the stream failure"
    scanner.stop()
