"""The port's host layer against the JAX package's, on the same inputs:
config and migrator, tunables overrides, the wire codecs, the native byte
codecs and ingest ring, replay sources, the transmission tracker, the
remote controller, the MQTT stand-in, the live source on the fake
SoapySDR, and the small utilities. Mirrors the host cases of
tests/test_runtime.py, test_mqtt.py (NullMqtt / make_mqtt), test_live_source.py,
test_native_ring.py, test_utils.py, test_collection_utils.py and
test_radio_utils.py. Host code is copied, so every comparison here is exact.
"""

import copy
import dataclasses
import datetime
import json
import sys
import time

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu import native as jnative
from rtl_sdr_scanner_tpu.runtime import config as jconfig
from rtl_sdr_scanner_tpu.runtime import config_migrator as jmigrator
from rtl_sdr_scanner_tpu.runtime import data_controller as jdata
from rtl_sdr_scanner_tpu.runtime import mqtt_client as jmqtt
from rtl_sdr_scanner_tpu.runtime import remote_controller as jremote
from rtl_sdr_scanner_tpu.runtime import sources as jsources
from rtl_sdr_scanner_tpu.runtime import transmission_tracker as jtracker
from rtl_sdr_scanner_tpu.utils import collection_utils as jcoll
from rtl_sdr_scanner_tpu.utils import radio_utils as jradio
from rtl_sdr_scanner_tpu.utils import utils as jutils
from rtl_sdr_scanner_tpu_torch import native as tnative
from rtl_sdr_scanner_tpu_torch.runtime import config as tconfig
from rtl_sdr_scanner_tpu_torch.runtime import config_migrator as tmigrator
from rtl_sdr_scanner_tpu_torch.runtime import data_controller as tdata
from rtl_sdr_scanner_tpu_torch.runtime import mqtt_client as tmqtt
from rtl_sdr_scanner_tpu_torch.runtime import remote_controller as tremote
from rtl_sdr_scanner_tpu_torch.runtime import sources as tsources
from rtl_sdr_scanner_tpu_torch.runtime import transmission_tracker as ttracker
from rtl_sdr_scanner_tpu_torch.utils import collection_utils as tcoll
from rtl_sdr_scanner_tpu_torch.utils import radio_utils as tradio
from rtl_sdr_scanner_tpu_torch.utils import utils as tutils
from tests.fake_soapy import fm_synth, make_fake_soapy

torch.set_num_threads(2)


def _device_json(**kw):
    base = {
        "enabled": True,
        "serial": "00000001",
        "driver": "rtlsdr",
        "sample_rate": 2048000,
        "start_recording_level": 8,
        "stop_recording_level": 5,
        "gains": [{"name": "TUNER", "value": 28.0}],
        "ranges": [{"start": 430000000, "stop": 440000000}, {"start": 144000000, "stop": 146000000}],
    }
    base.update(kw)
    return base


def _raw():
    raw = jconfig.default_config_json()
    raw["devices"] = [_device_json(), _device_json(serial="replay1", driver="replay", file="x.cs8",
                                                   file_format="cs8", channels=4)]
    raw["ignored_frequencies"] = [
        {"frequency": 200, "bandwidth": 10},
        {"frequency": 145000000, "bandwidth": 20000},
        {"frequency": 100, "bandwidth": 20},
    ]
    raw["workers"] = 3
    raw["mqtt"] = {"ca_file": "/ca.pem"}
    return raw


def _config_view(cfg):
    return dict(
        devices=[dataclasses.asdict(d) for d in cfg.devices],
        names=[d.name for d in cfg.devices],
        # the port has no kernel switches (use_pallas_*)
        tunables={k: v for k, v in dataclasses.asdict(cfg.tunables).items() if not k.startswith("use_pallas_")},
        ignored=cfg.ignored_ranges,
        recording=(cfg.recording_bandwidth, cfg.recording_min_time_ms, cfg.recording_timeout_ms,
                   cfg.recording_tuning_step),
        output=(cfg.color_log_enabled, cfg.console_log_level, cfg.file_log_level),
        mqtt=(cfg.mqtt_url, cfg.mqtt_username, cfg.mqtt_password, cfg.mqtt_ca_file, cfg.mqtt_enabled),
        recorders=cfg.recorders_count(),
        json=cfg.json,
    )


def test_default_config_json_equal():
    assert tconfig.default_config_json() == jconfig.default_config_json()


def test_config_fields_equal(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_raw()))
    want = jconfig.Config.load_from_file(str(path), scan_hardware=False)
    got = tconfig.Config.load_from_file(str(path), scan_hardware=False)
    assert _config_view(got) == _config_view(want)
    assert got.devices[0].name == "rtlsdr_00000001" and got.devices[1].channels == 4
    # save-back strips the same probe-derived fields
    jconfig.Config.save_to_file(str(tmp_path / "j.json"), want.json)
    tconfig.Config.save_to_file(str(tmp_path / "t.json"), got.json)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_config_migrator_equal():
    raw = _raw()
    raw["version"] = 0
    want, got = copy.deepcopy(raw), copy.deepcopy(raw)
    jmigrator.migrate(want)
    jmigrator.sort_config(want)
    tmigrator.migrate(got)
    tmigrator.sort_config(got)
    assert got == want
    assert got["version"] == 2
    assert [i["frequency"] for i in got["ignored_frequencies"]] == [100, 200, 145000000]
    assert got["devices"][0]["ranges"][0]["start"] == 144000000


def test_tunables_overrides_equal_and_kernel_switches_ignored(tmp_path, monkeypatch):
    raw = jconfig.default_config_json()
    raw["tunables"] = {
        "grouping_x": 11, "frames_per_block": 8, "pipelined_ingest": True, "noise_state_path": "n",
        "use_pallas_psd": True, "use_pallas_select": True, "use_pallas_fir": True, "bogus_knob": 1,
    }
    path = tmp_path / "c.json"
    path.write_text(json.dumps(raw))
    warned = []
    monkeypatch.setattr(tconfig.logger, "warn", lambda label, msg, *args: warned.append(msg.format(*args)))
    got = dataclasses.asdict(tconfig.Config.load_from_file(str(path), scan_hardware=False).tunables)
    want = dataclasses.asdict(jconfig.Config.load_from_file(str(path), scan_hardware=False).tunables)
    assert want.pop("use_pallas_psd") is True and want.pop("use_pallas_select") is True
    assert got == want
    assert got["grouping_x"] == 11 and got["frames_per_block"] == 8 and got["grouping_y"] == 21
    assert warned == ["unknown tunables ignored: ['bogus_knob', 'use_pallas_fir', 'use_pallas_psd', "
                      "'use_pallas_select']"]


def test_transmission_codec_byte_equal():
    rng = np.random.default_rng(0)
    for n in (0, 1, 3, 1600):
        iq = rng.integers(-128, 128, size=(n, 2), dtype=np.int8)
        args = (1234567890123 + n, 145_250_000 + n, 16000, iq)
        payload = tdata.encode_transmission(*args)
        assert payload == jdata.encode_transmission(*args)
        t, start, stop, rate, back = tdata.decode_transmission(payload)
        assert (t, start, stop, rate) == (args[0], args[1] - 8000, args[1] + 8000, 16000)
        np.testing.assert_array_equal(back, iq)
    payload = tdata.encode_transmission(1, 145_250_000, 16000, np.array([[1, -2]], dtype=np.int8))
    assert payload[20] == (1 ^ 0x80) and payload[21] == ((-2) & 0xFF) ^ 0x80


def test_spectrogram_codec_byte_equal():
    bins = np.arange(-64, 64, dtype=np.int8)
    payload = tdata.encode_spectrogram(99, 145_000_000, 2048000, bins)
    assert payload == jdata.encode_spectrogram(99, 145_000_000, 2048000, bins)
    t, start, stop, step, back = tdata.decode_spectrogram(payload)
    assert (t, start, stop, step) == (99, 143_976_000, 146_024_000, 2048000 // 128)
    np.testing.assert_array_equal(back, bins)


def _codec_outputs(mod, data, z):
    return [
        mod.xor_offset_binary(data).tobytes(),
        mod.cs8_to_complex64(data[:1000]).tobytes(),
        mod.cu8_to_complex64(data.view(np.uint8)[:1000]).tobytes(),
        mod.complex64_to_cs8(z).tobytes(),
        mod.complex64_to_cs8(z, scale=31.5).tobytes(),
    ]


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_native_codecs_byte_equal(route, monkeypatch):
    """The port's codecs give the JAX package's bytes, through the C++
    library and through the numpy fallbacks alike."""
    if route == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    else:
        assert tnative.native_available() == jnative.native_available()
    rng = np.random.default_rng(0)
    data = rng.integers(-128, 128, size=1001, dtype=np.int8)
    z = (rng.standard_normal(500) + 1j * rng.standard_normal(500)).astype(np.complex64) * 0.7
    assert _codec_outputs(tnative, data, z) == _codec_outputs(jnative, data, z)
    np.testing.assert_array_equal(tnative.xor_offset_binary(data), data.view(np.uint8) ^ 0x80)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_ingest_ring_matches_reference(route, monkeypatch):
    """Wrap-around and overflow-drop accounting of the port's ring equal the
    JAX package's, read for read (test_native_ring.py's cases)."""
    if route == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    rings = [tnative.IngestRing(256), jnative.IngestRing(256)]
    assert rings[0].capacity == rings[1].capacity >= 256
    seq = np.arange(rings[0].capacity * 3, dtype=np.uint8)
    for pos in range(0, seq.size, 37):
        wrote = [r.write(seq[pos : pos + 37]) for r in rings]
        got = [r.read(29).tobytes() for r in rings]
        assert wrote[0] == wrote[1] and got[0] == got[1]
    for r in rings:
        r.write(np.zeros(rings[0].capacity * 2, dtype=np.uint8))
    assert rings[0].dropped_bytes == rings[1].dropped_bytes > 0
    assert rings[0].available == rings[1].available


def _spec(mod, path, fmt):
    return mod.DeviceSpec(True, "f", "replay", 250000, 8, 5, file=str(path), file_format=fmt)


@pytest.mark.parametrize("fmt", ["cf32", "cs8", "cu8"])
def test_replay_source_blocks_equal(tmp_path, fmt):
    rng = np.random.default_rng(1)
    iq = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(np.complex64) * 0.1
    path = tmp_path / f"x.{fmt}"
    pairs = iq.view(np.float32)
    if fmt == "cf32":
        pairs.tofile(path)
    elif fmt == "cs8":
        np.clip(np.round(pairs * 127.5), -128, 127).astype(np.int8).tofile(path)
    else:
        np.clip(np.round(pairs * 127.5 + 127.5), 0, 255).astype(np.uint8).tofile(path)
    for loop in (False, True):
        src = [tsources.ReplaySource(_spec(tconfig, path, fmt), loop=loop),
               jsources.ReplaySource(_spec(jconfig, path, fmt), loop=loop)]
        for n in (256, 300, 400, 256):
            got, want = (s.read_block(n) for s in src)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            got8, want8 = (s.read_block_int8(n) for s in src)
            assert (got8 is None) == (want8 is None)
            if got8 is not None:
                np.testing.assert_array_equal(got8, want8)
            assert src[0].stream_time_ms() == src[1].stream_time_ms()
            assert src[0].exhausted == src[1].exhausted
    if fmt == "cf32":
        np.testing.assert_array_equal(tsources.ReplaySource(_spec(tconfig, path, fmt)).read_block(256), iq[:256])


def _scene(path):
    rate = 256000
    rng = np.random.default_rng(9)
    n = int(rate * 8)
    t = np.arange(n) / rate
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f, t_on, t_off in ((30_000, 3.0, 6.0), (-60_000, 3.5, 5.5)):
        phase = 2 * np.pi * f * t + 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * 800 * t)) / rate
        iq += 0.4 * np.exp(1j * phase) * ((t >= t_on) & (t < t_off))
    iq.astype(np.complex64).view(np.float32).tofile(path)


@pytest.mark.parametrize("compact", [False, True], ids=["process", "process_compact"])
def test_tracker_notifications_identical(tmp_path, compact, monkeypatch):
    """Every per-frame tracker input of a JAX scan (two transmissions in one
    band) replayed through both trackers: identical notifications, tracked
    keys and overflow counts."""
    from rtl_sdr_scanner_tpu.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu.runtime.scanner import Scanner

    capture = tmp_path / "x.cf32"
    _scene(capture)
    raw = jconfig.default_config_json()
    raw["tunables"] = {"compact_detection": compact}
    raw["recording"] = {"max_noise_time_ms": 1000, "min_sample_rate": 16000, "min_time_ms": 1000, "step": 2500}
    raw["devices"] = [{
        "enabled": True, "serial": "r", "driver": "replay", "sample_rate": 256000,
        "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
        "ranges": [{"start": 144_900_000, "stop": 145_100_000}], "file": str(capture), "file_format": "cf32",
    }]
    cfg = jconfig.Config(raw)
    name = "process_compact" if compact else "process"
    calls = []
    real = getattr(jtracker.TransmissionTracker, name)

    def record(self, *args):
        calls.append(copy.deepcopy(args))
        return real(self, *args)

    monkeypatch.setattr(jtracker.TransmissionTracker, name, record)
    scanner = Scanner(cfg, cfg.devices[0], NullMqtt(), recorders_count=3)
    scanner.run_to_completion()
    assert len(calls) > 100
    scan_cfg, center = scanner.device.scan_cfg, 145_000_000
    kw = dict(
        fft_size=scan_cfg.fft_size, group_size=int(np.ceil(16000 / scan_cfg.step_hz)), start_level=8.0,
        stop_level=5.0, recording_min_time_ms=1000, recording_timeout_ms=1000, tuning_step=2500,
        index_to_shift=scan_cfg.index_to_shift, index_to_frequency=lambda i: scan_cfg.index_to_frequency(i, center),
        is_index_in_range=lambda i: abs(scan_cfg.index_to_shift(i)) <= 100_000,
    )
    want = jtracker.TransmissionTracker(**kw, ignored_ranges=[(145_020_000, 145_021_000)])
    got = ttracker.TransmissionTracker(**kw, ignored_ranges=[(145_020_000, 145_021_000)])
    monkeypatch.setattr(jtracker.TransmissionTracker, name, real)
    seen = set()
    for args in calls:
        w = getattr(want, name)(*args)
        assert getattr(got, name)(*args) == w
        assert sorted(got._signals) == sorted(want._signals)
        seen.update(shift for shift, _ in w)
        if compact:
            assert (got.current_keys(16) == want.current_keys(16)).all()
    assert got.candidate_overflow_count == want.candidate_overflow_count
    assert {27_500, 30_000, -60_000} & seen and len(seen) >= 2


def test_remote_controller_flow_equal():
    """test_runtime.py's remote-controller flows, through both packages:
    the same topics and payloads published, the same callbacks fired."""
    seen = {}
    for name, mqtt_mod, remote_mod, config_mod in (
        ("jax", jmqtt, jremote, jconfig), ("torch", tmqtt, tremote, tconfig)
    ):
        mqtt = mqtt_mod.NullMqtt()
        mqtt.keep_payloads = True
        events = []
        remote_mod.RemoteController(
            config_mod.Config(config_mod.default_config_json()),
            "abc",
            mqtt,
            lambda cfg: events.append(("config", cfg)),
            manual_recording_callback=lambda f, d: (events.append(("manual", f, d)), True)[1],
            restart_callback=lambda: events.append(("restart",)),
        )
        mqtt.inject("sdr/list", "")
        mqtt.inject("sdr/config/abc", json.dumps({"version": 2}))
        mqtt.inject("sdr/config/abc", "{not json")
        mqtt.inject("sdr/manual_recording", json.dumps({"frequency": 145_030_000, "duration_ms": 2500}))
        mqtt.inject("sdr/manual_recording", json.dumps({"frequency": 145_000_000}))
        mqtt.inject("sdr/manual_recording", "{not json")
        mqtt.inject("sdr/manual_recording", json.dumps({"duration_ms": 5}))
        mqtt.inject("sdr/restart/abc", "")
        seen[name] = (mqtt.published, [t for t, _ in mqtt._callbacks], events)
    assert seen["torch"] == seen["jax"]
    published, _, events = seen["torch"]
    topics = [t for t, _ in published]
    assert "sdr/status/abc" in topics and "sdr/config/abc/success" in topics and "sdr/config/abc/failed" in topics
    assert events == [("config", {"version": 2}), ("manual", 145_030_000, 2500), ("manual", 145_000_000, 10_000),
                      ("restart",)]


def test_make_mqtt_falls_back_without_env():
    class Cfg:
        mqtt_enabled = False
        mqtt_url = ""
        mqtt_username = ""
        mqtt_password = ""

    assert isinstance(tmqtt.make_mqtt(Cfg()), tmqtt.NullMqtt)
    for url in ("tcp://broker:1883", "ssl://broker:8883", "mqtts://broker", "broker", "broker:1234"):
        assert tmqtt._parse_url(url) == jmqtt._parse_url(url)


# -- live source on the fake SoapySDR (test_live_source.py's cases) ---------

RATE = 256000


def _live_spec(mod, driver="rtlsdr"):
    return mod.DeviceSpec(
        enabled=True, serial="fake0", driver=driver, sample_rate=RATE, start_level=8.0, stop_level=5.0,
        gains=[("LNA", 32.8), ("VGA", 20.0)], ranges=[(145_000_000 - 100000, 145_000_000 + 100000)],
    )


def _soapy(monkeypatch, **kw):
    fake = make_fake_soapy(**kw)
    monkeypatch.setitem(sys.modules, "SoapySDR", fake)
    return fake


def test_soapy_source_setup_and_quirks(monkeypatch):
    before = int(time.time() * 1000)
    fake = _soapy(monkeypatch, tune_failures=9)
    src = tsources.SoapySource(_live_spec(tconfig))
    dev = fake.devices[0]
    assert dev.agc is False and dev.gains_set == [("LNA", 32.8), ("VGA", 20.0)]
    assert dev.sample_rate_calls == [RATE] and dev.stream_active
    assert before <= src.session_epoch_ms <= int(time.time() * 1000)
    assert src.set_center_frequency(145_000_000) is True and dev.tune_attempts == 10
    src.reset_buffers()  # rtlsdr re-sets the rate
    assert dev.sample_rate_calls == [RATE, RATE] and dev.deactivate_calls == 0
    src.close()
    assert dev.stream_closed and not dev.stream_active

    fake = _soapy(monkeypatch, tune_failures=10)
    src = tsources.SoapySource(_live_spec(tconfig, driver="hackrf"))
    assert src.set_center_frequency(145_000_000) is False and fake.devices[0].tune_attempts == 10
    src.reset_buffers()  # every other driver bounces the stream
    assert fake.devices[0].deactivate_calls == 1 and fake.devices[0].activate_calls == 2


def test_soapy_streams_equal(monkeypatch):
    """Direct short reads and ring-fed reads (timeouts injected) give the
    synthesized stream sample for sample, as the JAX package's source does."""
    total = RATE // 4
    synth = fm_synth(30_000, 0.0, 1.0)
    expected = synth(0, total, RATE)
    for mod, cfg_mod in ((tsources, tconfig), (jsources, jconfig)):
        _soapy(monkeypatch, synth=synth, total_samples=total, short_read_max=777)
        src = mod.SoapySource(_live_spec(cfg_mod))
        np.testing.assert_array_equal(src.read_block(total), expected)
        src.close()
        _soapy(monkeypatch, synth=synth, total_samples=total, short_read_max=1001,
               inject_results={1: -1, 3: -1})
        src = mod.SoapySource(_live_spec(cfg_mod))
        src.start_streaming()
        np.testing.assert_array_equal(src.read_block(total), expected)
        src.stop_streaming()
        assert src.stream_time_ms() == int(total * 1000 // RATE)
        src.close()


def test_soapy_errors_and_overflow(monkeypatch):
    from rtl_sdr_scanner_tpu_torch.constants import Tunables

    _soapy(monkeypatch, synth=fm_synth(30_000, 0.0, 1.0), total_samples=RATE, short_read_max=4096,
           inject_results={2: -7})
    src = tsources.SoapySource(_live_spec(tconfig))
    src.start_streaming()
    with pytest.raises(RuntimeError, match="stream error"):
        src.read_block(RATE // 2)
    src.close()
    _soapy(monkeypatch, total_samples=RATE, inject_results={0: -2})
    src = tsources.SoapySource(_live_spec(tconfig))
    with pytest.raises(RuntimeError, match="readStream error"):
        src.read_block(1024)
    src.close()
    _soapy(monkeypatch, total_samples=RATE * 4)
    src = tsources.SoapySource(_live_spec(tconfig), tunables=Tunables(ingest_ring_seconds=0.05,
                                                                       ingest_overflow_fatal=True))
    src.start_streaming()
    with pytest.raises(RuntimeError, match="overflow"):
        for _ in range(1000):
            src.read_block(RATE // 10)
    assert src.dropped_bytes > 0
    src.close()


def test_device_probe_equal(monkeypatch):
    from rtl_sdr_scanner_tpu.runtime.device_reader import scan_soapy_devices as jscan
    from rtl_sdr_scanner_tpu_torch.runtime.device_reader import scan_soapy_devices as tscan

    for config in ({"devices": []}, {"devices": [{"serial": "abc", "sample_rate": 900000}]}):
        want, got = copy.deepcopy(config), copy.deepcopy(config)
        _soapy(monkeypatch, enumerate_results=[{"serial": "abc", "driver": "rtlsdr"}])
        jscan(want)
        _soapy(monkeypatch, enumerate_results=[{"serial": "abc", "driver": "rtlsdr"}])
        tscan(got)
        assert got == want
    assert got["devices"][0]["sample_rate"] == 1024000


# -- utilities --------------------------------------------------------------


def test_radio_utils_equal():
    for f in (0, 7, 999, 1000, 144_962_500, 2_400_000_000, -30_000, 12_345):
        assert tradio.format_frequency(abs(f)) == jradio.format_frequency(abs(f))
        for step in (1000, 2500, 12_500):
            assert tradio.get_tuned_frequency(f, step) == jradio.get_tuned_frequency(f, step)
    for rate in (100, 250_000, 1_024_000, 2_048_000, 2_400_000, 20_480_000):
        assert tradio.get_range_split_sample_rate(rate) == jradio.get_range_split_sample_rate(rate)
        assert tradio.get_fft(rate, 250) == jradio.get_fft(rate, 250)
        for bw in (16_000, 32_000):
            assert tradio.get_resamplers_factors(rate, bw, 125) == jradio.get_resamplers_factors(rate, bw, 125)
    ranges = [(144_000_000, 146_000_000), (430_000_000, 440_000_000), (1, 5)]
    assert tradio.split_ranges(ranges, 2_000_000) == jradio.split_ranges(ranges, 2_000_000)
    assert tradio.format_power(3.14159) == jradio.format_power(3.14159)
    now = datetime.datetime(2024, 1, 2, 3, 4, 5)
    assert tradio.get_raw_file_name("full", "fc", 145_000_000, 2_048_000, now=now) == jradio.get_raw_file_name(
        "full", "fc", 145_000_000, 2_048_000, now=now
    )


def test_collection_and_misc_utils_equal():
    rng = np.random.default_rng(3)
    data = rng.normal(size=200).astype(np.float32)
    for index in (0, 5, 100, 199):
        for group in (1, 4, 21):
            assert tcoll.get_max_index(data, index, group) == jcoll.get_max_index(data, index, group)
            assert tcoll.contains_with_margin([3, 50, 120], index, group) == jcoll.contains_with_margin(
                [3, 50, 120], index, group
            )
    for votes in ([1], [1, 2, 2, 3], [5, 1, 5, 1, 3], [4, 4, 2, 2, 9, 9]):
        assert tcoll.most_frequent_value(votes) == jcoll.most_frequent_value(votes)
        assert tcoll.get_nearest_element(votes, 3) == jcoll.get_nearest_element(votes, 3)
    assert [tutils.round_down(v, 8) for v in (0, 1, 8, 9)] == [jutils.round_down(v, 8) for v in (0, 1, 8, 9)]
    assert len(tutils.generate_random_hash()) == len(jutils.generate_random_hash())
