"""Narrow bands against the JAX package: the geometries whose fft is below
256 (a band of 32 kHz or less at 250 Hz bins), where the card runs the
selection kernel's register form and the int8 PSD kernel's small-frame
form. The JAX ``Scanner`` and the port's ``Scanner(..., device="cpu")`` on
the same cs8 replays of a single 32 kHz (fft 128) and 16 kHz (fft 64) band,
compact and full-row, and the JAX ``WidebandScanner`` against the port's on
a 2.048 Msps capture split into 64 channels of 32 kHz (fft 128), in the
split form; payloads compared by ``chip_smoke.compare_payloads`` (the same
topics in the same order, equal headers, IQ within 1 LSB, spectrogram bins
within 1). Each scene keys a band-wide FM signal after the 2 s of noise
learning (the verify skill's two pitfalls).
"""

import json

import pytest
import torch

from chip_smoke import compare_payloads, recorded_tone, write_capture
from rtl_sdr_scanner_tpu.runtime import config as jconfig
from rtl_sdr_scanner_tpu.runtime import mqtt_client as jmqtt
from rtl_sdr_scanner_tpu.runtime import scanner as jscanner
from rtl_sdr_scanner_tpu.runtime import wideband as jwideband
from rtl_sdr_scanner_tpu_torch.runtime import config as tconfig
from rtl_sdr_scanner_tpu_torch.runtime import mqtt_client as tmqtt
from rtl_sdr_scanner_tpu_torch.runtime import scanner as tscanner
from rtl_sdr_scanner_tpu_torch.runtime import wideband as twideband

torch.set_num_threads(2)
CENTER = 145_000_000
REC_RATE = 16_000
WIDE_RATE = 2_048_000
WIDE_CHANNELS = 64  # 32 kHz channels
# channel b is centred b * 32 kHz from the centre (mod 64): channels 3 and 57
WIDE_SIGNALS = ((100_000, 800.0), (-230_000, 1300.0))


def _raw(capture, rate, channels=0, tunables=None, workers=2, rec_rate=REC_RATE):
    raw = jconfig.default_config_json()
    raw["tunables"] = dict(tunables or {})
    raw["recording"] = {"max_noise_time_ms": 1000, "min_sample_rate": rec_rate, "min_time_ms": 500, "step": 2500}
    raw["devices"] = [{
        "enabled": True, "serial": "narrow0", "driver": "replay", "sample_rate": rate,
        "start_recording_level": 8, "stop_recording_level": 5, "gains": [],
        "ranges": [{"start": CENTER - rate // 2, "stop": CENTER + rate // 2}],
        "file": str(capture), "file_format": "cs8", "channels": channels,
    }]
    raw["workers"] = workers
    return raw


def _scan(pkg, raw):
    """One replay through one package's Scanner (WidebandScanner for a
    channelized device): (payloads, scanner)."""
    config_mod, mqtt_mod = (jconfig, jmqtt) if pkg == "jax" else (tconfig, tmqtt)
    cfg = config_mod.Config(json.loads(json.dumps(raw)))
    mqtt = mqtt_mod.NullMqtt()
    mqtt.keep_payloads = True
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if cfg.devices[0].channels >= 2:
        cls = (jwideband if pkg == "jax" else twideband).WidebandScanner
    else:
        cls = (jscanner if pkg == "jax" else tscanner).Scanner
    scanner = cls(cfg, cfg.devices[0], mqtt, recorders_count=cfg.recorders_count(), **kw)
    scanner.run_to_completion()
    scanner.stop()
    return mqtt.published, scanner


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("rate,fft", [(32_000, 128), (16_000, 64)])
def test_single_narrow_band_matches_jax(tmp_path, rate, fft, compact):
    """A single cs8 band of 32 or 16 kHz: FM keyed 2.5-4.5 s at +3 kHz,
    recorded at half the band's rate (the JAX package's DDC needs at least
    one decimating stage: a chain of none fails its carry)."""
    capture = tmp_path / "narrow.cs8"
    write_capture(capture, rate, 5.5, 3_000, (2.5, 4.5), seed=rate // 1000)
    rec_rate = rate // 2
    raw = _raw(capture, rate, tunables={"compact_detection": compact}, rec_rate=rec_rate)
    want, _ = _scan("jax", raw)
    got, scanner = _scan("torch", raw)
    stats = compare_payloads(want, got)
    session = scanner.device
    assert session.scan_cfg.fft_size == fft and session._compact == compact
    assert stats["transmissions"] > 0, stats
    _, n, tone = recorded_tone(got, CENTER + 3_000, rec_rate)
    assert n > rec_rate and abs(tone - 800) < 50, (n, tone)


def test_64_channels_of_32_khz_match_jax(tmp_path):
    """A 2.048 Msps capture into 64 channels of 32 kHz (fft 128), the split
    form (``mesh_bands`` 1): both transmissions recorded at their tones."""
    capture = tmp_path / "wide.cs8"
    write_capture(capture, WIDE_RATE, 4.5, WIDE_SIGNALS, (2.5, 4.0), seed=11)
    raw = _raw(capture, WIDE_RATE, channels=WIDE_CHANNELS, tunables={"mesh_bands": 1}, workers=4)
    want, _ = _scan("jax", raw)
    got, scanner = _scan("torch", raw)
    stats = compare_payloads(want, got)
    assert scanner._mesh is not None and scanner._mesh.shape["bands"] == 1 and not scanner._fused
    assert scanner.sessions[0].scan_cfg.fft_size == 128
    assert stats["transmissions"] > 0, stats
    for shift, tone in WIDE_SIGNALS:
        _, n, got_tone = recorded_tone(got, CENTER + shift, REC_RATE)
        assert n > REC_RATE // 2 and abs(got_tone - tone) < 50, (shift, n, got_tone)
