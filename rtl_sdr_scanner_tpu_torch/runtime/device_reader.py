"""Device discovery and config enrichment.

Reference: sources/radio/sdr_device_reader.cpp -- enumerate SoapySDR hardware,
merge found devices into the config JSON by serial (update sample rate to the
nearest supported, or create a new entry with max gains, default levels 8/5,
and a seed range at the best supported rate).

SoapySDR python bindings are optional in this environment; without them the
probe is a no-op (replay devices need no hardware), matching the reference's
"scan device exception" tolerance (sdr_device_reader.cpp:123-126).
"""

from __future__ import annotations

from typing import Any, Dict, List

from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.collection_utils import get_nearest_element

LABEL = "config"

DEFAULT_RECORDING_START_LEVEL = 8
DEFAULT_RECORDING_STOP_LEVEL = 5

# (start, stop, sample_rate) seed preferences (sdr_device_reader.cpp:89-95)
_SEED_RANGES = [
    (140000000, 160000000, 20480000),
    (140000000, 160000000, 20000000),
    (144000000, 146000000, 2048000),
    (144000000, 146000000, 2000000),
    (144000000, 146000000, 1024000),
    (144000000, 146000000, 1000000),
]


def _soapy():
    try:
        import SoapySDR  # type: ignore

        return SoapySDR
    except ImportError:
        return None


def scan_soapy_devices(config: Dict[str, Any]) -> None:
    """sdr_device_reader.cpp:102-128 scanSoapyDevices."""
    config.setdefault("devices", [])
    for device in config["devices"]:
        device.setdefault("driver", device.get("driver", ""))
        device["sample_rates"] = device.get("sample_rates", [])
        # replay devices are software-defined; leave them untouched
        if device.get("file"):
            device["driver"] = device.get("driver") or "replay"

    soapy = _soapy()
    if soapy is None:
        logger.info(LABEL, "SoapySDR not available, skipping hardware scan")
        return

    try:
        results = soapy.Device.enumerate("remote=")
    except Exception as exc:  # pragma: no cover - hardware path
        logger.warn(LABEL, "scan devices exception: {}", exc)
        return
    logger.info(LABEL, "found {} devices", len(results))
    for args in results:  # pragma: no cover - hardware path
        try:
            serial = args["serial"]
            existing = next(
                (d for d in config["devices"] if d.get("serial") == serial), None
            )
            if existing is not None:
                _update_soapy_device(existing, args, soapy)
            else:
                created: Dict[str, Any] = {}
                _create_soapy_device(created, args, soapy)
                config["devices"].append(created)
        except Exception as exc:
            logger.warn(LABEL, "scan device exception: {}", exc)


def _update_soapy_device(json_dev, args, soapy):  # pragma: no cover - hardware path
    """sdr_device_reader.cpp:37-57: refresh driver + snap sample_rate."""
    sdr = soapy.Device(args)
    try:
        json_dev["driver"] = args["driver"]
        rates = sorted({int(r) for r in sdr.listSampleRates(soapy.SOAPY_SDR_RX, 0)})
        json_dev["sample_rates"] = rates
        if int(json_dev["sample_rate"]) not in rates:
            json_dev["sample_rate"] = get_nearest_element(rates, int(json_dev["sample_rate"]))
    finally:
        del sdr


def _create_soapy_device(json_dev, args, soapy):  # pragma: no cover - hardware path
    """sdr_device_reader.cpp:59-99: new entry with defaults + seed range."""
    sdr = soapy.Device(args)
    try:
        json_dev["driver"] = args["driver"]
        json_dev["serial"] = args["serial"]
        json_dev["enabled"] = True
        json_dev["start_recording_level"] = DEFAULT_RECORDING_START_LEVEL
        json_dev["stop_recording_level"] = DEFAULT_RECORDING_STOP_LEVEL
        rates = sorted({int(r) for r in sdr.listSampleRates(soapy.SOAPY_SDR_RX, 0)})
        json_dev["sample_rates"] = rates
        json_dev["ranges"] = []
        for start, stop, rate in _SEED_RANGES:
            if not json_dev["ranges"] and rate in rates:
                json_dev["ranges"] = [{"start": start, "stop": stop}]
                json_dev["sample_rate"] = rate
        if not json_dev["ranges"] and rates:
            json_dev["ranges"] = [{"start": 144000000, "stop": 146000000}]
            json_dev["sample_rate"] = rates[-1]
        gains = []
        for gain in sdr.listGains(soapy.SOAPY_SDR_RX, 0):
            rng = sdr.getGainRange(soapy.SOAPY_SDR_RX, 0, gain)
            gains.append({"name": gain, "value": rng.maximum()})
        json_dev["gains"] = gains
    finally:
        del sdr


def clear_devices(config: Dict[str, Any]) -> None:
    """Strip probe-derived fields before save-back
    (sdr_device_reader.cpp:163-168)."""
    for device in config.get("devices", []):
        device.pop("driver", None)
        device.pop("sample_rates", None)
