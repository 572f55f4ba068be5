"""JSON configuration (host side).

Reference: sources/config.cpp / config.h. Same schema as the reference
(config.example.json), same env-var secrets (MQTT_URL/USER/PASSWORD,
config.cpp:84-86), same save-back with probe-derived device fields stripped
(config.cpp:110-123). Divergences, both deliberate:
- missing MQTT env vars disable MQTT instead of aborting (the replay/offline
  path should not require a broker);
- the reference's compile-time constexpr tier (config.h:10-38) is runtime
  config here: an optional "tunables" section overrides constants.Tunables.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from rtl_sdr_scanner_tpu_torch.constants import DEFAULT, Tunables
from rtl_sdr_scanner_tpu_torch.runtime.config_migrator import migrate, sort_config
from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.logger import parse_log_level

LABEL = "config"

FrequencyRange = Tuple[int, int]


@dataclasses.dataclass
class DeviceSpec:
    """Reference Device POD (radio/help_structures.h:20-30) + replay extras."""

    enabled: bool
    serial: str
    driver: str
    sample_rate: int
    start_level: float
    stop_level: float
    gains: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    ranges: List[FrequencyRange] = dataclasses.field(default_factory=list)
    # addition over the reference: replayed-IQ file backend (SURVEY.md section 4)
    file: Optional[str] = None
    file_format: str = "cf32"  # cf32 | cs8 | cu8
    # addition over the reference: split this device's band into N sub-bands via
    # the polyphase channelizer and scan them CONCURRENTLY (runtime/wideband.py)
    channels: int = 0

    @property
    def name(self) -> str:
        return f"{self.driver}_{self.serial}"


def _read_device(raw: Dict[str, Any]) -> DeviceSpec:
    """sdr_device_reader.cpp:130-147 readDevice."""
    return DeviceSpec(
        enabled=bool(raw["enabled"]),
        serial=str(raw["serial"]),
        driver=str(raw.get("driver", "")),
        sample_rate=int(raw["sample_rate"]),
        start_level=float(raw["start_recording_level"]),
        stop_level=float(raw["stop_recording_level"]),
        gains=[(g["name"], float(g["value"])) for g in raw.get("gains", [])],
        ranges=[(int(r["start"]), int(r["stop"])) for r in raw.get("ranges", [])],
        file=raw.get("file"),
        file_format=raw.get("file_format", "cf32"),
        channels=int(raw.get("channels", 0)),
    )


class Config:
    """Parsed configuration with typed getters (reference config.h:40-63)."""

    def __init__(self, raw: Dict[str, Any], tunables: Optional[Tunables] = None):
        self._raw = raw
        self.tunables = tunables or _read_tunables(raw)

        self.devices: List[DeviceSpec] = []
        for dev in raw.get("devices", []):
            try:
                self.devices.append(_read_device(dev))
            except (KeyError, TypeError, ValueError) as exc:
                logger.warn(LABEL, "read device exception: {}", exc)

        out = raw["output"]
        self.color_log_enabled = bool(out["color_log_enabled"])
        self.console_log_level = parse_log_level(out["console_log_level"])
        self.file_log_level = parse_log_level(out["file_log_level"])

        self.ignored_ranges: List[FrequencyRange] = [
            (
                int(item["frequency"]) - int(item["bandwidth"]) // 2,
                int(item["frequency"]) + int(item["bandwidth"]) // 2,
            )
            for item in raw.get("ignored_frequencies", [])
        ]

        rec = raw["recording"]
        self.recording_bandwidth = int(rec["min_sample_rate"])
        self.recording_min_time_ms = int(rec["min_time_ms"])
        self.recording_timeout_ms = int(rec["max_noise_time_ms"])
        self.recording_tuning_step = int(rec["step"])
        self._workers = int(raw.get("workers", 0))

        # env-var secrets (config.cpp:84-86); absence disables MQTT
        self.mqtt_url = os.environ.get("MQTT_URL", "")
        self.mqtt_username = os.environ.get("MQTT_USER", "")
        self.mqtt_password = os.environ.get("MQTT_PASSWORD", "")
        # private-CA TLS brokers: path to a CA bundle (PEM). The reference
        # pins the system store path (mqtt.cpp:81-83 ca_path /etc/ssl/certs);
        # empty = system store. Env tier like the other MQTT settings, with a
        # JSON "mqtt": {"ca_file": ...} override for file-managed deployments.
        self.mqtt_ca_file = os.environ.get(
            "MQTT_CA_FILE", str(raw.get("mqtt", {}).get("ca_file", ""))
        )

    @property
    def json(self) -> Dict[str, Any]:
        return self._raw

    @property
    def mqtt_enabled(self) -> bool:
        return bool(self.mqtt_url)

    def recorders_count(self) -> int:
        """Clamp workers to hw_concurrency/2; 0 means max (config.cpp:135-139).

        The device recorder bank is a batch dimension, not threads, but the knob
        keeps its meaning: max concurrent recordings.
        """
        max_workers = max(1, (os.cpu_count() or 2) // 2)
        workers = max(0, min(self._workers, max_workers))
        return max_workers if workers == 0 else workers

    @classmethod
    def load_from_file(cls, path: str, scan_hardware: bool = True) -> "Config":
        """config.cpp:88-108: parse, migrate, hardware-probe enrich, sort."""
        with open(path, "r") as f:
            raw = json.load(f)
        migrate(raw)
        if scan_hardware:
            from rtl_sdr_scanner_tpu_torch.runtime.device_reader import scan_soapy_devices

            scan_soapy_devices(raw)
        sort_config(raw)
        return cls(raw)

    @staticmethod
    def save_to_file(path: str, raw: Dict[str, Any]) -> None:
        """config.cpp:110-123: persist with probe-derived fields stripped."""
        from rtl_sdr_scanner_tpu_torch.runtime.device_reader import clear_devices

        tmp = json.loads(json.dumps(raw))
        clear_devices(tmp)
        try:
            with open(path, "w") as f:
                f.write(json.dumps(tmp, indent=4, sort_keys=True))
        except OSError:
            logger.warn(LABEL, "save new config failed")


def _read_tunables(raw: Dict[str, Any]) -> Tunables:
    """Optional "tunables" section overriding the reference constexpr tier."""
    overrides = raw.get("tunables", {})
    valid = {f.name for f in dataclasses.fields(Tunables)}
    unknown = set(overrides) - valid
    if unknown:
        logger.warn(LABEL, "unknown tunables ignored: {}", sorted(unknown))
    return dataclasses.replace(
        DEFAULT, **{k: v for k, v in overrides.items() if k in valid}
    )


def default_config_json() -> Dict[str, Any]:
    """Seed config matching the reference config.example.json."""
    return {
        "devices": [],
        "ignored_frequencies": [],
        "output": {
            "color_log_enabled": True,
            "console_log_level": "info",
            "file_log_level": "debug",
        },
        "recording": {
            "max_noise_time_ms": 2000,
            "min_sample_rate": 32000,
            "min_time_ms": 2000,
            "step": 2500,
        },
        "version": 2,
        "workers": 0,
    }
