"""Config schema versioning + canonical ordering.

Reference: sources/config_migrator.cpp -- versions below 2 are migrated
forward; ignored_frequencies and per-device ranges get a canonical sort so
save-back diffs stay stable.
"""

from __future__ import annotations

from typing import Any, Dict

from rtl_sdr_scanner_tpu_torch.utils import logger

LABEL = "config"
CURRENT_VERSION = 2


def migrate(config: Dict[str, Any]) -> None:
    """config_migrator.cpp:8-13 update()."""
    version = int(config.get("version", 0))
    logger.info(LABEL, "version: {}", version)
    if version < 2:
        _apply_version_2(config)


def _apply_version_2(config: Dict[str, Any]) -> None:
    """Version 2 is a no-op migration in the reference
    (config_migrator.cpp:39); it only stamps the version."""
    config["version"] = CURRENT_VERSION


def sort_config(config: Dict[str, Any]) -> None:
    """config_migrator.cpp:15-32 sort()."""
    if "ignored_frequencies" in config:
        config["ignored_frequencies"].sort(
            key=lambda r: (int(r["frequency"]), int(r["bandwidth"]))
        )
    for device in config.get("devices", []):
        if "ranges" in device:
            device["ranges"].sort(key=lambda r: int(r["start"]))
