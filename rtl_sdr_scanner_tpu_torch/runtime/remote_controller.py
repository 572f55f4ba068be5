"""MQTT control plane.

Reference: sources/network/remote_controller.cpp -- subscribes:
  sdr/list               -> publish full config on sdr/status/{id}
  sdr/config/{id}        -> persist new config, ack success/failed, reload
  sdr/manual_recording   -> IMPLEMENTED here (stub in the reference,
                            remote_controller.cpp:45). JSON payload:
                            {"frequency": Hz, "duration_ms": N} -- queues a
                            forced recording on the scanner whose configured
                            ranges cover the frequency.
  sdr/restart/{id}       -> IMPLEMENTED here (stub in the reference,
                            remote_controller.cpp:46): rebuilds the world
                            (same teardown path as a config update, without
                            persisting a new config).
"""

from __future__ import annotations

import json
from typing import Callable, Optional

from rtl_sdr_scanner_tpu_torch.utils import logger

LABEL = "remote"


class RemoteController:
    def __init__(
        self,
        config,
        instance_id: str,
        mqtt,
        config_callback: Callable,
        manual_recording_callback: Optional[Callable] = None,
        restart_callback: Optional[Callable] = None,
    ):
        self._config = config
        self._id = instance_id
        self._mqtt = mqtt
        self._config_callback = config_callback
        self._manual_recording_callback = manual_recording_callback
        self._restart_callback = restart_callback
        mqtt.set_message_callback("sdr/list", self._list_callback)
        mqtt.set_message_callback(f"sdr/config/{self._id}", self._config_cb)
        mqtt.set_message_callback("sdr/manual_recording", self._manual_recording_cb)
        mqtt.set_message_callback(f"sdr/restart/{self._id}", self._restart_cb)
        logger.info(LABEL, "started, id: {}", self._id)

    def _list_callback(self, _data: str) -> None:
        logger.info(LABEL, "received list")
        self._mqtt.publish(f"sdr/status/{self._id}", json.dumps(self._config.json), 2)

    def _config_cb(self, data: str) -> None:
        logger.info(LABEL, "received config")
        try:
            parsed = json.loads(data)
            self._config_callback(parsed)
            self._mqtt.publish(f"sdr/config/{self._id}/success", "", 2)
        except (ValueError, OSError):
            logger.warn(LABEL, "invalid config")
            self._mqtt.publish(f"sdr/config/{self._id}/failed", "", 2)

    def _manual_recording_cb(self, data: str) -> None:
        logger.info(LABEL, "received manual recording")
        if self._manual_recording_callback is None:
            return
        try:
            parsed = json.loads(data)
            frequency = int(parsed["frequency"])
            duration_ms = int(parsed.get("duration_ms", 10_000))
        except (ValueError, KeyError, TypeError):
            logger.warn(LABEL, "invalid manual recording request")
            return
        if not self._manual_recording_callback(frequency, duration_ms):
            logger.warn(LABEL, "no scanner covers the requested frequency")

    def _restart_cb(self, _data: str) -> None:
        logger.info(LABEL, "received restart")
        if self._restart_callback is not None:
            self._restart_callback()
