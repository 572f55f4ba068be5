"""Application entry point and lifecycle (port of the JAX package's
``runtime/main.py``).

Reference: sources/main.cpp -- SIGINT/SIGTERM handler, outer reload loop:
load config -> Mqtt + RemoteController -> one Scanner per enabled device with
non-empty ranges -> poll until stop/reload (triggered by a remote config
update, which persists the new config and rebuilds the world).

Usage: python -m rtl_sdr_scanner_tpu_torch.runtime.main /path/to/config.json

Every scanner runs on the card (CUDA); ``run(..., device="cpu")`` runs the
plain PyTorch versions instead. A device with ``channels >= 2`` runs a
``WidebandScanner``. ``mesh_time`` and ``mesh_bands`` spread a device over
the visible cards (on the CPU, over copies of the CPU device). A config
that needs a path the port does not have yet (``multihost``: slice 9), or a
geometry a kernel on the card does not take, is refused with one error and
exit code 1 before any scanner starts.
"""

from __future__ import annotations

import signal
import sys
import time
from typing import List

from rtl_sdr_scanner_tpu_torch.device import DeviceLike, resolve_device
from rtl_sdr_scanner_tpu_torch.runtime.config import Config
from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import make_mqtt
from rtl_sdr_scanner_tpu_torch.runtime.remote_controller import RemoteController
from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner
from rtl_sdr_scanner_tpu_torch.runtime.sdr_device import unported_path
from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner
from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.utils import generate_random_hash

LABEL = "main"

_is_running = True


def _handler(signum, frame):
    global _is_running
    logger.warn(LABEL, "received stop signal")
    _is_running = False


def _refusal(config: Config, device):
    """The first unported path (or kernel geometry) an enabled device or the
    tunables need on ``device``."""
    for spec in config.devices:
        if spec.enabled and spec.ranges:
            reason = unported_path(config, spec, device)
            if reason is not None:
                return reason
    return unported_path(config)


def run(config_file: str, device: DeviceLike = None) -> int:
    global _is_running
    device = resolve_device(device)  # a missing card raises before anything starts
    try:
        signal.signal(signal.SIGINT, _handler)
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        # not the main thread (embedded/test use): the embedder owns signals
        # and stops via main._is_running
        pass

    logger.configure()
    logger.info(LABEL, "starting")
    instance_id = generate_random_hash()

    rc = 0
    while _is_running:
        reload_requested = [False]
        config = Config.load_from_file(config_file)
        logger.configure(
            config.console_log_level,
            config.file_log_level,
            config.tunables.log_file_name,
            config.tunables.log_file_size,
            config.tunables.log_files_count,
            config.color_log_enabled,
        )
        reason = _refusal(config, device)
        if reason is not None:
            logger.error(LABEL, "{}", reason)
            return 1

        mqtt = make_mqtt(config)

        def config_callback(new_json):
            logger.info(LABEL, "reload config")
            Config.save_to_file(config_file, new_json)
            reload_requested[0] = True

        scanners: List[Scanner] = []

        def restart_callback():
            logger.info(LABEL, "restart requested")
            reload_requested[0] = True

        def manual_recording_callback(frequency: int, duration_ms: int) -> bool:
            return any(s.manual_record(frequency, duration_ms) for s in scanners)

        remote = RemoteController(
            config,
            instance_id,
            mqtt,
            config_callback,
            manual_recording_callback=manual_recording_callback,
            restart_callback=restart_callback,
        )
        for spec in config.devices:
            try:
                if not spec.enabled:
                    logger.info(LABEL, "device disabled, skipping: {}", spec.name)
                elif not spec.ranges:
                    logger.info(LABEL, "empty ranges to scan, skipping: {}", spec.name)
                elif spec.channels >= 2:
                    scanner = WidebandScanner(config, spec, mqtt, config.recorders_count(), device=device)
                    scanner.start()
                    scanners.append(scanner)
                else:
                    scanner = Scanner(config, spec, mqtt, config.recorders_count(), device=device)
                    scanner.start()
                    scanners.append(scanner)
            except Exception as exc:
                logger.error(LABEL, "can not open device: {}, exception: {}", spec.name, exc)

        if not scanners:
            logger.warn(LABEL, "empty devices list")

        logger.info(LABEL, "started")
        while _is_running and not reload_requested[0]:
            if any(getattr(s, "failed", False) for s in scanners):
                # a scanner thread died on a fatal source/pipeline error.
                # The reference exit(1)s on a stream error and lets the
                # container supervisor restart it (sdr_source.cpp:38-41);
                # polling forever with a dead scanner would scan nothing.
                # rc = 1 so a container supervisor keyed on the exit code
                # actually restarts us.
                logger.error(LABEL, "scanner failed fatally; stopping")
                rc = 1
                _is_running = False
                break
            time.sleep(0.1)

        for scanner in scanners:
            scanner.stop()
        mqtt.stop()

    logger.info(LABEL, "stopped")
    return rc


def main() -> int:
    if len(sys.argv) < 2:
        logger.configure()
        logger.error(LABEL, "no config file argument provided")
        return 1
    return run(sys.argv[1])


if __name__ == "__main__":
    sys.exit(main())
