"""Runtime performance counter.

Reference: sources/performance_logger.cpp (frame counter logging average frame
time + fps every N frames at debug level).
"""

from __future__ import annotations

import time

from rtl_sdr_scanner_tpu_torch.constants import DEFAULT, Tunables
from rtl_sdr_scanner_tpu_torch.utils import logger


class PerformanceLogger:
    """Counts frames; every `interval` kicks logs avg frame time + fps
    (reference performance_logger.cpp:7-22)."""

    def __init__(self, label: str, tunables: Tunables = DEFAULT):
        self._label = label
        self._interval = tunables.performance_logger_interval
        self._count = 0
        self._last = time.monotonic()

    def kick(self) -> None:
        self._count += 1
        if self._count % self._interval == 0:
            now = time.monotonic()
            elapsed = now - self._last
            frame_ms = 1000.0 * elapsed / self._interval
            fps = self._interval / elapsed if elapsed > 0 else float("inf")
            logger.debug(self._label, "avg frame time: {:.3f} ms, fps: {:.1f}", frame_ms, fps)
            self._last = now

