"""Debug raw-dump sinks.

Reference: sources/radio/blocks/file_sink.h -- optional taps writing raw IQ /
power rows to disk for offline analysis with scripts/converter.py, gated by
the DEBUG_SAVE_* constants (config.h:11-13, wired sdr_device.cpp:173-181 and
recorder.cpp:42-45). File naming via utils/radio_utils.get_raw_file_name so
converter.py can parse frequency/sample-rate from the name.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import get_raw_file_name

LABEL = "file_sink"


class FileSink:
    """Start/stop-gated appender of raw numpy buffers to a file."""

    def __init__(self, label: str, extension: str):
        self._label = label
        self._extension = extension
        self._file = None
        self._path: Optional[str] = None

    @property
    def recording(self) -> bool:
        return self._file is not None

    def start(self, frequency: int, sample_rate: int) -> None:
        self.stop()
        self._path = get_raw_file_name(self._label, self._extension, frequency, sample_rate)
        self._file = open(self._path, "wb")
        logger.info(LABEL, "start recording: {}", self._path)

    def write(self, data: np.ndarray) -> None:
        if self._file is not None:
            self._file.write(np.ascontiguousarray(data).tobytes())

    def stop(self) -> None:
        if self._file is not None:
            self._file.close()
            logger.info(LABEL, "stop recording: {}", self._path)
            self._file = None
