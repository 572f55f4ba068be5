"""Label-prefixed logger with console + rotating-file sinks.

Reference: sources/logger.h / logger.cpp (spdlog wrapper with [label]
prefixes, ANSI colors, rotating file 10 MB x 9, periodic flush). Python's
logging module supplies the sinks; this module supplies the reference's
surface: configure(), per-label helpers, colored().
"""

from __future__ import annotations

import logging
import logging.handlers
import sys
from typing import Optional

# ANSI color helpers (reference logger.h:86-98)
NC = "\033[0m"
RED = "\033[0;31m"
GREEN = "\033[0;32m"
YELLOW = "\033[0;33m"
BROWN = "\033[0;33m"
CYAN = "\033[0;36m"
MAGENTA = "\033[0;35m"

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "err": logging.ERROR,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

logging.addLevelName(_LEVELS["trace"], "TRACE")

_color_enabled = True
_root = logging.getLogger("sdr")
_root.setLevel(1)
_root.propagate = False


def parse_log_level(level: str) -> int:
    """Map config strings to levels (reference config.cpp parseLogLevel)."""
    return _LEVELS.get(level, _LEVELS["off"])


def is_color_log_enabled() -> bool:
    return _color_enabled


def colored(color: str, text: str) -> str:
    """Wrap text in ANSI color when enabled (reference logger.h colored())."""
    if not _color_enabled:
        return text
    return f"{color}{text}{NC}"


def configure(
    console_level: int = logging.INFO,
    file_level: int = logging.INFO,
    file_name: Optional[str] = None,
    file_size: int = 10 * 1024 * 1024,
    files_count: int = 9,
    color: bool = True,
) -> None:
    """(Re)configure sinks; mirrors Logger::configure (logger.cpp:8-32)."""
    global _color_enabled
    _color_enabled = color
    for handler in list(_root.handlers):
        _root.removeHandler(handler)

    fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    console = logging.StreamHandler(sys.stdout)
    console.setLevel(console_level)
    console.setFormatter(fmt)
    _root.addHandler(console)

    if file_name:
        rotating = logging.handlers.RotatingFileHandler(
            file_name, maxBytes=file_size, backupCount=files_count
        )
        rotating.setLevel(file_level)
        rotating.setFormatter(fmt)
        _root.addHandler(rotating)


def _log(level: int, label: str, msg: str, *args) -> None:
    if args:
        msg = msg.format(*args)
    _root.log(level, f"[{label}] {msg}")


def trace(label: str, msg: str, *args) -> None:
    _log(_LEVELS["trace"], label, msg, *args)


def debug(label: str, msg: str, *args) -> None:
    _log(logging.DEBUG, label, msg, *args)


def info(label: str, msg: str, *args) -> None:
    _log(logging.INFO, label, msg, *args)


def warn(label: str, msg: str, *args) -> None:
    _log(logging.WARNING, label, msg, *args)


def error(label: str, msg: str, *args) -> None:
    _log(logging.ERROR, label, msg, *args)
