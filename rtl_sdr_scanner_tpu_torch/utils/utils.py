"""General host helpers (reference sources/utils/utils.cpp): the ones the
port's runtime uses."""

from __future__ import annotations

import uuid


def generate_random_hash() -> str:
    """Random instance id: uuid4 hex without dashes (reference utils.cpp:24-29)."""
    return uuid.uuid4().hex


def round_down(value: int, factor: int) -> int:
    """Round down to a multiple of factor (reference utils.cpp:63)."""
    return value // factor * factor
