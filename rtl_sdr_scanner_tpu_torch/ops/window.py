"""Window functions (numpy; the planners' arrays equal the JAX package's)."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=32)
def hamming(n: int) -> np.ndarray:
    """Symmetric Hamming window 0.54 - 0.46 cos(2 pi k / (n-1)) as f32
    (GNU Radio window::hamming == numpy.hamming)."""
    if n == 1:
        return np.ones(1, dtype=np.float32)
    k = np.arange(n, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=32)
def kaiser(n: int, beta: float) -> np.ndarray:
    """Kaiser window (GNU Radio window::kaiser == numpy.kaiser), f64."""
    return np.kaiser(n, beta).astype(np.float64)
