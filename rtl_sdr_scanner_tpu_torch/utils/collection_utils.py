"""Host-side collection helpers.

Behavioral parity targets: reference sources/utils/collection_utils.h:8-67
(windowed argmax, margin membership, mode with median-of-ties, nearest element).
Golden-tested against the expectations of tests/test_collection_utils.cpp.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np


def get_max_index(data: np.ndarray, index: int, group_size: int) -> int:
    """First argmax of data within [index - g//2, index + g//2] clamped to bounds.

    Reference collection_utils.h:8-14 (std::max_element returns the FIRST max).
    """
    size = len(data)
    lo = max(0, index - group_size // 2)
    hi = min(size, index + group_size // 2 + 1)
    window = np.asarray(data[lo:hi])
    return lo + int(np.argmax(window))


def contains_with_margin(keys: Iterable[int], index: int, margin: int) -> Optional[int]:
    """Smallest key within +/- ceil(margin/2) of index, or None.

    Reference collection_utils.h:16-27: submargin = margin/2, rounded UP for
    odd margins; returns the lower_bound key if it lies within the window.
    """
    submargin = margin // 2 if margin % 2 == 0 else margin // 2 + 1
    left = index - submargin
    right = index + submargin
    best = None
    for k in keys:
        if left <= k <= right and (best is None or k < best):
            best = k
    return best


def most_frequent_value(data: Sequence[int]) -> int:
    """Mode; on ties, the median of the tied values.

    Reference collection_utils.h:29-50: collect all values sharing the max
    count, sort ascending, return element at position len//2.
    """
    counts = Counter(data)
    max_count = max(counts.values())
    tied = sorted(v for v, c in counts.items() if c == max_count)
    return tied[len(tied) // 2]


def get_nearest_element(data: Iterable[int], value: int) -> int:
    """Nearest element of a sorted-able collection; ties resolve upward.

    Reference collection_utils.h:52-67: if next - value <= value - prev,
    prefer the next (greater-or-equal) element.
    """
    items = sorted(data)
    for i, item in enumerate(items):
        if item >= value:
            if i == 0:
                return item
            prev = items[i - 1]
            if item - value <= value - prev:
                return item
            return prev
    return items[-1]
