"""Radio math helpers (host side): FFT sizing and resampler factorization,
copied from the JAX package's ``utils/radio_utils.py`` (reference
radio_utils.cpp)."""

from __future__ import annotations

import math
from typing import List, Tuple


def get_fft(sample_rate: int, max_step: int) -> int:
    """Smallest power-of-two FFT size with bin width <= max_step
    (radio_utils.cpp:98-104)."""
    fft = 1
    while max_step < sample_rate / fft:
        fft <<= 1
    return fft


def get_prime_factors(n: int) -> List[int]:
    """Prime factorization, ascending; [1] for n == 1 (radio_utils.cpp:106-127)."""
    if n == 1:
        return [1]
    factors = []
    while n % 2 == 0:
        factors.append(2)
        n //= 2
    i = 3
    while i * i <= n:
        while n % i == 0:
            factors.append(i)
            n //= i
        i += 2
    if n > 2:
        factors.append(n)
    return factors


def _split_factor(value: int, factors: List[int], threshold: int) -> None:
    """Split value into factors <= threshold where possible, most balanced
    pair first; primes above threshold stay whole (radio_utils.cpp:9-34)."""

    def balanced_pair(v: int) -> Tuple[int, int]:
        for i in range(int(math.isqrt(v)), 0, -1):
            if v % i == 0:
                return i, v // i
        return 1, v

    if threshold < value and len(get_prime_factors(value)) != 1:
        f1, f2 = balanced_pair(value)
        if threshold < f1:
            _split_factor(f1, factors, threshold)
        else:
            factors.append(f1)
        if threshold < f2:
            _split_factor(f2, factors, threshold)
        else:
            factors.append(f2)
    else:
        factors.append(value)


def get_resamplers_factors(
    sample_rate: int, bandwidth: int, threshold: int
) -> List[Tuple[int, int]]:
    """Staged (interpolation, decimation) factors from sample_rate to
    bandwidth (radio_utils.cpp:129-152)."""
    g = math.gcd(sample_rate, bandwidth)
    left = bandwidth // g
    right = sample_rate // g

    left_factors: List[int] = []
    right_factors: List[int] = []
    _split_factor(left, left_factors, threshold)
    _split_factor(right, right_factors, threshold)
    while len(left_factors) < len(right_factors):
        left_factors.append(1)
    while len(right_factors) < len(left_factors):
        right_factors.append(1)
    left_factors.sort()
    right_factors.sort()
    return list(zip(left_factors, right_factors))
