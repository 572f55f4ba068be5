"""Radio math helpers (host side).

Behavioral parity targets: reference sources/utils/radio_utils.cpp
(FFT sizing, frequency snapping, resampler factorization, range splitting,
frequency formatting). Golden-tested against tests/test_radio_utils.cpp
expectations.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from rtl_sdr_scanner_tpu_torch.utils.utils import round_down

Frequency = int
FrequencyRange = Tuple[int, int]


def format_frequency(frequency: int) -> str:
    """Human format: 144.962.500 Hz (reference radio_utils.cpp:37-57, no color)."""
    f1 = frequency // 1000000
    f2 = (frequency // 1000) % 1000
    f3 = frequency % 1000
    if frequency >= 1000000:
        return f"{f1:d}.{f2:03d}.{f3:03d} Hz"
    elif frequency >= 1000:
        return f"{f2:d}.{f3:03d} Hz"
    return f"{f3:d} Hz"


def format_power(power: float) -> str:
    """Reference radio_utils.cpp:59-70 (no color)."""
    return f"{power:5.2f}"


def get_tuned_frequency(frequency: int, step: int) -> int:
    """Round frequency to the step grid, ties toward +infinity.

    Mirrors the C++ truncating-modulo arithmetic of radio_utils.cpp:86-96:
    negative frequencies bias the remainder by +step.
    """
    rest = math.fmod(frequency, step)
    rest = int(rest)
    if frequency < 0:
        rest += step
    down = frequency - rest
    up = down + step
    if rest < step - rest:
        return down
    return up


def get_fft(sample_rate: int, max_step: int) -> int:
    """Smallest power-of-two FFT size with bin width <= max_step.

    Reference radio_utils.cpp:98-104.
    """
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
    """Recursively split value into factors <= threshold where possible.

    Mirrors the anonymous-namespace `split` of radio_utils.cpp:9-34: at each
    step pick the most-balanced two-way factorization (largest divisor
    <= sqrt(value)); primes larger than threshold stay whole.
    """

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
    """Staged (interpolation, decimation) factors from sample_rate to bandwidth.

    GCD-reduce the ratio, split both sides into factors <= threshold, pad with
    ones, sort ascending, and pair stage-wise (radio_utils.cpp:129-152).
    """
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


def get_range_split_sample_rate(sample_rate: int) -> int:
    """Round a sample rate down to a friendly hop-grid rate
    (radio_utils.cpp:163-173)."""
    if sample_rate >= 10_000_000:
        return round_down(sample_rate, 1_000_000)
    elif sample_rate >= 1_000_000:
        return round_down(sample_rate, 500_000)
    elif sample_rate >= 100_000:
        return round_down(sample_rate, 100_000)
    return sample_rate


def split_range(rng: FrequencyRange, sample_rate: int) -> List[FrequencyRange]:
    """Chop a range into sample_rate-wide hops (radio_utils.cpp:175-186)."""
    start, stop = rng
    if stop - start <= sample_rate:
        return [rng]
    return [(f, f + sample_rate) for f in range(start, stop, sample_rate)]


def split_ranges(
    ranges: List[FrequencyRange], sample_rate: int
) -> List[FrequencyRange]:
    """splitRange over a list (radio_utils.cpp:188-196)."""
    out: List[FrequencyRange] = []
    for rng in ranges:
        out.extend(split_range(rng, sample_rate))
    return out


def get_raw_file_name(label: str, extension: str, frequency: int, sample_rate: int, *, now=None) -> str:
    """Debug dump filename convention (radio_utils.cpp:78-84); parsed by
    scripts/converter.py."""
    import datetime

    tm = now or datetime.datetime.now()
    return (
        f"./{label}_{tm.year:04d}{tm.month:02d}{tm.day:02d}_"
        f"{tm.hour:02d}{tm.minute:02d}{tm.second:02d}_{frequency}_{sample_rate}_{extension}.raw"
    )
