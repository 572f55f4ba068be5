"""Frequency-domain sliding average (reference utils.cpp:31-53):
out[i] = mean(x[max(0,i-a) : min(n,i+a+1)]), a = group//2, edge windows
shrink.

Kept in the JAX package's factored order: width w = p*q as width-p partial
sums combined at stride p. Another summation order moves results by ~4e-7,
which would break stage-exact comparison with the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _factor(w: int) -> int:
    """Largest divisor of w that is <= sqrt(w) (1 if w is prime)."""
    best = 1
    for p in range(2, int(w**0.5) + 1):
        if w % p == 0:
            best = p
    return best


def sliding_average(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """Edge-shrinking boxcar over the last axis (float32 out)."""
    n = x.shape[-1]
    a = group_size // 2
    w = 2 * a + 1
    xf = x.to(torch.float32)
    p = _factor(w)
    if p > 1:
        q = w // p
        # t[i] = sum x[i : i+p]; y[i] = sum_j t[i + j*p] covers [i, i+w)
        padded = F.pad(xf, (a, a + p))  # zeros never shift sums
        m = n + (q - 1) * p
        t = padded[..., 0:m]
        for s in range(1, p):
            t = t + padded[..., s : s + m]
        total = t[..., 0:n]
        for j in range(1, q):
            total = total + t[..., j * p : j * p + n]
    else:
        padded = F.pad(xf, (a, a))
        total = padded[..., 0:n]
        for s in range(1, w):
            total = total + padded[..., s : s + n]
    # window widths made on the device: a host tensor would cost a copy and
    # a stream synchronisation per call
    idx = torch.arange(n, device=x.device)
    counts = torch.clamp(idx + a + 1, max=n) - torch.clamp(idx - a, min=0)
    return total / counts.to(torch.float32)
