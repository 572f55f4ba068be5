"""Plain detection pipeline of a block, written from the semantics the
configuration states and independent of the program (float64 arithmetic,
each stored or selected row rounded to the precision the configuration
names for it):

- PSD: the first ``fft`` samples of each fft*decim group, cs8 / 127.5,
  times a symmetric Hamming window and (-1)^n (the fftshift), FFT, then
  10 log10(max(|X|^2, 1e-30) / rate) dB;
- noise: frame g of the stream (time stamp trunc((g + 1) * fft * decim *
  1000 / rate) ms) learns while no earlier frame's stamp reached the
  learning time; the floor is the per-bin max over the learning frames,
  and each later frame's row is its PSD less the floor (NO_DATA = -100
  while learning);
- averager: the mean of the last ``grouping_y`` rows (NO_DATA until that
  many frames have been seen), then a ``grouping_x``-bin mean whose edge
  windows shrink;
- detection, per (band, frame): the top ``top_k`` bins (ties to the lower
  bin), ``k_sep`` greedy winners each suppressing +-submargin bins, the
  count of bins at or above the start level, all over rows rounded to the
  selection precision; each candidate's history vote (the most frequent
  first-max position of its +-group/2 window over this frame's row and
  the 10 before it, ties to the median of the tied positions, the window
  counting only where its max reaches the level); and the first max of
  the +-group/2 window around each key.

A block's rows depend on the learned floor, the last ``grouping_y - 1``
rows of the block before it and the block itself, so a block is worked out
from the stream's inputs alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

NO_DATA = -100.0
K_SEP = 16

PRECISION = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to ``precision`` and held in float64."""
    return x.to(PRECISION[precision]).to(torch.float64)


class Geometry(NamedTuple):
    rate: int
    fft: int
    decim: int
    frames: int
    learn_ms: int
    grouping_x: int
    grouping_y: int

    @classmethod
    def of(cls, config: dict) -> "Geometry":
        return cls(config["sample_rate"], config["fft_size"], config["decimator_factor"],
                   config["frames_per_block"], config["noise_learning_ms"], config["grouping_x"],
                   config["grouping_y"])

    @property
    def block_samples(self) -> int:
        return self.frames * self.fft * self.decim

    def stamp_ms(self, g: np.ndarray) -> np.ndarray:
        """int32 ms stamp of stream frame g."""
        return ((np.asarray(g, dtype=np.float64) + 1) * (self.fft * self.decim * 1000.0 / self.rate)).astype(np.int32)

    def last_learning_frame(self) -> int:
        """The last frame whose row is NO_DATA: the first whose stamp reaches
        the learning time."""
        g = 0
        while self.stamp_ms(g) < self.learn_ms:
            g += 1
        return g

    def learning_blocks(self) -> int:
        """Blocks that hold a learning frame."""
        return self.last_learning_frame() // self.frames + 1


def window(fft: int, device) -> torch.Tensor:
    k = torch.arange(fft, dtype=torch.float64, device=device)
    w = 0.54 - 0.46 * torch.cos(2.0 * math.pi * k / (fft - 1))
    return w * (1.0 - 2.0 * (k % 2))


def psd_db(iq: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """[..., fft*decim, 2] int8 -> [..., fft] float64 PSD dB, fftshifted."""
    x = iq[..., : geo.fft, :].to(torch.float64) / 127.5
    spec = torch.fft.fft(torch.complex(x[..., 0], x[..., 1]) * window(geo.fft, iq.device))
    power = spec.real ** 2 + spec.imag ** 2
    return 10.0 * torch.log10(torch.clamp(power, min=1e-30) / geo.rate)


def noise_floor(learning: list, geo: Geometry) -> torch.Tensor:
    """[NB, fft] float64 floor from the learning blocks' inputs (a list of
    [NB, F, fft*decim, 2] int8, blocks 0, 1, ...)."""
    last = geo.last_learning_frame()
    floor = None
    for b, iq in enumerate(learning):
        n = min(geo.frames, last + 1 - b * geo.frames)
        if n <= 0:
            break
        held = torch.stack([psd_db(iq[band, :n], geo).amax(dim=0) for band in range(iq.shape[0])])
        floor = held if floor is None else torch.maximum(floor, held)
    return floor


def raw_rows(iq: torch.Tensor, first_frame: int, floor: torch.Tensor, geo: Geometry,
             frames: slice = slice(None)) -> torch.Tensor:
    """[NB, n, fft] float64 noise-subtracted rows of ``iq``'s frames
    ``frames``, whose first is stream frame ``first_frame``."""
    last = geo.last_learning_frame()
    out = []
    for band in range(iq.shape[0]):
        power = psd_db(iq[band, frames], geo)
        g = first_frame + torch.arange(power.shape[0], device=iq.device)
        out.append(torch.where((g > last)[:, None], power - floor[band], NO_DATA))
    return torch.stack(out)


class Rows(NamedTuple):
    hist: torch.Tensor  # [NB, H-1+F, fft] stored rows: the 10 before the block, then its own
    avg: torch.Tensor  # [NB, F, fft] smoothed rows


def block_rows(prev_iq, iq: torch.Tensor, b: int, floor: torch.Tensor, geo: Geometry,
               row_precision: str) -> Rows:
    """Block b's rows from its inputs and the frames before it (``prev_iq``
    [NB, P, fft*decim, 2], the last P frames of the stream before block b,
    P at least ``grouping_y - 1`` or every frame since the stream began;
    None at b = 0), the history before the stream's first frame being the
    averager's zero ring, each noise-subtracted row stored at
    ``row_precision``."""
    depth, f = geo.grouping_y, geo.frames
    cur = rounded(raw_rows(iq, b * f, floor, geo), row_precision)
    have = 0 if prev_iq is None else min(depth - 1, b * f, prev_iq.shape[1])
    if have < min(depth - 1, b * f):
        raise ValueError(f"block {b} needs {min(depth - 1, b * f)} frames before it, got {have}")
    prev = torch.zeros((cur.shape[0], depth - 1 - have, geo.fft), dtype=torch.float64, device=iq.device)
    if have:
        n = prev_iq.shape[1]
        held = rounded(raw_rows(prev_iq, b * f - have, floor, geo, slice(n - have, n)), row_precision)
        prev = torch.cat([prev, held], dim=1)
    rows = torch.cat([prev, cur], dim=1)  # [NB, depth - 1 + F, fft]
    cs = F.pad(torch.cumsum(rows, dim=1), (0, 0, 1, 0))
    sums = cs[:, depth:] - cs[:, :-depth]  # [NB, F, fft]: rows k .. k + depth - 1
    seen = b * f + torch.arange(1, f + 1, device=iq.device)
    mean = torch.where((seen >= depth)[:, None], sums / depth, NO_DATA)
    half_depth = depth - depth // 2
    return Rows(hist=rows[:, depth - half_depth:], avg=smooth(mean, geo.grouping_x))


def smooth(x: torch.Tensor, group: int) -> torch.Tensor:
    a = group // 2
    n = x.shape[-1]
    cs = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    i = torch.arange(n, device=x.device)
    lo, hi = torch.clamp(i - a, min=0), torch.clamp(i + a + 1, max=n)
    return (cs[..., hi] - cs[..., lo]) / (hi - lo).to(torch.float64)


def submargin(group: int) -> int:
    return group // 2 if group % 2 == 0 else group // 2 + 1


def top_k(sel: torch.Tensor, k: int) -> torch.Tensor:
    """[R, fft] -> [R, k] indices of the k largest, ties to the lower bin."""
    return torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :k]


def greedy(sel: torch.Tensor, k: int, margin: int) -> torch.Tensor:
    """[R, fft] -> [R, k] strongest-first winners, each suppressing +-margin."""
    bins = torch.arange(sel.shape[-1], device=sel.device)[None]
    supp = torch.zeros(sel.shape, dtype=torch.bool, device=sel.device)
    picks = []
    for _ in range(k):
        p = torch.argmax(torch.where(supp, -torch.inf, sel), dim=-1)
        picks.append(p)
        supp |= (bins - p[:, None]).abs() <= margin
    return torch.stack(picks, dim=1)


def vote(hist: torch.Tensor, cand: torch.Tensor, half: int, level: float) -> torch.Tensor:
    """History vote of candidates cand [NB, F, C] over hist [NB, H-1+F, fft]
    (frame k votes over hist rows k .. k+H-1) -> [NB, F, C] int64."""
    nb, f, c = cand.shape
    h_rows = hist.shape[1] - f + 1
    w = 2 * half + 1
    padded = F.pad(hist, (half, half), value=-torch.inf)
    out = torch.empty_like(cand)
    for band in range(nb):
        win = padded[band].unfold(-1, w, 1)  # [R, fft, w]
        rows = torch.arange(f, device=hist.device)[:, None, None] + torch.arange(h_rows, device=hist.device)[None, None, :]
        g = win[rows, cand[band][:, :, None]]  # [F, C, H, w]
        vmax, arg = torch.max(g, dim=-1)  # first max
        votes = cand[band][:, :, None] - half + arg  # [F, C, H]
        ok = vmax >= level
        out[band] = mode_median_ties(votes, ok, cand[band])
    return out


def mode_median_ties(votes: torch.Tensor, ok: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Most frequent valid vote over the last axis; among equally frequent
    values the median of the sorted distinct ones ([n // 2]); ``fallback``
    where no vote is valid."""
    big = torch.iinfo(torch.int64).max
    v = torch.where(ok, votes, big)
    same = (v[..., :, None] == v[..., None, :]) & ok[..., None, :]
    counts = torch.where(ok, same.sum(dim=-1), 0)
    h = votes.shape[-1]
    earlier = torch.tril(torch.ones(h, h, dtype=torch.bool, device=votes.device), diagonal=-1)
    first = ~((v[..., :, None] == v[..., None, :]) & earlier).any(dim=-1)
    tied = ok & first & (counts == counts.max(dim=-1, keepdim=True).values)
    ranked = torch.sort(torch.where(tied, v, big), dim=-1).values
    pick = torch.div(tied.sum(dim=-1, keepdim=True), 2, rounding_mode="floor")
    res = torch.gather(ranked, -1, pick)[..., 0]
    return torch.where(ok.any(dim=-1), res, fallback)


def window_first_max(avg: torch.Tensor, centers: torch.Tensor, half: int):
    """First max of avg [NB, F, fft] over [c - half, c + half] (indices
    clamped into the row) for centers [S] -> (values, indices) [NB, F, S]."""
    fft = avg.shape[-1]
    idx = torch.clamp(centers[:, None] + torch.arange(-half, half + 1, device=avg.device), 0, fft - 1)  # [S, w]
    g = avg[..., idx]  # [NB, F, S, w]
    pos = torch.argmax(g, dim=-1, keepdim=True)
    return torch.gather(g, -1, pos)[..., 0], idx[torch.arange(idx.shape[0], device=avg.device)[None, None, :], pos[..., 0]]


class Detections(NamedTuple):
    cand_idx: torch.Tensor  # [NB, F, top_k + K_SEP]
    cand_val: torch.Tensor
    cand_best: torch.Tensor
    cand_count: torch.Tensor  # [NB, F]
    key_val: torch.Tensor  # [NB, F, S]
    key_idx: torch.Tensor
    ready: torch.Tensor  # [NB] bool


def detect(rows: Rows, ready: bool, keys: torch.Tensor, level: float, group: int, top: int,
           sel_precision: str) -> Detections:
    """The block's detections from its rows, selecting over rows rounded to
    ``sel_precision`` and reporting the rows' own values."""
    nb, f, fft = rows.avg.shape
    sel = rounded(rows.avg, sel_precision).reshape(nb * f, fft)
    cand = torch.cat([top_k(sel, top), greedy(sel, K_SEP, submargin(group))], dim=1).reshape(nb, f, -1)
    count = (sel >= rounded(torch.tensor(level, dtype=torch.float64), sel_precision)).sum(dim=-1).reshape(nb, f)
    best = vote(rounded(rows.hist, sel_precision), cand, group // 2, level)
    key_val, key_idx = window_first_max(rows.avg, keys.to(rows.avg.device), group // 2)
    return Detections(cand, torch.gather(rows.avg, 2, cand), best, count, key_val, key_idx,
                      torch.full((nb,), ready, dtype=torch.bool))
