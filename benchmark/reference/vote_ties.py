"""The history vote judged up to the rows' tolerance.

A vote (``scan.vote``) is a step function of its rows: each row's first
max over the candidate's window, counted only where that max reaches the
level, then the most frequent position, ties to the median. Over rows
rounded to bfloat16, a stored row that lies within a rounding error of a
bfloat16 boundary can land on either side of it: two bins then tie or
part, a window's max crosses the level or not, and the vote moves by up to
the window's width. ``judge.judge_scan`` compares the reported vote with
the reference's exactly, which holds where the program's rows equal the
reference's to far below a boundary's reach, as the int8 PSD kernel's do.
Channels of a float32 filter bank carry more rounding into their rows, and
such flips show.

``vote_gap`` accepts a reported vote that the reference gives for some
rows each within ``tol_db`` of its own stored row, rounded to the
selection precision as the program rounds them; a vote it does not accept
reads its distance to the reference's own vote, as ``judge_scan`` reads
it. Each row of a candidate's vote is a different stored row, so the rows
are chosen independently; the search is exact, over every choice of each
row's possible outcomes (its first-max positions, or no vote), and a
candidate with more than ``MAX_CHOICES`` choices is not accepted.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import torch

from benchmark.reference import scan

MAX_CHOICES = 1 << 16


def row_outcomes(lo: torch.Tensor, hi: torch.Tensor, level: float) -> List[Optional[int]]:
    """The outcomes one row can give, each bin between ``lo`` and ``hi``
    [w]: window positions that can be its first max reaching the level,
    and None where its max can stay under the level."""
    neg = torch.full((1,), -torch.inf, dtype=lo.dtype)
    before = torch.cummax(torch.cat([neg, lo[:-1]]), dim=0).values  # max of lo over earlier bins
    after = torch.flip(torch.cummax(torch.flip(torch.cat([lo[1:], neg]), [0]), dim=0).values, [0])
    can = (hi > before) & (hi >= after) & (hi >= level)
    out: List[Optional[int]] = torch.nonzero(can)[:, 0].tolist()
    if lo.max().item() < level:
        out.append(None)
    return out


def mode_median_ties(votes: List[Optional[int]], fallback: int) -> int:
    """``scan.mode_median_ties`` of one candidate's votes (None: no vote)."""
    counts = {}
    for v in votes:
        if v is not None:
            counts[v] = counts.get(v, 0) + 1
    if not counts:
        return fallback
    top = max(counts.values())
    tied = sorted(v for v, c in counts.items() if c == top)
    return tied[len(tied) // 2]


def admissible(rows: torch.Tensor, cand: int, half: int, level: float, precision: str, tol_db: float,
               vote: int) -> bool:
    """Whether ``vote`` is the reference's vote of candidate ``cand`` for
    some rows each within ``tol_db`` of ``rows`` [H, fft] (float64)."""
    fft = rows.shape[1]
    lo_bin, hi_bin = max(cand - half, 0), min(cand + half + 1, fft)
    win = rows[:, lo_bin:hi_bin]
    lo = scan.rounded(win - tol_db, precision)
    hi = scan.rounded(win + tol_db, precision)
    options = [[None if j is None else lo_bin + j for j in row_outcomes(lo[r], hi[r], level)]
               for r in range(rows.shape[0])]
    fixed = sum(1 for opts in options if vote in opts)
    free = [opts for opts in options if vote not in opts]
    n = 1
    for opts in free:
        n *= len(opts)
        if n > MAX_CHOICES:
            return False
    for pick in itertools.product(*free):
        if mode_median_ties([vote] * fixed + list(pick), cand) == vote:
            return True
    return False


def vote_gap(got: scan.Detections, hist: torch.Tensor, half: int, level: float, precision: str,
             tol_db: float) -> float:
    """The worst |reported vote - the reference's| over the candidates
    (got's [NB, F, C]; hist [NB, H-1+F, fft] the reference's stored rows,
    float64), 0 where the reported vote is one that rows within ``tol_db``
    of the reference's give."""
    want = scan.vote(scan.rounded(hist, precision), got.cand_idx, half, level)
    gap = (got.cand_best - want).abs()
    f = got.cand_idx.shape[1]
    h = hist.shape[1] - f + 1
    flagged = torch.nonzero(gap > 0)
    order = torch.argsort(gap[tuple(flagged.T)], descending=True)
    for band, frame, c in flagged[order].tolist():  # the widest first: the first not accepted is the worst
        cand, vote = int(got.cand_idx[band, frame, c]), int(got.cand_best[band, frame, c])
        rows = hist[band, frame: frame + h].cpu()
        if not admissible(rows, cand, half, level, precision, tol_db, vote):
            return float(gap[band, frame, c])
    return 0.0
