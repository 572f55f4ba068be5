"""The numbers that decide ``correct`` for a block step: the program's
outputs judged by what they say against the plain reference's rows and
recordings. Each number is a worst case over the checked blocks, bands,
frames and slots; its limit sits in the cell's file.

- ``rows_db``: |reported value - reference row at the reported bin| over
  every candidate and key, and each key's value against the reference's
  window max (dB); readiness that differs reads infinite.
- ``select_rel``: the top-K bins' reference values, sorted, against the
  reference's own top K, rank by rank; and each margin winner's reference
  value against the reference's max outside the zones of the winners
  reported before it (a winner inside a zone reads infinite); as a share
  of max(|value|, 1).
- ``count_excess``: how far the reported count lies outside the counts of
  the reference's rows moved by -+``COUNT_SLACK_DB`` and rounded to the
  selection precision.
- ``vote_bins``: |reported vote - the reference's vote for the reported
  candidate| in bins.
- ``rec_excess_lsb``: max |recording - clip(127 y)| - 1/2 over the int8
  recordings, y the reference bank's output (0 where every sample is the
  nearest integer).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import scan

COUNT_SLACK_DB = 4e-3


def unpack(packed: torch.Tensor, frames: int, top: int, key_slots: int) -> scan.Detections:
    """The program's packed rows [NB, L] float32 -> Detections."""
    n = top + scan.K_SEP
    row = 3 * n + 1 + 2 * key_slots
    body = packed[:, : frames * row].reshape(packed.shape[0], frames, row).to(torch.float64)
    i64 = lambda t: t.round().to(torch.int64)
    return scan.Detections(
        cand_idx=i64(body[..., :n]), cand_val=body[..., n: 2 * n], cand_best=i64(body[..., 2 * n: 3 * n]),
        cand_count=i64(body[..., 3 * n]), key_val=body[..., 3 * n + 1: 3 * n + 1 + key_slots],
        key_idx=i64(body[..., 3 * n + 1 + key_slots:]), ready=packed[:, frames * row] > 0.5,
    )


def _rel(gap: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return gap.abs() / torch.clamp(ref.abs(), min=1.0)


def select_gap(got: scan.Detections, avg: torch.Tensor, top: int, group: int) -> float:
    nb, f, fft = avg.shape
    rows = avg.reshape(nb * f, fft)
    top_idx = got.cand_idx[..., :top].reshape(nb * f, top)
    sep_idx = got.cand_idx[..., top:].reshape(nb * f, -1)
    if (top_idx < 0).any() or (top_idx >= fft).any() or (sep_idx < 0).any() or (sep_idx >= fft).any():
        return float("inf")
    if (torch.sort(top_idx, dim=-1).values.diff(dim=-1) == 0).any():
        return float("inf")
    want = torch.topk(rows, top, dim=-1).values
    have = torch.sort(torch.gather(rows, 1, top_idx), dim=-1, descending=True).values
    worst = _rel(have - want, want).max().item()
    margin = scan.submargin(group)
    bins = torch.arange(fft, device=avg.device)[None]
    supp = torch.zeros(rows.shape, dtype=torch.bool, device=avg.device)
    for i in range(sep_idx.shape[1]):
        p = sep_idx[:, i: i + 1]
        if torch.gather(supp, 1, p).any():
            return float("inf")
        best = torch.where(supp, -torch.inf, rows).amax(dim=-1)
        worst = max(worst, _rel(best - torch.gather(rows, 1, p)[:, 0], best).max().item())
        supp |= (bins - p).abs() <= margin
    return worst


def count_excess(got: scan.Detections, avg: torch.Tensor, level: float, sel_precision: str) -> float:
    lvl = scan.rounded(torch.tensor(level, dtype=torch.float64), sel_precision)
    count = lambda rows: (scan.rounded(rows, sel_precision) >= lvl).sum(dim=-1)
    lo, hi = count(avg - COUNT_SLACK_DB), count(avg + COUNT_SLACK_DB)
    c = got.cand_count
    return torch.clamp(torch.maximum(lo - c, c - hi), min=0).max().item()


def judge_scan(got: scan.Detections, ref: scan.Rows, ref_ready: bool, keys: torch.Tensor, level: float,
               group: int, top: int, sel_precision: str) -> Dict[str, float]:
    """The scan's numbers for one block (got on ref's device)."""
    avg = ref.avg
    fft = avg.shape[-1]
    if bool((got.ready != ref_ready).any()):
        return dict(rows_db=float("inf"), select_rel=float("inf"), count_excess=float("inf"),
                    vote_bins=float("inf"))
    idx_ok = lambda i: bool(((i >= 0) & (i < fft)).all())
    if not (idx_ok(got.cand_idx) and idx_ok(got.key_idx)):
        return dict(rows_db=float("inf"), select_rel=float("inf"), count_excess=float("inf"),
                    vote_bins=float("inf"))
    key_max, _ = scan.window_first_max(avg, keys.to(avg.device), group // 2)
    rows_db = max(
        (got.cand_val - torch.gather(avg, 2, got.cand_idx)).abs().max().item(),
        (got.key_val - torch.gather(avg, 2, got.key_idx)).abs().max().item(),
        (got.key_val - key_max).abs().max().item(),
    )
    want_best = scan.vote(scan.rounded(ref.hist, sel_precision), got.cand_idx, group // 2, level)
    return dict(
        rows_db=rows_db,
        select_rel=select_gap(got, avg, top, group),
        count_excess=count_excess(got, avg, level, sel_precision),
        vote_bins=(got.cand_best - want_best).abs().max().item(),
    )


def judge_recording(rec: torch.Tensor, ref127: torch.Tensor) -> Dict[str, float]:
    """rec [..., 2] int8 against the reference's 127 y [..., 2] float."""
    want = torch.clamp(ref127.to(torch.float64), -128.0, 127.0)
    gap = (rec.to(torch.float64) - want).abs().max().item()
    return dict(rec_excess_lsb=max(gap - 0.5, 0.0))


def worst(into: Dict[str, float], numbers: Dict[str, float]) -> None:
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), float(v))
