"""Device-side detection compaction (port of the JAX package's
``ops/detect.py``).

Per (band, frame) row of the smoothed spectrum: top-K candidate bins,
K_SEP margin-separated winners, the count above the start level, the
reference's history vote per candidate (transmission.cpp:132-154, mode with
the C++ median-of-ties rule, collection_utils.h:29-50) and a windowed argmax
per tracked key. Bands are a leading batch dimension: rows are [NB, F, fft].

The selection (top-K, margin winners, count) is ``ops/cuda/select_kernel``
and the history vote ``ops/cuda/vote_kernel``; this module holds the plain
pieces their plain versions are built from.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

K_SEP = 16  # margin-separated candidate slots

# History-vote lowering of the plain version (history_vote_plain, the CPU's;
# the card runs ops/cuda/vote_kernel at every width): "code" = the int8-code
# sliding table (sliding_argmax_code + _vote_windows_code; the f32+i32 pair
# tables for windows wider than 128 bins), "gather" = candidate-window
# gathers (_vote_windows_gather: only the consumed cells, any width). Read at
# each call; no config key selects it, as in the reference.
VOTE_FORM = "code"

# suppression sentinel of the margin greedy and the selection kernel
SUPPRESSED = -3.3e38
# value compact_detection writes into masked-out bins
MASKED = -3.0e38


class CompactOutputs(NamedTuple):
    cand_idx: torch.Tensor  # [NB, F, K + K_SEP] i32, value-sorted desc
    cand_val: torch.Tensor  # [NB, F, K + K_SEP] f32
    cand_best: torch.Tensor  # [NB, F, K + K_SEP] i32 history-vote result
    cand_count: torch.Tensor  # [NB, F] i32 bins >= start_level (masked)
    key_val: torch.Tensor  # [NB, F, S] f32 windowed max around each key
    key_idx: torch.Tensor  # [NB, F, S] i32 argmax position for key_val


def top_k_exact(rows: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis, value descending with FIRST-occurrence
    ties (lax.top_k's documented order; torch.topk promises no tie order, so
    this is a stable sort)."""
    vals, idx = torch.sort(rows, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _margin_separated_top(
    rows: torch.Tensor, k: int, submargin: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy strongest-first selection with +-submargin suppression over
    rows [R, fft] -> (vals [R, k] row dtype, idxs [R, k] i32).

    The sequential greedy that the JAX package's segment-table form
    (``_margin_separated_top``) and its ``_1per`` fallback both reproduce:
    each step takes the first-occurrence argmax of the row with every zone
    found so far set to the sentinel cast to the row dtype.
    """
    r, fft = rows.shape
    bins = torch.arange(fft, device=rows.device)[None, :]
    neg = torch.tensor(SUPPRESSED, dtype=rows.dtype, device=rows.device)
    supp = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
    vals, idxs = [], []
    for _ in range(k):
        cur = torch.where(supp, neg, rows)
        idx = torch.argmax(cur, dim=-1)  # first occurrence of the max
        vals.append(torch.gather(cur, 1, idx[:, None])[:, 0])
        idxs.append(idx)
        supp |= (bins - idx[:, None]).abs() <= submargin
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1).to(torch.int32)


def count_at_level(rows: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Bins >= level per row, the level cast DOWN to the row dtype."""
    return (rows >= level.to(rows.dtype)).sum(dim=-1).to(torch.int32)


def _sliding_span_tables(rows: torch.Tensor, half: int, max_levels: int):
    """Doubling-table core of the sliding-window argmax family: per-position
    (max, int8 argmax offset) over 2^J-wide spans, in PADDED coordinates
    (real bin b at position b + half; -inf padding shrinks edge windows)."""
    n = rows.shape[-1]
    w = 2 * half + 1
    j_max = 0
    while (1 << (j_max + 1)) <= w and j_max + 1 <= max_levels:
        j_max += 1
    span = 1 << j_max
    if span > 128:
        raise ValueError("int8 offset encoding bounds the window span at 128")
    total = n + 2 * half + span
    v = F.pad(rows, (half, total - n - half), value=-torch.inf)
    off8 = torch.zeros(v.shape, dtype=torch.int8, device=rows.device)
    for j in range(j_max):
        step = 1 << j
        sv = F.pad(v[..., step:], (0, step), value=-torch.inf)
        so = F.pad(off8[..., step:], (0, step))
        # the left span's candidate has the smaller index: >= keeps the
        # first-occurrence rule
        take = v >= sv
        v = torch.where(take, v, sv)
        off8 = torch.where(take, off8, so + step)
    return v, off8, span, w


def sliding_argmax(rows: torch.Tensor, half: int, max_levels: int = 4):
    """(max value, FIRST-max index) over the clamped window [c-half, c+half]
    for every center c: [..., n] -> (values [..., n], indices [..., n] i32)."""
    n = rows.shape[-1]
    v, off8, span, w = _sliding_span_tables(rows, half, max_levels)
    starts = list(range(0, w - span, span)) + [w - span]
    pos = torch.arange(n, dtype=torch.int32, device=rows.device) - half
    bv = v[..., :n]
    bi = pos + off8[..., :n].to(torch.int32)
    for s in starts[1:]:
        cv = v[..., s : s + n]
        take = bv >= cv
        bv = torch.where(take, bv, cv)
        bi = torch.where(take, bi, pos + s + off8[..., s : s + n].to(torch.int32))
    return bv, bi


def sliding_argmax_code(
    rows: torch.Tensor, half: int, level: torch.Tensor, max_levels: int = 3
) -> torch.Tensor:
    """Windowed first-max argmax at every center as ONE int8 code: the
    offset from the window start (0..2*half) when the window max is >= level,
    else -1. The level test runs after promotion to f32, as the reference's
    ``bv >= level`` does with a bf16 table and an f32 level."""
    n = rows.shape[-1]
    if 2 * half + 1 > 128:
        raise ValueError("int8 window-relative codes bound the window at 128")
    v, off8, span, w = _sliding_span_tables(rows, half, max_levels)
    starts = list(range(0, w - span, span)) + [w - span]
    bv = v[..., :n]
    rel = off8[..., :n]
    for s in starts[1:]:
        cv = v[..., s : s + n]
        take = bv >= cv
        bv = torch.where(take, bv, cv)
        rel = torch.where(take, rel, off8[..., s : s + n] + s)
    return torch.where(bv.to(torch.float32) >= level.to(torch.float32), rel, -1)


def _history_rows(f: int, half_depth: int, device) -> torch.Tensor:
    """[F, H] history row of each vote: frame k votes over rows k..k+H-1."""
    return (
        torch.arange(f, device=device)[:, None]
        + torch.arange(half_depth, device=device)[None, :]
    )


def _vote_windows_code(code_tbl: torch.Tensor, cand_idx: torch.Tensor, half_depth: int):
    """out[b, k, h, c] = code_tbl[b, k+h, cand[b, k, c]]: [NB, F, H, K] int8."""
    nb, f, _ = cand_idx.shape
    rows = _history_rows(f, half_depth, code_tbl.device)
    band = torch.arange(nb, device=code_tbl.device)[:, None, None, None]
    return code_tbl[band, rows[None, :, :, None], cand_idx[:, :, None, :].long()]


def _vote_windows(
    hist_val: torch.Tensor, hist_idx: torch.Tensor, cand_idx: torch.Tensor, half_depth: int
):
    """Pair-table form of the vote-window selection (windows wider than 128
    bins): (vals [NB, F, H, K] f32, idxs [NB, F, H, K] i32). The reference's
    one-hot contraction yields f32 values; the gather here is exact."""
    nb, f, _ = cand_idx.shape
    rows = _history_rows(f, half_depth, hist_val.device)
    band = torch.arange(nb, device=hist_val.device)[:, None, None, None]
    at = (band, rows[None, :, :, None], cand_idx[:, :, None, :].long())
    return hist_val[at].to(torch.float32), hist_idx[at]


def _vote_windows_gather(
    hist: torch.Tensor, cand_idx: torch.Tensor, half: int, level: torch.Tensor, half_depth: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """History vote by candidate-window gathers instead of the sliding table:
    hist [NB, R, fft] (f32 or bf16, R = H-1+F), cand_idx [NB, F, K] ->
    (idxs [NB, F, H, K] i32, valid [NB, F, H, K] bool).

    The history is padded with ``half`` -inf bins a side (edge windows
    shrink like the host get_max_index; padding never wins) and made
    bin-major, so a candidate's window is 2*half+1 consecutive rows. Each
    (frame, candidate) takes its window over the H history rows it votes on
    (frame k: rows k..k+H-1), then the max and the first-occurrence argmax
    over the window: the same cells the reference selects after reducing
    all R rows. Validity compares the window max with the level in f32, as
    the code form does; the reference casts the level down to the history
    dtype, which in bf16 disagrees with its code form for maxima in
    [round_bf16(level), level). The windows are ``Tensor.unfold`` views;
    the reference's two gather lowerings are XLA choices that give the same
    cells, and this one equals both."""
    nb, f, _ = cand_idx.shape
    w = 2 * half + 1
    dev = hist.device
    hist_t = F.pad(hist, (half, half), value=-torch.inf).transpose(1, 2)  # [NB, fft + 2*half, R]
    band = torch.arange(nb, device=dev)[:, None, None, None]
    start = cand_idx.long()[..., None]  # window start in padded coords = the candidate's bin
    row = _history_rows(f, half_depth, dev)[None, :, None, :]  # [1, F, 1, H]
    g = hist_t.unfold(1, w, 1)[band, start, row]  # [NB, F, K, H, w]
    vmax, varg = torch.max(g, dim=-1)  # the first maximal index
    valid = vmax.to(torch.float32) >= level.to(torch.float32)
    idxs = cand_idx[..., None] - half + varg.to(torch.int32)
    return idxs.transpose(2, 3), valid.transpose(2, 3)


def _mode_median_ties_unrolled(
    votes: torch.Tensor, valid: torch.Tensor, fallback: torch.Tensor
) -> torch.Tensor:
    """C++ mostFrequentValue over the valid votes (collection_utils.h:29-50):
    among values sharing the max count, the median of the sorted distinct
    values ([n_tied // 2]). votes/valid: [..., H, K]; fallback [..., K]."""
    h = votes.shape[-2]
    big = 2**30
    v = torch.where(valid, votes, big)
    vs = [v[..., i, :] for i in range(h)]
    ok = [valid[..., i, :] for i in range(h)]
    counts = []
    for i in range(h):
        c = torch.zeros(vs[i].shape, dtype=torch.int32, device=votes.device)
        for j in range(h):
            c = c + ((vs[i] == vs[j]) & ok[j]).to(torch.int32)
        counts.append(torch.where(ok[i], c, 0))
    maxc = counts[0]
    for i in range(1, h):
        maxc = torch.maximum(maxc, counts[i])
    reps = []
    for i in range(h):
        rep = (counts[i] == maxc) & ok[i]
        for j in range(i):  # first occurrence of each distinct value
            rep = rep & (vs[i] != vs[j])
        reps.append(rep)
    vals = [torch.where(reps[i], vs[i], big) for i in range(h)]
    for p in range(h):  # odd-even transposition sort, ascending
        for i in range(p % 2, h - 1, 2):
            lo = torch.minimum(vals[i], vals[i + 1])
            vals[i + 1] = torch.maximum(vals[i], vals[i + 1])
            vals[i] = lo
    n_tied = reps[0].to(torch.int32)
    for i in range(1, h):
        n_tied = n_tied + reps[i].to(torch.int32)
    pick = n_tied // 2
    res = vals[0]
    for i in range(1, h):
        res = torch.where(pick == i, vals[i], res)
    any_valid = ok[0]
    for i in range(1, h):
        any_valid = any_valid | ok[i]
    return torch.where(any_valid, res, fallback)


def history_vote_plain(
    raw: torch.Tensor,
    prev_tail: torch.Tensor,
    cand_idx: torch.Tensor,
    half: int,
    level: torch.Tensor,
    half_depth: int,
    bf16: bool,
) -> torch.Tensor:
    """The reference's history vote (transmission.cpp:132-154): for each
    candidate of frame k, the first-max argmax of each history row k..k+H-1
    (rows of prev_tail [NB, H-1, fft] ++ raw [NB, F, fft]) over the clamped
    window [c-half, c+half], valid where the window max (promoted to f32)
    is >= level (f32); then the mode of the valid votes with the median-of-
    ties rule, or the candidate where none is valid. cand_idx [NB, F, K]
    -> cand_best [NB, F, K]. The history is voted in the rows' dtype, in
    bf16 where ``bf16``. ``VOTE_FORM`` picks the lowering; every form gives
    the same votes. This is the CPU's version of ``ops/cuda/vote_kernel``."""
    # history vote: rows k-10..k (global) = hist[k : k+half_depth]
    hist = torch.cat([prev_tail.to(raw.dtype), raw], dim=1)  # [NB, H-1+F, fft]
    if bf16:
        hist = hist.to(torch.bfloat16)
    if VOTE_FORM == "gather":
        idxs, votes_valid = _vote_windows_gather(hist, cand_idx, half, level, half_depth)
    elif 2 * half + 1 <= 128:
        code_tbl = sliding_argmax_code(hist, half, level)
        codes = _vote_windows_code(code_tbl, cand_idx, half_depth)  # [NB, F, H, K]
        votes_valid = codes >= 0
        idxs = (cand_idx[:, :, None, :] - half) + codes.to(torch.int32)
    else:
        hist_val, hist_idx = sliding_argmax(hist, half)
        vote_val, idxs = _vote_windows(hist_val, hist_idx, cand_idx, half_depth)
        votes_valid = vote_val >= level
    return _mode_median_ties_unrolled(idxs, votes_valid, cand_idx)


def _windowed_argmax(rows: torch.Tensor, centers: torch.Tensor, half: int, fft: int):
    """First-max argmax of rows[..., :] in [center-half, center+half] clamped:
    rows [..., fft], centers [C] -> (values [..., C], indices [..., C] i32).
    Per-band centers [NB, C] take rows [NB, F, fft] (each band its own keys)."""
    offs = torch.arange(-half, half + 1, device=rows.device)
    idx = torch.clamp(centers.long()[..., None] + offs, 0, fft - 1)  # [(NB,) C, w]
    if centers.ndim == 1:
        gathered = rows[..., idx]  # [..., C, w]
    else:
        nb, f = rows.shape[:2]
        band = torch.arange(nb, device=rows.device)[:, None, None, None]
        frame = torch.arange(f, device=rows.device)[None, :, None, None]
        idx = idx[:, None].expand(nb, f, *idx.shape[1:])  # [NB, F, C, w]
        gathered = rows[band, frame, idx]
    pos = torch.argmax(gathered, dim=-1)  # first max
    best_idx = torch.gather(idx.expand(pos.shape + (idx.shape[-1],)), -1, pos[..., None])[..., 0]
    best_val = torch.gather(gathered, -1, pos[..., None])[..., 0]
    return best_val, best_idx.to(torch.int32)


def compact_detection(
    avg: torch.Tensor,  # [NB, F, fft] smoothed rows
    raw: torch.Tensor,  # [NB, F, fft] raw (noise-subtracted) rows of this block
    prev_tail: torch.Tensor,  # [NB, half-1, fft] newest ordered ring rows pre-block
    keys: torch.Tensor,  # [S] i32 tracked signal keys, or [NB, S] (each band its own)
    valid_mask: torch.Tensor,  # [fft] bool: in-range & not ignored, or [NB, fft]
    start_level: torch.Tensor,  # 0-d f32
    group_size: int,
    top_k: int,
    bf16: bool = False,
) -> CompactOutputs:
    """bf16=True is the tolerance mode: the selection sweeps read bf16 copies
    of the rows, every reported value stays f32. The selection and the
    history vote always go through the hand-written kernels' wrappers
    (``ops/cuda/select_kernel``, ``ops/cuda/vote_kernel``)."""
    nb, f, fft = avg.shape
    half = group_size // 2
    level = start_level.to(torch.float32)

    masked = torch.where(valid_mask if valid_mask.ndim == 1 else valid_mask[:, None, :], avg, MASKED)
    sel = masked.to(torch.bfloat16) if bf16 else masked
    submargin = group_size // 2 if group_size % 2 == 0 else group_size // 2 + 1
    from rtl_sdr_scanner_tpu_torch.ops.cuda.select_kernel import fused_selection

    # CPU rows take the plain version; on the card the wrapper launches the
    # kernel or raises on a shape the kernel does not take
    top_val, top_idx, sep_val, sep_idx, cand_count = fused_selection(
        sel.reshape(nb * f, fft), level, top_k, K_SEP, submargin
    )
    cand_idx = torch.cat([top_idx, sep_idx], dim=1).reshape(nb, f, -1)
    cand_count = cand_count.reshape(nb, f)
    if bf16:
        # exact f32 powers at the bf16-selected bins
        cand_val = torch.gather(masked, 2, cand_idx.long())
    else:
        cand_val = torch.cat([top_val, sep_val], dim=1).reshape(nb, f, -1)

    # history vote: frame k votes over rows k..k+H-1 of prev_tail ++ raw.
    # CPU rows take the plain version (history_vote_plain); on the card the
    # wrapper launches the kernel or raises
    from rtl_sdr_scanner_tpu_torch.ops.cuda.vote_kernel import history_vote

    cand_best = history_vote(raw, prev_tail, cand_idx, half, level, prev_tail.shape[1] + 1, bf16)

    key_val, key_idx = _windowed_argmax(avg, keys, half, fft)

    return CompactOutputs(
        cand_idx=cand_idx.to(torch.int32),
        cand_val=cand_val,
        cand_best=cand_best.to(torch.int32),
        cand_count=cand_count,
        key_val=key_val,
        key_idx=key_idx,
    )
