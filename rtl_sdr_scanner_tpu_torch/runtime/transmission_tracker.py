"""Signal lifecycle state machine (host side).

Re-implements the reference detection bookkeeping with exact semantics:
- Signal (sources/radio/signal.cpp): per-transmission timers, power, index
  history, the isMinimalTime/isMaximalTime/isTimeout/needFlush predicates.
- Transmission (sources/radio/blocks/transmission.cpp): per detection frame,
  add/update/clear tracked signals and emit the sorted (shift, flush) list.

The heavy per-bin math (PSD, noise floor, time+frequency smoothing) already
happened on device (models/scan_pipeline.py); this consumes the <=50 rows/s
of raw/avg rows, so plain numpy + small python loops over the handful of
tracked signals is the right altitude (SURVEY.md section 7 architecture
stance: host owns signal lifecycle bookkeeping).

All times are relative milliseconds (stream time), an input -- never wall
clock -- so replayed captures detect deterministically.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rtl_sdr_scanner_tpu_torch.constants import DEFAULT, Tunables
from rtl_sdr_scanner_tpu_torch.utils import logger
from rtl_sdr_scanner_tpu_torch.utils.collection_utils import (
    contains_with_margin,
    get_max_index,
    most_frequent_value,
)
from rtl_sdr_scanner_tpu_torch.utils.radio_utils import format_frequency, format_power, get_tuned_frequency

LABEL = "transmission"

FrequencyFlush = Tuple[int, bool]  # (shift snapped to tuning step, needs flush)


class Signal:
    """One tracked transmission (reference signal.cpp:6-40)."""

    def __init__(self, now_ms: int, start_level: float, stop_level: float,
                 min_time_ms: int, timeout_ms: int, max_time_ms: int):
        self.first_ms = now_ms
        self.last_ms = now_ms
        self.power = 0.0
        self.indexes: List[int] = []
        self._start_level = start_level
        self._stop_level = stop_level
        self._min_time_ms = min_time_ms
        self._timeout_ms = timeout_ms
        self._max_time_ms = max_time_ms

    def new_data(self, avg_index: int, avg_power: float, now_ms: int) -> None:
        """signal.cpp:16-24: refresh last-active if >= stopLevel, append index
        history if >= startLevel."""
        self.power = avg_power
        if avg_power >= self._stop_level:
            self.last_ms = now_ms
        if avg_power >= self._start_level:
            self.indexes.append(avg_index)

    def is_minimal_time(self, now_ms: int) -> bool:
        return self.first_ms + self._min_time_ms <= now_ms

    def is_maximal_time(self, now_ms: int) -> bool:
        return self.first_ms + self._max_time_ms <= now_ms

    def is_timeout(self, now_ms: int) -> bool:
        return self.last_ms + self._timeout_ms <= now_ms

    def need_flush(self, now_ms: int) -> bool:
        """Active this very frame AND past minimal time (signal.cpp:32)."""
        return self.last_ms == now_ms and self.is_minimal_time(now_ms)

    def get_index(self) -> int:
        """Most frequent historical index (signal.cpp:36)."""
        return most_frequent_value(self.indexes) if self.indexes else 0


class TransmissionTracker:
    """Per-band detector bookkeeping (reference transmission.cpp:9-176).

    Consumes device-produced rows; maintains the raw-row history ring that the
    reference keeps inside Averager (averager.cpp data()) for the history vote.
    """

    def __init__(
        self,
        fft_size: int,
        group_size: int,
        start_level: float,
        stop_level: float,
        recording_min_time_ms: int,
        recording_timeout_ms: int,
        tuning_step: int,
        index_to_shift: Callable[[int], int],
        index_to_frequency: Callable[[int], int],
        is_index_in_range: Callable[[int], bool],
        ignored_ranges: Sequence[Tuple[int, int]] = (),
        tunables: Tunables = DEFAULT,
    ):
        self._fft_size = fft_size
        self._group_size = group_size
        self._start_level = start_level
        self._stop_level = stop_level
        self._min_time_ms = recording_min_time_ms
        self._timeout_ms = recording_timeout_ms
        self._max_time_ms = tunables.transmission_max_time_ms
        self._tuning_step = tuning_step
        self._index_to_shift = index_to_shift
        self._index_to_frequency = index_to_frequency
        self._is_index_in_range = is_index_in_range
        self._grouping_y = tunables.grouping_y
        self._signals: Dict[int, Signal] = {}
        # raw-row ring, oldest-first, zero-filled like the reference Averager
        self._history: deque = deque(
            np.zeros((fft_size,), dtype=np.float32) for _ in range(self._grouping_y)
        )
        # precompute the in-range & not-ignored bin mask lazily (depends on
        # center frequency via the callbacks; recomputed on reset)
        self._valid_mask: Optional[np.ndarray] = None
        self._ignored_ranges = list(ignored_ranges)
        # compact-mode candidate overflow observability: frames whose
        # above-level bin count exceeded the device candidate capacity
        # (the reference processes ALL bins, transmission.cpp:88-111; the
        # compact path's coverage degrades gracefully -- see ops/detect.py --
        # but must never degrade silently)
        self.candidate_overflow_count = 0
        self._overflow_logged = False

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Retune reset (transmission.cpp:42-55 resetBuffers)."""
        self._signals.clear()
        self._history = deque(
            np.zeros((self._fft_size,), dtype=np.float32) for _ in range(self._grouping_y)
        )
        self._valid_mask = None

    def _compute_valid_mask(self) -> np.ndarray:
        if self._valid_mask is None:
            idx = np.arange(self._fft_size)
            freqs = np.fromiter(
                (self._index_to_frequency(int(i)) for i in idx), dtype=np.int64, count=self._fft_size
            )
            in_range = np.fromiter(
                (self._is_index_in_range(int(i)) for i in idx), dtype=bool, count=self._fft_size
            )
            ignored = np.zeros(self._fft_size, dtype=bool)
            for lo, hi in self._ignored_ranges:
                ignored |= (freqs >= lo) & (freqs <= hi)
            self._valid_mask = in_range & ~ignored
        return self._valid_mask

    # -- per-frame processing ---------------------------------------------

    def process(
        self, raw_row: np.ndarray, avg_row: np.ndarray, now_ms: int
    ) -> List[FrequencyFlush]:
        """One detection frame (transmission.cpp:57-68). raw_row is the
        noise-subtracted power row (the averager input in the reference);
        avg_row is the time+frequency smoothed row."""
        self._history.popleft()
        self._history.append(np.asarray(raw_row, dtype=np.float32))

        self._add_signals(avg_row, raw_row, now_ms)
        self._update_signals(avg_row, raw_row, now_ms)
        self._clear_signals(now_ms)
        return self._sorted_transmissions(now_ms)

    def _add_signals(self, avg: np.ndarray, raw: np.ndarray, now_ms: int) -> None:
        """transmission.cpp:88-111: threshold + mask, strongest-first,
        margin-dedup, history-vote seeding."""
        mask = self._compute_valid_mask()
        cand = np.nonzero((avg >= self._start_level) & mask)[0]
        if cand.size == 0:
            return
        cand = cand[np.argsort(-avg[cand], kind="stable")]
        for index in cand:
            index = int(index)
            if contains_with_margin(self._signals.keys(), index, self._group_size) is None:
                best = self._get_best_index(index)
                if best in self._signals:
                    continue  # std::map::insert no-op on existing key
                logger.info(
                    LABEL,
                    "signal: {}, start: {}, avg power: {}, raw power: {}",
                    format_frequency(self._index_to_frequency(best)),
                    format_frequency(
                        get_tuned_frequency(self._index_to_frequency(best), self._tuning_step)
                    ),
                    format_power(float(avg[best])),
                    format_power(float(raw[best])),
                )
                self._signals[best] = Signal(
                    now_ms,
                    self._start_level,
                    self._stop_level,
                    self._min_time_ms,
                    self._timeout_ms,
                    self._max_time_ms,
                )

    def _get_best_index(self, index: int) -> int:
        """Mode of windowed argmaxes over the NEWEST half of the raw history
        (transmission.cpp:132-154: rows [depth/2, depth), oldest-first)."""
        depth = len(self._history)
        votes: List[int] = []
        for i in range(depth // 2, depth):
            row = self._history[i]
            best = get_max_index(row, index, self._group_size)
            if row[best] >= self._start_level:
                votes.append(best)
        if not votes:
            # C++ reads uninitialized memory here; only reachable when the
            # triggering avg bin had no raw-row support. Seed at the candidate.
            return index
        return most_frequent_value(votes)

    def _update_signals(self, avg: np.ndarray, raw: np.ndarray, now_ms: int) -> None:
        """transmission.cpp:113-130: re-center measurement on the local argmax
        around each tracked key (the key itself does not move)."""
        for index, signal in self._signals.items():
            best_avg = get_max_index(avg, index, self._group_size)
            signal.new_data(best_avg, float(avg[best_avg]), now_ms)

    def _clear_signals(self, now_ms: int) -> None:
        """transmission.cpp:70-86: drop on quiet-timeout or 10-minute cap."""
        for index in [i for i, s in self._signals.items() if s.is_timeout(now_ms) or s.is_maximal_time(now_ms)]:
            signal = self._signals[index]
            logger.info(
                LABEL,
                "signal: {}, stop: {}, center: {}",
                format_frequency(self._index_to_frequency(index)),
                format_frequency(
                    get_tuned_frequency(self._index_to_frequency(index), self._tuning_step)
                ),
                format_frequency(self._index_to_frequency(signal.get_index())),
            )
            del self._signals[index]

    def _sorted_transmissions(self, now_ms: int) -> List[FrequencyFlush]:
        """transmission.cpp:166-176: keys sorted by power desc; shifts snapped
        to the tuning-step grid."""
        keys = sorted(self._signals.keys(), key=lambda i: -self._signals[i].power)
        return [
            (
                get_tuned_frequency(self._index_to_shift(i), self._tuning_step),
                self._signals[i].need_flush(now_ms),
            )
            for i in keys
        ]

    @property
    def active_count(self) -> int:
        return len(self._signals)

    # -- compact mode ------------------------------------------------------
    #
    # Device-side detection compaction (ops/detect.py): the per-bin math and
    # the history vote already happened on device; the host consumes top-K
    # candidates + per-key windowed argmaxes. Semantics match full mode
    # except two bounded cases documented in ops/detect.py.

    def current_keys(self, slots: int) -> np.ndarray:
        """Tracked keys padded to a fixed slot count (unused slots -1)."""
        keys = np.full(slots, -1, dtype=np.int32)
        for i, k in enumerate(sorted(self._signals.keys())[:slots]):
            keys[i] = k
        return keys

    def process_compact(
        self,
        cand_idx: np.ndarray,  # [K] i32 desc by value
        cand_val: np.ndarray,  # [K] f32
        cand_best: np.ndarray,  # [K] i32 device history vote
        cand_count: int,
        slot_keys: np.ndarray,  # [S] the keys the device computed argmax for
        key_val: np.ndarray,  # [S] f32
        key_idx: np.ndarray,  # [S] i32
        now_ms: int,
    ) -> List[FrequencyFlush]:
        """One frame in compact mode (mirrors process()).

        cand_* hold the union of plain top-K and margin-separated candidates
        (ops/detect.py); merge into a single strongest-first pass with the
        reference's ordering (desc value, lower index on ties).
        """
        capacity = len(cand_idx)
        if cand_count > capacity:
            # more above-level bins than candidate slots this frame: dense
            # clusters may defer a weak distinct signal to a later frame
            # (ops/detect.py bounded-divergence contract). Log once, count
            # always, so a saturated scene is visible.
            self.candidate_overflow_count += 1
            if not self._overflow_logged:
                self._overflow_logged = True
                logger.warn(
                    LABEL,
                    "candidate overflow: {} bins above start level exceed the "
                    "{} device candidate slots (raise detection_top_k if this "
                    "persists)",
                    int(cand_count),
                    capacity,
                )
        order = np.lexsort((cand_idx, -cand_val))
        seen_idx = set()

        for i in order:
            index = int(cand_idx[i])
            if cand_val[i] < self._start_level:
                break
            if index in seen_idx:
                continue
            seen_idx.add(index)
            if contains_with_margin(self._signals.keys(), index, self._group_size) is None:
                best = int(cand_best[i])
                if best in self._signals:
                    continue
                logger.info(
                    LABEL,
                    "signal: {}, start: {}, avg power: {}",
                    format_frequency(self._index_to_frequency(best)),
                    format_frequency(
                        get_tuned_frequency(self._index_to_frequency(best), self._tuning_step)
                    ),
                    format_power(float(cand_val[i])),
                )
                self._signals[best] = Signal(
                    now_ms,
                    self._start_level,
                    self._stop_level,
                    self._min_time_ms,
                    self._timeout_ms,
                    self._max_time_ms,
                )

        # updateSignals: exact for keys the device knew; signals added after
        # the block started fall back to the nearest candidate in-window
        slot_of = {int(sk): s for s, sk in enumerate(slot_keys) if sk >= 0}
        half = self._group_size // 2
        for index, signal in self._signals.items():
            if index in slot_of:
                s = slot_of[index]
                signal.new_data(int(key_idx[s]), float(key_val[s]), now_ms)
            else:
                in_win = np.abs(cand_idx - index) <= half
                in_win &= cand_val > -1.0e30  # exclude masked-out padding
                if np.any(in_win):
                    j = int(np.argmax(np.where(in_win, cand_val, -np.inf)))
                    signal.new_data(int(cand_idx[j]), float(cand_val[j]), now_ms)
                # else: no information this frame; defer to the next block

        self._clear_signals(now_ms)
        return self._sorted_transmissions(now_ms)
