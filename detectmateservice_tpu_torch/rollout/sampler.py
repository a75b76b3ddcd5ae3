"""Reservoir sampler tapping the scorer dispatch path.

The port's copy of ``detectmateservice_tpu/rollout/sampler.py``: the same
seeded draws in the same order, so the same offers give the same reservoir
in both packages. The reservoir lives in two preallocated arrays (rows and
scores, slot for slot) instead of lists of per-row copies, so a snapshot is
one copy of each under the lock: the drift monitor snapshots every tick,
and the drain path's offers wait on the same lock.

The continuous fine-tuning loop (rollout/manager.py) needs a recent,
representative slice of live traffic without holding the stream: the
detector offers every dispatched token batch here (one call per
micro-batch, engine thread), a seeded ratio filter thins it, and a classic
Algorithm-R reservoir bounds memory to ``capacity`` rows no matter how long
the service runs. Rows are stored as copies of the tokenized [S] int32
vectors — raw bytes never enter the sampler, so its memory bound is exactly
``capacity * seq_len * 4`` bytes (plus one fp32 score per row when the
offerer pairs scores with rows — the dmdrift tap).

Determinism: the RNG is seeded, and both the ratio filter and the reservoir
replacement indices are drawn from it in offer order — the same offered
sequence always yields the same reservoir (pinned by tests/test_torch_rollout.py against the JAX package's).
The clock is injected for the same reason: ``last_offer_age`` (the
staleness the manager reports) is testable without sleeping.

Scores ride ALONGSIDE the rows (dmdrift, obs/drift.py): the drain path
offers each scored batch together with its [n] fp32 scores, and the
reservoir keeps row i's score in the same slot — ``snapshot(with_scores=
True)`` returns both copies under ONE lock acquisition, so a drift
evaluation never reads a reservoir mid-mutation or pairs a row with
another row's score. Rows offered without scores carry NaN.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np


class TrafficSampler:
    """Bounded reservoir over dispatched token rows (thread-safe: the
    engine thread offers, the rollout manager and drift monitor
    snapshot/drain)."""

    def __init__(self, capacity: int, ratio: float, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if capacity <= 0:
            raise ValueError(f"sampler capacity must be > 0 (got {capacity})")
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"sample ratio must be in (0, 1] (got {ratio})")
        self.capacity = capacity
        self.ratio = ratio
        self._rng = np.random.default_rng(seed)
        self._clock = clock
        self._lock = threading.Lock()
        # slot i holds row i and its score (NaN = none); allocated at the
        # first offer, when the row width is known
        self._rows: Optional[np.ndarray] = None
        self._row_scores = np.full(capacity, np.nan, np.float32)
        self._held = 0
        self._seen = 0          # rows that passed the ratio filter
        self._offered = 0       # rows offered by the dispatch path
        self._last_offer: Optional[float] = None

    def offer_rows(self, tokens: np.ndarray,
                   scores: Optional[np.ndarray] = None) -> int:
        """Offer an [n, S] token batch from the dispatch path (optionally
        with its [n] scores); returns how many rows entered the reservoir.
        One RNG draw per offered batch for the ratio filter plus one per
        accepted row once the reservoir is full — cheap enough for the hot
        path's per-micro-batch cadence. The RNG draw sequence is identical
        with and without scores, so pairing scores in cannot perturb which
        rows a seeded run samples."""
        n = len(tokens)
        if n == 0:
            return 0
        if scores is not None and len(scores) != n:
            raise ValueError(
                f"scores must pair 1:1 with tokens ({len(scores)} != {n})")
        with self._lock:
            self._offered += n
            self._last_offer = self._clock()
            picked = np.flatnonzero(self._rng.random(n) < self.ratio)
            if len(picked) and self._rows is None:
                self._rows = np.zeros((self.capacity,) + tuple(tokens.shape[1:]), np.int32)
            taken = 0
            for i in picked:
                self._seen += 1
                score = float(scores[i]) if scores is not None else float("nan")
                if self._held < self.capacity:
                    slot = self._held
                    self._held += 1
                else:
                    # Algorithm R: row j of the filtered stream replaces a
                    # reservoir slot with probability capacity/j
                    slot = int(self._rng.integers(0, self._seen))
                    if slot >= self.capacity:
                        continue
                self._rows[slot] = tokens[i]
                self._row_scores[slot] = score
                taken += 1
            return taken

    def __len__(self) -> int:
        with self._lock:
            return self._held

    def snapshot(self, with_scores: bool = False
                 ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        """Copy of the reservoir as one [k, S] matrix (empty → [0, 0]).
        With ``with_scores``, returns ``(rows, scores)`` — the [k] fp32
        score paired with each row (NaN where the offerer had none) —
        both copied under ONE lock acquisition, so a concurrent
        ``offer_rows`` can neither tear the matrix nor skew a row against
        another row's score."""
        with self._lock:
            if not self._held:
                rows = np.zeros((0, 0), np.int32)
                scores = np.zeros(0, np.float32)
            else:
                rows = self._rows[:self._held].copy()
                scores = self._row_scores[:self._held].copy()
        return (rows, scores) if with_scores else rows

    def last_offer_age(self) -> Optional[float]:
        with self._lock:
            if self._last_offer is None:
                return None
            return max(0.0, self._clock() - self._last_offer)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            scored = int(np.count_nonzero(~np.isnan(self._row_scores[:self._held])))
            return {
                "capacity": self.capacity,
                "ratio": self.ratio,
                "held_rows": self._held,
                "scored_rows": scored,
                "rows_offered": self._offered,
                "rows_sampled": self._seen,
                "last_offer_age_s": (
                    None if self._last_offer is None
                    else round(max(0.0, self._clock() - self._last_offer), 3)),
            }
