"""Shadow-scoring canary: divergence accounting and the promotion gate.

The port's copy of ``detectmateservice_tpu/rollout/shadow.py``.

While a candidate shadows, the manager scores sampled traffic through BOTH
param sets and feeds the per-row results here. Two divergence views:

* **score deltas** — ``|candidate - live|`` per row, exported as the
  ``model_shadow_divergence`` histogram (the ``ModelCanaryDiverging``
  signal) and summarized as mean/max;
* **alert-decision flips** — rows where ``score > threshold`` disagrees
  between the two models. Deltas measure drift in the score space; flips
  measure what an operator would actually see change. Both must clear
  their gate.

The promotion gate is three-valued: ``wait`` until ``min_samples`` rows
have shadowed (a candidate must not promote off a handful of lucky rows),
then ``promote`` when mean-|delta| ≤ ``max_mean_delta`` AND the flip ratio
≤ ``max_flip_ratio``, else ``hold`` — the manager turns a hold into a
structured ``model_canary_holdback`` event and keeps serving the live
params. Pure host-side math, fully deterministic (pinned by
tests/test_torch_rollout.py against the JAX package's).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np


class ShadowEvaluator:
    def __init__(self, threshold: float, min_samples: int,
                 max_mean_delta: float, max_flip_ratio: float,
                 track_top: int = 0) -> None:
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1 (got {min_samples})")
        self.threshold = threshold
        self.min_samples = min_samples
        self.max_mean_delta = max_mean_delta
        self.max_flip_ratio = max_flip_ratio
        self.samples = 0
        self.delta_sum = 0.0
        self.delta_max = 0.0
        self.flips = 0
        # bounded worst-offender ledger (offline replay triage: WHICH
        # recorded rows moved the candidate — 0 keeps the live canary free)
        self.track_top = max(0, int(track_top))
        self._top: list = []        # (|delta|, row_id, live, cand) desc

    def observe(self, live_scores: np.ndarray,
                cand_scores: np.ndarray,
                row_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Account one shadow batch; returns the per-row ``|delta|`` array
        so the caller can feed the ``model_shadow_divergence`` histogram.
        ``row_ids`` (optional, aligned) labels rows in the worst-offender
        ledger when ``track_top`` is set — the WAL replay passes record
        sequence numbers so an operator can pull the exact traffic back
        out of the spool."""
        live = np.asarray(live_scores, np.float64)
        cand = np.asarray(cand_scores, np.float64)
        if live.shape != cand.shape:
            raise ValueError(
                f"live/candidate score shapes differ: {live.shape} vs "
                f"{cand.shape}")
        delta = np.abs(cand - live)
        self.samples += len(delta)
        self.delta_sum += float(delta.sum())
        self.delta_max = max(self.delta_max, float(delta.max(initial=0.0)))
        self.flips += int(((live > self.threshold)
                           != (cand > self.threshold)).sum())
        if self.track_top and len(delta):
            for i in np.argsort(delta)[::-1][:self.track_top]:
                self._top.append((float(delta[i]),
                                  row_ids[i] if row_ids is not None else None,
                                  float(live[i]), float(cand[i])))
            self._top.sort(key=lambda t: t[0], reverse=True)
            del self._top[self.track_top:]
        return delta

    @property
    def mean_delta(self) -> float:
        return self.delta_sum / self.samples if self.samples else 0.0

    @property
    def flip_ratio(self) -> float:
        return self.flips / self.samples if self.samples else 0.0

    def verdict(self) -> str:
        """``wait`` | ``promote`` | ``hold`` (see module docstring)."""
        if self.samples < self.min_samples:
            return "wait"
        if (self.mean_delta <= self.max_mean_delta
                and self.flip_ratio <= self.max_flip_ratio):
            return "promote"
        return "hold"

    def stats(self) -> Dict[str, Any]:
        doc = {
            "samples": self.samples,
            "min_samples": self.min_samples,
            "mean_abs_delta": round(self.mean_delta, 6),
            "max_abs_delta": round(self.delta_max, 6),
            "flips": self.flips,
            "flip_ratio": round(self.flip_ratio, 6),
            "gate": {"max_mean_delta": self.max_mean_delta,
                     "max_flip_ratio": self.max_flip_ratio},
            "verdict": self.verdict(),
        }
        if self.track_top:
            doc["top_divergent"] = [
                {"abs_delta": round(d, 6), "row_id": rid,
                 "live": round(lv, 6), "candidate": round(cv, 6)}
                for d, rid, lv, cv in self._top]
        return doc
