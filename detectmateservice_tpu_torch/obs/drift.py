"""Streaming drift detection over the rollout traffic reservoir.

The port's copy of ``detectmateservice_tpu/obs/drift.py``: the same
statistics, baseline document and hysteresis, over the port's reservoir
(``rollout/sampler.py``) and store (``rollout/store.py``); the cycle it
starts is the port's ``RolloutManager.run_cycle``.

The rollout subsystem already keeps a seeded reservoir of live token rows
(rollout/sampler.py), and each row rides with the score the dispatch path
produced for it. That pairing is the whole trick: the
drift monitor never re-scores anything. Every ``drift_interval_s`` it
snapshots the reservoir under one lock and compares the live score
distribution against a **baseline pinned at promote time**:

* ``stat="ks"`` — two-sample Kolmogorov–Smirnov distance between the live
  scores and the baseline's retained score sample (scale-free, sensitive
  to any distributional change);
* ``stat="psi"`` — population stability index over baseline-quantile bins
  (the classic "is this still the population I calibrated on" number;
  > 0.2 is the textbook act threshold);
* per-feature PSI over the token columns of the featurized rows, counting
  how many columns exceed ``drift_feature_psi_threshold`` — the
  attribution signal behind ``model_drift_features_over_threshold``.

The baseline is built from the reservoir at pin time and **persisted in
the CheckpointStore manifest** (``meta["drift_baseline"]`` on the live
entry, via ``store.update_meta``), so a restarted replica resumes against
the same reference distribution instead of silently re-pinning on
whatever traffic it boots into. When the live version changes (a promote
or rollback), the monitor re-pins from current traffic — the new model
was fine-tuned on the drifted stream, so the old reference is void — and
that re-pin is what drives stats back under threshold and emits
``drift_cleared`` after a promotion.

Detection is hysteresis-gated: ``drift_trigger_intervals`` consecutive
over-threshold evaluations before ``drift_detected``, and
``drift_clear_intervals`` consecutive clean ones before ``drift_cleared``
— a single noisy window flaps neither way. While drifting, the monitor
kicks ``RolloutManager.run_cycle(reason="drift")`` so retraining follows
the data instead of the interval clock, bounded by a
``drift_min_cycle_interval_s`` cooldown (and deferred, without consuming
the cooldown, while a candidate is already shadowing).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

LOGGER = logging.getLogger("detectmate.obs.drift")

_BASELINE_SCHEMA = "dmdrift-baseline-v1"
_BASELINE_META_KEY = "drift_baseline"
_PSI_BINS = 10          # baseline-quantile bins for PSI (deciles)
_PSI_EPS = 1e-4         # Laplace smoothing: no bin proportion is ever 0
_TOP_FEATURES = 8       # columns reported by /admin/drift attribution


# -- statistics ------------------------------------------------------------
def ks_statistic(baseline_sorted: np.ndarray, live: np.ndarray) -> float:
    """Two-sample Kolmogorov–Smirnov distance: sup |ECDF_base - ECDF_live|.

    ``baseline_sorted`` must be sorted ascending (the baseline stores it
    that way); ``live`` need not be. O((n+m) log(n+m)), no SciPy."""
    n, m = len(baseline_sorted), len(live)
    if n == 0 or m == 0:
        return 0.0
    live_sorted = np.sort(np.asarray(live, dtype=np.float64))
    grid = np.concatenate([baseline_sorted, live_sorted])
    cdf_base = np.searchsorted(baseline_sorted, grid, side="right") / n
    cdf_live = np.searchsorted(live_sorted, grid, side="right") / m
    return float(np.max(np.abs(cdf_base - cdf_live)))


def _bin_props(values: np.ndarray, interior_edges: np.ndarray) -> np.ndarray:
    """Laplace-smoothed bin proportions of ``values`` over the bins cut by
    ``interior_edges`` (open-ended first/last bin). len(edges)+1 bins."""
    bins = len(interior_edges) + 1
    if len(values) == 0:
        return np.full(bins, 1.0 / bins)
    idx = np.searchsorted(interior_edges, values, side="right")
    counts = np.bincount(idx, minlength=bins).astype(np.float64)
    counts += _PSI_EPS * len(values) + 1e-12
    return counts / counts.sum()


def psi(base_props: np.ndarray, live_values: np.ndarray,
        interior_edges: np.ndarray) -> float:
    """Population stability index of ``live_values`` against stored
    baseline bin proportions: sum((p_live - p_base) * ln(p_live/p_base)).
    Both sides are Laplace-smoothed, so the result is always finite."""
    live_props = _bin_props(np.asarray(live_values, np.float64),
                            interior_edges)
    base = np.maximum(np.asarray(base_props, np.float64), 1e-12)
    base = base / base.sum()
    return float(np.sum((live_props - base) * np.log(live_props / base)))


def warm_statistics() -> None:
    """Run each numpy path a tick takes (the baseline fit with its
    resampling, KS, PSI, the manifest document) once on a few synthetic
    values, and discard the results: the modules numpy loads at a first
    call load here, when the monitor starts, not inside a tick while
    traffic flows (on a gVisor host such a load held the whole process
    for 100-170 ms, ``PERF.md`` §6)."""
    values = np.arange(64, dtype=np.float64)
    base = DriftBaseline.fit(None, np.stack([values % 7, values], axis=1), values, keep=16,
                             pinned_unix=0.0)
    ks_statistic(base.scores, values[::-1])
    psi(base.score_props, values, base.score_edges)
    base.to_dict()


# -- baseline --------------------------------------------------------------
class DriftBaseline:
    """Frozen reference distribution: a retained (quantile-resampled)
    score sample plus quantile bin edges/proportions for the score and
    each token column. JSON round-trips through the manifest."""

    def __init__(self, version: Optional[int], scores: np.ndarray,
                 score_edges: np.ndarray, score_props: np.ndarray,
                 feature_edges: List[Optional[np.ndarray]],
                 feature_props: List[Optional[np.ndarray]],
                 source_rows: int, pinned_unix: float) -> None:
        self.version = version
        self.scores = np.asarray(scores, np.float64)        # sorted asc
        self.score_edges = np.asarray(score_edges, np.float64)
        self.score_props = np.asarray(score_props, np.float64)
        self.feature_edges = feature_edges
        self.feature_props = feature_props
        self.source_rows = int(source_rows)
        self.pinned_unix = float(pinned_unix)

    @classmethod
    def fit(cls, version: Optional[int], rows: np.ndarray,
            scores: np.ndarray, keep: int,
            pinned_unix: float) -> Optional["DriftBaseline"]:
        """Build a baseline from a reservoir snapshot; ``None`` when there
        are no finite scores to pin. ``keep`` bounds the retained score
        sample via even-quantile resampling (preserves the ECDF shape the
        KS statistic compares against)."""
        scores = np.asarray(scores, np.float64)
        finite = scores[np.isfinite(scores)]
        if len(finite) == 0:
            return None
        sample = np.sort(finite)
        if len(sample) > keep:
            sample = np.quantile(sample, np.linspace(0.0, 1.0, keep))
        edges = _quantile_edges(sample)
        props = _bin_props(sample, edges)
        feat_edges: List[Optional[np.ndarray]] = []
        feat_props: List[Optional[np.ndarray]] = []
        if rows is not None and rows.ndim == 2 and rows.shape[0] > 0:
            cols = np.asarray(rows, np.float64)
            for j in range(cols.shape[1]):
                e = _quantile_edges(cols[:, j])
                if len(e) < 2:      # (near-)constant column: PSI undefined
                    feat_edges.append(None)
                    feat_props.append(None)
                else:
                    feat_edges.append(e)
                    feat_props.append(_bin_props(cols[:, j], e))
        return cls(version, sample, edges, props, feat_edges, feat_props,
                   source_rows=len(finite), pinned_unix=pinned_unix)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": _BASELINE_SCHEMA,
            "version": self.version,
            "pinned_unix": round(self.pinned_unix, 3),
            "source_rows": self.source_rows,
            "scores": [round(float(v), 7) for v in self.scores],
            "score_edges": [round(float(v), 7) for v in self.score_edges],
            "score_props": [round(float(v), 7) for v in self.score_props],
            "feature_edges": [
                None if e is None else [float(v) for v in e]
                for e in self.feature_edges],
            "feature_props": [
                None if p is None else [round(float(v), 7) for v in p]
                for p in self.feature_props],
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "DriftBaseline":
        if doc.get("schema") != _BASELINE_SCHEMA:
            raise ValueError(
                f"drift baseline schema {doc.get('schema')!r}; this build "
                f"reads {_BASELINE_SCHEMA!r}")
        return cls(
            doc.get("version"),
            np.asarray(doc["scores"], np.float64),
            np.asarray(doc["score_edges"], np.float64),
            np.asarray(doc["score_props"], np.float64),
            [None if e is None else np.asarray(e, np.float64)
             for e in doc.get("feature_edges", [])],
            [None if p is None else np.asarray(p, np.float64)
             for p in doc.get("feature_props", [])],
            source_rows=int(doc.get("source_rows", 0)),
            pinned_unix=float(doc.get("pinned_unix", 0.0)))


def _quantile_edges(values: np.ndarray) -> np.ndarray:
    """Interior decile edges, deduplicated — integer-heavy columns (token
    ids) collapse tied quantiles instead of producing zero-width bins."""
    qs = np.linspace(0.0, 1.0, _PSI_BINS + 1)[1:-1]
    return np.unique(np.quantile(np.asarray(values, np.float64), qs))


# -- monitor ---------------------------------------------------------------
class _DriftCheck:
    """Health-check adapter: DEGRADED while the hysteresis gate is latched
    drifting (a model serving off-distribution traffic is a degraded
    replica, not a dead one)."""

    name = "model_drift"

    def __init__(self, owner: "DriftMonitor") -> None:
        self._owner = owner

    def evaluate(self, now: float) -> Tuple[str, str]:
        from ..engine.health import DEGRADED, PASS

        snap = self._owner.status()
        stats = snap["stats"]
        if snap["drifting"]:
            return DEGRADED, (
                f"score distribution drifted from baseline "
                f"v{snap['baseline'] and snap['baseline']['version']}: "
                f"ks={stats['ks']} psi={stats['psi']}")
        if snap["baseline"] is None:
            return PASS, "no baseline pinned yet (collecting traffic)"
        return PASS, (f"within baseline: ks={stats['ks']} "
                      f"psi={stats['psi']}")


class DriftMonitor:
    """Periodic drift evaluator over the rollout reservoir.

    Threading: ``start()`` runs ``tick()`` on a daemon thread every
    ``drift_interval_s``; tests call ``tick()`` directly with an injected
    clock. Reservoir reads are one-lock snapshots (sampler), manifest
    writes go through the store's own lock, and the monitor's mutable
    state is guarded by ``_lock`` — no lock is ever held across a
    reservoir read, a manifest write, or a rollout cycle."""

    def __init__(self, settings: Any, sampler: Any,
                 store: Optional[Any] = None, rollout: Optional[Any] = None,
                 labels: Optional[Dict[str, str]] = None,
                 monitor: Optional[Any] = None,
                 logger: Optional[logging.Logger] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time) -> None:
        self.settings = settings
        self.sampler = sampler
        self.store = store
        self.rollout = rollout
        self.labels = dict(labels or {})
        self.monitor = monitor
        self.logger = logger or LOGGER
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._baseline: Optional[DriftBaseline] = None
        self._baseline_persisted = False
        self._seen_live_version: Optional[int] = None
        self._drifting = False
        self._over_streak = 0
        self._under_streak = 0
        self._last_eval: Optional[Dict[str, Any]] = None
        self._last_eval_t: Optional[float] = None
        self._last_drift_cycle_t: Optional[float] = None
        self._ticks = 0
        self._history: List[Dict[str, Any]] = []
        self._gauges: Optional[Tuple[Any, Any, Any]] = None

    # -- metrics / events -------------------------------------------------
    def _metric_children(self) -> Tuple[Any, Any, Any]:
        if self._gauges is None:
            from ..engine import metrics as m

            self._gauges = (
                m.MODEL_DRIFT_SCORE().labels(stat="ks", **self.labels),
                m.MODEL_DRIFT_SCORE().labels(stat="psi", **self.labels),
                m.MODEL_DRIFT_FEATURES().labels(**self.labels))
        return self._gauges

    def _note(self, kind: str, level: int = logging.WARNING,
              **fields: Any) -> Dict[str, Any]:
        doc = {"kind": kind, **fields}
        with self._lock:
            self._history.append({**doc, "at_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(self._wall()))})
            del self._history[:-64]
        if self.monitor is not None:
            self.monitor.emit_event(dict(doc), level=level)
        else:
            self.logger.log(level, "drift event %s: %s", kind, doc)
        return doc

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        if self.monitor is not None:
            self.monitor.add_check(_DriftCheck(self))
        warm_statistics()
        self._halt.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="DriftMonitor")
        self._thread.start()

    def stop(self) -> None:
        self._halt.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=10)
        self._thread = None
        if self.monitor is not None:
            self.monitor.remove_check(_DriftCheck.name)

    def _run(self) -> None:
        interval = max(0.05, float(self.settings.drift_interval_s))
        while not self._halt.wait(interval):
            try:
                self.tick()
            except Exception:
                # containment boundary: a failed evaluation must not kill
                # the monitor thread — the next interval retries
                self.logger.exception("drift evaluation failed")

    # -- baseline management ----------------------------------------------
    def _load_persisted(self, version: int) -> Optional[DriftBaseline]:
        if self.store is None:
            return None
        try:
            doc = self.store.entry(version).get("meta", {})
            raw = doc.get(_BASELINE_META_KEY)
            if raw is None:
                return None
            return DriftBaseline.from_dict(raw)
        except Exception:
            self.logger.exception(
                "could not load persisted drift baseline for v%s", version)
            return None

    def _pin_baseline(self, version: Optional[int], rows: np.ndarray,
                      scores: np.ndarray, reason: str) -> bool:
        baseline = DriftBaseline.fit(
            version, rows, scores,
            keep=int(self.settings.drift_baseline_size),
            pinned_unix=self._wall())
        if baseline is None:
            return False
        persisted = False
        if self.store is not None and version is not None:
            try:
                self.store.update_meta(
                    version, **{_BASELINE_META_KEY: baseline.to_dict()})
                persisted = True
            except Exception:
                # a missing manifest entry (e.g. boot-time fit that never
                # hit the store) keeps the baseline memory-only
                self.logger.warning(
                    "drift baseline for v%s is memory-only "
                    "(no manifest entry)", version)
        with self._lock:
            self._baseline = baseline
            self._baseline_persisted = persisted
            self._over_streak = 0
            self._under_streak = 0
        self._note("drift_baseline_pinned", level=logging.INFO,
                   baseline_version=version, rows=baseline.source_rows,
                   persisted=persisted, reason=reason)
        return True

    def _sync_baseline(self, rows: np.ndarray, scores: np.ndarray) -> None:
        """Keep the baseline aligned with the live model version: load the
        persisted one on first sight of a version, re-pin from current
        traffic when the version changes, pin in-memory when there is no
        live version at all (boot-time fit)."""
        live = self.store.live_version() if self.store is not None else None
        with self._lock:
            seen = self._seen_live_version
            have = self._baseline is not None
        if have and seen == live:
            return
        if live is not None and (not have or seen != live):
            loaded = None
            if seen is None:        # first sight after (re)start: resume
                loaded = self._load_persisted(live)
            if loaded is not None:
                with self._lock:
                    self._baseline = loaded
                    self._baseline_persisted = True
                    self._over_streak = 0
                    self._under_streak = 0
                self._note("drift_baseline_pinned", level=logging.INFO,
                           baseline_version=live, rows=loaded.source_rows,
                           persisted=True, reason="resume")
            elif not self._pin_baseline(
                    live, rows, scores,
                    reason="promote" if seen is not None else "boot"):
                return              # not enough scored traffic yet; retry
        elif live is None and not have:
            if not self._pin_baseline(None, rows, scores, reason="boot"):
                return
        with self._lock:
            self._seen_live_version = live

    # -- evaluation -------------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """One evaluation: snapshot the reservoir, sync the baseline to
        the live version, compute KS/PSI/per-feature PSI, update the
        hysteresis gate, export gauges, maybe kick an early cycle."""
        with self._lock:
            self._ticks += 1
        rows, scores = self.sampler.snapshot(with_scores=True)
        finite = np.isfinite(scores)
        live_scores = np.asarray(scores, np.float64)[finite]
        live_rows = rows[finite] if rows.shape[0] == len(scores) else rows
        self._sync_baseline(live_rows, live_scores)
        with self._lock:
            baseline = self._baseline
        if baseline is None or len(live_scores) < int(
                self.settings.drift_min_rows):
            return self.status()

        ks = ks_statistic(baseline.scores, live_scores)
        score_psi = psi(baseline.score_props, live_scores,
                        baseline.score_edges)
        feature_psis: List[Tuple[int, float]] = []
        if (live_rows.ndim == 2 and live_rows.shape[0] > 0
                and live_rows.shape[1] == len(baseline.feature_edges)):
            cols = np.asarray(live_rows, np.float64)
            for j, (e, p) in enumerate(zip(baseline.feature_edges,
                                           baseline.feature_props)):
                if e is None:
                    continue
                feature_psis.append((j, psi(p, cols[:, j], e)))
        feat_threshold = float(self.settings.drift_feature_psi_threshold)
        features_over = sum(1 for _, v in feature_psis if v > feat_threshold)
        over = (ks > float(self.settings.drift_ks_threshold)
                or score_psi > float(self.settings.drift_psi_threshold))

        g_ks, g_psi, g_feat = self._metric_children()
        g_ks.set(ks)
        g_psi.set(score_psi)
        g_feat.set(features_over)

        top = sorted(feature_psis, key=lambda t: -t[1])[:_TOP_FEATURES]
        evaluation = {
            "ks": round(ks, 4), "psi": round(score_psi, 4),
            "features_over_threshold": features_over,
            "evaluated_rows": int(len(live_scores)),
            "top_features": [{"column": j, "psi": round(v, 4)}
                             for j, v in top],
        }
        detected = cleared = False
        with self._lock:
            self._last_eval = evaluation
            self._last_eval_t = self._clock()
            if over:
                self._over_streak += 1
                self._under_streak = 0
                if (not self._drifting and self._over_streak
                        >= int(self.settings.drift_trigger_intervals)):
                    self._drifting = detected = True
            else:
                self._under_streak += 1
                self._over_streak = 0
                if (self._drifting and self._under_streak
                        >= int(self.settings.drift_clear_intervals)):
                    self._drifting = False
                    cleared = True
            drifting = self._drifting
        if detected:
            self._note("drift_detected", level=logging.WARNING,
                       baseline_version=baseline.version, **evaluation)
        if cleared:
            self._note("drift_cleared", level=logging.INFO,
                       baseline_version=baseline.version,
                       ks=evaluation["ks"], psi=evaluation["psi"])
        if drifting:
            self._maybe_kick_cycle()
        return self.status()

    def _maybe_kick_cycle(self) -> None:
        """Sustained drift pulls the next fine-tune cycle forward, bounded
        by the cooldown. A shadowing candidate defers WITHOUT consuming
        the cooldown — the kick retries next tick once the gate resolves."""
        rollout = self.rollout
        if rollout is None:
            return
        cooldown = float(self.settings.drift_min_cycle_interval_s)
        now = self._clock()
        with self._lock:
            last = self._last_drift_cycle_t
        if last is not None and now - last < cooldown:
            return
        info = rollout.run_cycle(reason="drift")
        if info.get("skipped"):
            self.logger.info("drift cycle deferred: %s", info["skipped"])
            return
        with self._lock:
            self._last_drift_cycle_t = now
        self._note("drift_cycle", level=logging.INFO,
                   cycle={k: v for k, v in info.items()
                          if k in ("version", "reason", "skipped")})

    # -- introspection ----------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The ``GET /admin/drift`` document."""
        with self._lock:
            baseline = self._baseline
            base_doc = None
            if baseline is not None:
                base_doc = {
                    "version": baseline.version,
                    "pinned_unix": round(baseline.pinned_unix, 3),
                    "source_rows": baseline.source_rows,
                    "persisted": self._baseline_persisted,
                }
            evaluation = dict(self._last_eval or {
                "ks": None, "psi": None, "features_over_threshold": None,
                "evaluated_rows": 0, "top_features": []})
            last_t = self._last_eval_t
            last_cycle = self._last_drift_cycle_t
            doc = {
                "drifting": self._drifting,
                "baseline": base_doc,
                "stats": evaluation,
                "hysteresis": {
                    "over_streak": self._over_streak,
                    "under_streak": self._under_streak,
                    "trigger_intervals": int(
                        self.settings.drift_trigger_intervals),
                    "clear_intervals": int(
                        self.settings.drift_clear_intervals),
                },
                "thresholds": {
                    "ks": float(self.settings.drift_ks_threshold),
                    "psi": float(self.settings.drift_psi_threshold),
                    "feature_psi": float(
                        self.settings.drift_feature_psi_threshold),
                },
                "ticks": self._ticks,
                "events": list(self._history[-16:]),
            }
        now = self._clock()
        doc["last_eval_age_s"] = (
            None if last_t is None else round(max(0.0, now - last_t), 3))
        doc["cycle"] = {
            "cooldown_s": float(self.settings.drift_min_cycle_interval_s),
            "last_drift_cycle_age_s": (
                None if last_cycle is None
                else round(max(0.0, now - last_cycle), 3)),
        }
        doc["sampler"] = self.sampler.stats()
        return doc
