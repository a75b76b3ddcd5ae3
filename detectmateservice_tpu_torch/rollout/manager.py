"""The model-lifecycle orchestrator behind ``/admin/model``.

The port's copy of ``detectmateservice_tpu/rollout/manager.py``. One manager
per service wraps the detector's rollout seams
(``library/detectors/torch_scorer.py``) into the continuous loop:

1. **sample** — a :class:`~.sampler.TrafficSampler` taps the drain path
   (the detector offers every drained batch's rows with their scores);
2. **fine-tune** — every ``rollout_interval_s`` the manager fine-tunes a
   CANDIDATE on the sampled reservoir: a clone of the live module and its
   optimizer state, trained on the manager thread; the live weights are
   never touched and the dispatch path keeps serving;
3. **checkpoint** — the candidate lands in the versioned
   :class:`~.store.CheckpointStore` (crash-atomic save + manifest commit,
   keep-N rotation) BEFORE it shadows, so a held-back canary is still
   inspectable and a fleet deploy has an artifact;
4. **shadow** — sampled rows score through the live warm set AND the
   candidate; the :class:`~.shadow.ShadowEvaluator` gates promotion on
   score deltas + alert-decision flips, exported as
   ``model_shadow_divergence``;
5. **swap** — a promoted candidate is copied into the live weights' storage
   in place (every captured CUDA graph stays valid, so a float swap
   captures nothing; a bucket the stored warm-set spec adds is captured
   under an expected ``model_swap`` context); a diverging one becomes a
   structured ``model_canary_holdback`` event instead.

Admin verbs (``web/router.py`` ``/admin/model``): ``promote`` (force the
current canary, or install a stored version), ``rollback`` (previous live
version), ``pin``/``unpin`` (freeze the served version; cycles suspend while
pinned), ``cycle`` (run one sample→fine-tune→shadow cycle now).

Every device call goes through the detector's seams, which serialize with
the dispatch path on the detector's stream (``graphs.py``); a seam that
fails raises, and nothing retries on the CPU: the thread's cycle counts
``failed``, a gate that refuses counts ``holdback``, as in the JAX manager.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .sampler import TrafficSampler
from .shadow import ShadowEvaluator
from .store import CheckpointStore, StoreError


class RolloutError(RuntimeError):
    pass


class _ShadowRun:
    """One candidate under shadow: params + evaluator + bookkeeping."""

    def __init__(self, version: int, params: Any, opt_state: Any,
                 evaluator: ShadowEvaluator, started: float,
                 source: str, timeout_s: float) -> None:
        self.version = version
        self.params = params
        self.opt_state = opt_state
        self.evaluator = evaluator
        self.started = started
        self.source = source      # "fine_tune" | "injected"
        self.timeout_s = timeout_s


class RolloutManager:
    def __init__(self, detector: Any, settings: Any,
                 labels: Dict[str, str], monitor: Any = None,
                 logger: Optional[logging.Logger] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time) -> None:
        self.detector = detector
        self.settings = settings
        self.labels = dict(labels)
        self.monitor = monitor
        self.logger = logger or logging.getLogger(__name__)
        self._clock = clock
        self._wall = wall_clock
        self.store = CheckpointStore(settings.rollout_dir,
                                     keep=settings.rollout_keep_checkpoints,
                                     clock=wall_clock)
        self.sampler = TrafficSampler(settings.rollout_sample_capacity,
                                      settings.rollout_sample_ratio,
                                      seed=getattr(settings, "seed", 0) or 0,
                                      clock=clock)
        detector.set_rollout_sampler(self.sampler)
        # _lock guards the cheap state below; _op_lock serializes the
        # heavyweight verbs (cycle / shadow tick / promote / rollback) so
        # an admin POST and the manager thread can never interleave a swap
        # with a fine-tune. Device work happens under _op_lock only — never
        # under _lock, which admin GETs take.
        self._lock = threading.Lock()
        self._op_lock = threading.Lock()
        self._shadow: Optional[_ShadowRun] = None
        self._history: List[Dict[str, Any]] = []
        self._last_cycle_info: Optional[Dict[str, Any]] = None
        self._last_cycle_t: Optional[float] = None
        self._started_wall = wall_clock()
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._swap_children: Dict[str, Any] = {}
        self._divergence_hist = None
        self._version_child: Optional[tuple] = None
        self._export_metrics()

    # -- metrics ----------------------------------------------------------
    def _export_metrics(self) -> None:
        from ..engine import metrics as m

        self._divergence_hist = m.MODEL_SHADOW_DIVERGENCE().labels(
            **self.labels)
        # scrape-time checkpoint age: survives a wedged manager thread, and
        # "no checkpoint yet" ages from manager start — a trainer that
        # never produces one must look stale, not fresh
        age_gauge = m.MODEL_CHECKPOINT_AGE().labels(**self.labels)
        age_gauge.set_function(
            lambda: max(0.0, self._wall() - (
                self.store.newest_created_unix() or self._started_wall)))
        self._set_version_info(self.store.live_version() or 0)

    def _set_version_info(self, version: int) -> None:
        from ..engine import metrics as m

        model = getattr(self.detector.config, "model", "unknown")
        gauge = m.MODEL_VERSION_INFO()
        new_key = (self.labels.get("component_type"),
                   self.labels.get("component_id"), str(version), model)
        old = self._version_child
        if old is not None and old != new_key:
            try:
                gauge.remove(*old)
            except KeyError:
                pass
        gauge.labels(*new_key).set(1)
        self._version_child = new_key

    def _count_swap(self, result: str) -> None:
        child = self._swap_children.get(result)
        if child is None:
            from ..engine import metrics as m

            child = m.MODEL_SWAPS().labels(result=result, **self.labels)
            self._swap_children[result] = child
        child.inc()

    # -- events / history -------------------------------------------------
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
            self.logger.log(level, "rollout event %s: %s", kind, doc)
        return doc

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._halt.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ModelRollout")
        self._thread.start()

    def stop(self) -> None:
        self._halt.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=10)
        self._thread = None

    def _shadow_ref(self) -> Optional[_ShadowRun]:
        with self._lock:
            return self._shadow

    def _run(self) -> None:
        interval = max(0.05, float(self.settings.rollout_interval_s))
        tick = min(1.0, interval / 4)
        while not self._halt.wait(tick):
            try:
                if self._shadow_ref() is not None:
                    self.shadow_tick()
                elif self._due():
                    self.run_cycle(reason="interval")
            except Exception:
                # containment boundary: a failed cycle must not kill the
                # lifecycle thread — the next interval retries
                self.logger.exception("rollout cycle failed")
                self._count_swap("failed")

    def _due(self) -> bool:
        with self._lock:
            last = self._last_cycle_t
        if self.store.pinned_version() is not None:
            return False
        now = self._clock()
        if last is None:
            with self._lock:
                # anchor the first interval at manager start, not epoch
                self._last_cycle_t = now
            return False
        return now - last >= float(self.settings.rollout_interval_s)

    # -- the cycle --------------------------------------------------------
    def run_cycle(self, reason: str = "manual",
                  block: bool = False) -> Dict[str, Any]:
        """One sample→fine-tune→checkpoint→shadow cycle. With ``block``,
        shadow ticks run inline until the gate resolves (the smoke/soak
        path); otherwise the manager thread ticks the shadow forward."""
        with self._op_lock:
            info = self._start_cycle_locked(reason)
        if not block or info.get("skipped") or self._shadow_ref() is None:
            return info
        deadline = self._clock() + float(self.settings.rollout_shadow_timeout_s)
        while self._shadow_ref() is not None:
            outcome = self.shadow_tick()
            if outcome is not None:
                info["outcome"] = outcome
                break
            if self._clock() > deadline:
                with self._op_lock:
                    if self._shadow_ref() is not None:
                        info["outcome"] = self._resolve_shadow(
                            "hold", "shadow timeout")
                break
            time.sleep(0.05)
        if "outcome" not in info:
            # the manager thread's own tick may have resolved the shadow
            # between our checks — its outcome is the cycle's outcome
            with self._lock:
                info["outcome"] = self._last_cycle_info
        return info

    def _start_cycle_locked(self, reason: str) -> Dict[str, Any]:
        with self._lock:
            self._last_cycle_t = self._clock()
        if self._shadow_ref() is not None:
            return {"skipped": "a candidate is already shadowing"}
        if self.store.pinned_version() is not None:
            return {"skipped": f"pinned to v{self.store.pinned_version()}"}
        if not self.detector.rollout_ready():
            return {"skipped": "detector not fitted yet"}
        rows = self.sampler.snapshot()
        if len(rows) < int(self.settings.rollout_min_fit_rows):
            return {"skipped": f"only {len(rows)} sampled rows "
                               f"(need {self.settings.rollout_min_fit_rows})"}
        version = self.store.allocate_version()
        t0 = self._clock()
        params, opt_state, fit_info = self.detector.rollout_fine_tune(
            rows, epochs=int(self.settings.rollout_train_epochs),
            seed=version)
        ckpt_dir = str(self.store.version_dir(version))
        self.detector.save_params_checkpoint(ckpt_dir, params, opt_state)
        meta = {"source": "fine_tune", "reason": reason,
                "rows": int(len(rows)),
                "model": getattr(self.detector.config, "model", "unknown"),
                **fit_info}
        # persist the warm-set spec: a promote on a RESTARTED replica
        # captures the buckets the recording boot warmed before it serves
        # the new weights, so no dispatch finds one of them missing
        warm_spec = self._warm_set_spec()
        if warm_spec is not None:
            meta["warm_set"] = warm_spec
        self.store.record(version, meta, status="shadowing")
        self._begin_shadow(version, params, opt_state, source="fine_tune")
        info = {"version": version, "rows": int(len(rows)),
                "fine_tune": fit_info,
                "elapsed_s": round(self._clock() - t0, 3)}
        self._note("model_candidate_ready", level=logging.INFO,
                   version=version, **meta)
        return info

    def _begin_shadow(self, version: int, params: Any, opt_state: Any,
                      source: str, min_samples: Optional[int] = None,
                      timeout_s: Optional[float] = None) -> None:
        evaluator = ShadowEvaluator(
            threshold=self.detector.live_threshold(),
            min_samples=int(min_samples
                            if min_samples is not None
                            else self.settings.rollout_min_shadow_samples),
            max_mean_delta=float(self.settings.rollout_max_mean_delta),
            max_flip_ratio=float(self.settings.rollout_max_flip_ratio))
        with self._lock:
            self._shadow = _ShadowRun(
                version, params, opt_state, evaluator, self._clock(), source,
                timeout_s=float(timeout_s if timeout_s is not None
                                else self.settings.rollout_shadow_timeout_s))

    def inject_candidate(self, params: Any, opt_state: Any,
                         tag: str = "injected",
                         min_samples: Optional[int] = None,
                         timeout_s: Optional[float] = None) -> int:
        """Test/soak seam: shadow an externally-built candidate (e.g. a
        deliberately-broken param tree) through the real gate. The optional
        gate overrides let a harness keep the canary shadowing — and the
        divergence series flowing — for a controlled window."""
        with self._op_lock:
            if self._shadow_ref() is not None:
                raise RolloutError("a candidate is already shadowing")
            version = self.store.allocate_version()
            ckpt_dir = str(self.store.version_dir(version))
            self.detector.save_params_checkpoint(ckpt_dir, params, opt_state)
            meta: Dict[str, Any] = {"source": tag}
            warm_spec = self._warm_set_spec()
            if warm_spec is not None:
                meta["warm_set"] = warm_spec
            self.store.record(version, meta, status="shadowing")
            self._begin_shadow(version, params, opt_state, source=tag,
                               min_samples=min_samples, timeout_s=timeout_s)
            return version

    def shadow_tick(self, max_rows: int = 256) -> Optional[Dict[str, Any]]:
        """Score one sampled batch through live + candidate params and feed
        the divergence accounting; resolves the gate when it can. Returns
        the resolution dict once resolved, else None."""
        with self._op_lock:
            shadow = self._shadow_ref()
            if shadow is None:
                return None
            rows = self.sampler.snapshot()
            if len(rows) == 0:
                return None
            if len(rows) > max_rows:
                idx = np.random.default_rng(shadow.evaluator.samples).choice(
                    len(rows), size=max_rows, replace=False)
                rows = rows[idx]
            live = self.detector.rollout_scores(None, rows)       # live params
            cand = self.detector.rollout_scores(shadow.params, rows)
            delta = shadow.evaluator.observe(live, cand)
            for value in delta:
                self._divergence_hist.observe(float(value))
            verdict = shadow.evaluator.verdict()
            if verdict == "wait":
                if self._clock() - shadow.started > shadow.timeout_s:
                    return self._resolve_shadow("hold", "shadow timeout")
                return None
            if verdict == "promote" and not bool(
                    self.settings.rollout_auto_promote):
                return self._resolve_shadow(
                    "hold", "auto-promote disabled; POST "
                            "/admin/model {action: promote} to cut over")
            return self._resolve_shadow(verdict, "gate")

    def _resolve_shadow(self, verdict: str, why: str) -> Dict[str, Any]:
        """Caller holds ``_op_lock`` (or is ``run_cycle(block=True)``'s
        inline loop, which does)."""
        shadow = self._shadow_ref()
        if shadow is None:
            return {"result": "idle"}
        stats = shadow.evaluator.stats()
        if verdict == "promote":
            swap = self._install(shadow.params, shadow.opt_state,
                                 shadow.version, source=shadow.source,
                                 warm_set=self._stored_warm_set(
                                     shadow.version))
            self.store.set_live(shadow.version, divergence=stats)
            self._count_swap("promoted")
            self._set_version_info(shadow.version)
            self._note("model_promoted", level=logging.INFO,
                       version=shadow.version, divergence=stats, swap=swap)
            outcome = {"result": "promoted", "version": shadow.version,
                       "divergence": stats, "swap": swap}
        else:
            self.store.set_status(shadow.version, "holdback",
                                  divergence=stats, why=why)
            self._count_swap("holdback")
            self._note("model_canary_holdback", version=shadow.version,
                       divergence=stats, why=why)
            outcome = {"result": "holdback", "version": shadow.version,
                       "divergence": stats, "why": why}
        with self._lock:
            self._shadow = None
            self._last_cycle_info = outcome
        return outcome

    def _warm_set_spec(self) -> Optional[Dict[str, Any]]:
        """The detector's live warm-set spec (None for components without
        one)."""
        spec_fn = getattr(self.detector, "warm_set_spec", None)
        if not callable(spec_fn):
            return None
        try:
            return spec_fn()
        # the spec is manifest metadata: it must not block a rollout cycle
        except Exception:  # noqa: BLE001
            return None

    def _stored_warm_set(self, version: int) -> Optional[Dict[str, Any]]:
        """The warm-set spec recorded with a stored version, if any."""
        try:
            return self.store.entry(version).get("meta", {}).get("warm_set")
        # an absent entry or a legacy manifest: the install keeps the live set
        except Exception:  # noqa: BLE001
            return None

    def _install(self, params: Any, opt_state: Any, version: int,
                 source: str,
                 warm_set: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        swap = self.detector.install_candidate(params, opt_state,
                                               version=version,
                                               warm_set=warm_set)
        swap["source"] = source
        return swap

    # -- admin verbs ------------------------------------------------------
    def promote(self, version: Optional[int] = None) -> Dict[str, Any]:
        """Force-promote: the current shadow candidate (``version=None``)
        or a stored version (every replica on a shared store can promote
        the same number)."""
        with self._op_lock:
            if version is None:
                if self._shadow_ref() is None:
                    raise RolloutError(
                        "no candidate is shadowing; pass a version to "
                        "promote from the store")
                return self._resolve_shadow("promote", "operator promote")
            return self._install_version(version, action="promote")

    def rollback(self) -> Dict[str, Any]:
        with self._op_lock:
            target = self.store.previous_live()
            if target is None:
                raise RolloutError("no superseded version to roll back to")
            live = self.store.live_version()
            outcome = self._install_version(target, action="rollback")
            if live is not None:
                try:
                    self.store.set_status(live, "rolled_back")
                except StoreError:
                    pass
            return outcome

    def _install_version(self, version: int, action: str) -> Dict[str, Any]:
        """Load a stored version and hot-swap it in (promote-by-number and
        rollback share this path)."""
        entry = self.store.entry(version)          # StoreError → HTTP 400
        directory = str(self.store.root / entry["dir"])
        params, opt_state, meta = self.detector.load_params_checkpoint(
            directory)
        swap = self._install(params, opt_state, version, source=action,
                             warm_set=entry.get("meta", {}).get("warm_set"))
        self.store.set_live(version)
        result = "promoted" if action == "promote" else "rolled_back"
        self._count_swap(result)
        self._set_version_info(version)
        # literal kinds (not f"model_{result}") so the DM-E event-contract
        # analyzer can extract both from the AST
        self._note("model_promoted" if action == "promote"
                   else "model_rolled_back",
                   level=logging.INFO, version=version,
                   action=action, swap=swap)
        outcome = {"result": result, "version": version, "swap": swap}
        with self._lock:
            self._last_cycle_info = outcome
        return outcome

    def pin(self, version: Optional[int] = None) -> Dict[str, Any]:
        """Pin the served model: cycles suspend and auto-promote stops
        until ``unpin``. With a version, that version is installed first."""
        with self._op_lock:
            outcome: Dict[str, Any] = {"result": "pinned"}
            if version is not None and version != self.store.live_version():
                outcome["install"] = self._install_version(version,
                                                           action="promote")
            pin_version = (version if version is not None
                           else self.store.live_version())
            if pin_version is None:
                raise RolloutError("nothing live to pin; promote first")
            self.store.pin(pin_version)
            self._count_swap("pinned")
            self._note("model_pinned", level=logging.INFO,
                       version=pin_version)
            outcome["version"] = pin_version
            return outcome

    def unpin(self) -> Dict[str, Any]:
        with self._op_lock:
            self.store.pin(None)
            self._note("model_unpinned", level=logging.INFO)
            return {"result": "unpinned"}

    # -- status -----------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            shadow = self._shadow
            shadow_doc = None
            if shadow is not None:
                shadow_doc = {"version": shadow.version,
                              "source": shadow.source,
                              "age_s": round(self._clock() - shadow.started,
                                             1),
                              **shadow.evaluator.stats()}
            last = self._last_cycle_info
            history = list(reversed(self._history))
        return {
            "enabled": True,
            "live_version": self.store.live_version(),
            "pinned_version": self.store.pinned_version(),
            "detector_version": self.detector.model_version(),
            "interval_s": float(self.settings.rollout_interval_s),
            "auto_promote": bool(self.settings.rollout_auto_promote),
            "shadow": shadow_doc,
            "last_outcome": last,
            "sampler": self.sampler.stats(),
            "store": {"root": str(self.store.root),
                      "keep": self.store.keep,
                      "versions": [e["version"]
                                   for e in self.store.history()]},
            "history": history,
        }

    def history(self, limit: Optional[int] = None) -> Dict[str, Any]:
        return {"checkpoints": self.store.history(limit),
                "live_version": self.store.live_version(),
                "pinned_version": self.store.pinned_version()}
