"""Calibrated per-replica capacity model + SLO burn-rate attribution.

The port's copy of ``detectmateservice_tpu/obs/capacity.py``. Capacity
answers one operator question ahead of time: *how many lines per second can
THIS replica actually score, and how close is the offered load to that
ceiling?* Two measurement modes feed one model:

* **Traffic arithmetic** (the normal mode): the detector's capacity tap
  (``set_capacity_tap``, ``library/detectors/torch_scorer.py``) reports
  every observed batch as ``(rows, device_seconds)``. Over a sliding
  ``capacity_window_s`` window, modeled capacity is simply
  ``sum(rows) / sum(device_seconds)`` — what the scorer demonstrably
  sustains when the device is busy — and the offered rate is
  ``sum(rows) / window``.
* **Idle micro-probe**: with no batch observed for
  ``capacity_probe_idle_s``, the monitor wall-times one bounded
  ``rollout_scores(None, synthetic_rows)`` burst (``capacity_probe_rows``
  rows through the warm set's train-bucket graph, an expected ``shadow``
  ledger context: no capture), so a freshly-booted or night-idle replica
  still publishes a calibrated number instead of 0. A probe that fails is
  logged and yields no number; the model keeps its last value.

``replica_capacity_lines_per_s`` and ``capacity_headroom_ratio``
(offered ÷ capacity) are exported per replica.

:class:`SloTracker` is the threadless half: it rings counter snapshots of
the pipeline's e2e latency histogram and per-stage dwell sums (the
``pipeline_*`` series the engines of a traced pipeline observe,
``engine_trace``) and the detector's processing, queue-wait and device
sums, and computes multi-window error ratios and burn rates on demand for
``GET /admin/slo``. Without tracing the e2e counts stay 0, every burn
window reports ``None`` and the dwell attribution is empty.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

import numpy as np

LOGGER = logging.getLogger("detectmate.obs.capacity")

# the SLO the burn math is anchored to — keep in lockstep with the
# PipelineLatencyBudgetBurn* alerts (ops/alerts.yml) and the
# slo:pipeline_e2e_error_ratio:* recording rules (ops/recording_rules.yml):
# a completed trace is "good" iff its e2e latency lands in the le="1.0"
# bucket, and the error budget is 1% of traces per window.
SLO_LATENCY_LE = "1.0"
SLO_ERROR_BUDGET = 0.01
SLO_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("5m", 300.0), ("30m", 1800.0), ("1h", 3600.0), ("6h", 21600.0))


class CapacityMonitor:
    """Sliding-window capacity model over the detector's batch tap.

    ``on_batch`` is the hot-path entry (one lock + deque append per
    drained micro-batch); ``tick()`` runs the model on the monitor thread
    (or directly from tests, with an injected clock)."""

    def __init__(self, detector: Any, settings: Any,
                 labels: Optional[Dict[str, str]] = None,
                 logger: Optional[logging.Logger] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.detector = detector
        self.settings = settings
        self.labels = dict(labels or {})
        self.logger = logger or LOGGER
        self._clock = clock
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._batches: Deque[Tuple[float, int, float]] = deque()
        self._last_batch_t: Optional[float] = None
        self._started_t = self._clock()
        self._capacity: Optional[float] = None
        self._capacity_source = "none"
        self._offered: float = 0.0
        self._headroom: float = 0.0
        self._last_probe: Optional[Dict[str, Any]] = None
        self._ticks = 0
        self._probe_rng = np.random.default_rng(0)
        self._gauges: Optional[Tuple[Any, Any]] = None

    def _metric_children(self) -> Tuple[Any, Any]:
        if self._gauges is None:
            from ..engine import metrics as m

            self._gauges = (m.REPLICA_CAPACITY().labels(**self.labels),
                            m.CAPACITY_HEADROOM().labels(**self.labels))
        return self._gauges

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        attach = getattr(self.detector, "set_capacity_tap", None)
        if attach is not None:
            attach(self.on_batch)
        self._halt.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="CapacityMonitor")
        self._thread.start()

    def stop(self) -> None:
        self._halt.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=10)
        self._thread = None
        detach = getattr(self.detector, "set_capacity_tap", None)
        if detach is not None:
            detach(None)

    def _run(self) -> None:
        interval = max(0.05, float(self.settings.capacity_interval_s))
        while not self._halt.wait(interval):
            try:
                self.tick()
            except Exception:
                # containment boundary: a failed model update must not
                # kill the monitor thread — the next interval retries
                self.logger.exception("capacity tick failed")

    # -- measurement ------------------------------------------------------
    def on_batch(self, n_rows: int, device_s: float) -> None:
        """The detector's capacity tap: one call per observed batch, any
        dispatch path. Kept to one lock + one append — this rides the
        drain path."""
        now = self._clock()
        with self._lock:
            self._batches.append((now, int(n_rows), float(device_s)))
            self._last_batch_t = now

    def _window_sums(self, now: float) -> Tuple[int, float, int]:
        """Prune to the window; return (rows, device_seconds, batches)."""
        horizon = now - float(self.settings.capacity_window_s)
        with self._lock:
            while self._batches and self._batches[0][0] < horizon:
                self._batches.popleft()
            rows = sum(b[1] for b in self._batches)
            dev = sum(b[2] for b in self._batches)
            return rows, dev, len(self._batches)

    def tick(self) -> Dict[str, Any]:
        """One model update: window arithmetic when the device was busy,
        an idle micro-probe when it wasn't, last-known capacity otherwise."""
        now = self._clock()
        rows, dev, batches = self._window_sums(now)
        # offered rate over the window the replica has actually existed for
        window = min(float(self.settings.capacity_window_s),
                     max(1e-3, now - self._started_t))
        offered = rows / window
        capacity: Optional[float] = None
        source = "held"
        if dev > 1e-4 and rows > 0:
            capacity = rows / dev
            source = "traffic"
        else:
            with self._lock:
                last_t = self._last_batch_t
            idle_for = now - (last_t if last_t is not None
                              else self._started_t)
            if idle_for >= float(self.settings.capacity_probe_idle_s):
                probed = self.probe_now()
                if probed is not None:
                    capacity = probed
                    source = "probe"
        with self._lock:
            if capacity is not None:
                self._capacity = capacity
                self._capacity_source = source
            self._offered = offered
            cap = self._capacity
            self._headroom = (offered / cap) if cap else 0.0
            headroom = self._headroom
            self._ticks += 1
        g_cap, g_head = self._metric_children()
        g_cap.set(cap or 0.0)
        g_head.set(headroom)
        return {"capacity_lines_per_s": cap, "offered_lines_per_s": offered,
                "headroom_ratio": headroom, "source": source,
                "window_rows": rows, "window_device_s": round(dev, 6),
                "window_batches": batches}

    def probe_now(self) -> Optional[float]:
        """Bounded closed-loop micro-probe: wall-time one
        ``rollout_scores`` burst of synthetic rows on the warm
        train-bucket shape. Returns lines/s, or None when the scorer
        can't serve the probe (not fitted, sharded, mid-fit)."""
        ready = getattr(self.detector, "rollout_ready", None)
        if ready is None or not ready():
            return None
        cfg = self.detector.config
        n = int(self.settings.capacity_probe_rows)
        tokens = self._probe_rng.integers(
            0, max(2, int(cfg.vocab_size)), size=(n, int(cfg.seq_len)),
            dtype=np.int32)
        t0 = time.perf_counter()
        try:
            self.detector.rollout_scores(None, tokens)
        except Exception:
            self.logger.exception("capacity probe failed")
            return None
        dt = max(1e-6, time.perf_counter() - t0)
        rate = n / dt
        with self._lock:
            self._last_probe = {"rows": n, "seconds": round(dt, 6),
                                "lines_per_s": round(rate, 3)}
        return rate

    # -- introspection ----------------------------------------------------
    def status(self) -> Dict[str, Any]:
        now = self._clock()
        rows, dev, batches = self._window_sums(now)
        with self._lock:
            last_t = self._last_batch_t
            doc = {
                "capacity_lines_per_s": (
                    None if self._capacity is None
                    else round(self._capacity, 3)),
                "capacity_source": self._capacity_source,
                "offered_lines_per_s": round(self._offered, 3),
                "headroom_ratio": round(self._headroom, 4),
                "window_s": float(self.settings.capacity_window_s),
                "window_rows": rows,
                "window_device_s": round(dev, 6),
                "window_batches": batches,
                "last_probe": self._last_probe,
                "ticks": self._ticks,
            }
        doc["last_batch_age_s"] = (
            None if last_t is None else round(max(0.0, now - last_t), 3))
        return doc


# -- SLO burn-rate attribution ---------------------------------------------
class SloTracker:
    """Threadless multi-window burn-rate estimator over this process's own
    metric registry.

    Every ``observe()`` rings a counter snapshot (e2e latency count +
    under-SLO bucket, per-stage dwell sums, detector queue/device/process
    sums); ``snapshot()`` observes and then differences the ring at each
    SLO window to report error ratios, burn rates, and where the latency
    budget is being spent. ``GET /admin/slo`` calls it on demand, so a
    replica that is never asked pays nothing; history is honest — each
    window reports the span it actually covered."""

    RING = 1024

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: Deque[Tuple[float, Dict[str, Any]]] = deque(
            maxlen=self.RING)

    # -- collection -------------------------------------------------------
    @staticmethod
    def _collect() -> Dict[str, Any]:
        from ..engine import metrics as m

        out: Dict[str, Any] = {"e2e_count": 0.0, "e2e_under": 0.0,
                               "dwell": {}, "transit_s": 0.0,
                               "process_s": 0.0, "queue_wait_s": 0.0,
                               "device_s": 0.0}
        collectors = (
            ("pipeline_e2e_latency_seconds", m.PIPELINE_E2E_LATENCY),
            ("pipeline_stage_dwell_seconds", m.PIPELINE_STAGE_DWELL),
            ("pipeline_transit_seconds", m.PIPELINE_TRANSIT),
            ("processing_duration_seconds", m.PROCESSING_DURATION),
            ("detector_queue_wait_seconds", m.BATCH_QUEUE_WAIT),
            ("detector_device_seconds", m.BATCH_DEVICE_SECONDS),
        )
        sums = {"pipeline_transit_seconds": "transit_s",
                "processing_duration_seconds": "process_s",
                "detector_queue_wait_seconds": "queue_wait_s",
                "detector_device_seconds": "device_s"}
        for base, accessor in collectors:
            for metric in accessor().collect():
                for sample in metric.samples:
                    if base == "pipeline_e2e_latency_seconds":
                        if sample.name == f"{base}_count":
                            out["e2e_count"] += sample.value
                        elif (sample.name == f"{base}_bucket"
                              and sample.labels.get("le") == SLO_LATENCY_LE):
                            out["e2e_under"] += sample.value
                    elif sample.name != f"{base}_sum":
                        continue
                    elif base == "pipeline_stage_dwell_seconds":
                        # attributed by stage type, as the JAX tracker does
                        stage = sample.labels.get("component_type", "unknown")
                        out["dwell"][stage] = out["dwell"].get(stage, 0.0) + sample.value
                    else:
                        out[sums[base]] += sample.value
        return out

    def observe(self) -> None:
        snap = self._collect()
        with self._lock:
            self._ring.append((self._clock(), snap))

    # -- reporting --------------------------------------------------------
    @staticmethod
    def _delta(new: Dict[str, Any], old: Dict[str, Any]) -> Dict[str, float]:
        count = max(0.0, new["e2e_count"] - old["e2e_count"])
        under = max(0.0, new["e2e_under"] - old["e2e_under"])
        return {"count": count, "over": max(0.0, count - under)}

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /admin/slo`` document."""
        self.observe()
        with self._lock:
            ring = list(self._ring)
        now_t, now_c = ring[-1]
        burn: Dict[str, Any] = {}
        for name, span in SLO_WINDOWS:
            # oldest snapshot still inside the window (or the ring's head)
            base_t, base_c = ring[0]
            for t, c in ring:
                if t >= now_t - span:
                    base_t, base_c = t, c
                    break
            d = self._delta(now_c, base_c)
            ratio = (d["over"] / d["count"]) if d["count"] > 0 else None
            burn[name] = {
                "window_s": span,
                "covered_s": round(max(0.0, now_t - base_t), 3),
                "traces": int(d["count"]),
                "error_ratio": None if ratio is None else round(ratio, 6),
                "burn_rate": (None if ratio is None
                              else round(ratio / SLO_ERROR_BUDGET, 3)),
            }
        dwell_total = sum(now_c["dwell"].values())
        shares = {
            stage: round(v / dwell_total, 4)
            for stage, v in sorted(now_c["dwell"].items())
        } if dwell_total > 0 else {}
        total_over = max(0.0, now_c["e2e_count"] - now_c["e2e_under"])
        return {
            "objective": {
                "latency_slo_s": float(SLO_LATENCY_LE),
                "error_budget": SLO_ERROR_BUDGET,
                "recording_rules": "ops/recording_rules.yml",
            },
            "e2e": {
                "traces_total": int(now_c["e2e_count"]),
                "traces_over_slo": int(total_over),
                "cumulative_error_ratio": (
                    round(total_over / now_c["e2e_count"], 6)
                    if now_c["e2e_count"] > 0 else None),
            },
            "burn": burn,
            "stages": {
                "dwell_seconds": {
                    stage: round(v, 6)
                    for stage, v in sorted(now_c["dwell"].items())},
                "dwell_share": shares,
                "transit_seconds": round(now_c["transit_s"], 6),
                "detector": {
                    "processing_seconds": round(now_c["process_s"], 6),
                    "queue_wait_seconds": round(now_c["queue_wait_s"], 6),
                    "device_seconds": round(now_c["device_s"], 6),
                },
            },
            "observations": len(ring),
        }
