"""Device-side observability: the capture ledger and the batch span log.

The port's copy of ``detectmateservice_tpu/engine/device_obs.py`` on CUDA.
On a TPU a "compile" is an XLA backend compile of one batch shape; on the
card there is no per-shape compile, and the two events that cost the same
stall are recorded in its place:

* a **CUDA-graph capture** of one (kind, bucket) of the detector's warm set
  (``library/detectors/graphs.py``), with its seconds: the boot warm-up,
  the expected re-captures (a bucket warmed on first use or resurrected
  after retirement, ``where="bucket_warm"``; the int8 cut-over,
  ``"int8_activate"``; a checkpoint restore, ``"restore"``) and, after
  warm-up, a dispatch on an active bucket that finds no valid graph: an
  unexpected recompile. On the CPU, where there is no graph, the eager call
  that stands in for a capture is recorded the same way;
* a **kernel build** by ``ops/cuda_build.py`` (``nvcc``), ``where="build"``.

The rest is the JAX module's contract:

* :class:`CompileLedger` attributes each record to the bucket and code path
  of the thread-local :meth:`CompileLedger.context` it happened in. A record
  with no context is ``where: external`` and is never flagged. After
  ``mark_warmup_complete`` a record inside a context with ``expected=False``
  is an unexpected recompile: counted
  (``scorer_xla_recompiles_unexpected_total``), emitted as a structured
  ``unexpected_recompile`` event through the bound health monitor, and it
  arms the ``xla_recompile_storm`` check (:class:`RecompileStormCheck`).
* each drained device batch records a span (bucket, real rows, path,
  queue-wait and device-time split, the coalescer's release reason) into a
  bounded ring; :meth:`CompileLedger.snapshot` is the ``GET /admin/xla``
  document, with the JAX package's top-level keys.
* :class:`WarmupPendingCheck` is UNHEALTHY while the warm set is still being
  captured.
* the warm-up phases keep the JAX labels of ``scorer_warmup_seconds``:
  ``device_put`` (model build and weights on the card), ``aot`` (the warm
  set's graph captures; the TPU's ahead-of-time compiles) and
  ``cache_load`` (loading kernel libraries ``cuda_build`` found already
  built; the TPU's persistent compile cache).
* :func:`export_hbm_gauges` exports ``device_hbm_bytes{device,kind}`` read
  at scrape time: ``in_use`` from ``torch.cuda.memory_stats(device)``
  (``allocated_bytes.all.current``), ``limit`` from
  ``torch.cuda.mem_get_info``. A CPU device exports nothing.

The series keep the JAX names, ``xla`` included: they are a contract with
the repo's dashboards and alert rules, which read both packages. The
``backend`` label is ``cuda``, or ``cpu`` where the caller asked for the
CPU.

The component library imports no metrics client: the ledger's series
exist once a hosting Service binds it with the metric factories
(``bind(..., metrics=...)``); an unbound ledger keeps its ring, totals and
checks and exports no series. Nothing here touches a CUDA tensor, so the
admin plane may read the ledger from its HTTP threads.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

# how long after the last unexpected recompile the watchdog check stays
# degraded
RECOMPILE_STORM_WINDOW_S = 120.0


class CompileLedger:
    """Bounded record of captures and kernel builds, and of device-batch
    spans, for one process. Thread-safe; span recording is one lock and one
    deque append per drained batch."""

    def __init__(self, max_events: int = 256, max_spans: int = 256,
                 storm_window_s: float = RECOMPILE_STORM_WINDOW_S) -> None:
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, max_events))
        self._spans: deque = deque(maxlen=max(1, max_spans))
        self._seq = 0
        self._span_seq = 0
        self._warmed = False
        self._storm_window_s = storm_window_s
        self._labels = {"component_type": "core", "component_id": "unknown"}
        self.monitor = None               # HealthMonitor, set via bind()
        self._metrics = None              # engine/metrics.py, set via bind()
        self._emit_events = True
        self._tls = threading.local()
        self._compile_children: Dict[Tuple[str, str], tuple] = {}
        self._unexpected_child = None
        self._totals = {"compiles": 0, "seconds": 0.0, "unexpected": 0}
        self._recent_unexpected: deque = deque(maxlen=64)  # monotonic stamps
        self._cache_load_seconds = 0.0
        self._warmup_phases: Dict[str, float] = {}
        self._warmup_children: Dict[str, Any] = {}
        # the detector's live warm / retired bucket sets, for GET /admin/xla
        self._bucket_state_fn: Optional[Callable[[], Dict[str, Any]]] = None

    # -- wiring ----------------------------------------------------------
    def bind(self, labels: Optional[Dict[str, str]] = None, monitor=None,
             emit_events: bool = True, register_check: bool = True,
             metrics=None) -> None:
        """Attach component identity, the health plane and the metric
        factories (the Service, at construction; last bind wins)."""
        with self._lock:
            if labels:
                self._labels = dict(labels)
            if labels or metrics is not None:
                self._compile_children.clear()
                self._unexpected_child = None
                self._warmup_children.clear()
            if metrics is not None:
                self._metrics = metrics
            if monitor is not self.monitor:
                # a storm that predates this binding belongs to the previous
                # service (the ring and counters keep the history)
                self._recent_unexpected.clear()
            self.monitor = monitor
            self._emit_events = emit_events
        if monitor is not None and register_check:
            monitor.remove_check(RecompileStormCheck.name)
            monitor.add_check(RecompileStormCheck(self, monitor, self._storm_window_s))

    def set_bucket_state_provider(self, fn) -> None:
        """Attach a callable returning the detector's live bucket state
        (warm / retired sets), surfaced under ``buckets`` in
        :meth:`snapshot`. Last registration wins."""
        with self._lock:
            self._bucket_state_fn = fn

    # -- attribution contexts -------------------------------------------
    @contextlib.contextmanager
    def context(self, bucket: Optional[int] = None,
                backend: Optional[str] = None, where: Optional[str] = None,
                expected: Optional[bool] = None) -> Iterator[None]:
        """Attribute records made by the enclosed code to (bucket, where).
        ``expected`` is inherited from the enclosing context when ``None``
        (outermost default: True)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append({"bucket": bucket, "backend": backend, "where": where,
                      "expected": expected})
        try:
            yield
        finally:
            stack.pop()

    def _effective_context(self) -> Optional[Dict[str, Any]]:
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return None
        eff: Dict[str, Any] = {"bucket": None, "backend": None,
                               "where": None, "expected": True}
        for frame in stack:
            for key, value in frame.items():
                if value is not None:
                    eff[key] = value
        return eff

    # -- warm-up phases and lifecycle -------------------------------------
    def record_cache_load(self, seconds: float) -> None:
        """Accumulate the seconds spent loading already-built kernel
        libraries (the ``cache_load`` phase reads the running total)."""
        with self._lock:
            self._cache_load_seconds += max(0.0, float(seconds))

    def cache_load_seconds(self) -> float:
        with self._lock:
            return self._cache_load_seconds

    def record_warmup_phase(self, phase: str, seconds: float) -> None:
        """One warm-up phase's wall seconds
        (``scorer_warmup_seconds{phase=aot|cache_load|device_put}``)."""
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._warmup_phases[phase] = round(seconds, 6)
            child = None
            if self._metrics is not None:
                child = self._warmup_children.get(phase)
                if child is None:
                    child = self._metrics.SCORER_WARMUP_SECONDS().labels(
                        phase=phase, **self._labels)
                    self._warmup_children[phase] = child
        if child is not None:
            child.set(seconds)

    def warmup_phases(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._warmup_phases)

    def mark_warmup_complete(self) -> None:
        with self._lock:
            self._warmed = True

    @property
    def warmup_complete(self) -> bool:
        with self._lock:
            return self._warmed

    # -- recording -------------------------------------------------------
    def _compile_counters(self, bucket: str, backend: str) -> Optional[tuple]:
        if self._metrics is None:
            return None
        pair = self._compile_children.get((bucket, backend))
        if pair is None:
            labels = dict(self._labels, bucket=bucket, backend=backend)
            pair = (self._metrics.XLA_COMPILES().labels(**labels),
                    self._metrics.XLA_COMPILE_SECONDS().labels(**labels))
            self._compile_children[(bucket, backend)] = pair
        return pair

    def record_compile(self, duration_s: float, bucket: Optional[int] = None,
                       backend: Optional[str] = None, where: Optional[str] = None,
                       expected: Optional[bool] = None) -> Dict[str, Any]:
        """Record one capture or kernel build. Attribution comes from the
        thread-local context; explicit keyword arguments override it (the
        callers that know their own attribution, and tests)."""
        eff = self._effective_context()
        attributed = eff is not None or bucket is not None
        if eff is None:
            eff = {"bucket": None, "backend": None, "where": None, "expected": True}
        for key, value in (("bucket", bucket), ("backend", backend),
                           ("where", where), ("expected", expected)):
            if value is not None:
                eff[key] = value
        bucket_s = "?" if eff["bucket"] is None else str(eff["bucket"])
        backend_s = eff["backend"] or "unknown"
        where_s = eff["where"] or ("unattributed" if attributed else "external")
        with self._lock:
            self._seq += 1
            phase = "runtime" if self._warmed else "warmup"
            unexpected = bool(self._warmed and attributed and not eff["expected"])
            self._totals["compiles"] += 1
            self._totals["seconds"] += float(duration_s)
            counters = self._compile_counters(bucket_s, backend_s)
            event = {
                "seq": self._seq,
                "ts": round(time.time(), 6),
                "bucket": bucket_s,
                "backend": backend_s,
                "seconds": round(float(duration_s), 6),
                "where": where_s,
                "phase": phase,
                "unexpected": unexpected,
            }
            unexpected_c = None
            if unexpected:
                self._totals["unexpected"] += 1
                self._recent_unexpected.append(time.monotonic())
                if self._metrics is not None:
                    if self._unexpected_child is None:
                        self._unexpected_child = (
                            self._metrics.XLA_RECOMPILES_UNEXPECTED().labels(**self._labels))
                    unexpected_c = self._unexpected_child
            monitor = self.monitor
            emit = unexpected and self._emit_events and monitor is not None
            self._events.append(event)
        if counters is not None:
            counters[0].inc()
            counters[1].inc(float(duration_s))
        if unexpected_c is not None:
            unexpected_c.inc()
        if emit:
            # outside the ledger lock: the monitor fans out to the event ring
            # and the logger
            monitor.emit_event(dict(event, kind="unexpected_recompile"))
        return event

    def record_span(self, bucket: int, real: int, path: str,
                    queue_wait_s: float, device_s: float,
                    trace_id: Optional[str] = None,
                    release: Optional[str] = None) -> None:
        """One drained device batch; ``release`` names why the coalescer
        let it go (full/deadline/flush), None for an uncoalesced dispatch."""
        with self._lock:
            self._span_seq += 1
            self._spans.append({
                "seq": self._span_seq,
                "ts": round(time.time(), 6),
                "bucket": int(bucket),
                "real": int(real),
                "occupancy": round(int(real) / max(1, int(bucket)), 4),
                "path": path,
                "queue_wait_s": round(float(queue_wait_s), 6),
                "device_s": round(float(device_s), 6),
                "trace_id": trace_id,
                "release": release,
            })

    # -- reads -----------------------------------------------------------
    def unexpected_in_window(self, window_s: Optional[float] = None,
                             now: Optional[float] = None) -> int:
        window = self._storm_window_s if window_s is None else window_s
        now = time.monotonic() if now is None else now
        with self._lock:
            return sum(1 for t in self._recent_unexpected if now - t <= window)

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """The ``GET /admin/xla`` document. The port has no persistent
        compile cache: ``compile_cache`` reports it unarmed."""
        with self._lock:
            events = list(self._events)
            spans = list(self._spans)
            totals = dict(self._totals)
            totals["seconds"] = round(totals["seconds"], 6)
            warmed = self._warmed
            bucket_fn = self._bucket_state_fn
            warmup_phases = dict(self._warmup_phases)
        if limit is not None and limit >= 0:
            events = events[-limit:]
            spans = spans[-limit:]
        doc = {
            "warmup_complete": warmed,
            "totals": totals,
            "compiles": events,
            "batches": spans,
            "compile_cache": {"armed": False, "hits": 0, "misses": 0},
            "warmup_phases": warmup_phases,
        }
        if bucket_fn is not None:
            try:
                doc["buckets"] = bucket_fn()
            except Exception:  # noqa: BLE001 — a racing detector must not kill the read
                pass
        return doc


class WarmupPendingCheck:
    """Watchdog check: UNHEALTHY while the detector's warm set is being
    captured, PASS once ``mark_warmup_complete`` lands. The detector
    registers it before its first capture."""

    name = "scorer_warmup_pending"

    def __init__(self, ledger: CompileLedger, monitor) -> None:
        self._ledger = ledger
        self._monitor = monitor

    def evaluate(self, now: float) -> Tuple[str, str]:
        from .health import PASS, UNHEALTHY

        if self._ledger.monitor is not self._monitor:
            return PASS, "ledger bound to another service"
        if not self._ledger.warmup_complete:
            return UNHEALTHY, ("scorer warm-up in flight — refusing ACTIVE "
                               "until the warm set is captured")
        phases = self._ledger.warmup_phases()
        if phases:
            return PASS, f"warm-up complete in {sum(phases.values()):.3f}s ({phases})"
        return PASS, "warm-up complete"


class RecompileStormCheck:
    """Watchdog check: degraded while unexpected recompiles are recent; PASS
    for a monitor the ledger is no longer bound to."""

    name = "xla_recompile_storm"

    def __init__(self, ledger: CompileLedger, monitor,
                 window_s: float = RECOMPILE_STORM_WINDOW_S) -> None:
        self._ledger = ledger
        self._monitor = monitor
        self._window_s = window_s

    def evaluate(self, now: float) -> Tuple[str, str]:
        from .health import DEGRADED, PASS

        if self._ledger.monitor is not self._monitor:
            return PASS, "ledger bound to another service"
        recent = self._ledger.unexpected_in_window(self._window_s)
        if recent:
            return DEGRADED, (f"{recent} unexpected recompile(s) (graph captures on "
                              f"the dispatch path) in the last {self._window_s:.0f}s "
                              "— see GET /admin/xla")
        return PASS, "no unexpected recompiles"


# -- the process-wide ledger ---------------------------------------------------
_ACTIVE = CompileLedger()


def get_ledger() -> CompileLedger:
    return _ACTIVE


def activate(ledger: CompileLedger) -> CompileLedger:
    """Swap the process-wide ledger (tests); returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ledger
    return prev


# -- HBM gauges -------------------------------------------------------------------
_HBM_LOCK = threading.Lock()
_HBM_EXPORTED: set = set()


def _hbm_reader(device, kind: str) -> Callable[[], float]:
    import torch

    def read() -> float:
        try:
            if kind == "in_use":
                return float(torch.cuda.memory_stats(device).get(
                    "allocated_bytes.all.current", 0))
            return float(torch.cuda.mem_get_info(device)[1])
        except Exception:  # noqa: BLE001 — a dead device must not kill the scrape
            return 0.0

    return read


def export_hbm_gauges(labels: Dict[str, str], device, metrics) -> int:
    """Export ``device_hbm_bytes{device,kind=in_use|limit}`` for ``device``
    (a ``torch.device``, or a list of them: a mesh's distinct devices),
    read at scrape time. Returns how many devices export: CPU devices, and
    every device without metric factories, do not."""
    if isinstance(device, (list, tuple)):
        return sum(export_hbm_gauges(labels, d, metrics) for d in device)
    if metrics is None or getattr(device, "type", None) != "cuda":
        return 0
    key = (tuple(sorted(labels.items())), str(device))
    with _HBM_LOCK:
        if key in _HBM_EXPORTED:
            return 1
        _HBM_EXPORTED.add(key)
    for kind in ("in_use", "limit"):
        metrics.DEVICE_HBM().labels(device=str(device), kind=kind,
                                    **labels).set_function(_hbm_reader(device, kind))
    return 1
