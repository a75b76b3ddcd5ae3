"""Per-process self-diagnosis: heartbeats, watchdog checks, structured events.

The port's copy of the parts of ``detectmateservice_tpu/engine/health.py``
that the engine and the admin plane read:

* each loop stamps a :class:`Heartbeat`, one monotonic clock write per
  iteration, read by the watchdog without a lock;
* one watchdog thread per service (:class:`HealthMonitor`) derives the
  checks ``process_wedged``, ``ingest_stalled``, ``output_saturated`` and the
  detector's ``device_inflight`` (pending work whose drain counter does not
  move) with hysteresis (degrade on the first failing evaluation, recover
  after ``recovery_intervals`` clean ones), rolled into the
  ``engine_health_state`` Enum and the ``engine_heartbeat_age_seconds``
  gauges;
* every transition is a structured event in a bounded :class:`EventLog`
  (``GET /admin/events``) and a log record (JSON lines with
  ``log_format: json``, :class:`JsonLogFormatter`);
* a process-wide ``threading.excepthook`` routes uncaught thread exceptions
  to the service logger and the event ring;
* subsystems register their own heartbeats (``register_heartbeat``: the
  detector's ``scorer_dispatch`` upload workers) and checks (``add_check``,
  ``remove_check``: the capture ledger's ``scorer_warmup_pending`` and
  ``xla_recompile_storm``, ``engine/device_obs.py``), and emit structured
  events (``emit_event``);
* events and transitions carry the flight recorder's last completed trace
  id (``trace_recorder``, attached by the Service), and JSON log records
  the ``trace_id`` and ``tenant_bucket`` of the frame the logging thread
  has in flight (``engine/tracing.py`` ``FRAME_CONTEXT``).

The overload ladder of the shed subsystem is not ported.
"""
from __future__ import annotations

import json
import logging
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import metrics as m
from . import tracing

PASS = "pass"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"
_SEVERITY = {PASS: 0, DEGRADED: 1, UNHEALTHY: 2}

HEALTHY = "healthy"  # roll-up name for "every check passes"


class Heartbeat:
    """A loop's liveness stamp: ``beat()`` is one monotonic clock read and
    one attribute store, read by the watchdog thread without a lock."""

    __slots__ = ("name", "last", "waiting", "waiting_since")

    def __init__(self, name: str) -> None:
        now = time.monotonic()
        self.name = name
        self.last = now
        # flow-control wait state (output pump): while ``waiting`` the loop
        # is alive but blocked on a peer since ``waiting_since``
        self.waiting = False
        self.waiting_since = now

    def beat(self) -> None:
        self.last = time.monotonic()

    def wait_begin(self) -> None:
        now = time.monotonic()
        self.last = now
        self.waiting_since = now
        self.waiting = True

    def wait_end(self) -> None:
        self.last = time.monotonic()
        self.waiting = False

    def age(self, now: Optional[float] = None) -> float:
        return max(0.0, (now if now is not None else time.monotonic()) - self.last)


class EventLog:
    """Bounded ring of structured events, each stamped with a wall-clock
    ``ts`` and an increasing ``seq`` so a poller can detect loss."""

    def __init__(self, maxlen: int = 512) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, maxlen))
        self._total = 0

    def emit(self, event: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._total += 1
            stamped = {"seq": self._total, "ts": round(time.time(), 6)}
            stamped.update(event)
            self._ring.append(stamped)
            return stamped

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            events = list(self._ring)
            total = self._total
        if limit is not None and limit >= 0:
            events = events[-limit:]
        return {"total": total, "events": events}


# -- checks: each evaluates to (status, detail) against a monotonic `now` ------

class ProcessWedgedCheck:
    """The engine loop stopped cycling. A loop blocked in the output pump's
    flow-control wait is not wedged: ``output_saturated`` takes that."""

    name = "process_wedged"

    def __init__(self, hb_loop: Heartbeat, hb_output: Optional[Heartbeat],
                 active_fn: Optional[Callable[[], bool]],
                 stall_s: float, unhealthy_s: float) -> None:
        self._hb_loop = hb_loop
        self._hb_output = hb_output
        self._active_fn = active_fn
        self._stall_s = stall_s
        self._unhealthy_s = unhealthy_s

    def evaluate(self, now: float) -> Tuple[str, str]:
        if self._active_fn is not None and not self._active_fn():
            return PASS, "engine not running"
        out = self._hb_output
        if out is not None and out.waiting and out.age(now) <= self._stall_s:
            return PASS, "loop blocked in output flow control (see output_saturated)"
        age = self._hb_loop.age(now)
        if age >= self._unhealthy_s:
            return UNHEALTHY, f"engine loop last beat {age:.1f}s ago"
        if age >= self._stall_s:
            return DEGRADED, f"engine loop last beat {age:.1f}s ago"
        return PASS, f"loop beat {age:.2f}s ago"


class IngestStalledCheck:
    """No ingress frame for a while; idle is healthy unless the stage sets
    ``watchdog_ingest_stall_seconds``."""

    name = "ingest_stalled"

    def __init__(self, hb_ingest: Heartbeat, active_fn: Optional[Callable[[], bool]],
                 stall_s: float) -> None:
        self._hb = hb_ingest
        self._active_fn = active_fn
        self._stall_s = stall_s

    def evaluate(self, now: float) -> Tuple[str, str]:
        if self._active_fn is not None and not self._active_fn():
            return PASS, "engine not running"
        age = self._hb.age(now)
        if self._stall_s > 0 and age >= self._stall_s:
            return DEGRADED, (f"no ingress frame for {age:.1f}s "
                              f"(stage expects traffic within {self._stall_s:.0f}s)")
        return PASS, f"last ingress frame {age:.1f}s ago"


class OutputSaturatedCheck:
    """The block-backpressure pump has waited on a full peer queue
    continuously: the downstream is not draining."""

    name = "output_saturated"

    def __init__(self, hb_output: Heartbeat, active_fn: Optional[Callable[[], bool]],
                 stall_s: float, unhealthy_s: float) -> None:
        self._hb = hb_output
        self._active_fn = active_fn
        self._stall_s = stall_s
        self._unhealthy_s = unhealthy_s

    def evaluate(self, now: float) -> Tuple[str, str]:
        if self._active_fn is not None and not self._active_fn():
            return PASS, "engine not running"
        if not self._hb.waiting:
            return PASS, "outputs draining"
        waited = max(0.0, now - self._hb.waiting_since)
        if waited >= self._unhealthy_s:
            return UNHEALTHY, f"output send blocked {waited:.1f}s (peer queue full)"
        if waited >= self._stall_s:
            return DEGRADED, f"output send blocked {waited:.1f}s (peer queue full)"
        return PASS, f"output briefly backpressured ({waited:.2f}s)"


class InflightStuckCheck:
    """Work is pending but the drain counter has not moved: a stuck device
    queue or a readback that never lands."""

    def __init__(self, name: str, pending_fn: Callable[[], int],
                 progress_fn: Callable[[], int], stall_s: float, unhealthy_s: float) -> None:
        self.name = name
        self._pending_fn = pending_fn
        self._progress_fn = progress_fn
        self._stall_s = stall_s
        self._unhealthy_s = unhealthy_s
        self._last_progress: Optional[int] = None
        self._stuck_since: Optional[float] = None

    def evaluate(self, now: float) -> Tuple[str, str]:
        try:
            pending = int(self._pending_fn() or 0)
            progress = int(self._progress_fn() or 0)
        except Exception as exc:  # noqa: BLE001 — probes must not kill the watchdog
            return PASS, f"probe unavailable: {exc}"
        if pending <= 0:
            self._last_progress = progress
            self._stuck_since = None
            return PASS, "nothing in flight"
        if self._last_progress is None or progress != self._last_progress:
            self._last_progress = progress
            self._stuck_since = now
            return PASS, f"{pending} in flight, draining"
        # re-arm the stuck clock the idle branch cleared, so a queue that
        # wedges on the first batch after an idle tick is still reported
        if self._stuck_since is None:
            self._stuck_since = now
        stuck = now - self._stuck_since
        if stuck >= self._unhealthy_s:
            return UNHEALTHY, f"{pending} in flight, no drain progress for {stuck:.1f}s"
        if stuck >= self._stall_s:
            return DEGRADED, f"{pending} in flight, no drain progress for {stuck:.1f}s"
        return PASS, f"{pending} in flight, waiting {stuck:.2f}s"


class HealthMonitor:
    """Owns the heartbeats, the derived checks and the watchdog thread; one
    per Service. ``evaluate()`` is safe from any thread (``?deep=1`` calls
    it) and is what the watchdog runs every interval."""

    def __init__(self, labels: Dict[str, str], *, stage: Optional[str] = None,
                 stall_seconds: float = 10.0, unhealthy_seconds: float = 30.0,
                 interval_s: float = 2.0, recovery_intervals: int = 2,
                 ingest_stall_seconds: float = 0.0, events: Optional[EventLog] = None,
                 logger: Optional[logging.Logger] = None) -> None:
        self._labels = dict(labels)
        self._stage = stage or labels.get("component_type") or "core"
        self._stall_s = stall_seconds
        self._unhealthy_s = max(unhealthy_seconds, stall_seconds)
        self._interval_s = interval_s
        self._recovery_intervals = max(1, recovery_intervals)
        self._ingest_stall_s = ingest_stall_seconds
        self._events = events
        self._logger = logger
        self.trace_recorder = None  # the engine's FlightRecorder, attached by the Service
        # a restart signal for pollers: counters reset with the process
        self._started_unix = round(time.time(), 3)

        self._lock = threading.Lock()
        self._heartbeats: Dict[str, Heartbeat] = {}
        self._checks: List[Any] = []
        self._latched: Dict[str, str] = {}    # check -> failing status held
        self._streaks: Dict[str, int] = {}    # consecutive clean evals while latched
        self._effective: Dict[str, str] = {}  # check -> last reported status
        self._state = HEALTHY
        self._last_report: Optional[Dict[str, Any]] = None

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self._state_metric = m.ENGINE_HEALTH_STATE().labels(**self._labels)
        self._state_metric.state(HEALTHY)

    # -- registration ----------------------------------------------------
    def _export_heartbeat(self, hb: Heartbeat) -> None:
        """The age gauge is computed at scrape time, so it stays true when
        the watchdog thread itself is wedged."""
        m.HEARTBEAT_AGE().labels(loop=hb.name, **self._labels).set_function(hb.age)

    def register_engine(self, hb_loop: Heartbeat, hb_ingest: Heartbeat, hb_output: Heartbeat,
                        active_fn: Optional[Callable[[], bool]] = None) -> None:
        """Wire the engine's three heartbeats into the loop checks."""
        with self._lock:
            for hb in (hb_loop, hb_ingest, hb_output):
                self._heartbeats[hb.name] = hb
                self._export_heartbeat(hb)
            self._checks.append(ProcessWedgedCheck(
                hb_loop, hb_output, active_fn, self._stall_s, self._unhealthy_s))
            self._checks.append(IngestStalledCheck(hb_ingest, active_fn, self._ingest_stall_s))
            self._checks.append(OutputSaturatedCheck(
                hb_output, active_fn, self._stall_s, self._unhealthy_s))

    def register_progress(self, name: str, pending_fn: Callable[[], int],
                          progress_fn: Callable[[], int]) -> None:
        """A stuck-queue check from a (pending, progress) probe pair."""
        with self._lock:
            self._checks.append(InflightStuckCheck(
                name, pending_fn, progress_fn, self._stall_s, self._unhealthy_s))

    def register_heartbeat(self, name: str) -> Heartbeat:
        """Create (or return) a named heartbeat exported as an
        ``engine_heartbeat_age_seconds{loop=name}`` gauge; no check is
        derived from it."""
        with self._lock:
            hb = self._heartbeats.get(name)
            if hb is None:
                hb = Heartbeat(name)
                self._heartbeats[name] = hb
                self._export_heartbeat(hb)
            return hb

    def add_check(self, check: Any) -> None:
        """Register a check object (``.name`` and ``.evaluate(now) ->
        (status, detail)``)."""
        with self._lock:
            self._checks.append(check)

    def remove_check(self, name: str) -> None:
        with self._lock:
            self._checks = [c for c in self._checks if c.name != name]
            self._latched.pop(name, None)
            self._streaks.pop(name, None)
            self._effective.pop(name, None)

    def emit_event(self, event: Dict[str, Any],
                   level: int = logging.WARNING) -> Dict[str, Any]:
        """A subsystem's structured event (the capture ledger's
        ``unexpected_recompile``) with this service's identity, to the event
        ring and the logger. Takes no monitor lock."""
        doc: Dict[str, Any] = {
            "component_type": self._labels.get("component_type"),
            "component_id": self._labels.get("component_id"),
            "stage": self._stage,
        }
        doc.update(event)
        recorder = self.trace_recorder
        if recorder is not None and "trace_id" not in doc:
            doc["trace_id"] = recorder.last_trace_id
        if self._events is not None:
            self._events.emit(doc)
        if self._logger is not None:
            self._logger.log(level, "event %s: %s", doc.get("kind", "unknown"), doc,
                             extra={"dm_event": doc})
        return doc

    # -- evaluation ------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def report(self) -> Dict[str, Any]:
        """The most recent evaluation (evaluating now if none ran yet)."""
        with self._lock:
            report = self._last_report
        return report or self.evaluate()

    def evaluate(self) -> Dict[str, Any]:
        """Run every check once, apply hysteresis, update the metrics, emit
        transition events, and return the full report."""
        now = time.monotonic()
        with self._lock:
            results: List[Dict[str, str]] = []
            worst = PASS
            for check in list(self._checks):
                try:
                    status, detail = check.evaluate(now)
                except Exception as exc:  # noqa: BLE001 — a crashing check is a failure
                    status, detail = DEGRADED, f"check crashed: {exc!r}"
                status, detail = self._apply_hysteresis(check.name, status, detail)
                results.append({"name": check.name, "status": status, "detail": detail})
                if _SEVERITY[status] > _SEVERITY[worst]:
                    worst = status
            state = {PASS: HEALTHY, DEGRADED: DEGRADED, UNHEALTHY: UNHEALTHY}[worst]
            if state != self._state:
                self._emit_transition(
                    "state", self._state, state, "roll-up of " + (
                        ", ".join(r["name"] for r in results if r["status"] != PASS)
                        or "all checks passing"))
                self._state = state
            self._state_metric.state(state)
            ages = {name: round(hb.age(now), 3) for name, hb in self._heartbeats.items()}
            report = {
                "state": state,
                "stage": self._stage,
                "component_type": self._labels.get("component_type"),
                "component_id": self._labels.get("component_id"),
                "started_unix": self._started_unix,
                "checks": results,
                "heartbeat_age_seconds": ages,
            }
            self._last_report = report
            return report

    def _apply_hysteresis(self, name: str, status: str, detail: str) -> Tuple[str, str]:
        if status == PASS:
            latched = self._latched.get(name)
            if latched is not None:
                streak = self._streaks.get(name, 0) + 1
                if streak >= self._recovery_intervals:
                    del self._latched[name]
                    self._streaks.pop(name, None)
                else:
                    self._streaks[name] = streak
                    status = latched
                    detail = (f"recovering ({streak}/{self._recovery_intervals}"
                              f" clean intervals): {detail}")
        else:
            self._latched[name] = status
            self._streaks[name] = 0
        prev = self._effective.get(name, PASS)
        if status != prev:
            self._emit_transition(name, prev, status, detail)
        self._effective[name] = status
        return status, detail

    def _emit_transition(self, check: str, old: str, new: str, detail: str) -> None:
        event = {
            "kind": "health_transition",
            "component_type": self._labels.get("component_type"),
            "component_id": self._labels.get("component_id"),
            "stage": self._stage,
            "check": check,
            "from": old,
            "to": new,
            "detail": detail,
            "trace_id": (self.trace_recorder.last_trace_id
                         if self.trace_recorder is not None else None),
        }
        if self._events is not None:
            self._events.emit(event)
        if self._logger is not None:
            level = logging.INFO if new in (PASS, HEALTHY) else logging.WARNING
            self._logger.log(level, "health %s: %s -> %s (%s)", check, old, new, detail,
                             extra={"dm_event": event})

    # -- watchdog thread -------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="HealthWatchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — the watchdog must outlive its checks
                if self._logger is not None:
                    self._logger.exception("health watchdog evaluation failed")


# -- structured (JSON) logging --------------------------------------------------

class JsonLogFormatter(logging.Formatter):
    """``log_format: json``: one JSON object per record, with the component
    identity; health transitions attach their event under ``event``. A
    record logged on a thread with a frame in flight (the engine loop)
    carries its ``trace_id`` and ``tenant_bucket`` (the bucket, never the
    raw tenant), so a stage's logs join the spans of the same frame."""

    def __init__(self, static: Optional[Dict[str, str]] = None,
                 tenant_buckets: int = tracing.TENANT_BUCKETS) -> None:
        super().__init__()
        self._static = dict(static or {})
        self._tenant_buckets = max(1, tenant_buckets)

    def format(self, record: logging.LogRecord) -> str:
        doc: Dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        doc.update(self._static)
        trace_id = tracing.current_trace_id()
        if trace_id is not None:
            doc["trace_id"] = f"{trace_id:016x}"
        tenant = tracing.current_tenant()
        if tenant is not None:
            doc["tenant_bucket"] = tracing.tenant_bucket(tenant, self._tenant_buckets)
        event = getattr(record, "dm_event", None)
        if event is not None:
            doc["event"] = event
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


class EventLogHandler(logging.Handler):
    """Mirrors WARNING+ records into the event ring (records that carry
    their own event are skipped, no duplicates)."""

    def __init__(self, events: EventLog) -> None:
        super().__init__(level=logging.WARNING)
        self._events = events

    def emit(self, record: logging.LogRecord) -> None:
        try:
            if getattr(record, "dm_event", None) is not None:
                return
            event: Dict[str, Any] = {
                "kind": "log",
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage(),
            }
            if record.exc_info and record.exc_info[1] is not None:
                event["error"] = repr(record.exc_info[1])
            self._events.emit(event)
        except Exception:  # noqa: BLE001 — logging must never raise
            pass


# -- threading.excepthook: no daemon worker dies silently to stderr -------------

_HOOK_LOCK = threading.Lock()
_HOOK_SINKS: List[Tuple[logging.Logger, Optional[EventLog]]] = []
_PREV_HOOK: Optional[Callable] = None


def install_thread_excepthook(logger: logging.Logger, events: Optional[EventLog] = None):
    """Route uncaught exceptions in any thread through ``logger`` (and the
    event ring). Installed once per process; each Service adds a sink and
    removes it at teardown. Returns the sink handle."""
    global _PREV_HOOK
    sink = (logger, events)
    with _HOOK_LOCK:
        _HOOK_SINKS.append(sink)
        if _PREV_HOOK is None:
            _PREV_HOOK = threading.excepthook
            threading.excepthook = _thread_excepthook
    return sink


def remove_excepthook_sink(sink) -> None:
    with _HOOK_LOCK:
        try:
            _HOOK_SINKS.remove(sink)
        except ValueError:
            pass


def _thread_excepthook(args) -> None:
    if args.exc_type is SystemExit:
        return
    thread_name = args.thread.name if args.thread is not None else "<unknown>"
    event = {
        "kind": "thread_exception",
        "thread": thread_name,
        "error": repr(args.exc_value),
        "traceback": "".join(traceback.format_exception(
            args.exc_type, args.exc_value, args.exc_traceback)),
    }
    with _HOOK_LOCK:
        sinks = list(_HOOK_SINKS)
        prev_hook = _PREV_HOOK
    delivered = False
    for logger, events in sinks:
        try:
            if events is not None:
                events.emit(dict(event))
            logger.error("uncaught exception in thread %s: %s", thread_name, args.exc_value,
                         exc_info=(args.exc_type, args.exc_value, args.exc_traceback),
                         extra={"dm_event": event})
            delivered = True
        except Exception:  # noqa: BLE001 — the hook of last resort cannot raise
            pass
    if not delivered and prev_hook is not None:
        prev_hook(args)


# -- build info -------------------------------------------------------------------

_BUILD_INFO_LOCK = threading.Lock()
_BUILD_INFO_SET = False


def set_build_info() -> None:
    """Export ``dm_build_info`` once per process: the package version and
    the native featurizer's feature version (the port has no native
    transport, so ``dmt_feature_version`` is ``unavailable``)."""
    global _BUILD_INFO_SET
    with _BUILD_INFO_LOCK:
        if _BUILD_INFO_SET:
            return
        from .. import __version__
        from ..utils.matchkern import DM_FEATURE_VERSION

        m.BUILD_INFO().labels(version=__version__, dm_feature_version=str(DM_FEATURE_VERSION),
                              dmt_feature_version="unavailable").set(1)
        _BUILD_INFO_SET = True
