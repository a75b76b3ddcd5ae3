"""Cross-stage trace assembly and tail-based sampling.

The port's copy of ``detectmateservice_tpu/telemetry/collector.py``, on the
port's socket layer. One stage per pipeline hosts the collector
(``telemetry_collector``); every traced stage points ``telemetry_addr`` at
its ``telemetry_collector_addr``, and its assembler turns the per-stage span
stream back into whole-pipeline traces:

* **out-of-order arrival**: stages flush on their own cadence, so spans are
  keyed on the trace id and merged whenever they arrive;
* **duplicate hops**: two spans of one (trace, stage) collapse to the
  earliest attempt;
* **watermark completion**: a trace is complete once its terminal hop was
  seen and the newest ``send_ns`` across every span received has advanced
  ``telemetry_settle_ms`` past the trace's own newest hop. A trace that
  never completes is flushed after ``telemetry_trace_timeout_s`` on the
  collector's clock and counted incomplete.

Tail sampling then keeps every trace that erred, was quarantined, ran past
the SLO or never completed, and the healthy rest at
``telemetry_sample_healthy_ratio`` by a deterministic (Fibonacci) hash of
the trace id. Kept traces land in a bounded ring behind ``GET
/admin/traces`` (JSON, Perfetto, OTLP) and, with ``telemetry_otlp_url``,
are pushed as OTLP/JSON by an export thread.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..engine import metrics as m
from ..engine.framing import FramingError, unpack_spans
from ..engine.socket import TransportError
from . import otlp, perfetto

# verdict precedence: the worst thing that happened to a trace names it
_FLAG_VERDICTS = ("error", "quarantined", "shed", "fault")


class _OpenTrace:
    """Assembly state for one trace id."""

    __slots__ = ("hops", "flags", "tenant_bucket", "terminal_send_ns",
                 "max_send_ns", "first_local_ns")

    def __init__(self, first_local_ns: int) -> None:
        self.hops: Dict[str, Dict[str, Any]] = {}   # stage → span dict
        self.flags: set = set()
        self.tenant_bucket: Optional[str] = None
        self.terminal_send_ns: Optional[int] = None
        self.max_send_ns = 0
        self.first_local_ns = first_local_ns


class TraceAssembler:
    """Pure assembly logic (no sockets, no threads). Clocks are injected:
    ``now_ns`` is the collector's local clock, span timestamps are producer
    ``time.time_ns()`` epoch values that only ever compare against each
    other."""

    def __init__(self, settle_ns: int, timeout_ns: int) -> None:
        self._settle_ns = max(0, int(settle_ns))
        self._timeout_ns = max(1, int(timeout_ns))
        self._open: Dict[int, _OpenTrace] = {}
        self.watermark = 0
        self.deduped = 0

    @property
    def backlog(self) -> int:
        return len(self._open)

    def add(self, span: Dict[str, Any], now_ns: int) -> str:
        """Merge one span record; returns ``"hop"``, ``"dup"``, or
        ``"flag"`` (malformed records raise KeyError/ValueError — the
        collector counts and drops them)."""
        trace_id = int(span["trace_id"], 16)
        rec = self._open.get(trace_id)
        if rec is None:
            rec = _OpenTrace(now_ns)
            self._open[trace_id] = rec
        if span.get("tenant_bucket") is not None:
            rec.tenant_bucket = str(span["tenant_bucket"])
        if span.get("recv_ns") is None:
            # flag-only annotation from a cold path (shed/quarantine/error)
            rec.flags.update(span.get("flags", ()))
            return "flag"
        rec.flags.update(span.get("flags", ()))
        stage = str(span["stage"])
        send_ns = int(span["send_ns"])
        if send_ns > self.watermark:
            self.watermark = send_ns
        existing = rec.hops.get(stage)
        if existing is not None:
            # at-least-once redelivery: keep the FIRST attempt's timing
            self.deduped += 1
            if int(span["recv_ns"]) < int(existing["recv_ns"]):
                rec.hops[stage] = dict(span)
            return "dup"
        rec.hops[stage] = dict(span)
        if span.get("terminal"):
            rec.terminal_send_ns = send_ns
        if send_ns > rec.max_send_ns:
            rec.max_send_ns = send_ns
        return "hop"

    def poll(self, now_ns: int) -> Tuple[List[Dict[str, Any]],
                                         List[Dict[str, Any]]]:
        """Flush ready traces → ``(completed, expired)``. Completed traces
        saw their terminal hop (watermark-settled or timed out with it);
        expired ones hit ``telemetry_trace_timeout_s`` without one."""
        completed: List[Dict[str, Any]] = []
        expired: List[Dict[str, Any]] = []
        done: List[int] = []
        for trace_id, rec in self._open.items():
            has_terminal = rec.terminal_send_ns is not None
            settled = (has_terminal
                       and self.watermark >= rec.max_send_ns + self._settle_ns)
            timed_out = now_ns - rec.first_local_ns >= self._timeout_ns
            if not settled and not timed_out:
                continue
            done.append(trace_id)
            trace = self._build(trace_id, rec, complete=has_terminal)
            (completed if has_terminal else expired).append(trace)
        for trace_id in done:
            del self._open[trace_id]
        return completed, expired

    @staticmethod
    def _build(trace_id: int, rec: _OpenTrace,
               complete: bool) -> Dict[str, Any]:
        hops = sorted(rec.hops.values(), key=lambda h: int(h["recv_ns"]))
        ingest_ns = min((int(h["ingest_ns"]) for h in hops
                         if h.get("ingest_ns") is not None), default=None)
        e2e_s = None
        if complete and ingest_ns is not None:
            e2e_s = max(0, rec.terminal_send_ns - ingest_ns) / 1e9
        return {
            "trace_id": f"{trace_id:016x}",
            "ingest_ns": ingest_ns,
            "e2e_seconds": e2e_s,
            "complete": bool(complete),
            "flags": sorted(rec.flags),
            "tenant_bucket": rec.tenant_bucket,
            "hops": [{"stage": h["stage"],
                      "recv_ns": int(h["recv_ns"]),
                      "send_ns": int(h["send_ns"]),
                      "replica": h.get("replica", "")}
                     for h in hops],
        }


class TailSampler:
    """Keep/drop verdicts biased toward the anomalous tail."""

    def __init__(self, healthy_ratio: float, slo_s: float) -> None:
        self._ratio = min(1.0, max(0.0, float(healthy_ratio)))
        self._slo_s = float(slo_s)

    def verdict(self, trace: Dict[str, Any]) -> Tuple[bool, str]:
        """``(keep, verdict)`` — every verdict value becomes a
        ``telemetry_spans_total{verdict=...}`` label, so the set is small
        and closed: error / quarantined / shed / fault / incomplete /
        slow / healthy."""
        flags = trace.get("flags") or ()
        for flag in _FLAG_VERDICTS:
            if flag in flags:
                return True, flag
        if not trace.get("complete"):
            return True, "incomplete"
        e2e = trace.get("e2e_seconds")
        if e2e is not None and e2e > self._slo_s:
            return True, "slow"
        return self._keep_healthy(int(trace["trace_id"], 16)), "healthy"

    def _keep_healthy(self, trace_id: int) -> bool:
        if self._ratio >= 1.0:
            return True
        if self._ratio <= 0.0:
            return False
        # Fibonacci-hash the id into [0, 1): deterministic per trace, so a
        # restarted collector (or a test) reproduces the same sample set
        h = (trace_id * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        return (h >> 40) / float(1 << 24) < self._ratio


class TelemetryCollector:
    """The runnable collector: listener socket + assembly thread + export
    thread, constructed by ``core.Service`` when ``telemetry_collector`` is
    set (the admin plane serves its ring via ``GET /admin/traces``)."""

    def __init__(self, settings, factory, labels: Dict[str, str],
                 monitor=None, logger: Optional[logging.Logger] = None,
                 ) -> None:
        self._addr = settings.telemetry_collector_addr
        self._factory = factory
        self._labels = dict(labels)
        self._monitor = monitor
        self._logger = logger or logging.getLogger("detectmate.telemetry")
        self._otlp_url = getattr(settings, "telemetry_otlp_url", None)
        self.assembler = TraceAssembler(
            settle_ns=int(float(settings.telemetry_settle_ms) * 1e6),
            timeout_ns=int(float(settings.telemetry_trace_timeout_s) * 1e9))
        self.sampler = TailSampler(
            healthy_ratio=settings.telemetry_sample_healthy_ratio,
            slo_s=float(settings.telemetry_slo_ms) / 1000.0)
        self._retained: deque = deque(
            maxlen=int(getattr(settings, "telemetry_retain_traces", 256)))
        self._lock = threading.Lock()
        self._stats = {"spans": 0, "assembled": 0, "incomplete": 0,
                       "kept": 0, "dropped": 0, "bad_frames": 0}
        # label children resolved once; verdict children on demand
        self._m_assembled = m.TELEMETRY_TRACES_ASSEMBLED().labels(**labels)
        self._m_dropped = m.TELEMETRY_TRACES_DROPPED().labels(**labels)
        self._m_incomplete = m.TELEMETRY_TRACES_INCOMPLETE().labels(**labels)
        self._m_deduped = m.TELEMETRY_SPANS_DEDUPED().labels(**labels)
        self._m_backlog = m.TELEMETRY_COLLECTOR_BACKLOG().labels(**labels)
        self._m_verdict: Dict[str, Any] = {}
        self._m_otlp: Dict[str, Any] = {}
        self._export_q: deque = deque(maxlen=1024)
        self._sock = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._export_thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._sock = self._factory.create(self._addr, self._logger, None)
        self._sock.recv_timeout = 100
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-collector", daemon=True)
        self._thread.start()
        if self._otlp_url:
            self._export_thread = threading.Thread(
                target=self._run_export, name="telemetry-otlp", daemon=True)
            self._export_thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        for thread in (self._thread, self._export_thread):
            if thread is not None:
                thread.join(timeout=timeout)
        self._thread = self._export_thread = None
        sock = self._sock
        self._sock = None
        if sock is not None:
            try:
                sock.close()
            except Exception:  # noqa: BLE001 — best-effort close during shutdown
                pass

    @property
    def backlog(self) -> int:
        return self.assembler.backlog

    # -- collector thread -------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                raw = self._sock.recv()
            except TransportError:
                raw = None
            except Exception:  # noqa: BLE001 — the collector outlives a bad recv
                self._logger.exception("telemetry collector recv failed")
                raw = None
            if raw is not None:
                self.ingest_frame(raw)
            self.pump(time.time_ns())
        # final pump so short-lived runs (smokes) flush their tail
        self.pump(time.time_ns())

    def ingest_frame(self, raw: bytes) -> int:
        """One span frame → assembler. Returns spans merged (0 on a frame
        that is not a span frame, or is garbled — counted, never raised:
        a poisoned telemetry channel must not kill the collector)."""
        try:
            spans = unpack_spans(raw)
        except FramingError:
            spans = None
        if spans is None:
            with self._lock:
                self._stats["bad_frames"] += 1
            return 0
        now_ns = time.time_ns()
        merged = 0
        for span in spans:
            try:
                outcome = self.assembler.add(span, now_ns)
            except (KeyError, TypeError, ValueError):
                with self._lock:
                    self._stats["bad_frames"] += 1
                continue
            if outcome == "dup":
                self._m_deduped.inc()
            merged += 1
        return merged

    def pump(self, now_ns: int) -> None:
        """Advance assembly: flush completed/expired traces through the
        tail sampler into the retained ring, update gauges. Called from the
        collector thread each cycle (and directly by tests/smokes)."""
        completed, expired = self.assembler.poll(now_ns)
        for trace in completed:
            self._m_assembled.inc()
            self._finish(trace, assembled=True)
        for trace in expired:
            self._m_incomplete.inc()
            self._finish(trace, assembled=False)
        self._m_backlog.set(self.assembler.backlog)

    def _finish(self, trace: Dict[str, Any], assembled: bool) -> None:
        keep, verdict = self.sampler.verdict(trace)
        trace["verdict"] = verdict
        child = self._m_verdict.get(verdict)
        if child is None:
            child = m.TELEMETRY_SPANS().labels(verdict=verdict,
                                               **self._labels)
            self._m_verdict[verdict] = child
        n_hops = len(trace["hops"])
        if n_hops:
            child.inc(n_hops)
        with self._lock:
            self._stats["spans"] += n_hops
            if assembled:
                self._stats["assembled"] += 1
            else:
                self._stats["incomplete"] += 1
            if keep:
                self._stats["kept"] += 1
                self._retained.append(trace)
            else:
                self._stats["dropped"] += 1
        if not keep:
            self._m_dropped.inc()
        elif self._otlp_url:
            self._export_q.append(trace)

    # -- OTLP export thread -----------------------------------------------

    def _run_export(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(0.25)
            self.export_pending()

    def export_pending(self) -> int:
        """Push queued kept traces to ``telemetry_otlp_url`` as one
        OTLP/JSON batch; returns traces shipped."""
        batch: List[Dict[str, Any]] = []
        q = self._export_q
        while q:
            try:
                batch.append(q.popleft())
            except IndexError:
                break
        if not batch:
            return 0
        doc = otlp.encode_traces(batch, self._labels)
        try:
            otlp.push(self._otlp_url, doc)
            result = "ok"
        except Exception as exc:  # noqa: BLE001 — counted, the thread goes on
            result = "error"
            self._logger.warning("OTLP push to %s failed: %s",
                                 self._otlp_url, exc)
        child = self._m_otlp.get(result)
        if child is None:
            child = m.TELEMETRY_OTLP_PUSHES().labels(result=result,
                                                     **self._labels)
            self._m_otlp[result] = child
        child.inc()
        return len(batch) if result == "ok" else 0

    # -- admin surfaces (web/router.py GET /admin/traces) ------------------

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            traces = list(self._retained)
            stats = dict(self._stats)
        traces.reverse()  # newest first
        if limit is not None:
            traces = traces[:max(0, int(limit))]
        stats["deduped"] = self.assembler.deduped
        stats["backlog"] = self.assembler.backlog
        return {
            "stats": stats,
            "traces": [{"trace_id": t["trace_id"],
                        "verdict": t.get("verdict"),
                        "complete": t["complete"],
                        "e2e_seconds": t["e2e_seconds"],
                        "stages": len(t["hops"]),
                        "flags": t["flags"]}
                       for t in traces],
        }

    def trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Full assembled trace by 16-hex id (the stage waterfall behind
        ``GET /admin/traces?id=``)."""
        want = trace_id.lower().lstrip("0x").rjust(16, "0")
        with self._lock:
            for t in reversed(self._retained):
                if t["trace_id"] == want:
                    return t
        return None

    def retained(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._retained)

    def perfetto_events(self) -> Dict[str, Any]:
        """Cross-stage Chrome trace-event document (Perfetto-loadable) of
        every retained trace — the pipeline view that supersedes the
        per-process ``GET /admin/trace?format=chrome``."""
        return perfetto.trace_events(self.retained())

    def otlp_payload(self) -> Dict[str, Any]:
        """The retained ring as one OTLP/JSON document
        (``GET /admin/traces?format=otlp``)."""
        return otlp.encode_traces(self.retained(), self._labels)
