"""Engine-side span export: hop records → span frames, off the engine loop.

The port's copy of ``detectmateservice_tpu/telemetry/spans.py``. The engine
loop already reads the clock once per frame to stamp its hop into the
forwarded trace block; this module makes the same record leave the process.
The contract with the loop:

* ``offer()`` is its only surface: one bounded-deque append (a ``len``
  check and an ``append``, both atomic under the interpreter lock), no
  lock, no clock read;
* when the queue is full the span is dropped, never the frame
  (``telemetry_spans_export_dropped_total``, and a rate-limited
  ``telemetry_export_degraded`` event);
* everything that costs (the span JSON, the tenant bucket hash, the socket
  send) runs on the sender thread every ``telemetry_flush_interval_ms``.
  The thread writes each span's JSON text with one format string, the
  bytes ``pack_spans`` gives for the same span dicts, without building the
  dicts: it shares the interpreter lock with the engine loop.

Cold paths annotate a trace through ``offer_flag``: flags ride the same
queue and become flag-only span records the collector merges into the
trace's verdict. The port's engine raises ``error`` (a dispatch that
raised) and ``quarantined`` (a message dropped after its attempts); the
flags of unported subsystems (``shed``, ``fault``) never fire.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..engine import metrics as m
from ..engine.framing import pack_span_body
from ..engine.tracing import tenant_bucket

# re-emit the degraded event at most this often while drops continue
_DEGRADED_EVENT_INTERVAL_S = 60.0


class SpanExporter:
    """Ships completed hop spans to the telemetry collector
    (``telemetry_addr``) over the engine's socket factory."""

    def __init__(self, settings, factory, stage: str, labels: Dict[str, str],
                 logger: Optional[logging.Logger] = None,
                 events: Optional[Callable[[Dict[str, Any]], Any]] = None) -> None:
        self._addr = settings.telemetry_addr
        self._cap = int(settings.telemetry_queue_size)
        self._flush_s = max(0.001, float(settings.telemetry_flush_interval_ms) / 1000.0)
        self._factory = factory
        self._stage = stage
        self._replica = labels.get("component_id", "")
        # the span JSON's constant parts, in pack_spans's key order
        who = f'"stage":{json.dumps(stage)},"replica":{json.dumps(self._replica)}'
        self._hop_fmt = ('{"trace_id":"%016x",' + who.replace("%", "%%")
                         + ',"ingest_ns":%d,"recv_ns":%d,"send_ns":%d,"terminal":%s%s}')
        self._flag_fmt = '{"trace_id":"%016x",' + who.replace("%", "%%") + ',"flags":[%s]}'
        self._logger = logger
        self._events = events
        # hop 6-tuples and flag 3-tuples in arrival order; a deque, not a
        # queue.Queue: offer() must never take a lock or wake a waiter
        self._q: deque = deque()
        self._m_dropped = m.TELEMETRY_EXPORT_DROPPED().labels(**labels)
        self._sock = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_degraded_emit = 0.0
        self._send_errors = 0

    # -- the engine loop's surface ---------------------------------------
    def offer(self, trace_id: int, ingest_ns: int, recv_ns: int, send_ns: int,
              terminal: bool, tenant: Optional[str]) -> None:
        """Enqueue one completed hop (bounded, non-blocking)."""
        q = self._q
        if len(q) < self._cap:
            q.append((trace_id, ingest_ns, recv_ns, send_ns, terminal, tenant))
        else:
            self._m_dropped.inc()

    def offer_flag(self, trace_id: Optional[int], flag: str) -> None:
        """Annotate ``trace_id`` with a verdict flag (cold paths only)."""
        if trace_id is None:
            return
        q = self._q
        if len(q) < self._cap:
            q.append(("flag", trace_id, flag))
        else:
            self._m_dropped.inc()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="telemetry-sender",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._thread = None
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except Exception:  # noqa: BLE001 — best-effort close of a broken link
                pass

    @property
    def backlog(self) -> int:
        return len(self._q)

    # -- the sender thread --------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self._flush_s)
            self.flush()
        self.flush()  # a final drain: a short run loses nothing offered

    def flush(self) -> int:
        """Drain the queue into one span frame and send it; the number of
        spans shipped (0 when idle or when the link refused)."""
        q = self._q
        if not q:
            return 0
        parts: List[str] = []
        hop_fmt, flag_fmt = self._hop_fmt, self._flag_fmt
        while q:
            try:
                item = q.popleft()
            except IndexError:
                break
            if item[0] == "flag":
                parts.append(flag_fmt % (item[1], json.dumps(item[2])))
                continue
            trace_id, ingest_ns, recv_ns, send_ns, terminal, tenant = item
            bucket = ("" if tenant is None
                      else f',"tenant_bucket":{json.dumps(tenant_bucket(tenant))}')
            parts.append(hop_fmt % (trace_id, ingest_ns, recv_ns, send_ns,
                                    "true" if terminal else "false", bucket))
        if not parts:
            return 0
        frame = pack_span_body(("[" + ",".join(parts) + "]").encode("utf-8"))
        try:
            sock = self._sock
            if sock is None:
                sock = self._factory.create_output(self._addr, self._logger)
                self._sock = sock
            sock.send(frame)
        except Exception as exc:  # noqa: BLE001 — span loss is the designed failure
            self._m_dropped.inc(len(parts))
            self._send_errors += 1
            self._sock = None
            self._note_degraded(f"send to {self._addr} failed: {exc}")
            return 0
        return len(parts)

    def _note_degraded(self, detail: str) -> None:
        now = time.monotonic()
        if now - self._last_degraded_emit < _DEGRADED_EVENT_INTERVAL_S:
            return
        self._last_degraded_emit = now
        if self._events is not None:
            try:
                self._events({"kind": "telemetry_export_degraded", "detail": detail,
                              "send_errors": self._send_errors})
            except Exception:  # noqa: BLE001 — a broken event ring must not stop sending
                pass
        elif self._logger is not None:
            self._logger.warning("telemetry export degraded: %s", detail)
