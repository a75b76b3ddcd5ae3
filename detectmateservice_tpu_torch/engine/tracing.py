"""Pipeline flight recorder: a bounded in-memory store of completed traces.

The port's copy of ``detectmateservice_tpu/engine/tracing.py``. The stage
where a trace ends (no forwarding outputs, or ``trace_terminal``; or every
egress with ``trace_observe_e2e``) hands each frame's ``TraceContext`` here
with its end-to-end latency. The recorder keeps two bounded views:

* the N **slowest** traces since start or reset (a min-heap on e2e), so the
  tail is never evicted by volume, and
* a **sampled** ring of every Kth completed trace, so it also shows what
  normal looks like.

``GET /admin/trace`` serves ``snapshot()`` as JSON and ``chrome_events()``
as a Chrome trace-event document (Perfetto, chrome://tracing): each hop is a
complete ("X") slice on its trace's track, and the wire and queue time
between stages a "transit" slice.

``FRAME_CONTEXT`` is per thread: the engine loop stores the trace id (an
int) and tenant of the frame it is expanding or dispatching and clears both
when the burst is finalized. ``JsonLogFormatter`` (``health.py``) reads it,
so a record logged while a frame is in flight carries its ``trace_id`` and
``tenant_bucket``. Records logged from other threads never inherit the
loop's frame. Plain attribute stores, no lock on the hot path.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import zlib
from collections import deque
from typing import Any, Dict, List, Optional

from .framing import TraceContext

FRAME_CONTEXT = threading.local()
# the port has no shed subsystem (``shed_tenant_buckets``): tenants hash
# into the JAX package's default count of buckets
TENANT_BUCKETS = 16


def tenant_bucket(tenant: str, buckets: int = TENANT_BUCKETS) -> str:
    """A stable hash of a tenant id into one of ``buckets`` label values:
    logs and spans carry the bucket, never the raw id (crc32, not
    ``hash()``, which is salted per process)."""
    return str(zlib.crc32(tenant.encode("utf-8")) % max(1, buckets))


def current_trace_id() -> Optional[int]:
    """The engine-loop trace id active on this thread, or None."""
    return getattr(FRAME_CONTEXT, "trace_id", None)


def current_tenant() -> Optional[str]:
    """The tenant of the frame active on this thread, or None."""
    return getattr(FRAME_CONTEXT, "tenant", None)


def trace_to_dict(ctx: TraceContext, e2e_s: float) -> Dict[str, Any]:
    return _entry_dict((ctx.trace_id, ctx.ingest_ns, tuple(ctx.hops), e2e_s))


def _entry_dict(entry: tuple) -> Dict[str, Any]:
    trace_id, ingest_ns, hops, e2e_s = entry
    return {
        "trace_id": f"{trace_id:016x}",
        "ingest_ns": ingest_ns,
        "e2e_seconds": e2e_s,
        "hops": [{"stage": h.stage, "recv_ns": h.recv_ns, "send_ns": h.send_ns}
                 for h in hops],
    }


class FlightRecorder:
    def __init__(self, max_slowest: int = 32, max_sampled: int = 128,
                 sample_every: int = 64) -> None:
        self._lock = threading.Lock()
        self._max_slowest = max(1, max_slowest)
        self._sample_every = max(1, sample_every)
        # a tiebreak counter: heapq must never compare two entries' dicts
        self._tiebreak = itertools.count()
        # entries are (trace_id, ingest_ns, hops, e2e_s) tuples, made dicts
        # when read: the engine loop records every completed trace
        self._slowest: List[tuple] = []  # min-heap of (e2e_s, n, entry)
        self._sampled: deque = deque(maxlen=max(1, max_sampled))
        self._completed = 0
        self._last_trace_id: Optional[int] = None

    def record(self, ctx: TraceContext, e2e_s: float) -> None:
        # a snapshot of the context: hops a later stage appends (with
        # trace_observe_e2e) never change the recorded view
        entry = (ctx.trace_id, ctx.ingest_ns, tuple(ctx.hops), e2e_s)
        with self._lock:
            self._completed += 1
            self._last_trace_id = ctx.trace_id
            if len(self._slowest) < self._max_slowest:
                heapq.heappush(self._slowest, (e2e_s, next(self._tiebreak), entry))
            elif e2e_s > self._slowest[0][0]:
                heapq.heapreplace(self._slowest, (e2e_s, next(self._tiebreak), entry))
            if self._completed % self._sample_every == 1 or self._sample_every == 1:
                self._sampled.append(entry)

    @property
    def completed(self) -> int:
        with self._lock:
            return self._completed

    @property
    def last_trace_id(self) -> Optional[str]:
        """The most recently completed trace id: health events and the
        detector's device-batch spans carry it."""
        with self._lock:
            last = self._last_trace_id
        return None if last is None else f"{last:016x}"

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            slowest = [e[2] for e in sorted(self._slowest, key=lambda e: -e[0])]
            sampled = list(self._sampled)
            completed = self._completed
        return {"completed": completed, "slowest": [_entry_dict(e) for e in slowest],
                "sampled": [_entry_dict(e) for e in sampled]}

    def chrome_events(self) -> Dict[str, Any]:
        """The recorded traces as a Chrome trace-event document."""
        snap = self.snapshot()
        seen = set()
        events: List[Dict[str, Any]] = []
        for trace in snap["slowest"] + snap["sampled"]:
            if trace["trace_id"] in seen:
                continue
            seen.add(trace["trace_id"])
            pid = int(trace["trace_id"], 16) % (1 << 31)
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": f"trace {trace['trace_id']}"}})
            prev_send = trace["ingest_ns"]
            for hop in trace["hops"]:
                if hop["recv_ns"] > prev_send:
                    events.append({"name": "transit", "cat": "pipeline", "ph": "X",
                                   "pid": pid, "tid": 0, "ts": prev_send / 1000.0,
                                   "dur": (hop["recv_ns"] - prev_send) / 1000.0})
                events.append({"name": hop["stage"], "cat": "pipeline", "ph": "X",
                               "pid": pid, "tid": 0, "ts": hop["recv_ns"] / 1000.0,
                               "dur": max(0, hop["send_ns"] - hop["recv_ns"]) / 1000.0,
                               "args": {"trace_id": trace["trace_id"]}})
                prev_send = hop["send_ns"]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def reset(self) -> None:
        with self._lock:
            self._slowest.clear()
            self._sampled.clear()
            self._completed = 0
            self._last_trace_id = None
