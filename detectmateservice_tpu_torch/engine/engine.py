"""Engine: the data-plane runtime.

The port's copy of ``detectmateservice_tpu/engine/engine.py``:

* construction checks the processor, binds the input socket through the
  factory seam and dials every output in the background; one output that
  cannot be dialled logs and is skipped, a failed input closes everything;
* the loop receives a wire frame, unwraps it (a tenant block is stripped
  and remembered for the egress re-stamp, a v2 trace header is stripped, a
  shm reference frame counts an error and is dropped), counts it, hands it
  to the processor and fans the results out; ``None`` from the processor
  filters the message;
* with ``engine_trace`` each frame carries a trace: an untraced frame
  originates one (``TraceContext.new``), a traced one observes its transit
  from the upstream stage. The frame's context waits in a FIFO; each
  forwarded frame takes the oldest, appends this stage's hop and leaves as a
  v2 frame (``_stamp_trace``), and what did not leave by the end of the
  burst (filtered messages, deferred outputs, a terminal stage) is closed
  there (``_finalize_traces``): the pairing is exact when frames map 1:1
  through the stage and best effort under re-chunking, as in the JAX
  engine. Dwell is observed for every context; e2e and the flight recorder
  (``trace_recorder``) where the trace ends (no forwarding outputs, or
  ``trace_terminal``), or at every egress with ``trace_observe_e2e``. With
  ``telemetry_addr`` each closed hop is also offered to the span exporter
  (``telemetry/spans.py``): one deque append per frame. ``FRAME_CONTEXT``
  carries the frame's trace id and tenant for the log formatter while the
  burst is in flight;
* ``engine_batch_size == 1`` processes one message at a time; ``> 1``
  micro-batches what arrived within ``engine_batch_timeout_ms`` into
  ``process_batch``, and a processor with ``process_frames`` takes whole
  wire frames instead (fused-frame mode: expansion and featurization happen
  inside it);
* while the processor holds pending work (``pending_count() > 0``) the loop
  polls with a short timeout and calls ``drain_ready`` on each tick; a
  processor with ``drain_due_in_ms`` (a coalescer's next due time) has the
  poll end when its held rows fall due, not up to a tick later (the JAX
  engine polls at the tick only), and a burst ends at that due time
  instead of lasting ``engine_batch_timeout_ms`` (the JAX engine waits out
  the burst); the blocking ``flush`` runs only when the input goes truly
  idle, and ``flush_final`` when the loop stops;
* a chunk whose processing raises is re-dispatched one message at a time
  (poison isolation): healthy messages complete, and one that fails every
  one of its ``dlq_max_attempts`` attempts is counted and dropped;
* fan-out retries a non-blocking send up to ``engine_retry_count`` times
  10 ms apart and then drops and counts (``out_backpressure: drop``), or
  waits for the peer (``block``) inside a stoppable 1 ms poll, with one
  ``out_stop_drain_ms`` window for what is pending at stop; results pack
  ``engine_frame_batch`` to a frame; with no outputs the reply goes back on
  the input socket;
* ``stop()`` joins the loop thread within 2 s and closes every socket;
  ``start()`` reopens them;
* ``call_in_loop(fn)`` runs ``fn`` on the loop thread between frames and
  returns its result: the admin plane's way to touch the component's
  device state (a checkpoint) without racing the loop.

The JAX engine's spool, router, admission, shm transport, fault sites and
dead-letter queue are not ported; their settings raise in ``settings.py``.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Protocol, Tuple, runtime_checkable

from ..settings import ServiceSettings
from . import metrics as m
from .framing import (
    MAGIC_SHM,
    MAGIC_TEN,
    MAGIC_V2,
    FramingError,
    Hop,
    TraceContext,
    frame_msg_count,
    pack_batch,
    unpack_batch,
    unwrap_tenant,
    unwrap_trace,
    wrap_tenant,
    wrap_trace,
)
from .health import Heartbeat
from .tracing import FRAME_CONTEXT, FlightRecorder
from .socket import (
    EngineSocket,
    EngineSocketFactory,
    TransportAgain,
    TransportError,
    TransportTimeout,
    make_socket_factory,
)


class EngineException(Exception):
    """Engine lifecycle failure."""


@runtime_checkable
class Processor(Protocol):
    """Per-message processing contract."""

    def process(self, data: bytes) -> Optional[bytes]: ...


@runtime_checkable
class BatchProcessor(Protocol):
    """Batched contract: ``process_batch`` returns the in-order outputs that
    are ready (a pipelined processor may defer results to later calls).
    Optional: ``flush()`` drains everything pending, ``pending_count()``
    says how much is pending (the engine short-polls while it is > 0 and
    calls ``drain_ready()`` on each tick), ``drain_poll_ms`` sets the tick."""

    def process_batch(self, data: List[bytes]) -> List[Optional[bytes]]: ...


_RETRY_SLEEP_S = 0.01
_STOP_JOIN_S = 2.0


def count_lines(data: bytes) -> int:
    """The line-count rule: newlines, plus one for a final unterminated
    line, at least 1."""
    return max(1, data.count(b"\n") + (0 if data.endswith(b"\n") else 1))


class Engine:
    def __init__(self, settings: ServiceSettings, processor: Processor,
                 socket_factory: Optional[EngineSocketFactory] = None,
                 logger: Optional[logging.Logger] = None, health=None) -> None:
        if processor is None or not callable(getattr(processor, "process", None)):
            raise EngineException("processor must provide a callable process(bytes)")
        self.settings = settings
        self.processor = processor
        self.logger = logger or logging.getLogger("engine")
        self._factory = socket_factory or make_socket_factory(
            settings.transport_backend, self.logger)
        self._running = False
        self._stop_event = threading.Event()
        # the drain window of a block-mode stop, set once by the first
        # blocked send that sees the stop flag and shared by every message
        # drained after it
        self._stop_drain_deadline: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._sockets_closed = False
        self._labels = dict(component_type=settings.component_type,
                            component_id=settings.component_id or "unknown")
        self._m_written_b = m.DATA_WRITTEN_BYTES().labels(**self._labels)
        self._m_written_l = m.DATA_WRITTEN_LINES().labels(**self._labels)
        self._m_dropped_b = m.DATA_DROPPED_BYTES().labels(**self._labels)
        self._m_dropped_l = m.DATA_DROPPED_LINES().labels(**self._labels)
        self._m_send_backlog = m.OUTPUT_SEND_BACKLOG().labels(**self._labels)

        self._hb_loop = Heartbeat("engine_loop")
        self._hb_ingest = Heartbeat("ingest")
        self._hb_output = Heartbeat("output_pump")
        if health is not None:
            health.register_engine(self._hb_loop, self._hb_ingest, self._hb_output,
                                   lambda: self._running)

        # pipeline tracing: inbound v2 headers are stripped whether or not
        # this stage traces; it stamps only with engine_trace, which rides
        # the frame magic detection (hence the autodetect gate)
        self._trace_enabled = settings.engine_trace and settings.engine_frame_autodetect
        self._trace_stage = (settings.trace_stage or settings.component_name
                             or settings.component_type)
        self._trace_terminal = settings.trace_terminal
        self._trace_observe_e2e = settings.trace_observe_e2e
        # (TraceContext, recv_ns) of the frames of the burst being
        # dispatched: taken by forwarded frames, closed at burst end
        self._trace_pending: deque = deque()
        self.trace_recorder = FlightRecorder(max_slowest=settings.trace_slowest,
                                             max_sampled=settings.trace_sampled,
                                             sample_every=settings.trace_sample_every)
        if self._trace_enabled:
            self._dwell_obs = m.PIPELINE_STAGE_DWELL().labels(**self._labels).observe
            self._transit_obs = m.PIPELINE_TRANSIT().labels(**self._labels).observe
            self._e2e_obs = m.PIPELINE_E2E_LATENCY().labels(**self._labels).observe
        self._frame_ctx = FRAME_CONTEXT
        self._telemetry = None
        if self._trace_enabled and settings.telemetry_addr:
            from ..telemetry.spans import SpanExporter

            self._telemetry = SpanExporter(
                settings, self._factory, self._trace_stage, self._labels, self.logger,
                events=health.emit_event if health is not None else None)

        # tenants of the ingress frames of the burst being dispatched, in
        # order: each forwarded frame is stamped with the oldest (exact when
        # frames map 1:1 through the stage, approximate under re-chunking)
        self._tenant_pending: deque = deque()
        # a coalescing processor is told each ingress frame's tenant
        self._note_tenant = getattr(processor, "note_tenant", None)
        # callables the admin plane hands to the loop thread (call_in_loop),
        # queued only while the loop runs
        self._calls: deque = deque()
        self._calls_lock = threading.Lock()
        self._loop_accepts = False

        self._pair_sock: EngineSocket = self._create_ingress()
        self._out_socks: List[EngineSocket] = []
        try:
            self._setup_output_sockets()
        except Exception:
            self._pair_sock.close()
            raise

    # ------------------------------------------------------------------
    def _create_ingress(self) -> EngineSocket:
        sock = self._factory.create(self.settings.engine_addr, self.logger)
        sock.recv_timeout = self.settings.engine_recv_timeout
        return sock

    def _setup_output_sockets(self) -> None:
        for addr in self.settings.out_addr:
            try:
                self._out_socks.append(self._factory.create_output(
                    addr, self.logger, None, dial_timeout=self.settings.out_dial_timeout,
                    buffer_size=self.settings.engine_buffer_size))
            except (TransportError, OSError) as exc:
                self.logger.error("cannot dial output %s: %s (continuing)", addr, exc)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> str:
        """Start (or restart) the loop thread; a restart after ``stop()``
        reopens the sockets first."""
        if self._running:
            return "already running"
        if self._sockets_closed:
            self._pair_sock = self._create_ingress()
            self._out_socks = []
            try:
                self._setup_output_sockets()
            except Exception:
                self._close_all()
                raise
            self._sockets_closed = False
        self._stop_event.clear()
        self._stop_drain_deadline = None
        # a restart must not trip the watchdog on ages accumulated while
        # the engine was (healthily) down
        self._hb_loop.beat()
        self._hb_ingest.beat()
        self._hb_output.wait_end()
        self._running = True
        if self._telemetry is not None:
            self._telemetry.start()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run_loop, name="EngineLoop",
                                            daemon=True)
        self._thread.start()
        self.logger.info("engine started")
        return "engine started"

    def stop(self) -> None:
        if not self._running and self._thread is None:
            self._close_all()
            return
        self._running = False
        self._stop_event.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=_STOP_JOIN_S)
            if thread.is_alive():
                raise EngineException("engine thread did not stop within deadline")
        self._thread = None
        self._close_all()
        self.logger.info("engine stopped")

    def _close_all(self) -> None:
        self._sockets_closed = True
        if self._telemetry is not None:
            # its sender thread drains the queue once more before it joins
            self._telemetry.stop()
        for sock in [self._pair_sock, *self._out_socks]:
            try:
                sock.close()
            except TransportError:
                pass

    @property
    def running(self) -> bool:
        return self._running

    def call_in_loop(self, fn: Callable[[], object], timeout: float = 120.0):
        """``fn()`` on the loop thread between frames, its result returned
        (its exception raised) here; called directly when no loop runs."""
        with self._calls_lock:
            queued = self._loop_accepts and threading.current_thread() is not self._thread
            if queued:
                future: Future = Future()
                self._calls.append((fn, future))
        if not queued:
            return fn()
        return future.result(timeout=timeout)

    def _run_calls(self) -> None:
        while self._calls:
            fn, future = self._calls.popleft()
            try:
                future.set_result(fn())
            except Exception as exc:  # noqa: BLE001 — handed to the caller
                future.set_exception(exc)

    # -- ingress ----------------------------------------------------------
    def _ingest_trace(self, raw: bytes, err_c) -> Optional[bytes]:
        """Strip a v2 trace header and, when tracing, queue the frame's
        context; the payload is the v1 wire unit. A garbled trace block
        counts an error and keeps the payload (this stage then originates a
        trace); a block running past the frame end loses the frame. One
        clock read per frame."""
        ctx = None
        if raw.startswith(MAGIC_V2):
            try:
                raw, ctx, damaged = unwrap_trace(raw)
            except FramingError as exc:
                err_c.inc()
                self.logger.error("corrupt traced frame dropped: %s", exc)
                return None
            if damaged:
                err_c.inc()
                self.logger.warning("garbled trace block stripped; payload messages kept")
        if not self._trace_enabled:
            return raw
        now = time.time_ns()
        if ctx is not None:
            prev = ctx.hops[-1].send_ns if ctx.hops else ctx.ingest_ns
            self._transit_obs(max(0, now - prev) / 1e9)
        else:
            ctx = TraceContext.new(now)
        self._trace_pending.append((ctx, now))
        self._frame_ctx.trace_id = ctx.trace_id
        return raw

    def _stamp_trace(self, payload: bytes, now_ns: int) -> bytes:
        """The oldest pending context's hop completed, ``payload`` wrapped
        as a v2 frame for the downstream stage. With ``trace_observe_e2e``
        this egress also observes e2e and feeds the flight recorder (which
        keeps a copy: hops appended downstream do not change it)."""
        ctx, recv_ns = self._trace_pending.popleft()
        ctx.hops.append(Hop(self._trace_stage, recv_ns, now_ns))
        self._dwell_obs(max(0, now_ns - recv_ns) / 1e9)
        tel = self._telemetry
        if self._trace_observe_e2e:
            self._observe_e2e(ctx, max(0, now_ns - ctx.ingest_ns) / 1e9)
        if tel is not None:
            tel.offer(ctx.trace_id, ctx.ingest_ns, recv_ns, now_ns, False,
                      getattr(self._frame_ctx, "tenant", None))
        return wrap_trace(payload, ctx)

    def _observe_e2e(self, ctx: TraceContext, e2e: float) -> None:
        """One completed trace: the e2e histogram (with the trace id as the
        bucket's exemplar when spans leave for a collector, which holds the
        assembled trace) and the flight recorder."""
        if self._telemetry is not None:
            self._e2e_obs(e2e, {"trace_id": f"{ctx.trace_id:016x}"})
        else:
            self._e2e_obs(e2e)
        self.trace_recorder.record(ctx, e2e)

    def _finalize_traces(self) -> None:
        """Close the contexts whose frames did not leave as v2 frames
        (filtered messages, deferred outputs, a terminal stage): dwell for
        each; e2e and the flight recorder only where the trace ends (no
        forwarding outputs, or ``trace_terminal``). The pending tenants go
        too: a later burst's frames must not take a stale one."""
        self._tenant_pending.clear()
        fc = self._frame_ctx
        if not self._trace_pending:
            fc.trace_id = None
            fc.tenant = None
            return
        now = time.time_ns()
        terminal = (self._trace_terminal if self._trace_terminal is not None
                    else not self._out_socks)
        tel = self._telemetry
        tenant = getattr(fc, "tenant", None)
        while self._trace_pending:
            ctx, recv_ns = self._trace_pending.popleft()
            ctx.hops.append(Hop(self._trace_stage, recv_ns, now))
            self._dwell_obs(max(0, now - recv_ns) / 1e9)
            if terminal:
                self._observe_e2e(ctx, max(0, now - ctx.ingest_ns) / 1e9)
            if tel is not None:
                tel.offer(ctx.trace_id, ctx.ingest_ns, recv_ns, now, terminal, tenant)
        fc.trace_id = None
        fc.tenant = None

    def _telemetry_flag(self, flag: str) -> None:
        """A verdict flag (``error``, ``quarantined``) for the trace being
        processed: the oldest pending context's, as the failing message's
        own trace is not known after expansion (best effort, like the
        tenant pairing)."""
        if self._telemetry is not None and self._trace_pending:
            self._telemetry.offer_flag(self._trace_pending[0][0].trace_id, flag)

    def _strip_tenant(self, raw: bytes, err_c) -> Tuple[Optional[bytes], Optional[str]]:
        """Strip one tenant block → ``(payload, tenant)``; a garbled id counts
        an error and keeps the payload untenanted."""
        try:
            payload, tenant, damaged = unwrap_tenant(raw)
        except FramingError as exc:
            err_c.inc()
            self.logger.error("corrupt tenant frame dropped: %s", exc)
            return None, None
        if damaged:
            err_c.inc()
            self.logger.warning("garbled tenant block stripped; payload messages kept")
        return (payload or None), tenant

    def _unwrap(self, raw: bytes, read_b, err_c) -> Optional[bytes]:
        """One wire frame at ingress: a shm reference is dropped and counted,
        a tenant block stripped (and queued for the egress re-stamp when the
        stage forwards), the payload bytes counted read, a v2 trace header
        stripped (and the frame's trace queued when tracing). None when
        nothing of the frame survives."""
        if raw[0] == 0xD7 and raw.startswith(MAGIC_SHM):
            err_c.inc()
            self.logger.error("shm reference frame dropped: the port has no "
                              "shared-memory transport")
            return None
        tenant = None
        if raw[0] == 0xD7 and raw.startswith(MAGIC_TEN):
            raw, tenant = self._strip_tenant(raw, err_c)
            if not raw:
                return None
        # None clears the previous frame's tenant
        self._frame_ctx.tenant = tenant
        if self._note_tenant is not None:
            self._note_tenant(tenant)
        if tenant is not None and self._out_socks:
            self._tenant_pending.append(tenant)
        read_b.inc(len(raw))
        if self._trace_enabled or (raw[0] == 0xD7 and raw.startswith(MAGIC_V2)):
            return self._ingest_trace(raw, err_c) or None
        return raw

    def _expand_frame(self, raw: bytes, read_b, read_l, err_c) -> List[bytes]:
        """One wire frame → its messages. Batch frames are told apart by
        their magic, which no protobuf message can begin with; a pipeline
        with other payloads sets ``engine_frame_autodetect: false``. Bytes
        count once per frame, lines per contained message."""
        if not self.settings.engine_frame_autodetect:
            read_b.inc(len(raw))
            read_l.inc(count_lines(raw))
            return [raw]
        raw = self._unwrap(raw, read_b, err_c)
        if raw is None:
            return []
        try:
            msgs = unpack_batch(raw)
        except FramingError as exc:
            err_c.inc()
            self.logger.error("corrupt batch frame dropped: %s", exc)
            return []
        if msgs is None:
            msgs = [raw]
        else:
            # packed empties are skipped like plain empty frames
            msgs = [msg for msg in msgs if msg]
        read_l.inc(sum(map(count_lines, msgs)))
        return msgs

    @staticmethod
    def _burst_deadline(batch_timeout_s: float, held_until: Optional[float]) -> float:
        """A burst lasts ``engine_batch_timeout_ms``, and ends earlier when
        rows held from before it fall due."""
        deadline = time.monotonic() + batch_timeout_s
        return deadline if held_until is None else min(deadline, held_until)

    def _collect_burst(self, deadline: float, remaining_fn, on_frame) -> None:
        """Receive further frames until ``deadline`` or until
        ``remaining_fn()`` (items still wanted, also recv_many's count) is
        0; ``on_frame`` takes each non-empty frame."""
        recv_many = getattr(self._pair_sock, "recv_many", None)
        saved_timeout = None if callable(recv_many) else self._pair_sock.recv_timeout
        while remaining_fn() > 0:
            remaining_ms = (deadline - time.monotonic()) * 1000.0
            if remaining_ms <= 0:
                break
            try:
                if callable(recv_many):
                    frames = recv_many(remaining_fn(), max(1, int(remaining_ms)))
                else:
                    self._pair_sock.recv_timeout = max(1, int(remaining_ms))
                    frames = [self._pair_sock.recv()]
            except (TransportTimeout, TransportError):
                break
            for nxt in frames:
                if nxt:
                    on_frame(nxt)
        if saved_timeout is not None:
            self._pair_sock.recv_timeout = saved_timeout

    def _run_loop(self) -> None:
        read_b = m.DATA_READ_BYTES().labels(**self._labels)
        read_l = m.DATA_READ_LINES().labels(**self._labels)
        err_c = m.PROCESSING_ERRORS().labels(**self._labels)
        ingress_g = m.INGRESS_BACKLOG().labels(**self._labels)
        batch_size = max(1, self.settings.engine_batch_size)
        batch_fn = getattr(self.processor, "process_batch", None)
        use_batches = batch_size > 1 and callable(batch_fn)
        frames_fn = getattr(self.processor, "process_frames", None)
        use_frames = (use_batches and callable(frames_fn)
                      and self.settings.engine_frame_autodetect)
        batch_timeout_s = self.settings.engine_batch_timeout_ms / 1000.0
        if self.settings.engine_frame_batch > 1 and not use_batches:
            self.logger.warning(
                "engine_frame_batch=%d has no effect without micro-batching "
                "(engine_batch_size > 1 and a batch-capable component)",
                self.settings.engine_frame_batch)
        flush_fn = getattr(self.processor, "flush", None)
        pending_fn = getattr(self.processor, "pending_count", None) if use_batches else None
        # a short-poll tick is not idleness: drain only what is already
        # host-readable, never wait on the device while traffic queues
        drain_fn = getattr(self.processor, "drain_ready", None)
        due_fn = getattr(self.processor, "drain_due_in_ms", None) if pending_fn else None
        base_timeout = self.settings.engine_recv_timeout
        try:
            hint = int(getattr(self.processor, "drain_poll_ms", 0) or 0)
        except (TypeError, ValueError):
            hint = 0
        short_timeout = (min(base_timeout, max(1, hint)) if hint > 0
                         else min(5, base_timeout))
        current_timeout = base_timeout
        with self._calls_lock:
            self._loop_accepts = True
        try:
            while self._running and not self._stop_event.is_set():
                self._hb_loop.beat()
                if self._calls:
                    self._run_calls()
                # the held rows' due time on the monotonic clock: a burst
                # ends there
                held_until = None
                if callable(pending_fn):
                    want = short_timeout if pending_fn() > 0 else base_timeout
                    due = due_fn() if want == short_timeout and callable(due_fn) else None
                    if due is not None:
                        # wake when the held rows fall due, not a tick later
                        want = max(1, min(short_timeout, math.ceil(due)))
                        held_until = time.monotonic() + due / 1000.0
                    if want != current_timeout:
                        self._pair_sock.recv_timeout = want
                        current_timeout = want
                try:
                    raw = self._pair_sock.recv()
                except TransportTimeout:
                    # a short-poll tick drains what has landed; the true idle
                    # timeout flushes
                    fn = (drain_fn if current_timeout <= short_timeout and callable(drain_fn)
                          else flush_fn)
                    if callable(fn):
                        try:
                            self._send_results(fn())
                        except Exception as exc:  # noqa: BLE001 — the loop outlives the processor
                            err_c.inc()
                            self.logger.error("idle drain raised: %s", exc)
                    continue
                except TransportError as exc:
                    if not self._running:
                        break
                    self.logger.error("engine recv failed: %s", exc)
                    time.sleep(0.05)  # no busy spin on a persistently failing socket
                    continue
                if not raw:
                    continue
                self._hb_ingest.beat()

                if use_frames:
                    # whole frames to the component, the burst capped by the
                    # messages their headers declare
                    def ingest_wire(nxt: bytes) -> Optional[bytes]:
                        return self._unwrap(nxt, read_b, err_c)

                    raw = ingest_wire(raw)
                    frames = [raw] if raw else []
                    est = [frame_msg_count(raw) if raw else 0]

                    def on_frame(nxt: bytes) -> None:
                        nxt = ingest_wire(nxt)
                        if nxt is None:
                            return
                        frames.append(nxt)
                        est[0] += frame_msg_count(nxt)

                    self._collect_burst(self._burst_deadline(batch_timeout_s, held_until),
                                        lambda: batch_size - est[0], on_frame)
                    if not frames:
                        continue
                    ingress_g.set(est[0])
                    outs, n_lines = self._dispatch_frames(frames_fn, frames, err_c)
                    read_l.inc(n_lines)
                    self._send_results(outs)
                    self._finalize_traces()
                    continue

                msgs = self._expand_frame(raw, read_b, read_l, err_c)
                if not msgs:
                    self._finalize_traces()
                    continue

                if not use_batches:
                    for msg_raw in msgs:
                        out = self._dispatch_single(msg_raw, err_c)
                        if out is not None:
                            self._send_results([out])
                    if self._trace_pending:
                        self._finalize_traces()
                    continue

                batch = msgs

                def on_burst_frame(nxt: bytes) -> None:
                    batch.extend(self._expand_frame(nxt, read_b, read_l, err_c))

                self._collect_burst(self._burst_deadline(batch_timeout_s, held_until),
                                    lambda: batch_size - len(batch), on_burst_frame)
                ingress_g.set(len(batch))
                # a packed frame can carry more than engine_batch_size messages:
                # the component never sees a batch beyond the cap
                for start in range(0, len(batch), batch_size):
                    self._send_results(self._dispatch_chunk(
                        batch_fn, batch[start:start + batch_size], err_c))
                if self._trace_pending:
                    self._finalize_traces()
        finally:
            with self._calls_lock:
                self._loop_accepts = False
            self._run_calls()
        # stop: drain the pipeline before the sockets close; flush_final may
        # wait out work a flush leaves running (a background fit)
        final_fn = getattr(self.processor, "flush_final", None) or flush_fn
        if callable(final_fn):
            try:
                self._send_results(final_fn())
            except Exception as exc:  # noqa: BLE001 — stop must complete
                self.logger.error("flush at stop raised: %s", exc)
        self._finalize_traces()

    # -- dispatch with poison isolation -----------------------------------
    def _dispatch_chunk(self, batch_fn, chunk: List[bytes], err_c) -> List:
        """``process_batch``; on failure the chunk's messages are counted
        and re-dispatched one at a time."""
        try:
            return batch_fn(chunk)
        except Exception as exc:  # noqa: BLE001 — isolated below
            err_c.inc(len(chunk))
            self._telemetry_flag("error")
            self.logger.error("process_batch() raised: %s — isolating %d messages",
                              exc, len(chunk))
            return self._isolate_poison(batch_fn, chunk, exc)

    def _drop_poison(self, what: str, exc: BaseException, attempts: int) -> None:
        self._telemetry_flag("quarantined")
        self.logger.error("%s dropped after %d failed attempts: %s: %s",
                          what, attempts, type(exc).__name__, exc)

    def _isolate_poison(self, batch_fn, chunk: List[bytes], chunk_exc: BaseException) -> List:
        """Each message of a failed chunk alone; the chunk's failure counts as
        each message's first attempt, and a message failing every attempt is
        dropped."""
        retries = max(1, self.settings.dlq_max_attempts - 1)
        outs: List = []
        for msg in chunk:
            last: BaseException = chunk_exc
            for _ in range(retries):
                try:
                    res = batch_fn([msg])
                except Exception as exc:  # noqa: BLE001 — retried, then dropped
                    last = exc
                    continue
                if res:
                    outs.extend(res)
                break
            else:
                self._drop_poison("message", last, 1 + retries)
        return outs

    def _dispatch_single(self, msg: bytes, err_c):
        """``process`` with a bounded attempt budget; a message failing
        every attempt is counted once and dropped."""
        attempts = max(1, self.settings.dlq_max_attempts)
        last: Optional[BaseException] = None
        for _ in range(attempts):
            try:
                return self.processor.process(msg)
            except Exception as exc:  # noqa: BLE001 — retried, then dropped
                last = exc
        err_c.inc()
        self._telemetry_flag("error")
        self._drop_poison("message", last, attempts)
        return None

    def _dispatch_frames(self, frames_fn, frames: List[bytes], err_c):
        """Fused-frame dispatch with the same isolation, frame by frame;
        returns ``(outs, n_lines)``."""
        try:
            outs, _n_msgs, n_lines = frames_fn(frames)
            return outs, n_lines
        except Exception as exc:  # noqa: BLE001 — isolated below
            err_c.inc(len(frames))
            self._telemetry_flag("error")
            self.logger.error("process_frames() raised: %s — isolating %d frames",
                              exc, len(frames))
        retries = max(1, self.settings.dlq_max_attempts - 1)
        outs, n_lines = [], 0
        for frame in frames:
            last: Optional[BaseException] = None
            for _ in range(retries):
                try:
                    f_outs, _n, f_lines = frames_fn([frame])
                except Exception as exc:  # noqa: BLE001 — retried, then dropped
                    last = exc
                    continue
                if f_outs:
                    outs.extend(f_outs)
                n_lines += f_lines
                break
            else:
                self._drop_poison("frame", last, 1 + retries)
        return outs, n_lines

    # -- fan-out --------------------------------------------------------
    def _send_results(self, outs) -> None:
        """Fan processor results out, ``engine_frame_batch`` of them packed
        per wire frame. With tracing, forwarding outputs and no
        ``trace_terminal``, each frame takes the oldest pending trace and
        leaves as a v2 frame (one clock read per call); a forwarded frame is
        then stamped, outermost, with the oldest pending ingress tenant. A
        reply on the input socket carries no trace: that stage ends it."""
        frame_batch = self.settings.engine_frame_batch
        pending = [o for o in outs if o is not None]
        attach = bool(self._trace_enabled and self._out_socks and not self._trace_terminal
                      and self._trace_pending and pending)
        now_ns = time.time_ns() if attach else 0
        start = 0
        while start < len(pending):
            chunk = pending[start:start + max(1, frame_batch)]
            if len(chunk) == 1:
                data, lines = chunk[0], None
            else:
                data = pack_batch(chunk)
                lines = sum(map(count_lines, chunk))
            if attach and self._trace_pending:
                # line and byte metrics count the payload, not the block
                if lines is None:
                    lines = count_lines(data)
                data = self._stamp_trace(data, now_ns)
            if self._tenant_pending:
                # line and byte metrics count the payload, not the block
                if lines is None:
                    lines = count_lines(data)
                data = wrap_tenant(data, self._tenant_pending.popleft())
            self._send_to_outputs(data, lines=lines)
            start += len(chunk)

    def _send_to_outputs(self, data: bytes, lines: Optional[int] = None) -> bool:
        written_b, written_l = self._m_written_b, self._m_written_l
        dropped_b, dropped_l = self._m_dropped_b, self._m_dropped_l
        if lines is None:
            lines = count_lines(data)

        if not self._out_socks:
            # no outputs: reply on the input socket
            try:
                self._pair_sock.send(data)
                written_b.inc(len(data))
                written_l.inc(lines)
                return True
            except (TransportAgain, TransportError) as exc:
                self.logger.warning("reply undeliverable: %s", exc)
                dropped_b.inc(len(data))
                dropped_l.inc(lines)
                return False

        any_ok = False
        wrote_once = False

        def mark_sent() -> None:
            nonlocal any_ok, wrote_once
            any_ok = True
            if not wrote_once:
                # written counts once per message, dropped once per socket
                written_b.inc(len(data))
                written_l.inc(lines)
                wrote_once = True

        if self.settings.out_backpressure == "block":
            # flow control: a stoppable 1 ms poll over every socket not yet
            # served, so one stalled peer does not block the healthy ones
            # and a stop drains within out_stop_drain_ms
            pending_socks = list(self._out_socks)
            waited = False
            while pending_socks:
                if not self._running or self._stop_event.is_set():
                    if self._stop_drain_deadline is None:
                        self._stop_drain_deadline = (
                            time.monotonic() + self.settings.out_stop_drain_ms / 1000.0)
                    if time.monotonic() >= self._stop_drain_deadline:
                        break
                still: List[EngineSocket] = []
                for sock in pending_socks:
                    try:
                        sock.send(data, block=False)
                    except TransportAgain:
                        still.append(sock)
                        continue
                    except TransportError as exc:
                        self.logger.warning("output send failed hard: %s", exc)
                        dropped_b.inc(len(data))
                        dropped_l.inc(lines)
                        continue
                    mark_sent()
                if len(still) == len(pending_socks):
                    self._m_send_backlog.set(len(still))
                    if not waited:
                        self._hb_output.wait_begin()
                    else:
                        self._hb_output.beat()
                    waited = True
                    time.sleep(0.001)
                pending_socks = still
            for _ in pending_socks:  # the stop-drain window expired
                dropped_b.inc(len(data))
                dropped_l.inc(lines)
            if waited:
                self._m_send_backlog.set(0)
                self._hb_output.wait_end()
            return any_ok

        waited = False
        for sock in self._out_socks:
            sent = False
            for _ in range(self.settings.engine_retry_count):
                try:
                    sock.send(data, block=False)
                    sent = True
                    break
                except TransportAgain:
                    if not waited:
                        self._m_send_backlog.set(1)
                        waited = True
                    self._hb_output.beat()
                    time.sleep(_RETRY_SLEEP_S)
                except TransportError as exc:
                    self.logger.warning("output send failed hard: %s", exc)
                    break
            if sent:
                mark_sent()
            else:
                dropped_b.inc(len(data))
                dropped_l.inc(lines)
        if waited:
            self._m_send_backlog.set(0)
        return any_ok
