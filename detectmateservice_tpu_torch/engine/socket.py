"""Data-plane transport: the pair-socket surface over zmq.

The port's copy of the zmq backend of ``detectmateservice_tpu/engine/
socket.py``: a DEALER socket per endpoint for ``ipc://``, ``tcp://`` and
``inproc://`` (libzmq reconnects in the background and buffers up to a
high-water mark; DEALER-DEALER is bidirectional 1:1), so the port's stages
speak the same wire as the JAX package's. The in-process queue transport
serves the tests. The exception taxonomy is the JAX package's
(``TransportTimeout`` / ``TransportAgain`` / ``TransportError``), because
the engine's retry and drop logic is written against it.

The JAX package's other transports (``native``, ``tls+tcp``, ``nng+tcp``,
``nng+tls+tcp``, ``ws``) are not ported: asking for one raises
``TransportError``.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Dict, List, Optional, Protocol, runtime_checkable

import zmq

# schemes of the JAX package's data plane that the port does not carry yet
UNPORTED_SCHEMES = ("tls+tcp", "nng+tcp", "nng+tls+tcp", "ws")


class TransportError(Exception):
    """Base transport failure."""


class TransportTimeout(TransportError):
    """recv timed out."""


class TransportAgain(TransportError):
    """Non-blocking send would block."""


class TransportClosed(TransportError):
    """Operation on a closed socket."""


@runtime_checkable
class EngineSocket(Protocol):
    """The socket surface the engine loop uses."""

    def recv(self) -> bytes: ...
    def send(self, data: bytes, block: bool = True) -> None: ...
    def close(self) -> None: ...
    @property
    def recv_timeout(self) -> Optional[int]: ...
    @recv_timeout.setter
    def recv_timeout(self, ms: Optional[int]) -> None: ...


@runtime_checkable
class EngineSocketFactory(Protocol):
    """``create`` returns a socket listening on ``addr``; ``create_output`` a
    socket dialing ``addr`` (possibly in the background)."""

    def create(self, addr: str, logger: Optional[logging.Logger] = None,
               tls_config: Optional[object] = None) -> EngineSocket: ...

    def create_output(self, addr: str, logger: Optional[logging.Logger] = None,
                      tls_config: Optional[object] = None,
                      dial_timeout: Optional[int] = None,
                      buffer_size: int = 100) -> EngineSocket: ...


def _split_scheme(addr: str) -> tuple:
    if "://" not in addr:
        raise TransportError(f"address {addr!r} has no scheme")
    scheme, rest = addr.split("://", 1)
    if scheme in UNPORTED_SCHEMES:
        raise TransportError(
            f"the {scheme}:// transport is not ported to detectmateservice_tpu_torch "
            f"yet ({addr!r}); use ipc://, tcp:// or inproc://")
    return scheme, rest


# ---------------------------------------------------------------------------
# zmq backend
# ---------------------------------------------------------------------------

_shared_ctx: Optional[zmq.Context] = None
_ctx_lock = threading.Lock()


def _context() -> zmq.Context:
    # one process-wide context so inproc:// endpoints are visible everywhere
    global _shared_ctx
    with _ctx_lock:
        if _shared_ctx is None or _shared_ctx.closed:
            _shared_ctx = zmq.Context.instance()
        return _shared_ctx


class ZmqPairSocket:
    """DEALER socket with the pair surface: 1:1 bidirectional, background
    reconnect, bounded HWM buffering; ``send(block=False)`` raises
    TransportAgain when the buffers are full (the engine drops and counts)."""

    def __init__(self, sock: zmq.Socket, addr: str, unlink_on_close: Optional[str] = None):
        self._sock = sock
        self._addr = addr
        self._closed = False
        self._recv_timeout: Optional[int] = None
        self._unlink_on_close = unlink_on_close
        self._lock = threading.Lock()

    @property
    def recv_timeout(self) -> Optional[int]:
        return self._recv_timeout

    @recv_timeout.setter
    def recv_timeout(self, ms: Optional[int]) -> None:
        self._recv_timeout = ms
        self._sock.setsockopt(zmq.RCVTIMEO, -1 if ms is None else int(ms))

    def recv(self) -> bytes:
        if self._closed:
            raise TransportClosed(f"recv on closed socket {self._addr}")
        try:
            return self._sock.recv()
        except zmq.Again as exc:
            raise TransportTimeout(str(exc) or "recv timeout") from exc
        except zmq.ZMQError as exc:
            if self._closed:
                raise TransportClosed(str(exc)) from exc
            raise TransportError(str(exc)) from exc

    def recv_many(self, max_n: int, first_timeout_ms: int) -> List[bytes]:
        """Up to ``max_n`` frames in one call: a timed recv for the first,
        then non-blocking drains. Raises TransportTimeout when nothing
        arrives within ``first_timeout_ms``."""
        if self._closed:
            raise TransportClosed(f"recv on closed socket {self._addr}")
        if max_n <= 0:
            return []
        frames: List[bytes] = []
        try:
            self._sock.setsockopt(zmq.RCVTIMEO, max(1, int(first_timeout_ms)))
            try:
                frames.append(self._sock.recv())
            finally:
                try:
                    self._sock.setsockopt(
                        zmq.RCVTIMEO,
                        -1 if self._recv_timeout is None else int(self._recv_timeout))
                except zmq.ZMQError:
                    pass  # closing mid-call: frames already read still count
            while len(frames) < max_n:
                try:
                    frames.append(self._sock.recv(flags=zmq.DONTWAIT))
                except zmq.Again:
                    break
            return frames
        except zmq.Again as exc:
            raise TransportTimeout(str(exc) or "recv timeout") from exc
        except zmq.ZMQError as exc:
            if frames:
                # frames already taken off the queue reach the caller
                return frames
            if self._closed:
                raise TransportClosed(str(exc)) from exc
            raise TransportError(str(exc)) from exc

    def send(self, data: bytes, block: bool = True) -> None:
        if self._closed:
            raise TransportClosed(f"send on closed socket {self._addr}")
        try:
            self._sock.send(data, flags=0 if block else zmq.DONTWAIT)
        except zmq.Again as exc:
            raise TransportAgain(str(exc) or "send would block") from exc
        except zmq.ZMQError as exc:
            if self._closed:
                raise TransportClosed(str(exc)) from exc
            raise TransportError(str(exc)) from exc

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._sock.close(linger=0)
        finally:
            if self._unlink_on_close:
                try:
                    os.unlink(self._unlink_on_close)
                except OSError:
                    pass


class ZmqPairSocketFactory:
    """The zmq factory for ``ipc://``, ``tcp://`` and ``inproc://``."""

    SCHEMES = ("ipc", "tcp", "inproc")

    def create(self, addr: str, logger: Optional[logging.Logger] = None,
               tls_config: Optional[object] = None) -> EngineSocket:
        logger = logger or logging.getLogger(__name__)
        scheme, rest = _split_scheme(addr)
        if scheme not in self.SCHEMES:
            raise TransportError(f"unsupported scheme {scheme!r} in {addr!r}")
        unlink = None
        if scheme == "ipc":
            # a stale ipc file from a dead process is unlinked before bind
            if os.path.exists(rest):
                try:
                    os.unlink(rest)
                    logger.debug("unlinked stale ipc file %s", rest)
                except OSError as exc:
                    raise TransportError(f"cannot unlink stale ipc file {rest}: {exc}") from exc
            unlink = rest
        if scheme == "tcp" and ":" not in rest.split("/", 1)[0]:
            raise TransportError(f"tcp address {addr!r} requires an explicit port")
        sock = _context().socket(zmq.DEALER)
        sock.setsockopt(zmq.LINGER, 0)
        try:
            sock.bind(addr)
        except zmq.ZMQError as exc:
            sock.close(linger=0)
            raise TransportError(f"cannot listen on {addr}: {exc}") from exc
        logger.debug("listening on %s", addr)
        return ZmqPairSocket(sock, addr, unlink_on_close=unlink)

    def create_output(self, addr: str, logger: Optional[logging.Logger] = None,
                      tls_config: Optional[object] = None,
                      dial_timeout: Optional[int] = None,
                      buffer_size: int = 100) -> EngineSocket:
        logger = logger or logging.getLogger(__name__)
        scheme, _ = _split_scheme(addr)
        if scheme not in self.SCHEMES:
            raise TransportError(f"unsupported scheme {scheme!r} in {addr!r}")
        sock = _context().socket(zmq.DEALER)
        sock.setsockopt(zmq.LINGER, 0)
        sock.setsockopt(zmq.SNDHWM, max(1, buffer_size))
        sock.setsockopt(zmq.RCVHWM, max(1, buffer_size))
        sock.setsockopt(zmq.RECONNECT_IVL, 100)
        # queue only to live connections: a non-blocking send to a peer that
        # is not there raises Again (counted as a drop) instead of buffering
        sock.setsockopt(zmq.IMMEDIATE, 1)
        try:
            sock.connect(addr)  # background connect
        except zmq.ZMQError as exc:
            sock.close(linger=0)
            raise TransportError(f"cannot dial {addr}: {exc}") from exc
        logger.debug("dialing %s (background connect)", addr)
        return ZmqPairSocket(sock, addr)


def make_socket_factory(backend: str = "auto",
                        logger: Optional[logging.Logger] = None) -> EngineSocketFactory:
    """Resolve a transport backend name to a factory: ``zmq`` and ``auto``
    both give the zmq factory (``auto`` never tries a native library first);
    ``native`` raises, the C++ transport is not ported."""
    if backend in ("auto", "zmq"):
        return ZmqPairSocketFactory()
    if backend == "native":
        raise TransportError(
            "the native transport is not ported to detectmateservice_tpu_torch yet; "
            "use transport_backend: zmq (or auto)")
    raise TransportError(f"unknown transport backend {backend!r}")


# ---------------------------------------------------------------------------
# in-process queue backend (tests)
# ---------------------------------------------------------------------------

class _QueuePair:
    def __init__(self, maxsize: int = 1024):
        self.a_to_b: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.b_to_a: "queue.Queue" = queue.Queue(maxsize=maxsize)


_inproc_registry: Dict[str, _QueuePair] = {}
_inproc_lock = threading.Lock()


class InprocQueueSocket:
    def __init__(self, addr: str, rq: "queue.Queue", sq: "queue.Queue"):
        self._addr = addr
        self._rq, self._sq = rq, sq
        self._closed = False
        self._recv_timeout: Optional[int] = None

    @property
    def recv_timeout(self) -> Optional[int]:
        return self._recv_timeout

    @recv_timeout.setter
    def recv_timeout(self, ms: Optional[int]) -> None:
        self._recv_timeout = ms

    def recv(self) -> bytes:
        if self._closed:
            raise TransportClosed(f"recv on closed {self._addr}")
        timeout = None if self._recv_timeout is None else self._recv_timeout / 1000.0
        try:
            return self._rq.get(timeout=timeout)
        except queue.Empty:
            raise TransportTimeout("recv timeout") from None

    def send(self, data: bytes, block: bool = True) -> None:
        if self._closed:
            raise TransportClosed(f"send on closed {self._addr}")
        try:
            self._sq.put(data, block=block)
        except queue.Full:
            raise TransportAgain("send queue full") from None

    def close(self) -> None:
        self._closed = True


class InprocQueueSocketFactory:
    """Queue-based factory for tests and single-process demos."""

    def __init__(self, maxsize: int = 1024):
        self._maxsize = maxsize

    def _pair(self, addr: str) -> _QueuePair:
        with _inproc_lock:
            pair = _inproc_registry.get(addr)
            if pair is None:
                pair = _QueuePair(self._maxsize)
                _inproc_registry[addr] = pair
            return pair

    def create(self, addr: str, logger: Optional[logging.Logger] = None,
               tls_config: Optional[object] = None) -> EngineSocket:
        pair = self._pair(addr)
        return InprocQueueSocket(addr, rq=pair.a_to_b, sq=pair.b_to_a)

    def create_output(self, addr: str, logger: Optional[logging.Logger] = None,
                      tls_config: Optional[object] = None,
                      dial_timeout: Optional[int] = None,
                      buffer_size: int = 100) -> EngineSocket:
        pair = self._pair(addr)
        return InprocQueueSocket(addr, rq=pair.b_to_a, sq=pair.a_to_b)
