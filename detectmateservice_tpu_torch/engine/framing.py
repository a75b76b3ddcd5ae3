"""Batch frames: many serialized messages in one wire frame.

The port's own copy of the batch frame of
``detectmateservice_tpu/engine/framing.py`` (wire format version 1):

    0xD7 'D' 'M' 0x01 | varint n | n × (varint len | len bytes)

The first byte 0xD7 decodes as protobuf field 26 / wire type 7, a wire type
that does not exist, so no valid protobuf message begins with it and a
receiver tells a batch frame from a single message by its first four bytes.
Any frame without the magic is one message, as the native featurizer's
count pass reads it (``native/dmfeat.c`` ``dm_count_frame_msgs``).

The engine also reads the wrappers of the v2 frame family, which share the
0xD7 lead byte, as the JAX package's engine does:

* the traced frame ``0xD7 'D' 'M' 0x02 | varint trace_len | trace block |
  payload``, where the payload is a complete v1 wire unit: the engine strips
  the trace block at ingress (``unwrap_trace``) and, with ``engine_trace``,
  stamps its hop and forwards a traced frame (``wrap_trace``);
* the tenant frame ``0xD7 'D' 'M' 0x04 | varint id_len | tenant id utf-8 |
  payload``, the outermost wrapper: stripped at ingress (``unwrap_tenant``)
  and stamped again outermost on forwarded frames (``wrap_tenant``);
* the shm reference frame ``0xD7 'D' 'M' 0x03 | ...``, recognised by its
  magic only: the port has no shared-memory transport, so the engine counts
  one as a processing error and drops it;
* the span frame ``0xD7 'D' 'M' 0x05 | varint body_len | span JSON utf-8``,
  the telemetry channel from a stage's span exporter to the collector
  (``telemetry/``): never on a data link.

The trace block is ``trace_id (8 bytes) | varint ingest_ns | varint n_hops |
n_hops × (varint name_len | name utf-8 | varint recv_ns | varint send_ns)``,
the timestamps ``time.time_ns()`` epoch nanoseconds. A garbled block is
skipped by its declared length and its payload survives; only a length
running past the frame end loses the frame.
"""
from __future__ import annotations

import itertools
import json
import os
from typing import List, NamedTuple, Optional, Tuple

MAGIC = b"\xd7DM\x01"
MAGIC_V2 = b"\xd7DM\x02"
MAGIC_SHM = b"\xd7DM\x03"
MAGIC_TEN = b"\xd7DM\x04"
MAGIC_SPAN = b"\xd7DM\x05"


class FramingError(ValueError):
    """A frame carried the batch magic but its body was malformed."""


def _put_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _get_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise FramingError("truncated varint in batch frame")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise FramingError("varint overflow in batch frame")


def pack_batch(messages: List[bytes]) -> bytes:
    """Pack serialized messages into one batch frame."""
    out = bytearray(MAGIC)
    _put_varint(out, len(messages))
    for msg in messages:
        _put_varint(out, len(msg))
        out += msg
    return bytes(out)


def _skip_block(data: bytes, magic: bytes) -> Optional[bytes]:
    """What follows the length-prefixed block of a wrapper frame, or None
    when its length is garbled or runs past the frame end."""
    try:
        block_len, pos = _get_varint(data, len(magic))
    except FramingError:
        return None
    start = pos + block_len
    return None if start > len(data) else data[start:]


def frame_msg_count(data: bytes) -> int:
    """Cheap message-count estimate for burst sizing: the header varint of a
    batch frame, 1 for a single message, 0 for an empty frame or a garbled
    header; tenant and traced frames count by their payload. Does not
    validate the body (``unpack_batch`` does)."""
    if not data:
        return 0
    for magic in (MAGIC_TEN, MAGIC_V2):
        if data.startswith(magic):
            payload = _skip_block(data, magic)
            return 0 if payload is None else frame_msg_count(payload)
    if not data.startswith(MAGIC):
        return 1
    try:
        count, _ = _get_varint(data, len(MAGIC))
    except FramingError:
        return 0
    return count


def unpack_batch(data: bytes) -> Optional[List[bytes]]:
    """Batch frame → messages; None when ``data`` is a plain single message
    (no magic). Raises FramingError on a corrupt batch body."""
    if not data.startswith(MAGIC):
        return None
    count, pos = _get_varint(data, len(MAGIC))
    messages: List[bytes] = []
    for _ in range(count):
        length, pos = _get_varint(data, pos)
        end = pos + length
        if end > len(data):
            raise FramingError("truncated message in batch frame")
        messages.append(data[pos:end])
        pos = end
    if pos != len(data):
        raise FramingError("trailing bytes after batch frame body")
    return messages


# -- trace blocks (v2 frames) ------------------------------------------------


# trace ids: one random 64-bit base per process, then a counter (``next``
# is atomic under the interpreter lock): no syscall on the per-frame path
_TRACE_ID_BASE = int.from_bytes(os.urandom(8), "big")
_TRACE_ID_SEQ = itertools.count()


class Hop(NamedTuple):
    """One stage transit record: when the frame entered and left the stage."""

    stage: str
    recv_ns: int
    send_ns: int


class TraceContext:
    """Per-frame trace state carried by the v2 trace block; each stage that
    stamps appends its ``Hop``."""

    __slots__ = ("trace_id", "ingest_ns", "hops")

    def __init__(self, trace_id: int, ingest_ns: int,
                 hops: Optional[List[Hop]] = None) -> None:
        self.trace_id = trace_id
        self.ingest_ns = ingest_ns
        self.hops: List[Hop] = hops if hops is not None else []

    @classmethod
    def new(cls, ingest_ns: int) -> "TraceContext":
        return cls((_TRACE_ID_BASE + next(_TRACE_ID_SEQ)) & 0xFFFFFFFFFFFFFFFF, ingest_ns)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext) and self.trace_id == other.trace_id
                and self.ingest_ns == other.ingest_ns and self.hops == other.hops)

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id:#018x}, ingest={self.ingest_ns},"
                f" hops={self.hops!r})")


def pack_trace_block(ctx: TraceContext) -> bytes:
    out = bytearray(ctx.trace_id.to_bytes(8, "big"))
    _put_varint(out, ctx.ingest_ns)
    _put_varint(out, len(ctx.hops))
    for hop in ctx.hops:
        name = hop.stage.encode("utf-8")
        _put_varint(out, len(name))
        out += name
        _put_varint(out, hop.recv_ns)
        _put_varint(out, hop.send_ns)
    return bytes(out)


def parse_trace_block(block: bytes) -> TraceContext:
    """Trace block bytes → TraceContext; raises FramingError on damage."""
    if len(block) < 8:
        raise FramingError("trace block shorter than the 8-byte trace id")
    trace_id = int.from_bytes(block[:8], "big")
    ingest_ns, pos = _get_varint(block, 8)
    n_hops, pos = _get_varint(block, pos)
    hops: List[Hop] = []
    for _ in range(n_hops):
        name_len, pos = _get_varint(block, pos)
        end = pos + name_len
        if end > len(block):
            raise FramingError("truncated hop name in trace block")
        try:
            stage = block[pos:end].decode("utf-8")
        except UnicodeDecodeError as exc:
            raise FramingError(f"non-UTF-8 hop name in trace block: {exc}") from exc
        recv_ns, pos = _get_varint(block, end)
        send_ns, pos = _get_varint(block, pos)
        hops.append(Hop(stage, recv_ns, send_ns))
    if pos != len(block):
        raise FramingError("trailing bytes after trace block hops")
    return TraceContext(trace_id, ingest_ns, hops)


def wrap_trace(payload: bytes, ctx: TraceContext) -> bytes:
    """Payload (a v1 batch frame or a single message) → v2 frame."""
    block = pack_trace_block(ctx)
    out = bytearray(MAGIC_V2)
    _put_varint(out, len(block))
    out += block
    out += payload
    return bytes(out)


def unwrap_trace(data: bytes) -> Tuple[bytes, Optional[TraceContext], bool]:
    """v2 frame → ``(payload, trace, trace_damaged)``.

    Non-v2 input passes through as ``(data, None, False)``. A garbled trace
    block is skipped by its declared length: the payload survives and
    ``trace_damaged`` is True. Only a declared length running past the frame
    end raises FramingError."""
    if not data.startswith(MAGIC_V2):
        return data, None, False
    trace_len, pos = _get_varint(data, len(MAGIC_V2))
    start = pos + trace_len
    if start > len(data):
        raise FramingError("trace block length exceeds frame size")
    try:
        ctx = parse_trace_block(data[pos:start])
    except FramingError:
        return data[start:], None, True
    return data[start:], ctx, False


def peek_trace_id(data: bytes) -> Optional[int]:
    """The trace id of a v2 frame (behind a tenant block, if any) without
    parsing its hops; None for other frames and for a declared block too
    short to hold an id."""
    if data.startswith(MAGIC_TEN):
        data = _skip_block(data, MAGIC_TEN)
        if data is None:
            return None
    if not data.startswith(MAGIC_V2):
        return None
    try:
        trace_len, pos = _get_varint(data, len(MAGIC_V2))
    except FramingError:
        return None
    if trace_len < 8 or pos + 8 > len(data):
        return None
    return int.from_bytes(data[pos:pos + 8], "big")


# -- tenant attribution --------------------------------------------------------


def wrap_tenant(payload: bytes, tenant: str) -> bytes:
    """Payload (any complete wire unit) → tenant frame, the tenant block
    outermost."""
    out = bytearray(MAGIC_TEN)
    name = tenant.encode("utf-8")
    _put_varint(out, len(name))
    out += name
    out += payload
    return bytes(out)


def unwrap_tenant(data: bytes) -> Tuple[bytes, Optional[str], bool]:
    """Tenant frame → ``(payload, tenant, tenant_damaged)``.

    Non-tenant input passes through as ``(data, None, False)``. An id that is
    not valid UTF-8 is skipped by its declared length: the payload survives
    and ``tenant_damaged`` is True. Only a declared id length running past
    the frame end raises FramingError."""
    if not data.startswith(MAGIC_TEN):
        return data, None, False
    id_len, pos = _get_varint(data, len(MAGIC_TEN))
    start = pos + id_len
    if start > len(data):
        raise FramingError("tenant id length exceeds frame size")
    try:
        tenant = data[pos:start].decode("utf-8")
    except UnicodeDecodeError:
        return data[start:], None, True
    return data[start:], tenant, False


# -- span frames (the telemetry channel) ----------------------------------------

def pack_spans(spans: List[dict]) -> bytes:
    """Span dicts → one span frame. Runs on the exporter's sender thread
    (``telemetry/spans.py``), never on the engine loop."""
    return pack_span_body(json.dumps(spans, separators=(",", ":")).encode("utf-8"))


def pack_span_body(body: bytes) -> bytes:
    """A span frame around ``body``, the compact JSON text of a list of
    span dicts."""
    out = bytearray(MAGIC_SPAN)
    _put_varint(out, len(body))
    out += body
    return bytes(out)


def unpack_spans(data: bytes) -> Optional[List[dict]]:
    """Span frame → span dicts; None when ``data`` is not a span frame.
    Raises FramingError on a garbled body: the frame is the telemetry, there
    is no payload behind it to keep."""
    if not data.startswith(MAGIC_SPAN):
        return None
    body_len, pos = _get_varint(data, len(MAGIC_SPAN))
    end = pos + body_len
    if end > len(data):
        raise FramingError("span body length exceeds frame size")
    if end != len(data):
        raise FramingError("trailing bytes after span frame body")
    try:
        spans = json.loads(data[pos:end].decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise FramingError(f"undecodable span frame body: {exc}") from exc
    if not isinstance(spans, list):
        raise FramingError("span frame body is not a JSON list")
    return spans
