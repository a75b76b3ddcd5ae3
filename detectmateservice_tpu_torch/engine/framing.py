"""Batch frames: many serialized messages in one wire frame.

The port's own copy of the batch frame of
``detectmateservice_tpu/engine/framing.py`` (wire format version 1):

    0xD7 'D' 'M' 0x01 | varint n | n × (varint len | len bytes)

The first byte 0xD7 decodes as protobuf field 26 / wire type 7, a wire type
that does not exist, so no valid protobuf message begins with it and a
receiver tells a batch frame from a single message by its first four bytes.
Any frame without the magic is one message, as the native featurizer's
count pass reads it (``native/dmfeat.c`` ``dm_count_frame_msgs``); the
traced, tenant, shm and span frames of the JAX package are not ported.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

MAGIC = b"\xd7DM\x01"


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


def frame_msg_count(data: bytes) -> int:
    """Cheap message-count estimate for burst sizing: the header varint of a
    batch frame, 1 for a single message, 0 for an empty frame or a garbled
    header. Does not validate the body (``unpack_batch`` does)."""
    if not data:
        return 0
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
