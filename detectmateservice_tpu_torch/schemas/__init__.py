"""Pipeline message schemas: a pure-Python proto3 codec.

Counterpart of ``detectmateservice_tpu/schemas`` without ``protobuf``: the
wire format is written and read by hand, with the field numbers, types and
proto3-optional presence of ``schemas.proto`` (the descriptor serialized in
``detectmateservice_tpu/schemas/schemas_pb2.py``). Output is byte-for-byte
what the generated classes write: fields in number order, optional scalars
written whenever set (even to their default), repeated ``int32`` packed,
negative ``int32`` as ten-byte varints, map entries with both key and value.
Map entries go out in insertion order. Unknown fields are skipped; truncated
or malformed input raises ``SchemaError``.

The dict-style wrapper surface matches the JAX package's: ``obj["field"]``
and ``obj.field``, live list and dict containers for repeated and map
fields, ``serialize`` / ``deserialize`` / ``from_bytes`` / ``to_dict``.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

SCHEMA_VERSION = "1.0.0"

__all__ = [
    "SCHEMA_VERSION",
    "SchemaError",
    "BaseSchema",
    "LogSchema",
    "ParserSchema",
    "DetectorSchema",
    "OutputSchema",
]

# field kinds
_STRING, _INT32, _FLOAT, _REP_STRING, _REP_INT32, _MAP = range(6)
_DEFAULTS = {_STRING: "", _INT32: 0, _FLOAT: 0.0}
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class SchemaError(Exception):
    """Raised on invalid schema field access or failed (de)serialization."""


# -- wire primitives --------------------------------------------------------
def _put_varint(out: bytearray, value: int) -> None:
    value &= (1 << 64) - 1  # negative int32 → two's complement, 10 bytes
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _put_bytes(out: bytearray, tag: int, data: bytes) -> None:
    _put_varint(out, tag)
    _put_varint(out, len(data))
    out += data


def _get_varint(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise SchemaError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
        if shift >= 70:
            raise SchemaError("varint too long")


def _as_int32(value: int) -> int:
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value & 0x80000000 else value


def _get_len(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
    length, pos = _get_varint(buf, pos, end)
    if pos + length > end:
        raise SchemaError("truncated length-delimited field")
    return pos + length, pos


def _decode_str(buf: bytes, start: int, stop: int) -> str:
    try:
        return buf[start:stop].decode("utf-8")
    except UnicodeDecodeError as exc:
        raise SchemaError(f"invalid UTF-8 in string field: {exc}") from exc


def _skip(buf: bytes, pos: int, end: int, wire: int, field: int) -> int:
    """Skip one unknown field's payload; returns the position after it."""
    if wire == 0:
        return _get_varint(buf, pos, end)[1]
    if wire == 1:
        pos += 8
    elif wire == 5:
        pos += 4
    elif wire == 2:
        return _get_len(buf, pos, end)[0]
    elif wire == 3:  # group: skip nested fields up to the matching end tag
        while True:
            key, pos = _get_varint(buf, pos, end)
            if key & 7 == 4:
                if key >> 3 != field:
                    raise SchemaError("mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, end, key & 7, key >> 3)
    else:
        raise SchemaError(f"invalid wire type {wire}")
    if pos > end:
        raise SchemaError("truncated fixed-width field")
    return pos


def _decode_map_entry(buf: bytes, pos: int, end: int) -> Tuple[str, str]:
    key = value = ""
    while pos < end:
        tag, pos = _get_varint(buf, pos, end)
        field, wire = tag >> 3, tag & 7
        if field in (1, 2) and wire == 2:
            stop, start = _get_len(buf, pos, end)
            text = _decode_str(buf, start, stop)
            pos = stop
            if field == 1:
                key = text
            else:
                value = text
        else:
            pos = _skip(buf, pos, end, wire, field)
    return key, value


# -- messages ---------------------------------------------------------------
class BaseSchema:
    """A message as a dict of set fields with dict + attribute access.

    Unset optional scalars read as their proto3 default; repeated and map
    fields read as the live list / dict held by the message, so
    ``obj["alertsObtain"].update(...)`` mutates it in place.
    """

    _FIELDS: Tuple[Tuple[int, str, int], ...] = ()   # (number, name, kind)
    _BY_NAME: Dict[str, Tuple[int, int]] = {}
    _BY_NUMBER: Dict[int, Tuple[str, int]] = {}

    def __init_subclass__(cls) -> None:
        cls._BY_NAME = {name: (num, kind) for num, name, kind in cls._FIELDS}
        cls._BY_NUMBER = {num: (name, kind) for num, name, kind in cls._FIELDS}

    def __init__(self, data: Optional[Mapping[str, Any]] = None, **kwargs: Any):
        self._values: Dict[str, Any] = {"__version__": SCHEMA_VERSION}
        if data is not None:
            if not isinstance(data, Mapping):
                raise SchemaError(
                    f"{type(self).__name__} expects a mapping, got {type(data).__name__}")
            self.update(data)
        if kwargs:
            self.update(kwargs)

    # -- field access ------------------------------------------------------
    def _kind(self, key: str) -> int:
        entry = self._BY_NAME.get(key)
        if entry is None:
            raise SchemaError(f"{type(self).__name__} has no field {key!r}")
        return entry[1]

    def __getitem__(self, key: str) -> Any:
        kind = self._kind(key)
        value = self._values.get(key)
        if value is not None:
            return value
        if kind == _REP_STRING or kind == _REP_INT32:
            value = self._values[key] = []
            return value
        if kind == _MAP:
            value = self._values[key] = {}
            return value
        return _DEFAULTS[kind]

    def __setitem__(self, key: str, value: Any) -> None:
        self._set_field(key, value)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") and name != "__version__":
            raise AttributeError(name)
        try:
            return self[name]
        except SchemaError as exc:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}") from exc

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_") and name != "__version__":
            object.__setattr__(self, name, value)
        else:
            self._set_field(name, value)

    def has(self, key: str) -> bool:
        """Presence of an optional scalar (set, even to its default)."""
        return self._kind(key) in _DEFAULTS and key in self._values

    def _set_field(self, key: str, value: Any) -> None:
        kind = self._kind(key)
        where = f"{type(self).__name__}.{key}"
        if kind == _STRING:
            if not isinstance(value, str):
                raise SchemaError(f"cannot set {where}: expected str, got {type(value).__name__}")
        elif kind == _INT32:
            value = _check_int32(value, where)
        elif kind == _FLOAT:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise SchemaError(f"cannot set {where}: expected a number, got {type(value).__name__}")
            value = struct.unpack("<f", struct.pack("<f", float(value)))[0]
        elif kind == _REP_STRING:
            value = list(value)
            if not all(isinstance(v, str) for v in value):
                raise SchemaError(f"cannot set {where}: expected a sequence of str")
        elif kind == _REP_INT32:
            value = [_check_int32(v, where) for v in value]
        else:  # map<string, string>
            value = dict(value)
            if not all(isinstance(k, str) and isinstance(v, str) for k, v in value.items()):
                raise SchemaError(f"cannot set {where}: expected a str → str mapping")
        self._values[key] = value

    def update(self, data: Mapping[str, Any]) -> None:
        for key, value in data.items():
            self._set_field(key, value)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except SchemaError:
            return default

    def __contains__(self, key: str) -> bool:
        return key in self._BY_NAME

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._BY_NAME))

    def keys(self) -> List[str]:
        return sorted(self._BY_NAME)

    # -- (de)serialization -------------------------------------------------
    def serialize(self) -> bytes:
        out = bytearray()
        for num, name, kind in self._FIELDS:
            value = self._values.get(name)
            if value is None:
                continue
            if kind == _STRING:
                _put_bytes(out, num << 3 | 2, value.encode("utf-8"))
            elif kind == _INT32:
                out.append(num << 3)
                _put_varint(out, value)
            elif kind == _FLOAT:
                out.append(num << 3 | 5)
                out += struct.pack("<f", value)
            elif kind == _REP_STRING:
                for item in value:
                    _put_bytes(out, num << 3 | 2, item.encode("utf-8"))
            elif kind == _REP_INT32:
                if value:
                    packed = bytearray()
                    for item in value:
                        _check_int32(item, name)
                        _put_varint(packed, item)
                    _put_bytes(out, num << 3 | 2, bytes(packed))
            else:
                for key, item in value.items():
                    entry = bytearray()
                    _put_bytes(entry, 0x0A, key.encode("utf-8"))
                    _put_bytes(entry, 0x12, item.encode("utf-8"))
                    _put_bytes(out, num << 3 | 2, bytes(entry))
        return bytes(out)

    def deserialize(self, raw: bytes) -> "BaseSchema":
        """Replace this message's content with the decoded ``raw``."""
        if not isinstance(raw, (bytes, bytearray, memoryview)):
            raise SchemaError(f"cannot deserialize {type(self).__name__} from "
                              f"{type(raw).__name__}")
        buf = bytes(raw)
        values: Dict[str, Any] = {}
        pos, end = 0, len(buf)
        try:
            while pos < end:
                tag, pos = _get_varint(buf, pos, end)
                num, wire = tag >> 3, tag & 7
                if num == 0:
                    raise SchemaError("field number 0")
                entry = self._BY_NUMBER.get(num)
                kind = entry[1] if entry is not None else -1
                if kind in (_STRING, _REP_STRING, _MAP) and wire == 2:
                    stop, start = _get_len(buf, pos, end)
                    name = entry[0]
                    if kind == _STRING:
                        values[name] = _decode_str(buf, start, stop)
                    elif kind == _REP_STRING:
                        values.setdefault(name, []).append(_decode_str(buf, start, stop))
                    else:
                        key, item = _decode_map_entry(buf, start, stop)
                        values.setdefault(name, {})[key] = item
                    pos = stop
                elif kind == _INT32 and wire == 0:
                    value, pos = _get_varint(buf, pos, end)
                    values[entry[0]] = _as_int32(value)
                elif kind == _REP_INT32 and wire == 0:
                    value, pos = _get_varint(buf, pos, end)
                    values.setdefault(entry[0], []).append(_as_int32(value))
                elif kind == _REP_INT32 and wire == 2:
                    stop, pos = _get_len(buf, pos, end)
                    items = values.setdefault(entry[0], [])
                    while pos < stop:
                        value, pos = _get_varint(buf, pos, stop)
                        items.append(_as_int32(value))
                elif kind == _FLOAT and wire == 5:
                    if pos + 4 > end:
                        raise SchemaError("truncated float field")
                    values[entry[0]] = struct.unpack_from("<f", buf, pos)[0]
                    pos += 4
                else:  # unknown field, or a known one with a foreign wire type
                    pos = _skip(buf, pos, end, wire, num)
        except SchemaError as exc:
            raise SchemaError(f"cannot deserialize {type(self).__name__}: {exc}") from exc
        self._values = values
        return self

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BaseSchema":
        return cls().deserialize(raw)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _num, name, kind in self._FIELDS:
            value = self[name]
            if kind == _MAP:
                value = dict(value)
            elif kind in (_REP_STRING, _REP_INT32):
                value = list(value)
            out[name] = value
        return out

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BaseSchema):
            return (type(self) is type(other)
                    and self.to_dict() == other.to_dict()
                    and {k for k in self._values if self.has(k)}
                    == {k for k in other._values if other.has(k)})
        return NotImplemented

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_dict()!r})"


def _check_int32(value: Any, where: str) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise SchemaError(f"cannot set {where}: expected int, got {type(value).__name__}")
    if not _INT32_MIN <= value <= _INT32_MAX:
        raise SchemaError(f"cannot set {where}: {value} is out of int32 range")
    return value


class LogSchema(BaseSchema):
    """Reader output: one raw log line and its provenance."""

    _FIELDS = (
        (1, "__version__", _STRING), (2, "logID", _STRING), (3, "log", _STRING),
        (4, "logSource", _STRING), (5, "hostname", _STRING),
    )


class ParserSchema(BaseSchema):
    """Parser output: template + extracted variables for one log line."""

    _FIELDS = (
        (1, "__version__", _STRING), (2, "parserType", _STRING),
        (3, "parserID", _STRING), (4, "EventID", _INT32),
        (5, "template", _STRING), (6, "variables", _REP_STRING),
        (7, "parsedLogID", _STRING), (8, "logID", _STRING),
        (9, "log", _STRING), (10, "logFormatVariables", _MAP),
        (11, "receivedTimestamp", _INT32), (12, "parsedTimestamp", _INT32),
    )


class DetectorSchema(BaseSchema):
    """Detector output: one alert (only emitted when an anomaly is found)."""

    _FIELDS = (
        (1, "__version__", _STRING), (2, "detectorID", _STRING),
        (3, "detectorType", _STRING), (4, "alertID", _STRING),
        (5, "detectionTimestamp", _INT32), (6, "logIDs", _REP_STRING),
        (8, "score", _FLOAT), (9, "extractedTimestamps", _REP_INT32),
        (10, "description", _STRING), (11, "receivedTimestamp", _INT32),
        (12, "alertsObtain", _MAP),
    )


class OutputSchema(BaseSchema):
    """Aggregated output record: the alerts of one group."""

    _FIELDS = (
        (1, "__version__", _STRING), (2, "detectorIDs", _REP_STRING),
        (3, "detectorTypes", _REP_STRING), (4, "alertIDs", _REP_STRING),
        (5, "outputTimestamp", _INT32), (6, "logIDs", _REP_STRING),
        (9, "extractedTimestamps", _REP_INT32), (10, "description", _STRING),
        (12, "alertsObtain", _MAP),
    )
