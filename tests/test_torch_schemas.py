"""The port's pure-Python proto3 codec against the JAX package's generated
protobuf classes: the same seeded random messages go both ways, and
truncated, unknown and malformed input is handled as protobuf handles it."""
import numpy as np
import pytest

from detectmateservice_tpu import schemas as ref
from detectmateservice_tpu_torch import schemas as port

_ALPHABET = list("abcXYZ019 _-=:./<*>") + ["é", "ß", "日", "🙂"]
_INT32_EDGES = [0, 1, -1, 127, 128, -128, 2**31 - 1, -(2**31), 300, -300]


def _text(rng, lo=0, hi=12):
    return "".join(rng.choice(_ALPHABET, size=int(rng.integers(lo, hi))))


def _int32(rng):
    if rng.random() < 0.4:
        return int(rng.choice(_INT32_EDGES))
    return int(rng.integers(-(2**31), 2**31))


def _parser_fields(rng):
    """A random ParserSchema field dict: each optional present or absent,
    repeated and map fields of 0-3 items."""
    fields = {}
    for name in ("parserType", "parserID", "template", "parsedLogID", "logID", "log"):
        if rng.random() < 0.6:
            fields[name] = _text(rng)
    for name in ("EventID", "receivedTimestamp", "parsedTimestamp"):
        if rng.random() < 0.6:
            fields[name] = _int32(rng)
    if rng.random() < 0.7:
        fields["variables"] = [_text(rng) for _ in range(int(rng.integers(0, 4)))]
    if rng.random() < 0.7:
        fields["logFormatVariables"] = {
            _text(rng, 1): _text(rng) for _ in range(int(rng.integers(0, 4)))}
    return fields


def _detector_fields(rng):
    fields = {}
    for name in ("detectorID", "detectorType", "alertID", "description"):
        if rng.random() < 0.6:
            fields[name] = _text(rng)
    for name in ("detectionTimestamp", "receivedTimestamp"):
        if rng.random() < 0.6:
            fields[name] = _int32(rng)
    if rng.random() < 0.6:
        fields["score"] = float(np.float32(rng.normal() * 10.0 ** rng.integers(-3, 4)))
    if rng.random() < 0.7:
        fields["logIDs"] = [_text(rng) for _ in range(int(rng.integers(0, 4)))]
    if rng.random() < 0.7:
        fields["extractedTimestamps"] = [_int32(rng) for _ in range(int(rng.integers(0, 5)))]
    if rng.random() < 0.7:
        fields["alertsObtain"] = {
            _text(rng, 1): _text(rng) for _ in range(int(rng.integers(0, 4)))}
    return fields


_KINDS = {
    "ParserSchema": (_parser_fields, "logFormatVariables"),
    "DetectorSchema": (_detector_fields, "alertsObtain"),
}


def _byte_order_fixed(fields, map_name):
    """protobuf writes map entries in an order of its own; with at most one
    entry the bytes are fully determined."""
    return len(fields.get(map_name, {})) <= 1


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("seed", range(8))
class TestRoundTrip:
    def test_port_encodes_what_protobuf_decodes(self, kind, seed):
        make, map_name = _KINDS[kind]
        rng = np.random.default_rng(seed)
        for _ in range(25):
            fields = make(rng)
            raw = getattr(port, kind)(fields).serialize()
            decoded = getattr(ref, kind).from_bytes(raw)
            assert decoded.to_dict() == getattr(port, kind)(fields).to_dict()
            expected = getattr(ref, kind)(fields).serialize()
            if _byte_order_fixed(fields, map_name):
                assert raw == expected
            else:
                assert len(raw) == len(expected)

    def test_protobuf_encodes_what_port_decodes(self, kind, seed):
        make, map_name = _KINDS[kind]
        rng = np.random.default_rng(1000 + seed)
        for _ in range(25):
            fields = make(rng)
            raw = getattr(ref, kind)(fields).serialize()
            decoded = getattr(port, kind).from_bytes(raw)
            assert decoded.to_dict() == getattr(ref, kind).from_bytes(raw).to_dict()
            if _byte_order_fixed(fields, map_name):
                assert decoded.serialize() == raw


class TestWireDetails:
    def test_optional_scalar_set_to_default_is_written(self):
        raw = port.ParserSchema(EventID=0, template="").serialize()
        assert raw == ref.ParserSchema(EventID=0, template="").serialize()
        assert port.ParserSchema.from_bytes(raw).has("EventID")
        assert not port.ParserSchema.from_bytes(b"").has("EventID")

    def test_repeated_int32_is_packed_with_ten_byte_negatives(self):
        msg = port.DetectorSchema(extractedTimestamps=[-1, 5])
        raw = msg.serialize()
        # field 9, wire type 2: one packed record, 10 + 1 payload bytes
        assert raw[-13:-11] == bytes([9 << 3 | 2, 11])
        assert raw == ref.DetectorSchema(extractedTimestamps=[-1, 5]).serialize()

    def test_unpacked_repeated_int32_is_accepted(self):
        raw = bytes([9 << 3, 7, 9 << 3, 0x7F])  # two unpacked varints
        assert port.DetectorSchema.from_bytes(raw)["extractedTimestamps"] == [7, 127]
        assert list(ref.DetectorSchema.from_bytes(raw)["extractedTimestamps"]) == [7, 127]

    @pytest.mark.parametrize("unknown", [
        bytes([15 << 3, 0x96, 0x01]),                 # varint
        bytes([15 << 3 | 1]) + bytes(8),              # fixed64
        bytes([15 << 3 | 5]) + bytes(4),              # fixed32
        bytes([15 << 3 | 2, 3]) + b"abc",             # length-delimited
        bytes([4 << 3 | 2, 1]) + b"x",                # known field, foreign wire type
    ])
    def test_unknown_fields_are_skipped(self, unknown):
        base = ref.ParserSchema(template="t <*>", variables=["a"], logID="7").serialize()
        raw = base + unknown
        got = port.ParserSchema.from_bytes(raw).to_dict()
        assert got == ref.ParserSchema.from_bytes(raw).to_dict()

    def test_every_truncation_fails_exactly_where_protobuf_fails(self):
        rng = np.random.default_rng(42)
        for _ in range(10):
            fields = _parser_fields(rng)
            fields["template"] = "a longer template <*> " + _text(rng, 2)
            raw = ref.ParserSchema(fields).serialize()
            for cut in range(len(raw)):
                try:
                    ref.ParserSchema.from_bytes(raw[:cut])
                    ref_ok = True
                except ref.SchemaError:
                    ref_ok = False
                if ref_ok:
                    port.ParserSchema.from_bytes(raw[:cut])
                else:
                    with pytest.raises(port.SchemaError):
                        port.ParserSchema.from_bytes(raw[:cut])

    def test_truncated_varint_and_string_raise(self):
        with pytest.raises(port.SchemaError):
            port.ParserSchema.from_bytes(bytes([4 << 3, 0x80]))
        with pytest.raises(port.SchemaError):
            port.ParserSchema.from_bytes(bytes([5 << 3 | 2, 10]) + b"abc")

    def test_wrapper_surface(self):
        msg = port.DetectorSchema()
        assert msg["__version__"] == port.SCHEMA_VERSION == ref.SCHEMA_VERSION
        msg["alertsObtain"].update({"k": "v"})
        msg.logIDs.append("3")
        assert port.DetectorSchema.from_bytes(msg.serialize()).to_dict() == msg.to_dict()
        with pytest.raises(port.SchemaError):
            msg["noSuchField"] = 1
        with pytest.raises(port.SchemaError):
            msg["detectionTimestamp"] = 2**31
        assert msg.keys() == sorted(ref.DetectorSchema().keys())
