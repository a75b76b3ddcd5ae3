"""The port's component base (``library/common/core.py``, ``detector.py``,
``utils/data_buffer.py``) against the JAX package's: config normalization,
config parsing and dumping, and the train-then-detect contract in the
per-message and FIXED-window modes."""
import copy

import pytest

from detectmateservice_tpu.library.common import core as ref_core
from detectmateservice_tpu.library.common import detector as ref_det
from detectmateservice_tpu.schemas import DetectorSchema as RefDetectorSchema
from detectmateservice_tpu.schemas import ParserSchema as RefParserSchema
from detectmateservice_tpu_torch.library.common import core, detector
from detectmateservice_tpu_torch.library.utils.data_buffer import BufferMode, DataBuffer

SECTIONS = [
    {"method_type": "core_detector", "auto_config": False,
     "params": {"all_threshold": 3, "window": 2},
     "events": {1: {"inst": {"variables": [{"pos": 0, "params": {}},
                                           {"pos": 2, "params": {"threshold": 9}}]}}}},
    {"method_type": "core_detector", "params": {"a": 1}, "a": 5},
    {"auto_config": True},
    {"method_type": "core_detector", "auto_config": False, "data_use_training": 3,
     "global": {"g": {"header_variables": [{"pos": "Time"}]}}},
]


@pytest.mark.parametrize("section", SECTIONS)
def test_normalize_config_matches(section):
    want = ref_core.normalize_config(copy.deepcopy(section), "core_detector")
    got = core.normalize_config(copy.deepcopy(section), "core_detector")
    assert got == want


@pytest.mark.parametrize("section,error", [
    ({"auto_config": False}, "AutoConfigError"),
    ({"method_type": "other"}, "MethodTypeError"),
])
def test_normalize_config_errors_match(section, error):
    with pytest.raises(getattr(ref_core, error)):
        ref_core.normalize_config(dict(section), "core_detector")
    with pytest.raises(getattr(core, error)):
        core.normalize_config(dict(section), "core_detector")


@pytest.mark.parametrize("doc", [
    {"detectors": {"Det": SECTIONS[0]}},
    {"detectors": {"Other": SECTIONS[3]}},
    SECTIONS[3],
])
def test_config_parse_and_dump_match(doc):
    want = ref_det.CoreDetectorConfig.from_dict(copy.deepcopy(doc), "Det")
    got = detector.CoreDetectorConfig.from_dict(copy.deepcopy(doc), "Det")
    assert got.to_dict() == want.to_dict()
    assert got.data_use_training == want.data_use_training
    assert {k: sorted(v) for k, v in got.events.items()} == \
        {k: sorted(v) for k, v in want.events.items()}
    for name, inst in want.global_.items():
        assert sorted(got.global_[name].get_all()) == sorted(inst.get_all())


def test_bad_field_types_raise_library_error():
    with pytest.raises(core.LibraryError):
        detector.CoreDetectorConfig.from_dict({"data_use_training": "many"})
    with pytest.raises(core.LibraryError):
        detector.CoreDetectorConfig.from_dict({"events": {1: {"i": {"variables": [{}]}}}})
    cfg = detector.CoreDetectorConfig.from_dict({"data_use_training": 4.0})
    assert cfg.data_use_training == 4 and isinstance(cfg.data_use_training, int)


def _hit_detector(base):
    class Hit(base):
        description = "flags templates that contain 'bad'"

        def detect(self, input_, output_):
            hit = "bad" in input_["template"]
            if hit:
                output_["score"] = 1.0
                output_["alertsObtain"].update({"why": input_["template"]})
            return hit

    return Hit


def _stream():
    times = ["1700000001", "1e400", "abc", "", "17.9"]
    msgs = []
    for i in range(23):
        lfv = {"Time": times[i % 5]} if i % 3 else {}
        msgs.append(RefParserSchema(
            EventID=i % 2, template="bad thing" if i % 4 == 1 else "ok",
            variables=[str(i)], logID=str(i) if i % 7 else "",
            receivedTimestamp=1_600_000_000 + i if i % 2 else 0,
            logFormatVariables=lfv).serialize())
    return msgs


def _strip(raw):
    out = RefDetectorSchema.from_bytes(raw).to_dict()
    now = out.pop("detectionTimestamp")
    assert out.pop("receivedTimestamp") == now > 0
    out["extractedTimestamps"] = ["now" if t == now else t
                                  for t in out["extractedTimestamps"]]
    return out


@pytest.mark.parametrize("mode", ["no_buf", "fixed"])
def test_train_then_detect_contract_matches(mode):
    cfg = {"method_type": "core_detector", "auto_config": False,
           "data_use_training": 3, "buffer_mode": mode, "buffer_size": 4,
           "start_id": 10}
    ref = _hit_detector(ref_det.CoreDetector)(name="det", config=dict(cfg))
    port = _hit_detector(detector.CoreDetector)(name="det", config=dict(cfg))
    assert port.buffer_mode.value == ref.buffer_mode.value == mode
    want = [ref.process(m) for m in _stream()] + ref.flush_final()
    got = [port.process(m) for m in _stream()] + port.flush_final()
    assert [g is None for g in got] == [w is None for w in want]
    assert any(w is not None for w in want)
    for g, w in zip(got, want):
        if w is not None:
            assert _strip(g) == _strip(w)


def test_undecodable_input_raises_library_error():
    port = _hit_detector(detector.CoreDetector)(config={"auto_config": False,
                                                        "data_use_training": 0})
    with pytest.raises(core.LibraryError, match="deserialize"):
        port.process(b"\x0a\xff")


def test_fixed_window_resize_carries_messages_over():
    cfg = {"auto_config": False, "buffer_mode": "fixed", "buffer_size": 4}
    port = _hit_detector(detector.CoreDetector)(name="det", config=dict(cfg))
    ref = _hit_detector(ref_det.CoreDetector)(name="det", config=dict(cfg))
    for det in (port, ref):
        for m in _stream()[:3]:
            assert det.process(m) is None
        det.reconfigure(dict(cfg, buffer_size=2))
    assert [_strip(o) for o in port.flush()] == [_strip(o) for o in ref.flush()]
    with pytest.raises(core.LibraryError, match="buffer_mode"):
        port.reconfigure(dict(cfg, buffer_mode="no_buf"))


def test_data_buffer_and_modes():
    assert [m.value for m in BufferMode] == [m.value for m in ref_det.BufferMode]
    buf = DataBuffer(3)
    assert buf.push(1) is None and buf.push(2) is None
    assert buf.push(3) == [1, 2, 3] and len(buf) == 0
    buf.push(4)
    assert buf.flush() == [4] and len(buf) == 0


EXTRA_DOC = {
    "method_type": "core_detector", "auto_config": False,
    "events": {1: {"inst": {
        "owner": "secops", "params": {"t": 1},
        "variables": [{"pos": 0, "name": "pid", "color": "red", "weights": [1, 2]},
                      {"pos": 2}],
        "header_variables": [{"pos": "Time", "unit": "s"}]}}},
    "global": {"g": {"note": {"k": "v"},
                     "header_variables": [{"pos": "Host", "params": {}, "rank": 3}]}},
}


@pytest.mark.parametrize("what", ["InstanceConfig", "Variable", "HeaderVariable"])
def test_undeclared_keys_survive_parse_and_dump(what):
    """The pydantic models keep keys they do not declare (``extra="allow"``)
    and dump them back; so do the port's dataclasses."""
    want = ref_det.CoreDetectorConfig.from_dict(copy.deepcopy(EXTRA_DOC))
    got = detector.CoreDetectorConfig.from_dict(copy.deepcopy(EXTRA_DOC))
    assert got.to_dict() == want.to_dict()
    ref_inst, inst = want.events[1]["inst"], got.events[1]["inst"]
    if what == "InstanceConfig":
        pairs = [(inst, ref_inst), (got.global_["g"], want.global_["g"])]
    elif what == "Variable":
        pairs = list(zip(inst.variables, ref_inst.variables))
    else:
        pairs = [(inst.header_variables[0], ref_inst.header_variables[0]),
                 (got.global_["g"].header_variables[0],
                  want.global_["g"].header_variables[0])]
    assert any(ref.model_extra for _, ref in pairs)
    for port, ref in pairs:
        assert port.extra == ref.model_extra
    # the declared fields are untouched by the extra keys
    assert inst.variables[0].label == ref_inst.variables[0].label == "pid"
    assert inst.params == {"t": 1}
