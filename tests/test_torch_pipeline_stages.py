"""The container demo stack's reader, parser and output on the port, against
the JAX package's components on the same seeded inputs, with both sides'
random id sources (``uuid.uuid4``, ``os.urandom``), clock and host name
pinned to the same values:

* ``LogFileReader``: ``process`` and ``read``, bytes equal;
* ``MatcherParser``: ``process``, ``process_batch`` and ``process_frames``
  under ``accept_raw_lines`` and ``native_parse`` true and false, with the
  demo's audit format, a normalizing format and a ``time_format``. Where
  both sides serialize in C the bytes are equal; where the JAX side
  serializes through protobuf, which writes map entries in an order of its
  own, the bytes are equal once the map entries are put in one order
  (``_canonical``);
* ``OutputWriter``: returned records, file names and file contents;
* each ported C entry point through the port's bindings against the JAX
  package's ``utils/matchkern`` on the same lines;
* the parser's ``setup_io`` raises, naming the library, when it cannot be
  built;
* a four-stage pipeline of port Services against one of JAX Services.
"""
import itertools
import json
import os
import socket
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import yaml

import chip_smoke
from conftest import wait_until
from detectmateservice_tpu.library.outputs import file_sink as jax_sink
from detectmateservice_tpu.library.parsers import template_matcher as jax_parser
from detectmateservice_tpu.library.readers import log_file as jax_reader
from detectmateservice_tpu.utils import matchkern as jax_kern
from detectmateservice_tpu_torch.engine.framing import pack_batch
from detectmateservice_tpu_torch.library.common.core import LibraryError
from detectmateservice_tpu_torch.library.outputs import file_sink as port_sink
from detectmateservice_tpu_torch.library.parsers import template_matcher as port_parser
from detectmateservice_tpu_torch.library.readers import log_file as port_reader
from detectmateservice_tpu_torch.schemas import DetectorSchema, LogSchema, ParserSchema
from detectmateservice_tpu_torch.utils import matchkern as port_kern

REPO = Path(__file__).resolve().parents[1]
CONF = REPO / "container" / "config"
AUDIT_FORMAT = "type=<Type> msg=audit(<Time>): <Content>"


class _Id:
    """What ``uuid.uuid4()`` returns, by a counter: ``str`` and ``hex``."""

    def __init__(self, n: int):
        self.hex = f"{n:032x}"

    def __str__(self) -> str:
        return f"00000000-0000-4000-8000-{self.hex[20:]}"


@pytest.fixture
def pinned(monkeypatch):
    """Pins the ids, the clock and the host name; ``pinned()`` restarts the
    id counter, to be called before each side runs."""
    state = {"ids": itertools.count()}
    monkeypatch.setattr(uuid, "uuid4", lambda: _Id(next(state["ids"])))
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + n) % 256 for i in range(n)))
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host-a")

    def restart():
        state["ids"] = itertools.count()

    return restart


def _audit_lines(n_fit=96, n_detect=160, seed=3):
    return chip_smoke.make_audit_log(n_fit, n_detect, anomaly_rate=0.05, seed=seed)[0]


def _payloads(seed=3):
    """Envelopes of the audit lines, then the shapes a stock line
    formatter sends, and edge rows: a JSON record, a bare line, blank
    rows, invalid UTF-8, non-ASCII text, an embedded newline, an empty
    payload, a truncated protobuf."""
    lines = _audit_lines(seed=seed)
    out = [LogSchema(logID=f"id{i}", log=line, logSource="audit", hostname="h").serialize()
           for i, line in enumerate(lines)]
    out += [
        json.dumps({"message": lines[3], "logSource": "fluentd", "logID": "j1"}).encode() + b"\n",
        json.dumps({"log": "  "}).encode(),
        (lines[5] + "\n").encode(),
        b"   \n", b"\xff\xfe not utf-8", "type=SYSCALL msg=audit(1.2:3): café".encode(),
        LogSchema(logID="nl", log=lines[7] + "\nsecond line").serialize(),
        LogSchema(logID="blank", log=" \t ").serialize(),
        LogSchema(logID="up", log=lines[9].upper()).serialize(),
        b"", b"\x1a\x05ab",
    ]
    return out


def _varint(raw, pos):
    shift = value = 0
    while True:
        byte = raw[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _canonical(raw):
    """A serialized message with its map entries (fields 10 and 12) in
    byte order: protobuf's own map order aside, the same bytes."""
    if not isinstance(raw, bytes):
        return raw
    records, pos = [], 0
    while pos < len(raw):
        start = pos
        tag, pos = _varint(raw, pos)
        if tag & 7 == 0:
            _, pos = _varint(raw, pos)
        else:
            n, pos = _varint(raw, pos)
            pos += n
        records.append((tag >> 3, raw[start:pos]))
    maps = sorted(r for f, r in records if f in (10, 12))
    return b"".join(r for f, r in records if f not in (10, 12)) + b"".join(maps)


def _parser_config(kind, accept_raw, native, tmp_path):
    templates = str(CONF / "audit_templates.txt")
    if kind == "audit":
        cfg = yaml.safe_load((CONF / "parser_config.yaml").read_text())
        block = cfg["parsers"]["MatcherParser"]
        block["params"].update(path_templates=templates, accept_raw_lines=accept_raw,
                               native_parse=native)
        return cfg
    params = {"accept_raw_lines": accept_raw, "native_parse": native}
    if kind == "normalize":
        path = tmp_path / "templates.txt"
        path.write_text("arch=<*> syscall=<*> success=yes exit=0 pid=<*> uid=<*> comm=<*> "
                        "exe=<*>\nTYPE=SYSCALL <*>\nno wildcard here\n")
        params.update(path_templates=str(path), remove_spaces=True, remove_punctuation=True,
                      lowercase=True)
        return {"parsers": {"MatcherParser": {"method_type": "matcher_parser",
                                              "auto_config": False, "log_format": AUDIT_FORMAT,
                                              "params": params}}}
    params.update(path_templates=templates)
    return {"parsers": {"MatcherParser": {
        "method_type": "matcher_parser", "auto_config": False,
        "log_format": "<Date> <Hour> <Content>", "time_format": "%Y-%m-%d %H:%M:%S",
        "params": params}}}


def _time_payloads():
    lines = _audit_lines(16, 16)
    out = [LogSchema(logID=str(i), log=f"2025-0{1 + i % 9}-1{i % 10} 0{i % 10}:1{i % 6}:00 "
                     + line.split(": ", 1)[1]).serialize() for i, line in enumerate(lines)]
    return out + [LogSchema(logID="bad", log="notadate 12:00 x").serialize(), b"raw\n"]


def _run(parser, method, payloads):
    if method == "process":
        outs = []
        for p in payloads:
            try:
                outs.append(parser.process(p))
            except Exception as exc:  # noqa: BLE001 — each package's LibraryError
                outs.append(type(exc).__name__)
        return outs
    if method == "process_batch":
        return parser.process_batch(list(payloads))
    frames = [pack_batch(payloads[:40]), pack_batch(payloads[40:200] + [b""]),
              b"\xd7DM\x01\x05\x01a"] + payloads[200:]
    return parser.process_frames(frames)


# -- the reader ------------------------------------------------------------

def test_reader_process_equals_the_jax_readers(pinned):
    inputs = [line.encode() for line in _audit_lines()] + [
        b"first\nsecond\n", b"\n\n  \nthird", b"   ", b"", b"\xff\xfe bad bytes",
        "unicode é ß".encode()]
    config = yaml.safe_load((CONF / "reader_config.yaml").read_text())
    outs = []
    for mod in (jax_reader, port_reader):
        pinned()
        reader = mod.LogFileReader(config=config)
        outs.append([reader.process(x) for x in inputs])
    assert outs[0] == outs[1]
    assert sum(o is None for o in outs[1]) == 2


def test_reader_read_equals_the_jax_readers(pinned, tmp_path):
    path = tmp_path / "audit.log"
    path.write_bytes(("\n".join(_audit_lines()) + "\n\n  \nlast").encode() + b"\xff\n")
    outs = []
    for mod in (jax_reader, port_reader):
        pinned()
        reader = mod.LogFileReader(config={"readers": {"LogFileReader": {
            "method_type": "log_file", "path": str(path)}}})
        outs.append([m.serialize() for m in reader.read()])
        with pytest.raises(mod.LibraryError, match="cannot read"):
            list(reader.read(str(tmp_path / "missing.log")))
    assert outs[0] == outs[1] and len(outs[1]) == 257


# -- the parser ------------------------------------------------------------

@pytest.mark.parametrize("method", ["process", "process_batch", "process_frames"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
@pytest.mark.parametrize("accept_raw", [True, False], ids=["raw", "strict"])
@pytest.mark.parametrize("kind", ["audit", "normalize", "time_format"])
def test_parser_equals_the_jax_parser(pinned, tmp_path, kind, accept_raw, native, method):
    config = _parser_config(kind, accept_raw, native, tmp_path)
    payloads = _time_payloads() if kind == "time_format" else _payloads()
    outs = []
    for mod in (jax_parser, port_parser):
        pinned()
        parser = mod.MatcherParser(config=config)
        parser.setup_io()
        outs.append(_run(parser, method, payloads))
    jax_outs, port_outs = outs
    if method == "process_frames":
        assert jax_outs[1:] == port_outs[1:]
        jax_outs, port_outs = jax_outs[0], port_outs[0]
    assert len(port_outs) == len(jax_outs) and any(isinstance(o, bytes) for o in port_outs)
    if native and method != "process":
        # both sides serialize in the same C: the same bytes
        assert port_outs == jax_outs
    else:
        assert [_canonical(o) for o in port_outs] == [_canonical(o) for o in jax_outs]


def test_native_rows_equal_the_plain_rows():
    """The port's C rows against its own plain path on the demo's config:
    every field equal but the drawn ``parsedLogID``."""
    payloads = _payloads()
    outs = []
    for native in (True, False):
        parser = port_parser.MatcherParser(config=_parser_config("audit", True, native, None))
        rows = []
        for out in parser.process_batch(payloads):
            doc = None if out is None else ParserSchema.from_bytes(out).to_dict()
            if doc is not None:
                assert len(doc.pop("parsedLogID")) == 32
            rows.append(doc)
        outs.append(rows)
    assert outs[0] == outs[1] and sum(r is not None for r in outs[1]) > 250


def test_setup_io_raises_naming_the_library_when_it_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setattr(port_kern, "CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(port_kern, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_kern, "_lib", None)
    parser = port_parser.MatcherParser(config=_parser_config("audit", True, True, tmp_path))
    with pytest.raises(LibraryError, match="native parser library \\(dmfeat.c\\) did not build"):
        parser.setup_io()
    with pytest.raises(LibraryError):
        parser.process_batch(_payloads()[:4])
    # with native_parse off the parser needs no library
    plain = port_parser.MatcherParser(config=_parser_config("audit", True, False, tmp_path))
    plain.setup_io()
    assert plain.process_batch(_payloads()[:4])[0] is not None


# -- the output ------------------------------------------------------------

def _alerts(n):
    rng = np.random.default_rng(5)
    return [DetectorSchema(
        detectorID="det", detectorType="torch_scorer", alertID=str(i),
        detectionTimestamp=1_760_000_000, logIDs=[f"log-{i}"],
        score=float(rng.normal()), extractedTimestamps=[1_753_800_000 + i],
        description="" if i % 3 else f"alert {i}",
        alertsObtain={f"k{i % 4}": f"v{i}", "score": str(i)}).serialize() for i in range(n)]


@pytest.mark.parametrize("aggregate", [1, 3])
def test_output_writer_equals_the_jax_writer(pinned, tmp_path, aggregate):
    alerts = _alerts(10) + [b"\x0a\xff"]
    results = []
    for name, mod in (("jax", jax_sink), ("port", port_sink)):
        pinned()
        out_dir = tmp_path / name
        writer = mod.OutputWriter(config={"outputs": {"OutputWriter": {
            "method_type": "output_writer", "output_dir": str(out_dir),
            "aggregate_count": aggregate, "aggregate_window_ms": 0}}})
        records = [writer.process(a) for a in alerts] + writer.flush_final()
        files = {p.name: p.read_bytes() for p in sorted(out_dir.iterdir())}
        results.append(([_canonical(r) for r in records], files, writer.records_written))
    assert results[0] == results[1]
    assert results[1][2] == -(-10 // aggregate) and len(results[1][1]) == 1


# -- the C entry points ------------------------------------------------------

def _norm_lines():
    lines = [line.split(": ", 1)[1] for line in _audit_lines()]
    return lines + ["", "no wildcard here", "TYPE=SYSCALL é x", "arch=c000003e syscall=",
                    "héllo wörld", "arch=" + "x" * 300]


TEMPLATES = [t.rstrip("\n") for t in (CONF / "audit_templates.txt").read_text().splitlines()]
TEMPLATES += ["no wildcard here", "<*> wörld", "TYPE=<*> é <*>", "<*>"]


def _kernel_args():
    lits, names = port_parser.split_log_format(AUDIT_FORMAT)
    return dict(lits=lits, names=names, norm_flags=0, accept_raw=True,
                raw_templates=TEMPLATES, method_type="matcher_parser",
                parser_id="MatcherParser", version="1.0.0")


def _same_arrays(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y)) if not isinstance(x, bytes)
               else x == y for x, y in zip(a, b))


@pytest.mark.parametrize("entry", [
    "dm_match_extract", "dm_match_extract_batch", "dm_parse_batch", "dm_parse_frames",
    "dm_parse_logs_batch", "dm_parse_logs_frames", "dm_emit_parser_rows"])
def test_c_entry_point_equals_the_jax_librarys(pinned, entry):
    payloads = _payloads()
    frames = [pack_batch(payloads[:100]), b"\xd7DM\x01\x09", pack_batch([b"", b"x"])] \
        + payloads[100:]
    got = []
    for kern in (jax_kern, port_kern):
        pinned()
        matcher = kern.TemplateMatcher(TEMPLATES)
        if entry == "dm_match_extract":
            got.append([matcher.match(line) for line in _norm_lines()])
        elif entry == "dm_match_extract_batch":
            got.append(matcher.match_batch(_norm_lines()))
        elif entry in ("dm_parse_batch", "dm_parse_frames"):
            pk = kern.ParseKernel(matcher=matcher, **_kernel_args())
            if entry == "dm_parse_batch":
                got.append(pk.parse_batch(payloads))
            else:
                pf = pk.parse_frames(frames)
                got.append((pf.status, pf.out_blob, pf.ends, pf.spans, pf.n_corrupt_frames,
                            pf.n_lines))
        elif entry == "dm_parse_logs_batch":
            view = kern.parse_logs_batch(payloads, True)
            got.append((view.status, view.fspans, view.spans,
                        [view.log(i) if view.status[i] in (1, 2) else None
                         for i in range(len(view))]))
        elif entry == "dm_parse_logs_frames":
            view = kern.parse_logs_frames(frames, False)
            got.append((view.status, view.fspans, view.spans, view.n_corrupt_frames,
                        view.n_lines))
        else:
            emitter = kern.ParserEmitter("1.0.0", "matcher_parser", "p")
            arena, offs = emitter.emit(
                [3, -1, 1], [b"t <*>", b"", "é".encode()], [[b"a", b"b"], [], [b"x" * 300]],
                [b"id", b"", b"z"], [[(b"Time", b"1"), (b"Type", b"SYSCALL")], [], [(b"k", b"")]],
                1_760_000_000, b"0123456789abcdef" * 6)
            got.append(arena[:offs[-1]].tobytes())
    if entry in ("dm_parse_batch",):
        assert _same_arrays(got[0], got[1]) and (got[1][0] == 1).sum() > 200
    elif entry in ("dm_parse_frames", "dm_parse_logs_batch", "dm_parse_logs_frames"):
        assert _same_arrays(got[0], got[1])
    else:
        assert got[0] == got[1]


def test_the_library_carries_the_parser_kernels():
    assert port_kern.has_parse_kernel() and port_kern.has_logs_kernel()
    assert port_kern.lib_feature_version() == jax_kern.DM_FEATURE_VERSION


# -- a four-stage pipeline ---------------------------------------------------------

def _pipeline(pkg, tmp: Path, lines, restart_ids):
    """reader → parser → detector → output of one package's Services in this
    process (the demo's reader and parser configs, a narrow MLP scorer),
    fed ``lines`` one per message; returns ({stage: read lines}, the output
    records) once every stage has drained."""
    if pkg == "jax":
        from detectmateservice_tpu.core import Service
        from detectmateservice_tpu.engine.socket import ZmqPairSocketFactory
        from detectmateservice_tpu.settings import ServiceSettings
        det_type, det_name, method, extra = (
            "detectors.jax_scorer.JaxScorerDetector", "JaxScorerDetector", "jax_scorer", {})
    else:
        from detectmateservice_tpu_torch.core import Service
        from detectmateservice_tpu_torch.engine.socket import ZmqPairSocketFactory
        from detectmateservice_tpu_torch.settings import ServiceSettings
        det_type, det_name, method, extra = (chip_smoke.TORCH_SCORER, "TorchScorerDetector",
                                             "torch_scorer", {"device": "cpu"})
    configs = {
        "reader": yaml.safe_load((CONF / "reader_config.yaml").read_text()),
        "parser": _parser_config("audit", True, True, None),
        "detector": {"detectors": {det_name: dict(
            method_type=method, auto_config=False, model="mlp", data_use_training=96,
            seq_len=32, dim=16, vocab_size=512, max_batch=256, threshold_sigma=6.0,
            async_fit=False, **extra)}},
        "output": {"outputs": {"OutputWriter": {"method_type": "output_writer",
                                                "auto_config": False,
                                                "output_dir": str(tmp / "out")}}},
    }
    types = {"reader": "readers.log_file.LogFileReader",
             "parser": "parsers.template_matcher.MatcherParser",
             "detector": det_type, "output": "outputs.file_sink.OutputWriter"}
    nxt = {"reader": "parser", "parser": "detector", "detector": "output", "output": None}
    services = {}
    sender = None
    try:
        for stage in ("output", "detector", "parser", "reader"):
            (tmp / f"{stage}.yaml").write_text(yaml.safe_dump(configs[stage]))
            batched = {"engine_batch_size": 256} if stage in ("parser", "detector") else {}
            services[stage] = Service(ServiceSettings(
                component_type=types[stage], component_id=stage,
                config_file=str(tmp / f"{stage}.yaml"), engine_addr=f"ipc://{tmp}/{stage}.ipc",
                out_addr=[f"ipc://{tmp}/{nxt[stage]}.ipc"] if nxt[stage] else [],
                http_port=0, log_to_file=False, **batched))
            services[stage].setup_io()
            threading.Thread(target=services[stage].run, daemon=True).start()
        assert wait_until(lambda: all(s.engine.running and s.web_server.port
                                      for s in services.values()), 60.0)
        sender = ZmqPairSocketFactory().create_output(f"ipc://{tmp}/reader.ipc")
        restart_ids()  # the reader draws one id per line from here on
        for line in lines:
            sender.send(line.encode())

        def counts():
            out = {}
            for stage, svc in services.items():
                text = chip_smoke._http("GET", svc.web_server.port, "/metrics")[1]
                out[stage] = tuple(chip_smoke.metric_value(text, name, stage) for name in (
                    "data_read_lines_total", "data_written_lines_total"))
            return out

        last = {"stable": 0}
        det = services["detector"].library_component

        def drained():
            now = counts()
            done = (now["reader"][0] == len(lines) and now["parser"][0] == now["reader"][1]
                    and now["detector"][0] == now["parser"][1]
                    and now["output"][0] == now["detector"][1]
                    and det._fitted and det.pending_count() == 0)
            last["stable"] = last["stable"] + 1 if done and now == last.get("c") else 0
            last["c"] = now
            return last["stable"] >= 3

        assert wait_until(drained, 90.0, 0.5)
        read = {stage: c[0] for stage, c in last["c"].items()}
    finally:
        if sender is not None:
            sender.close()
        for stage in ("reader", "parser", "detector", "output"):
            if stage in services:
                services[stage].shutdown()
    records = [json.loads(x) for f in sorted((tmp / "out").glob("output.*"))
               for x in f.read_text().splitlines()]
    return read, records


def test_four_port_stages_against_four_jax_stages(pinned, tmp_path):
    """The same raw audit lines through both packages' four Services: the
    reader, parser and detector stages read as many lines in each (the
    parser's outputs are the detector's input), and both output files
    alert on every injected anomaly. Each detector fits its own weights
    here, so decisions off the anomalies may differ; identical decisions
    on bridged weights are held in test_torch_detector.py."""
    lines, anomalies = chip_smoke.make_audit_log(96, 384, anomaly_rate=0.02, seed=11)
    results = {}
    for pkg in ("jax", "port"):
        tmp = tmp_path / pkg
        tmp.mkdir()
        read, records = _pipeline(pkg, tmp, lines, pinned)
        # the reader's logIDs count up from the pinned id source: line i's is i
        alerted = {int(log_id[-12:], 16) for r in records for log_id in r["logIDs"]}
        results[pkg] = (read, alerted)
    # the output stage counts the lines of each package's own alert bytes
    for stage in ("reader", "parser", "detector"):
        assert results["port"][0][stage] == results["jax"][0][stage]
    assert results["port"][0]["reader"] == len(lines)
    assert anomalies and anomalies <= results["jax"][1] and anomalies <= results["port"][1]
    assert max(results["port"][1]) < len(lines)
