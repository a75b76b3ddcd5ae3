"""The port's cross-stage telemetry (``telemetry/``) against the JAX
package's: span frames and OTLP documents byte for byte (span ids stable
across exports); the Perfetto view equal; the trace assembler's output equal
for out-of-order, duplicate-hop, watermark, timeout and flag cases; the tail
sampler's verdict equal per trace id at several ratios; span frames the JAX
exporter writes, fed to the port's collector, assemble the traces the JAX
collector assembles; the port's exporter writes the JAX exporter's bytes;
and through port Services the collector's routes and the e2e exemplar."""
import json
import random
import time
import re
import threading
import uuid
from types import SimpleNamespace

import pytest

from detectmateservice_tpu.engine import framing as ref_framing
from detectmateservice_tpu.engine.socket import InprocQueueSocketFactory as RefInproc
from detectmateservice_tpu.telemetry import SpanExporter as RefExporter
from detectmateservice_tpu.telemetry import TailSampler as RefSampler
from detectmateservice_tpu.telemetry import TelemetryCollector as RefCollector
from detectmateservice_tpu.telemetry import TraceAssembler as RefAssembler
from detectmateservice_tpu.telemetry import otlp as ref_otlp
from detectmateservice_tpu.telemetry import perfetto as ref_perfetto
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine import framing
from detectmateservice_tpu_torch.engine import metrics as port_metrics
from detectmateservice_tpu_torch.engine.socket import InprocQueueSocketFactory
from detectmateservice_tpu_torch.settings import ServiceSettings
from detectmateservice_tpu_torch.telemetry import (
    SpanExporter,
    TailSampler,
    TelemetryCollector,
    TraceAssembler,
    otlp,
    perfetto,
)

from conftest import wait_until

MS = 1_000_000


def tel_settings(**over):
    base = dict(telemetry_addr="inproc://tel", telemetry_queue_size=4096,
                telemetry_flush_interval_ms=50.0, telemetry_collector=True,
                telemetry_collector_addr="inproc://tel", telemetry_sample_healthy_ratio=1.0,
                telemetry_slo_ms=1000.0, telemetry_settle_ms=0.0,
                telemetry_trace_timeout_s=5.0, telemetry_retain_traces=256,
                telemetry_otlp_url=None, shed_tenant_buckets=16)
    base.update(over)
    return SimpleNamespace(**base)


def labels():
    return {"component_type": "telemetry.test", "component_id": f"tel-{uuid.uuid4().hex[:8]}"}


def hop(tid, stage, ingest, recv, send, terminal=False, **extra):
    span = {"trace_id": f"{tid:016x}", "stage": stage, "replica": "r0", "ingest_ns": ingest,
            "recv_ns": recv, "send_ns": send, "terminal": terminal}
    span.update(extra)
    return span


def built(tid=0xABC, complete=True, flags=(), e2e=0.010, verdict="healthy", tenant=None):
    return {"trace_id": f"{tid:016x}", "ingest_ns": 1000,
            "e2e_seconds": e2e if complete else None, "complete": complete,
            "flags": sorted(flags), "tenant_bucket": tenant, "verdict": verdict,
            "hops": [{"stage": "reader", "recv_ns": 1000, "send_ns": 2000, "replica": "r0"},
                     {"stage": "detector", "recv_ns": 3000, "send_ns": 4000, "replica": ""}]}


# -- span frames ----------------------------------------------------------------

SPANS = [[], [hop(1, "a", 0, 1, 2)],
         [hop(2**64 - 1, "détecteur", 10, 20, 30, True, tenant_bucket="7"),
          {"trace_id": "00000000000000ff", "stage": "x", "replica": "", "flags": ["error"]}]]


@pytest.mark.parametrize("case", range(len(SPANS)))
def test_span_frames_are_byte_equal(case):
    frame = framing.pack_spans(SPANS[case])
    assert frame == ref_framing.pack_spans(SPANS[case])
    assert framing.unpack_spans(frame) == ref_framing.unpack_spans(frame) == SPANS[case]


@pytest.mark.parametrize("frame", [b"plain", framing.pack_batch([b"a"]),
                                   framing.MAGIC_SPAN + b"\x02{]",
                                   framing.MAGIC_SPAN + b"\x02{}",
                                   framing.MAGIC_SPAN + b"\x7f[]",
                                   framing.pack_spans([]) + b"x"])
def test_span_frame_refusals_agree(frame):
    def outcome(mod):
        try:
            return mod.unpack_spans(frame)
        except mod.FramingError:
            return "raises"

    assert outcome(framing) == outcome(ref_framing)


# -- OTLP and Perfetto ------------------------------------------------------------

TRACES = [built(), built(0xFEED, flags=["error"], verdict="error", tenant="3"),
          built(0x1, complete=False, verdict="incomplete"),
          built(0x2, flags=["quarantined", "fault"], verdict="quarantined"),
          dict(built(0x3), verdict=None, ingest_ns=None)]


def test_otlp_documents_are_byte_equal_and_span_ids_stable():
    resource = {"component_id": "c", "component_type": "core"}
    doc = otlp.encode_traces(TRACES, resource)
    assert json.dumps(doc, sort_keys=False) == json.dumps(
        ref_otlp.encode_traces(TRACES, resource), sort_keys=False)
    # a re-export gives the same span ids
    assert otlp.encode_traces(TRACES, resource) == doc
    assert otlp.span_id("00ab", "reader") == ref_otlp.span_id("00ab", "reader")
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert spans[1]["parentSpanId"] == spans[0]["spanId"]
    assert all(re.fullmatch(r"[0-9a-f]{32}", s["traceId"]) for s in spans)
    assert otlp.encode_traces([]) == ref_otlp.encode_traces([])


def test_perfetto_events_equal_the_jax_export():
    assert perfetto.trace_events(TRACES + TRACES[:1]) == ref_perfetto.trace_events(
        TRACES + TRACES[:1])


def test_otlp_push_posts_the_document_to_a_local_endpoint():
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    bodies = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(self.rfile.read(int(self.headers["Content-Length"])))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        doc = otlp.encode_traces(TRACES[:1])
        assert otlp.push(f"http://127.0.0.1:{server.server_address[1]}/v1/traces", doc) == 200
    finally:
        server.shutdown()
        server.server_close()
    assert json.loads(bodies[0]) == doc


# -- assembly and sampling ----------------------------------------------------------

def _assemble(cls, settle_ns, timeout_ns, steps):
    """``steps``: ("add", span, now) or ("poll", now); the outcomes in order."""
    asm = cls(settle_ns=settle_ns, timeout_ns=timeout_ns)
    out = []
    for step in steps:
        if step[0] == "add":
            try:
                out.append(asm.add(dict(step[1]), step[2]))
            except (KeyError, TypeError, ValueError) as exc:
                out.append(type(exc).__name__)
        else:
            out.append(asm.poll(step[1]))
    return out, asm.watermark, asm.deduped, asm.backlog


T0 = 1_000_000_000
CASES = {
    "out_of_order": (0, 10_000 * MS, [
        ("add", hop(0x10, "output", T0, T0 + 9 * MS, T0 + 10 * MS, True), 0),
        ("add", hop(0x10, "detector", T0, T0 + 5 * MS, T0 + 8 * MS), 0),
        ("add", hop(0x10, "parser", T0, T0 + 1 * MS, T0 + 4 * MS), 0),
        ("poll", 1)]),
    "duplicate_hop": (0, 10_000 * MS, [
        ("add", hop(0x11, "detector", T0, T0 + 5 * MS, T0 + 6 * MS), 0),
        ("add", hop(0x11, "detector", T0, T0 + 2 * MS, T0 + 3 * MS), 0),
        ("add", hop(0x11, "detector", T0, T0 + 9 * MS, T0 + 9 * MS), 0),
        ("add", hop(0x11, "output", T0, T0 + 10 * MS, T0 + 11 * MS, True), 0),
        ("poll", 1)]),
    "watermark": (50 * MS, 10_000 * MS, [
        ("add", hop(0x12, "output", T0, T0 + 1 * MS, T0 + 2 * MS, True), 0),
        ("poll", 1),
        ("add", hop(0x13, "output", T0, T0 + 30 * MS, T0 + 40 * MS, True), 2),
        ("poll", 3),
        ("add", hop(0x14, "output", T0, T0 + 60 * MS, T0 + 60 * MS, True), 4),
        ("poll", 5)]),
    "timeout": (0, 100 * MS, [
        ("add", hop(0x15, "parser", T0, T0 + 1 * MS, T0 + 2 * MS), 0),
        ("poll", 50 * MS),
        ("add", hop(0x16, "parser", T0, T0 + 3 * MS, T0 + 4 * MS), 60 * MS),
        ("poll", 100 * MS),
        ("poll", 200 * MS)]),
    "flags": (0, 10_000 * MS, [
        ("add", {"trace_id": f"{0x17:016x}", "stage": "detector", "flags": ["shed"]}, 0),
        ("add", hop(0x17, "parser", T0, T0 + 1 * MS, T0 + 2 * MS, tenant_bucket="4",
                    flags=["error"]), 0),
        ("add", hop(0x17, "output", T0, T0 + 3 * MS, T0 + 4 * MS, True), 0),
        ("poll", 1)]),
    "malformed": (0, 10_000 * MS, [
        ("add", {"stage": "x"}, 0),
        ("add", {"trace_id": "zz", "stage": "x"}, 0),
        ("add", hop(0x18, "p", T0, 1, 2) | {"send_ns": None}, 0),
        ("poll", 1)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_assembler_outputs_equal_the_jax_assemblers(case):
    settle, timeout, steps = CASES[case]
    port = _assemble(TraceAssembler, settle, timeout, steps)
    assert port == _assemble(RefAssembler, settle, timeout, steps)
    if case == "duplicate_hop":
        assert port[2] == 2
        (completed, _), = [o for o in port[0] if isinstance(o, tuple) and o[0]]
        assert completed[0]["hops"][0]["recv_ns"] == T0 + 2 * MS


@pytest.mark.parametrize("ratio", [0.0, 0.05, 0.3, 0.5, 0.999, 1.0])
def test_tail_sampler_verdicts_equal_per_trace_id(ratio):
    rng = random.Random(7)
    port, ref = TailSampler(ratio, 0.25), RefSampler(ratio, 0.25)
    kept = 0
    for _ in range(2000):
        tid = rng.getrandbits(64)
        trace = built(tid, complete=rng.random() > 0.05,
                      flags=rng.sample(["error", "quarantined", "shed", "fault"],
                                       k=int(rng.random() < 0.1)),
                      e2e=rng.random() * 0.3)
        verdict = port.verdict(trace)
        assert verdict == ref.verdict(trace)
        kept += verdict[0]
    if 0.0 < ratio < 1.0:
        assert 0 < kept < 2000


# -- exporters and collectors across packages -----------------------------------------

def _offers(exporter):
    t0 = T0
    for tid in (0x21, 0x22, 0x23):
        for i, stage in enumerate(("reader", "parser", "detector")):
            exporter.offer(tid, t0, t0 + i * MS, t0 + (i + 1) * MS, i == 2,
                           "tenant-a" if tid == 0x22 else None)
    exporter.offer_flag(0x23, "error")
    exporter.offer_flag(None, "error")


@pytest.mark.parametrize("stage", ["reader", "détecteur"])
def test_the_exporter_writes_the_jax_exporters_bytes(stage):
    frames = {}
    for name, exp_cls, factory in (("port", SpanExporter, InprocQueueSocketFactory()),
                                   ("jax", RefExporter, RefInproc())):
        listener = factory.create("inproc://tel-bytes", None, None)
        listener.recv_timeout = 1000
        exporter = exp_cls(tel_settings(telemetry_addr="inproc://tel-bytes"), factory, stage,
                           {"component_type": "t", "component_id": "replica-1"})
        _offers(exporter)
        assert exporter.flush() == 10
        frames[name] = listener.recv()
        exporter.stop()
    assert frames["port"] == frames["jax"]


def test_jax_span_frames_assemble_the_jax_collectors_traces_in_the_port_collector():
    """Span frames from JAX exporters (one per stage, flushed through an
    in-process socket) fed to both collectors' ``ingest_frame``: the same
    stats, retained traces, Perfetto and OTLP exports."""
    factory = RefInproc()
    listener = factory.create("inproc://tel-x", None, None)
    listener.recv_timeout = 1000
    settings = tel_settings(telemetry_addr="inproc://tel-x", telemetry_settle_ms=1.0,
                            telemetry_sample_healthy_ratio=0.5)
    stages = ["reader", "parser", "detector", "output"]
    exporters = [RefExporter(settings, factory, s, {"component_type": "t",
                                                    "component_id": s}) for s in stages]
    rng = random.Random(3)
    for n in range(64):
        tid = rng.getrandbits(64)
        for i, exp in enumerate(exporters):
            if n % 16 == 5 and i == 3:
                continue      # no terminal hop: expires incomplete
            exp.offer(tid, T0 + n * MS, T0 + (n + i) * MS, T0 + (n + i + 1) * MS, i == 3,
                      "tenant-z" if n % 3 == 0 else None)
        if n % 10 == 0:
            exporters[1].offer_flag(tid, "quarantined")
    frames = []
    for exp in reversed(exporters):      # the terminal stage's spans arrive first
        assert exp.flush() > 0
        frames.append(listener.recv())
        exp.stop()
    frames.append(b"not a span frame")
    docs = []
    for cls in (TelemetryCollector, RefCollector):
        collector = cls(settings, None, labels={"component_type": "t", "component_id": "c"})
        merged = [collector.ingest_frame(f) for f in frames]
        collector.pump(now_ns=time.time_ns())
        # past telemetry_trace_timeout_s on the collector's clock
        collector.pump(now_ns=time.time_ns() + 10 * 1_000_000_000)
        docs.append((merged, collector.snapshot(), collector.retained(),
                     collector.perfetto_events(), collector.otlp_payload(),
                     collector.trace(collector.retained()[0]["trace_id"])))
    assert docs[0] == docs[1]
    stats = docs[0][1]["stats"]
    assert stats["assembled"] == 60 and stats["incomplete"] == 4 and stats["bad_frames"] == 1


def test_the_exporter_is_bounded_and_its_spans_reach_a_port_collector():
    factory = InprocQueueSocketFactory()
    lab = labels()
    settings = tel_settings(telemetry_addr="inproc://tel-rt", telemetry_queue_size=16)
    listener = factory.create("inproc://tel-rt", None, None)
    listener.recv_timeout = 1000
    exporter = SpanExporter(settings, factory, "reader", lab)
    dropped = port_metrics.TELEMETRY_EXPORT_DROPPED().labels(**lab)
    for i in range(20):
        exporter.offer(i + 1, T0, T0, T0 + MS, True, None)
    assert exporter.backlog == 16 and dropped._value.get() == 4
    assert exporter.flush() == 16
    collector = TelemetryCollector(settings, factory, labels=lab)
    assert collector.ingest_frame(listener.recv()) == 16
    collector.pump(now_ns=0)
    assert collector.snapshot()["stats"]["assembled"] == 16
    assert collector.trace("1")["hops"][0]["stage"] == "reader"
    exporter.stop()


# -- through Services -----------------------------------------------------------------

def _http(port, path, raw=False):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        body = resp.read()
        return body.decode() if raw else json.loads(body)


def test_services_export_assemble_and_serve_the_collectors_routes():
    """relay → sink, both traced; the relay exports spans, the sink hosts
    the collector and ends each trace (and exports its own spans): ``GET
    /admin/traces`` holds the two-hop traces (``?id=``, Perfetto, OTLP),
    ``/admin/trace?format=chrome`` on the sink is the cross-stage document
    and on the relay its own hops, and the sink's e2e histogram carries a
    retained trace's id as its exemplar."""
    factory = InprocQueueSocketFactory()
    tag = uuid.uuid4().hex[:8]
    tel = f"inproc://svc-tel-{tag}"

    def settings(stage, addr, outs=(), **kw):
        return ServiceSettings(component_type="core", component_id=f"{stage}-{tag}",
                               trace_stage=stage, engine_addr=addr, out_addr=list(outs),
                               engine_trace=True, telemetry_addr=tel, http_port=0,
                               log_to_file=False, log_to_console=False,
                               watchdog_enabled=False, telemetry_flush_interval_ms=10.0, **kw)

    # spans of one trace arrive from two exporters in either order: the
    # collector waits 50 ms of watermark for stragglers, and a trace no
    # later span settles completes at the 1 s timeout
    sink = Service(settings("sink", f"inproc://svc-{tag}-b", telemetry_collector=True,
                            telemetry_collector_addr=tel, telemetry_settle_ms=50.0,
                            telemetry_trace_timeout_s=1.0,
                            telemetry_sample_healthy_ratio=1.0), socket_factory=factory)
    relay = Service(settings("relay", f"inproc://svc-{tag}-a", [f"inproc://svc-{tag}-b"]),
                    socket_factory=factory)
    threads = [threading.Thread(target=svc.run, daemon=True) for svc in (sink, relay)]
    for thread in threads:
        thread.start()
    n = 10
    try:
        assert wait_until(lambda: sink.engine.running and relay.engine.running
                          and sink.web_server.port and relay.web_server.port, 10.0)
        client = factory.create_output(f"inproc://svc-{tag}-a")
        for i in range(n):
            client.send(f"line {i}".encode())
        assert wait_until(lambda: sink.telemetry.snapshot()["stats"]["assembled"] >= n, 10.0)
        port = sink.web_server.port
        traces = _http(port, "/admin/traces")
        one = _http(port, f"/admin/traces?id={traces['traces'][0]['trace_id']}")
        perfetto_doc = _http(port, "/admin/traces?format=perfetto")
        otlp_doc = _http(port, "/admin/traces?format=otlp")
        chrome = _http(port, "/admin/trace?format=chrome")
        local = _http(relay.web_server.port, "/admin/trace?format=chrome")
        missing = _http_code(relay.web_server.port, "/admin/traces")
        unknown = _http_code(port, "/admin/traces?id=0123456789abcdef")
        openmetrics = _http(port, "/metrics?format=openmetrics", raw=True)
    finally:
        for svc in (relay, sink):
            svc.shutdown()
        for thread in threads:
            thread.join(10)
    assert traces["stats"]["bad_frames"] == 0 and len(traces["traces"]) == n
    assert all(t["stages"] == 2 and t["complete"] for t in traces["traces"])
    assert [h["stage"] for h in one["hops"]] == ["relay", "sink"]
    assert "localOnly" not in chrome and chrome == perfetto_doc
    assert local["localOnly"] is True
    assert len(otlp_doc["resourceSpans"][0]["scopeSpans"][0]["spans"]) == \
        2 * len(traces["traces"])
    assert (missing, unknown) == (404, 404)
    exemplars = re.findall(r'pipeline_e2e_latency_seconds_bucket\{[^}]*component_id="sink-'
                           + tag + r'"[^}]*\} [0-9.e+]+ # \{trace_id="([0-9a-f]{16})"\}',
                           openmetrics)
    assert exemplars and set(exemplars) & {t["trace_id"] for t in traces["traces"]}


def _http_code(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as exc:
        return exc.code


def test_an_exporter_whose_collector_never_listens_never_holds_the_loop():
    """Spans queue (bounded) for a collector that is not there; every frame
    still completes its trace and its reply."""
    factory = InprocQueueSocketFactory()
    tag = uuid.uuid4().hex[:8]
    svc = Service(ServiceSettings(component_type="core", component_id=f"nocol-{tag}",
                                  engine_addr=f"inproc://nocol-{tag}", engine_trace=True,
                                  telemetry_addr=f"inproc://nocol-tel-{tag}",
                                  telemetry_queue_size=16, http_port=0, log_to_file=False,
                                  log_to_console=False, watchdog_enabled=False),
                  socket_factory=factory)
    with svc:
        svc.start()
        client = factory.create_output(f"inproc://nocol-{tag}")
        client.recv_timeout = 5000
        for i in range(40):
            client.send(b"m%d" % i)
            assert client.recv() == b"m%d" % i
        assert wait_until(lambda: svc.engine.trace_recorder.completed == 40, 5.0)
