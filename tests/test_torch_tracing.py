"""The port's pipeline tracing against the JAX package's: trace blocks, v2
frames, the downgrade to v1 and ``peek_trace_id`` byte for byte; the flight
recorder's snapshots and Chrome events equal after the same records; each
package's Engine, fed the same frames one at a time, forwards frames of the
same shape (v2 or v1, payload, hop stages) and observes as many dwell,
transit and e2e samples in single, micro-batch and fused-frame modes, with
deferred outputs and at a terminal stage; and a two-stage pipeline of port
Services gives the hops, per-stage counts and ``/admin/trace`` keys of the
same pipeline of JAX Services."""
import json
import re
import threading
import time
import urllib.request
import uuid

import pytest

from detectmateservice_tpu.core import Service as RefService
from detectmateservice_tpu.engine import Engine as RefEngine
from detectmateservice_tpu.engine import framing as ref_framing
from detectmateservice_tpu.engine import metrics as ref_metrics
from detectmateservice_tpu.engine import tracing as ref_tracing
from detectmateservice_tpu.engine.socket import InprocQueueSocketFactory as RefInproc
from detectmateservice_tpu.engine.socket import TransportTimeout as RefTimeout
from detectmateservice_tpu.settings import ServiceSettings as RefSettings
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine import framing
from detectmateservice_tpu_torch.engine import metrics as port_metrics
from detectmateservice_tpu_torch.engine import tracing
from detectmateservice_tpu_torch.engine.engine import Engine
from detectmateservice_tpu_torch.engine.socket import InprocQueueSocketFactory, TransportTimeout
from detectmateservice_tpu_torch.settings import ServiceSettings

from conftest import wait_until

PACKAGES = {
    "jax": (RefEngine, RefSettings, RefInproc, RefTimeout, ref_framing, ref_metrics),
    "port": (Engine, ServiceSettings, InprocQueueSocketFactory, TransportTimeout, framing,
             port_metrics),
}


def _ctx(mod, trace_id, ingest, hops):
    ctx = mod.TraceContext(trace_id, ingest)
    for stage, recv, send in hops:
        ctx.hops.append(mod.Hop(stage, recv, send))
    return ctx


CONTEXTS = [
    (0, 0, []),
    (0xFFFFFFFFFFFFFFFF, 1_700_000_000_000_000_000, [("parser", 1_700_000_000_000_000_100,
                                                       1_700_000_000_000_009_000)]),
    (0x0123456789ABCDEF, 5, [("a", 6, 7), ("détecteur", 8, 8), ("x" * 300, 2**40, 2**62)]),
]


# -- the wire ---------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(CONTEXTS)))
def test_trace_blocks_and_v2_frames_are_byte_equal(case):
    port_ctx, ref_ctx = (_ctx(mod, *CONTEXTS[case]) for mod in (framing, ref_framing))
    block = framing.pack_trace_block(port_ctx)
    assert block == ref_framing.pack_trace_block(ref_ctx)
    assert framing.parse_trace_block(block) == port_ctx
    for payload in (framing.pack_batch([b"aa", b"", b"c" * 200]), b"\x0aone message", b""):
        frame = framing.wrap_trace(payload, port_ctx)
        assert frame == ref_framing.wrap_trace(payload, ref_ctx)
        got, ctx, damaged = framing.unwrap_trace(ref_framing.wrap_trace(payload, ref_ctx))
        # the downgrade to v1 is a slice: the untraced sender's bytes
        assert (got, ctx, damaged) == (payload, port_ctx, False)
        assert framing.peek_trace_id(frame) == ref_framing.peek_trace_id(frame) \
            == CONTEXTS[case][0]
        tenanted = framing.wrap_tenant(frame, "tenant-a")
        assert framing.peek_trace_id(tenanted) == ref_framing.peek_trace_id(tenanted)
        assert framing.frame_msg_count(frame) == ref_framing.frame_msg_count(frame)


@pytest.mark.parametrize("frame", [
    b"", b"plain", framing.pack_batch([b"m1"]), framing.MAGIC_V2 + b"\x7f" + b"short",
    framing.MAGIC_V2 + b"\x03abc" + b"payload", framing.MAGIC_V2 + b"\x80",
    framing.MAGIC_TEN + b"\x7fx", framing.MAGIC_TEN + b"\x01t" + b"plain",
    framing.MAGIC_TEN + b"\x01t" + framing.MAGIC_V2 + b"\x05short",
])
def test_peek_and_unwrap_agree_on_odd_frames(frame):
    assert framing.peek_trace_id(frame) == ref_framing.peek_trace_id(frame)

    def outcome(mod):
        try:
            payload, ctx, damaged = mod.unwrap_trace(frame)
        except mod.FramingError:
            return "raises"
        return payload, None if ctx is None else mod.pack_trace_block(ctx), damaged

    assert outcome(framing) == outcome(ref_framing)


def test_a_garbled_block_keeps_its_payload_in_both():
    payload = framing.pack_batch([b"keep", b"me"])
    block = ref_framing.pack_trace_block(_ctx(ref_framing, *CONTEXTS[1]))[:-2] + b"\xff\xff"
    frame = bytearray(framing.MAGIC_V2)
    framing._put_varint(frame, len(block))
    frame = bytes(frame + block + payload)
    assert framing.unwrap_trace(frame) == (payload, None, True)
    assert ref_framing.unwrap_trace(frame) == (payload, None, True)


def test_new_trace_ids_are_distinct_64_bit_values():
    ids = {framing.TraceContext.new(i).trace_id for i in range(1000)}
    assert len(ids) == 1000 and all(0 <= i < 2**64 for i in ids)


# -- the flight recorder --------------------------------------------------------

@pytest.mark.parametrize("bounds", [(3, 8, 1), (32, 128, 64), (4, 2, 3), (1, 1, 1)])
def test_recorder_snapshots_and_chrome_events_equal_the_jax_recorders(bounds):
    slowest, sampled, every = bounds
    port_rec = tracing.FlightRecorder(slowest, sampled, every)
    ref_rec = ref_tracing.FlightRecorder(slowest, sampled, every)
    for i in range(40):
        e2e = float((i * 7) % 13) / 10.0   # ties included
        hops = [("parser", 1000 * i + 5, 1000 * i + 50), ("detector", 1000 * i + 60,
                                                           1000 * i + 60 + i)]
        port_rec.record(_ctx(framing, 0x1000 + i, 1000 * i, hops), e2e)
        ref_rec.record(_ctx(ref_framing, 0x1000 + i, 1000 * i, hops), e2e)
    assert port_rec.snapshot() == ref_rec.snapshot()
    assert port_rec.chrome_events() == ref_rec.chrome_events()
    assert port_rec.last_trace_id == ref_rec.last_trace_id == f"{0x1000 + 39:016x}"
    port_rec.reset()
    assert port_rec.snapshot() == {"completed": 0, "slowest": [], "sampled": []}


def test_trace_to_dict_and_frame_context_helpers():
    ctx = _ctx(framing, 0xAB, 3, [("s", 4, 5)])
    assert tracing.trace_to_dict(ctx, 0.5) == ref_tracing.trace_to_dict(
        _ctx(ref_framing, 0xAB, 3, [("s", 4, 5)]), 0.5)
    seen = []

    def other_thread():
        seen.append((tracing.current_trace_id(), tracing.current_tenant()))

    tracing.FRAME_CONTEXT.trace_id, tracing.FRAME_CONTEXT.tenant = 7, "t"
    try:
        thread = threading.Thread(target=other_thread)
        thread.start()
        thread.join(5)
        assert (tracing.current_trace_id(), tracing.current_tenant()) == (7, "t")
    finally:
        tracing.FRAME_CONTEXT.trace_id = tracing.FRAME_CONTEXT.tenant = None
    assert seen == [(None, None)]
    from detectmateservice_tpu.shed.quota import tenant_bucket as ref_bucket

    for tenant in ("a", "tenant-b", "", "ünï"):
        assert tracing.tenant_bucket(tenant) == ref_bucket(tenant, 16)


# -- the engine -----------------------------------------------------------------

class Echo:
    def process(self, data):
        return data


class BatchEcho(Echo):
    def process_batch(self, batch):
        return list(batch)


class FramesEcho(BatchEcho):
    """Whole wire frames (fused-frame mode)."""

    def process_frames(self, frames):
        outs = []
        for frame in frames:
            msgs = framing.unpack_batch(frame)
            outs.extend(msgs if msgs is not None else [frame])
        return outs, len(outs), len(outs)


class Deferred(BatchEcho):
    """Holds every batch until the next drain tick (the coalescing
    detector's deferred outputs)."""

    def __init__(self):
        self.held = []

    def process_batch(self, batch):
        self.held.extend(batch)
        return []

    def pending_count(self):
        return len(self.held)

    def drain_ready(self):
        out, self.held = self.held, []
        return out

    flush = drain_ready


def _count(metrics, series, cid):
    """Observations of a histogram under ``component_id`` ``cid``."""
    total = 0.0
    for metric in series().collect():
        for sample in metric.samples:
            if sample.name.endswith("_count") and sample.labels.get("component_id") == cid:
                total += sample.value
    return total


def _run_engine(pkg, processor, frames, **settings):
    """Each frame sent alone, its outputs awaited: returns the outputs as
    (tenant, traced, payload, hop stages), the stage's observation counts
    and its recorder's snapshot."""
    engine_cls, settings_cls, factory_cls, timeout_cls, mod, metrics = PACKAGES[pkg]
    factory = factory_cls()
    tag = uuid.uuid4().hex[:8]
    cid = f"trace-{pkg}-{tag}"
    outs = settings.pop("outs", True)
    addr = f"inproc://tr-{tag}"
    sink = None
    if outs:
        sink = factory.create(f"inproc://tr-{tag}-out")
        sink.recv_timeout = 300
    engine = engine_cls(settings_cls(component_type="core", component_id=cid,
                                     engine_addr=addr, log_to_file=False,
                                     out_addr=[f"inproc://tr-{tag}-out"] if outs else [],
                                     **settings), processor, factory)
    engine.start()
    client = factory.create_output(addr)
    client.recv_timeout = 300
    reader = sink if sink is not None else client
    got = []
    try:
        for frame in frames:
            client.send(frame)
            while True:
                try:
                    out = reader.recv()
                except timeout_cls:
                    break
                # a tenant block rides outermost, the trace block inside it
                inner, tenant, _ = mod.unwrap_tenant(out)
                payload, ctx, damaged = mod.unwrap_trace(inner)
                assert not damaged
                got.append((tenant, ctx is not None, payload,
                            [h.stage for h in ctx.hops] if ctx is not None else None))
    finally:
        engine.stop()
    counts = {name: _count(metrics, getattr(metrics, attr), cid) for name, attr in (
        ("dwell", "PIPELINE_STAGE_DWELL"), ("transit", "PIPELINE_TRANSIT"),
        ("e2e", "PIPELINE_E2E_LATENCY"))}
    return got, counts, engine.trace_recorder.snapshot()


def _frames():
    ref_ctx = _ctx(ref_framing, 0xFEED, time.time_ns() - 1_000_000,
                   [("upstream", time.time_ns() - 900_000, time.time_ns() - 500_000)])
    return [b"plain one", framing.pack_batch([b"a", b"b", b"c"]),
            ref_framing.wrap_trace(b"traced single", ref_ctx),
            ref_framing.wrap_trace(framing.pack_batch([b"t1", b"t2"]), ref_ctx),
            framing.wrap_tenant(b"tenanted", "tenant-x")]


MODES = {
    "single": (Echo, {}),
    "micro_batch": (BatchEcho, {"engine_batch_size": 8}),
    "fused_frames": (FramesEcho, {"engine_batch_size": 8}),
    "deferred": (Deferred, {"engine_batch_size": 8}),
    "packed_egress": (BatchEcho, {"engine_batch_size": 8, "engine_frame_batch": 4}),
    "terminal_override": (BatchEcho, {"engine_batch_size": 8, "trace_terminal": True}),
    "observe_e2e": (BatchEcho, {"engine_batch_size": 8, "trace_observe_e2e": True}),
    "reply_terminal": (BatchEcho, {"engine_batch_size": 8, "outs": False}),
    "trace_off": (BatchEcho, {"engine_batch_size": 8, "engine_trace": False}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_engines_stamp_alike(mode):
    """The same frames through each package's engine: the same outputs
    (tenant re-stamped outermost, v2 or v1, payload, hop stages), the same
    dwell, transit and e2e counts and the same recorded traces' hop
    stages."""
    cls, settings = MODES[mode]
    settings = dict({"engine_trace": True, "trace_stage": "stage", "trace_sample_every": 1},
                    **settings)
    results = {}
    for pkg in PACKAGES:
        got, counts, snap = _run_engine(pkg, cls(), _frames(), **dict(settings))
        stages = sorted(tuple(h["stage"] for h in t["hops"]) for t in snap["sampled"])
        results[pkg] = (got, counts, snap["completed"], stages)
    assert results["port"] == results["jax"]
    got, counts, completed, _ = results["port"]
    if settings["engine_trace"]:
        assert counts["dwell"] == 5 and counts["transit"] == 2
    else:
        assert counts == {"dwell": 0, "transit": 0, "e2e": 0}
        assert not any(traced for _, traced, *_ in got)
    if mode in ("terminal_override", "reply_terminal", "observe_e2e"):
        assert counts["e2e"] == completed == 5
    if mode == "deferred":
        # the contexts close at burst end; the held outputs leave as v1
        assert not any(traced for _, traced, *_ in got) and counts["e2e"] == 0


def test_a_traced_frame_gains_this_stages_hop():
    got, counts, _ = _run_engine("port", BatchEcho(), _frames()[2:3], engine_trace=True,
                                 trace_stage="detector", engine_batch_size=4)
    assert got == [(None, True, b"traced single", ["upstream", "detector"])]
    assert counts == {"dwell": 1, "transit": 1, "e2e": 0}


def test_error_and_quarantine_flags_reach_the_exporter():
    class Raising(BatchEcho):
        def process_batch(self, batch):
            raise RuntimeError("poison")

        process = process_batch

    offers = []
    factory = InprocQueueSocketFactory()
    engine = Engine(ServiceSettings(component_type="core", component_id="flags",
                                    engine_addr="inproc://flags", engine_trace=True,
                                    engine_batch_size=4, telemetry_addr="inproc://flags-tel",
                                    log_to_file=False), Raising(), factory)
    engine._telemetry.offer_flag = lambda tid, flag: offers.append((tid, flag))
    engine.start()
    try:
        factory.create_output("inproc://flags").send(b"poison")
        assert wait_until(lambda: len(offers) >= 2, 5.0)
    finally:
        engine.stop()
    assert [flag for _, flag in offers][:2] == ["error", "quarantined"]
    assert len({tid for tid, _ in offers}) == 1


# -- two stages of Services -------------------------------------------------------

def _http(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read())


def _pipeline(pkg, n):
    """relay → sink, both traced, in process over the package's in-process
    queues; ``n`` messages; returns the sink's /admin/trace, the recorded
    hop stages and the per-stage counts."""
    settings_cls = RefSettings if pkg == "jax" else ServiceSettings
    service_cls = RefService if pkg == "jax" else Service
    factory = RefInproc() if pkg == "jax" else InprocQueueSocketFactory()
    metrics = ref_metrics if pkg == "jax" else port_metrics
    tag = uuid.uuid4().hex[:8]

    def settings(stage, addr, outs=()):
        return settings_cls(component_type="core", component_id=f"{stage}-{pkg}-{tag}",
                            trace_stage=stage, engine_addr=addr, out_addr=list(outs),
                            engine_trace=True, trace_sample_every=1, http_port=0,
                            log_to_file=False, log_to_console=False, watchdog_enabled=False)

    sink = service_cls(settings("sink", f"inproc://p2-{tag}-b"), socket_factory=factory)
    relay = service_cls(settings("relay", f"inproc://p2-{tag}-a", [f"inproc://p2-{tag}-b"]),
                        socket_factory=factory)
    threads = []
    for svc in (sink, relay):
        thread = threading.Thread(target=svc.run, daemon=True)
        thread.start()
        threads.append(thread)
    try:
        assert wait_until(lambda: sink.web_server.port and relay.web_server.port
                          and sink.engine.running and relay.engine.running, 10.0)
        client = factory.create_output(f"inproc://p2-{tag}-a")
        for i in range(n):
            client.send(f"line {i}\n".encode())
        assert wait_until(lambda: sink.engine.trace_recorder.completed >= n, 10.0)
        body = _http(sink.web_server.port, "/admin/trace")
        chrome = _http(relay.web_server.port, "/admin/trace?format=chrome")
    finally:
        for svc in (relay, sink):
            svc.shutdown()
        for thread in threads:
            thread.join(10)
    counts = {stage: {name: _count(metrics, getattr(metrics, attr), f"{stage}-{pkg}-{tag}")
                      for name, attr in (("dwell", "PIPELINE_STAGE_DWELL"),
                                         ("transit", "PIPELINE_TRANSIT"),
                                         ("e2e", "PIPELINE_E2E_LATENCY"))}
              for stage in ("relay", "sink")}
    return body, chrome, counts


def test_two_stage_pipeline_equals_the_jax_pipeline():
    n = 12
    port_body, port_chrome, port_counts = _pipeline("port", n)
    ref_body, ref_chrome, ref_counts = _pipeline("jax", n)
    assert set(port_body) == set(ref_body) == {"completed", "slowest", "sampled",
                                               "tracing_enabled"}
    assert port_body["completed"] == ref_body["completed"] == n
    assert port_body["tracing_enabled"] is True
    assert port_counts == ref_counts == {"relay": {"dwell": n, "transit": 0, "e2e": 0},
                                         "sink": {"dwell": n, "transit": n, "e2e": n}}
    for body in (port_body, ref_body):
        for trace in body["sampled"]:
            assert [h["stage"] for h in trace["hops"]] == ["relay", "sink"]
            stamps = [t for h in trace["hops"] for t in (h["recv_ns"], h["send_ns"])]
            assert stamps == sorted(stamps) and stamps[0] >= trace["ingest_ns"]
    # a stage without a collector serves its own hops, and says so
    assert port_chrome["localOnly"] is True and ref_chrome["localOnly"] is True
    assert set(port_chrome) == set(ref_chrome)


def test_health_events_carry_the_last_trace_id():
    factory = InprocQueueSocketFactory()
    svc = Service(ServiceSettings(component_type="core", component_id="evt",
                                  engine_addr="inproc://evt", engine_trace=True,
                                  http_port=0, log_to_file=False, log_to_console=False,
                                  watchdog_enabled=False), socket_factory=factory)
    with svc:
        assert svc.health.emit_event({"kind": "probe"})["trace_id"] is None
        svc.start()
        client = factory.create_output("inproc://evt")
        client.recv_timeout = 5000
        client.send(b"ping")
        assert client.recv() == b"ping"
        assert wait_until(lambda: svc.engine.trace_recorder.completed == 1, 5.0)
        last = svc.engine.trace_recorder.last_trace_id
        assert svc.health.emit_event({"kind": "probe"})["trace_id"] == last
        assert svc.health.evaluate() and svc.health.trace_recorder is svc.engine.trace_recorder


def test_json_log_records_carry_the_frames_trace_and_tenant_bucket():
    import logging

    from detectmateservice_tpu.engine.health import JsonLogFormatter as RefFormatter
    from detectmateservice_tpu_torch.engine.health import JsonLogFormatter

    record = logging.LogRecord("x", logging.WARNING, __file__, 1, "poison %s", ("m",), None)
    docs = {}
    for name, fmt, ctx in (("port", JsonLogFormatter(static={"a": "b"}), tracing),
                           ("jax", RefFormatter(static={"a": "b"}), ref_tracing)):
        ctx.FRAME_CONTEXT.trace_id, ctx.FRAME_CONTEXT.tenant = 0xBEEF, "tenant-b"
        try:
            docs[name] = json.loads(fmt.format(record))
        finally:
            ctx.FRAME_CONTEXT.trace_id = ctx.FRAME_CONTEXT.tenant = None
        plain = json.loads(fmt.format(record))
        assert "trace_id" not in plain and "tenant_bucket" not in plain
    docs["port"].pop("ts"), docs["jax"].pop("ts")
    assert docs["port"] == docs["jax"]
    assert docs["port"]["trace_id"] == f"{0xBEEF:016x}"


@pytest.mark.parametrize("native", [True, False])
def test_featurize_row_series_follow_featurize_rows(native):
    """Under a hosting Service (its metric factories handed in) the
    detector's featurize_rows also move featurize_native_rows_total and
    featurize_fallback_rows_total, as the JAX detector counts them."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector

    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": {
        "method_type": "torch_scorer", "device": "cpu", "auto_config": False,
        "model": "mlp", "data_use_training": 64, "min_train_steps": 5, "seq_len": 16,
        "dim": 32, "vocab_size": 1024, "max_batch": 64, "dtype": "float32",
        "async_fit": False, "head_impl": "einsum", "native_featurize": native}}})
    det.metrics = port_metrics
    labels = dict(component_type="torch_scorer", component_id=det.name)
    series = (port_metrics.FEATURIZE_NATIVE_ROWS().labels(**labels),
              port_metrics.FEATURIZE_FALLBACK_ROWS().labels(**labels))
    before = [s._value.get() for s in series]     # the series are process-wide
    det.setup_io()
    msgs, _ = chip_smoke.make_messages(200, anomaly_rate=0.0)
    for start in range(0, len(msgs), 50):
        det.process_batch(msgs[start:start + 50])
    det.flush_final()
    native_rows, fallback_rows = (s._value.get() - b for s, b in zip(series, before))
    assert (native_rows, fallback_rows) == (det.featurize_rows["native"],
                                           det.featurize_rows["fallback"])
    assert (native_rows if native else fallback_rows) >= 200


def test_device_batches_carry_the_last_trace_id():
    """A detector under a traced Service: each batch's ledger span and its
    queue-wait sample's exemplar carry the flight recorder's last completed
    trace id at dispatch, as the JAX detector's do; with no trace, none."""
    import sys
    from pathlib import Path
    from types import SimpleNamespace

    from prometheus_client.openmetrics import exposition

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from detectmateservice_tpu_torch.engine import device_obs
    from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector

    ledger = device_obs.CompileLedger()
    previous = device_obs.activate(ledger)
    try:
        det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": {
            "method_type": "torch_scorer", "device": "cpu", "auto_config": False,
            "model": "mlp", "data_use_training": 64, "min_train_steps": 5, "seq_len": 16,
            "dim": 32, "vocab_size": 1024, "max_batch": 64, "dtype": "float32",
            "async_fit": False, "head_impl": "einsum", "host_score_max_batch": 0}}})
        recorder = tracing.FlightRecorder()
        det.metrics = port_metrics
        det.health_monitor = SimpleNamespace(trace_recorder=recorder)
        det.setup_io()
        msgs, _ = chip_smoke.make_messages(192, anomaly_rate=0.0)
        det.process_batch(msgs[:64])          # the fit
        det.flush_final()
        det.process_batch(msgs[64:128])       # no trace completed yet
        det.flush_final()
        recorder.record(_ctx(framing, 0xC0FFEE, 1, [("relay", 2, 3)]), 0.004)
        det.process_batch(msgs[128:])
        det.flush_final()
        spans = ledger.snapshot()["batches"]
    finally:
        device_obs.activate(previous)
    assert spans[-1]["trace_id"] == f"{0xC0FFEE:016x}"
    assert any(s["trace_id"] is None for s in spans[:-1])
    text = exposition.generate_latest(port_metrics.REGISTRY).decode()
    assert re.search(r'detector_queue_wait_seconds_bucket\{[^}]*component_id="'
                     + re.escape(det.name) + r'"[^}]*\} [0-9.e+]+ # \{trace_id="0000000000c0ffee"\}',
                     text)
