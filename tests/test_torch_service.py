"""The port's service host (``detectmateservice_tpu_torch/core.py``, the
admin plane and the CLI) on the CPU, held against the JAX package's:

* the port's Service hosting ``TorchScorerDetector`` beside the JAX Service
  hosting ``JaxScorerDetector``, from the same bridged weights, pinned to
  one threshold, on the same stream over zmq ipc: alerts may differ only
  within 1e-3 of the threshold, and the common scores agree to rtol 1e-4;
* the admin plane: the status report's keys, the slice's series on
  ``/metrics``, health (503 on ``?deep=1`` with a wedged loop), stop/start,
  reconfigure, the checkpoint verb and a restart that restores it, 404 on
  unknown and unported routes;
* a JAX ``MatcherParser`` Service feeding the port's detector Service;
* the CLI as a subprocess: the log split, alerts out, exit 0 after
  ``POST /admin/shutdown``;
* a detector with no ``device`` refuses to start without CUDA.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import prometheus_client
import pytest
import torch
import yaml

from detectmateservice_tpu.core import Service as RefService
from detectmateservice_tpu.engine.socket import TransportTimeout as RefTransportTimeout
from detectmateservice_tpu.engine.socket import ZmqPairSocketFactory as RefZmq
from detectmateservice_tpu.schemas import DetectorSchema as RefDetectorSchema
from detectmateservice_tpu.schemas import LogSchema as RefLogSchema
from detectmateservice_tpu.settings import ServiceSettings as RefSettings
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine import metrics as port_metrics
from detectmateservice_tpu_torch.engine.framing import pack_batch
from detectmateservice_tpu_torch.engine.socket import TransportTimeout, ZmqPairSocketFactory
from detectmateservice_tpu_torch.library.common.core import CoreComponent, LibraryError
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.schemas import DetectorSchema
from detectmateservice_tpu_torch.settings import ServiceSettings
from detectmateservice_tpu_torch.web.router import UNPORTED_ROUTES

from conftest import wait_until
from test_torch_detector import BASE, N_TRAIN, STREAM

REPO = Path(__file__).resolve().parents[1]
TORCH_SCORER = "detectmateservice_tpu_torch.library.detectors.torch_scorer.TorchScorerDetector"
PORT_CONFIG = dict(BASE, method_type="torch_scorer", device="cpu")
JAX_CONFIG = dict(BASE, method_type="jax_scorer")


def http(method, port, path, payload=None, timeout=30):
    body = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        return json.loads(raw) if "json" in resp.headers.get("Content-Type", "") else raw.decode()


def http_code(method, port, path):
    try:
        http(method, port, path, {} if method == "POST" else None)
    except urllib.error.HTTPError as err:
        return err.code
    return 200


@pytest.fixture()
def serve():
    """Run each Service's ``run()`` on a thread; shut down and join at the
    end. Returns the thread."""
    started = []

    def _serve(svc):
        thread = threading.Thread(target=svc.run, daemon=True)
        thread.start()
        started.append((svc, thread))
        assert wait_until(lambda: svc.web_server.port, 10.0)
        return thread

    yield _serve
    for svc, thread in started:
        svc.shutdown()
        thread.join(timeout=15.0)


@pytest.fixture()
def short_dir():
    """ipc paths must stay under 107 bytes: a short directory under /tmp."""
    path = tempfile.mkdtemp(prefix="dms", dir="/tmp")
    yield Path(path)
    shutil.rmtree(path, ignore_errors=True)


def _write(path, data):
    path.write_text(yaml.safe_dump(data))
    return str(path)


def _recv_all(sock, quiet_ms=1500, first_ms=20000):
    """Frames until the socket is quiet for ``quiet_ms``."""
    out, sock.recv_timeout = [], first_ms
    while True:
        try:
            out.append(sock.recv())
        except (TransportTimeout, RefTransportTimeout):
            return out
        sock.recv_timeout = quiet_ms


def _alerts(frames, schema):
    from detectmateservice_tpu_torch.engine.framing import unpack_batch

    msgs = [m for f in frames for m in (unpack_batch(f) or [f])]
    return {a["logIDs"][0]: a for a in map(schema.from_bytes, msgs)}


def _scorer_settings(cls, d, name, **kw):
    return cls(component_type=kw.pop("component_type", TORCH_SCORER),
               component_id=name, config_file=str(d / f"{name}.yaml"),
               engine_addr=f"ipc://{d}/{name}-in.ipc", out_addr=[f"ipc://{d}/{name}-out.ipc"],
               http_port=0, log_to_file=False, engine_batch_size=64,
               engine_batch_timeout_ms=5.0, transport_backend="zmq", **kw)


# -- the port's Service beside the JAX Service ---------------------------------

def test_service_matches_the_jax_service(short_dir, serve):
    _write(short_dir / "jax.yaml", {"detectors": {"JaxScorerDetector": JAX_CONFIG}})
    _write(short_dir / "port.yaml", {"detectors": {"TorchScorerDetector": PORT_CONFIG}})
    ref = RefService(_scorer_settings(RefSettings, short_dir, "jax",
                                      component_type="detectors.jax_scorer.JaxScorerDetector"))
    port = Service(_scorer_settings(ServiceSettings, short_dir, "port"))
    # the same initial weights: the JAX detector's seeded init, bridged
    ref.library_component._ensure_scorer()
    port.library_component.load_params(params_from_flax(
        jax.tree_util.tree_map(np.asarray, ref.library_component._params)))
    sinks = {"jax": RefZmq().create(f"ipc://{short_dir}/jax-out.ipc"),
             "port": ZmqPairSocketFactory().create(f"ipc://{short_dir}/port-out.ipc")}
    for svc in (ref, port):
        svc.setup_io()
        serve(svc)
    senders = {"jax": RefZmq().create_output(f"ipc://{short_dir}/jax-in.ipc", buffer_size=1000),
               "port": ZmqPairSocketFactory().create_output(f"ipc://{short_dir}/port-in.ipc",
                                                            buffer_size=1000)}
    train, detect = STREAM[:N_TRAIN], STREAM[N_TRAIN:]
    for sender in senders.values():
        for i in range(0, N_TRAIN, 32):
            sender.send(pack_batch(train[i:i + 32]))
    dets = {"jax": ref.library_component, "port": port.library_component}
    assert wait_until(lambda: all(d._fitted for d in dets.values()), 60.0)
    # pin both to the JAX detector's calibrated threshold
    threshold = float(dets["jax"]._threshold)
    for name, svc in (("jax", ref), ("port", port)):
        cfg = dict(JAX_CONFIG if name == "jax" else PORT_CONFIG, score_threshold=threshold)
        key = "JaxScorerDetector" if name == "jax" else "TorchScorerDetector"
        http("POST", svc.web_server.port, "/admin/reconfigure",
             {"config": {"detectors": {key: cfg}}})
    assert dets["port"]._threshold == dets["jax"]._threshold == threshold
    for sender in senders.values():
        # packed frames, with every third chunk as single messages
        for j, i in enumerate(range(0, len(detect), 16)):
            chunk = detect[i:i + 16]
            for frame in ([pack_batch(chunk)] if j % 3 else chunk):
                sender.send(frame)
    # every line sent is read, on both sides, before the alerts are drained
    lines = sum(max(1, m.count(b"\n") + (0 if m.endswith(b"\n") else 1)) for m in STREAM)

    def read_lines(name):
        registry = prometheus_client.REGISTRY if name == "jax" else port_metrics.REGISTRY
        svc = ref if name == "jax" else port
        return registry.get_sample_value("data_read_lines_total", {
            "component_type": svc.settings.component_type, "component_id": name})

    assert wait_until(lambda: all(read_lines(n) == lines and dets[n].pending_count() == 0
                                  for n in dets), 60.0)
    got = {name: _alerts(_recv_all(sink, quiet_ms=1000, first_ms=5000),
                         RefDetectorSchema if name == "jax" else DetectorSchema)
           for name, sink in sinks.items()}
    assert got["jax"] and len(got["jax"]) < len(detect)
    flips = set(got["jax"]) ^ set(got["port"])
    if flips:
        tokens, ok = dets["jax"]._featurize_raw_batch([STREAM[int(i)] for i in sorted(flips)])
        assert ok.all()
        assert np.all(np.abs(dets["jax"].score_tokens(tokens) - threshold) < 1e-3)
    for log_id in set(got["jax"]) & set(got["port"]):
        np.testing.assert_allclose(got["port"][log_id]["score"], got["jax"][log_id]["score"],
                                   rtol=1e-4)
    for sock in (*senders.values(), *sinks.values()):
        sock.close()


# -- the admin plane --------------------------------------------------------------

class Blocking(CoreComponent):
    """Echoes, but blocks inside ``process`` while ``gate`` is clear."""

    gate = threading.Event()

    def process(self, data):
        self.gate.wait(10.0)
        return data


def _core(cls, d, name, **kw):
    return cls(component_id=name, engine_addr=f"ipc://{d}/{name}.ipc", http_port=0,
               log_to_file=False, **kw)


def test_status_report_has_the_jax_keys(short_dir, serve):
    ref = RefService(_core(RefSettings, short_dir, "jax-status", transport_backend="zmq"))
    port = Service(_core(ServiceSettings, short_dir, "port-status"))
    serve(ref)
    serve(port)
    want = http("GET", ref.web_server.port, "/admin/status")
    got = http("GET", port.web_server.port, "/admin/status")
    assert set(got) == set(want) == {"status", "distributed", "settings", "configs"}
    assert set(got["status"]) == set(want["status"])
    assert got["distributed"] == {"initialized": False, "process_index": 0,
                                  "process_count": 1, "local_devices": None}
    assert set(got["settings"]) <= set(want["settings"])
    assert got["status"]["component_id"] == "port-status" and got["status"]["running"]


@pytest.fixture()
def scorer_service(short_dir, serve):
    """The port's scorer Service, fitted over its socket, with a sink."""
    cfg = dict(PORT_CONFIG, data_use_training=32, min_train_steps=5)
    _write(short_dir / "scorer.yaml", {"detectors": {"TorchScorerDetector": cfg}})
    settings = _scorer_settings(ServiceSettings, short_dir, "scorer",
                                checkpoint_dir=str(short_dir / "ckpt"))
    sink = ZmqPairSocketFactory().create(f"ipc://{short_dir}/scorer-out.ipc")
    svc = Service(settings)
    svc.setup_io()
    thread = serve(svc)
    sender = ZmqPairSocketFactory().create_output(f"ipc://{short_dir}/scorer-in.ipc")
    sender.send(pack_batch(STREAM[:32]))
    assert wait_until(lambda: svc.library_component._fitted, 30.0)
    # scorer_warmup_pending latches UNHEALTHY while the warm set is captured
    # and recovers after the watchdog's recovery intervals (2 of 2 s), which
    # a short fit may not have lasted
    assert wait_until(lambda: svc.health.state == "healthy", 15.0)
    yield svc, sender, sink, cfg, settings, thread
    sender.close()
    sink.close()


def _writable(sock) -> bool:
    """Whether a dialing socket has a live connection (``IMMEDIATE``: it is
    writable only then)."""
    import zmq

    return bool(sock._sock.getsockopt(zmq.EVENTS) & zmq.POLLOUT)


def _reconnect(svc, addr):
    """A sender to a restarted engine on a connection of its own (the
    stopped engine's input socket is gone, and a message the old connection
    takes before it notices is lost with it), once both it and the engine's
    re-dialed outputs are connected (an alert sent before that is dropped)."""
    sender = ZmqPairSocketFactory().create_output(addr)
    assert wait_until(lambda: _writable(sender)
                      and all(_writable(s) for s in svc.engine._out_socks), 10.0)
    return sender


def _anomaly(log_id):
    from detectmateservice_tpu_torch.schemas import ParserSchema

    return ParserSchema(EventID=9, template="segfault at <*> ip <*> sp <*>",
                        variables=["0xdead", "0xbeef", "0x1"], logID=log_id,
                        logFormatVariables={"Time": "1700000000"}).serialize()


def test_admin_plane(scorer_service):
    svc, sender, sink, cfg, _, _ = scorer_service
    port = svc.web_server.port
    assert http("GET", port, "/admin/health") == {"state": "healthy"}
    assert http("GET", port, "/admin/health?deep=1")["state"] == "healthy"
    assert "events" in http("GET", port, "/admin/events?limit=5")

    # stop, start, and the engine works again
    http("POST", port, "/admin/stop")
    assert not svc.engine.running
    assert http("GET", port, "/admin/status")["status"]["running"] is False
    http("POST", port, "/admin/start")
    assert wait_until(lambda: svc.engine.running)
    sender.close()
    sender = _reconnect(svc, svc.settings.engine_addr)
    sink.recv_timeout = 20000
    sender.send(_anomaly("after-restart"))
    assert DetectorSchema.from_bytes(sink.recv())["logIDs"] == ["after-restart"]

    # reconfigure: a threshold below every score makes a normal line alert
    http("POST", port, "/admin/reconfigure",
         {"config": {"detectors": {"TorchScorerDetector": dict(cfg, score_threshold=-1e9)}}})
    assert svc.library_component._threshold == -1e9
    sender.send(STREAM[40])
    assert DetectorSchema.from_bytes(sink.recv())["logIDs"] == ["40"]
    with pytest.raises(urllib.error.HTTPError) as err:
        http("POST", port, "/admin/reconfigure",
             {"config": {"detectors": {"TorchScorerDetector": dict(cfg, dim=64)}}})
    assert err.value.code == 500

    # the slice's series, the detector's among them after its detect batches
    metrics = http("GET", port, "/metrics")
    for series in ("data_read_bytes_total", "data_read_lines_total", "processing_errors_total",
                   "processing_duration_seconds", "detector_batch_size", "engine_running",
                   "engine_starts_total", "engine_ingress_backlog", "output_send_backlog",
                   "engine_health_state", "engine_heartbeat_age_seconds", "dm_build_info",
                   "detector_device_lines_total", "detector_device_batches_total",
                   "detector_batch_occupancy", "detector_queue_wait_seconds",
                   "detector_device_seconds"):
        assert f"\n{series}" in metrics, series
    sender.close()


def test_checkpoint_verb_and_restore_on_restart(scorer_service, serve):
    svc, sender, sink, _, settings, thread = scorer_service
    assert http("POST", svc.web_server.port, "/admin/checkpoint")["checkpoint"] == "saved"
    assert (Path(settings.checkpoint_dir) / "meta.json").exists()
    threshold = svc.library_component._threshold
    svc.shutdown()
    thread.join(timeout=15.0)
    assert not thread.is_alive()
    fresh = Service(settings)
    fresh.setup_io()
    det = fresh.library_component
    assert det._fitted and det._threshold == threshold
    serve(fresh)
    assert wait_until(lambda: fresh.engine.running, 10.0)
    sender.close()
    sender = _reconnect(fresh, settings.engine_addr)
    sink.recv_timeout = 20000
    sender.send(_anomaly("restored"))   # no training: the restore resumes alerting
    assert DetectorSchema.from_bytes(sink.recv())["logIDs"] == ["restored"]
    sender.close()


@pytest.mark.parametrize("method,path", [*UNPORTED_ROUTES, ("GET", "/nope"),
                                         ("POST", "/admin/nope")])
def test_unknown_and_unported_routes_give_404(short_dir, serve, method, path):
    svc = Service(_core(ServiceSettings, short_dir, "routes"))
    serve(svc)
    assert http_code(method, svc.web_server.port, path) == 404


def test_deep_health_is_503_while_the_loop_is_wedged(short_dir, serve):
    Blocking.gate.clear()
    svc = Service(_core(
        ServiceSettings, short_dir, "wedged", component_type="test_torch_service.Blocking",
        watchdog_interval_s=0.05, watchdog_stall_seconds=0.3,
        watchdog_unhealthy_seconds=60.0))
    serve(svc)
    assert wait_until(lambda: svc.engine.running)
    client = ZmqPairSocketFactory().create_output(f"ipc://{short_dir}/wedged.ipc")
    try:
        client.send(b"stuck")
        assert wait_until(lambda: http_code("GET", svc.web_server.port,
                                            "/admin/health?deep=1") == 503, 10.0)
        assert http("GET", svc.web_server.port, "/admin/health") == {"state": "degraded"}
        report = svc.health.report()
        assert {c["name"]: c["status"] for c in report["checks"]}["process_wedged"] \
            == "degraded"
    finally:
        Blocking.gate.set()
        client.close()


def test_detector_without_a_device_refuses_to_start_without_cuda(short_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {k: v for k, v in PORT_CONFIG.items() if k != "device"}
    _write(short_dir / "nodev.yaml", {"detectors": {"TorchScorerDetector": cfg}})
    svc = Service(_scorer_settings(ServiceSettings, short_dir, "nodev"))
    with pytest.raises(LibraryError, match="CUDA"):
        with svc:
            svc.run()
    assert svc._torn_down and not svc.engine.running


@pytest.mark.parametrize("component_type", ["detectors.new_value_detector.NewValueDetector",
                                            "detectmateservice_tpu.library.detectors."
                                            "jax_scorer.JaxScorerDetector"])
def test_components_only_the_jax_library_holds_are_not_ported(short_dir, component_type):
    with pytest.raises(ImportError, match="not ported|JAX package"):
        Service(_core(ServiceSettings, short_dir, "jaxonly", component_type=component_type))


# -- a JAX parser feeding the port's detector ----------------------------------------

def test_jax_parser_feeds_the_port_detector(short_dir, serve):
    templates = short_dir / "templates.txt"
    templates.write_text("user <*> ran <*>\nsegfault at <*> ip <*>\n")
    _write(short_dir / "parser.yaml", {"parsers": {"MatcherParser": {
        "method_type": "matcher_parser", "auto_config": False,
        "params": {"path_templates": str(templates)}}}})
    _write(short_dir / "det.yaml", {"detectors": {"TorchScorerDetector": dict(
        PORT_CONFIG, data_use_training=32, min_train_steps=20, threshold_sigma=4.0)}})
    parser = RefService(RefSettings(
        component_type="parsers.template_matcher.MatcherParser", component_id="parser",
        config_file=str(short_dir / "parser.yaml"), engine_addr=f"ipc://{short_dir}/p.ipc",
        out_addr=[f"ipc://{short_dir}/d.ipc"], http_port=0, log_to_file=False,
        transport_backend="zmq"))
    detector = Service(ServiceSettings(
        component_type=TORCH_SCORER, component_id="det",
        config_file=str(short_dir / "det.yaml"), engine_addr=f"ipc://{short_dir}/d.ipc",
        out_addr=[f"ipc://{short_dir}/a.ipc"], http_port=0, log_to_file=False,
        engine_batch_size=64))
    sink = ZmqPairSocketFactory().create(f"ipc://{short_dir}/a.ipc")
    detector.setup_io()
    serve(detector)
    parser.setup_io()
    serve(parser)
    ingress = RefZmq().create_output(f"ipc://{short_dir}/p.ipc")
    try:
        for i in range(32):
            ingress.send(RefLogSchema(logID=str(i), log=f"user u{i % 4} ran ls").serialize())
        assert wait_until(lambda: detector.library_component._fitted, 30.0)
        ingress.send(RefLogSchema(logID="99", log="segfault at 0xdead ip 0xbeef").serialize())
        sink.recv_timeout = 20000
        alert = DetectorSchema.from_bytes(sink.recv())
        assert alert["logIDs"] == ["99"] and alert["detectorType"] == "torch_scorer"
    finally:
        ingress.close()
        sink.close()


# -- the CLI as a subprocess ----------------------------------------------------------

def test_cli_subprocess(short_dir, free_port):
    cfg = dict(PORT_CONFIG, data_use_training=32, min_train_steps=5)
    _write(short_dir / "cfg.yaml", {"detectors": {"TorchScorerDetector": cfg}})
    settings = _write(short_dir / "settings.yaml", {
        "component_type": TORCH_SCORER, "config_file": str(short_dir / "cfg.yaml"),
        "engine_addr": f"ipc://{short_dir}/cli-in.ipc",
        "out_addr": [f"ipc://{short_dir}/cli-out.ipc"], "http_port": free_port,
        "log_to_file": False, "engine_batch_size": 64})
    sink = ZmqPairSocketFactory().create(f"ipc://{short_dir}/cli-out.ipc")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out, err = open(short_dir / "out.log", "wb"), open(short_dir / "err.log", "wb")
    proc = subprocess.Popen([sys.executable, "-m", "detectmateservice_tpu_torch.cli",
                             "--settings", settings], stdout=out, stderr=err, env=env,
                            cwd=str(short_dir))
    sender = ZmqPairSocketFactory().create_output(f"ipc://{short_dir}/cli-in.ipc")
    try:
        def running():
            try:
                return http("GET", free_port, "/admin/status", timeout=2)["status"]["running"]
            except (OSError, ValueError):
                return False

        assert wait_until(running, 60.0, 0.2), (short_dir / "err.log").read_text()
        sender.send(pack_batch(STREAM[:32]))
        sender.send(b"\xd7DM\x01\x05\x01a")     # a corrupt batch frame: an ERROR record
        sender.send(_anomaly("cli"))
        sink.recv_timeout = 30000
        assert DetectorSchema.from_bytes(sink.recv())["logIDs"] == ["cli"]
        http("POST", free_port, "/admin/shutdown")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        sender.close()
        sink.close()
        out.close()
        err.close()
    stdout, stderr = (short_dir / "out.log").read_text(), (short_dir / "err.log").read_text()
    assert "HTTP Admin active" in stdout
    assert "corrupt batch frame" in stderr and "corrupt batch frame" not in stdout
    assert "INFO" not in stderr
