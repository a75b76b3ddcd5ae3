"""The port's on-demand profiler (``utils/profiling.py``) and its three
routes against the JAX package's, on the CPU: one capture per process,
numbered ``capture-NNNN`` directories, the ``capture.json`` marker on
success and on error, pruning to ``max_captures``, ``status``, ``wait``,
``latest_dir`` and ``zip_latest``; the same status keys, the same refusals
(400 on bad seconds, 404 before the first capture, 409 while one runs) from
both packages' Services. On a CPU caller a capture records the host's CPU
activity only (with every thread's ops); a CUDA device without CUDA
activity raises. Both transitions hold every registered warm set's lock."""
import io
import json
import math
import threading
import time
import urllib.error
import urllib.request
import uuid
import zipfile

import pytest
import torch

from detectmateservice_tpu.core import Service as RefService
from detectmateservice_tpu.engine.socket import InprocQueueSocketFactory as RefInproc
from detectmateservice_tpu.settings import ServiceSettings as RefSettings
from detectmateservice_tpu.utils import profiling as ref_profiling
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine.socket import InprocQueueSocketFactory
from detectmateservice_tpu_torch.settings import ServiceSettings
from detectmateservice_tpu_torch.utils import profiling

from conftest import wait_until


def _capture(manager, base, seconds=0.1, **kw):
    manager.start(str(base), seconds, **kw)
    assert manager.wait(60)
    return manager.status()["last"]


def test_a_cpu_capture_writes_a_marked_chrome_trace_of_every_thread(tmp_path):
    manager = profiling.ProfileManager()
    stop = threading.Event()
    tids = []

    def work():
        tids.append(threading.get_native_id())
        x = torch.ones(64)
        while not stop.is_set():
            x = x * 1.0001
            time.sleep(0.001)

    worker = threading.Thread(target=work)
    worker.start()
    try:
        info = manager.start(str(tmp_path), 0.2)
        assert info["state"] == "running" and info["activities"] == ["cpu"]
        assert manager.status()["running"]
        assert manager.wait(60) and not manager.status()["running"]
    finally:
        stop.set()
        worker.join(10)
    last = manager.status()["last"]
    assert last["state"] == "done" and last["dir"].endswith("capture-0001")
    marker = json.loads((tmp_path / "capture-0001" / "capture.json").read_text())
    assert marker == last
    events = json.loads((tmp_path / "capture-0001" / profiling.TRACE_FILE).read_text())
    ops = [e for e in events["traceEvents"] if e.get("cat") == "cpu_op"]
    assert last["trace_bytes"] == (tmp_path / "capture-0001" / profiling.TRACE_FILE).stat().st_size
    # the worker's ops, though another thread started the capture
    assert last["all_threads"] is True
    assert any(e.get("tid") == tids[0] for e in ops)
    start, stop_span = last["transitions_monotonic"]["start"], \
        last["transitions_monotonic"]["stop"]
    assert start[0] <= start[1] <= stop_span[0] <= stop_span[1]
    assert stop_span[0] - start[1] >= 0.2


def test_status_and_info_keys_cover_the_jax_managers(tmp_path):
    port, ref = profiling.ProfileManager(), ref_profiling.ProfileManager()
    assert port.status() == ref.status() == {"running": False, "current": None, "last": None}
    port_last = _capture(port, tmp_path / "port")
    ref_last = _capture(ref, tmp_path / "jax")
    assert set(port.status()) == set(ref.status())
    assert set(ref_last) <= set(port_last)
    assert port_last["state"] == ref_last["state"] == "done"
    assert port_last["seq"] == ref_last["seq"] == 1
    assert port.default_dir() == ref.default_dir()
    assert profiling.MAX_CAPTURE_SECONDS == ref_profiling.MAX_CAPTURE_SECONDS


@pytest.mark.parametrize("seconds", [0, -1, 300.5, math.nan, math.inf])
def test_bad_seconds_raise_in_both(tmp_path, seconds):
    for mod in (profiling, ref_profiling):
        with pytest.raises(mod.ProfileError, match="seconds"):
            mod.ProfileManager().start(str(tmp_path), seconds)
    assert not list(tmp_path.iterdir())


def test_one_capture_at_a_time(tmp_path):
    manager = profiling.ProfileManager()
    manager.start(str(tmp_path), 0.3)
    try:
        with pytest.raises(profiling.ProfileBusyError, match="already running"):
            manager.start(str(tmp_path), 0.1)
        assert issubclass(profiling.ProfileBusyError, profiling.ProfileError)
    finally:
        assert manager.wait(60)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["capture-0001"]


def test_pruning_latest_and_zip(tmp_path):
    manager = profiling.ProfileManager()
    assert manager.latest_dir(str(tmp_path)) is None and manager.zip_latest(str(tmp_path)) is None
    for _ in range(3):
        _capture(manager, tmp_path, max_captures=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["capture-0002", "capture-0003"]
    assert manager.latest_dir(str(tmp_path)) == str(tmp_path / "capture-0003")
    name, data = manager.zip_latest(str(tmp_path))
    assert name == "capture-0003.zip"
    assert sorted(zipfile.ZipFile(io.BytesIO(data)).namelist()) == ["capture.json", "trace.json"]
    # an unmarked directory (a capture still being written) is never served
    (tmp_path / "capture-0004").mkdir()
    assert manager.latest_dir(str(tmp_path)) == str(tmp_path / "capture-0003")


def test_a_failed_capture_is_marked_with_its_error(tmp_path, monkeypatch):
    import torch.profiler

    class Broken:
        def __init__(self, **kwargs):
            pass

        def start(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    last = _capture(profiling.ProfileManager(), tmp_path)
    assert last["state"] == "error" and "no profiler here" in last["error"]
    assert json.loads((tmp_path / "capture-0001" / "capture.json").read_text()) == last


def test_a_cuda_device_without_cuda_activity_raises(tmp_path, monkeypatch):
    """Never a silent host-only trace of a CUDA caller."""
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(profiling.ProfileError, match="CUDA"):
        profiling.ProfileManager().start(str(tmp_path), 0.1, device=torch.device("cuda", 0))
    assert not list(tmp_path.iterdir())


def test_transitions_hold_every_registered_warm_set_lock(tmp_path):
    from detectmateservice_tpu_torch.library.detectors.graphs import WarmSet

    warm = WarmSet(torch.device("cpu"), ledger=None, backend="cpu",
                   eager=lambda kind, tokens: tokens, ident=lambda kind: None)
    assert warm in profiling.PROFILER._owners
    manager = profiling.ProfileManager()
    owner = type("Owner", (), {"lock": threading.RLock()})()
    manager.register_capture_lock(owner)
    held, release = threading.Event(), threading.Event()

    def hold():
        with owner.lock:
            held.set()
            release.wait(10)

    holder = threading.Thread(target=hold)
    holder.start()
    held.wait(10)
    manager.start(str(tmp_path), 0.05)
    time.sleep(0.3)
    assert manager.status()["running"]
    release.set()
    holder.join(10)
    assert manager.wait(60)
    last = manager.status()["last"]
    start = last["transitions_monotonic"]["start"]
    assert last["state"] == "done" and start[1] - start[0] >= 0.25
    del owner
    assert len(manager._owners) == 0


def test_a_fit_step_holds_the_warm_set_lock():
    """Every fit step holds the detector's warm-set lock, which profiler
    transitions hold, as a fine-tune's steps do: a capture starts or stops
    between steps, never during a backward."""
    from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
    from detectmateservice_tpu_torch.schemas import ParserSchema

    det = TorchScorerDetector(config={
        "method_type": "torch_scorer", "device": "cpu", "auto_config": False, "model": "mlp",
        "vocab_size": 256, "dim": 16, "seq_len": 8, "max_batch": 32, "dtype": "float32",
        "data_use_training": 32, "min_train_steps": 3, "train_epochs": 1,
        "async_fit": False})
    det.setup_io()
    assert det._warm in profiling.PROFILER._owners
    held = []
    step = det._scorer.train_step

    def recording(*args, **kwargs):
        held.append(det._warm.lock._is_owned())
        return step(*args, **kwargs)

    det._scorer.train_step = recording
    det.process_batch([ParserSchema(EventID=1, template="user <*> in", variables=[str(i)],
                                    logID=str(i)).serialize() for i in range(32)])
    assert len(held) >= 3 and all(held)


# -- the routes, on each package's Service ------------------------------------------

def _request(port, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else (
        b"{}" if method == "POST" else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


PACKAGES = {"port": (Service, ServiceSettings, InprocQueueSocketFactory, profiling),
            "jax": (RefService, RefSettings, RefInproc, ref_profiling)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_the_profile_routes_answer_alike(pkg, tmp_path):
    """The sequence of ``tests/test_device_obs.py``'s profile checks on
    each package's Service: 404 before the first capture, 200 then 409,
    400 on ``seconds=0`` and ``bogus``, the status after, the zip with its
    marker, and pruning to ``profile_max_captures`` = 2 after three
    captures; returns the codes, which both packages must give."""
    service_cls, settings_cls, factory_cls, mod = PACKAGES[pkg]
    svc = service_cls(settings_cls(component_type="core", component_name=f"prof-{pkg}",
                                   engine_addr=f"inproc://prof-{uuid.uuid4().hex[:8]}",
                                   http_port=0, log_to_file=False, log_to_console=False,
                                   watchdog_enabled=False, profile_dir=str(tmp_path / "p"),
                                   profile_max_captures=2), socket_factory=factory_cls())
    thread = threading.Thread(target=svc.run, daemon=True)
    thread.start()
    codes = []
    try:
        assert wait_until(lambda: svc.web_server.port, 10.0)
        port = svc.web_server.port
        codes.append(_request(port, "GET", "/admin/profile/latest")[0])
        code, body = _request(port, "POST", "/admin/profile?seconds=0.2")
        codes.append(code)
        assert json.loads(body)["detail"] == "capture started"
        code, body = _request(port, "POST", "/admin/profile?seconds=0.2")
        codes.append(code)
        assert "already running" in json.loads(body)["detail"]
        codes.append(_request(port, "GET", "/admin/profile/latest")[0])
        assert mod.PROFILER.wait(60)
        status = json.loads(_request(port, "GET", "/admin/profile")[1])
        assert status["running"] is False and status["last"]["state"] == "done"
        assert status["profile_dir"] == str(tmp_path / "p")
        code, data = _request(port, "GET", "/admin/profile/latest")
        codes.append(code)
        assert "capture.json" in zipfile.ZipFile(io.BytesIO(data)).namelist()
        for query in ("seconds=0", "seconds=bogus"):
            codes.append(_request(port, "POST", f"/admin/profile?{query}")[0])
        # the older body shape, then the newest two kept
        codes.append(_request(port, "POST", "/admin/profile", {"duration_ms": 100})[0])
        assert mod.PROFILER.wait(60)
        codes.append(_request(port, "POST", "/admin/profile", {"seconds": 0.1})[0])
        assert mod.PROFILER.wait(60)
        kept = sorted(p.name for p in (tmp_path / "p").iterdir())
    finally:
        svc.shutdown()
        thread.join(10)
    assert kept == ["capture-0002", "capture-0003"]
    assert codes == [404, 200, 409, 409, 200, 400, 400, 200, 200]


_KINETO_THREAD_SCRIPT = """
import sys, tempfile, torch
from detectmateservice_tpu_torch.utils import profiling
if sys.argv[1] == "init":
    assert profiling.PROFILER.init_on_this_thread(torch.device("cpu"))
profiling.PROFILER.start(tempfile.mkdtemp(), 0.1, device=torch.device("cpu"))
assert profiling.PROFILER.wait(120)
assert profiling.PROFILER.status()["last"]["state"] == "done"
"""


@pytest.mark.parametrize("mode", ["capture-thread-first", "init"])
def test_kineto_initializes_on_the_thread_that_registered_it(mode):
    """ROADMAP.md queue 3 item 17: torch registers its Kineto client on the thread that
    imports it, and a first start on the capture thread logs "External init
    callback must run in same thread as registerClient"; a start and stop
    on the main thread first (``init_on_this_thread``, which a Service on
    CUDA calls before its engine starts) leaves no such line. Off the main
    thread it does nothing."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _KINETO_THREAD_SCRIPT, mode],
                          capture_output=True, text=True, timeout=240,
                          cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr[-2000:]
    logged = "External init callback must run in same thread as registerClient" in proc.stderr
    assert logged == (mode == "capture-thread-first")
    ran = []
    worker = threading.Thread(target=lambda: ran.append(
        profiling.PROFILER.init_on_this_thread(torch.device("cpu"))))
    worker.start()
    worker.join()
    assert ran == [False]
