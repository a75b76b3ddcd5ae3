"""Host cost of pipeline tracing and span export at one stage.

    python3 scripts/trace_cost_bench.py [--package detectmateservice_tpu_torch]
                                        [--n 30000] [--modes off,trace,tel]

One ``core`` Service (an echo stage, ``engine_batch_size`` 32, the scorer
example's engine settings) of the named package, ended traces
(``trace_terminal``), fed ``--n`` single 200-byte messages over zmq ipc by
a sender process and read back by this process. ``off``: plain frames, no
tracing; ``trace``: v2 frames with one upstream hop, ``engine_trace`` on
(parse, transit, dwell, e2e, the flight recorder); ``tel``: the same with
``telemetry_addr`` (the span exporter's thread; the frames go to a socket
that only drains them). Prints one JSON line per mode: messages/s and the
microseconds per message it implies. The stage runs on the host; no device
is involved. Pass ``--package detectmateservice_tpu`` to run the JAX
package's Service the same way (it needs that package's dependencies).
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SENDER = """
import sys, time
sys.path.insert(0, {repo!r})
from detectmateservice_tpu_torch.engine.framing import Hop, TraceContext, wrap_trace
from detectmateservice_tpu_torch.engine.socket import ZmqPairSocketFactory
sock = ZmqPairSocketFactory().create_output({addr!r}, buffer_size=1000)
msg = b"x" * 200
now = time.time_ns()
ctx = TraceContext.new(now)
ctx.hops.append(Hop("upstream", now, now + 1000))
frames = [wrap_trace(msg, ctx) if {traced} else msg for _ in range({n})]
time.sleep(0.3)
for frame in frames:
    sock.send(frame)
time.sleep(2)
"""


def run(package: str, mode: str, n: int) -> dict:
    core = importlib.import_module(f"{package}.core")
    settings_mod = importlib.import_module(f"{package}.settings")
    socket_mod = importlib.import_module(f"{package}.engine.socket")
    tmp = tempfile.mkdtemp(prefix="tcb", dir="/tmp")
    kw = {} if mode == "off" else {"engine_trace": True, "trace_terminal": True}
    factory = socket_mod.ZmqPairSocketFactory()
    drain = None
    if mode == "tel":
        kw["telemetry_addr"] = f"ipc://{tmp}/tel.ipc"
        drain = factory.create(kw["telemetry_addr"])
        drain.recv_timeout = 200
    svc = core.Service(settings_mod.ServiceSettings(
        component_type="core", component_name=f"stage-{mode}",
        engine_addr=f"ipc://{tmp}/in.ipc", out_addr=[f"ipc://{tmp}/out.ipc"], http_port=0,
        log_to_file=False, log_to_console=False, engine_batch_size=32,
        engine_buffer_size=8192, watchdog_enabled=False, transport_backend="zmq", **kw))
    sink = factory.create(f"ipc://{tmp}/out.ipc")
    sink.recv_timeout = 3000
    stop = threading.Event()

    def drain_spans():
        while not stop.is_set():
            try:
                drain.recv()
            except socket_mod.TransportError:
                continue

    drainer = threading.Thread(target=drain_spans, daemon=True) if drain else None
    if drainer:
        drainer.start()
    svc.start()
    sender = subprocess.Popen([sys.executable, "-c", SENDER.format(
        repo=str(REPO), addr=f"ipc://{tmp}/in.ipc", traced=mode != "off", n=n)])
    got, t0 = 0, None
    try:
        while got < n:
            try:
                sink.recv()
            except socket_mod.TransportTimeout:
                break
            if t0 is None:
                t0 = time.perf_counter()
            got += 1
        elapsed = time.perf_counter() - t0
    finally:
        sender.wait(60)
        svc.stop()
        stop.set()
        if drainer:
            drainer.join(5)
            drain.close()
        sink.close()
    if got != n:
        raise RuntimeError(f"{mode}: {got} of {n} messages came back")
    rate = (n - 1) / elapsed
    return {"package": package, "mode": mode, "n": n, "msgs_per_s": rate,
            "us_per_msg": 1e6 / rate}


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package", default="detectmateservice_tpu_torch")
    parser.add_argument("--n", type=int, default=30000)
    parser.add_argument("--modes", default="off,trace,tel")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    for mode in args.modes.split(","):
        print(json.dumps(run(args.package, mode, args.n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
