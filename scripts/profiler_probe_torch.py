"""What ``torch.profiler`` records on this machine's card, before a service
relies on it.

    python3 scripts/profiler_probe_torch.py [OUT_DIR]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(it builds the fused head, ``ops/csrc/scorehead.cu``). Each probe prints one
JSON line:

* ``plain``: ``profile(activities=[CPU, CUDA])`` over a few matmuls on the
  thread that started it: device events in the chrome trace and device time
  in ``key_averages()``;
* ``graph``: the fused head (kernel 1, bf16 wgmma variant) and a matmul
  captured into one CUDA graph, replayed 8 times inside the window: kernel
  events per replay, by name;
* ``threads``: the profiler started and stopped on one thread while another
  thread launches the work: that thread's CPU ops and its kernels in the
  trace;
* ``trace_size``: a 1 s window over a loop of small ops: events and bytes of
  the exported chrome trace;
* ``capture_overlap`` (last): the profiler started on one thread while
  another thread is between ``capture_begin`` and ``capture_end`` of a CUDA
  graph, and stopped before the capture ends: whether the capture survives
  and its replay still scores what the eager call scores.

The traces land in ``OUT_DIR`` (default: a temporary directory, removed at
the end; the 1 s window of small ops alone writes ≈ 100 MB). Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from detectmateservice_tpu_torch.ops import scorehead  # noqa: E402

ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _events(path: Path) -> list:
    return json.loads(path.read_text()).get("traceEvents", [])


def _device(events: list) -> list:
    return [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _export(prof, out: Path, name: str) -> list:
    path = out / f"{name}.json"
    prof.export_chrome_trace(str(path))
    return _events(path)


def probe_plain(out: Path) -> dict:
    a = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=ACTS) as prof:
        for _ in range(4):
            a = a @ a / 2048.0
        torch.cuda.synchronize()
    events = _export(prof, out, "plain")
    dev_us = sum(getattr(k, "device_time_total", 0.0) or getattr(k, "cuda_time_total", 0.0)
                 for k in prof.key_averages())
    return {"device_events": len(_device(events)), "events": len(events),
            "key_averages_device_us": dev_us,
            "kernel_names": sorted({e["name"][:80] for e in _device(events)})[:6]}


def _head_inputs():
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(1024, 128, device="cuda", generator=gen).bfloat16()
    e = torch.randn(32768, 128, device="cuda", generator=gen).bfloat16()
    return h, e


def probe_graph(out: Path) -> dict:
    h, e = _head_inputs()
    w = torch.randn(128, 128, device="cuda").bfloat16()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        scorehead.candidate_lse(h @ w, e)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = scorehead.candidate_lse(h @ w, e)
    torch.cuda.synchronize()
    replays = 8
    with profile(activities=ACTS) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    events = _export(prof, out, "graph")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names: dict = {}
    for ev in kernels:
        key = ev["name"].split("(")[0][:60]
        names[key] = names.get(key, 0) + 1
    lse = sum(n for k, n in names.items() if "lse_wgmma_kernel" in k)
    want = scorehead.candidate_lse_reference(h.float() @ w.float(), e.float())
    return {"replays": replays, "kernel_events": len(kernels), "by_name": names,
            "lse_wgmma_per_replay": lse / replays, "variant": scorehead.variant(
                1024, 32768, 128, torch.bfloat16),
            "max_abs_err": float((got.float() - want).abs().max())}


def probe_threads(out: Path) -> dict:
    a = torch.randn(1024, 1024, device="cuda")
    torch.cuda.synchronize()
    started, stop, done = threading.Event(), threading.Event(), threading.Event()
    worker_tid = []

    def work():
        worker_tid.append(threading.get_native_id())
        started.wait(10)
        b = a
        while not stop.is_set():
            b = torch.tanh(b @ a / 1024.0)
        torch.cuda.synchronize()
        done.set()

    thread = threading.Thread(target=work, name="probe-worker")
    thread.start()
    with profile(activities=ACTS) as prof:
        started.set()
        time.sleep(0.3)
    stop.set()
    done.wait(10)
    thread.join(10)
    events = _export(prof, out, "threads")
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    tids = {}
    for ev in cpu_ops:
        tids[str(ev.get("tid"))] = tids.get(str(ev.get("tid")), 0) + 1
    return {"worker_tid": worker_tid[0], "cpu_ops_by_tid": tids,
            "worker_ops": tids.get(str(worker_tid[0]), 0),
            "device_events": len(_device(events))}


def probe_capture_overlap(out: Path) -> dict:
    h, e = _head_inputs()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        scorehead.candidate_lse(h, e)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    in_capture, profiled = threading.Event(), threading.Event()
    result: dict = {}

    def capture():
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                got = scorehead.candidate_lse(h, e)
                in_capture.set()
                profiled.wait(10)
            graph.replay()
            torch.cuda.synchronize()
            result["replay_equal_eager"] = bool(torch.equal(got, scorehead.candidate_lse(h, e)))
            result["capture"] = "ok"
        except Exception as exc:  # noqa: BLE001 — the finding is the failure
            result["capture"] = f"{type(exc).__name__}: {exc}"[:300]

    thread = threading.Thread(target=capture, name="probe-capture")
    thread.start()
    in_capture.wait(10)
    try:
        prof = profile(activities=ACTS)
        prof.start()
        time.sleep(0.05)
        prof.stop()
        result["profiler"] = "ok"
        result["device_events"] = len(_device(_export(prof, out, "capture_overlap")))
    except Exception as exc:  # noqa: BLE001 — the finding is the failure
        result["profiler"] = f"{type(exc).__name__}: {exc}"[:300]
    profiled.set()
    thread.join(30)
    try:
        torch.cuda.synchronize()
        result["after"] = "ok"
    except Exception as exc:  # noqa: BLE001
        result["after"] = f"{type(exc).__name__}: {exc}"[:300]
    return result


def probe_trace_size(out: Path) -> dict:
    x = torch.randn(64, device="cuda")
    torch.cuda.synchronize()
    ops = 0
    with profile(activities=ACTS) as prof:
        t_end = time.perf_counter() + 1.0
        while time.perf_counter() < t_end:
            x = x * 1.0001 + 0.0001
            ops += 2
        torch.cuda.synchronize()
    path = out / "trace_size.json"
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    export_s = time.perf_counter() - t0
    events = _events(path)
    return {"ops_issued": ops, "events": len(events), "device_events": len(_device(events)),
            "bytes": path.stat().st_size, "export_s": export_s}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profiler_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    keep = len(argv) > 1
    out = Path(argv[1]) if keep else Path(tempfile.mkdtemp(prefix="dmprobe"))
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "pid": os.getpid()}), flush=True)
    for name, fn in (("plain", probe_plain), ("graph", probe_graph),
                     ("threads", probe_threads), ("trace_size", probe_trace_size),
                     ("capture_overlap", probe_capture_overlap)):
        t0 = time.perf_counter()
        try:
            row = fn(out)
        except Exception as exc:  # noqa: BLE001 — each probe reports on its own
            row = {"error": f"{type(exc).__name__}: {exc}"[:500]}
        print(json.dumps({"probe": name, "seconds": time.perf_counter() - t0, **row}),
              flush=True)
    if not keep:
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
