"""Release waits and socket rate of the scorer example's service, for
versions of the port side by side on one CUDA card.

    python3 scripts/coalesce_ab_torch.py [--reps N] [--profile-first | --profile-between]
                                         [--gc-log] [--loop-log] [--probe]
                                         [--lifecycle | --trace] [ROOT ...]

Each ROOT is a checkout of the repo (default: the repo root), for example a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Each runs in a process of its own, in the order
given (list them as parent, change, change, parent to see the spread; list
one root 8 times for 8 fresh processes): it builds the fused head and runs
``chip_smoke.coalesce_service`` of that checkout ``--reps`` times (the
example hosted by the port's Service, 65,536 single messages from a sender
process, 64 lone messages), and prints one JSON line per run with the
largest and mean release wait, the releases, the socket lines/s and the
lone p50. ``--lifecycle`` runs ``chip_smoke.lifecycle_service`` (phase 14)
and ``--trace`` ``chip_smoke.trace_pipeline`` (phase 15) instead; their
largest wait is the one outside the cycles (the capture). A run whose own
checks fail still prints its line (its ``failed`` field says why).

Diagnostics, each optional: ``--profile-first`` takes a 1 s profiler
capture first (``--profile-between``: between two sets of ``--reps``);
``--gc-log`` logs the interpreter's garbage collections and the collection
time inside the 5 longest waits; ``--loop-log`` logs the engine loop's
work segment by segment (the receive at the top of the loop, the burst and
its ``recv_many``, the featurize, the pump with its upload, replay,
capture and readback, each drained batch and its landed-scores query, the
send, the trace finalization) and reports, for the 5 longest waits and
every wait over 12 ms, the milliseconds of each segment inside the wait,
the receives' time past their timeouts, the loop's own Python between
calls, and, for an over-bound wait, each loop iteration's segments;
``--probe`` runs a thread that sleeps 1 ms at a time and times how long
each wake waited for the interpreter lock; a wait of 2 ms or more, or a
wake 3 ms late or more, notes where every thread was (which thread held
the interpreter meanwhile). Each line also carries the host's CPU count,
the process's CPU affinity, the load average and the caching host
allocator's counts before and after, the CPU seconds of this process and
of its waited children (the sender, the relay and the sink) over the run
beside its wall seconds, and the drift and capacity ticks' count and wall
milliseconds. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _capture_first() -> dict:
    import torch

    from detectmateservice_tpu_torch.utils import profiling

    tmp = tempfile.mkdtemp(prefix="dmabp", dir="/tmp")
    try:
        profiling.PROFILER.start(tmp, 1.0, 2, device=torch.device("cuda", 0))
        x = torch.ones(1024, device="cuda")
        while profiling.PROFILER.status()["running"]:
            x = x * 1.0001
        torch.cuda.synchronize()
        profiling.PROFILER.wait(60)
        last = profiling.PROFILER.status()["last"]
        return {k: last.get(k) for k in ("state", "activities", "all_threads", "trace_bytes")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _GcLog:
    """Collections (start, seconds, generation) and coalesced releases
    (time, wait) on the monotonic clock."""

    def __init__(self, detector_cls):
        import gc
        import time

        self.collections, self.waits, self._t0 = [], [], None
        self._gc, self._time = gc, time
        self._cls, self._release = detector_cls, detector_cls._release_coalesced
        log = self

        def release(det, n, reason, now):
            log.waits.append((now, det._coalescer.oldest_age(now)))
            return log._release(det, n, reason, now)

        detector_cls._release_coalesced = release
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        now = self._time.monotonic()
        if phase == "start":
            self._t0 = now
        elif self._t0 is not None:
            self.collections.append((self._t0, now - self._t0, info["generation"]))
            self._t0 = None

    def close(self) -> dict:
        self._gc.callbacks.remove(self._on_gc)
        self._cls._release_coalesced = self._release
        by_gen = {}
        for _, seconds, gen in self.collections:
            n, total, longest = by_gen.get(gen, (0, 0.0, 0.0))
            by_gen[gen] = (n + 1, total + seconds, max(longest, seconds))
        slow = sorted(self.waits, key=lambda w: w[1])[-5:]
        return {"collections": {str(g): {"n": n, "ms": total * 1e3, "longest_ms": longest * 1e3}
                                for g, (n, total, longest) in sorted(by_gen.items())},
                "slowest_waits": [
                    {"wait_ms": wait * 1e3, "gc_inside_ms": 1e3 * sum(
                        min(t + d, now) - max(t, now - wait) for t, d, _ in self.collections
                        if t < now and t + d > now - wait)} for now, wait in slow]}


class _LoopLog:
    """The engine loop thread's work, segment by segment, and the coalesced
    releases, on the monotonic clock. Each logged call records its start,
    end and exclusive time (its own time less that of the logged calls
    inside it): the socket receive at the top of the loop (``recv``), the
    burst collection (``burst``, its receives included), the detector's
    frame featurize (``featurize``), the coalescer pump (``pump``, its
    dispatches included), each drained batch (``drain``), the fan-out
    (``send``), the trace finalization and queued admin calls; the
    processor calls around them (``process_frames``, ``drain_ready``, ...)
    keep the rest of their time."""

    SEGMENTS = ("recv", "burst", "featurize", "pump", "drain", "send")

    def __init__(self, detector_cls):
        import threading
        import time

        from detectmateservice_tpu_torch import core
        from detectmateservice_tpu_torch.engine import engine as engine_mod
        from detectmateservice_tpu_torch.engine import socket as sock_mod
        from detectmateservice_tpu_torch.utils import matchkern

        self.events, self.waits = [], []
        self._undo = []
        self._stack = []
        log, clock = self, time.monotonic

        def patch(owner, name, kind, on_loop=True):
            original = getattr(owner, name, None)
            if original is None:  # a checkout without this seam
                return
            is_module = not isinstance(owner, type)

            def wrapped(*args, **kwargs):
                if on_loop and threading.current_thread().name != "EngineLoop":
                    return original(*args, **kwargs)
                t0 = clock()
                log._stack.append(0.0)
                try:
                    return original(*args, **kwargs)
                finally:
                    t1 = clock()
                    inner = log._stack.pop()
                    if log._stack:
                        log._stack[-1] += t1 - t0
                    obj = None if is_module else args[0]
                    timeout = getattr(obj, "recv_timeout", None) if kind == "recv" else None
                    log.events.append((t0, t1, kind, timeout, (t1 - t0) - inner,
                                       len(log._stack)))

            setattr(owner, name, wrapped)
            self._undo.append((owner, name, original))

        patch(sock_mod.ZmqPairSocket, "recv", "recv")
        patch(sock_mod.ZmqPairSocket, "recv_many", "recv_many")
        patch(engine_mod.Engine, "_collect_burst", "burst")
        patch(engine_mod.Engine, "_send_results", "send")
        patch(engine_mod.Engine, "_finalize_traces", "finalize")
        patch(engine_mod.Engine, "_run_calls", "calls")
        for name in ("process_batch", "_process_frames", "drain_ready", "flush"):
            patch(core.LibraryComponentProcessor, name, name.lstrip("_"))
        patch(matchkern, "featurize_frames", "featurize")
        patch(detector_cls, "_coalesce_pump", "pump")
        patch(detector_cls, "_drain_one", "drain")
        # inside the pump and the drain: the pinned upload, the graph replay
        # (a capture on a bucket's first use apart), the score readback, the
        # landed-scores query
        from detectmateservice_tpu_torch.library.detectors import graphs as graphs_mod
        patch(detector_cls, "_host_tokens", "upload")
        patch(detector_cls, "_readback", "readback")
        patch(detector_cls, "_head_ready", "query")
        patch(graphs_mod.WarmSet, "run", "replay")
        patch(graphs_mod.WarmSet, "capture", "capture")
        release = detector_cls._release_coalesced

        def recording(det, n, reason, now):
            log.waits.append((now, det._coalescer.oldest_age(now)))
            return release(det, n, reason, now)

        detector_cls._release_coalesced = recording
        self._undo.append((detector_cls, "_release_coalesced", release))

    def window(self, a: float, b: float) -> dict:
        """The loop's time in [a, b]: exclusive ms by kind, the receives'
        time past their timeouts, and the time no logged call covered
        (the loop's own Python between calls)."""
        by_kind, covered, overslept, n = {}, 0.0, 0.0, 0
        for t0, t1, kind, timeout, excl, depth in self.events:
            if t1 <= a or t0 >= b:
                continue
            n += 1
            span = min(t1, b) - max(t0, a)
            share = span * (excl / (t1 - t0)) if t1 > t0 else 0.0
            by_kind[kind] = by_kind.get(kind, 0.0) + share * 1e3
            if depth == 0:
                covered += span
            if kind == "recv" and timeout:
                overslept += max(0.0, (t1 - t0) - timeout / 1e3) * 1e3
        return {"segments_ms": {k: round(v, 3) for k, v in sorted(by_kind.items())},
                "recv_overslept_ms": round(overslept, 3),
                "between_ms": round(((b - a) - covered) * 1e3, 3), "events": n}

    def iterations(self, a: float, b: float) -> list:
        """The loop iterations (top-level receive to the next one) that
        overlap [a, b], each as ms per segment kind."""
        tops = sorted(e for e in self.events if e[5] == 0)
        starts = [e[0] for e in tops if e[2] == "recv"]
        out = []
        for i, s in enumerate(starts):
            e = starts[i + 1] if i + 1 < len(starts) else s + 1.0
            if e <= a or s >= b:
                continue
            seg = {}
            for t0, t1, kind, _, excl, _ in self.events:
                if s <= t0 < e:
                    seg[kind] = round(seg.get(kind, 0.0) + excl * 1e3, 3)
            out.append({"start_ms": round((s - a) * 1e3, 3),
                        "ms": round((e - s) * 1e3, 3), "segments_ms": seg})
        return out

    def close(self, bound_s: float = 0.012) -> dict:
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)
        self.events.sort()
        picked = sorted(self.waits, key=lambda w: w[1])[-5:]
        picked += [w for w in self.waits if w[1] > bound_s and w not in picked]
        out = []
        for now, wait in sorted(picked, key=lambda w: w[1]):
            doc = dict(wait_ms=wait * 1e3, end=now, **self.window(now - wait, now))
            if wait > bound_s:
                doc["iterations"] = self.iterations(now - wait, now)
            out.append(doc)
        # the usual wait's segments, for comparison: the median wait's window
        usual = None
        if self.waits:
            now, wait = sorted(self.waits, key=lambda w: w[1])[len(self.waits) // 2]
            usual = dict(wait_ms=wait * 1e3, **self.window(now - wait, now))
        return {"slowest_waits": out, "median_wait": usual}


class _Probe:
    """A thread that, every 1 ms, reads the monotonic clock through a
    foreign call (ctypes releases the interpreter around it) and again in
    Python once it holds the interpreter back: the gap is how long it
    waited for the interpreter lock. It also logs how late its 1 ms sleep
    woke (the timer's lateness plus that lock wait). A lock wait of 2 ms
    or more, or a wake 3 ms late or more, logs where every other thread
    was (``sys._current_frames``: the innermost frame of the package or the
    script, else the innermost); the thread that held the lock shows in
    Python code, the others at their blocking calls."""

    def __init__(self):
        import ctypes
        import threading
        import time

        self.wakes, self.stalls, self._stop = [], [], threading.Event()
        self._time, self._threading = time, threading

        class _Timespec(ctypes.Structure):
            _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]

        libc = ctypes.CDLL(None, use_errno=True)
        self._gettime, self._ts = libc.clock_gettime, _Timespec()
        self._gettime.argtypes = [ctypes.c_int, ctypes.POINTER(_Timespec)]
        self._ts_ref = ctypes.byref(self._ts)
        self._thread = threading.Thread(target=self._run, name="WakeProbe", daemon=True)
        self._thread.start()

    def _where(self) -> dict:
        names = {t.ident: t.name for t in self._threading.enumerate()}
        out = {}
        for ident, frame in sys._current_frames().items():
            if ident == self._thread.ident:
                continue
            pick, f = frame, frame
            while f is not None:
                if "detectmateservice" in f.f_code.co_filename or "chip_smoke" in \
                        f.f_code.co_filename:
                    pick = f
                    break
                f = f.f_back
            inner = (f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno} "
                     f"{frame.f_code.co_name}")
            where = (f"{os.path.basename(pick.f_code.co_filename)}:{pick.f_lineno} "
                     f"{pick.f_code.co_name}")
            out[names.get(ident, str(ident))] = where if pick is frame else f"{where} < {inner}"
        return out

    def _gil_wait(self) -> float:
        """Seconds from a clock read outside the interpreter lock to the
        next read inside it."""
        self._gettime(1, self._ts_ref)  # CLOCK_MONOTONIC, as time.monotonic
        after = self._time.monotonic()
        return max(0.0, after - (self._ts.tv_sec + self._ts.tv_nsec * 1e-9))

    def _run(self) -> None:
        clock, sleep = self._time.monotonic, self._time.sleep
        while not self._stop.is_set():
            t0 = clock()
            sleep(0.001)
            t1 = clock()
            late = t1 - t0 - 0.001
            gil = self._gil_wait()
            self.wakes.append((t1, late, gil))
            if late >= 0.003 or gil >= 0.002:
                self.stalls.append((t1, late, gil, self._where()))

    def close(self, waits, bound_s: float = 0.012) -> dict:
        self._stop.set()
        self._thread.join(5)
        late = sorted(w[1] for w in self.wakes)
        gil = sorted(w[2] for w in self.wakes)
        picked = sorted(waits, key=lambda w: w[1])[-5:]
        picked += [w for w in waits if w[1] > bound_s and w not in picked]
        out = []
        for now, wait in sorted(picked, key=lambda w: w[1]):
            inside = [(lat, g) for t, lat, g in self.wakes if now - wait <= t <= now + 0.002]
            stalls = [{"late_ms": round(lat * 1e3, 2), "gil_ms": round(g * 1e3, 2),
                       "threads": where}
                      for t, lat, g, where in self.stalls if now - wait <= t <= now + 0.002]
            out.append({"wait_ms": wait * 1e3,
                        "probe_latest_ms": max(i[0] for i in inside) * 1e3 if inside else None,
                        "probe_gil_ms": max(i[1] for i in inside) * 1e3 if inside else None,
                        "probe_gil_sum_ms": sum(i[1] for i in inside) * 1e3,
                        "stalls": stalls[:4]})

        def pick(xs, q):
            return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3 if xs else None

        # every stall of the run: where each other thread was
        holders = Counter(f"{name} @ {where}" for _, _, _, threads in self.stalls
                          for name, where in threads.items())
        return {"wakes": len(late), "stalls": len(self.stalls),
                "stall_threads": holders.most_common(16),
                "p50_late_ms": pick(late, 0.5), "p999_late_ms": pick(late, 0.999),
                "max_late_ms": pick(late, 1.0), "p50_gil_ms": pick(gil, 0.5),
                "p99_gil_ms": pick(gil, 0.99), "p999_gil_ms": pick(gil, 0.999),
                "max_gil_ms": pick(gil, 1.0), "slowest_waits": out}


class _TickLog:
    """The drift and capacity monitors' ticks: how many, and their wall
    milliseconds (p50, max), whichever thread runs them."""

    def __init__(self):
        import time

        from detectmateservice_tpu_torch.obs import capacity, drift

        self.ms = {"drift": [], "capacity": []}
        self._undo = []
        for name, cls in (("drift", drift.DriftMonitor), ("capacity", capacity.CapacityMonitor)):
            original = cls.tick

            def wrapped(monitor, *args, _original=original, _name=name, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _original(monitor, *args, **kwargs)
                finally:
                    self.ms[_name].append((time.perf_counter() - t0) * 1e3)

            cls.tick = wrapped
            self._undo.append((cls, original))

    def close(self) -> dict:
        for cls, original in self._undo:
            cls.tick = original
        return {name: {"n": len(xs), "p50_ms": sorted(xs)[len(xs) // 2] if xs else None,
                       "max_ms": max(xs) if xs else None} for name, xs in self.ms.items()}


def _cpu() -> dict:
    """This process's and its waited children's CPU seconds, and the
    monotonic clock."""
    import resource
    import time

    me, kids = resource.getrusage(resource.RUSAGE_SELF), resource.getrusage(
        resource.RUSAGE_CHILDREN)
    return {"self": me.ru_utime + me.ru_stime, "children": kids.ru_utime + kids.ru_stime,
            "wall": time.monotonic()}


def _host() -> dict:
    import threading

    import torch

    return {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "loadavg": list(os.getloadavg()), "torch_threads": torch.get_num_threads(),
            "python_threads": threading.active_count(),
            "process_threads": len(os.listdir("/proc/self/task"))}


def _pinned_stats() -> dict:
    """The caching host allocator's counts (pinned host blocks allocated
    and freed), where this torch has them."""
    import torch

    try:
        stats = torch.cuda.host_memory_stats()
    except (AttributeError, RuntimeError):
        return {}
    return {k: v for k, v in stats.items() if "alloc" in k or "free" in k}


def measure(root: str, reps: int, profile_first: bool, gc_log: bool = False,
            between: bool = False, lifecycle: bool = False, loop_log: bool = False,
            probe: bool = False, trace: bool = False) -> int:
    sys.path.insert(0, root)
    os.chdir(root)
    import io
    from contextlib import redirect_stdout

    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("coalesce_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    _, smi = chip_smoke.phase_card()
    chip_smoke.phase_build()
    captured = _capture_first() if profile_first else None
    for rep in range(2 * reps if between else reps):
        if between and rep == reps:
            captured = _capture_first()
        tmp = tempfile.mkdtemp(prefix="dmab", dir="/tmp")
        failed = None
        out = io.StringIO()
        host0 = _host()
        pinned0 = _pinned_stats()
        log = _GcLog(chip_smoke.TorchScorerDetector) if gc_log else None
        loop = _LoopLog(chip_smoke.TorchScorerDetector) if loop_log else None
        waker = _Probe() if probe else None
        ticks = _TickLog()
        cpu0 = _cpu()
        try:
            with redirect_stdout(out):
                if lifecycle:
                    chip_smoke.lifecycle_service(chip_smoke.Path(tmp), smi, "cuda")
                elif trace:
                    chip_smoke.trace_pipeline(chip_smoke.Path(tmp), smi, None, "cuda")
                else:
                    chip_smoke.coalesce_service(chip_smoke.Path(tmp) / "a", smi, "cuda")
        except AssertionError as exc:
            failed = str(exc)[:300]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        cpu1 = _cpu()
        cpu = {k: round(cpu1[k] - cpu0[k], 3) for k in cpu0}
        tick_doc = ticks.close()
        gc_doc = log.close() if log is not None else None
        waits = list(loop.waits) if loop is not None else []
        if loop is not None:
            gc_doc = dict(gc_doc or {}, loop=loop.close())
        if waker is not None:
            gc_doc = dict(gc_doc or {}, probe=waker.close(waits))
        phase = "lifecycle" if lifecycle else "trace" if trace else "coalesce"
        line = [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith('{"phase": "%s"' % phase)]
        doc = line[-1] if line else {}
        if (lifecycle or trace) and doc:
            waits = doc["release_wait_ms"]
            lone = doc["lone_p50_ms"]
            doc = dict(doc, max_release_wait_ms=waits["outside_max"],
                       mean_release_wait_ms=waits["inside_max"],
                       lone_p50_ms=lone["outside"] if isinstance(lone, dict) else lone)
        print(json.dumps({"root": root, "rep": rep, "card": smi, "failed": failed,
                          "profiled_first": captured, "gc": gc_doc,
                          "host": {"before": host0, "after": _host()},
                          "pinned_allocs": {"before": pinned0, "after": _pinned_stats()},
                          "cpu_s": cpu, "ticks": tick_doc,
                          **{k: doc.get(k) for k in (
                              "max_release_wait_ms", "mean_release_wait_ms",
                              "releases", "socket_lines_per_s", "lone_p50_ms")}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


def main(argv: list) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--profile-first", action="store_true")
    parser.add_argument("--profile-between", action="store_true")
    parser.add_argument("--gc-log", action="store_true")
    parser.add_argument("--lifecycle", action="store_true")
    parser.add_argument("--loop-log", action="store_true")
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--trace", action="store_true")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="*")
    args = parser.parse_args(argv)
    roots = [os.path.abspath(r) for r in (args.roots or [REPO])]
    if args.one:
        return measure(roots[0], args.reps, args.profile_first, args.gc_log,
                       args.profile_between, args.lifecycle, args.loop_log, args.probe,
                       args.trace)
    rc = 0
    extra = ([f"--{name.replace('_', '-')}" for name in (
        "profile_first", "profile_between", "gc_log", "lifecycle", "loop_log", "probe",
        "trace")
        if getattr(args, name)])
    for root in roots:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              "--reps", str(args.reps), *extra, root], check=False,
                             timeout=1200).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
