"""Release waits and socket rate of the scorer example's service, for
versions of the port side by side on one CUDA card.

    python3 scripts/coalesce_ab_torch.py [--reps N] [--profile-first | --profile-between]
                                         [--gc-log] [--loop-log] [--probe]
                                         [--switch-interval-ms MS] [--lifecycle] [ROOT ...]

Each ROOT is a checkout of the repo (default: the repo root), for example a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Each runs in a process of its own, in the order
given (list them as parent, change, change, parent to see the spread): it
builds the fused head and runs ``chip_smoke.coalesce_service`` of that
checkout ``--reps`` times (the example hosted by the port's Service, 65,536
single messages from a sender process, 64 lone messages), and prints one
JSON line per run with the largest and mean release wait, the releases,
the socket lines/s and the lone p50. A run whose own checks fail still
prints its line (its ``failed`` field says why). With ``--profile-first``
each process first takes a 1 s ``utils/profiling.PROFILER`` capture of
CPU and CUDA activity over a loop of small kernels (a checkout that has
the profiler), to see whether a finished capture leaves a cost behind;
with ``--profile-between`` it runs ``--reps`` before the capture and
``--reps`` after it, in the same process.
With ``--gc-log`` each run also logs the interpreter's garbage collections
(``gc.callbacks``) and every coalesced release's wait on the host's
monotonic clock, and reports the collections by generation, the longest
pause, and for the 5 longest waits the collection time inside each wait.
With ``--loop-log`` it logs the engine loop's socket receives (entry,
return, the timeout set) and its processor calls, and reports for the 5
longest waits where the loop's time inside each went: blocked in a
receive past its timeout, inside processor calls, or between calls (the
interpreter lock, the loop's own Python), and the longest wait's events in
order (ms from the oldest row's arrival). ``--probe`` runs a thread that
sleeps 1 ms at a time and logs how late each wake-up came, and reports the
latest wake-up inside each of the 5 longest waits: a late probe says the
whole interpreter (its lock, or the process's CPU time) was held up, an
on-time one that only the engine loop was. ``--switch-interval-ms`` sets
the interpreter's thread switch interval (``sys.setswitchinterval``; 5 ms
by default) in the measuring process. Each line also carries the host's
CPU count, the process's CPU affinity and the load average before and
after. ``--lifecycle`` runs ``chip_smoke.lifecycle_service`` (phase 14)
instead and reports its largest wait outside and inside the cycles.
Imports nothing of JAX.
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
    """The engine loop thread's receives and processor calls, and the
    coalesced releases, on the monotonic clock."""

    def __init__(self, detector_cls):
        import threading
        import time

        from detectmateservice_tpu_torch import core
        from detectmateservice_tpu_torch.engine import socket as sock_mod

        self.events, self.waits = [], []
        self._undo = []
        log, clock = self, time.monotonic

        def patch(cls, name, kind):
            original = getattr(cls, name)

            def wrapped(obj, *args, **kwargs):
                if threading.current_thread().name != "EngineLoop":
                    return original(obj, *args, **kwargs)
                t0 = clock()
                try:
                    return original(obj, *args, **kwargs)
                finally:
                    timeout = getattr(obj, "recv_timeout", None) if kind == "recv" else None
                    log.events.append((t0, clock(), kind, timeout))

            setattr(cls, name, wrapped)
            self._undo.append((cls, name, original))

        patch(sock_mod.ZmqPairSocket, "recv", "recv")
        patch(sock_mod.ZmqPairSocket, "recv_many", "recv_many")
        for name in ("process_batch", "_process_frames", "drain_ready", "flush"):
            patch(core.LibraryComponentProcessor, name, name.lstrip("_"))
        release = detector_cls._release_coalesced

        def recording(det, n, reason, now):
            log.waits.append((now, det._coalescer.oldest_age(now)))
            return release(det, n, reason, now)

        detector_cls._release_coalesced = recording
        self._undo.append((detector_cls, "_release_coalesced", release))

    def close(self) -> dict:
        for cls, name, original in reversed(self._undo):
            setattr(cls, name, original)
        out = []
        for now, wait in sorted(self.waits, key=lambda w: w[1])[-5:]:
            a = now - wait
            inside = [e for e in self.events if e[1] > a and e[0] < now]
            busy = {"recv_overslept_ms": 0.0, "recv_ms": 0.0, "calls_ms": 0.0}
            covered = 0.0
            for t0, t1, kind, timeout in inside:
                span = min(t1, now) - max(t0, a)
                covered += span
                if kind in ("recv", "recv_many"):
                    busy["recv_ms"] += span * 1e3
                    if kind == "recv" and timeout:
                        busy["recv_overslept_ms"] += max(0.0, (t1 - t0) - timeout / 1e3) * 1e3
                else:
                    busy["calls_ms"] += span * 1e3
            out.append(dict(wait_ms=wait * 1e3, between_ms=(wait - covered) * 1e3,
                            events=len(inside), **busy))
        slowest = max(self.waits, key=lambda w: w[1]) if self.waits else None
        timeline = []
        if slowest is not None:
            now, wait = slowest
            a = now - wait
            # the slowest wait's loop events, ms from the oldest row's arrival
            timeline = [[round((t0 - a) * 1e3, 3), round((t1 - a) * 1e3, 3), kind]
                        for t0, t1, kind, _ in self.events if t1 > a and t0 < now][:60]
        return {"slowest_waits": out, "slowest_timeline": timeline}


class _Probe:
    """A thread that sleeps 1 ms at a time, logging (wake-up, lateness);
    a wake-up 3 ms late or more also logs where every other thread was
    (``sys._current_frames``: the innermost frame of the package or the
    script, else the innermost)."""

    def __init__(self):
        import threading
        import time

        self.wakes, self.stalls, self._stop = [], [], threading.Event()
        self._time, self._threading = time, threading
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
            out[names.get(ident, str(ident))] = (
                f"{os.path.basename(pick.f_code.co_filename)}:{pick.f_lineno} "
                f"{pick.f_code.co_name}")
        return out

    def _run(self) -> None:
        clock, sleep = self._time.monotonic, self._time.sleep
        while not self._stop.is_set():
            t0 = clock()
            sleep(0.001)
            t1 = clock()
            late = t1 - t0 - 0.001
            self.wakes.append((t1, late))
            if late >= 0.003:
                self.stalls.append((t1, late, self._where()))

    def close(self, waits) -> dict:
        self._stop.set()
        self._thread.join(5)
        late = sorted(w[1] for w in self.wakes)
        out = []
        for now, wait in sorted(waits, key=lambda w: w[1])[-5:]:
            inside = [lat for t, lat in self.wakes if now - wait <= t <= now + 0.002]
            stalls = [{"late_ms": round(lat * 1e3, 2), "threads": where}
                      for t, lat, where in self.stalls if now - wait <= t <= now + 0.002]
            out.append({"wait_ms": wait * 1e3,
                        "probe_latest_ms": max(inside) * 1e3 if inside else None,
                        "stalls": stalls[:3]})
        pick = (lambda q: late[min(len(late) - 1, int(q * len(late)))] * 1e3) if late else None
        # every late wake-up of the run: where each other thread was
        holders = Counter(f"{name} @ {where}" for _, _, threads in self.stalls
                          for name, where in threads.items())
        return {"wakes": len(late), "stalls": len(self.stalls),
                "stall_threads": holders.most_common(12),
                "p50_late_ms": pick(0.5) if late else None,
                "p999_late_ms": pick(0.999) if late else None,
                "max_late_ms": late[-1] * 1e3 if late else None, "slowest_waits": out}


def _host() -> dict:
    import threading

    import torch

    return {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "loadavg": list(os.getloadavg()), "torch_threads": torch.get_num_threads(),
            "python_threads": threading.active_count(),
            "process_threads": len(os.listdir("/proc/self/task"))}


def measure(root: str, reps: int, profile_first: bool, gc_log: bool = False,
            between: bool = False, lifecycle: bool = False, loop_log: bool = False,
            probe: bool = False, switch_ms: float = 0.0) -> int:
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
    if switch_ms > 0:
        sys.setswitchinterval(switch_ms / 1e3)
    captured = _capture_first() if profile_first else None
    for rep in range(2 * reps if between else reps):
        if between and rep == reps:
            captured = _capture_first()
        tmp = tempfile.mkdtemp(prefix="dmab", dir="/tmp")
        failed = None
        out = io.StringIO()
        host0 = _host()
        log = _GcLog(chip_smoke.TorchScorerDetector) if gc_log else None
        loop = _LoopLog(chip_smoke.TorchScorerDetector) if loop_log else None
        waker = _Probe() if probe else None
        try:
            with redirect_stdout(out):
                if lifecycle:
                    chip_smoke.lifecycle_service(chip_smoke.Path(tmp), smi, "cuda")
                else:
                    chip_smoke.coalesce_service(chip_smoke.Path(tmp) / "a", smi, "cuda")
        except AssertionError as exc:
            failed = str(exc)[:300]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        gc_doc = log.close() if log is not None else None
        waits = list(loop.waits) if loop is not None else []
        if loop is not None:
            gc_doc = dict(gc_doc or {}, loop=loop.close())
        if waker is not None:
            gc_doc = dict(gc_doc or {}, probe=waker.close(waits))
        phase = "lifecycle" if lifecycle else "coalesce"
        line = [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith('{"phase": "%s"' % phase)]
        doc = line[-1] if line else {}
        if lifecycle and doc:
            waits = doc["release_wait_ms"]
            doc = dict(doc, max_release_wait_ms=waits["outside_max"],
                       mean_release_wait_ms=waits["inside_max"],
                       lone_p50_ms=doc["lone_p50_ms"]["outside"])
        print(json.dumps({"root": root, "rep": rep, "card": smi, "failed": failed,
                          "profiled_first": captured, "gc": gc_doc,
                          "switch_interval_ms": sys.getswitchinterval() * 1e3,
                          "host": {"before": host0, "after": _host()},
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
    parser.add_argument("--switch-interval-ms", type=float, default=0.0)
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="*")
    args = parser.parse_args(argv)
    roots = [os.path.abspath(r) for r in (args.roots or [REPO])]
    if args.one:
        return measure(roots[0], args.reps, args.profile_first, args.gc_log,
                       args.profile_between, args.lifecycle, args.loop_log, args.probe,
                       args.switch_interval_ms)
    rc = 0
    extra = ([f"--{name.replace('_', '-')}" for name in (
        "profile_first", "profile_between", "gc_log", "lifecycle", "loop_log", "probe")
        if getattr(args, name)])
    extra += ["--switch-interval-ms", str(args.switch_interval_ms)]
    for root in roots:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              "--reps", str(args.reps), *extra, root], check=False,
                             timeout=1200).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
