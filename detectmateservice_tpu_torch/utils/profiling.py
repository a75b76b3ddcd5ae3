"""On-demand ``torch.profiler`` captures of a running process.

The port's counterpart of the capture half of
``detectmateservice_tpu/utils/profiling.py`` (its compile-cache half has no
counterpart here: the kernels' build cache is ``ops/cuda_build.py``'s).
``POST /admin/profile`` calls :meth:`ProfileManager.start`, under the JAX
contract:

* one capture per process at a time (a second start raises
  ``ProfileBusyError``, HTTP 409; bad parameters ``ProfileError``, 400);
* each capture in its own numbered ``capture-NNNN`` subdirectory of the
  configured directory, pruned to the newest ``max_captures``;
* a ``capture.json`` marker written when the capture ends, on success and
  on error: only marked directories are downloadable, so ``GET
  /admin/profile/latest`` never serves a half-written trace;
* ``status``, ``wait``, ``latest_dir`` and ``zip_latest``.

A capture records with ``torch.profiler.profile`` and writes one Chrome
trace (``trace.json``, ``export_chrome_trace``; the JAX package writes a
TensorBoard xplane instead). It asks for no shapes, stacks or memory, and
records the CPU ops of every thread (the engine loop's too, though another
thread starts the capture) where the installed torch offers that. The
activities follow the device the caller names: a CUDA device records CPU
and CUDA (and a torch without CUDA activity support raises, never a silent
host-only trace), the CPU or no device (a component with no device work)
the host's CPU only.

PyTorch registers its client with Kineto on the thread that imports torch
(the main thread), and Kineto runs that client's init only on the
registering thread: a first start on the ``ProfileCapture`` thread logs
"External init callback must run in same thread as registerClient" and
skips it. ``init_on_this_thread`` starts and stops the profiler once on the
main thread, so that the later captures find Kineto initialized; a Service
whose component computes on CUDA calls it before its engine starts.

Starting or stopping the profiler synchronizes the device, which fails,
and ruins the capture, while another thread captures a CUDA graph. So both
transitions hold the lock of every registered warm set
(``register_capture_lock``; ``library/detectors/graphs.py``: a graph
capture holds that lock). ``PROFILER`` is the one manager of the process.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import tempfile
import threading
import time
import weakref
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

_CAPTURE_PREFIX = "capture-"
_DONE_MARKER = "capture.json"
TRACE_FILE = "trace.json"
MAX_CAPTURE_SECONDS = 300.0


class ProfileError(ValueError):
    """A capture that cannot run (a ValueError, so the admin plane answers
    400)."""


class ProfileBusyError(ProfileError):
    """A capture is already running in this process (HTTP 409)."""


def _activities(device: Optional[torch.device]) -> List[Any]:
    from torch.profiler import ProfilerActivity, supported_activities

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise ProfileError(f"device {device} is a CUDA device, but this torch's "
                               "profiler records no CUDA activity")
        acts.append(ProfilerActivity.CUDA)
    return acts


def _experimental_config():
    """Every thread's CPU ops, and no Python event objects built at stop
    (the trace file is what a capture keeps), as far as this torch offers
    them; None where it offers neither."""
    from torch._C._profiler import _ExperimentalConfig

    for kwargs in ({"profile_all_threads": True, "trace_only": True},
                   {"profile_all_threads": True}):
        try:
            return _ExperimentalConfig(**kwargs), kwargs
        except TypeError:
            continue
    return None, {}


class ProfileManager:
    """Bounded, one-at-a-time ``torch.profiler`` captures (see the module
    docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._current: Optional[Dict[str, Any]] = None
        self._last: Optional[Dict[str, Any]] = None
        self._owners: "weakref.WeakSet" = weakref.WeakSet()

    @staticmethod
    def default_dir() -> str:
        return os.path.join(tempfile.gettempdir(), f"detectmate_profile_{os.getpid()}")

    def register_capture_lock(self, owner) -> None:
        """Hold ``owner.lock`` while a capture starts and stops; kept only
        while ``owner`` lives."""
        self._owners.add(owner)

    @contextlib.contextmanager
    def _captures_quiesced(self) -> Iterator[None]:
        with contextlib.ExitStack() as stack:
            for owner in sorted(list(self._owners), key=id):
                stack.enter_context(owner.lock)
            yield

    def init_on_this_thread(self, device: Optional[torch.device] = None) -> bool:
        """Start and stop the profiler (``device``'s activities) once on the
        calling thread when it is the main thread, the one whose import of
        torch registered PyTorch's client with Kineto; returns whether it
        ran (not on another thread, nor while a capture runs)."""
        if threading.current_thread() is not threading.main_thread():
            return False
        from torch.profiler import profile

        activities = _activities(device)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            prof = profile(activities=activities)
            with self._captures_quiesced():
                prof.start()
                prof.stop()
        return True

    # -- capture ---------------------------------------------------------
    def start(self, base_dir: str, seconds: float, max_captures: int = 4,
              device: Optional[torch.device] = None) -> Dict[str, Any]:
        seconds = float(seconds)
        if not 0.0 < seconds <= MAX_CAPTURE_SECONDS:
            raise ProfileError(f"seconds must be in (0, {MAX_CAPTURE_SECONDS:.0f}], "
                               f"got {seconds}")
        activities = _activities(device)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise ProfileBusyError("a profiler capture is already running "
                                       f"({(self._current or {}).get('dir')})")
            os.makedirs(base_dir, exist_ok=True)
            seq = 1 + max((int(name[len(_CAPTURE_PREFIX):]) for name in os.listdir(base_dir)
                           if name.startswith(_CAPTURE_PREFIX)
                           and name[len(_CAPTURE_PREFIX):].isdigit()), default=0)
            out_dir = os.path.join(base_dir, f"{_CAPTURE_PREFIX}{seq:04d}")
            os.makedirs(out_dir)
            info: Dict[str, Any] = {
                "state": "running",
                "dir": out_dir,
                "seq": seq,
                "seconds": seconds,
                "started_ts": round(time.time(), 6),
                "activities": [str(a).rsplit(".", 1)[-1].lower() for a in activities],
            }
            self._current = info
            self._thread = threading.Thread(
                target=self._run, args=(dict(info), activities, base_dir, max_captures),
                name="ProfileCapture", daemon=True)
            self._thread.start()
            return dict(info)

    def _run(self, info: Dict[str, Any], activities, base_dir: str,
             max_captures: int) -> None:
        from torch.profiler import profile

        config, options = _experimental_config()
        info["all_threads"] = bool(options.get("profile_all_threads"))
        prof = profile(activities=activities, experimental_config=config)
        started = False
        try:
            t0 = time.monotonic()
            with self._captures_quiesced():
                prof.start()
            started = True
            t1 = time.monotonic()
            time.sleep(info["seconds"])
            t2 = time.monotonic()
            with self._captures_quiesced():
                started = False
                prof.stop()
            t3 = time.monotonic()
            path = os.path.join(info["dir"], TRACE_FILE)
            prof.export_chrome_trace(path)
            info["trace_bytes"] = os.path.getsize(path)
            # what the capture cost the process, and where its transitions
            # fell on the host's monotonic clock
            info["transitions_monotonic"] = {"start": [t0, t1], "stop": [t2, t3]}
            info["export_s"] = time.monotonic() - t3
            info["state"] = "done"
        except Exception as exc:  # noqa: BLE001 — a failed capture reports, never dies silently
            info["state"] = "error"
            info["error"] = repr(exc)
            if started:
                try:
                    with self._captures_quiesced():
                        prof.stop()
                except Exception:  # noqa: BLE001 — the capture already failed
                    pass
        info["finished_ts"] = round(time.time(), 6)
        try:
            with open(os.path.join(info["dir"], _DONE_MARKER), "w", encoding="utf-8") as fh:
                json.dump(info, fh)
        except OSError:
            pass
        with self._lock:
            self._last = info
            self._current = None
        self._prune(base_dir, max_captures)

    @staticmethod
    def _prune(base_dir: str, max_captures: int) -> None:
        try:
            captures = sorted(name for name in os.listdir(base_dir)
                              if name.startswith(_CAPTURE_PREFIX))
        except OSError:
            return
        for name in captures[:max(0, len(captures) - max(1, max_captures))]:
            shutil.rmtree(os.path.join(base_dir, name), ignore_errors=True)

    # -- reads -----------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            running = self._thread is not None and self._thread.is_alive()
            return {"running": running,
                    "current": dict(self._current) if self._current else None,
                    "last": dict(self._last) if self._last else None}

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the running capture (if any) ends; True when none is
        left running."""
        with self._lock:
            thread = self._thread
        if thread is None:
            return True
        thread.join(timeout)
        return not thread.is_alive()

    def latest_dir(self, base_dir: str) -> Optional[str]:
        """The newest completed capture directory under ``base_dir``."""
        try:
            captures = sorted((name for name in os.listdir(base_dir)
                               if name.startswith(_CAPTURE_PREFIX)), reverse=True)
        except OSError:
            return None
        for name in captures:
            path = os.path.join(base_dir, name)
            if os.path.exists(os.path.join(path, _DONE_MARKER)):
                return path
        return None

    def zip_latest(self, base_dir: str) -> Optional[Tuple[str, bytes]]:
        """``(archive_name, zip_bytes)`` of the newest completed capture, or
        None when there is none."""
        latest = self.latest_dir(base_dir)
        if latest is None:
            return None
        buffer = io.BytesIO()
        with zipfile.ZipFile(buffer, "w", zipfile.ZIP_DEFLATED) as archive:
            for root, _dirs, files in os.walk(latest):
                for name in files:
                    full = os.path.join(root, name)
                    archive.write(full, os.path.relpath(full, latest))
        return os.path.basename(latest) + ".zip", buffer.getvalue()


# one per process, like the profiler itself
PROFILER = ProfileManager()
