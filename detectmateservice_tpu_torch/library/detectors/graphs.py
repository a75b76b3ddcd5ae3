"""The detector's warm set: one CUDA graph per (kind, bucket).

On a TPU the JAX detector compiles each batch shape ahead of time and keeps
the executables (``_aot_exec`` in ``jax_scorer.py``). On the card there is
no per-shape compile; what a shape costs there is the host's work of
launching its kernels one by one. The port's counterpart of an executable
is a ``torch.cuda.CUDAGraph`` captured per (kind, bucket), where kind is
one of ``KINDS``: ``score`` (raw NLL), ``normscore`` (positional z-scores)
and ``token_nlls`` (the calibration pass of ``score_norm: position``).

An entry holds its graph, a static token input (the narrow wire format of
the detector's uploads, ``[bucket, S]``), the static output, and the
identity of the weights it was captured on (``ident``: the int8 state
object while that path serves, else None). Every capture shares one memory
pool (``torch.cuda.graph_pool_handle``); the detector captures its boot set
largest bucket first, so the smaller graphs reuse the largest one's blocks.
Sharing is safe because every replay runs on the one stream the detector
uses for all its device work, one after another, and because each replay's
input copy, the replay and the copy of its static output happen under the
warm set's lock: two upload workers can never interleave on one bucket's
static buffers.

``run`` replays: it copies the pinned upload into the static input, replays,
and returns a copy of the static output made on the same stream (so the
next replay may overwrite the static output at once). A missing entry, or
one captured on other weights, is captured first, attributed by the capture
ledger (``engine/device_obs.py``) to the context the caller set: the
detector's dispatch path sets ``expected=False``, so after warm-up such a
capture is an unexpected recompile. A capture that fails raises; nothing
carries on eagerly.

Kernel launch counts (``ops/scorehead.py``, ``ops/flash.py``) move in the
wrappers' Python, which a replay does not run: each capture records the
counts its kernels' wrappers added while it was captured, and each replay
adds them back. The capture's own eager warm-up (which builds the lazy
state a capture cannot: cuBLAS handles, module loads) and the capture
itself leave the counts as they were.

On the CPU there is no graph: a "capture" is the eager call on a zero batch
that ``setup_io`` made before graphs, recorded in the ledger the same way,
and ``run`` scores eagerly under the warm set's lock.

Captures run only on a thread that owns the detector's device work: never
while a background fit runs on another thread (``owner_ok``).

A profiler capture (``utils/profiling.py``) synchronizes the device when it
starts and stops, which would break a graph capture running on another
thread: every warm set registers its lock with the process's profiler, which
holds it through both transitions.

**Other threads' device work.** The model lifecycle's threads (the rollout
manager, the drift and capacity monitors, an admin verb) reach the device
through the detector's rollout seams, never through ``Engine.call_in_loop``:
a fine-tune takes seconds, and the engine loop would stop reading for as
long. Instead each seam enqueues its device work on the detector's stream
(the thread's current stream, the one the dispatch path uses) inside the
warm set's ``lock``, one unit at a time: a fine-tune one train step per
acquisition (never across steps, so replays interleave), a shadow or probe
pass one chunk per acquisition, an install its whole in-place copy. Since a
capture holds the same lock and first synchronizes the device, nothing ever
captures while another thread has device work in flight on that stream, and
no replay is queued between two halves of a swap. Training captures
nothing and replays nothing from the warm set. The seams refuse to run
while a background fit runs on another thread (an install waits for it to
end), so a probe or a shadow pass never overlaps a fit.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ...ops import flash, scorehead
from ...utils import profiling

KINDS = ("score", "normscore", "token_nlls")


def _wrappers() -> Tuple[Any, ...]:
    """The counted kernel wrappers, looked up at each use (a caller may
    rebind a module's wrapper)."""
    return (scorehead.candidate_lse, flash.flash_forward, flash.flash_dq, flash.flash_dkv)


def _counts() -> List[Tuple[int, collections.Counter]]:
    return [(fn.launches, collections.Counter(fn.variants)) for fn in _wrappers()]


def _restore(counts: List[Tuple[int, collections.Counter]]) -> None:
    for fn, (launches, variants) in zip(_wrappers(), counts):
        fn.launches = launches
        fn.variants.clear()
        fn.variants.update(variants)


class _Entry:
    __slots__ = ("graph", "static_in", "static_out", "ident", "deltas", "seconds")

    def __init__(self, graph, static_in, static_out, ident, deltas, seconds):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.ident = ident
        # per wrapper: (launches, variants) the capture saw
        self.deltas: List[Tuple[int, collections.Counter]] = deltas
        self.seconds = seconds


class WarmSet:
    """Graphs by (kind, bucket) for one detector on one device.

    ``eager(kind, tokens)`` scores a token tensor on the device the way the
    detector serves now; ``ident(kind)`` names the weights that serve it.
    ``owner_ok()`` says whether the calling thread may capture; ``lock``
    is a lock shared with other warm sets (one is made otherwise)."""

    def __init__(self, device: torch.device, ledger, backend: str,
                 eager: Callable[[str, torch.Tensor], torch.Tensor],
                 ident: Callable[[str], Any],
                 owner_ok: Callable[[], bool] = lambda: True,
                 lock: Optional[threading.RLock] = None) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self._ledger = ledger
        self._backend = backend
        self._eager = eager
        self._ident = ident
        self._owner_ok = owner_ok
        self._entries: Dict[Tuple[str, int], _Entry] = {}
        self._pool = None
        # one lock over captures and replays: every graph shares one pool
        # and one stream, and a replay's static buffers are its own only
        # from its input copy to the copy of its output; other threads'
        # device work enqueues under it too (``lock``). Warm sets that serve
        # one caller together (a mesh's rows) share the caller's lock
        self._lock = lock if lock is not None else threading.RLock()
        # replays by (kind, bucket), the kernel launches they added by
        # wrapper name, and captures made
        self.replays: Dict[Tuple[str, int], int] = collections.Counter()
        self.replay_launches: Dict[str, int] = collections.Counter()
        self.captures = 0
        profiling.PROFILER.register_capture_lock(self)

    @property
    def lock(self) -> threading.RLock:
        """The lock a thread holds while it enqueues device work on the
        detector's stream outside a replay (see the module docstring)."""
        return self._lock

    # -- reads -----------------------------------------------------------
    def keys(self) -> List[Tuple[str, int]]:
        with self._lock:
            return sorted(self._entries)

    def has(self, kind: str, bucket: int) -> bool:
        """A valid entry: present and captured on the weights serving now."""
        with self._lock:
            entry = self._entries.get((kind, bucket))
            return entry is not None and entry.ident is self._ident(kind)

    # -- capture -----------------------------------------------------------
    def capture(self, kind: str, bucket: int, host_tokens: torch.Tensor) -> None:
        """Capture (kind, bucket) on the weights serving now, replacing any
        entry; ``host_tokens`` is a [bucket, S] upload of the wire format
        (its values do not matter). Records one ledger entry with its
        seconds, attributed to the caller's ledger context."""
        if kind not in KINDS:
            raise ValueError(f"unknown warm-set kind {kind!r}")
        if not self._owner_ok():
            raise RuntimeError(
                f"capture of ({kind}, {bucket}) requested from "
                f"{threading.current_thread().name} while a background fit owns "
                "the device; captures run only on the thread that owns dispatch")
        with self._lock:
            self._entries.pop((kind, bucket), None)  # a stale graph never replays
            before = _counts()
            t0 = time.perf_counter()
            try:
                if self.cuda:
                    entry = self._capture_cuda(kind, host_tokens)
                else:
                    self._eager(kind, host_tokens)
                    entry = _Entry(None, None, None, self._ident(kind), [], 0.0)
            finally:
                _restore(before)
            entry.seconds = time.perf_counter() - t0
            self._entries[(kind, bucket)] = entry
            self.captures += 1
        self._ledger.record_compile(entry.seconds, bucket=bucket, backend=self._backend)

    def _capture_cuda(self, kind: str, host_tokens: torch.Tensor) -> _Entry:
        static_in = torch.zeros(tuple(host_tokens.shape), dtype=host_tokens.dtype,
                                device=self.device)
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            # eager warm-up off the capture: lazy library state (cuBLAS
            # handles and workspaces, module loads) is built here
            self._eager(kind, static_in)
        stream.wait_stream(side)
        torch.cuda.synchronize(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        warmed = _counts()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            static_out = self._eager(kind, static_in)
        captured = _counts()
        deltas = [(c[0] - w[0], c[1] - w[1]) for c, w in zip(captured, warmed)]
        return _Entry(graph, static_in, static_out, self._ident(kind), deltas, 0.0)

    # -- replay ------------------------------------------------------------
    def run(self, kind: str, host_tokens: torch.Tensor) -> torch.Tensor:
        """Scores of ``host_tokens`` ([bucket, S], the wire format; pinned
        on CUDA) through the (kind, bucket) graph, captured first if it is
        missing or stale. On the CPU: the eager call, under the same lock."""
        bucket = int(host_tokens.shape[0])
        if not self.has(kind, bucket):
            self.capture(kind, bucket, host_tokens)
        if not self.cuda:
            with self._lock:   # no eager call reads half of a swap
                return self._eager(kind, host_tokens)
        with self._lock:
            entry = self._entries.get((kind, bucket))
            if entry is None or entry.ident is not self._ident(kind):
                # dropped or invalidated between the check and the lock
                raise RuntimeError(f"warm-set entry ({kind}, {bucket}) went away")
            # the pinned upload stays alive until this copy completes: the
            # caching host allocator records the copy's stream event
            entry.static_in.copy_(host_tokens, non_blocking=True)
            entry.graph.replay()
            out = entry.static_out.clone()
            for fn, (launches, variants) in zip(_wrappers(), entry.deltas):
                if launches:
                    fn.launches += launches
                    fn.variants.update(variants)
                    self.replay_launches[fn.__name__] += launches
            self.replays[(kind, bucket)] += 1
        return out

    # -- drops ---------------------------------------------------------------
    def drop(self, bucket: int) -> None:
        """Drop every entry of ``bucket`` (retirement); its pool blocks
        return to the shared pool."""
        with self._lock:
            for key in [k for k in self._entries if k[1] == bucket]:
                del self._entries[key]

    def stale(self) -> List[Tuple[str, int]]:
        """Entries captured on weights that no longer serve."""
        with self._lock:
            return sorted(k for k, e in self._entries.items()
                          if e.ident is not self._ident(k[0]))
