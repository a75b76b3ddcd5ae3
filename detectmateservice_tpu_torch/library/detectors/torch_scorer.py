"""TorchScorerDetector: GPU-batched neural anomaly scoring.

Counterpart of ``detectmateservice_tpu/library/detectors/jax_scorer.py``
(``JaxScorerDetector``) on PyTorch and CUDA, for the ``mlp``, ``gru`` and
``logbert`` scorers. The same CoreDetector contract (train-then-detect,
alert-or-None per message) and the same phases:

1. **train** — the first ``data_use_training`` messages are tokenized and
   buffered (filtered from the output),
2. **fit** — at the phase boundary the scorer trains for ``train_epochs``
   (at least ``min_train_steps`` steps) over the buffer on the device, then
   calibrates the alert threshold as ``mean + threshold_sigma * std`` of
   the training scores (or of the positional z-scores, ``score_norm:
   position``),
3. **detect** — batches are featurized on the host, padded to a power-of-two
   bucket, scored on the device, and read back asynchronously: up to
   ``pipeline_depth`` batches stay in flight, each with a CUDA event that
   says when its scores have landed in pinned host memory; scores above
   the threshold become DetectorSchema alerts, in input order.

``head_impl: pallas`` scores through the hand-written CUDA kernel of
``ops/scorehead.py``, and ``model: logbert`` with ``attn_impl: flash`` (or
``auto`` at ``seq_len >= FLASH_MIN_SEQ`` on CUDA) attends through the
hand-written CUDA kernels of ``ops/flash.py``, in scoring and in the fit
(the names are the JAX package's, so one config drives both packages).
Batches of at most ``host_score_max_batch`` rows score on a CPU copy of the
module through the einsum head, as the JAX detector's host twin does; a
logbert whose attention can take the flash kernels has no such copy.

``dtype: int8w`` serves weight-only int8 (``models/quant.py``) as the JAX
detector does: activations in bf16 on CUDA and fp32 on the CPU; at the end
of each fit the weights are quantized, the calibration split's first 512
rows (the parity corpus) are scored through the float and the quantized
path, and the quantized path serves only if no alert decision flips
(``_int8_report`` says what the gate found). The device keeps only the
int8 payloads, their fp32 scales and the passthrough leaves; every scoring
call dequantizes them into the compute dtype and runs the scorer on them
through ``torch.func.functional_call`` over a skeleton of the model on the
meta device, so no second float model is resident. ``save_checkpoint`` and
``load_checkpoint`` persist the float weights, the optimizer state and the
calibration (``utils/checkpoint.py``); a restore re-quantizes ungated.

Featurization runs in C (``utils/matchkern.py`` over ``native/dmfeat.c``,
the port's copy of the JAX package's featurizer) with ``native_featurize:
true``, the default: the protobuf wire parse, tokenize and hash of a whole
batch in one GIL-free call over a row-parallel pool (``featurize_threads``
sets its width), and only the rows the C side refuses (more than 64
header-map entries, for one) are retried in Python, which gives the same
rows. ``setup_io`` builds the library with the host compiler; a failed build
raises ``LibraryError`` there, where the JAX detector falls back to Python
in silence. ``native_featurize: false`` featurizes every row in Python.
``featurize_rows`` counts the rows each path featurized (under a Service
also ``featurize_native_rows_total`` / ``featurize_fallback_rows_total``).
Each device batch carries the flight recorder's last completed trace id
(``_current_trace_id``, read through the health monitor) into its
capture-ledger span and as the exemplar of its queue-wait sample.
``process_frames`` takes packed wire frames (``engine/framing.py``) as the
JAX detector's does: in the fitted steady state one native call expands and
featurizes the whole burst, and raw bytes are sliced only for the alerts.

**The warm set.** On a CUDA device every device batch is a replay of a
CUDA graph captured per (kind, bucket) (``graphs.py``), the counterpart of
the JAX detector's ahead-of-time executables: ``setup_io`` captures the JAX
warm set (``(*small, train_batch_size, max_batch)``, and ``token_nlls`` at
the train bucket for ``score_norm: position``), largest bucket first, under
the ``scorer_warmup_pending`` check, then marks the capture ledger's warm-up
complete (``engine/device_obs.py``). A bucket outside the set is captured as
an expected warm-up before its first batch (``where="bucket_warm"``). Swaps
that replace tensors re-capture what they invalidate as expected captures
(the int8 cut-over, ``"int8_activate"``; a restore, ``"restore"``); swaps
whose shapes agree copy into the captured storage (the position-norm
statistics live in static buffers, and ``load_state_dict`` and the
optimizer write the weights in place). After warm-up a dispatch that finds
no valid graph for its bucket captures in an ``expected=False`` context:
an unexpected recompile, counted, emitted and flagged. On the CPU a
"capture" is the eager call, recorded the same way.

**Adaptive batching** (``batch_deadline_ms > 0``): a coalescer
(``_BatchCoalescer``) holds detect rows across ``process_batch`` /
``process_frames`` calls and releases them toward the largest active warm
bucket: ``full`` once the held rows reach ``batch_target_occupancy`` of it,
``deadline`` once the oldest row has waited 0.75 × the deadline (one drain
tick early), ``flush`` on an idle drain, at teardown, or when the deadline
is turned off at runtime. A release buckets against the active warm set:
its natural power-of-two bucket (warmed on first use), or, where that
bucket was retired for underuse (``bucket_retire_interval_s``,
``bucket_retire_min_dispatches``; its graph is dropped), the next active
bucket up, until persistent pressure resurrects it with one expected
capture. Tenants the engine names (``note_tenant``) are served by deficit
round-robin. ``upload_workers > 0`` moves the upload and the replay onto
worker threads (``scorer_dispatch`` heartbeat); the output order is the
in-flight queue's, and a batch whose dispatch failed is counted as
processing errors for its rows and emits nothing.

The engine contract of the JAX detector: ``pending_count()`` (batches in
flight, plus one while the coalescer holds rows), ``drain_poll_ms`` (the
short-poll tick while rows are held; the port adds ``drain_due_in_ms``, when
the held rows fall due, which ends a tick early), ``drained_total()`` (batches drained,
the progress counter the health watchdog pairs with it), and, once a
Service has handed the detector its metric factories (``metrics``),
``detector_device_lines_total`` / ``detector_device_batches_total`` per
scored call, the occupancy, queue-wait and device-seconds histograms per
batch, ``detector_coalesce_depth`` and ``detector_deadline_releases_total``.
The counters are plain Python integers: the watchdog and the admin plane
read them from their own threads and touch no CUDA state.

**The model lifecycle** (``rollout/``, ``obs/``): the seams the Service's
rollout manager and drift and capacity monitors drive, the JAX detector's
names and results. While a sampler is attached (``set_rollout_sampler``)
each in-flight slot keeps its token rows and the drain offers them paired
with their scores; ``set_capacity_tap`` gets ``(rows, device_seconds)`` of
every observed batch. ``rollout_fine_tune`` trains a clone of the live
module and optimizer state (the live weights stay bit-equal);
``rollout_scores`` scores the live weights through the warm set (``None``)
or a candidate state dict op by op, both at the train bucket;
``install_candidate`` copies a candidate into the live weights' storage in
place, so every captured graph stays valid (a float swap captures nothing;
under ``int8w`` the gate is judged again and the warm set re-captured).
These run on the caller's thread and enqueue under the warm set's lock
(``graphs.py``); a failure raises, and nothing retries on the CPU.

**Mesh mode** (``mesh_shape``, the JAX detector's multi-chip mode): one
process drives every device of a mesh (``parallel/``). The scorer is a
``parallel.ShardedScorer``: batches split over the ``data`` axis, a
logbert's weights over ``model`` per ``LOGBERT_RULES`` (each data row runs
its model shards: column- and row-parallel matmuls, each shard's heads
through the path's attention kernel, kernel 1 once per row on the joined
E), and ``attn_impl: ring`` runs its attention as a ring over the ``seq``
axis. The warm set is
one CUDA-graph warm set per data row behind ``MeshWarmSet``; the fit trains
every row and sums the gradients over them. As in the JAX detector, mesh
mode has no host copy, labels its device ``mesh(data=8)`` and its capture
ledger entries ``backend: mesh``, and refuses in-process fine-tuning and
shadow scoring of explicit weights (a rollout installs externally trained
checkpoints). The mesh takes every local device (``parallel/mesh.py``
``local_devices``); a mesh that needs more raises ``ValueError`` at
``setup_io``.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import math
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...engine import device_obs
from ...engine.framing import FramingError, unpack_batch
from ...models import quant
from ...models.base import ScorerBase
from ...models.gru import GRUScorer, GRUScorerConfig
from ...models.logbert import LogBERTConfig, LogBERTScorer
from ...models.mlp import MLPScorer, MLPScorerConfig
from ...models.tokenizer import PAD_ID, HashTokenizer, narrow_tokens
from ...ops import flash, scorehead
from ...ops.attention import FLASH_MIN_SEQ
from ...schemas import DetectorSchema, ParserSchema, SchemaError
from ...utils import matchkern
from ...utils.checkpoint import (COMPATIBLE_TREE_VERSIONS, MODEL_TREE_VERSIONS,
                                 load_scorer_state, save_scorer_state)
from ...utils.device import resolve_device
from ..common.core import LibraryError
from ..common.detector import BufferMode, CoreDetector, CoreDetectorConfig
from .graphs import WarmSet

logger = logging.getLogger(__name__)

_DTYPES = {"auto": torch.bfloat16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass
class TorchScorerDetectorConfig(CoreDetectorConfig):
    """Field for field ``JaxScorerDetectorConfig``, with its defaults."""

    method_type: str = "torch_scorer"
    model: str = "mlp"                # "mlp" | "gru" | "logbert"
    vocab_size: int = 32768
    seq_len: int = 32
    dim: int = 128
    depth: int = 2                    # logbert/gru layers
    heads: int = 4                    # logbert only
    score_topk: int = 0               # logbert/gru: 0=mean NLL, k>0=top-k mean
    score_vocab: int = 0              # logbert/gru candidate-vocab scoring
    attn_impl: str = "auto"           # logbert attention path
    # scoring head: "auto"/"einsum" = weight-tied logits + log_softmax;
    # "pallas" = the fused logsumexp head (CUDA kernel, ops/scorehead.py)
    head_impl: str = "auto"
    data_use_training: int = 256
    train_epochs: int = 3
    min_train_steps: int = 100
    train_batch_size: int = 32
    threshold_sigma: float = 4.0
    score_threshold: Optional[float] = None  # explicit override wins
    # "none": score = sequence NLL; "position": max over positions of
    # (NLL - mu_pos)/sigma_pos, mu/sigma calibrated on training traffic
    score_norm: str = "none"
    # run the train→detect boundary fit in a background thread so the
    # caller keeps feeding input during training (batched path only)
    async_fit: bool = True
    max_batch: int = 1024
    # scored batches that may be in flight before results are forced back
    pipeline_depth: int = 8
    # adaptive batching: hold rows across calls for at most this budget
    # (0 = dispatch every call at once)
    batch_deadline_ms: float = 0.0
    batch_target_occupancy: float = 0.9
    bucket_retire_interval_s: float = 0.0  # 0 = never retire a warm bucket
    bucket_retire_min_dispatches: int = 2
    upload_workers: int = 0               # threads for upload + replay; 0 = inline
    native_featurize: bool = True         # featurize in C (utils/matchkern.py)
    featurize_threads: int = 0            # native pool width; 0 = auto
    # batches of at most this many rows score on the CPU copy of the module
    host_score_max_batch: int = 128
    device: Optional[str] = None          # None = "cuda:0"; "cuda:N" | "cpu"
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 8}: mesh mode
    dtype: str = "auto"                   # "auto" = bfloat16; "int8w" = int8 weights
    seed: int = 0


def _bucket(n: int, max_batch: int) -> int:
    """Round a ragged batch size up to a power of two (≤ max_batch)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def _padded_chunks(tokens: np.ndarray, bucket: int):
    """Yield (start, [bucket, S] chunk zero-padded at the end, real rows)."""
    for start in range(0, len(tokens), bucket):
        chunk = tokens[start:start + bucket]
        real = len(chunk)
        if real < bucket:
            chunk = np.concatenate(
                [chunk, np.zeros((bucket - real,) + chunk.shape[1:], chunk.dtype)])
        yield start, chunk, real


class _InflightSlot:
    """One scored (or still-scoring) batch in the in-flight queue.

    ``scores`` is a host numpy array (host path, CPU device) or a pinned CPU
    tensor that a CUDA copy is filling; ``event`` (None off the GPU)
    completes with that copy. ``done`` is set once ``scores`` or ``error``
    is filled: inline dispatch fills the slot before it joins the queue, an
    upload worker after, and the slot joins ``_inflight`` at dispatch time
    either way, so the output order is the dispatch order.

    ``bucket`` is the padded row count; ``t_enqueue`` the dispatch call's
    time (for a coalesced release the oldest held row's arrival, so the
    queue wait includes the hold), ``t_start`` when scoring began (worker
    pickup), ``trace_id`` the flight recorder's last completed trace at
    dispatch (the link from a device batch to a pipeline trace), and
    ``release`` why the coalescer let the batch go (full/deadline/flush;
    None uncoalesced). ``tokens`` keeps the batch's token rows only while a
    rollout sampler is attached (the drain offers them with their
    scores)."""

    __slots__ = ("scores", "event", "raws", "real", "path", "bucket", "error", "done",
                 "t_enqueue", "t_start", "trace_id", "release", "tokens")

    def __init__(self, raws, real: int, path: str, bucket: int,
                 trace_id: Optional[str] = None, release: Optional[str] = None,
                 tokens: Optional[np.ndarray] = None):
        self.scores: Any = None
        self.event: Optional[torch.cuda.Event] = None
        self.raws = raws
        self.real = real
        self.path = path
        self.bucket = bucket
        self.error: Optional[Exception] = None
        self.done = threading.Event()
        self.t_enqueue = time.monotonic()
        self.t_start: Optional[float] = None
        self.trace_id = trace_id
        self.release = release
        self.tokens = tokens


class _ChainRaws:
    """Lazy concatenation of per-segment raw-message sequences (lists or
    native ``SpanRaws``): a coalesced release merges rows of several calls
    into one dispatch without materializing a bytes object per row; only
    the anomalous rows are sliced out, at alert construction."""

    __slots__ = ("_segs", "_len")

    def __init__(self, segs):
        self._segs = segs
        self._len = sum(len(s) for s in segs)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i):
        if isinstance(i, slice):
            # the dispatch path's chunking slices (contiguous): stay lazy
            start, stop, step = i.indices(self._len)
            if step != 1:
                return [self[j] for j in range(start, stop, step)]
            out, pos = [], 0
            for seg in self._segs:
                n = len(seg)
                lo, hi = max(start - pos, 0), min(stop - pos, n)
                if lo < hi:
                    out.append(seg[lo:hi])
                pos += n
                if pos >= stop:
                    break
            return _ChainRaws(out)
        if i < 0:
            i += self._len
        for seg in self._segs:
            if i < len(seg):
                return seg[i]
            i -= len(seg)
        raise IndexError("row index out of range")


class _BatchCoalescer:
    """Deadline-aware row accumulator between the engine and the device.

    Host bookkeeping with one owner (the engine thread, like the rest of the
    dispatch path; no lock). Rows arrive as (tokens, raws) segments stamped
    with their arrival time and the ingress frame's tenant; ``take`` pops
    ``n`` rows, and a split segment's remainder keeps its arrival stamp (the
    deadline is per row, not per call). With one tenant (the anonymous
    ``None``) releases are FIFO; with several, deficit round-robin across
    the per-tenant queues (equal quanta), FIFO within each tenant. The
    release policy (target occupancy, warm-bucket choice, retirement) lives
    in the detector, which owns the warm set and the capture ledger."""

    __slots__ = ("deadline_s", "target_occupancy", "releases", "rows_in",
                 "max_wait_s", "wait_sum_s", "wait_n", "retired_total",
                 "_q", "_rr", "_deficit", "_total")

    def __init__(self, deadline_s: float, target_occupancy: float) -> None:
        self.deadline_s = deadline_s
        self.target_occupancy = target_occupancy
        self.releases = {"full": 0, "deadline": 0, "flush": 0}
        self.rows_in = 0
        self.max_wait_s = 0.0
        self.wait_sum_s = 0.0
        self.wait_n = 0
        self.retired_total = 0
        # tenant -> deque of (t_arrival, tokens [k, S], raws); emptied
        # queues are pruned, so the table holds active tenants only
        self._q: Dict[Optional[str], deque] = {}
        self._rr: deque = deque()                    # rotation over _q's keys
        self._deficit: Dict[Optional[str], int] = {}  # carried DRR deficit (rows)
        self._total = 0

    def __len__(self) -> int:
        return self._total

    def add(self, tokens: np.ndarray, raws, now: float,
            tenant: Optional[str] = None) -> None:
        if not len(tokens):
            return
        q = self._q.get(tenant)
        if q is None:
            q = self._q[tenant] = deque()
            self._rr.append(tenant)
        q.append((now, tokens, raws))
        self._total += len(tokens)
        self.rows_in += len(tokens)

    def oldest_age(self, now: float) -> float:
        heads = [q[0][0] for q in self._q.values() if q]
        return 0.0 if not heads else max(0.0, now - min(heads))

    def due_in_s(self, now: float) -> Optional[float]:
        """Seconds until the held rows fall due (0 once they are), None when
        none is held: the oldest row falls due at 0.75 of the deadline, one
        drain tick (deadline/4) early, so its wait lands at about the
        budget, not a tick past it."""
        if not self._total:
            return None
        return max(0.0, self.deadline_s * 0.75 - self.oldest_age(now))

    def due(self, now: float) -> bool:
        """True once the held rows fall due (``due_in_s``)."""
        return self.due_in_s(now) == 0.0

    def held_by_tenant(self) -> Dict[str, int]:
        """Held rows per tenant (the anonymous tenant as ``"default"``)."""
        return {(t if t is not None else "default"): sum(len(seg[1]) for seg in q)
                for t, q in self._q.items()}

    def take(self, n: int):
        """Pop ``n`` rows → (tokens [n, S], raws, t_oldest). The round starts
        at the tenant holding the oldest row, so a deadline release carries
        the row that tripped it; each visited tenant serves up to its
        quantum plus carried deficit before the rotation moves on, and an
        emptied queue forfeits its deficit and leaves the rotation."""
        quantum = max(1, n // max(1, len(self._rr)))
        oldest_key = min(self._q, key=lambda k: self._q[k][0][0])
        while self._rr[0] != oldest_key:
            self._rr.rotate(-1)
        parts, raw_segs, got = [], [], 0
        t_oldest = None
        while got < n:
            key = self._rr[0]
            q = self._q[key]
            deficit = self._deficit.get(key, 0) + quantum
            take_rows = min(deficit, n - got)
            served = 0
            while q and served < take_rows:
                t, tok, raws = q.popleft()
                if t_oldest is None or t < t_oldest:
                    t_oldest = t
                want = take_rows - served
                if want < len(tok):
                    parts.append(tok[:want])
                    raw_segs.append(raws[:want])
                    # the remainder keeps its arrival stamp
                    q.appendleft((t, tok[want:], raws[want:]))
                    served += want
                else:
                    parts.append(tok)
                    raw_segs.append(raws)
                    served += len(tok)
            got += served
            if q:
                self._deficit[key] = deficit - served
                self._rr.rotate(-1)
            else:
                self._rr.popleft()
                self._deficit.pop(key, None)
                del self._q[key]
        self._total -= n
        tokens = parts[0] if len(parts) == 1 else np.concatenate(parts)
        raws = raw_segs[0] if len(raw_segs) == 1 else _ChainRaws(raw_segs)
        return tokens, raws, t_oldest

    def note_release(self, reason: str, wait_s: float) -> None:
        self.releases[reason] = self.releases.get(reason, 0) + 1
        self.max_wait_s = max(self.max_wait_s, wait_s)
        self.wait_sum_s += max(0.0, wait_s)
        self.wait_n += 1


class _ServingModule(torch.nn.Module):
    """The int8 serving path: ``forward`` scores through ``scorer`` on
    ``model``, a skeleton of the scorer's module on the meta device (no
    storage of its own); ``torch.func.functional_call`` supplies every leaf
    (keys ``model.<state_dict key>``) for the duration of one call."""

    def __init__(self, scorer: ScorerBase):
        super().__init__()
        self.scorer = scorer
        self.model = scorer.meta_model()

    def forward(self, tokens: torch.Tensor,
                norm: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        if norm is not None:
            return self.scorer.normscore(self.model, tokens, *norm)
        return self.scorer.score(self.model, tokens)


class TorchScorerDetector(CoreDetector):
    config_class = TorchScorerDetectorConfig
    description = "TorchScorerDetector flags log lines the GPU scorer finds improbable."

    def __init__(self, name: Optional[str] = None, config: Any = None,
                 buffer_mode: BufferMode = BufferMode.MICRO_BATCH) -> None:
        super().__init__(name=name or "TorchScorerDetector", buffer_mode=buffer_mode,
                         config=config)
        self.config: TorchScorerDetectorConfig
        self._validate_static_config()
        self._tokenizer = HashTokenizer(vocab_size=self.config.vocab_size,
                                        seq_len=self.config.seq_len)
        self._scorer: Optional[ScorerBase] = None
        self._model: Optional[torch.nn.Module] = None
        self._optimizer: Optional[torch.optim.Optimizer] = None
        self._device: Optional[torch.device] = None
        # mesh mode: the sharded scorer (it owns the weights, the optimizer
        # and the warm set) and the device label its metrics carry
        self._sharded = None
        self._device_label: Optional[str] = None
        # seeds one generator per train step (the JAX detector splits
        # its PRNG key per step)
        self._step_seeds: Optional[torch.Generator] = None
        self._threshold: Optional[float] = self.config.score_threshold
        # (mean, std) of the calibration scores: a runtime threshold_sigma
        # change recomputes the threshold without a refit
        self._calib_stats: Optional[Tuple[float, float]] = None
        self._train_buffer: List[np.ndarray] = []
        self._fitted = False
        self._norm_mu: Optional[np.ndarray] = None     # [S] fp32, "position" norm
        self._norm_sigma: Optional[np.ndarray] = None
        # the position-norm statistics on the device, when set: the static
        # buffers (_norm_bufs) the normscore graphs were captured on, so a
        # new calibration is a copy into them, never a new tensor
        self._norm_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._norm_bufs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._fit_thread: Optional[threading.Thread] = None
        # guards the join-and-dispatch handoff in _finish_fit: the engine
        # thread and external callers may race it
        self._fit_lock = threading.Lock()
        self._pending: List[Tuple[np.ndarray, bytes]] = []  # backlog during fit
        # CPU copy for small batches (einsum head), synced after each fit
        self._host_scorer: Optional[ScorerBase] = None
        self._host_model: Optional[torch.nn.Module] = None
        self._host_norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._inflight: deque = deque()
        # scored batches by path ("device" / "host"), for callers that check
        # which path a stream took
        self.path_counts: Dict[str, int] = {"device": 0, "host": 0}
        # rows featurized in C and rows featurized in Python (the retries of
        # rows the C side refused, or every row with native_featurize off)
        self.featurize_rows: Dict[str, int] = {"native": 0, "fallback": 0}
        self._feat_counters: Optional[Tuple[Any, Any]] = None
        self._native_ready = False
        # weight-only int8 serving (dtype: int8w): the quantized state on the
        # device, live only after the parity gate passed, and the meta-device
        # skeleton each call runs the scorer on
        self._int8w = self.config.dtype == "int8w"
        self._qstate: Optional[Dict[str, quant.QuantLeaf]] = None
        self._serving: Optional[_ServingModule] = None
        self._serve_lock = threading.Lock()
        self._parity_corpus: Optional[np.ndarray] = None
        self._int8_report: Optional[Dict[str, Any]] = None
        # engine contract: drained batches, and the metric children the
        # hosting Service's factories give (built at first use)
        self._drained_total = 0
        self._device_children: Optional[Tuple[Any, Any]] = None
        self._batch_children: Dict[str, Tuple[Any, ...]] = {}
        # the capture ledger and the warm set of graphs (set in
        # _ensure_scorer); _device_warm is the set of warm buckets the
        # coalescer picks from, each entered through an expected capture
        self._ledger: device_obs.CompileLedger = device_obs.get_ledger()
        self._obs_backend = "unknown"
        self._warm: Optional[WarmSet] = None
        self._device_warm: set = set()
        # adaptive batching, owned by the engine thread like _inflight
        self._coalescer: Optional[_BatchCoalescer] = None
        self._ingress_tenant: Optional[str] = None
        self._retired_buckets: set = set()
        self._retired_hits: Dict[int, int] = {}       # pad-ups per retired bucket
        self._bucket_usage: Dict[int, int] = {}       # dispatches since the sweep
        self._retire_last_sweep: Optional[float] = None
        self._drop_pending: set = set()               # retired, graph still held
        self._coalesce_gauge = None
        self._release_children: Dict[str, Any] = {}
        self._occ_stats = (0, 0.0)                    # (dispatches, occupancy sum)
        # upload workers (upload_workers > 0) and their heartbeat
        self._upload_queue: Optional[queue.Queue] = None
        self._upload_threads: List[threading.Thread] = []
        self._dispatch_hb = None
        # the model lifecycle: the rollout manager's traffic sampler (the
        # drain offers each batch's rows with their scores), the capacity
        # monitor's per-batch tap, the installed checkpoint version (0 = the
        # boot-time fit), and the meta-device skeleton candidates score on
        self._rollout_sampler = None
        self._capacity_tap = None
        self._model_version = 0
        self._candidate: Optional[_ServingModule] = None

    def _validate_static_config(self) -> None:
        """Reject bad or not-yet-ported config at construction."""
        cfg = self.config
        if cfg.score_norm not in ("none", "position"):
            raise LibraryError(
                f"unknown score_norm {cfg.score_norm!r}; expected 'none' or 'position'")
        if cfg.attn_impl not in ("auto", "einsum", "flash", "blockwise", "ring"):
            raise LibraryError(
                f"unknown attn_impl {cfg.attn_impl!r}; expected 'auto', "
                "'einsum', 'flash', 'blockwise', or 'ring'")
        if cfg.model not in ("mlp", "gru", "logbert"):
            raise LibraryError(f"unknown scorer model {cfg.model!r}")
        if cfg.dtype not in ("auto", "bfloat16", "float32", "float16", "int8w"):
            raise LibraryError(
                f"unknown dtype {cfg.dtype!r}; expected 'auto', 'bfloat16', "
                "'float32', 'float16', or 'int8w'")
        if cfg.head_impl not in ("auto", "einsum", "pallas"):
            raise LibraryError(
                f"unknown head_impl {cfg.head_impl!r}; expected 'auto', "
                "'einsum', or 'pallas'")
        if cfg.batch_deadline_ms < 0:
            raise LibraryError(
                f"batch_deadline_ms must be >= 0 (got {cfg.batch_deadline_ms})")
        if not 0.0 < cfg.batch_target_occupancy <= 1.0:
            raise LibraryError(
                "batch_target_occupancy must be in (0, 1] "
                f"(got {cfg.batch_target_occupancy})")
        if cfg.bucket_retire_interval_s < 0:
            raise LibraryError(
                "bucket_retire_interval_s must be >= 0 "
                f"(got {cfg.bucket_retire_interval_s})")

    # -- lifecycle ------------------------------------------------------
    def setup_io(self) -> None:
        """Build the native featurizer (``native_featurize``), resolve the
        device, build the model with params initialized on it and the CUDA
        kernels the configured path runs, then capture the warm set: one
        graph per bucket the JAX detector compiles at boot, largest first.

        Under a Service the ``scorer_warmup_pending`` check is registered
        first (deep health is UNHEALTHY until the kernels are built and the
        set is captured). The warm-up phases go to ``scorer_warmup_seconds``:
        ``device_put`` (model build and weights on the device),
        ``cache_load`` (kernel libraries loaded ready-built) and ``aot``
        (the captures)."""
        t0 = time.monotonic()
        ledger = self._ledger
        monitor = ledger.monitor
        if monitor is not None:
            # before the kernel builds and the first capture
            monitor.remove_check(device_obs.WarmupPendingCheck.name)
            monitor.add_check(device_obs.WarmupPendingCheck(ledger, monitor))
        cache0 = ledger.cache_load_seconds()
        if self.config.native_featurize:
            self._native()
        self._ensure_scorer()
        t_warm = time.monotonic()
        cache_load = max(0.0, ledger.cache_load_seconds() - cache0)
        ledger.record_warmup_phase("device_put", max(0.0, t_warm - t0 - cache_load))
        ledger.record_warmup_phase("cache_load", cache_load)
        cfg = self.config
        small = () if self._host_scorer is not None else (1, 8)
        buckets = {_bucket(b, cfg.max_batch)
                   for b in (*small, cfg.train_batch_size, cfg.max_batch)}
        kind = "normscore" if cfg.score_norm == "position" else "score"
        with ledger.context(where="warmup", backend=self._obs_backend, expected=True):
            for bucket in sorted(buckets, reverse=True):   # one pool, largest first
                self._device_warm.add(bucket)
                with ledger.context(bucket=bucket):
                    self._warm.capture(kind, bucket, self._zero_upload(bucket))
            if cfg.score_norm == "position" and self._norm_mu is None:
                # the fit's calibration pass runs token_nlls at the train bucket
                bucket = _bucket(cfg.train_batch_size, cfg.max_batch)
                with ledger.context(bucket=bucket):
                    self._warm.capture("token_nlls", bucket, self._zero_upload(bucket))
        ledger.mark_warmup_complete()
        ledger.record_warmup_phase("aot", time.monotonic() - t_warm)

    def warm_set_spec(self) -> Dict[str, Any]:
        """The warm bucket set as a persistable spec, key for key the JAX
        detector's."""
        return {"buckets": sorted(int(b) for b in self._device_warm),
                "seq_len": int(self.config.seq_len),
                "dtype": str(self.config.dtype),
                "score_norm": str(self.config.score_norm)}

    def _ensure_scorer(self) -> None:
        if self._scorer is not None:
            return
        cfg = self.config
        self._validate_static_config()
        device = resolve_device(cfg.device)
        mesh = None
        if cfg.mesh_shape:
            from ...parallel.mesh import make_mesh

            mesh = make_mesh(dict(cfg.mesh_shape), device_type=device.type)
            device = mesh.lead
        self._obs_backend = "mesh" if mesh is not None else device.type
        # GET /admin/xla reports the live warm / retired sets beside the
        # captures they explain
        self._ledger.set_bucket_state_provider(self._bucket_state)
        if device.type == "cuda":
            # fail at boot, not per batch: nvcc missing or refusing a kernel
            # the configured path runs stops the detector here
            if cfg.head_impl == "pallas":
                scorehead.build_kernel()
            if self._flash_reachable():
                flash.build_kernel()
        device_obs.export_hbm_gauges(
            self._obs_labels(), mesh.distinct_devices() if mesh is not None else device,
            self.metrics)
        scorer = self._build_scorer(device)
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        self._device = device
        self._step_seeds = torch.Generator().manual_seed(cfg.seed)
        if mesh is not None:
            self._build_sharded(scorer, mesh, generator)
            return
        self._model = scorer.init_model(device, generator)
        self._optimizer = scorer.make_optimizer(self._model)
        if cfg.host_score_max_batch > 0 and self._host_scoring_possible():
            # the host copy scores through the einsum head whatever the
            # device head is, like the JAX detector's host twin
            self._host_scorer = type(scorer)(
                dataclasses.replace(scorer.config, head_impl="einsum"))
        self._scorer = scorer
        if cfg.score_norm == "position":
            self._norm_bufs = (torch.zeros(cfg.seq_len, device=device),
                               torch.ones(cfg.seq_len, device=device))
        self._warm = WarmSet(device, self._ledger, self._obs_backend, self._eager,
                             self._graph_ident, owner_ok=self._may_capture)

    def _build_sharded(self, scorer: ScorerBase, mesh, generator: torch.Generator) -> None:
        """Mesh mode: the weights are initialized on the mesh's first device
        from the same generator as on one device, then placed; no host copy
        (small batches ride the mesh, as in the JAX detector)."""
        from ...parallel.sharded import ShardedScorer, mesh_label

        self._sharded = ShardedScorer(scorer, mesh=mesh, generator=generator,
                                      owner_ok=self._may_capture, ledger=self._ledger)
        self._device_label = mesh_label(mesh)
        self._scorer = scorer
        if self.config.score_norm == "position":
            self._sharded.set_norm(np.zeros(self.config.seq_len, np.float32),
                                   np.ones(self.config.seq_len, np.float32))
        self._warm = self._sharded.warm

    def _build_scorer(self, device: torch.device) -> ScorerBase:
        """The scorer the config names, as ``jax_scorer.py`` builds it.
        ``int8w`` computes in the device's fast float: bf16 on CUDA, fp32 on
        the CPU."""
        cfg = self.config
        if self._int8w:
            dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
        else:
            dtype = _DTYPES[cfg.dtype]
        if cfg.model == "gru":
            return GRUScorer(GRUScorerConfig(
                vocab_size=cfg.vocab_size, dim=cfg.dim, depth=cfg.depth,
                seq_len=cfg.seq_len, score_topk=cfg.score_topk,
                score_vocab=cfg.score_vocab, head_impl=cfg.head_impl, dtype=dtype))
        if cfg.model == "logbert":
            return LogBERTScorer(LogBERTConfig(
                vocab_size=cfg.vocab_size, dim=cfg.dim, depth=cfg.depth,
                heads=cfg.heads, seq_len=cfg.seq_len, score_topk=cfg.score_topk,
                attn_impl=cfg.attn_impl, score_vocab=cfg.score_vocab,
                head_impl=cfg.head_impl, dtype=dtype))
        return MLPScorer(MLPScorerConfig(
            vocab_size=cfg.vocab_size, dim=cfg.dim, seq_len=cfg.seq_len,
            dtype=dtype, head_impl=cfg.head_impl))

    def _flash_reachable(self) -> bool:
        """Whether the model's attention can take the flash kernels on a
        CUDA device (``attention()``'s routing)."""
        cfg = self.config
        return cfg.model == "logbert" and (
            cfg.attn_impl == "flash"
            or (cfg.attn_impl == "auto" and cfg.seq_len >= FLASH_MIN_SEQ))

    def _host_scoring_possible(self) -> bool:
        """Whether the model can score on the host CPU copy: a logbert whose
        attention takes the flash kernels, or runs as a ring over a mesh, is
        device-only, as in the JAX detector, so its small batches ride the
        device path."""
        cfg = self.config
        ring = cfg.model == "logbert" and cfg.attn_impl == "ring"
        return not (self._flash_reachable() or ring)

    def load_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Install weights (a ``state_dict``, e.g. from
        ``models.convert.params_from_flax``) before the fit; the optimizer
        restarts from zero moments."""
        self._ensure_scorer()
        if self._sharded is not None:
            self._sharded.install_params(state_dict)
            return
        self._model.load_state_dict(state_dict)
        self._optimizer = self._scorer.make_optimizer(self._model)

    def _sync_host_params(self) -> None:
        """Mirror the current (float) weights and norm statistics into the
        CPU copy (after a fit or a checkpoint load)."""
        if self._host_scorer is None or self._model is None:
            return
        self._host_model = self._host_scorer.clone_model(self._model, torch.device("cpu"))
        self._host_norm = (None if self._norm_mu is None else
                           (torch.from_numpy(self._norm_mu),
                            torch.from_numpy(self._norm_sigma)))

    def _set_norm(self, mu: Optional[np.ndarray], sigma: Optional[np.ndarray]) -> None:
        """Install (or clear, with None) the position-norm statistics, on
        the host and on the device. On the device they are copied into the
        static buffers the normscore graphs read, so no graph goes stale."""
        self._norm_mu, self._norm_sigma = mu, sigma
        if mu is None:
            self._norm_dev = None
            return
        if self._sharded is not None:
            # each data row reads its own copy (the rows' normscore graphs)
            self._sharded.set_norm(mu, sigma)
            self._norm_dev = self._sharded.norm_rows
            return
        if self._norm_bufs is None:
            self._norm_bufs = (torch.empty(len(mu), device=self._device),
                               torch.empty(len(sigma), device=self._device))
        self._norm_bufs[0].copy_(torch.from_numpy(mu))
        self._norm_bufs[1].copy_(torch.from_numpy(sigma))
        self._norm_dev = self._norm_bufs

    def _host_tokens(self, array: np.ndarray) -> torch.Tensor:
        """A token batch in the narrow wire format (uint16 ids as int16
        bits; the scorer widens them on the device), as a host tensor:
        pinned on a GPU, so its copy to the card is asynchronous."""
        narrow = narrow_tokens(array, self.config.vocab_size)
        if narrow.dtype == np.uint16:
            narrow = narrow.view(np.int16)
        tokens = torch.from_numpy(np.ascontiguousarray(narrow))
        return tokens if self._device.type == "cpu" else tokens.pin_memory()

    def _zero_upload(self, bucket: int) -> torch.Tensor:
        return self._host_tokens(np.zeros((bucket, self.config.seq_len), np.int32))

    def _put(self, array: np.ndarray) -> torch.Tensor:
        """Upload a token batch on the device; on a GPU the copy queues
        behind the batches already in flight instead of waiting for them."""
        tokens = self._host_tokens(array)
        if self._device.type == "cpu":
            return tokens
        return tokens.to(self._device, non_blocking=True)

    def _eager(self, kind: str, tokens: torch.Tensor) -> torch.Tensor:
        """Score device tokens the way the detector serves now, op by op:
        what a warm-set graph captures and replays. ``normscore`` reads the
        static norm buffers; while the int8 path serves, its state is
        dequantized into the compute dtype here, in the call. In mesh mode
        every data row scores its slice (``ShardedScorer.eager``)."""
        if self._sharded is not None:
            return self._sharded.eager(kind, tokens)
        if kind == "token_nlls":
            return self._scorer.token_nlls(self._model, tokens)
        norm = self._norm_bufs if kind == "normscore" else None
        if self._qstate is not None:
            params = quant.dequantize(self._qstate, self._scorer.config.dtype)
            with self._serve_lock:  # functional_call swaps the skeleton's leaves
                return torch.func.functional_call(
                    self._serving, {f"model.{k}": v for k, v in params.items()},
                    (tokens, norm))
        if norm is not None:
            return self._scorer.normscore(self._model, tokens, *norm)
        return self._scorer.score(self._model, tokens)

    def _graph_ident(self, kind: str) -> Any:
        """The weights a graph of ``kind`` reads that a swap replaces rather
        than overwrites: the int8 state while it serves (the calibration
        pass scores the float weights)."""
        return None if kind == "token_nlls" else self._qstate

    def _may_capture(self) -> bool:
        """Captures run on the thread that owns the device work: not while
        a background fit runs, unless on the fit thread itself."""
        fit = self._fit_thread
        return fit is None or not fit.is_alive() or threading.current_thread() is fit

    def _serve_kind(self) -> str:
        return "normscore" if self._norm_dev is not None else "score"

    def _score_dev(self, tokens: np.ndarray) -> torch.Tensor:
        """Queue scoring of [n, S] tokens on the device (positional z-scores
        once calibrated) through the warm set: on a GPU the replay of the
        bucket's graph, captured first if missing or stale; returns the
        device tensor without waiting for it."""
        return self._warm.run(self._serve_kind(), self._host_tokens(tokens))

    def _score_eager(self, tokens: np.ndarray) -> torch.Tensor:
        """The same scores as ``_score_dev``, op by op without a graph (the
        yardstick a replay is held against)."""
        return self._eager(self._serve_kind(), self._put(tokens))

    def _token_nlls_dev(self, tokens: np.ndarray) -> torch.Tensor:
        return self._warm.run("token_nlls", self._host_tokens(tokens))

    def _score_host(self, tokens: np.ndarray) -> np.ndarray:
        """Score a small batch on the CPU copy."""
        t = torch.from_numpy(tokens)
        if self._host_norm is not None:
            out = self._host_scorer.normscore(self._host_model, t, *self._host_norm)
        else:
            out = self._host_scorer.score(self._host_model, t)
        return out.numpy()

    def _readback(self, slot: _InflightSlot, scores: torch.Tensor) -> None:
        """Start the device→host copy of a batch's scores."""
        if scores.device.type == "cpu":
            slot.scores = scores.numpy()
            return
        host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
        host.copy_(scores, non_blocking=True)
        slot.event = torch.cuda.Event()
        slot.event.record(torch.cuda.current_stream(scores.device))
        slot.scores = host

    def _calibrate_position_norm(self, data: np.ndarray, bs: int) -> np.ndarray:
        """Masked per-position mean/std of training NLLs → mu/sigma [S];
        returns the calibration split's z-max scores."""
        bucket = _bucket(max(bs, self.config.train_batch_size), self.config.max_batch)
        nlls = self._run_chunked(self._token_nlls_dev, data, bucket)
        mask = (data != PAD_ID).astype(np.float32)
        cnt = np.maximum(mask.sum(0), 1.0)
        mu = (nlls * mask).sum(0) / cnt
        var = ((nlls - mu) ** 2 * mask).sum(0) / cnt
        # sigma floor: a near-constant position stays sensitive to unseen
        # values without the z-score exploding on float jitter
        sigma = np.maximum(np.sqrt(var), 0.05)
        self._set_norm(mu.astype(np.float32), sigma.astype(np.float32))
        z = (nlls - mu) / sigma
        z = np.where(mask > 0, z, -np.inf)
        zmax = z.max(-1)
        return np.where(np.isneginf(zmax), 0.0, zmax).astype(np.float32)

    def _train_step(self, batch: np.ndarray) -> float:
        """One optimizer step with its own generator, seeded from the
        detector's seed stream (the masked-LM mask is drawn from it). The
        step holds the warm set's lock, as a fine-tune's steps do: a
        profiler start or stop (which holds it, ``utils/profiling.py``)
        waits for the step in flight, and no step runs during one (a stop
        during a fit's backward has frozen the process, the stop and the
        backward each waiting inside torch)."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self._step_seeds))
        generator = torch.Generator(device=self._device).manual_seed(seed)
        with self._warm.lock:
            if self._sharded is not None:
                return self._sharded.train_step(batch, generator=generator)
            loss = self._scorer.train_step(self._model, self._optimizer, self._put(batch),
                                           generator=generator)
            return float(loss)

    # -- featurization (host side) --------------------------------------
    def featurize(self, input_: ParserSchema) -> np.ndarray:
        return self._tokenizer.encode_parsed(
            input_.get("template") or "",
            list(input_["variables"]),
            dict(input_["logFormatVariables"]),
        )

    def _native(self):
        """The native featurizer (``utils/matchkern.py``), built at the first
        call, its pool set to ``featurize_threads`` when that is > 0. A
        failed build raises ``LibraryError``: no path runs the Python
        featurizer for a whole batch in its place."""
        if not self._native_ready:
            try:
                matchkern.load()
                if self.config.featurize_threads > 0:
                    matchkern.set_featurize_threads(self.config.featurize_threads)
            except matchkern.NativeBuildError as exc:
                raise LibraryError(
                    f"native_featurize is on but the native featurizer did not build: "
                    f"{exc}") from exc
            self._native_ready = True
        return matchkern

    def _count_featurize_rows(self, native: int, fallback: int) -> None:
        """``featurize_rows``, and under a hosting Service
        ``featurize_native_rows_total`` / ``featurize_fallback_rows_total``:
        which path featurized how many rows."""
        self.featurize_rows["native"] += native
        self.featurize_rows["fallback"] += fallback
        if self.metrics is None or not (native or fallback):
            return
        if self._feat_counters is None:
            labels = self._obs_labels()
            self._feat_counters = (self.metrics.FEATURIZE_NATIVE_ROWS().labels(**labels),
                                   self.metrics.FEATURIZE_FALLBACK_ROWS().labels(**labels))
        if native:
            self._feat_counters[0].inc(native)
        if fallback:
            self._feat_counters[1].inc(fallback)

    def _featurize_raw_batch(self, batch: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        """Serialized ParserSchema bytes → ([N, S] int32 tokens, [N] ok).
        Natively with ``native_featurize``, retrying in Python only the rows
        the C side refuses (the same rows, exactly); in Python otherwise."""
        cfg = self.config
        if cfg.native_featurize:
            tokens, ok = self._native().featurize_batch(batch, cfg.seq_len, cfg.vocab_size)
            flagged = np.flatnonzero(~ok)
            if len(flagged):
                self._featurize_python_rows(batch, tokens, ok, flagged)
            self._count_featurize_rows(len(batch) - len(flagged), len(flagged))
            return tokens, ok
        tokens = np.zeros((len(batch), cfg.seq_len), np.int32)
        ok = np.zeros(len(batch), dtype=bool)
        self._featurize_python_rows(batch, tokens, ok, range(len(batch)))
        self._count_featurize_rows(0, len(batch))
        return tokens, ok

    def _featurize_python_rows(self, batch: List[bytes], tokens: np.ndarray,
                               ok: np.ndarray, indices) -> None:
        encode_into = self._tokenizer.encode_into
        for i in indices:
            try:
                msg = ParserSchema.from_bytes(batch[i])
            except SchemaError:
                continue
            parts = [msg["template"]]
            parts.extend(msg["variables"])
            lfv = msg["logFormatVariables"]
            if lfv:
                parts.extend(f"{k}={lfv[k]}" for k in sorted(lfv))
            tokens[i] = 0  # the native pass may have partly filled the row
            encode_into(" ".join(parts), tokens[i])
            ok[i] = True

    # -- training -------------------------------------------------------
    def train(self, input_: ParserSchema) -> None:
        """Single-message training path: buffer the tokenized row for the
        phase-boundary ``fit`` (``process_batch`` buffers directly)."""
        self._train_buffer.append(self.featurize(input_))

    def fit(self) -> Dict[str, float]:
        """Train on the buffered normal traffic, calibrate the threshold."""
        self._ensure_scorer()
        cfg = self.config
        if not self._train_buffer:
            self._fitted = True
            if self._threshold is None:
                self._threshold = float("inf")
            return {"loss": float("nan"), "threshold": self._threshold}
        data = np.stack(self._train_buffer)
        self._train_buffer = []
        if self._int8w:
            # training updates the float weights; the previous quantized state
            # must not serve (or calibrate) stale scores mid-fit
            self._set_qstate(None)
        bs = min(cfg.train_batch_size, len(data))
        loss = float("nan")
        rng = np.random.default_rng(cfg.seed)
        # "position" norm calibrates on a held-out split: statistics of data
        # the model memorized underestimate the NLL of fresh values
        if cfg.score_norm == "position" and len(data) >= 64:
            n_cal = max(16, len(data) // 5)
            calib, train_data = data[-n_cal:], data[:-n_cal]
            bs = min(bs, len(train_data))
        else:
            calib, train_data = data, data
        steps_per_epoch = max(1, len(train_data) // bs)
        epochs = max(cfg.train_epochs, -(-cfg.min_train_steps // steps_per_epoch))
        for _ in range(epochs):
            order = rng.permutation(len(train_data))
            for start in range(0, len(train_data) - bs + 1, bs):
                loss = self._train_step(train_data[order[start:start + bs]])
        if cfg.score_norm == "position":
            scores = self._calibrate_position_norm(calib, bs)
        else:
            bucket = _bucket(max(bs, cfg.train_batch_size), cfg.max_batch)
            scores = self._run_chunked(self._score_dev, calib, bucket)
        self._calib_stats = (float(scores.mean()), float(scores.std()))
        if self._threshold is None:
            self._threshold = float(scores.mean() + cfg.threshold_sigma * scores.std())
        if self._int8w:
            # the calibration split is the parity corpus: the scores the
            # threshold was calibrated on are the decisions int8 must keep
            self._parity_corpus = np.asarray(calib[:512], np.int32)
            self._activate_int8(where="fit")
        self._fitted = True
        self._sync_host_params()
        return {"loss": loss, "threshold": self._threshold}

    # -- weight-only int8 serving (dtype: int8w) -------------------------
    def _parity_scores(self, tokens: np.ndarray) -> np.ndarray:
        """Served-path scores of the parity corpus, in chunks of the train
        bucket."""
        return self._run_chunked(self._score_dev, tokens,
                                 _bucket(self.config.train_batch_size, self.config.max_batch))

    def _activate_int8(self, where: str = "fit") -> Dict[str, Any]:
        """Quantize the live weights and cut serving over to the int8 path
        (dequantized per call), gated on differential parity: the quantized
        path must flip no alert decision on the parity corpus against the
        path serving now, or the float weights serve. Without a corpus (a
        restore before any fit) the int8 state installs ungated.

        Both sides are judged through the path that serves, the warm set's
        graphs: the tentative install captures the int8 path at the train
        bucket, and afterwards every graph captured on weights that no
        longer serve is re-captured. These are expected captures
        (``where="int8_activate"``, or ``"restore"``)."""
        with self._ledger.context(backend=self._obs_backend, expected=True,
                                  where="restore" if where == "restore" else "int8_activate"):
            report = self._activate_int8_gated(where)
            self._recapture_stale()
        return report

    def _recapture_stale(self) -> None:
        """Re-capture every warm-set graph captured on weights that no
        longer serve, in the caller's ledger context."""
        for kind, bucket in self._warm.stale():
            with self._ledger.context(bucket=bucket):
                self._warm.capture(kind, bucket, self._zero_upload(bucket))

    def _activate_int8_gated(self, where: str) -> Dict[str, Any]:
        report: Dict[str, Any] = {"activated": False, "where": where,
                                  "rows": 0, "flips": 0, "flip_ratio": 0.0}
        threshold = float(self._threshold) if self._threshold is not None else float("inf")
        corpus = self._parity_corpus
        if self._sharded is not None:
            qstate = quant.quantize(self._sharded.state_dict(), self._sharded.linear_keys)
        else:
            qstate = quant.quantize(self._model.state_dict(),
                                    quant.linear_weight_keys(self._model))
        float_scores = None
        if corpus is not None and len(corpus):
            float_scores = self._parity_scores(corpus)
        # tentative install, then judge the per-call int8 path that serves
        # on the same corpus
        self._set_qstate(qstate)
        ok = True
        if float_scores is not None:
            q_scores = self._parity_scores(corpus)
            flips = int(np.sum((float_scores > threshold) != (q_scores > threshold)))
            report.update(rows=int(len(float_scores)), flips=flips,
                          flip_ratio=float(flips) / max(1, len(float_scores)))
            ok = flips == 0
        if not ok:
            self._set_qstate(None)  # parity broke: the quantized path never serves
        else:
            report["activated"] = True
            report["gated"] = float_scores is not None
            report["bytes"] = quant.quant_stats(qstate)
        self._int8_report = report
        return report

    def _set_qstate(self, qstate: Optional[Dict[str, quant.QuantLeaf]]) -> None:
        """Install (None: clear) the int8 state that serves: the detector's
        own, or the mesh's placed copy."""
        if self._sharded is not None:
            if qstate is None:
                self._sharded.clear_quantized()
            else:
                self._sharded.install_quantized(qstate)
            return
        if qstate is not None and self._serving is None:
            self._serving = _ServingModule(self._scorer)
        self._qstate = qstate

    # -- scoring --------------------------------------------------------
    def score_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """[N, S] → [N] fp32 scores, padded up to a bucket, on the device.
        A capture here (a bucket outside the warm set) is expected
        (``where="detect"``): the storm signal watches the batched dispatch
        path, not this one."""
        self._ensure_scorer()
        bucket = _bucket(len(tokens), self.config.max_batch)
        with self._ledger.context(bucket=bucket, where="detect",
                                  backend=self._obs_backend, expected=True):
            return self._run_chunked(self._score_dev, tokens, bucket)

    @staticmethod
    def _run_chunked(fn, tokens: np.ndarray, bucket: int) -> np.ndarray:
        """``fn`` over bucket-sized padded chunks of ``tokens``, waiting for
        each result; the padding rows are dropped."""
        parts = [fn(chunk).cpu().numpy()[:real]
                 for _, chunk, real in _padded_chunks(tokens, bucket)]
        if not parts:
            return np.empty((0,), np.float32)
        return np.concatenate(parts)

    # -- engine contract ------------------------------------------------
    def process_batch(self, batch: List[bytes]) -> List[Optional[bytes]]:
        """Batched hot path: featurize the micro-batch, dispatch one device
        batch per bucket, return the alerts of every batch whose scores have
        landed (older batches first), keeping at most ``pipeline_depth``
        in flight. Messages that arrive while a background fit runs wait in
        an ordered backlog that dispatches once the fit is done."""
        fit_thread = self._fit_thread
        if fit_thread is not None and not fit_thread.is_alive():
            self._finish_fit()
        tokens, ok = self._featurize_raw_batch(batch)
        detect_idx: List[int] = []
        for i in range(len(batch)):
            if not ok[i]:
                continue
            if self._trained < self.config.data_use_training:
                self._train_buffer.append(tokens[i])
                self._trained += 1
                if self._trained == self.config.data_use_training:
                    self._start_fit()
            elif self._fit_thread is not None:
                # the append happens under _fit_lock so _finish_fit's
                # backlog handoff can never interleave with it
                with self._fit_lock:
                    if self._fit_thread is not None:
                        self._pending.append((tokens[i], batch[i]))
                        continue
                if not self._fitted:
                    self.fit()
                detect_idx.append(i)
            else:
                if not self._fitted:
                    self.fit()
                detect_idx.append(i)
        if detect_idx:
            self._hold_or_dispatch(tokens[detect_idx], [batch[i] for i in detect_idx])
            self._count_device_lines(len(detect_idx))
        self._coalesce_pump()
        return self._drain_landed()

    def _hold_or_dispatch(self, tokens: np.ndarray, raws) -> None:
        """Detect rows to the coalescer when it is on (the pump decides
        what dispatches), else straight to the device."""
        coalescer = self._get_coalescer()
        if coalescer is not None:
            coalescer.add(tokens, raws, time.monotonic(), tenant=self._ingress_tenant)
        else:
            self._dispatch(tokens, raws)

    def note_tenant(self, tenant: Optional[str]) -> None:
        """Engine seam: the tenant the current ingress frame was attributed
        to; rows the coalescer takes until the next call are held under it
        (weighted-fair releases). ``None`` clears it. Engine thread."""
        self._ingress_tenant = tenant

    def _drain_landed(self) -> List[Optional[bytes]]:
        """The alerts of every in-flight batch whose scores have landed,
        then of the oldest batches beyond ``pipeline_depth`` (older batches
        first)."""
        ready: List[Optional[bytes]] = []
        while self._inflight and self._head_ready():
            ready.extend(self._drain_one())
        while len(self._inflight) > self.config.pipeline_depth:
            ready.extend(self._drain_one())
        return ready

    def process_frames(self, frames: List[bytes]) -> Tuple[List[Optional[bytes]], int, int]:
        """Wire-frame hot path, as the JAX detector's: raw wire frames
        (packed batch frames of ``engine/framing.py``, or single messages)
        → ``(ready_outputs, n_messages, n_lines)``, ``n_lines`` by the
        engine's newline rule. Packed empty messages are filtered and not
        counted; a corrupt batch frame is counted as a processing error.

        In the fitted steady state one native call expands and featurizes
        the whole burst; the rows stay spans into the frame blob
        (``SpanRaws``) through dispatch and drain, and only the anomalous
        rows are sliced, to build their alerts. During the training phase
        or a running fit the burst is materialized and goes through
        ``process_batch``. With ``native_featurize: false`` the frames are
        expanded in Python."""
        cfg = self.config
        if not cfg.native_featurize:
            msgs: List[bytes] = []
            n_corrupt = 0
            for frame in frames:
                expanded = self._expand_frame_python(frame)
                if expanded is None:
                    n_corrupt += 1
                else:
                    msgs.extend(expanded)
            if n_corrupt:
                self.count_processing_errors(n_corrupt, "corrupt batch frame(s)")
            n_lines = sum(max(1, d.count(b"\n") + (0 if d.endswith(b"\n") else 1))
                          for d in msgs)
            return self.process_batch(msgs), len(msgs), n_lines

        fit_thread = self._fit_thread
        if fit_thread is not None and not fit_thread.is_alive():
            self._finish_fit()
        kern = self._native()
        fb = kern.featurize_frames(frames, cfg.seq_len, cfg.vocab_size)
        if fb.n_corrupt_frames:
            self.count_processing_errors(fb.n_corrupt_frames, "corrupt batch frame(s)")
        n = len(fb)
        steady = (self._fitted and self._fit_thread is None
                  and self._trained >= cfg.data_use_training)
        if not steady:
            return self.process_batch([fb.raw(i) for i in range(n)]), n, fb.n_lines
        raws = kern.SpanRaws(fb.blob, fb.spans)
        flagged = np.flatnonzero(~fb.ok)
        if len(flagged):
            # rows the C side refused: retried in Python, as in a batch
            self._featurize_python_rows(raws, fb.tokens, fb.ok, flagged)
        self._count_featurize_rows(n - len(flagged), len(flagged))
        tokens = fb.tokens
        if not fb.ok.all():
            keep = np.flatnonzero(fb.ok)
            tokens, raws = tokens[keep], kern.SpanRaws(fb.blob, fb.spans[keep])
        if len(tokens):
            # SpanRaws segments stay lazy inside the coalescer
            self._hold_or_dispatch(tokens, raws)
            self._count_device_lines(len(tokens))
        self._coalesce_pump()
        return self._drain_landed(), n, fb.n_lines

    @staticmethod
    def _expand_frame_python(frame: bytes) -> Optional[List[bytes]]:
        """A frame's non-empty messages, expanded in Python; None for a
        corrupt batch frame."""
        try:
            msgs = unpack_batch(frame)
        except FramingError:
            return None
        if msgs is None:
            return [frame] if frame else []
        return [m for m in msgs if m]

    def _head_ready(self) -> bool:
        """True when the oldest in-flight batch's scores are host-readable
        without blocking (an upload worker may still own its dispatch)."""
        slot = self._inflight[0]
        if not slot.done.is_set():
            return False
        return slot.error is not None or slot.event is None or slot.event.query()

    def drain_ready(self) -> List[Optional[bytes]]:
        """Engine short-poll tick: deadline releases, then only batches
        whose scores already landed; never blocks on the device."""
        out: List[Optional[bytes]] = []
        self._finish_fit(wait=False)
        self._coalesce_pump()
        while self._inflight and self._head_ready():
            out.extend(self._drain_one())
        return out

    # -- async fit at the phase boundary --------------------------------
    def _start_fit(self) -> None:
        if not self.config.async_fit:
            self.fit()
            return

        def _fit_safe():
            try:
                self.fit()
            except Exception:
                logger.exception("background fit failed")
                self._fitted = True  # fail open: detect with inf threshold
                if self._threshold is None:
                    self._threshold = float("inf")

        # publish AND start under the lock: _finish_fit clears the handle
        # under it, and joining a published-but-unstarted thread raises
        with self._fit_lock:
            self._fit_thread = threading.Thread(target=_fit_safe, daemon=True,
                                                name="ScorerFit")
            self._fit_thread.start()

    def _finish_fit(self, wait: bool = False) -> None:
        """Join a finished (or, with ``wait``, still-running) fit thread and
        dispatch the ordered backlog that accumulated during the fit."""
        pre = self._fit_thread
        if pre is not None and pre.is_alive() and not wait:
            return
        with self._fit_lock:
            thread = self._fit_thread
            if thread is None:
                return
            if thread.is_alive() and not wait:
                return
            thread.join()  # the fit thread never takes _fit_lock
            self._fit_thread = None
            if self._pending:
                tokens = np.stack([t for t, _ in self._pending])
                raws = [r for _, r in self._pending]
                self._pending = []
                coalescer = self._get_coalescer()
                if coalescer is not None:
                    # the backlog's size is whatever the fit's length made
                    # it: through the coalescer (released by the caller's
                    # pump) it stays on warm buckets
                    coalescer.add(tokens, raws, time.monotonic())
                else:
                    self._dispatch(tokens, raws)
                self._count_device_lines(len(raws))

    def _dispatch(self, tokens: np.ndarray, msgs: List[Any],
                  t_enqueue: Optional[float] = None, release: Optional[str] = None) -> None:
        """Score [n, S] tokens: small batches synchronously on the CPU copy,
        the rest on the device in bucket-sized chunks whose readback is
        queued without waiting. Every batch joins ``_inflight`` in order.

        A coalesced release (``release`` set) backdates ``t_enqueue`` to the
        oldest held row's arrival and buckets against the active warm set
        (``_pick_device_bucket``); an uncoalesced call takes the natural
        power-of-two bucket, warmed as an expected capture first when it is
        outside the warm set."""
        self._ensure_scorer()
        n = len(tokens)
        cap = self.config.host_score_max_batch
        # token rows ride the slot only while a sampler will take them
        keep_tokens = self._rollout_sampler is not None
        if 0 < n <= cap and self._host_model is not None:
            slot = _InflightSlot(msgs, n, path="host", bucket=n,
                                 trace_id=self._current_trace_id(), release=release,
                                 tokens=tokens if keep_tokens else None)
            if t_enqueue is not None:
                slot.t_enqueue = t_enqueue
            slot.t_start = time.monotonic()
            slot.scores = self._score_host(tokens)
            slot.done.set()
            # synchronous: the scores are host-readable now
            self._observe_batch(slot, time.monotonic() - slot.t_start)
            self._inflight.append(slot)
            self.path_counts["host"] += 1
            return
        if release is not None:
            bucket = self._pick_device_bucket(n)
            self._bucket_usage[bucket] = self._bucket_usage.get(bucket, 0) + 1
        else:
            bucket = _bucket(n, self.config.max_batch)
            if bucket not in self._device_warm:
                self._warm_device_bucket(bucket)
        workers = self.config.upload_workers > 0
        if workers:
            self._ensure_upload_workers()
        for start, chunk, real in _padded_chunks(tokens, bucket):
            slot = _InflightSlot(msgs[start:start + real], real, path="device",
                                 bucket=bucket, trace_id=self._current_trace_id(),
                                 release=release, tokens=chunk if keep_tokens else None)
            if t_enqueue is not None:
                slot.t_enqueue = t_enqueue
            self._inflight.append(slot)
            self.path_counts["device"] += 1
            if workers:
                self._upload_queue.put((slot, chunk))
                continue
            # inline: filled before returning; a dispatch error raises to the
            # caller
            slot.t_start = time.monotonic()
            with self._ledger.context(bucket=bucket, backend=self._obs_backend,
                                      where="dispatch", expected=False):
                self._readback(slot, self._score_dev(chunk))
            slot.done.set()

    # -- adaptive batching (the coalescer) -------------------------------
    def _get_coalescer(self) -> Optional[_BatchCoalescer]:
        if self.config.batch_deadline_ms <= 0:
            return None
        if self._coalescer is None:
            self._coalescer = _BatchCoalescer(self.config.batch_deadline_ms / 1000.0,
                                              self.config.batch_target_occupancy)
        return self._coalescer

    def _coalesce_pump(self, force: bool = False) -> None:
        """Release held rows, for three reasons in this order: ``full`` (the
        held rows fill the largest active warm bucket to the target
        occupancy), ``deadline`` (the oldest row's wait nears the budget:
        everything held goes, in smaller buckets), ``flush`` (``force``: an
        idle or teardown drain, or the deadline turned off at runtime).
        Engine thread only."""
        co = self._coalescer
        if co is None:
            return
        if not len(co):
            self._observe_coalesce_depth(0)
            self._drop_retired_graphs()
            return
        if self.config.batch_deadline_ms <= 0:
            force = True  # disabled at runtime with rows still held
        now = time.monotonic()
        largest = self._largest_active_bucket()
        target = max(1, math.ceil(co.target_occupancy * largest))
        while len(co) >= target:
            self._release_coalesced(min(len(co), largest), "full", now)
        if force:
            while len(co):
                self._release_coalesced(min(len(co), largest), "flush", now)
        elif co.due(now):
            while len(co):
                self._release_coalesced(min(len(co), largest), "deadline", now)
        self._maybe_retire_buckets(now)
        self._drop_retired_graphs()
        self._observe_coalesce_depth(len(co))

    def _release_coalesced(self, n: int, reason: str, now: float) -> None:
        tokens, raws, t_oldest = self._coalescer.take(n)
        self._coalescer.note_release(reason, now - t_oldest)
        self._count_release(reason)
        self._dispatch(tokens, raws, t_enqueue=t_oldest, release=reason)

    def _active_buckets(self) -> List[int]:
        """The warm set without the retired buckets, ascending."""
        return sorted(self._device_warm - self._retired_buckets)

    def _largest_active_bucket(self) -> int:
        active = self._active_buckets()
        return active[-1] if active else _bucket(self.config.max_batch,
                                                 self.config.max_batch)

    def _pick_device_bucket(self, n: int) -> int:
        """The bucket of a coalesced release: the natural power-of-two
        bucket when active (warmed on first use, an expected capture), the
        next active bucket up while the natural one is retired (padding
        costs less than bringing back a bucket the usage window judged
        underused), and the natural one resurrected once it keeps winning
        best fit (the traffic's shape came back)."""
        natural = _bucket(n, self.config.max_batch)
        if natural in self._device_warm and natural not in self._retired_buckets:
            return natural
        if natural in self._retired_buckets:
            hits = self._retired_hits.get(natural, 0) + 1
            self._retired_hits[natural] = hits
            if hits <= max(1, self.config.bucket_retire_min_dispatches):
                # the largest bucket never retires: an active bucket at
                # least this large exists
                for b in self._active_buckets():
                    if b >= natural:
                        return b
            self._retired_buckets.discard(natural)
            self._drop_pending.discard(natural)
        self._warm_device_bucket(natural)
        return natural

    def _warm_device_bucket(self, bucket: int) -> None:
        """Capture a device bucket before the dispatch path uses it, as an
        expected capture (``where="bucket_warm"``): neither warm-set growth
        nor a resurrection may page as a recompile storm. The capture stalls
        this one release; later batches of the bucket replay."""
        self._ensure_scorer()
        with self._ledger.context(bucket=bucket, backend=self._obs_backend,
                                  where="bucket_warm", expected=True):
            if not self._warm.has(self._serve_kind(), bucket):
                self._warm.capture(self._serve_kind(), bucket, self._zero_upload(bucket))
        self._device_warm.add(bucket)

    def _maybe_retire_buckets(self, now: float) -> None:
        interval = self.config.bucket_retire_interval_s
        if interval <= 0 or self._coalescer is None:
            return
        if self._retire_last_sweep is None:
            self._retire_last_sweep = now
            return
        if now - self._retire_last_sweep >= interval:
            self._retire_sweep(now)

    def _retire_sweep(self, now: float) -> None:
        """One retirement pass over the usage window: active buckets with
        fewer than ``bucket_retire_min_dispatches`` dispatches since the
        last sweep leave the active set (their rows pad up) and their graphs
        are dropped once no batch of theirs is in flight. The largest bucket
        is the pad-up backstop and stays."""
        floor = max(1, self.config.bucket_retire_min_dispatches)
        active = self._active_buckets()
        largest = active[-1] if active else 0
        retired = [b for b in active if b != largest and self._bucket_usage.get(b, 0) < floor]
        for b in retired:
            self._retired_buckets.add(b)
            self._drop_pending.add(b)
        if retired:
            self._coalescer.retired_total += len(retired)
            logger.info("batch coalescer retired underused bucket(s) %s (< %d dispatches "
                        "in %.1fs); active warm set now %s", retired, floor,
                        self.config.bucket_retire_interval_s, self._active_buckets())
        self._bucket_usage.clear()
        self._retired_hits.clear()
        self._retire_last_sweep = now

    def _drop_retired_graphs(self) -> None:
        """Drop the graphs of retired buckets none of whose batches is still
        in flight (a graph is never destroyed under a queued replay)."""
        if not self._drop_pending:
            return
        busy = {slot.bucket for slot in self._inflight}
        for bucket in sorted(self._drop_pending - busy):
            self._drop_pending.discard(bucket)
            if bucket in self._retired_buckets and self._warm is not None:
                self._warm.drop(bucket)

    def _bucket_state(self) -> Dict[str, Any]:
        """The ledger's bucket-state provider (``GET /admin/xla``); host
        state only."""
        return {"coalescing": self.config.batch_deadline_ms > 0,
                "warm": self._active_buckets(),
                "retired": sorted(self._retired_buckets)}

    def batching_stats(self) -> Dict[str, Any]:
        """Scheduler counters: releases by reason, achieved occupancy, held
        depth, release waits and the warm / retired sets, key for key the
        JAX detector's."""
        co = self._coalescer
        occ_n, occ_sum = self._occ_stats
        return {
            "enabled": self.config.batch_deadline_ms > 0,
            "held_rows": 0 if co is None else len(co),
            "rows_coalesced": 0 if co is None else co.rows_in,
            "releases": dict(co.releases) if co is not None else {},
            "max_wait_s": 0.0 if co is None else round(co.max_wait_s, 6),
            "mean_wait_s": (round(co.wait_sum_s / co.wait_n, 6)
                            if co is not None and co.wait_n else 0.0),
            "buckets_retired_total": 0 if co is None else co.retired_total,
            "held_by_tenant": {} if co is None else co.held_by_tenant(),
            "dispatches": occ_n,
            "occupancy_sum": round(occ_sum, 4),
            "occupancy_mean": round(occ_sum / occ_n, 4) if occ_n else None,
            "warm_buckets": self._active_buckets(),
            "retired_buckets": sorted(self._retired_buckets),
        }

    def _observe_coalesce_depth(self, depth: int) -> None:
        if self.metrics is None:
            return
        if self._coalesce_gauge is None:
            self._coalesce_gauge = self.metrics.COALESCE_DEPTH().labels(**self._obs_labels())
        self._coalesce_gauge.set(depth)

    def _count_release(self, reason: str) -> None:
        if self.metrics is None:
            return
        child = self._release_children.get(reason)
        if child is None:
            child = self.metrics.DEADLINE_RELEASES().labels(reason=reason,
                                                            **self._obs_labels())
            self._release_children[reason] = child
        child.inc()

    # -- upload workers ---------------------------------------------------
    def _ensure_upload_workers(self) -> None:
        if self._upload_threads and all(t.is_alive() for t in self._upload_threads):
            return
        if self._upload_queue is None:
            self._upload_queue = queue.Queue()
        if self._dispatch_hb is None and self.health_monitor is not None:
            self._dispatch_hb = self.health_monitor.register_heartbeat("scorer_dispatch")
        self._upload_threads = [t for t in self._upload_threads if t.is_alive()]
        for i in range(len(self._upload_threads), self.config.upload_workers):
            thread = threading.Thread(target=self._upload_loop, daemon=True,
                                      name=f"ScorerDispatch-{i}")
            self._upload_threads.append(thread)
            thread.start()

    def _upload_loop(self) -> None:
        """Dispatch worker: the upload, the replay and the readback's start
        for queued slots. A failure is stored on the slot (counted at
        drain), so no slot is left waiting on a worker that died."""
        while True:
            item = self._upload_queue.get()
            if item is None:
                return
            if self._dispatch_hb is not None:
                self._dispatch_hb.beat()
            slot, chunk = item
            slot.t_start = time.monotonic()  # the queue wait ends here
            try:
                with self._ledger.context(bucket=slot.bucket, backend=self._obs_backend,
                                          where="dispatch", expected=False):
                    self._readback(slot, self._score_dev(chunk))
            except Exception as exc:  # noqa: BLE001 — the slot carries it to the drain
                slot.error = exc
            finally:
                slot.done.set()

    def _stop_upload_workers(self) -> None:
        if self._upload_queue is None:
            return
        for thread in self._upload_threads:
            if thread.is_alive():
                self._upload_queue.put(None)   # one sentinel per live worker
        for thread in self._upload_threads:
            thread.join(timeout=5)
        self._upload_threads = []

    # -- drain ---------------------------------------------------------------
    def _drain_one(self) -> List[Optional[bytes]]:
        slot = self._inflight.popleft()
        slot.done.wait()
        self._drained_total += 1
        if slot.error is not None:
            # a worker's dispatch failed: every row of the batch is counted
            # as a processing error, nothing is emitted, the loop lives on
            self.count_processing_errors(slot.real, f"batch dispatch failed: {slot.error}")
            return []
        if slot.event is not None:
            slot.event.synchronize()
            scores = slot.scores.numpy()[:slot.real]
        else:
            scores = np.asarray(slot.scores)[:slot.real]
        if self._rollout_sampler is not None and slot.tokens is not None:
            # rows enter the reservoir paired with the scores they got: the
            # drift monitor reads the distribution the dispatch path served
            self._rollout_sampler.offer_rows(slot.tokens[:slot.real], scores)
        if slot.path != "host":
            # scoring-call start to host-readable scores (the host path
            # recorded its synchronous time at dispatch)
            start = slot.t_start if slot.t_start is not None else slot.t_enqueue
            self._observe_batch(slot, time.monotonic() - start)
        threshold = self._threshold if self._threshold is not None else float("inf")
        hits = np.flatnonzero(scores > threshold)
        out: List[Optional[bytes]] = []
        for i in hits:  # decode only the anomalous rows
            msg = ParserSchema.from_bytes(slot.raws[i])
            out.append(self._make_alert_pb(msg, float(scores[i])))
        return out

    def pending_count(self) -> int:
        """Scored batches in flight, plus one while the coalescer holds rows:
        while > 0 the engine short-polls and calls ``drain_ready`` on each
        tick."""
        held = self._coalescer is not None and len(self._coalescer) > 0
        return len(self._inflight) + (1 if held else 0)

    @property
    def device(self) -> Optional[torch.device]:
        """The device the detector scores on (None before ``setup_io``): a
        profiler capture of its process records that device's activity."""
        return self._device

    @property
    def drain_poll_ms(self) -> Optional[int]:
        """The engine's short-poll tick while the coalescer may hold rows: a
        quarter of the deadline (the coalescer also releases a tick early),
        at least 1 ms; None without a deadline."""
        if self.config.batch_deadline_ms <= 0:
            return None
        return max(1, int(self.config.batch_deadline_ms / 4))

    def drain_due_in_ms(self) -> Optional[float]:
        """Milliseconds until the coalescer's held rows fall due (0 when
        they are), None when it holds none: the engine's short poll ends
        then instead of up to a tick later (``drain_poll_ms``). Engine
        thread."""
        co = self._coalescer
        due = None if co is None else co.due_in_s(time.monotonic())
        return None if due is None else due * 1e3

    def drained_total(self) -> int:
        """Batches drained so far: the progress counter the health watchdog
        pairs with ``pending_count`` to see a stuck device queue."""
        return self._drained_total

    def _obs_labels(self) -> Dict[str, str]:
        return dict(component_type=self.config.method_type, component_id=self.name)

    def _count_device_lines(self, n: int) -> None:
        """``n`` lines handed to the scorer in one call, under the
        detector's own labels and device, as the JAX detector counts them."""
        if self.metrics is None:
            return
        if self._device_children is None:
            labels = dict(self._obs_labels(), device=self._device_label or str(self._device))
            self._device_children = (self.metrics.DEVICE_LINES().labels(**labels),
                                     self.metrics.DEVICE_BATCHES().labels(**labels))
        lines, batches = self._device_children
        lines.inc(n)
        batches.inc()

    def _current_trace_id(self) -> Optional[str]:
        """The flight recorder's last completed trace id (the engine's,
        through the health monitor the Service hands in), or None off a
        traced pipeline."""
        recorder = getattr(self.health_monitor, "trace_recorder", None)
        return recorder.last_trace_id if recorder is not None else None

    def _observe_batch(self, slot: _InflightSlot, device_s: float) -> None:
        """Per-batch telemetry when its scores become host-readable: the
        occupancy (real rows over the padded bucket), the queue wait
        (dispatch call, or the oldest held row's arrival, to scoring start),
        the device seconds and the bucket; a span in the capture ledger."""
        start = slot.t_start if slot.t_start is not None else slot.t_enqueue
        queue_wait_s = max(0.0, start - slot.t_enqueue)
        occ_n, occ_sum = self._occ_stats
        self._occ_stats = (occ_n + 1, occ_sum + slot.real / slot.bucket)
        self._ledger.record_span(slot.bucket, slot.real, slot.path, queue_wait_s,
                                 max(0.0, device_s), slot.trace_id, release=slot.release)
        tap = self._capacity_tap
        if tap is not None:
            # the capacity model's arithmetic: every observed batch, any path
            tap(slot.real, max(0.0, device_s))
        if self.metrics is None:
            return
        children = self._batch_children.get(slot.path)
        if children is None:
            labels = dict(self._obs_labels(), path=slot.path)
            children = (self.metrics.BATCH_OCCUPANCY().labels(**labels),
                        self.metrics.BATCH_QUEUE_WAIT().labels(**labels),
                        self.metrics.BATCH_DEVICE_SECONDS().labels(**labels))
            self._batch_children[slot.path] = children
        occupancy, queue_wait, device_seconds = children
        occupancy.observe(slot.real / slot.bucket)
        # the exemplar links the sample to the trace in flight at dispatch
        if slot.trace_id:
            queue_wait.observe(queue_wait_s, {"trace_id": slot.trace_id})
        else:
            queue_wait.observe(queue_wait_s)
        device_seconds.observe(max(0.0, device_s))
        self.metrics.BUCKET_SELECTED().labels(
            bucket=str(slot.bucket), path=slot.path, **self._obs_labels()).inc()

    def flush(self) -> List[Optional[bytes]]:
        """Idle-time drain: non-blocking on a running fit (a finished fit's
        backlog is dispatched); held rows release (``flush``), then every
        in-flight batch is drained."""
        self._finish_fit(wait=False)
        self._coalesce_pump(force=True)
        out = super().flush()
        while self._inflight:
            out.extend(self._drain_one())
        return out

    def flush_final(self) -> List[Optional[bytes]]:
        """Stop-time drain: waits for a running fit so its backlog is scored
        and emitted before the caller stops; the upload workers stop after
        the drain (a detector used again respawns them)."""
        self._finish_fit(wait=True)
        out = self.flush()
        self._stop_upload_workers()
        return out

    def _make_alert_pb(self, msg: ParserSchema, score: float) -> bytes:
        """Alert for one anomalous message: ``make_output``'s skeleton plus
        the score."""
        out = self.make_output(msg)
        out["score"] = score
        out["alertsObtain"] = {
            f"{self.name} - score": f"anomaly score {score:.4f} > {self._threshold:.4f}"}
        return out.serialize()

    def detect(self, input_: ParserSchema, output_: DetectorSchema) -> bool:
        """Single-message path: a batch of one, scored on the device."""
        self._finish_fit(wait=True)
        if not self._fitted:
            self.fit()
        score = float(self.score_tokens(self.featurize(input_)[None])[0])
        self._count_device_lines(1)
        if score > self._threshold:
            output_["score"] = score
            output_["alertsObtain"].update(
                {f"{self.name} - score": f"anomaly score {score:.4f} > {self._threshold:.4f}"})
            return True
        return False

    # -- the model lifecycle (rollout/manager.py, obs/) -------------------
    def set_rollout_sampler(self, sampler) -> None:
        """Attach the drain-path traffic tap (``rollout/sampler.py``): one
        ``offer_rows`` call per drained batch, rows paired with the scores
        they got. None detaches."""
        self._rollout_sampler = sampler

    def set_capacity_tap(self, tap) -> None:
        """Attach the capacity tap (``obs/capacity.py``): called as
        ``tap(n_rows, device_seconds)`` per observed batch, any path. None
        detaches."""
        self._capacity_tap = tap

    def model_version(self) -> int:
        """The installed checkpoint version (0 = the boot-time fit)."""
        return self._model_version

    def live_threshold(self) -> float:
        return float(self._threshold) if self._threshold is not None else float("inf")

    def rollout_ready(self) -> bool:
        """Whether a fine-tune and shadow cycle can run: fitted, one device
        with live weights, and no background fit running (mesh mode serves
        hot-swaps of checkpoints but fine-tunes nothing in process, as in the
        JAX detector)."""
        return (self._fitted and self._fit_thread is None and self._sharded is None
                and self._model is not None)

    def _refuse_during_fit(self, what: str) -> None:
        fit = self._fit_thread
        if fit is not None and fit.is_alive() and threading.current_thread() is not fit:
            raise LibraryError(f"{what} refused: a background fit owns the device")

    def rollout_fine_tune(self, rows: np.ndarray, epochs: int = 1,
                          seed: int = 0) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                                                  Dict[str, Any]]:
        """Fine-tune a CANDIDATE on sampled rows: a clone of the live module
        and of its optimizer state, trained on the caller's thread; the live
        weights are never touched. The sample order is the JAX detector's
        (``default_rng(seed + cfg.seed)``, batches of ``min(train_batch_size,
        len(rows))``); a step that draws (LogBERT's masks) draws from one
        generator seeded ``cfg.seed + 1 + seed``, as the JAX detector seeds
        its key. Each step enqueues under the warm set's lock, released
        between steps. Returns the candidate's ``(state_dict, optimizer state_dict,
        {"steps", "loss", "batch_size"})``."""
        self._ensure_scorer()
        if self._sharded is not None:
            raise LibraryError(
                "continuous fine-tuning is not supported in mesh (sharded) "
                "mode; deploy externally-trained checkpoints instead")
        self._refuse_during_fit("fine-tuning")
        cfg = self.config
        rows = np.asarray(rows, np.int32)
        if not len(rows):
            raise LibraryError("no sampled rows to fine-tune on")
        bs = min(cfg.train_batch_size, len(rows))
        order_rng = np.random.default_rng(cfg.seed + seed)
        generator = torch.Generator(device=self._device).manual_seed(cfg.seed + 1 + seed)
        with self._warm.lock:
            model = self._scorer.clone_model(self._model, self._device).requires_grad_(True)
            optimizer = self._scorer.make_optimizer(model)
            # load_state_dict keeps the tensors it is given: the candidate's
            # moments must not be the live optimizer's storage
            optimizer.load_state_dict(copy.deepcopy(self._optimizer.state_dict()))
        loss, steps = None, 0
        with self._ledger.context(where="rollout_fit", backend=self._obs_backend,
                                  expected=True):
            for _ in range(max(1, epochs)):
                order = order_rng.permutation(len(rows))
                for start in range(0, len(rows) - bs + 1, bs):
                    batch = rows[order[start:start + bs]]
                    with self._warm.lock:
                        loss = self._scorer.train_step(model, optimizer, self._put(batch),
                                                       generator=generator)
                    steps += 1
        return (model.state_dict(), optimizer.state_dict(),
                {"steps": steps, "loss": float("nan") if loss is None else float(loss),
                 "batch_size": bs})

    def _score_with_params(self, params: Optional[Dict[str, torch.Tensor]],
                           tokens: np.ndarray) -> torch.Tensor:
        """Scores of a padded chunk under ``params`` (None = the live
        weights, through the warm set's graph); a candidate scores op by op
        on the meta-device skeleton with the live norm statistics, so live
        and candidate scores share one unit."""
        if params is None:
            return self._score_dev(tokens)
        if self._candidate is None:
            self._candidate = _ServingModule(self._scorer)
        leaves = {f"model.{k}": v for k, v in params.items()}
        norm = self._norm_bufs if self._norm_dev is not None else None
        upload = self._put(tokens)
        with self._warm.lock:
            return torch.func.functional_call(self._candidate, leaves, (upload, norm))

    def rollout_scores(self, params: Optional[Dict[str, torch.Tensor]],
                       tokens: np.ndarray) -> np.ndarray:
        """Shadow scoring: [n, S] tokens → [n] fp32 scores under ``params``
        (None = live), in padded chunks of the train bucket (warm since
        setup), under an expected ``shadow`` ledger context."""
        self._ensure_scorer()
        if self._sharded is not None and params is not None:
            raise LibraryError(
                "shadow scoring with explicit params is not supported in "
                "mesh (sharded) mode")
        self._refuse_during_fit("shadow scoring")
        tokens = np.asarray(tokens, np.int32)
        n = len(tokens)
        if n == 0:
            return np.zeros(0, np.float32)
        if params is not None:
            params = {k: v.to(self._device) for k, v in params.items()}
        bucket = _bucket(self.config.train_batch_size, self.config.max_batch)
        out = np.empty(n, np.float32)
        with self._ledger.context(bucket=bucket, where="shadow", backend=self._obs_backend,
                                  expected=True):
            for start, chunk, real in _padded_chunks(tokens, bucket):
                out[start:start + real] = \
                    self._score_with_params(params, chunk).cpu().numpy()[:real]
        return out

    def _resolve_warm_set(self, warm_set: Optional[Dict[str, Any]]) -> List[int]:
        """The live warm set UNIONED with a persisted warm-set spec (the
        rollout manifest's): a promote on a restarted process warms what
        the recording boot warmed. A spec for another sequence length, or a
        malformed one, adds nothing."""
        cfg = self.config
        warmed = set(self._device_warm)
        if warm_set:
            try:
                if int(warm_set.get("seq_len", cfg.seq_len)) == cfg.seq_len:
                    warmed.update(b for b in (int(x) for x in warm_set.get("buckets", ()))
                                  if 0 < b <= cfg.max_batch)
            except (TypeError, ValueError, AttributeError):
                pass
        return sorted(warmed)

    def install_candidate(self, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
                          version: int = 0,
                          warm_set: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Zero-downtime hot-swap: land a running boundary fit, build the
        CPU copy's mirror of the candidate, then, under ``_fit_lock`` and the
        warm set's lock, copy the candidate into the live weights' storage
        on the detector's stream and swap the mirror, the optimizer state
        and the version. Every graph reads the weights by address, so each
        stays valid: a float swap captures nothing. A bucket the stored
        ``warm_set`` spec adds is captured after the copy under an expected
        ``model_swap`` context. Under ``dtype: int8w`` the candidate is
        re-quantized and the gate judged again under the same locks, so
        the warm set is re-captured (expected, ``int8_activate``) before any
        replay runs. ``install`` in the result times the copy and the
        mirror."""
        self._ensure_scorer()
        fit = self._fit_thread
        if fit is not None and fit.is_alive() and threading.current_thread() is not fit:
            # its end would overwrite the installed weights with the fit's;
            # the backlog it held is dispatched by the dispatch thread
            fit.join()
        warmed = self._resolve_warm_set(warm_set)
        t0 = time.perf_counter()
        if self._sharded is not None:
            return self._install_on_mesh(params, opt_state, version, warmed)
        mirror = None
        if self._host_scorer is not None:
            mirror = self._host_scorer.meta_model().to_empty(device=torch.device("cpu"))
            mirror.load_state_dict(params)
            mirror.requires_grad_(False)
        mirror_s = time.perf_counter() - t0
        result: Dict[str, Any] = {"swapped": True, "version": int(version),
                                  "prewarmed_buckets": warmed, "backend": self._obs_backend}
        with self._ledger.context(where="model_swap", backend=self._obs_backend,
                                  expected=True):
            with self._fit_lock, self._warm.lock:
                if self._int8w:
                    # the gate below judges the new float weights: the old
                    # int8 state stops serving (no replay runs meanwhile)
                    self._qstate = None
                t1 = time.perf_counter()
                with torch.no_grad():
                    live = self._model.state_dict()
                    for key, tensor in live.items():
                        tensor.copy_(params[key])
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                copy_s = time.perf_counter() - t1
                self._optimizer.load_state_dict(opt_state)
                if mirror is not None:
                    self._host_model = mirror
                self._model_version = int(version)
                kind = self._serve_kind()
                for bucket in warmed:
                    if bucket not in self._device_warm:
                        with self._ledger.context(bucket=bucket):
                            self._warm.capture(kind, bucket, self._zero_upload(bucket))
                        self._device_warm.add(bucket)
                if self._int8w:
                    result["int8"] = self._activate_int8(where="install")
        result["install"] = {"copy_s": copy_s, "mirror_s": mirror_s}
        return result

    def _install_on_mesh(self, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
                         version: int, warmed: List[int]) -> Dict[str, Any]:
        """``install_candidate`` in mesh mode: the candidate is copied into
        every row's placed weights in place (no graph goes stale), then the
        warm set grows by the stored spec's buckets; ``int8w`` re-gates."""
        result: Dict[str, Any] = {"swapped": True, "version": int(version),
                                  "prewarmed_buckets": warmed, "backend": self._obs_backend}
        with self._ledger.context(where="model_swap", backend=self._obs_backend,
                                  expected=True):
            with self._fit_lock, self._warm.lock:
                if self._int8w:
                    self._set_qstate(None)
                t1 = time.perf_counter()
                self._sharded.install_params(params, opt_state)
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                copy_s = time.perf_counter() - t1
                self._model_version = int(version)
                kind = self._serve_kind()
                for bucket in warmed:
                    if bucket not in self._device_warm:
                        with self._ledger.context(bucket=bucket):
                            self._warm.capture(kind, bucket, self._zero_upload(bucket))
                        self._device_warm.add(bucket)
                if self._int8w:
                    result["int8"] = self._activate_int8(where="install")
        result["install"] = {"copy_s": copy_s, "mirror_s": 0.0}
        return result

    def save_params_checkpoint(self, directory: str, params: Dict[str, torch.Tensor],
                               opt_state: Dict[str, Any]) -> None:
        """Persist an EXPLICIT state dict (a rollout candidate) with this
        detector's state metadata: the versioned store's twin of
        ``save_checkpoint``, which persists the live weights."""
        save_scorer_state(directory, params, opt_state, self.state_dict(),
                          tree_version=MODEL_TREE_VERSIONS.get(self.config.model, 1))

    def load_params_checkpoint(self, directory: str):
        """A stored version's ``(params, opt_state, meta)`` on the detector's
        device, NOT installed (promote-by-version and rollback load through
        here, then ``install_candidate``)."""
        self._ensure_scorer()
        return load_scorer_state(
            directory, map_location=self._device,
            accepted_tree_versions=COMPATIBLE_TREE_VERSIONS.get(self.config.model, {1}))

    # -- runtime reconfigure --------------------------------------------
    def validate_reconfigure(self, new_config) -> None:
        """Veto changes that need a rebuilt model or a refit."""
        super().validate_reconfigure(new_config)
        frozen = ("model", "vocab_size", "seq_len", "dim", "depth", "heads",
                  "score_topk", "score_vocab", "score_norm", "mesh_shape",
                  "attn_impl", "dtype", "head_impl", "device")
        for field in frozen:
            if getattr(new_config, field) != getattr(self.config, field):
                raise LibraryError(
                    f"{field!r} cannot change at runtime (old="
                    f"{getattr(self.config, field)!r} new="
                    f"{getattr(new_config, field)!r}); restart the service")

    def apply_config(self) -> None:
        """Re-read the batching deadline and target, and re-derive the
        threshold: an explicit score_threshold wins; a new threshold_sigma
        recomputes from the stored calibration stats."""
        super().apply_config()
        self._validate_static_config()
        # batching knobs apply live: held rows keep their arrival stamps; a
        # deadline turned off drains on the next pump (reason "flush")
        if self._coalescer is not None and self.config.batch_deadline_ms > 0:
            self._coalescer.deadline_s = self.config.batch_deadline_ms / 1000.0
            self._coalescer.target_occupancy = self.config.batch_target_occupancy
        if self.config.score_threshold is not None:
            self._threshold = float(self.config.score_threshold)
        elif self._calib_stats is not None:
            mean, std = self._calib_stats
            self._threshold = float(mean + self.config.threshold_sigma * std)
        elif not self._fitted:
            self._threshold = None
        else:
            logger.warning("reconfigure: no stored calibration stats; threshold stays %r",
                           self._threshold)

    # -- state checkpointing --------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The detector state ``meta.json`` carries, key for key the JAX
        detector's."""
        state = {
            "trained": self._trained,
            "threshold": self._threshold,
            "fitted": self._fitted,
            "calib_stats": None if self._calib_stats is None else list(self._calib_stats),
            "norm_mu": None if self._norm_mu is None else self._norm_mu.tolist(),
            "norm_sigma": None if self._norm_sigma is None else self._norm_sigma.tolist(),
        }
        # the candidate-vocab subset is persisted and reused verbatim: numpy's
        # Generator stream is not promised stable across numpy versions
        cand = getattr(self._scorer, "_cand_cache", None)
        if cand is not None:
            state["cand_key"] = list(cand[0])
            state["cand_ids"] = cand[1].tolist()
        return state

    def save_checkpoint(self, directory: str) -> None:
        """Persist the float weights, the optimizer state and
        ``state_dict()`` (``utils/checkpoint.py``)."""
        self._ensure_scorer()
        # a boundary fit mutates weights and threshold concurrently: land it
        # first so the checkpoint is a consistent post-fit snapshot
        self._finish_fit(wait=True)
        if self._sharded is not None:
            # the first row's weights; the optimizer state is a one-device one
            params = self._sharded.state_dict()
            opt_state = self._sharded.optimizer.state_dict()
        else:
            params, opt_state = self._model.state_dict(), self._optimizer.state_dict()
        save_scorer_state(directory, params, opt_state, self.state_dict(),
                          tree_version=MODEL_TREE_VERSIONS.get(self.config.model, 1))

    def load_checkpoint(self, directory: str) -> None:
        """Restore a ``save_checkpoint`` directory, branch for branch as the
        JAX detector restores its own."""
        self._ensure_scorer()
        params, opt_state, meta = load_scorer_state(
            directory, map_location=self._device,
            accepted_tree_versions=COMPATIBLE_TREE_VERSIONS.get(self.config.model, {1}))
        if self._sharded is not None:
            self._sharded.install_params(params, opt_state)
        else:
            self._model.load_state_dict(params)
            self._optimizer.load_state_dict(opt_state)
        self._trained = int(meta.get("trained", 0))
        self._fitted = bool(meta.get("fitted", False))
        cand_key, cand_ids = meta.get("cand_key"), meta.get("cand_ids")
        if cand_key is not None and cand_ids is not None:
            # reuse the checkpointed subset verbatim, on the host copy too
            cache = (tuple(cand_key), np.asarray(cand_ids, np.int32))
            self._scorer._cand_cache = cache
            if self._host_scorer is not None:
                self._host_scorer._cand_cache = cache
        stats = meta.get("calib_stats")
        self._calib_stats = None if stats is None else (float(stats[0]), float(stats[1]))
        mu, sigma = meta.get("norm_mu"), meta.get("norm_sigma")
        # the checkpointed threshold is in the units it was calibrated in
        # (z-scores with norm statistics, raw NLL without): across a
        # norm-mode change it is discarded (fail open) unless config overrides
        norm_mismatch = (mu is not None) != (self.config.score_norm == "position")
        if self.config.score_norm == "position":
            self._set_norm(None if mu is None else np.asarray(mu, np.float32),
                           None if sigma is None else np.asarray(sigma, np.float32))
        else:
            self._set_norm(None, None)
        if self.config.score_threshold is not None:
            self._threshold = self.config.score_threshold
        else:
            thr = meta.get("threshold")
            if thr is not None and norm_mismatch:
                logger.warning(
                    "checkpoint norm calibration (%s) does not match config "
                    "score_norm=%r: discarding the checkpointed threshold "
                    "(alerts disabled until reconfigured or refitted)",
                    "present" if mu is not None else "absent", self.config.score_norm)
                self._threshold = float("inf")
            elif thr is not None:
                self._threshold = float(thr)
            elif self._fitted:
                self._threshold = float("inf")
            else:
                # unfitted checkpoint: the next fit recalibrates
                self._threshold = None
        if self._int8w and self._fitted:
            # re-quantize from the restored float weights (int8 is a serving
            # representation); without a parity corpus the install is ungated
            self._activate_int8(where="restore")
        self._sync_host_params()
