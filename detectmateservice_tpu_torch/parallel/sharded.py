"""ShardedScorer: a scorer driven over a device mesh by one process.

Counterpart of ``detectmateservice_tpu/parallel/sharded.py`` (BASELINE
config #5: one process drives every device instead of one process per
device). The JAX class hands its shardings to ``jit`` and lets GSPMD insert
the collectives; here the single controller does each step itself:

* **Placement.** ``shardings`` is ``tree_shardings`` of the rules
  (``mesh.LOGBERT_RULES`` for LogBERT), the layout the JAX mesh gives each
  leaf. With a ``model`` axis of m > 1 and a scorer that runs over model
  shards (LogBERT, its heads and width divisible by m), it is applied: in
  each data row a leaf the rules split is m slices (``mesh.split_leaf``),
  slice j on the row's device at ``model`` j, and a replicated leaf is one
  whole tensor on the row's first device. Otherwise every leaf is whole on
  the row's first device. The ``seq`` axis holds no weights (it runs the
  ring's blocks).
* **Forward.** The batch pads to a multiple of the data rows and splits
  over them. A row runs the scorer on its weights: over its model shards
  through ``scorer.model_over_shards`` (``models/logbert.py``
  ``LogBERTOverShards``: column- and row-parallel matmuls, attention of
  each shard's heads through the path's kernel, the head's E joined and
  kernel 1 run once on the row's first device), or whole through
  ``torch.func.functional_call`` on a skeleton of the module; with a
  ``seq`` axis its attention runs as a ring over the row's ``seq`` devices
  (``ops/attention.ring_context``). The rows' results are gathered onto
  the mesh's first device. Weight-only int8 serves whole dequantized
  weights on each row's first device, split or not.
* **Training.** One step draws its mask over the whole padded batch and
  counts the batch's loss denominator (``loss_count``); each row then runs
  forward and backward on its ``loss_sum`` over that one denominator, so a
  row weighs what it weighs in the JAX step's mean over the global batch
  (padding rows repeat real rows, as in JAX) and only one row's
  activations are alive at a time. The first row's slices take the
  gradient sum over every row, slice by slice (the reduction over
  ``data``), one AdamW step updates them, and the other rows copy the
  result in place. AdamW is elementwise, so a step on the slices is the
  step on the whole leaf; the optimizer's ``state_dict`` joins the slices'
  moments into a one-device optimizer's layout (and ``load_state_dict``
  splits them), and ``state_dict`` joins the weights, so a checkpoint
  moves between a mesh and one device as it is.
* **The capture map** (JAX's AOT executables): one CUDA-graph warm set per
  data row (``graphs.WarmSet`` on the row's first device, one lock for
  all), behind ``MeshWarmSet``, which has the warm set's surface for the
  detector; a row's graph holds the work of all its model shards. Every
  graph reads the weights by address; installs and steps write them in
  place.

A row whose ``seq`` or ``model`` shards sit on other GPUs than its first
one copies between GPUs inside its graph; that, and a mesh across
processes, are not proven yet (``ROADMAP.md``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import device_obs
from ..library.detectors.graphs import WarmSet
from ..models import quant
from ..models.base import ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY, widen_tokens
from ..models.tokenizer import narrow_tokens
from ..ops.attention import ring_context
from .mesh import (AXIS_DATA, AXIS_MODEL, AXIS_SEQ, LOGBERT_RULES, REPLICATED_RULES, P, Mesh,
                   join_leaf, make_mesh, split_dim, split_leaf, tree_shardings)


class _RowModule(torch.nn.Module):
    """``forward(op, *args)`` is ``scorer.<op>(model, *args)`` on a skeleton
    of the scorer's module on the meta device; ``functional_call`` supplies
    a row's weights (keys ``model.<state_dict key>``) for one call."""

    def __init__(self, scorer) -> None:
        super().__init__()
        self.scorer = scorer
        self.model = scorer.meta_model()

    def forward(self, op: str, *args):
        return getattr(self.scorer, op)(self.model, *args)


class _RowLedger:
    """A row warm set records nothing; ``MeshWarmSet`` records one capture
    per mesh bucket."""

    @staticmethod
    def record_compile(*_args, **_kwargs) -> None:
        return None


class MeshWarmSet:
    """The warm set's surface (``graphs.WarmSet``) over one warm set per
    data row: a (kind, bucket) entry is each row's graph of its
    ``bucket / rows`` slice (the bucket padded to a multiple of the rows
    first). One lock covers every row's captures and replays."""

    def __init__(self, sharded: "ShardedScorer", ledger, backend: str,
                 owner_ok: Callable[[], bool]) -> None:
        self._ledger = ledger
        self._backend = backend
        self._lock = threading.RLock()
        self.device = sharded.mesh.lead
        self.cuda = self.device.type == "cuda"
        self.rows = [WarmSet(sharded.row_device(d), _RowLedger(), backend,
                             eager=(lambda kind, t, d=d: sharded.row_eager(d, kind, t)),
                             ident=sharded.graph_ident, owner_ok=owner_ok, lock=self._lock)
                     for d in range(sharded.data_parallelism)]
        self._keys: Dict[Tuple[str, int], int] = {}      # (kind, bucket) -> row bucket
        self.replays: Dict[Tuple[str, int], int] = Counter()
        self.captures = 0

    @property
    def lock(self) -> threading.RLock:
        return self._lock

    @property
    def replay_launches(self) -> Dict[str, int]:
        total: Counter = Counter()
        for row in self.rows:
            total.update(row.replay_launches)
        return total

    def _row_bucket(self, bucket: int) -> int:
        return -(-bucket // len(self.rows))

    def _slices(self, host_tokens: torch.Tensor) -> List[torch.Tensor]:
        """The rows' slices of a [bucket, S] upload, zero-padded (PAD) to a
        multiple of the rows."""
        rb = self._row_bucket(int(host_tokens.shape[0]))
        pad = rb * len(self.rows) - int(host_tokens.shape[0])
        if pad:
            zeros = torch.zeros((pad,) + tuple(host_tokens.shape[1:]), dtype=host_tokens.dtype)
            host_tokens = torch.cat([host_tokens, zeros])
            if self.cuda:
                host_tokens = host_tokens.pin_memory()
        return [host_tokens[d * rb:(d + 1) * rb] for d in range(len(self.rows))]

    def keys(self) -> List[Tuple[str, int]]:
        with self._lock:
            return sorted(self._keys)

    def has(self, kind: str, bucket: int) -> bool:
        with self._lock:
            rb = self._keys.get((kind, bucket))
            return rb is not None and all(row.has(kind, rb) for row in self.rows)

    def capture(self, kind: str, bucket: int, host_tokens: torch.Tensor) -> None:
        """Capture (kind, bucket) on every row, one ledger entry for all."""
        t0 = time.perf_counter()
        with self._lock:
            rb = self._row_bucket(bucket)
            self._keys.pop((kind, bucket), None)
            for row, part in zip(self.rows, self._slices(host_tokens)):
                row.capture(kind, rb, part)
            self._keys[(kind, bucket)] = rb
            self.captures += 1
        self._ledger.record_compile(time.perf_counter() - t0, bucket=bucket,
                                    backend=self._backend)

    def run(self, kind: str, host_tokens: torch.Tensor) -> torch.Tensor:
        """[bucket] scores on the mesh's first device: each row replays its
        slice, the rows' scores gathered (captured first if missing or
        stale)."""
        bucket = int(host_tokens.shape[0])
        if not self.has(kind, bucket):
            self.capture(kind, bucket, host_tokens)
        with self._lock:
            outs = [row.run(kind, part)
                    for row, part in zip(self.rows, self._slices(host_tokens))]
            self.replays[(kind, bucket)] += 1
            return torch.cat([o.to(self.device) for o in outs])[:bucket]

    def drop(self, bucket: int) -> None:
        """Drop every entry of ``bucket``; a row graph goes only when no
        other bucket's entry shares it."""
        with self._lock:
            for key in [k for k in self._keys if k[1] == bucket]:
                rb = self._keys.pop(key)
                if not any(k[0] == key[0] and v == rb for k, v in self._keys.items()):
                    for row in self.rows:
                        with row.lock:
                            row._entries.pop((key[0], rb), None)

    def stale(self) -> List[Tuple[str, int]]:
        with self._lock:
            return sorted(k for k, rb in self._keys.items()
                          if not all(row.has(k[0], rb) for row in self.rows))


class SlicedAdamW:
    """AdamW (``optax.adamw``'s defaults, as ``ScorerBase.make_optimizer``)
    over the first data row's slices, whose ``state_dict`` is a one-device
    optimizer's over the whole leaves in ``state_dict`` order: each leaf's
    moments are its slices' joined (``load_state_dict`` splits them)."""

    def __init__(self, slices: Dict[str, List[torch.Tensor]], specs: Dict[str, P],
                 lr: float) -> None:
        self._slices = slices
        self._specs = specs
        self.inner = torch.optim.AdamW([t for parts in slices.values() for t in parts], lr=lr,
                                       betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                       weight_decay=ADAMW_WEIGHT_DECAY)

    def step(self) -> None:
        self.inner.step()

    def _positions(self) -> List[Tuple[str, List[int]]]:
        """Each key with the inner optimizer's indices of its slices."""
        out, pos = [], 0
        for key, parts in self._slices.items():
            out.append((key, list(range(pos, pos + len(parts)))))
            pos += len(parts)
        return out

    def state_dict(self) -> Dict[str, Any]:
        inner = self.inner.state_dict()
        state = {}
        with torch.no_grad():
            for i, (key, idx) in enumerate(self._positions()):
                entries = [inner["state"].get(j) for j in idx]
                if any(e is None for e in entries):
                    continue
                state[i] = {name: (join_leaf([e[name] for e in entries], self._specs[key])
                                   if torch.is_tensor(value) and value.dim() > 0 else value)
                            for name, value in entries[0].items()}
        groups = [dict(g, params=list(range(len(self._slices)))) for g in inner["param_groups"]]
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        state, total = {}, 0
        for i, (key, idx) in enumerate(self._positions()):
            total += len(idx)
            entry = state_dict["state"].get(i)
            if entry is None:
                continue
            pieces = {name: (split_leaf(value, self._specs[key], len(idx))
                             if torch.is_tensor(value) and value.dim() > 0 else [value] * len(idx))
                      for name, value in entry.items()}
            for n, j in enumerate(idx):
                state[j] = {name: parts[n] for name, parts in pieces.items()}
        groups = [dict(g, params=list(range(total))) for g in state_dict["param_groups"]]
        self.inner.load_state_dict({"state": state, "param_groups": groups})


class ShardedScorer:
    """A scorer (``MLPScorer`` / ``GRUScorer`` / ``LogBERTScorer``) placed on
    a mesh. ``score(tokens)`` and ``train_step(tokens)`` own the placed
    weights and the optimizer, so callers just stream batches."""

    def __init__(self, scorer, mesh: Optional[Mesh] = None,
                 rules: Optional[Sequence] = None,
                 generator: Optional[torch.Generator] = None,
                 owner_ok: Callable[[], bool] = lambda: True,
                 ledger: Optional[device_obs.CompileLedger] = None) -> None:
        self.scorer = scorer
        self.mesh = mesh if mesh is not None else make_mesh()
        if rules is None:
            rules = LOGBERT_RULES if getattr(scorer, "name", "") == "logbert" else REPLICATED_RULES
        self._seq_axis = AXIS_SEQ if AXIS_SEQ in self.mesh.shape else None
        if self._seq_axis is not None:
            seq_size = int(self.mesh.shape[AXIS_SEQ])
            seq_len = getattr(getattr(scorer, "config", None), "seq_len", None)
            if seq_len is not None and seq_len % seq_size != 0:
                raise ValueError(
                    f"seq_len {seq_len} must divide by the seq mesh axis "
                    f"({seq_size}) for sequence-parallel scoring")
        self._vocab_size = getattr(getattr(scorer, "config", None), "vocab_size", 1 << 31)
        self._data_axis = AXIS_DATA if AXIS_DATA in self.mesh.shape else None
        dp = int(self.mesh.shape.get(AXIS_DATA, 1))
        self._devices = [self.mesh.device_at(**{AXIS_DATA: d}) for d in range(dp)]
        # each data row's own mesh: its ring runs over that row's seq axis
        self._row_meshes = [self.mesh.take(AXIS_DATA, d) if self._data_axis else self.mesh
                            for d in range(dp)]
        self._ledger = ledger if ledger is not None else device_obs.get_ledger()
        lead = self.mesh.lead
        with self._ledger.context(where="sharded_init", backend="mesh", expected=True):
            model = scorer.init_model(lead, generator)
        state = model.state_dict()
        self.shardings = tree_shardings(self.mesh, state, rules)
        self.model_parallelism = int(self.mesh.shape.get(AXIS_MODEL, 1))
        self._split = self._splits(scorer, state)
        # the spec each leaf is placed by: the rules' on a split mesh
        self._specs = {k: (self.shardings[k].spec if self._split else P()) for k in state}
        # rows[d][key]: data row d's slices of each weight (one for a whole
        # leaf), slice j on the row's device at model j
        self._rows = [{k: [piece.detach().to(dev, copy=True).contiguous().requires_grad_(True)
                           for piece, dev in zip(self._slice(k, v), self._shard_devices(d))]
                       for k, v in state.items()} for d in range(dp)]
        del model, state
        self.linear_keys = quant.linear_weight_keys(scorer.meta_model())
        self._rowmods = [_RowModule(scorer) for _ in range(dp)]
        self._lock = threading.RLock()
        self._norm_rows: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        # weight-only int8 serving: each row's (q, scale) leaves while the
        # detector's gate lets them serve
        self._qrows: Optional[List[Dict[str, quant.QuantLeaf]]] = None
        self.optimizer = self._make_optimizer()
        self.warm = MeshWarmSet(self, self._ledger, "mesh", owner_ok)

    # -- placement -------------------------------------------------------
    @property
    def data_parallelism(self) -> int:
        return int(self.mesh.shape.get(AXIS_DATA, 1))

    def row_device(self, d: int) -> torch.device:
        """Data row d's first device: where its forward runs."""
        return self._devices[d]

    def _splits(self, scorer, state: Dict[str, torch.Tensor]) -> bool:
        """Whether the rows hold the ``model`` axis's slices: an axis of
        more than one shard, a scorer that runs over model shards, heads
        and width that divide, and a leaf the rules split."""
        m = self.model_parallelism
        cfg = getattr(scorer, "config", None)
        return (m > 1 and callable(getattr(scorer, "model_over_shards", None))
                and getattr(cfg, "heads", 0) % m == 0 and getattr(cfg, "dim", 0) % m == 0
                and any(split_dim(self.shardings[k].spec) is not None for k in state))

    @property
    def split(self) -> bool:
        """Whether the ``model`` axis computes (the rows hold slices)."""
        return self._split

    def _shard_devices(self, d: int) -> List[torch.device]:
        """Data row d's devices along ``model`` (its first alone when the
        rows hold whole weights)."""
        if not self._split:
            return [self._devices[d]]
        return [self.mesh.device_at(**{AXIS_DATA: d, AXIS_MODEL: j})
                for j in range(self.model_parallelism)]

    def _slice(self, key: str, whole: torch.Tensor) -> List[torch.Tensor]:
        return split_leaf(whole, self._specs[key], self.model_parallelism)

    def _make_optimizer(self) -> SlicedAdamW:
        """AdamW over the first row's slices; its state is a one-device
        optimizer's."""
        return SlicedAdamW(self._rows[0], self._specs, self.scorer.config.learning_rate)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights, each leaf whole: the first row's slices joined on
        the mesh's first device (a whole leaf is the stored tensor)."""
        with torch.no_grad():
            return {k: join_leaf(parts, self._specs[k]) for k, parts in self._rows[0].items()}

    def shard_bytes(self) -> Dict[str, Any]:
        """The bytes of the leaves the rules split: the whole leaves', and
        what each (data row, model shard) holds of them."""
        split = [k for k in self._rows[0] if split_dim(self._specs[k]) is not None]
        whole = sum(t.nbytes for k in split for t in self._rows[0][k])
        held = [[sum(self._rows[d][k][j].nbytes for k in split)
                 for j in range(len(self._shard_devices(d)))]
                for d in range(self.data_parallelism)]
        return {"split_leaves": len(split), "whole": int(whole), "per_shard": held}

    def install_params(self, params: Dict[str, torch.Tensor],
                       opt_state: Optional[Dict[str, Any]] = None) -> None:
        """Hot-swap the served weights (model rollout, a restore): copied
        into the placed tensors in place, so every captured graph stays
        valid; ``opt_state`` (a one-device optimizer's) is loaded, or the
        moments restart from zero without one."""
        with self._lock, torch.no_grad():
            for row in self._rows:
                for key, parts in row.items():
                    for t, piece in zip(parts, self._slice(key, params[key])):
                        t.copy_(piece)
            if opt_state is not None:
                self.optimizer.load_state_dict(opt_state)
            else:
                self.optimizer = self._make_optimizer()

    # -- weight-only int8 serving -------------------------------------------
    def install_quantized(self, qstate: Dict[str, quant.QuantLeaf]) -> None:
        """Serve a quantized state (``models/quant.quantize`` of the live
        weights): a whole copy on each row's device, like the float
        weights. The graphs captured on the float weights go stale."""
        self._qrows = [{key: tuple(t.to(dev, copy=True).contiguous() for t in leaf)
                        for key, leaf in qstate.items()} for dev in self._devices]

    def clear_quantized(self) -> None:
        """Back to the float weights."""
        self._qrows = None

    def graph_ident(self, kind: str) -> Any:
        """The weights a graph of ``kind`` reads that a swap replaces rather
        than overwrites: the int8 state while it serves (the calibration
        pass scores the float weights)."""
        return None if kind == "token_nlls" else self._qrows

    # -- scoring -------------------------------------------------------------
    @property
    def norm_rows(self) -> Optional[List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Each data row's (mu, sigma) buffers, once set."""
        return self._norm_rows

    def set_norm(self, mu, sigma) -> None:
        """The position-norm statistics on every row's device, copied into
        the buffers the normscore graphs read."""
        mu = torch.as_tensor(np.asarray(mu, np.float32))
        sigma = torch.as_tensor(np.asarray(sigma, np.float32))
        if self._norm_rows is None or self._norm_rows[0][0].shape != mu.shape:
            self._norm_rows = [(torch.empty(mu.shape, device=self.row_device(d)),
                                torch.empty(sigma.shape, device=self.row_device(d)))
                               for d in range(self.data_parallelism)]
        for m_buf, s_buf in self._norm_rows:
            m_buf.copy_(mu)
            s_buf.copy_(sigma)

    def _leaves(self, d: int, quantized: bool) -> Dict[str, torch.Tensor]:
        leaves = (quant.dequantize(self._qrows[d], self.scorer.config.dtype) if quantized
                  else {k: parts[0] for k, parts in self._rows[d].items()})
        return {f"model.{k}": v for k, v in leaves.items()}

    def _row_call(self, d: int, op: str, *args, quantized: bool = False):
        """``scorer.<op>`` on data row d's weights: over its model shards
        when the rows hold slices, else whole on its first device; with its
        ring over the row's seq devices."""
        ctx = (ring_context(self._row_meshes[d], batch_axis=None, axis_name=self._seq_axis)
               if self._seq_axis is not None else contextlib.nullcontext())
        with self._lock, ctx:
            if self._split and not quantized:
                return getattr(self.scorer, op)(self.scorer.model_over_shards(self._rows[d]),
                                                *args)
            return torch.func.functional_call(self._rowmods[d], self._leaves(d, quantized),
                                              (op, *args))

    def row_eager(self, d: int, kind: str, tokens: torch.Tensor) -> torch.Tensor:
        """Row d's scores of its token slice (on its device) the way the
        mesh serves now, op by op: what its warm-set graph captures."""
        if kind == "token_nlls":
            return self._row_call(d, "token_nlls", tokens)
        quantized = self._qrows is not None
        if kind == "normscore":
            return self._row_call(d, "normscore", tokens, *self._norm_rows[d],
                                  quantized=quantized)
        return self._row_call(d, "score", tokens, quantized=quantized)

    def eager(self, kind: str, tokens: torch.Tensor) -> torch.Tensor:
        """[bucket] scores of device tokens, every row op by op, gathered on
        the mesh's first device (the yardstick a replay is held against)."""
        n = int(tokens.shape[0])
        dp = self.data_parallelism
        rb = -(-n // dp)
        if rb * dp != n:
            tokens = torch.cat([tokens, tokens.new_zeros((rb * dp - n,) + tuple(tokens.shape[1:]))])
        outs = [self.row_eager(d, kind, tokens[d * rb:(d + 1) * rb].to(self.row_device(d)))
                for d in range(dp)]
        return torch.cat([o.to(self.mesh.lead) for o in outs])[:n]

    def _pad_batch(self, tokens: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad the batch with PAD rows to a multiple of the data rows."""
        n = len(tokens)
        dp = self.data_parallelism
        padded = -(-n // dp) * dp
        if padded != n:
            tokens = np.concatenate([tokens, np.zeros((padded - n,) + tokens.shape[1:],
                                                      tokens.dtype)])
        return tokens, n

    def _upload(self, tokens: np.ndarray) -> torch.Tensor:
        """A host batch in the narrow wire format (pinned off the CPU)."""
        narrow = narrow_tokens(np.asarray(tokens), self._vocab_size)
        if narrow.dtype == np.uint16:
            narrow = narrow.view(np.int16)
        host = torch.from_numpy(np.ascontiguousarray(narrow))
        return host.pin_memory() if self.warm.cuda else host

    def _run(self, kind: str, tokens: np.ndarray) -> torch.Tensor:
        tokens, _ = self._pad_batch(np.asarray(tokens))
        with self._ledger.context(bucket=len(tokens), backend="mesh", where="sharded"):
            return self.warm.run(kind, self._upload(tokens))

    def score(self, tokens: np.ndarray) -> np.ndarray:
        n = len(tokens)
        return self.score_device(tokens).cpu().numpy()[:n]

    def score_device(self, tokens: np.ndarray) -> torch.Tensor:
        """Scores of [n, S] tokens, padded to the data rows, on the mesh's
        first device without waiting (rows past ``n`` are padding): the
        int8 state while it serves, through the bucket's graphs."""
        return self._run("score", tokens)

    def token_nlls_device(self, tokens: np.ndarray) -> torch.Tensor:
        """[n, S] → [n_padded, S] per-position NLLs (float weights)."""
        return self._run("token_nlls", tokens)

    def normscore_device(self, tokens: np.ndarray, mu, sigma) -> torch.Tensor:
        """Per-position-normalized scores (``models.base.positional_z_max``)."""
        self.set_norm(mu, sigma)
        return self._run("normscore", tokens)

    def warm_bucket(self, tokens: np.ndarray) -> None:
        """Capture the score path for this batch shape before its first
        dispatch, as an expected ``bucket_warm``."""
        tokens, _ = self._pad_batch(np.asarray(tokens))
        with self._ledger.context(bucket=len(tokens), backend="mesh", where="bucket_warm",
                                  expected=True):
            if not self.warm.has("score", len(tokens)):
                self.warm.capture("score", len(tokens), self._upload(tokens))

    def aot_compile_bucket(self, kind: str, tokens: np.ndarray, *extra) -> None:
        """Capture one (kind, bucket) entry of the map and keep it; the
        bucket pads to the data rows first, so the key is the padded shape
        every later call of this bucket produces."""
        if kind == "normscore":
            self.set_norm(*extra)
        tokens, _ = self._pad_batch(np.asarray(tokens))
        with self._ledger.context(bucket=len(tokens), backend="mesh", where="sharded"):
            self.warm.capture(kind, len(tokens), self._upload(tokens))

    def _aot_call(self, kind: str, batch: int, *args) -> Optional[torch.Tensor]:
        """The kept entry for (kind, batch) replayed on ``args[-1]``'s tokens
        (after ``mu, sigma`` for normscore: ``(tokens, mu, sigma)``), or None
        when absent."""
        if not self.warm.has(kind, batch):
            return None
        tokens = args[0]
        if kind == "normscore":
            self.set_norm(*args[1:3])
        return self.warm.run(kind, self._upload(tokens))

    # -- training ------------------------------------------------------------
    def train_step(self, tokens: np.ndarray, generator: Optional[torch.Generator] = None,
                   mask: Optional[np.ndarray] = None) -> float:
        """One step over the whole batch; returns its loss. A ragged batch
        pads by repeating real rows, NOT with PAD rows (an all-PAD row would
        teach the model that empty sequences are normal)."""
        tokens = np.asarray(tokens)
        n = len(tokens)
        dp = self.data_parallelism
        padded = -(-n // dp) * dp
        if padded != n:
            # modular repetition covers n < padded - n too
            idx = np.arange(padded) % n
            tokens = tokens[idx]
            mask = None if mask is None else np.asarray(mask)[idx]
        lead = self.mesh.lead
        upload = self._upload(tokens)
        whole = widen_tokens(upload.to(lead, non_blocking=True))
        if mask is None:
            whole_mask = self.scorer.draw_mask(whole, generator)
        else:
            whole_mask = torch.as_tensor(np.asarray(mask, bool), device=lead)
        rb = padded // dp
        rows = [slice(d * rb, (d + 1) * rb) for d in range(dp)]
        masks = [None if whole_mask is None else whole_mask[r] for r in rows]
        with self._lock:
            # the batch's denominator first, so each row's backward can
            # start at once (one row's activations alive at a time)
            count = torch.stack([self.scorer.loss_count(whole[r], m).to(lead)
                                 for r, m in zip(rows, masks)]).sum()
            count = torch.clamp(count, min=1.0)
            for row in self._rows:
                for parts in row.values():
                    for t in parts:
                        t.grad = None
            total = None
            for d, (r, m) in enumerate(zip(rows, masks)):
                dev = self.row_device(d)
                part = self._row_call(d, "loss_sum", whole[r].to(dev),
                                      None if m is None else m.to(dev))
                (part / count.to(dev)).backward()
                part = part.detach().to(lead)
                total = part if total is None else total + part
            loss = total / count
            self._reduce_grads()
            self.optimizer.step()
            self._broadcast_rows()
        return float(loss.detach())

    def _reduce_grads(self) -> None:
        """Each of the first row's slices takes the sum of every row's
        gradient of that slice."""
        for key, parts in self._rows[0].items():
            for j, t in enumerate(parts):
                for row in self._rows[1:]:
                    grad = row[key][j].grad
                    if grad is not None:
                        grad = grad.to(t.device)
                        t.grad = grad if t.grad is None else t.grad + grad

    @torch.no_grad()
    def _broadcast_rows(self) -> None:
        """Every other row copies the first row's stepped slices in place."""
        for row in self._rows[1:]:
            for key, parts in row.items():
                for dst, src in zip(parts, self._rows[0][key]):
                    dst.copy_(src)
                    dst.grad = None

    def __repr__(self) -> str:
        return f"ShardedScorer({self.scorer.name}, {self.mesh!r})"


def mesh_label(mesh: Mesh) -> str:
    """The device label a mesh-mode detector reports, as the JAX one."""
    return f"mesh({','.join(f'{k}={v}' for k, v in mesh.shape.items())})"

