"""Checkpoint/restore of scorer params, optimizer state and detector state.

Counterpart of ``detectmateservice_tpu/utils/checkpoint.py`` with the port's
own format, and no orbax:

* ``params.<nonce>.pt`` (the model's ``state_dict``) and
  ``opt_state.<nonce>.pt`` (the optimizer's), each written by
  ``torch.save`` into a fresh nonce-named file and fsynced, read back by
  ``torch.load(..., weights_only=True, map_location=...)``;
* then the atomic ``meta.json`` commit (temp file + fsync + ``os.replace``
  + directory fsync, ``utils/atomicio.py``), which names the nonce it
  belongs to (``data_nonce``), so a loader only ever sees a fully written
  generation; a crash mid-save leaves the previous generation trusted and at
  most some orphaned nonce files;
* then pruning of every other generation, and of the legacy bare
  ``params``/``opt_state`` names, as the reference prunes.

``meta.json`` carries the detector state and a per-family ``tree_version``
(the JAX package's numbers); a version this build does not accept raises
``CheckpointFormatError`` before any tensor is read.

A checkpoint the JAX package wrote (orbax array trees) is not readable
here, and this format is not readable there: weights cross between the two
packages through ``models/convert.py``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from .atomicio import write_json_atomic

_META = "meta.json"

# param-tree layout versions per model family, the JAX package's: mlp
# restores from v1 and v2 stamps, gru and logbert from v2
MODEL_TREE_VERSIONS = {"mlp": 1, "gru": 2, "logbert": 2}
COMPATIBLE_TREE_VERSIONS = {"mlp": {1, 2}, "gru": {2}, "logbert": {2}}


class CheckpointFormatError(RuntimeError):
    """Checkpoint param-tree layout does not match this build."""


# saves are rare control-plane operations; serializing them keeps two
# concurrent callers from pruning each other's fresh generation
_SAVE_LOCK = threading.Lock()


def _save_durably(obj: Any, path: Path) -> None:
    with open(path, "wb") as fh:
        torch.save(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())


def _prune_stale_data(path: Path, keep_nonce: str) -> None:
    """Remove data generations other than ``keep_nonce``: older nonce files,
    orphans from crashed saves, and the legacy bare ``params``/``opt_state``
    names (safe only AFTER the meta commit landed)."""
    for entry in path.iterdir():
        name = entry.name
        if name in ("params", "opt_state") or (
                (name.startswith("params.") or name.startswith("opt_state."))
                and not name.endswith(keep_nonce + ".pt")):
            if entry.is_dir():
                shutil.rmtree(entry, ignore_errors=True)
            else:
                entry.unlink(missing_ok=True)


def save_scorer_state(directory: str, params: Dict[str, torch.Tensor],
                      opt_state: Dict[str, Any], meta: Dict[str, Any],
                      tree_version: int = 1) -> None:
    """Write a new generation (params, optimizer state), then commit
    ``meta`` naming it, then prune the others."""
    path = Path(directory).absolute()
    path.mkdir(parents=True, exist_ok=True)
    # fresh generation per save: the previous one stays intact and trusted
    # until the meta commit below atomically retargets the loader
    nonce = f"{os.getpid()}-{time.time_ns():x}"
    with _SAVE_LOCK:
        _save_durably(params, path / f"params.{nonce}.pt")
        _save_durably(opt_state, path / f"opt_state.{nonce}.pt")
        write_json_atomic(path / _META, {**meta, "tree_version": tree_version,
                                         "data_nonce": nonce})
        _prune_stale_data(path, keep_nonce=nonce)


def load_scorer_state(directory: str, map_location: Any = "cpu",
                      accepted_tree_versions=frozenset({1}),
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], Dict[str, Any]]:
    """(params, opt_state, meta) of the generation ``meta.json`` names,
    tensors placed by ``map_location``."""
    path = Path(directory).absolute()
    # meta first: a tree-version mismatch must produce an actionable error
    # before any tensor is read
    meta = json.loads((path / _META).read_text())
    found = meta.get("tree_version", 1)
    if found not in accepted_tree_versions:
        raise CheckpointFormatError(
            f"checkpoint at {path} has param-tree version {found}, this "
            f"build accepts {sorted(accepted_tree_versions)} for this model "
            "family; the module layout changed (param paths were renamed), "
            "so this checkpoint cannot be restored directly — refit the "
            "scorer, or migrate the checkpoint by renaming its param keys")
    nonce = meta["data_nonce"]
    params = torch.load(path / f"params.{nonce}.pt", weights_only=True,
                        map_location=map_location)
    opt_state = torch.load(path / f"opt_state.{nonce}.pt", weights_only=True,
                           map_location=map_location)
    return params, opt_state, meta
