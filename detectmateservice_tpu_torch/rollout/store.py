"""Versioned checkpoint store with an atomically-committed manifest.

The port's copy of ``detectmateservice_tpu/rollout/store.py``. The manifest
is the same document; each version directory is one of the port's own
``utils/checkpoint.save_scorer_state`` directories (torch tensors), so a
store that a JAX replica wrote cannot be promoted from here, nor this one
there.

Layout under ``rollout_dir``::

    MANIFEST.json        # the commit point (utils.atomicio.write_json_atomic)
    v000001/             # one utils.checkpoint save_scorer_state dir each
    v000002/
    ...

The manifest is the ONLY state the rest of the subsystem trusts: which
versions exist, which one is live, which (if any) is pinned, and each
version's metadata (model family, tree version, norm-calibration stats,
shadow-divergence verdict). It is replaced atomically with an fsync'd
temp-file + ``os.replace`` — the same discipline as the checkpoint meta —
so a crash mid-rotation can never leave a manifest naming a half-written
version: ``record`` is only called AFTER ``save_scorer_state`` committed
the version directory's own meta.

Keep-N pruning removes the oldest entries beyond ``keep`` — but never the
live version, never a pinned version, and never the newest candidate — so
rollback always has a target and an operator pin survives any amount of
churn. A shared filesystem makes the store the fleet-rollout vehicle:
every replica points its ``rollout_dir`` at the same root and each
promotes one version number (``POST /admin/model``).
"""
from __future__ import annotations

import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from ..utils.atomicio import write_json_atomic

MANIFEST = "MANIFEST.json"
_SCHEMA = "dmroll-manifest-v1"


class StoreError(RuntimeError):
    pass


class CheckpointStore:
    def __init__(self, root: str, keep: int = 4,
                 clock: Callable[[], float] = time.time) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1 (got {keep})")
        self.root = Path(root).absolute()
        self.keep = keep
        self._clock = clock
        self._lock = threading.Lock()
        self.root.mkdir(parents=True, exist_ok=True)

    # -- manifest ---------------------------------------------------------
    def _load(self) -> Dict[str, Any]:
        path = self.root / MANIFEST
        if not path.exists():
            return {"schema": _SCHEMA, "live_version": None,
                    "pinned_version": None, "entries": []}
        import json

        doc = json.loads(path.read_text(encoding="utf-8"))
        if doc.get("schema") != _SCHEMA:
            raise StoreError(
                f"manifest {path} has schema {doc.get('schema')!r}; this "
                f"build reads {_SCHEMA!r}")
        return doc

    def _write(self, doc: Dict[str, Any]) -> None:
        write_json_atomic(self.root / MANIFEST, doc)

    # -- versions ---------------------------------------------------------
    def version_dir(self, version: int) -> Path:
        return self.root / f"v{version:06d}"

    def allocate_version(self) -> int:
        """Next unused version number: one past the max of manifest entries
        and on-disk ``v*`` dirs (orphans from a crashed save included, so a
        retried save never reuses a dirty directory)."""
        with self._lock:
            doc = self._load()
            top = max((e["version"] for e in doc["entries"]), default=0)
            for entry in self.root.glob("v[0-9]*"):
                try:
                    top = max(top, int(entry.name[1:]))
                except ValueError:
                    continue
            return top + 1

    def record(self, version: int, meta: Dict[str, Any],
               status: str = "candidate") -> Dict[str, Any]:
        """Commit a fully-saved version into the manifest (atomic), then
        apply keep-N pruning. Caller guarantees ``save_scorer_state``
        already landed in ``version_dir(version)``.

        ``meta`` may carry a ``warm_set`` spec (the detector's
        ``warm_set_spec()``): install paths read it back so a promote on a
        restarted process captures the bucket set the recording boot
        warmed before cutover."""
        with self._lock:
            doc = self._load()
            entry = {
                "version": version,
                "dir": self.version_dir(version).name,
                "created_unix": self._clock(),
                "created_utc": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(self._clock())),
                "status": status,
                "meta": dict(meta),
            }
            doc["entries"] = [e for e in doc["entries"]
                              if e["version"] != version] + [entry]
            doc["entries"].sort(key=lambda e: e["version"])
            self._prune_locked(doc)
            self._write(doc)
            return entry

    def set_status(self, version: int, status: str,
                   **meta_updates: Any) -> None:
        with self._lock:
            doc = self._load()
            entry = self._entry_locked(doc, version)
            entry["status"] = status
            entry["meta"].update(meta_updates)
            self._write(doc)

    def update_meta(self, version: int, **meta_updates: Any) -> None:
        """Merge metadata into a version's manifest entry without touching
        its status — the dmdrift baseline-pinning path (``drift_baseline``
        rides the live entry so a restarted monitor resumes against the
        same reference distribution)."""
        with self._lock:
            doc = self._load()
            entry = self._entry_locked(doc, version)
            entry["meta"].update(meta_updates)
            self._write(doc)

    def set_live(self, version: int, **meta_updates: Any) -> None:
        """Mark ``version`` live (the dispatch path's params); the previous
        live entry becomes ``superseded`` — the natural rollback target."""
        with self._lock:
            doc = self._load()
            entry = self._entry_locked(doc, version)
            for other in doc["entries"]:
                if other["status"] == "live" and other is not entry:
                    other["status"] = "superseded"
            entry["status"] = "live"
            entry["meta"].update(meta_updates)
            doc["live_version"] = version
            self._write(doc)

    def pin(self, version: Optional[int]) -> None:
        """Pin a version (protect from pruning, block auto-promote past it);
        ``None`` lifts the pin."""
        with self._lock:
            doc = self._load()
            if version is not None:
                self._entry_locked(doc, version)  # must exist
            doc["pinned_version"] = version
            self._write(doc)

    def _entry_locked(self, doc: Dict[str, Any],
                      version: int) -> Dict[str, Any]:
        for entry in doc["entries"]:
            if entry["version"] == version:
                return entry
        raise StoreError(
            f"no checkpoint version {version} in {self.root / MANIFEST}; "
            f"known: {[e['version'] for e in doc['entries']]}")

    def _prune_locked(self, doc: Dict[str, Any]) -> None:
        entries = doc["entries"]
        protected = {doc.get("live_version"), doc.get("pinned_version")}
        if entries:
            protected.add(entries[-1]["version"])   # the newest stays
        keep: List[Dict[str, Any]] = []
        removable = [e for e in entries if e["version"] not in protected]
        excess = len(entries) - self.keep
        for entry in entries:
            if excess > 0 and entry in removable:
                shutil.rmtree(self.root / entry["dir"], ignore_errors=True)
                excess -= 1
            else:
                keep.append(entry)
        doc["entries"] = keep

    # -- read side --------------------------------------------------------
    def manifest(self) -> Dict[str, Any]:
        with self._lock:
            return self._load()

    def entry(self, version: int) -> Dict[str, Any]:
        with self._lock:
            return self._entry_locked(self._load(), version)

    def live_version(self) -> Optional[int]:
        with self._lock:
            return self._load().get("live_version")

    def pinned_version(self) -> Optional[int]:
        with self._lock:
            return self._load().get("pinned_version")

    def previous_live(self) -> Optional[int]:
        """The newest ``superseded`` entry — what rollback targets."""
        with self._lock:
            doc = self._load()
            superseded = [e["version"] for e in doc["entries"]
                          if e["status"] == "superseded"]
            return max(superseded) if superseded else None

    def history(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            entries = list(reversed(self._load()["entries"]))
            return entries[:limit] if limit else entries

    def newest_created_unix(self) -> Optional[float]:
        with self._lock:
            doc = self._load()
            if not doc["entries"]:
                return None
            return max(e["created_unix"] for e in doc["entries"])
