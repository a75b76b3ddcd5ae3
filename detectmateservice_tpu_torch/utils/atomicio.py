"""Crash-atomic filesystem primitives (dependency-free).

The port's own copy of ``detectmateservice_tpu/utils/atomicio.py``: the
temp file + fsync + ``os.replace`` + directory fsync commit that the
checkpoint meta uses. The reference's fault-injection hook is not carried
over; the port has no fault injector yet.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict


def fsync_dir(directory: Path) -> None:
    """fsync a directory so a just-created/renamed/removed entry survives a
    power loss (the rename itself is atomic; its durability needs this)."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_atomic(path: Path, doc: Dict[str, Any]) -> None:
    """Durably replace ``path`` with ``doc``: write a temp sibling, fsync
    it, ``os.replace`` onto the final name, fsync the directory. The replace
    is the commit point: a reader (or a post-crash restart) sees either the
    old document or the new one, never a torn write."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    data = json.dumps(doc, indent=0, sort_keys=True)
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
