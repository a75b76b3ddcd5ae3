"""Multi-process bootstrap: the seam that joins processes.

Counterpart of ``detectmateservice_tpu/parallel/distributed.py``. Within
one process the mesh is the single controller's (``parallel/mesh.py``,
``parallel/sharded.py``); to join processes the port starts a
``torch.distributed`` process group, the role ``jax.distributed`` plays for
the JAX package: ``init_process_group`` over ``tcp://<coordinator>``, NCCL
for a CUDA component and gloo for the CPU.

Wireup as in the JAX package: service settings carry the coordinator
address and the process coordinates, and ``DETECTMATE_COORDINATOR_ADDRESS``
/ ``DETECTMATE_NUM_PROCESSES`` / ``DETECTMATE_PROCESS_ID`` reach the same
fields through the settings env layer; they are also read here directly for
settings that left the fields unset. The coordinator's source decides the
coordinates' source. ``initialize_from_settings`` is idempotent and a no-op
without a coordinator (one process: the common case). A mesh that spans the
processes of a group is not ported: ``make_mesh`` refuses under a group of
more than one rank.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Optional

_initialized = False


def _backend(device_type: Optional[str]) -> str:
    """NCCL for a CUDA component, gloo for the CPU (``device_type`` None:
    CUDA when this process has a card)."""
    import torch

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_from_settings(settings: Optional[Any] = None,
                             logger: Optional[logging.Logger] = None,
                             device_type: Optional[str] = None) -> bool:
    """Start the process group from settings/env; returns whether it is
    (now) live. Safe to call several times.

    A settings-borne coordinator takes every coordinate from the settings;
    an env-borne one takes them from the env (the settings' 1/0 defaults
    cannot say "unset")."""
    global _initialized
    logger = logger or logging.getLogger(__name__)
    if _initialized:
        return True

    coordinator = (getattr(settings, "coordinator_address", None)
                   if settings is not None else None)
    if coordinator:
        num_processes = int(getattr(settings, "num_processes", 1) or 1)
        process_id = int(getattr(settings, "process_id", 0) or 0)
    else:
        coordinator = os.environ.get("DETECTMATE_COORDINATOR_ADDRESS") or None
        if coordinator is None:
            return False  # one process: nothing to do
        num_processes = int(os.environ.get("DETECTMATE_NUM_PROCESSES") or 1)
        process_id = int(os.environ.get("DETECTMATE_PROCESS_ID") or 0)

    import torch.distributed as dist

    backend = _backend(device_type)
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _initialized = True
    logger.info("torch.distributed initialized: process %d/%d via %s (%s)",
                process_id, num_processes, coordinator, backend)
    return True


def process_info() -> dict:
    """For /admin/status: this process's place among the processes, keys
    as in the JAX package. Importless until the group was started."""
    if not _initialized:
        return {"initialized": False, "process_index": 0,
                "process_count": 1, "local_devices": None}
    import torch
    import torch.distributed as dist

    return {
        "initialized": True,
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
    }
