"""The chip plane: the device mesh, sharded execution, ring attention and
the multi-process bootstrap.

Counterpart of ``detectmateservice_tpu/parallel``. Exports resolve lazily
(PEP 562): ``distributed`` imports nothing until a coordinator is set, so
a stage reads ``process_info`` through this package on every
/admin/status call without loading the scorer's modules.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "AXIS_DATA": "mesh",
    "AXIS_MODEL": "mesh",
    "AXIS_SEQ": "mesh",
    "LOGBERT_RULES": "mesh",
    "REPLICATED_RULES": "mesh",
    "batch_sharding": "mesh",
    "join_leaf": "mesh",
    "make_mesh": "mesh",
    "split_leaf": "mesh",
    "tree_shardings": "mesh",
    "initialize_from_settings": "distributed",
    "process_info": "distributed",
    "ring_attention": "ring",
    "ShardedScorer": "sharded",
}

__all__ = list(_EXPORTS)

if TYPE_CHECKING:  # static analyzers see the real symbols
    from .distributed import initialize_from_settings, process_info  # noqa: F401
    from .mesh import (  # noqa: F401
        AXIS_DATA,
        AXIS_MODEL,
        AXIS_SEQ,
        LOGBERT_RULES,
        REPLICATED_RULES,
        batch_sharding,
        join_leaf,
        make_mesh,
        split_leaf,
        tree_shardings,
    )
    from .ring import ring_attention  # noqa: F401
    from .sharded import ShardedScorer  # noqa: F401


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value
