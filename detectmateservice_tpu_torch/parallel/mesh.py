"""Device-mesh construction and parameter-sharding rules.

Counterpart of ``detectmateservice_tpu/parallel/mesh.py``. There one
process drives every chip through a ``jax.sharding.Mesh`` and XLA inserts
the collectives. The port keeps that design in PyTorch's idiom: one process
(a single controller) holds a named-axis array of ``torch.device``s; a
tensor placed on the mesh is one torch tensor per shard, on that shard's
device; a collective is an explicit copy or reduction in this process
(``parallel/sharded.py``, ``parallel/ring.py``). ``torch.distributed``
joins processes only (``parallel/distributed.py``). Axes:

* ``data``  — batch (replica) parallelism for the scorer hot path,
* ``model`` — the weights' Megatron-style split (``LOGBERT_RULES``),
* ``seq``   — sequence parallelism (ring attention, ``parallel/ring.py``).

The devices come from ``local_devices``, the one place that lists them:
every local CUDA device, or the host for a CPU component. A caller may pass
its own list, repeats included (eight shards of ``cuda:0`` give the
sharding, the ring and the reductions on one card, as eight virtual CPU
devices do for the JAX package's tests). A mesh that needs more devices than
it is given raises ``ValueError``, as the JAX one does. A mesh spanning
processes does not exist yet: under a live process group of more than one
rank ``make_mesh`` raises.

The rules match the port's ``state_dict`` names (``models/convert.py`` maps
the flax paths onto them). A ``Linear`` weight is stored ``[out, in]`` where
the flax kernel is ``[in, out]``, so its partition spec is the transpose of
the JAX rule's. ``split_leaf`` cuts a leaf into the slices its spec gives
the shards of an axis (shard j's slice is what the JAX array's shard at
that mesh position holds), and ``join_leaf`` puts them back together.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"

# what lifts the one-process limit (ROADMAP.md, queue 1)
CROSS_PROCESS_ITEM = "ROADMAP.md queue 1: a mesh across processes or hosts"


class P(tuple):
    """A partition spec: one mesh axis name (or None, replicated) per
    tensor dimension; trailing dimensions not named are replicated."""

    def __new__(cls, *axes: Optional[str]) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Mesh:
    """A named-axis array of ``torch.device``s (``devices[i, j, ...]`` is the
    device of the shard at those coordinates)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device of the first shard: where a gathered result lands."""
        return self.devices.flat[0]

    def device_at(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (an axis not named, or
        not in the mesh, at 0)."""
        index = tuple(int(coords.get(name, 0)) for name in self.axis_names)
        return self.devices[index]

    def take(self, axis: str, index: int) -> "Mesh":
        """The mesh at ``index`` along ``axis``, without that axis (a data
        row's own mesh)."""
        pos = self.axis_names.index(axis)
        names = self.axis_names[:pos] + self.axis_names[pos + 1:]
        picked = np.take(self.devices, [index], axis=pos)
        return Mesh(picked.reshape(picked.shape[:pos] + picked.shape[pos + 1:]), names)

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        out: List[torch.device] = []
        for dev in self.devices.flat:
            if dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """The devices of this process a mesh may use: every local CUDA device
    (none without CUDA), or the host for ``"cpu"``."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[torch.device]] = None,
              device_type: str = "cuda") -> Mesh:
    """Build a mesh; default = every local device on the ``data`` axis."""
    if _world_size() > 1:
        raise ValueError(
            f"a mesh across {_world_size()} processes is not ported; this process's "
            f"devices make the mesh ({CROSS_PROCESS_ITEM})")
    devices = list(devices if devices is not None else local_devices(device_type))
    if not shape:
        shape = {AXIS_DATA: len(devices)}
    names = tuple(shape.keys())
    dims = tuple(int(v) for v in shape.values())
    total = int(np.prod(dims))
    if total != len(devices):
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    for i, dev in enumerate(devices):
        arr[i] = torch.device(dev)
    return Mesh(arr.reshape(dims), names)


# -- parameter partition rules ---------------------------------------------
# (state_dict-key regex, P); first match wins. Megatron-style: qkv and
# mlp_in split their output features, proj and mlp_out their input
# features (the transposes of the JAX package's kernel rules).
LOGBERT_RULES: List[Tuple[str, P]] = [
    (r"tok_embed\.weight$", P(None, AXIS_MODEL)),
    (r"pos_embed$", P()),
    (r"(qkv|mlp_in)\.weight$", P(AXIS_MODEL, None)),
    (r"(qkv|mlp_in)\.bias$", P(AXIS_MODEL)),
    (r"(proj|mlp_out)\.weight$", P(None, AXIS_MODEL)),
    (r"(proj|mlp_out)\.bias$", P()),
    (r".*", P()),
]

REPLICATED_RULES: List[Tuple[str, P]] = [(r".*", P())]


class NamedSharding:
    """A tensor's placement: its partition spec over ``mesh``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: P) -> None:
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


def partition_spec_for(path: str, rules: Sequence[Tuple[str, P]]) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return P()


def tree_shardings(mesh: Mesh, tree: Mapping[str, Any],
                   rules: Sequence[Tuple[str, P]]) -> Dict[str, Any]:
    """Map a ``state_dict`` (nested mappings allowed, their keys joined by
    ``.``) to ``NamedSharding``s through the rule table. A rule that names
    an axis the mesh lacks, or one that does not divide the dimension,
    replicates the tensor instead."""

    def _one(path: str, leaf: Any) -> NamedSharding:
        spec = partition_spec_for(path, rules)
        shape = tuple(getattr(leaf, "shape", ()))
        for dim, axis in zip(shape, tuple(spec) + (None,) * 8):
            if axis is None:
                continue
            if axis not in mesh.shape or dim % mesh.shape[axis] != 0:
                spec = P()
                break
        return NamedSharding(mesh, spec)

    def _walk(prefix: str, node: Mapping[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in node.items():
            path = f"{prefix}.{key}" if prefix else str(key)
            out[key] = _walk(path, value) if isinstance(value, Mapping) else _one(path, value)
        return out

    return _walk("", tree)


def split_dim(spec: P, axis: str = AXIS_MODEL) -> Optional[int]:
    """The tensor dimension ``spec`` splits over ``axis``, or None."""
    for dim, name in enumerate(spec):
        if name == axis:
            return dim
    return None


def split_leaf(leaf: torch.Tensor, spec: P, parts: int,
               axis: str = AXIS_MODEL) -> List[torch.Tensor]:
    """The ``parts`` contiguous slices of ``leaf`` along the dimension
    ``spec`` splits over ``axis`` (slice j for shard j of the axis), each
    its own contiguous tensor; ``[leaf]`` when the spec leaves the leaf
    whole on that axis. ``tree_shardings`` only names an axis that divides
    the dimension."""
    dim = split_dim(spec, axis)
    if dim is None:
        return [leaf]
    if leaf.shape[dim] % parts:
        raise ValueError(f"dimension {dim} of a {tuple(leaf.shape)} leaf does not divide "
                         f"into {parts} slices")
    return [piece.contiguous() for piece in torch.chunk(leaf, parts, dim=dim)]


def join_leaf(slices: Sequence[torch.Tensor], spec: P,
              axis: str = AXIS_MODEL) -> torch.Tensor:
    """The whole leaf from ``split_leaf``'s slices, on the first slice's
    device (a replicated leaf's one slice as it is)."""
    dim = split_dim(spec, axis)
    if dim is None or len(slices) == 1:
        return slices[0]
    return torch.cat([s.to(slices[0].device) for s in slices], dim=dim)


def batch_sharding(mesh: Mesh, axis: str = AXIS_DATA) -> NamedSharding:
    """Leading-dim batch sharding for activations and inputs."""
    return NamedSharding(mesh, P(axis))
