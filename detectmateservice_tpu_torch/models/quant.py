"""Weight-only int8 quantization for the serving path (``dtype: int8w``).

Counterpart of ``detectmateservice_tpu/models/quant.py`` over the port's
``state_dict``s, in the JAX package's semantics, so the same leaves quantize
to the same payloads in both packages:

* a leaf is eligible when it is a float tensor with ndim ≥ 2 and at least
  ``QUANT_MIN_SIZE`` elements; the others (biases, norms, ``bos_embed``)
  pass through as they are;
* symmetric int8: per channel, ``scale = max(amax, 1e-8) / 127`` and
  ``q = clip(round(w / scale), -127, 127)`` with ``round`` half to even;
* the channel axis is flax's LAST axis. A ``Linear`` weight is stored
  [out, in] where the flax kernel is [in, out], so its channels are torch's
  axis 0 (``linear_weight_keys`` names those leaves); every other leaf keeps
  flax's layout, so an embedding [V, D] has one scale per D column, not per
  vocabulary row.

A quantized leaf is ``(q_int8, scale_fp32)``, the scale shaped to broadcast
against ``q`` (``[out, 1]`` for a ``Linear`` weight, ``[1, D]`` for an
embedding); a passthrough leaf is ``(w,)``, a copy of the float tensor, so
a later training step does not move it. ``dequantize`` is
``q.to(dtype) * scale.to(dtype)``. The detector keeps only this state on the
device and dequantizes it inside every scoring call, as the JAX package
does inside every jitted call (where XLA also fuses the dequantization into
the weight reads; here it is its own pass over the weights).
"""
from __future__ import annotations

from typing import Collection, Dict, Tuple

import torch
from torch import nn

# leaves below this element count ride through unquantized: biases and
# norm vectors are a rounding error of the weight bytes
QUANT_MIN_SIZE = 1024

# symmetric int8: scales map the per-channel absmax onto +/-127
_QMAX = 127.0

QuantLeaf = Tuple[torch.Tensor, ...]


def linear_weight_keys(model: nn.Module) -> frozenset:
    """The ``state_dict`` keys of ``model`` that are ``Linear`` weights,
    whose layout is the transpose of the flax kernel's."""
    return frozenset(f"{name}.weight" for name, module in model.named_modules()
                     if isinstance(module, nn.Linear))


def eligible(tensor: torch.Tensor) -> bool:
    """Whether a leaf gets int8 storage: a float tensor with a channel
    structure (ndim >= 2) and enough elements to matter (decided on the
    element count and ndim, which a transpose leaves as they are)."""
    return (tensor.is_floating_point() and tensor.dim() >= 2
            and tensor.numel() >= QUANT_MIN_SIZE)


def _quantize_leaf(w: torch.Tensor, channel_axis: int) -> QuantLeaf:
    w32 = w.detach().float()
    reduce = tuple(a for a in range(w32.dim()) if a != channel_axis)
    amax = w32.abs().amax(dim=reduce, keepdim=True)
    # floor: an all-zero channel quantizes to zeros instead of dividing by 0
    scale = torch.clamp(amax, min=1e-8) / _QMAX
    q = torch.clamp(torch.round(w32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def quantize(state_dict: Dict[str, torch.Tensor],
             linear_keys: Collection[str]) -> Dict[str, QuantLeaf]:
    """Float ``state_dict`` → ``{key: (q, scale)}`` for eligible leaves and
    ``{key: (w,)}`` for the rest; ``linear_keys`` (``linear_weight_keys``)
    are quantized per row, every other leaf per last-axis column."""
    out: Dict[str, QuantLeaf] = {}
    for key, w in state_dict.items():
        if not eligible(w):
            out[key] = (w.detach().clone(),)
        else:
            out[key] = _quantize_leaf(w, 0 if key in linear_keys else w.dim() - 1)
    return out


def dequantize(qstate: Dict[str, QuantLeaf], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Quantized state → float ``state_dict``: quantized leaves in ``dtype``
    (``q.to(dtype) * scale.to(dtype)``), passthrough leaves as stored."""
    return {key: leaf[0] if len(leaf) == 1 else leaf[0].to(dtype) * leaf[1].to(dtype)
            for key, leaf in qstate.items()}


def quant_stats(qstate: Dict[str, QuantLeaf]) -> Dict[str, int]:
    """Byte accounting for reports, counted as the JAX package counts it:
    int8 payload bytes, and float bytes of the scales and passthrough
    leaves."""
    stats = {"quantized_leaves": 0, "passthrough_leaves": 0,
             "int8_bytes": 0, "float_bytes": 0}
    for leaf in qstate.values():
        if len(leaf) == 1:
            stats["passthrough_leaves"] += 1
            stats["float_bytes"] += leaf[0].numel() * leaf[0].element_size()
        else:
            stats["quantized_leaves"] += 1
            stats["int8_bytes"] += leaf[0].numel()
            stats["float_bytes"] += leaf[1].numel() * 4
    return stats


def quant_shardings(qstate: Dict[str, QuantLeaf], shardings: Dict[str, object],
                    mesh: object) -> Dict[str, tuple]:
    """Placements for ``quantize``'s state on a mesh
    (``parallel/mesh.NamedSharding``s, key for key): the int8 payload is
    placed exactly like its float leaf; the per-channel scale follows the
    leaf's channel axis (flax's last axis), so the scales of a weight split
    over ``model`` along its channels are split with it. A passthrough leaf
    keeps its float leaf's placement."""
    from ..parallel.mesh import NamedSharding, P

    out: Dict[str, tuple] = {}
    for key, leaf in qstate.items():
        sharding = shardings[key]
        if len(leaf) == 1:
            out[key] = (sharding,)
            continue
        q, scale = leaf
        spec = tuple(sharding.spec) + (None,) * (q.dim() - len(sharding.spec))
        scale_spec = P(*(spec[i] if scale.shape[i] == q.shape[i] else None
                         for i in range(q.dim())))
        out[key] = (sharding, NamedSharding(mesh, scale_spec))
    return out
