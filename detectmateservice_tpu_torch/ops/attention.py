"""Attention ops for the scorer models.

Counterpart of ``detectmateservice_tpu/ops/attention.py``: the einsum
formulation (``dot_product_attention``), the streaming-softmax building
block and its blockwise loop (``blockwise_attention_step``,
``blockwise_attention``), and ``attention()``, which routes between them and
the fused kernels of ``ops/flash.py``. Layout is the JAX package's: q
``[B, H, S, D]``, k and v ``[B, H, T, D]``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from .flash import flash_attention

# the reference's routing threshold: sequences this long take the fused
# kernels on the accelerator, shorter ones the einsum path
FLASH_MIN_SEQ = 2048

_F32_MIN = torch.finfo(torch.float32).min

# (mesh, batch_axis, seq_axis) for impl="ring", set by the execution layer
# (parallel.ShardedScorer) around a forward, so the model stays
# mesh-agnostic: the same LogBERT module scores on one device or sequence-
# parallel by who wraps the call
_RING_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "dm_ring_attention_ctx", default=None)


@contextlib.contextmanager
def ring_context(mesh, batch_axis: Optional[str] = None, axis_name: str = "seq"):
    """Make ``impl="ring"`` resolvable inside model code run under this
    scope (a CUDA graph captured under it keeps the ring it captured)."""
    token = _RING_CTX.set((mesh, batch_axis, axis_name))
    try:
        yield
    finally:
        _RING_CTX.reset(token)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_mask: Optional[torch.Tensor] = None,
              impl: str = "auto") -> torch.Tensor:
    """Route to an attention implementation.

    ``impl``: "auto" (flash for CUDA tensors with T >= ``FLASH_MIN_SEQ``,
    einsum otherwise), "einsum", "flash", "blockwise", or "ring" (sequence-
    parallel exact attention over the mesh ``ring_context`` provides). The
    mask is the scorer's PAD-key form, [B, T] bool, True = attend; ring
    uses it as per-shard key validity. An unknown ``impl`` takes the einsum
    path, as in the JAX package."""
    t = k.shape[2]
    if impl == "auto":
        impl = "flash" if (q.device.type == "cuda" and t >= FLASH_MIN_SEQ) else "einsum"
    if impl == "ring":
        ctx = _RING_CTX.get()
        if ctx is None:
            raise ValueError(
                "attention impl='ring' needs a sequence mesh: run the model "
                "through parallel.ShardedScorer with a 'seq' mesh axis (or "
                "wrap the call in ops.attention.ring_context)")
        mesh, batch_axis, axis_name = ctx
        from ..parallel.ring import ring_attention

        return ring_attention(q, k, v, mesh, kv_valid=key_mask,
                              axis_name=axis_name, batch_axis=batch_axis)
    if impl == "flash":
        return flash_attention(q, k, v, key_mask)
    mask = None if key_mask is None else key_mask[:, None, None, :]
    if impl == "blockwise":
        return blockwise_attention(q, k, v, mask=mask)
    return dot_product_attention(q, k, v, mask)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard softmax attention: fp32 logits and softmax whatever the
    input dtype; ``mask`` broadcasts to [B, H, S, T], True = attend, and
    masked logits become float32's minimum. The probabilities are cast to
    v's dtype for the product, whose result is in v's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, _F32_MIN)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def blockwise_attention_step(q, k_block, v_block, acc, row_max, row_sum,
                             mask_block: Optional[torch.Tensor] = None):
    """One streaming-softmax update against a block of keys/values: returns
    the new (acc [B, H, S, D] fp32, row_max [B, H, S], row_sum [B, H, S])."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k_block.float().transpose(-1, -2)) * scale
    if mask_block is not None:
        logits = logits.masked_fill(~mask_block, _F32_MIN)
    block_max = logits.amax(dim=-1)
    new_max = torch.maximum(row_max, block_max)
    correction = torch.exp(row_max - new_max)
    probs = torch.exp(logits - new_max[..., None])
    new_sum = row_sum * correction + probs.sum(dim=-1)
    new_acc = acc * correction[..., None] + torch.matmul(probs, v_block.float())
    return new_acc, new_max, new_sum


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 128,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention computed over key blocks of ``block_size``; matches
    ``dot_product_attention`` with fp32 accumulation. T must divide by the
    block size."""
    b, h, s, d = q.shape
    t = k.shape[2]
    if t % block_size != 0:
        raise ValueError(f"key length {t} not divisible by block size {block_size}")
    if mask is not None:
        mask = mask.expand(b, h, s, t)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, h, s), _F32_MIN, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    for start in range(0, t, block_size):
        blk = slice(start, start + block_size)
        acc, row_max, row_sum = blockwise_attention_step(
            q, k[:, :, blk], v[:, :, blk], acc, row_max, row_sum,
            None if mask is None else mask[..., blk])
    # row_sum stays >= 1 even for fully masked rows (masked logits are
    # float32's minimum, not -inf)
    return (acc / torch.clamp(row_sum[..., None], min=1e-30)).to(q.dtype)
