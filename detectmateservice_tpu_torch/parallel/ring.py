"""Ring attention: sequence-parallel exact attention over a device mesh.

Counterpart of ``detectmateservice_tpu/parallel/ring.py``. Each shard of
the ``seq`` axis holds a ``[B, H, S/n, D]`` block of the sequence; key and
value blocks (and their PAD validity) travel around the ring, one hop per
step, while every shard folds the block it holds into a streaming-softmax
accumulator (``ops/attention.blockwise_attention_step``). After ``n``
blocks every query shard has attended to the whole sequence: exact
attention in O(S/n) memory per shard.

The JAX ring runs under ``shard_map`` with ``lax.ppermute`` hops. Here one
process drives every shard: a hop is a copy of each block to the next
shard's device (on a mesh that repeats one device, a rotation of the list).
The fold is plain torch, so autograd differentiates the whole ring, as JAX
differentiates its ``lax.scan``, and training runs under a ``seq`` mesh.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.attention import _F32_MIN, blockwise_attention_step
from .mesh import Mesh


def _ring_shards(qs: List[torch.Tensor], ks: List[torch.Tensor], vs: List[torch.Tensor],
                 valids: List[torch.Tensor], devices: List[torch.device]) -> List[torch.Tensor]:
    """One ring over n shards: q/k/v ``[B, H, Sl, D]`` and validity
    ``[B, Sl]`` blocks, shard i on ``devices[i]``; returns each shard's
    attention output in q's dtype."""
    n = len(qs)
    b, h, s_local, d = qs[0].shape
    acc = [torch.zeros((b, h, s_local, d), dtype=torch.float32, device=dev) for dev in devices]
    row_max = [torch.full((b, h, s_local), _F32_MIN, dtype=torch.float32, device=dev)
               for dev in devices]
    row_sum = [torch.zeros((b, h, s_local), dtype=torch.float32, device=dev) for dev in devices]
    k_blk, v_blk, valid_blk = list(ks), list(vs), list(valids)
    for hop in range(n):
        for i in range(n):
            mask = valid_blk[i][:, None, None, :].expand(b, h, s_local, valid_blk[i].shape[-1])
            acc[i], row_max[i], row_sum[i] = blockwise_attention_step(
                qs[i], k_blk[i], v_blk[i], acc[i], row_max[i], row_sum[i], mask)
        if hop == n - 1:
            break   # the last hop's rotation would bring every block home
        # one hop around the ring: shard i receives what shard i - 1 held
        k_blk = [k_blk[i - 1].to(devices[i]) for i in range(n)]
        v_blk = [v_blk[i - 1].to(devices[i]) for i in range(n)]
        valid_blk = [valid_blk[i - 1].to(devices[i]) for i in range(n)]
    return [(acc[i] / torch.clamp(row_sum[i][..., None], min=1e-30)).to(qs[i].dtype)
            for i in range(n)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   kv_valid: Optional[torch.Tensor] = None, axis_name: str = "seq",
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Exact attention with q/k/v split on the sequence dim over ``mesh``.

    q/k/v: [B, H, S, D] whole tensors; S must divide by
    ``mesh.shape[axis_name]``. ``kv_valid``: optional [B, S] bool (False =
    PAD key, excluded everywhere). ``batch_axis`` names a mesh axis the
    batch splits over as well (dp×sp: each data row runs its own ring).
    Shard (row r, position i) sits on the mesh device at those coordinates
    (every other axis at 0); the result is whole again, on q's device."""
    b, _, s, _ = q.shape
    n = int(mesh.shape[axis_name])
    if s % n:
        raise ValueError(f"sequence length {s} does not divide by the {axis_name!r} "
                         f"mesh axis ({n})")
    rows = int(mesh.shape[batch_axis]) if batch_axis else 1
    if b % rows:
        raise ValueError(f"batch {b} does not divide by the {batch_axis!r} mesh axis ({rows})")
    if kv_valid is None:
        kv_valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    s_local, b_local = s // n, b // rows
    outs = []
    for r in range(rows):
        rsl = slice(r * b_local, (r + 1) * b_local)
        coords = {batch_axis: r} if batch_axis else {}
        devices = [mesh.device_at(**coords, **{axis_name: i}) for i in range(n)]
        blocks = [slice(i * s_local, (i + 1) * s_local) for i in range(n)]
        shards = _ring_shards(
            [q[rsl, :, blk].to(dev) for blk, dev in zip(blocks, devices)],
            [k[rsl, :, blk].to(dev) for blk, dev in zip(blocks, devices)],
            [v[rsl, :, blk].to(dev) for blk, dev in zip(blocks, devices)],
            [kv_valid[rsl, blk].to(dev) for blk, dev in zip(blocks, devices)],
            devices)
        outs.append(torch.cat([o.to(q.device) for o in shards], dim=2))
    return outs[0] if rows == 1 else torch.cat(outs, dim=0)
