"""LogBERT-style Transformer anomaly scorer.

Counterpart of ``detectmateservice_tpu/models/logbert.py``: pre-norm
Transformer blocks over hashed log tokens, trained as a masked language model
on normal traffic; the anomaly score is the (top-k) mean NLL of the observed
tokens (``SequenceScorerBase``).

Numerics follow the flax module: parameters stay fp32 and each op computes in
``config.dtype`` (bf16 by default); LayerNorm takes its statistics in fp32
with epsilon 1e-6 and the fast variance E[x²] - E[x]²; GELU is the tanh
approximation; the weight-tied head multiplies compute-dtype values into fp32
logits. Attention goes through ``ops/attention.attention``, so
``attn_impl: flash`` runs the hand-written CUDA kernels of ``ops/flash.py``
on a CUDA device, in scoring and in training.

``LogBERTOverShards`` is the same model over the ``model`` axis of a mesh
(Megatron, the split the JAX package's GSPMD makes from ``LOGBERT_RULES``),
run by ``parallel/sharded.py`` on each data row's shards. One set of
functions (``_hidden``, ``_block``) computes both: they take each leaf as
its list of slices, and the one-device model is the case of one shard.

* ``tok_embed`` [V, D] splits along D; each shard looks up its slice and
  the slices join into x.
* ``qkv`` is column-parallel, but its fused output is contiguous thirds
  (q, k, v), so shard j's columns are not the q, k and v of its own heads.
  Each shard computes its column slice; the slices are gathered (a copy
  when the shards share a card) and shard j takes the q, k and v of its
  H/m heads and runs attention on them through the path's kernel
  (``ops/attention``: the flash kernels at ``[B, H/m, S, Dh]``).
* ``proj`` is row-parallel over the same heads (its input dimension splits
  contiguously, in step with the heads); ``mlp_in`` column-parallel, GELU
  on each shard, ``mlp_out`` row-parallel. A row-parallel layer's partial
  products are fp32 sums of compute-dtype operands, added together in
  fp32; the bias is added once, then the result rounds to the compute
  dtype, as one device's GEMM rounds its fp32 accumulator once.
* LayerNorms and ``pos_embed`` are replicated, on the row's first device.
* The weight-tied head needs the whole E: its D-slices are joined on the
  row's first device, where kernel 1 runs once per row (kernel 1 takes no
  partial logits; XLA also gathers a sharded operand of a custom call).
"""
from __future__ import annotations

import dataclasses
import functools
import operator
from types import SimpleNamespace
from typing import Callable, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .base import SequenceScorerBase, init_lecun_normal_
from .tokenizer import MASK_ID, PAD_ID

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class LogBERTConfig:
    vocab_size: int = 32768
    dim: int = 256
    depth: int = 4
    heads: int = 4
    mlp_ratio: int = 4
    seq_len: int = 32
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    mask_prob: float = 0.15
    learning_rate: float = 1e-3
    # 0 = mean NLL over all observed tokens; k > 0 = mean of the k most
    # surprising tokens
    score_topk: int = 0
    # 0 = exact full-vocab NLL; 0 < C < vocab_size = candidate-vocab estimate
    score_vocab: int = 0
    # "auto" = flash kernels on CUDA for long sequences, einsum otherwise;
    # "einsum" | "flash" | "blockwise" force a path
    attn_impl: str = "auto"
    # "auto"/"einsum" = S-chunked einsum head; "pallas" = the fused
    # logsumexp head (ops/scorehead.py)
    head_impl: str = "auto"


def flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dtype)``: fp32 statistics (fast variance,
    clipped at 0), fp32 scale and bias, result in ``dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + LAYER_NORM_EPS) * ln.weight)
    return (y + ln.bias).to(dtype)


# a model's tensors by ``state_dict`` key: the key's slices, one per model
# shard (slice j on shard j's device), or one whole tensor
Leaf = Callable[[str], Sequence[torch.Tensor]]


def _one_shard(module: nn.Module) -> Leaf:
    """``module``'s tensors as the one shard of the one-device model."""
    return lambda key: (operator.attrgetter(key)(module),)


def _whole(leaf: Leaf, key: str) -> torch.Tensor:
    (tensor,) = leaf(key)
    return tensor


def _norm(leaf: Leaf, prefix: str) -> SimpleNamespace:
    return SimpleNamespace(weight=_whole(leaf, f"{prefix}.weight"),
                           bias=_whole(leaf, f"{prefix}.bias"))


def _gather(parts: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The shards' outputs joined along the last dimension on ``lead``."""
    return parts[0] if len(parts) == 1 else torch.cat([p.to(lead) for p in parts], dim=-1)


def _column_parallel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """flax ``Dense(dtype=dtype)`` on each shard's output columns: input,
    kernel and bias in ``dtype``."""
    return [F.linear(x.to(w.device), w.to(dtype), b.to(dtype)) for w, b in zip(weights, biases)]


def _row_parallel(parts: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                  bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel ``Dense(dtype)``; one shard is flax ``Dense(dtype)``.
    Over more, shard j multiplies its input slice by its weight slice
    (compute-dtype operands, fp32 products and sums), the partial sums add
    up in fp32 on the first shard's device, the bias once, and the result
    rounds to ``dtype``."""
    if len(parts) == 1:
        return F.linear(parts[0], weights[0].to(dtype), bias.to(dtype))
    lead = parts[0].device
    total = None
    for x, w in zip(parts, weights):
        part = torch.matmul(x.float(), w.to(dtype).float().t()).to(lead)
        total = part if total is None else total + part
    return (total + bias.to(dtype).float()).to(dtype)


def _block(cfg: LogBERTConfig, leaf: Leaf, x: torch.Tensor,
           pad_mask: torch.Tensor) -> torch.Tensor:
    """Pre-norm block: x + proj(attention(qkv(LN(x)))), then x + MLP(LN(x)),
    over the model shards of the block's ``leaf``; x lives on the first."""
    dt = cfg.dtype
    qkv_weights = leaf("qkv.weight")
    devices = [w.device for w in qkv_weights]
    m = len(devices)
    head_dim = cfg.dim // cfg.heads
    local = cfg.dim // m
    h = flax_layer_norm(x, _norm(leaf, "ln1"), dt)
    qkv = _gather(_column_parallel(h, qkv_weights, leaf("qkv.bias"), dt), x.device)
    q, k, v = qkv.split(cfg.dim, dim=-1)    # contiguous thirds
    b, s, _ = q.shape
    outs = []
    for j, dev in enumerate(devices):
        def heads(t: torch.Tensor) -> torch.Tensor:
            # shard j's H/m heads: columns j*D/m .. (j+1)*D/m
            return (t[..., j * local:(j + 1) * local].to(dev)
                    .reshape(b, s, cfg.heads // m, head_dim).transpose(1, 2))

        out = attention(heads(q), heads(k), heads(v), key_mask=pad_mask.to(dev),
                        impl=cfg.attn_impl)
        outs.append(out.transpose(1, 2).reshape(b, s, local))
    x = x + _row_parallel(outs, leaf("proj.weight"), _whole(leaf, "proj.bias"), dt)
    h = flax_layer_norm(x, _norm(leaf, "ln2"), dt)
    ys = [F.gelu(y, approximate="tanh")
          for y in _column_parallel(h, leaf("mlp_in.weight"), leaf("mlp_in.bias"), dt)]
    return x + _row_parallel(ys, leaf("mlp_out.weight"), _whole(leaf, "mlp_out.bias"), dt)


def _hidden(config: LogBERTConfig, leaf: Leaf, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] int64 → [B, S, D] fp32 final hidden states (pre-head)."""
    dt = config.dtype
    slices = leaf("tok_embed.weight")
    pad_mask = tokens != PAD_ID
    x = _gather([F.embedding(tokens.to(e.device), e) for e in slices], slices[0].device).to(dt)
    x = x + _whole(leaf, "pos_embed")[:tokens.shape[1]].to(dt)
    for i in range(config.depth):
        x = _block(config, lambda name, i=i: leaf(f"blocks.{i}.{name}"), x, pad_mask)
    return flax_layer_norm(x, _norm(leaf, "final_ln"), dt).float()


def _tied_logits(config: LogBERTConfig, hidden: torch.Tensor,
                 embed: torch.Tensor) -> torch.Tensor:
    """[B, S, V] fp32 logits of the weight-tied head: compute-dtype
    operands, fp32 products and sums."""
    dt = config.dtype
    return hidden.to(dt).float() @ embed.to(dt).float().T


class Block(nn.Module):
    """Pre-norm block: x + proj(attention(qkv(LN(x)))), then x + MLP(LN(x))."""

    def __init__(self, config: LogBERTConfig):
        super().__init__()
        self.config = config
        dim = config.dim
        self.ln1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp_in = nn.Linear(dim, dim * config.mlp_ratio)
        self.mlp_out = nn.Linear(dim * config.mlp_ratio, dim)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        return _block(self.config, _one_shard(self), x, pad_mask)


class LogBERT(nn.Module):
    """``tok_embed`` [V, D], ``pos_embed`` [seq_len, D], ``depth`` blocks
    and ``final_ln`` (fp32 parameters)."""

    def __init__(self, config: LogBERTConfig):
        super().__init__()
        self.config = config
        self.tok_embed = nn.Embedding(config.vocab_size, config.dim)
        self.pos_embed = nn.Parameter(torch.empty(config.seq_len, config.dim))
        self.blocks = nn.ModuleList(Block(config) for _ in range(config.depth))
        self.final_ln = nn.LayerNorm(config.dim, eps=LAYER_NORM_EPS)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, S, D] fp32 final hidden states (pre-head)."""
        return _hidden(self.config, _one_shard(self), tokens)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, S, V] fp32 logits (weight-tied head)."""
        return _tied_logits(self.config, self.hidden(tokens), self.tok_embed.weight)


class LogBERTOverShards:
    """LogBERT's forward over ``m`` model shards of one data row, through
    the one-device model's arithmetic (``_hidden``, ``_block``).

    ``leaves`` maps each ``state_dict`` key to its slices: ``m`` slices for
    a leaf ``LOGBERT_RULES`` splits over ``model`` (slice j on shard j's
    device), one whole tensor on the row's first device for a replicated
    one. It has the surface the scorer uses (``hidden``, a call for the
    logits, ``tok_embed.weight``); autograd reaches every slice."""

    def __init__(self, config: LogBERTConfig, leaves: Mapping[str, Sequence[torch.Tensor]]):
        self.config = config
        self.leaves = leaves
        m = len(leaves["tok_embed.weight"])
        if config.heads % m or config.dim % m:
            raise ValueError(f"{config.heads} heads of dim {config.dim} do not split over "
                             f"{m} model shards")

    @functools.cached_property
    def tok_embed(self) -> SimpleNamespace:
        """E [V, D], its D-slices joined on the row's first device."""
        slices = self.leaves["tok_embed.weight"]
        return SimpleNamespace(weight=_gather(slices, slices[0].device))

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, S, D] fp32 final hidden states, as ``LogBERT``'s."""
        return _hidden(self.config, self.leaves.__getitem__, tokens)

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, S, V] fp32 logits, as ``LogBERT.forward``."""
        return _tied_logits(self.config, self.hidden(tokens), self.tok_embed.weight)


def masked_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the targets at the masked positions (fp32 logits)."""
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                          reduction="none")
    mask = mask.reshape(-1).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class LogBERTScorer(SequenceScorerBase):
    """Masked-LM transformer scorer: this class owns the model and its loss;
    scoring comes from ``SequenceScorerBase``."""

    name = "logbert"

    def __init__(self, config: Optional[LogBERTConfig] = None):
        super().__init__(config or LogBERTConfig())

    def _build_model(self) -> LogBERT:
        return LogBERT(self.config)

    def model_over_shards(self, leaves: Mapping[str, Sequence[torch.Tensor]]
                          ) -> LogBERTOverShards:
        """The model over a data row's ``model`` shards (``leaves``: each
        key's slices, as ``parallel/sharded.py`` places them)."""
        return LogBERTOverShards(self.config, leaves)

    def _init_weights(self, model: LogBERT, generator: torch.Generator) -> None:
        """flax's initializers: Embed N(0, 1/D), ``pos_embed`` N(0, 0.02²),
        Dense lecun-normal (truncated) with zero bias, LayerNorm 1 and 0."""
        nn.init.normal_(model.tok_embed.weight, 0.0, (1.0 / self.config.dim) ** 0.5,
                        generator=generator)
        nn.init.normal_(model.pos_embed, 0.0, 0.02, generator=generator)
        for blk in model.blocks:
            for layer in (blk.qkv, blk.proj, blk.mlp_in, blk.mlp_out):
                init_lecun_normal_(layer, generator)
        for module in model.modules():
            if isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def draw_mask(self, tokens: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Each non-PAD token is masked with probability ``mask_prob``, drawn
        from ``generator`` on the tokens' device."""
        draw = torch.rand(tokens.shape, generator=generator, device=tokens.device)
        return (draw < self.config.mask_prob) & (tokens != PAD_ID)

    def loss_sum(self, model: LogBERT, tokens: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The masked positions' summed NLL, the positions replaced by MASK
        (``masked_lm_loss`` divides it by their count)."""
        corrupted = torch.where(mask, torch.full_like(tokens, MASK_ID), tokens)
        logits = model(corrupted)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1),
                              reduction="none")
        return (nll * mask.reshape(-1).float()).sum()

    def loss_count(self, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The masked positions."""
        return mask.reshape(-1).float().sum()
