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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


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
        cfg = self.config
        dt = cfg.dtype
        head_dim = cfg.dim // cfg.heads
        qkv = _dense(flax_layer_norm(x, self.ln1, dt), self.qkv, dt)
        q, k, v = qkv.split(cfg.dim, dim=-1)    # contiguous thirds
        b, s, _ = q.shape

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, s, cfg.heads, head_dim).transpose(1, 2)

        out = attention(heads(q), heads(k), heads(v), key_mask=pad_mask,
                        impl=cfg.attn_impl)
        out = out.transpose(1, 2).reshape(b, s, cfg.dim)
        x = x + _dense(out, self.proj, dt)
        y = _dense(flax_layer_norm(x, self.ln2, dt), self.mlp_in, dt)
        y = _dense(F.gelu(y, approximate="tanh"), self.mlp_out, dt)
        return x + y


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
        dt = self.config.dtype
        pad_mask = tokens != PAD_ID
        x = self.tok_embed(tokens).to(dt) + self.pos_embed[:tokens.shape[1]].to(dt)
        for blk in self.blocks:
            x = blk(x, pad_mask)
        return flax_layer_norm(x, self.final_ln, dt).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, S, V] fp32 logits (weight-tied head):
        compute-dtype operands, fp32 products and sums."""
        dt = self.config.dtype
        return self.hidden(tokens).to(dt).float() @ self.tok_embed.weight.to(dt).float().T


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
