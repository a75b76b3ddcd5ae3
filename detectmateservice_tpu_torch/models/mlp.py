"""Embedding + MLP bag-of-tokens NLL scorer.

Counterpart of ``detectmateservice_tpu/models/mlp.py``. A CBOW-style
log-linear language model: masked mean-pool of token embeddings → small MLP
→ weight-tied logits over the vocab; the anomaly score is the mean NLL of
the sequence's observed tokens.

Numerics follow the flax module: parameters stay fp32 and each op computes
in ``config.dtype`` (bf16 by default), GELU is the tanh approximation
(``flax.linen.gelu``'s default), and the weight-tied head returns logits in
the compute dtype, so the einsum head's ``log_softmax`` runs on bf16 logits
as the JAX scorer's does.

``head_impl`` keeps the JAX package's values so one config drives both:
``"auto"``/``"einsum"`` is the weight-tied head + ``log_softmax`` in plain
torch ([B, V] logits materialize); ``"pallas"`` is the fused logsumexp head
(``ops/scorehead.candidate_lse``, the hand-written CUDA kernel on a CUDA
device) plus direct target dots — no [B, V] tensor. Training always goes
through the weight-tied logits (``bag_nll``), whatever the head.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .base import ScorerBase, init_lecun_normal_, positional_z_max, widen_tokens
from .tokenizer import PAD_ID


@dataclasses.dataclass(frozen=True)
class MLPScorerConfig:
    vocab_size: int = 32768
    dim: int = 128
    hidden: int = 256
    seq_len: int = 32
    dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 3e-3
    head_impl: str = "auto"


class EmbedMLPModel(nn.Module):
    """``tok_embed`` [V, D], ``fc1`` D→H, ``fc2`` H→D (fp32 parameters)."""

    def __init__(self, config: MLPScorerConfig):
        super().__init__()
        self.config = config
        self.tok_embed = nn.Embedding(config.vocab_size, config.dim)
        self.fc1 = nn.Linear(config.dim, config.hidden)
        self.fc2 = nn.Linear(config.hidden, config.dim)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, D] context vector (pre-head), compute dtype."""
        dt = self.config.dtype
        emb = self.tok_embed(tokens).to(dt)
        mask = (tokens != PAD_ID).to(dt)[..., None]
        pooled = (emb * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        x = F.linear(pooled, self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        x = F.gelu(x, approximate="tanh")
        return F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, V] logits in the compute dtype (weight-tied)."""
        dt = self.config.dtype
        return self.hidden(tokens).to(dt) @ self.tok_embed.weight.to(dt).T


def _masked_mean_nll(tok_lp: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] per-token log-probs → [B] mean NLL over non-PAD positions."""
    mask = (tokens != PAD_ID).float()
    return -(tok_lp * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)


def bag_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean NLL of each sequence's non-PAD tokens under its single context
    distribution → [B] fp32."""
    logprobs = torch.log_softmax(logits, dim=-1)     # [B, V]
    tok_lp = torch.gather(logprobs, -1, tokens)      # [B, S]
    return _masked_mean_nll(tok_lp, tokens)


class MLPScorer(ScorerBase):
    """Bag-of-tokens scorer: the model emits ONE context distribution per
    sequence ([B, V] logits), not per-position [B, S, V]."""

    name = "mlp"

    def __init__(self, config: Optional[MLPScorerConfig] = None):
        super().__init__(config or MLPScorerConfig())

    def _build_model(self) -> EmbedMLPModel:
        return EmbedMLPModel(self.config)

    def _init_weights(self, model: EmbedMLPModel, generator: torch.Generator) -> None:
        # flax Embed: variance_scaling(1.0, "fan_in", "normal", out_axis=0),
        # fan_in = D for a [V, D] table
        nn.init.normal_(model.tok_embed.weight, 0.0, (1.0 / self.config.dim) ** 0.5,
                        generator=generator)
        init_lecun_normal_(model.fc1, generator)
        init_lecun_normal_(model.fc2, generator)

    def _pallas_token_logprobs(self, model: EmbedMLPModel,
                               tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] per-token log-probs via the fused head: lse from the
        kernel (no [B, V] logits), target logits from direct h·emb[token]
        dots; compute-dtype operands, fp32 products and sums."""
        dt = self.config.dtype
        h = model.hidden(tokens).to(dt)
        emb = model.tok_embed.weight.to(dt)
        lse = self._pallas_lse_rows(h, emb)                      # [B] fp32
        tgt = torch.einsum("bsd,bd->bs", emb[tokens].float(), h.float())
        return tgt - lse[:, None]

    def _token_logprobs(self, model: EmbedMLPModel, tokens: torch.Tensor) -> torch.Tensor:
        if self._use_pallas_head():
            return self._pallas_token_logprobs(model, tokens)
        logprobs = torch.log_softmax(model(tokens), dim=-1)
        return torch.gather(logprobs, -1, tokens)                # [B, S]

    @torch.no_grad()
    def score(self, model: EmbedMLPModel, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] → [B] fp32 mean NLL of the non-PAD tokens."""
        tokens = widen_tokens(tokens)
        return _masked_mean_nll(self._token_logprobs(model, tokens), tokens)

    @torch.no_grad()
    def token_nlls(self, model: EmbedMLPModel, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] per-position NLL under the bag context distribution
        (PAD positions → 0)."""
        tokens = widen_tokens(tokens)
        tok_lp = self._token_logprobs(model, tokens)
        return -tok_lp * (tokens != PAD_ID).float()

    @torch.no_grad()
    def normscore(self, model: EmbedMLPModel, tokens: torch.Tensor,
                  mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        tokens = widen_tokens(tokens)
        return positional_z_max(self.token_nlls(model, tokens), tokens, mu, sigma)

    def loss_sum(self, model: EmbedMLPModel, tokens: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The rows' summed bag NLL (the step draws nothing; the loss is
        their mean)."""
        return bag_nll(model(tokens), tokens).sum()

    def loss_count(self, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The rows."""
        return torch.tensor(float(tokens.shape[0]), device=tokens.device)
