"""DeepLog-style recurrent (GRU) next-token anomaly scorer.

Counterpart of ``detectmateservice_tpu/models/gru.py``: a causal next-token
language model over the hashed token stream. Position t's hidden state is
computed from tokens[<t] after a learned BOS embedding (teacher-forced
shift-right), so the per-position NLLs line up 1:1 with the input tokens and
the anomaly score is the (top-k) mean NLL of the observed tokens
(``SequenceScorerBase``, whose exact, candidate and position-norm heads this
scorer inherits).

Numerics follow flax 0.12's ``nn.RNN(nn.GRUCell(features=D, dtype=dtype))``:

* the gates are ``r = σ(W_ir x + b_ir + W_hr h)``, ``z = σ(W_iz x + b_iz +
  W_hz h)``, ``n = tanh(W_in x + b_in + r·(W_hn h + b_hn))`` and ``h' =
  (1 − z)·n + z·h``. ``hr`` and ``hz`` carry no bias; ``torch.nn.GRU`` (and
  cuDNN) would add ``b_hr``/``b_hz``, which training would move off zero, so
  the cell is written in torch ops: one [B·S, D] × [D, 3D] product for the
  input side of every step, then per step one [B, D] × [D, 3D] product for
  ``hr``, ``hz`` and ``hn``;
* each Dense computes in ``dtype`` (bf16 by default): operands cast, the
  product rounded to ``dtype``, then the bias added in ``dtype``; the gates
  stay in ``dtype``;
* the carry starts as fp32 zeros (flax's ``param_dtype``) and ``z·h`` is
  ``dtype`` × fp32, so the carry and every layer output are fp32 at every
  step; the next step's hidden projections cast the carry back to ``dtype``;
* the final LayerNorm takes fp32 statistics (epsilon 1e-6) and returns
  ``dtype``; the weight-tied head multiplies ``dtype`` values into fp32
  logits. Parameters stay fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .base import SequenceScorerBase, init_lecun_normal_
from .logbert import LAYER_NORM_EPS, flax_layer_norm
from .tokenizer import PAD_ID

INPUT_GATES = ("ir", "iz", "in")
HIDDEN_GATES = ("hr", "hz", "hn")


@dataclasses.dataclass(frozen=True)
class GRUScorerConfig:
    vocab_size: int = 32768
    dim: int = 128
    depth: int = 1                    # stacked GRU layers
    seq_len: int = 32
    dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 2e-3
    # 0 = mean NLL over observed tokens; k > 0 = mean of the k most surprising
    score_topk: int = 0
    # 0 = exact full-vocab NLL; 0 < C < vocab_size = candidate-vocab estimate
    score_vocab: int = 0
    # "auto"/"einsum" = S-chunked einsum head; "pallas" = the fused
    # logsumexp head (ops/scorehead.py)
    head_impl: str = "auto"


class GRUCell(nn.ModuleDict):
    """flax ``GRUCell``'s six Dense layers by their flax names: ``ir``,
    ``iz``, ``in`` (with bias), ``hr``, ``hz`` (without) and ``hn`` (with)."""

    def __init__(self, dim: int):
        super().__init__({name: nn.Linear(dim, dim, bias=name not in ("hr", "hz"))
                          for name in (*INPUT_GATES, *HIDDEN_GATES)})


def gru_layer(x: torch.Tensor, cell: GRUCell, dtype: torch.dtype) -> torch.Tensor:
    """One ``nn.RNN(GRUCell)`` over [B, S, D] inputs → [B, S, D] fp32 outputs
    (the carry after each step), rounding where flax rounds."""
    b, s, d = x.shape
    w_i = torch.cat([cell[g].weight for g in INPUT_GATES]).to(dtype)
    b_i = torch.cat([cell[g].bias for g in INPUT_GATES]).to(dtype)
    w_h = torch.cat([cell[g].weight for g in HIDDEN_GATES]).to(dtype)
    b_hn = cell["hn"].bias.to(dtype)
    gi = F.linear(x.to(dtype), w_i) + b_i            # [B, S, 3D], every step
    h = torch.zeros(b, d, dtype=torch.float32, device=x.device)
    outs = []
    for t in range(s):
        i_r, i_z, i_n = gi[:, t].split(d, dim=-1)
        h_r, h_z, h_n = F.linear(h.to(dtype), w_h).split(d, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + b_hn))
        h = (1.0 - z) * n + z * h                    # dtype·fp32 → fp32
        outs.append(h)
    return torch.stack(outs, dim=1)


class GRULM(nn.Module):
    """``tok_embed`` [V, D], ``bos_embed`` [D], ``depth`` GRU cells
    (``rnns``) and ``final_ln`` (fp32 parameters)."""

    def __init__(self, config: GRUScorerConfig):
        super().__init__()
        self.config = config
        self.tok_embed = nn.Embedding(config.vocab_size, config.dim)
        self.bos_embed = nn.Parameter(torch.empty(config.dim))
        self.rnns = nn.ModuleList(GRUCell(config.dim) for _ in range(config.depth))
        self.final_ln = nn.LayerNorm(config.dim, eps=LAYER_NORM_EPS)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, S, D] fp32 causal hidden states (pre-head):
        the input at step t is token t−1, BOS at step 0."""
        dt = self.config.dtype
        emb = self.tok_embed(tokens).to(dt)
        bos = self.bos_embed.to(dt).expand(tokens.shape[0], 1, -1)
        x = torch.cat([bos, emb[:, :-1]], dim=1)
        for cell in self.rnns:
            x = gru_layer(x, cell, dt)
        return flax_layer_norm(x, self.final_ln, dt).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] int64 → [B, S, V] fp32 causal next-token logits
        (weight-tied head): compute-dtype operands, fp32 products and sums."""
        dt = self.config.dtype
        return self.hidden(tokens).to(dt).float() @ self.tok_embed.weight.to(dt).float().T


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over all non-PAD positions (scalar)."""
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1),
                          reduction="none")
    mask = (tokens != PAD_ID).reshape(-1).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class GRUScorer(SequenceScorerBase):
    """Causal GRU LM scorer: this class owns the model and its loss;
    scoring comes from ``SequenceScorerBase``."""

    name = "gru"

    def __init__(self, config: Optional[GRUScorerConfig] = None):
        super().__init__(config or GRUScorerConfig())

    def _build_model(self) -> GRULM:
        return GRULM(self.config)

    def _init_weights(self, model: GRULM, generator: torch.Generator) -> None:
        """flax's initializers: Embed N(0, 1/D), ``bos_embed`` N(0, 0.02²),
        the input Dense layers lecun-normal (truncated) with zero bias, the
        hidden ones orthogonal (``hn``'s bias zero), LayerNorm 1 and 0."""
        nn.init.normal_(model.tok_embed.weight, 0.0, (1.0 / self.config.dim) ** 0.5,
                        generator=generator)
        nn.init.normal_(model.bos_embed, 0.0, 0.02, generator=generator)
        for cell in model.rnns:
            for name in INPUT_GATES:
                init_lecun_normal_(cell[name], generator)
            for name in HIDDEN_GATES:
                nn.init.orthogonal_(cell[name].weight, generator=generator)
            nn.init.zeros_(cell["hn"].bias)
        nn.init.ones_(model.final_ln.weight)
        nn.init.zeros_(model.final_ln.bias)

    def loss_sum(self, model: GRULM, tokens: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The non-PAD positions' summed next-token NLL (teacher forcing
        draws nothing; ``causal_lm_loss`` divides it by their count)."""
        logits = model(tokens)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1),
                              reduction="none")
        return (nll * (tokens != PAD_ID).reshape(-1).float()).sum()

    def loss_count(self, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The non-PAD positions."""
        return (tokens != PAD_ID).reshape(-1).float().sum()
