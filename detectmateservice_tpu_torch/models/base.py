"""Shared scorer scaffolding: the per-position NLL reductions and the
scorer surface the detector programs against.

Counterpart of the scorer part of ``detectmateservice_tpu/models/base.py``
(``reduce_nlls``, ``token_nll``, ``positional_z_max``, ``ScorerBase``).
A scorer here is stateless over its module: ``score(model, tokens)`` takes
the ``nn.Module`` the way the JAX scorer takes its params, so the detector
can score the same weights on the device and on a CPU copy. Token batches
may arrive in the narrow wire format (int16 bits of uint16 ids, see
``models.tokenizer.narrow_tokens``); every entry point widens them first.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..ops.scorehead import candidate_lse
from .tokenizer import PAD_ID

# optax.adamw defaults (torch's AdamW defaults to weight_decay=1e-2)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
# stddev correction of flax's truncated_normal variance scaling: the std of
# a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def widen_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """Token ids as int64. int16 input carries uint16 ids bit for bit."""
    if tokens.dtype == torch.int16:
        return tokens.long() & 0xFFFF
    return tokens.long()


def reduce_nlls(nlls: torch.Tensor, mask: torch.Tensor, topk: int = 0) -> torch.Tensor:
    """[B, S] per-position NLLs (PAD = 0) + fp32 mask → [B] sequence score;
    ``topk > 0`` averages only the k most surprising tokens."""
    if topk > 0:
        k = min(topk, nlls.shape[-1])
        top = torch.topk(nlls, k, dim=-1).values
        denom = torch.clamp(torch.clamp(mask.sum(-1), min=1.0), max=float(k))
        return top.sum(-1) / denom
    return nlls.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)


def token_nll(logits: torch.Tensor, tokens: torch.Tensor, topk: int = 0) -> torch.Tensor:
    """Per-sequence NLL of the observed non-PAD tokens under per-position
    logits [B, S, V] → [B] fp32."""
    logprobs = torch.log_softmax(logits, dim=-1)
    tok_lp = torch.gather(logprobs, -1, tokens[..., None])[..., 0]
    mask = (tokens != PAD_ID).float()
    return reduce_nlls(-tok_lp * mask, mask, topk)


def positional_z_max(nlls: torch.Tensor, tokens: torch.Tensor,
                     mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Max over positions of ``(NLL - mu_pos) / sigma_pos`` → [B] fp32.
    All-PAD rows score 0; a +inf z stays +inf (an alert)."""
    z = (nlls - mu) / sigma
    z = torch.where(tokens != PAD_ID, z, torch.full_like(z, float("-inf")))
    zmax = z.max(dim=-1).values
    return torch.where(torch.isneginf(zmax), torch.zeros_like(zmax), zmax)


def init_lecun_normal_(linear: torch.nn.Linear, generator: torch.Generator) -> None:
    """flax ``Dense`` init: lecun-normal (truncated) kernel, zero bias."""
    fan_in = linear.weight.shape[1]
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    torch.nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    torch.nn.init.zeros_(linear.bias)


class ScorerBase:
    """The public score/train surface over a module built by
    ``init_model``. Subclasses provide ``name``, ``_build_model``,
    ``_init_weights`` and the scoring impls."""

    name = "base"

    def __init__(self, config: Any):
        self.config = config

    # -- subclass hooks -------------------------------------------------
    def _build_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def _init_weights(self, model: torch.nn.Module, generator: torch.Generator) -> None:
        raise NotImplementedError

    def score(self, model: torch.nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def token_nlls(self, model: torch.nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def normscore(self, model: torch.nn.Module, tokens: torch.Tensor,
                  mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def train_step(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   tokens: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- shared surface -------------------------------------------------
    @staticmethod
    def _pallas_lse_rows(rows: torch.Tensor, emb_matrix: torch.Tensor) -> torch.Tensor:
        """[N] logsumexp of rows·emb_matrixᵀ through the fused head
        (ops/scorehead.py): the CUDA kernel for CUDA tensors, its plain
        version for CPU tensors."""
        return candidate_lse(rows, emb_matrix)

    def init_model(self, device: torch.device,
                   generator: Optional[torch.Generator] = None) -> torch.nn.Module:
        """A fresh module on ``device``, initialized from ``generator`` (a
        generator on that device) with flax's initializers."""
        with torch.device("meta"):  # no throwaway default init
            model = self._build_model()
        model = model.to_empty(device=device)
        if generator is None:
            generator = torch.Generator(device=device)
        with torch.no_grad():
            self._init_weights(model, generator)
        return model

    def clone_model(self, model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
        """A frozen copy of ``model``'s weights on ``device`` (the host copy
        the detector scores small batches on)."""
        with torch.device("meta"):
            clone = self._build_model()
        clone = clone.to_empty(device=device)
        clone.load_state_dict(model.state_dict())
        return clone.requires_grad_(False)

    def make_optimizer(self, model: torch.nn.Module) -> torch.optim.Optimizer:
        """AdamW with optax.adamw's defaults (decoupled weight decay 1e-4)."""
        return torch.optim.AdamW(model.parameters(), lr=self.config.learning_rate,
                                 betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                 weight_decay=ADAMW_WEIGHT_DECAY)
