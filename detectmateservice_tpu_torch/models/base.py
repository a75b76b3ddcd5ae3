"""Shared scorer scaffolding: the per-position NLL reductions and the
scorer surface the detector programs against.

Counterpart of ``detectmateservice_tpu/models/base.py`` (``reduce_nlls``,
``token_nll``, ``positional_z_max``, ``ScorerBase``, ``SequenceScorerBase``).
A scorer here is stateless over its module: ``score(model, tokens)`` takes
the ``nn.Module`` the way the JAX scorer takes its params, so the detector
can score the same weights on the device and on a CPU copy. Token batches
may arrive in the narrow wire format (int16 bits of uint16 ids, see
``models.tokenizer.narrow_tokens``); every entry point widens them first.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
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

    def loss_sum(self, model: torch.nn.Module, tokens: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training loss's numerator over int64 ``tokens``: the loss is
        ``loss_sum / max(loss_count, 1)``. Split so that the shards of one
        batch (``parallel/sharded.py``) add up to the whole batch's loss.
        ``mask`` is ``draw_mask``'s draw."""
        raise NotImplementedError

    def loss_count(self, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The loss's denominator (fp32 scalar): what ``loss_sum`` sums over."""
        raise NotImplementedError

    def draw_mask(self, tokens: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        """The randomness a training step draws over int64 ``tokens`` (on
        their device, from ``generator``); None for a step that draws
        nothing."""
        return None

    def train_step(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   tokens: torch.Tensor, generator: Optional[torch.Generator] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step on ``loss_terms``; returns the (pre-step)
        loss. ``generator`` (on the tokens' device) feeds ``draw_mask``; an
        explicit ``mask`` is used as given instead."""
        tokens = widen_tokens(tokens)
        if mask is None:
            mask = self.draw_mask(tokens, generator)
        else:
            mask = mask.to(device=tokens.device, dtype=torch.bool)
        loss = self.loss_sum(model, tokens, mask) / torch.clamp(
            self.loss_count(tokens, mask), min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    # -- shared surface -------------------------------------------------
    def _use_pallas_head(self) -> bool:
        return getattr(self.config, "head_impl", "auto") == "pallas"

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
        model = self.meta_model().to_empty(device=device)
        if generator is None:
            generator = torch.Generator(device=device)
        with torch.no_grad():
            self._init_weights(model, generator)
        return model

    def clone_model(self, model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
        """A frozen copy of ``model``'s weights on ``device`` (the host copy
        the detector scores small batches on)."""
        clone = self.meta_model().to_empty(device=device)
        clone.load_state_dict(model.state_dict())
        return clone.requires_grad_(False)

    def meta_model(self) -> torch.nn.Module:
        """The module on the meta device: its structure, with no storage
        and no initialization."""
        with torch.device("meta"):
            return self._build_model()

    def make_optimizer(self, model: torch.nn.Module) -> torch.optim.Optimizer:
        """AdamW with optax.adamw's defaults (decoupled weight decay 1e-4)."""
        return torch.optim.AdamW(model.parameters(), lr=self.config.learning_rate,
                                 betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                 weight_decay=ADAMW_WEIGHT_DECAY)


class SequenceScorerBase(ScorerBase):
    """Scoring for models with per-position predictions (logbert): anomaly
    score = (top-k) mean NLL of the observed tokens.

    Counterpart of the JAX package's ``SequenceScorerBase``. NLLs come from
    the model's [B, S, D] final hidden states (``model.hidden``), never from
    the [B, S, V] logits: the exact einsum head works in S-chunks whose fp32
    logits stay within ``_CHUNK_ELEMENT_BUDGET``; ``head_impl: pallas`` takes
    the logsumexp from the fused head (``ops/scorehead.py``) and the target
    logit from a direct hidden·emb[token] dot. ``score_vocab`` in (0, V)
    estimates the logsumexp over a fixed seeded candidate subset of the
    vocab with the ``+ log(V/C)`` correction; the target logit stays exact.
    """

    # fp32 elements the per-chunk logits may occupy (1 GiB); the largest
    # divisor of S that fits becomes the chunk length
    _CHUNK_ELEMENT_BUDGET = 1 << 28

    @torch.no_grad()
    def score(self, model: torch.nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] → [B] fp32 (top-k) mean NLL of the non-PAD tokens."""
        tokens = widen_tokens(tokens)
        nlls = self._token_nlls_impl(model, tokens)
        mask = (tokens != PAD_ID).float()
        return reduce_nlls(nlls, mask, getattr(self.config, "score_topk", 0))

    @torch.no_grad()
    def token_nlls(self, model: torch.nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] per-position NLL (PAD positions → 0)."""
        return self._token_nlls_impl(model, widen_tokens(tokens))

    @torch.no_grad()
    def normscore(self, model: torch.nn.Module, tokens: torch.Tensor,
                  mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        tokens = widen_tokens(tokens)
        return positional_z_max(self._token_nlls_impl(model, tokens), tokens, mu, sigma)

    def _candidate_ids(self, vocab: int, n: int) -> np.ndarray:
        """Fixed, seeded candidate subset (sorted int32 ids): the same
        (vocab, n) always gives the same ids, the JAX package's included, so
        calibration and detection score with the same approximation."""
        cached = getattr(self, "_cand_cache", None)
        if cached is None or cached[0] != (vocab, n):
            ids = np.random.default_rng(0x5EED).choice(vocab, size=n, replace=False)
            self._cand_cache = ((vocab, n), np.sort(ids).astype(np.int32))
        return self._cand_cache[1]

    def _candidate_ids_on(self, vocab: int, n: int, device: torch.device) -> torch.Tensor:
        """The candidate ids as an int64 tensor on ``device``, kept from call
        to call: a CUDA graph that captured it reads this storage, so new
        ids (a restored subset) are copied into it, never swapped for a new
        tensor, and no upload happens inside a capture."""
        ids = self._candidate_ids(vocab, n)
        # one copy per device: a mesh's rows may score on several
        per_device = self.__dict__.setdefault("_cand_dev", {})
        cached = per_device.get(device)
        if cached is None or cached[1].shape[0] != len(ids):
            per_device[device] = (ids, torch.from_numpy(ids).to(device).long())
        elif cached[0] is not ids:
            cached[1].copy_(torch.from_numpy(ids))
            per_device[device] = (ids, cached[1])
        return per_device[device][1]

    @classmethod
    def _pallas_lse(cls, hidden: torch.Tensor, emb_matrix: torch.Tensor) -> torch.Tensor:
        """[B, S] logsumexp of hidden·emb_matrixᵀ through the fused head."""
        b, s, d = hidden.shape
        return cls._pallas_lse_rows(hidden.reshape(b * s, d), emb_matrix).reshape(b, s)

    @staticmethod
    def _lse_low_precision(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """logsumexp with the exp in the compute dtype and the sum in fp32,
        after subtracting the row max."""
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp((logits - m).to(dtype))
        total = e.sum(dim=-1, dtype=torch.float32)
        return torch.log(total) + m[..., 0].float()

    def _token_nlls_impl(self, model: torch.nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        score_vocab = int(getattr(self.config, "score_vocab", 0) or 0)
        if score_vocab > 0:
            return self._token_nlls_candidate(model, tokens, score_vocab)
        return self._token_nlls_exact(model, tokens)

    @staticmethod
    def _target_logits(hidden: torch.Tensor, emb: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] fp32 hidden·emb[token] (products of compute-dtype values,
        summed in fp32)."""
        return (hidden.float() * emb[tokens].float()).sum(dim=-1)

    def _token_nlls_candidate(self, model: torch.nn.Module, tokens: torch.Tensor,
                              n_cand: int) -> torch.Tensor:
        dtype = self.config.dtype
        emb = model.tok_embed.weight
        v = emb.shape[0]
        if n_cand >= v:
            return self._token_nlls_exact(model, tokens)
        hidden = model.hidden(tokens).to(dtype)
        emb = emb.to(dtype)
        ids = self._candidate_ids_on(v, n_cand, emb.device)
        emb_c = emb[ids]                                     # [C, D]
        correction = math.log(float(v) / n_cand)
        tgt = self._target_logits(hidden, emb, tokens)
        mask = (tokens != PAD_ID).float()
        b, s, _ = hidden.shape
        if self._use_pallas_head():
            lse = self._pallas_lse(hidden, emb_c) + correction
            return -(tgt - lse) * mask
        # candidate logits stay in the compute dtype, so a chunk of S holds
        # 4 / itemsize times the fp32 budget's rows
        elem_bytes = torch.empty((), dtype=dtype).element_size()
        budget = self._CHUNK_ELEMENT_BUDGET * 4 // max(1, elem_bytes)
        sc = max(1, min(s, budget // max(1, b * n_cand)))
        while s % sc:
            sc -= 1
        lse = torch.cat([self._lse_low_precision(hidden[:, c:c + sc] @ emb_c.T, dtype)
                         for c in range(0, s, sc)], dim=1) + correction
        return -(tgt - lse) * mask

    def _token_nlls_exact(self, model: torch.nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        """Full-vocab per-position NLL: compute-dtype operands, fp32
        products and sums, chunked over S (einsum head) or through the
        fused head (``head_impl: pallas``)."""
        dtype = self.config.dtype
        hidden = model.hidden(tokens).to(dtype)
        emb = model.tok_embed.weight.to(dtype)
        mask = (tokens != PAD_ID).float()
        b, s, _ = hidden.shape
        v = emb.shape[0]
        if self._use_pallas_head():
            lse = self._pallas_lse(hidden, emb)
            return -(self._target_logits(hidden, emb, tokens) - lse) * mask
        sc = max(1, min(s, self._CHUNK_ELEMENT_BUDGET // max(1, b * v)))
        while s % sc:
            sc -= 1
        emb_t = emb.float().T
        parts = []
        for c in range(0, s, sc):
            logits = hidden[:, c:c + sc].float() @ emb_t
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, tokens[:, c:c + sc, None])[..., 0]
            parts.append(tgt - lse)
        return -torch.cat(parts, dim=1) * mask
