"""The port's LogBERT training (``models/logbert.py``) against the JAX
package's ``LogBERTScorer`` on bridged weights: the masked-LM loss and its
gradients, and one AdamW train step fed the mask JAX drew, through the
einsum path and through flash attention (the JAX custom_vjp in interpret
mode; the port's autograd Function over the plain dQ and dK/dV versions on
the CPU); the port's own mask draw and seeded init."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.models import logbert as jax_lb
from detectmateservice_tpu_torch.models import logbert as lb
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.models.tokenizer import PAD_ID

_SIZES = dict(vocab_size=4096, dim=32, depth=2, heads=2, seq_len=16)


def _tokens(seed, n=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, 4000, (n, 16)).astype(np.int32)
    for i in range(0, n, 2):  # ragged PAD tails
        toks[i, 16 - (i % 8 + 1):] = PAD_ID
    toks[3] = PAD_ID  # one all-PAD row
    return toks


@functools.lru_cache(maxsize=None)
def _flax_init(seed):
    cfg = jax_lb.LogBERTConfig(**_SIZES, dtype=jnp.float32)
    return jax_lb.LogBERTScorer(cfg).init(jax.random.PRNGKey(seed))


def _pair(attn, seed):
    """A JAX and a port fp32 scorer with the same seeded weights."""
    opts = dict(_SIZES, attn_impl=attn)
    jax_scorer = jax_lb.LogBERTScorer(jax_lb.LogBERTConfig(**opts, dtype=jnp.float32))
    params, opt_state = _flax_init(seed)
    scorer = lb.LogBERTScorer(lb.LogBERTConfig(**opts, dtype=torch.float32))
    model = scorer.init_model(torch.device("cpu"))
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_scorer, params, opt_state, scorer, model


_TRAIN_RNG = 1


@functools.lru_cache(maxsize=None)
def _jax_train_case(attn):
    """JAX's side of one train step at seed 4: the batch, the mask its
    ``_train_impl`` draws, its loss and gradients under that mask, and the
    params after its jitted ``train_step``."""
    jax_scorer, params, opt_state, _, _ = _pair(attn, seed=4)
    toks = _tokens(20)
    jtoks = jnp.asarray(toks)
    rng = jax.random.PRNGKey(_TRAIN_RNG)
    mask_rng, _ = jax.random.split(rng)
    mask = (jax.random.uniform(mask_rng, toks.shape) < 0.15) & (jtoks != PAD_ID)

    def loss_fn(p):
        corrupted = jnp.where(mask, 1, jtoks)
        return jax_lb.masked_lm_loss(jax_scorer.model.apply(p, corrupted), jtoks, mask)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new_params, _, step_loss = jax_scorer.train_step(params, opt_state, rng, jtoks)
    as_state = lambda tree: params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    return (toks, np.array(mask), float(loss), as_state(grads), float(step_loss),
            as_state(new_params))


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_train_step_gradients_match(attn):
    toks, mask, want_loss, want, _, _ = _jax_train_case(attn)
    assert mask.any()
    _, _, _, _, model = _pair(attn, seed=4)
    tokens = torch.from_numpy(toks).long()
    tmask = torch.from_numpy(mask)
    corrupted = torch.where(tmask, torch.ones_like(tokens), tokens)
    loss = lb.masked_lm_loss(model(corrupted), tokens, tmask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_one_train_step_lands_on_matching_params(attn):
    """One ``train_step`` each from the same params and batch, the port fed
    the mask JAX drew. Adam's first update is ``lr * g / (|g| + eps)``, so
    as in tests/test_torch_mlp.py every element with |g| >= 1e-7 must land
    within 1e-5; the rest are held by the gradient test above."""
    toks, mask, _, grads, jax_loss, want = _jax_train_case(attn)
    _, _, _, scorer, model = _pair(attn, seed=4)
    loss = scorer.train_step(model, scorer.make_optimizer(model),
                             torch.from_numpy(toks), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), jax_loss, rtol=1e-5)
    for name, value in model.state_dict().items():
        steady = grads[name].abs() >= 1e-7
        np.testing.assert_allclose(value[steady].numpy(), want[name][steady].numpy(),
                                   atol=1e-5, err_msg=name)


def test_train_step_draws_its_mask_from_the_generator():
    _, _, _, scorer, model = _pair("flash", seed=2)
    toks = torch.from_numpy(_tokens(21))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = scorer.make_optimizer(model)
    loss = scorer.train_step(model, opt, toks, generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(loss)
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    # the same generator seed on the same weights gives the same loss
    model.load_state_dict(before)
    again = scorer.train_step(model, scorer.make_optimizer(model), toks,
                              generator=torch.Generator().manual_seed(5))
    assert float(again) == float(loss)


def test_init_follows_flax_initializers():
    cfg = lb.LogBERTConfig(vocab_size=4096, dim=64, depth=2, heads=2, seq_len=16)
    scorer = lb.LogBERTScorer(cfg)
    model = scorer.init_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    assert abs(model.tok_embed.weight.std().item() - (1 / 64) ** 0.5) < 0.005
    assert abs(model.pos_embed.std().item() - 0.02) < 0.003
    blk = model.blocks[0]
    assert abs(blk.qkv.weight.std().item() - (1 / 64) ** 0.5) < 0.01
    assert not blk.qkv.bias.any() and (blk.ln1.weight == 1).all()
    assert blk.ln1.eps == lb.LAYER_NORM_EPS == 1e-6
    again = scorer.init_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    assert torch.equal(again.pos_embed, model.pos_embed)
