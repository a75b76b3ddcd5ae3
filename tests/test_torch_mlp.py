"""The port's MLP scorer against the JAX package's ``MLPScorer`` on bridged
weights: scores, per-token NLLs and positional z-scores through both heads
(the einsum head, and the fused logsumexp head that the JAX side runs as
its Pallas kernel in interpret mode), and AdamW train steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.models.mlp import MLPScorer as JaxMLPScorer
from detectmateservice_tpu.models.mlp import MLPScorerConfig as JaxMLPConfig
from detectmateservice_tpu_torch.models import base as port_base
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.models.mlp import MLPScorer, MLPScorerConfig
from detectmateservice_tpu_torch.models.tokenizer import PAD_ID

_SIZES = dict(vocab_size=4096, dim=32, seq_len=16)
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tokens(seed=7, n=64):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 4000, (n, 16)).astype(np.int32)
    for i in range(0, n, 2):  # ragged PAD tails of varying length
        toks[i, 16 - (i % 8 + 1):] = PAD_ID
    toks[3] = PAD_ID  # one all-PAD row
    return toks


def _pair(head, dtype, seed=0):
    jdt, tdt = _DTYPES[dtype]
    jax_scorer = JaxMLPScorer(JaxMLPConfig(**_SIZES, dtype=jdt, head_impl=head))
    params, opt_state = jax_scorer.init(jax.random.PRNGKey(seed))
    scorer = MLPScorer(MLPScorerConfig(**_SIZES, dtype=tdt, head_impl=head))
    model = scorer.init_model(torch.device("cpu"))
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_scorer, params, opt_state, scorer, model


@pytest.mark.parametrize("head", ["einsum", "pallas"])
class TestFloat32Parity:
    def test_scores(self, head):
        jax_scorer, params, _, scorer, model = _pair(head, "float32")
        toks = _tokens()
        want = np.asarray(jax_scorer.score(params, jnp.asarray(toks)))
        got = scorer.score(model, torch.from_numpy(toks)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        assert got[3] == 0.0  # all-PAD row

    def test_token_nlls(self, head):
        jax_scorer, params, _, scorer, model = _pair(head, "float32")
        toks = _tokens(8)
        want = np.asarray(jax_scorer._token_nlls(params, jnp.asarray(toks)))
        got = scorer.token_nlls(model, torch.from_numpy(toks)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        assert (got[toks == PAD_ID] == 0).all()

    def test_normscore(self, head):
        jax_scorer, params, _, scorer, model = _pair(head, "float32")
        toks = _tokens(9)
        rng = np.random.default_rng(9)
        mu = rng.uniform(5, 9, 16).astype(np.float32)
        sigma = rng.uniform(0.05, 2, 16).astype(np.float32)
        want = np.asarray(jax_scorer._normscore(params, jnp.asarray(toks), mu, sigma))
        got = scorer.normscore(model, torch.from_numpy(toks), torch.from_numpy(mu),
                               torch.from_numpy(sigma)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        assert got[3] == 0.0

    def test_narrow_wire_tokens_score_the_same(self, head):
        _, _, _, scorer, model = _pair(head, "float32")
        toks = _tokens(10)
        wide = scorer.score(model, torch.from_numpy(toks))
        narrow = torch.from_numpy(toks.astype(np.uint16).view(np.int16))
        torch.testing.assert_close(scorer.score(model, narrow), wide)


@pytest.mark.parametrize("head", ["einsum", "pallas"])
def test_bf16_scores_within_bound(head):
    """bf16 compute rounds at other places in the two frameworks; the bound
    is the one tests/test_scorehead.py holds the two JAX heads to."""
    jax_scorer, params, _, scorer, model = _pair(head, "bfloat16")
    toks = _tokens(11)
    want = np.asarray(jax_scorer.score(params, jnp.asarray(toks)))
    got = scorer.score(model, torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 0.05
    nll_want = np.asarray(jax_scorer._token_nlls(params, jnp.asarray(toks)))
    nll_got = scorer.token_nlls(model, torch.from_numpy(toks)).numpy()
    assert np.abs(nll_got - nll_want).max() < 0.1


def _flax_grads(jax_scorer, params, batch):
    from detectmateservice_tpu.models.mlp import bag_nll as jax_bag_nll

    def loss_fn(p):
        return jax_bag_nll(jax_scorer.model.apply(p, jnp.asarray(batch)),
                           jnp.asarray(batch)).mean()

    grads = jax.grad(loss_fn)(params)
    return params_from_flax(jax.tree_util.tree_map(np.asarray, grads))


def test_train_step_gradients_match():
    """The loss and its gradient on bridged params: the MLP's backward pass
    is plain autograd on both sides."""
    jax_scorer, params, _, scorer, model = _pair("pallas", "float32", seed=4)
    batch = _tokens(20, n=32)
    want = _flax_grads(jax_scorer, params, batch)
    tokens = torch.from_numpy(batch).long()
    from detectmateservice_tpu_torch.models.mlp import bag_nll

    bag_nll(model(tokens), tokens).mean().backward()
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-8, err_msg=name)


def test_one_train_step_lands_on_matching_params():
    """One ``train_step`` each from the same params and batch.

    Adam's first update is ``lr * g / (|g| + eps)``: where |g| is near eps
    (1e-8) a gradient difference at fp32 rounding level (~1e-9, which the
    gradient test above pins) moves the update by up to ``lr``, so those
    elements are held to the gradient test and to the same-gradient
    optimizer test below. With a gradient error of 1e-9 the update moves by
    ``lr * eps * 1e-9 / (|g| + eps)**2``, under 1e-5 for |g| >= 1e-7: every
    such element must land within 1e-5."""
    jax_scorer, params, opt_state, scorer, model = _pair("pallas", "float32", seed=4)
    batch = _tokens(20, n=32)
    grads = _flax_grads(jax_scorer, params, batch)
    new_params, _, jax_loss = jax_scorer.train_step(
        params, opt_state, jax.random.PRNGKey(0), jnp.asarray(batch))
    loss = scorer.train_step(model, scorer.make_optimizer(model), torch.from_numpy(batch))
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, new_params))
    for name, value in model.state_dict().items():
        steady = grads[name].abs() >= 1e-7
        np.testing.assert_allclose(value[steady].numpy(), want[name][steady].numpy(),
                                   atol=1e-5, err_msg=name)


def test_adamw_steps_from_the_same_gradients_match_optax():
    """Three AdamW steps fed the same gradients: torch's AdamW at optax's
    defaults lands on optax.adamw's params."""
    import optax

    jax_scorer, params, _, scorer, model = _pair("einsum", "float32", seed=5)
    optimizer = scorer.make_optimizer(model)
    tx = optax.adamw(3e-3)
    opt_state = tx.init(params)
    for step in range(3):
        batch = _tokens(30 + step, n=32)
        grads = _flax_grads(jax_scorer, params, batch)
        flax_grads = jax.tree_util.tree_map(jnp.asarray, _to_flax(grads))
        updates, opt_state = tx.update(flax_grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, param in model.named_parameters():
            param.grad = grads[name].clone()
        optimizer.step()
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


def _to_flax(state):
    from detectmateservice_tpu_torch.models.convert import params_to_flax

    return params_to_flax(state)


def test_optimizer_has_optax_adamw_defaults():
    _, _, _, scorer, model = _pair("einsum", "float32")
    group = scorer.make_optimizer(model).param_groups[0]
    assert group["weight_decay"] == port_base.ADAMW_WEIGHT_DECAY == 1e-4
    assert group["eps"] == 1e-8 and group["betas"] == (0.9, 0.999)
    assert group["lr"] == 3e-3


def test_init_follows_flax_initializers():
    """Seeded init on the port's side: embedding ~ N(0, 1/D), Dense kernels
    lecun-normal truncated at two standard deviations, zero biases."""
    cfg = MLPScorerConfig(vocab_size=4096, dim=64, hidden=256, seq_len=16)
    scorer = MLPScorer(cfg)
    gen = torch.Generator().manual_seed(0)
    model = scorer.init_model(torch.device("cpu"), gen)
    emb = model.tok_embed.weight
    assert abs(emb.std().item() - (1 / 64) ** 0.5) < 0.005
    w1 = model.fc1.weight
    assert abs(w1.std().item() - (1 / 64) ** 0.5) < 0.01
    assert w1.abs().max().item() <= 2 * (1 / 64) ** 0.5 / port_base._TRUNC_STD + 1e-6
    assert not model.fc1.bias.any() and not model.fc2.bias.any()
    again = scorer.init_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    assert torch.equal(again.tok_embed.weight, emb)
