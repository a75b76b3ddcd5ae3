"""The port's GRU scorer (``models/gru.py`` over ``SequenceScorerBase``)
against the JAX package's ``GRULM``/``GRUScorer`` on bridged weights: hidden
states and logits in fp32 and bf16, per-token NLLs, scores and positional
z-scores through both heads, exact and candidate-vocab, the causal LM loss
and one train step, the flax ↔ torch round trip and the seeded init.

The JAX side runs the fused head's Pallas kernel in interpret mode (as
``tests/test_scorehead.py`` does); the port computes its plain version on
the CPU.

Tolerances: fp32 1e-4 (rtol and atol) on hidden states, logits, NLLs and
scores; bf16 hidden states and logits within 2^-4 (one bf16 step at
magnitudes 4-8, where the two frameworks round a gate differently), bf16
scores within 0.05 (the bound tests/test_scorehead.py holds the two JAX
heads to); gradients rtol 1e-3 / atol 1e-6 and the AdamW step within 1e-5
wherever |g| >= 1e-7 (ROADMAP queue 3 item 4: Adam's eps amplifies
rounding where the gradient is near it).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.models import base as jax_base
from detectmateservice_tpu.models import gru as jax_gru
from detectmateservice_tpu_torch.models import gru
from detectmateservice_tpu_torch.models.convert import params_from_flax, params_to_flax
from detectmateservice_tpu_torch.models.tokenizer import PAD_ID

_SIZES = dict(vocab_size=1024, dim=32, depth=2, seq_len=16)
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tokens(seed=7, n=8):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, 1000, (n, 16)).astype(np.int32)
    for i in range(0, n, 2):  # ragged PAD tails
        toks[i, 16 - (i % 8 + 1) * 2:] = PAD_ID
    toks[3] = PAD_ID  # one all-PAD row
    return toks


@functools.lru_cache(maxsize=None)
def _flax_init(dtype, seed):
    cfg = jax_gru.GRUScorerConfig(**_SIZES, dtype=_DTYPES[dtype][0])
    return jax_gru.GRUScorer(cfg).init(jax.random.PRNGKey(seed))


def _pair(head="einsum", vocab=0, topk=0, dtype="float32", seed=0):
    jdt, tdt = _DTYPES[dtype]
    opts = dict(_SIZES, head_impl=head, score_vocab=vocab, score_topk=topk)
    jax_scorer = jax_gru.GRUScorer(jax_gru.GRUScorerConfig(**opts, dtype=jdt))
    params, opt_state = _flax_init(dtype, seed)
    scorer = gru.GRUScorer(gru.GRUScorerConfig(**opts, dtype=tdt))
    model = scorer.init_model(torch.device("cpu"))
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_scorer, params, opt_state, scorer, model


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2.0 ** -4)])
def test_hidden_states_and_logits_match(dtype, tol):
    jax_scorer, params, _, _, model = _pair(dtype=dtype)
    toks = _tokens()
    jtoks = jnp.asarray(toks)
    want_h = np.asarray(jax_scorer.model.apply(params, jtoks, method="hidden"))
    want_l = np.asarray(jax_scorer.model.apply(params, jtoks))
    with torch.no_grad():
        got_h = model.hidden(torch.from_numpy(toks).long()).numpy()
        got_l = model(torch.from_numpy(toks).long()).numpy()
    assert got_h.dtype == got_l.dtype == np.float32
    assert got_h.shape == (8, 16, 32) and got_l.shape == (8, 16, 1024)
    np.testing.assert_allclose(got_h, want_h, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_l, want_l, rtol=tol, atol=tol)


def test_carry_is_fp32_in_bf16_as_flax_promotes_it():
    """flax's carry starts as fp32 zeros and ``z·h`` promotes it, so a bf16
    GRU layer still returns fp32 states; so does the port's."""
    _, _, _, scorer, model = _pair(dtype="bfloat16")
    x = torch.randn(2, 5, 32).to(torch.bfloat16)
    with torch.no_grad():
        out = gru.gru_layer(x, model.rnns[0], torch.bfloat16)
    assert out.dtype == torch.float32
    assert not torch.equal(out, out.to(torch.bfloat16).float())


@pytest.mark.parametrize("vocab", [0, 64])
@pytest.mark.parametrize("head", ["einsum", "pallas"])
def test_nlls_scores_and_normscores_match(head, vocab):
    """Per-token NLLs from the JAX scorer's jitted impl (the Pallas head in
    interpret mode); its score and normscore follow from them through the
    JAX package's own reductions, at top-k 0 and 4."""
    jax_scorer, params, _, scorer, model = _pair(head, vocab)
    toks = _tokens(seed=3 + vocab)
    jtoks = jnp.asarray(toks)
    want_nlls = jax_scorer._token_nlls(params, jtoks)
    mask = (jtoks != PAD_ID).astype(jnp.float32)
    ttoks = torch.from_numpy(toks)
    got_nlls = scorer.token_nlls(model, ttoks).numpy()
    np.testing.assert_allclose(got_nlls, np.asarray(want_nlls), rtol=1e-4, atol=1e-4)
    assert (got_nlls[toks == PAD_ID] == 0).all()
    for topk in (0, 4):
        port = gru.GRUScorer(gru.GRUScorerConfig(**_SIZES, head_impl=head, score_vocab=vocab,
                                                 score_topk=topk, dtype=torch.float32))
        want = np.asarray(jax_base.reduce_nlls(want_nlls, mask, topk))
        got = port.score(model, ttoks).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert got[3] == 0.0  # all-PAD row
    rng = np.random.default_rng(9)
    mu = rng.uniform(5, 9, 16).astype(np.float32)
    sigma = rng.uniform(0.05, 2, 16).astype(np.float32)
    want = np.asarray(jax_base.positional_z_max(want_nlls, jtoks, mu, sigma))
    got = scorer.normscore(model, ttoks, torch.from_numpy(mu), torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_jitted_score_and_normscore_match_end_to_end():
    """The JAX scorer's own ``score`` and ``_normscore`` through the Pallas
    head (interpret mode) against the port's plain head."""
    jax_scorer, params, _, scorer, model = _pair("pallas", topk=4)
    toks = _tokens(seed=5)
    want = np.asarray(jax_scorer.score(params, jnp.asarray(toks)))
    got = scorer.score(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    mu = np.full(16, 7.0, np.float32)
    sigma = np.full(16, 0.5, np.float32)
    want = np.asarray(jax_scorer._normscore(params, jnp.asarray(toks), mu, sigma))
    got = scorer.normscore(model, torch.from_numpy(toks), torch.from_numpy(mu),
                           torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head", ["einsum", "pallas"])
def test_bf16_scores_within_bound(head):
    jax_scorer, params, _, scorer, model = _pair(head, dtype="bfloat16")
    toks = _tokens(seed=11)
    want = np.asarray(jax_scorer.score(params, jnp.asarray(toks)))
    got = scorer.score(model, torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 0.05


@functools.lru_cache(maxsize=None)
def _jax_train_case():
    """JAX's side of one train step at seed 4: the batch, its causal LM loss
    and gradients, and the params after its jitted ``train_step``."""
    jax_scorer, params, opt_state, _, _ = _pair(seed=4)
    toks = _tokens(seed=20, n=16)
    jtoks = jnp.asarray(toks)

    def loss_fn(p):
        return jax_gru.causal_lm_loss(jax_scorer.model.apply(p, jtoks), jtoks)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new_params, _, step_loss = jax_scorer.train_step(params, opt_state,
                                                     jax.random.PRNGKey(1), jtoks)
    as_state = lambda tree: params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    return toks, float(loss), as_state(grads), float(step_loss), as_state(new_params)


def test_causal_lm_loss_and_gradients_match():
    toks, want_loss, want, _, _ = _jax_train_case()
    _, _, _, _, model = _pair(seed=4)
    tokens = torch.from_numpy(toks).long()
    loss = gru.causal_lm_loss(model(tokens), tokens)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert set(want) == {name for name, _ in model.named_parameters()}
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def test_one_train_step_lands_on_matching_params():
    """One ``train_step`` each from the same params and batch (the JAX step
    ignores its rng, the port's its generator)."""
    toks, _, grads, jax_loss, want = _jax_train_case()
    _, _, _, scorer, model = _pair(seed=4)
    loss = scorer.train_step(model, scorer.make_optimizer(model), torch.from_numpy(toks),
                             generator=torch.Generator().manual_seed(123))
    np.testing.assert_allclose(float(loss), jax_loss, rtol=1e-5)
    for name, value in model.state_dict().items():
        steady = grads[name].abs() >= 1e-7
        assert steady.any(), name
        np.testing.assert_allclose(value[steady].numpy(), want[name][steady].numpy(),
                                   atol=1e-5, err_msg=name)


def test_flax_tree_round_trips_exactly():
    """The GRU tree: tok_embed, bos_embed, rnns_{i}/cell/{ir, iz, in, hr, hz,
    hn} (no bias on hr, hz), final_ln — every leaf, bit for bit, both ways,
    with the family read from the keys."""
    params, _ = _flax_init("float32", 0)
    tree = jax.tree_util.tree_map(np.asarray, params)
    state = params_from_flax(tree)
    model = gru.GRULM(gru.GRUScorerConfig(**_SIZES, dtype=torch.float32))
    model.load_state_dict(state, strict=True)  # every key, every shape
    assert "rnns.0.hr.bias" not in state and "rnns.1.hn.bias" in state
    back = params_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    cell = tree["params"]["rnns_1"]["cell"]
    np.testing.assert_array_equal(state["rnns.1.in.weight"].numpy(), cell["in"]["kernel"].T)
    again = params_from_flax(params_to_flax(state), family="gru")
    assert set(again) == set(state)
    for name, value in state.items():
        assert torch.equal(again[name], value) and again[name].data_ptr() != value.data_ptr()


def test_init_follows_flax_initializers():
    cfg = gru.GRUScorerConfig(vocab_size=1024, dim=64, depth=1, seq_len=16)
    scorer = gru.GRUScorer(cfg)
    model = scorer.init_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    assert abs(model.tok_embed.weight.std().item() - (1 / 64) ** 0.5) < 0.005
    assert abs(model.bos_embed.std().item() - 0.02) < 0.006
    cell = model.rnns[0]
    assert abs(cell["ir"].weight.std().item() - (1 / 64) ** 0.5) < 0.01
    assert not cell["in"].bias.any() and not cell["hn"].bias.any()
    for name in gru.HIDDEN_GATES:  # orthogonal
        w = cell[name].weight
        torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5, rtol=0)
    assert cell["hr"].bias is None and cell["hz"].bias is None
    assert (model.final_ln.weight == 1).all() and model.final_ln.eps == 1e-6
    again = scorer.init_model(torch.device("cpu"), torch.Generator().manual_seed(0))
    assert torch.equal(again.rnns[0]["hz"].weight, cell["hz"].weight)


def test_config_mirrors_the_jax_config():
    ref = jax_gru.GRUScorerConfig()
    port = gru.GRUScorerConfig()
    for name in ("vocab_size", "dim", "depth", "seq_len", "learning_rate", "score_topk",
                 "score_vocab", "head_impl"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.learning_rate == 2e-3 and port.dtype == torch.bfloat16
