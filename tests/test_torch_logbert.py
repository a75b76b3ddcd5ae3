"""The port's LogBERT scorer (``models/logbert.py`` over
``SequenceScorerBase``) against the JAX package's ``LogBERTScorer`` on
bridged weights: hidden states, per-token NLLs, scores and positional
z-scores through every attention path and both heads, exact and
candidate-vocab (training: ``test_torch_logbert_train.py``).

The JAX side runs its Pallas kernels (flash attention, the fused head) in
interpret mode; the port computes their plain versions on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.models import base as jax_base
from detectmateservice_tpu.models import logbert as jax_lb
from detectmateservice_tpu_torch.models import logbert as lb
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.models.tokenizer import PAD_ID

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# blockwise attention takes whole 128-key blocks, so its cases run at 128
_SEQ = {"einsum": 16, "flash": 16, "blockwise": 128}


def _sizes(attn):
    return dict(vocab_size=4096, dim=32, depth=2, heads=2, seq_len=_SEQ[attn])


def _tokens(seq_len, seed=7, n=8):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, 4000, (n, seq_len)).astype(np.int32)
    for i in range(0, n, 2):  # ragged PAD tails
        toks[i, seq_len - (i % 8 + 1) * seq_len // 16:] = PAD_ID
    toks[3] = PAD_ID  # one all-PAD row
    return toks


@functools.lru_cache(maxsize=None)
def _flax_init(attn, dtype, seed):
    """The JAX scorer's seeded (params, opt_state): the tree depends on the
    sizes only, so one init serves every head and vocab option."""
    cfg = jax_lb.LogBERTConfig(**_sizes(attn), dtype=_DTYPES[dtype][0])
    return jax_lb.LogBERTScorer(cfg).init(jax.random.PRNGKey(seed))


def _pair(attn="einsum", head="einsum", vocab=0, topk=0, dtype="float32", seed=0):
    jdt, tdt = _DTYPES[dtype]
    opts = dict(_sizes(attn), attn_impl=attn, head_impl=head, score_vocab=vocab,
                score_topk=topk)
    jax_scorer = jax_lb.LogBERTScorer(jax_lb.LogBERTConfig(**opts, dtype=jdt))
    params, opt_state = _flax_init(attn, dtype, seed)
    scorer = lb.LogBERTScorer(lb.LogBERTConfig(**opts, dtype=tdt))
    model = scorer.init_model(torch.device("cpu"))
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_scorer, params, opt_state, scorer, model


@pytest.mark.parametrize("attn", ["einsum", "flash", "blockwise"])
def test_hidden_states_match(attn):
    jax_scorer, params, _, _, model = _pair(attn)
    toks = _tokens(_SEQ[attn])
    want = np.asarray(jax.jit(lambda p, t: jax_scorer.model.apply(
        p, t, method="hidden"))(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = model.hidden(torch.from_numpy(toks).long()).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("vocab", [0, 64])
@pytest.mark.parametrize("head", ["einsum", "pallas"])
@pytest.mark.parametrize("attn", ["einsum", "flash", "blockwise"])
def test_nlls_scores_and_normscores_match(attn, head, vocab):
    """Per-token NLLs from the JAX scorer's jitted impl; its score and
    normscore follow from them through the JAX package's own reductions
    (as its ``_score_impl``/``_normscore_impl`` do), at top-k 0 and 4."""
    jax_scorer, params, _, scorer, model = _pair(attn, head, vocab)
    seq = _SEQ[attn]
    toks = _tokens(seq, seed=len(attn) + vocab)
    jtoks = jnp.asarray(toks)
    want_nlls = jax_scorer._token_nlls(params, jtoks)
    mask = (jtoks != PAD_ID).astype(jnp.float32)
    ttoks = torch.from_numpy(toks)
    got_nlls = scorer.token_nlls(model, ttoks).numpy()
    np.testing.assert_allclose(got_nlls, np.asarray(want_nlls), rtol=1e-4, atol=1e-4)
    assert (got_nlls[toks == PAD_ID] == 0).all()
    for topk in (0, 4):
        port = lb.LogBERTScorer(lb.LogBERTConfig(
            **_sizes(attn), attn_impl=attn, head_impl=head, score_vocab=vocab,
            score_topk=topk, dtype=torch.float32))
        want = np.asarray(jax_base.reduce_nlls(want_nlls, mask, topk))
        got = port.score(model, ttoks).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert got[3] == 0.0  # all-PAD row
    rng = np.random.default_rng(9)
    mu = rng.uniform(5, 9, seq).astype(np.float32)
    sigma = rng.uniform(0.05, 2, seq).astype(np.float32)
    want = np.asarray(jax_base.positional_z_max(want_nlls, jtoks, mu, sigma))
    got = scorer.normscore(model, ttoks, torch.from_numpy(mu),
                           torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_jitted_score_and_normscore_match_end_to_end():
    """The JAX scorer's own ``_score`` and ``_normscore`` (one config)."""
    jax_scorer, params, _, scorer, model = _pair("flash", "pallas", 0, topk=4)
    toks = _tokens(16, seed=3)
    want = np.asarray(jax_scorer.score(params, jnp.asarray(toks)))
    got = scorer.score(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    mu = np.full(16, 7.0, np.float32)
    sigma = np.full(16, 0.5, np.float32)
    want = np.asarray(jax_scorer._normscore(params, jnp.asarray(toks), mu, sigma))
    got = scorer.normscore(model, torch.from_numpy(toks), torch.from_numpy(mu),
                           torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("attn,head", [("einsum", "einsum"), ("flash", "pallas")])
def test_bf16_scores_within_bound(attn, head):
    """bf16 compute rounds at other places in the two frameworks; the bound
    is the one tests/test_scorehead.py holds the two JAX heads to."""
    jax_scorer, params, _, scorer, model = _pair(attn, head, dtype="bfloat16")
    toks = _tokens(16, seed=11)
    want = np.asarray(jax_scorer.score(params, jnp.asarray(toks)))
    got = scorer.score(model, torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 0.05


def test_candidate_ids_are_the_jax_packages():
    _, _, _, scorer, _ = _pair()
    jax_scorer = jax_lb.LogBERTScorer(jax_lb.LogBERTConfig(**_sizes("einsum")))
    for vocab, n in ((4096, 64), (32768, 2048)):
        np.testing.assert_array_equal(scorer._candidate_ids(vocab, n),
                                      jax_scorer._candidate_ids(vocab, n))
        assert scorer._candidate_ids(vocab, n).dtype == np.int32
