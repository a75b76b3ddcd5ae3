"""The weight bridge between the JAX package's flax param tree and the
port's ``state_dict``: the round trip is exact in both directions and the
bridged module computes what the flax module computes."""
import jax
import numpy as np
import torch

from detectmateservice_tpu.models.mlp import MLPScorer as JaxMLPScorer
from detectmateservice_tpu.models.mlp import MLPScorerConfig as JaxMLPConfig
from detectmateservice_tpu_torch.models.convert import params_from_flax, params_to_flax
from detectmateservice_tpu_torch.models.mlp import EmbedMLPModel, MLPScorerConfig

_SIZES = dict(vocab_size=4096, dim=32, hidden=64, seq_len=16)


def _flax_params(seed=0):
    scorer = JaxMLPScorer(JaxMLPConfig(**_SIZES, dtype=jax.numpy.float32))
    params, _ = scorer.init(jax.random.PRNGKey(seed))
    return scorer, jax.tree_util.tree_map(np.asarray, params)


def test_flax_to_torch_to_flax_is_exact():
    _, tree = _flax_params()
    state = params_from_flax(tree)
    model = EmbedMLPModel(MLPScorerConfig(**_SIZES, dtype=torch.float32))
    model.load_state_dict(state, strict=True)  # every key, every shape
    back = params_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert state["fc1.weight"].shape == (64, 32)  # Dense_0/kernel [D, H] transposed
    np.testing.assert_array_equal(state["fc1.weight"].numpy(),
                                  tree["params"]["Dense_0"]["kernel"].T)


def test_torch_to_flax_to_torch_is_exact():
    model = EmbedMLPModel(MLPScorerConfig(**_SIZES, dtype=torch.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    back = params_from_flax(params_to_flax(state))
    assert set(back) == set(state)
    for name, value in state.items():
        assert torch.equal(back[name], value), name
        assert back[name].data_ptr() != value.data_ptr()  # copies, no aliasing


def test_bridged_module_computes_the_flax_forward():
    scorer, tree = _flax_params(seed=3)
    tokens = np.random.default_rng(3).integers(0, 4096, (8, 16)).astype(np.int32)
    tokens[:, 12:] = 0
    want = np.asarray(scorer.model.apply(tree, tokens))
    model = EmbedMLPModel(MLPScorerConfig(**_SIZES, dtype=torch.float32))
    model.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _logbert_flax_params(seed=0, depth=2):
    from detectmateservice_tpu.models.logbert import LogBERTConfig as JaxLogBERTConfig
    from detectmateservice_tpu.models.logbert import LogBERTScorer as JaxLogBERTScorer

    scorer = JaxLogBERTScorer(JaxLogBERTConfig(vocab_size=4096, dim=32, depth=depth,
                                               heads=2, seq_len=16,
                                               dtype=jax.numpy.float32))
    params, _ = scorer.init(jax.random.PRNGKey(seed))
    return scorer, jax.tree_util.tree_map(np.asarray, params)


def _logbert_model(depth=2):
    from detectmateservice_tpu_torch.models.logbert import LogBERT, LogBERTConfig

    return LogBERT(LogBERTConfig(vocab_size=4096, dim=32, depth=depth, heads=2,
                                 seq_len=16, dtype=torch.float32))


def test_logbert_tree_round_trips_exactly():
    """The LogBERT tree: tok_embed, pos_embed, blocks_{i}/{LayerNorm_0,
    LayerNorm_1, qkv, proj, mlp_in, mlp_out}, final_ln — every leaf, bit for
    bit, both ways, with the family read from the keys."""
    _, tree = _logbert_flax_params()
    state = params_from_flax(tree)
    model = _logbert_model()
    model.load_state_dict(state, strict=True)
    back = params_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    blk = tree["params"]["blocks_1"]
    np.testing.assert_array_equal(state["blocks.1.qkv.weight"].numpy(), blk["qkv"]["kernel"].T)
    np.testing.assert_array_equal(state["blocks.1.ln2.weight"].numpy(),
                                  blk["LayerNorm_1"]["scale"])
    again = params_from_flax(params_to_flax(state))
    assert set(again) == set(state)
    for name, value in state.items():
        assert torch.equal(again[name], value) and again[name].data_ptr() != value.data_ptr()


def test_family_can_be_named():
    _, tree = _logbert_flax_params(depth=1)
    assert set(params_from_flax(tree, family="logbert")) == set(params_from_flax(tree))
    _, mlp_tree = _flax_params()
    assert set(params_from_flax(mlp_tree, family="mlp")) == \
        {"tok_embed.weight", "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    import pytest

    with pytest.raises(ValueError, match="family"):
        params_from_flax(tree, family="rnn")


def test_bridged_logbert_computes_the_flax_forward():
    scorer, tree = _logbert_flax_params(seed=3)
    tokens = np.random.default_rng(3).integers(2, 4096, (4, 16)).astype(np.int32)
    tokens[:, 12:] = 0
    want = np.asarray(scorer.model.apply(tree, tokens))
    model = _logbert_model()
    model.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
