"""The port's weight-only int8 quantization (``models/quant.py``) against the
JAX package's ``quantize_tree`` / ``dequantize_tree`` / ``quant_stats`` on
the bridged MLP, GRU and LogBERT trees.

Tolerances: int8 payloads equal; scales within 1 ulp of fp32 (both compute
``max(amax, 1e-8) / 127`` in fp32); the same eligible leaves; equal
``quant_stats``; dequantized weights within 1 ulp of the compute dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.models import gru as jax_gru
from detectmateservice_tpu.models import logbert as jax_lb
from detectmateservice_tpu.models import mlp as jax_mlp
from detectmateservice_tpu.models import quant as jax_quant
from detectmateservice_tpu_torch.models import gru, logbert, mlp, quant
from detectmateservice_tpu_torch.models.convert import params_from_flax


def _family(name):
    """(JAX scorer, port module) of one family at a small size."""
    if name == "mlp":
        sizes = dict(vocab_size=1024, dim=32, hidden=64, seq_len=16)
        return (jax_mlp.MLPScorer(jax_mlp.MLPScorerConfig(**sizes)),
                mlp.EmbedMLPModel(mlp.MLPScorerConfig(**sizes)))
    if name == "gru":
        sizes = dict(vocab_size=1024, dim=32, depth=2, seq_len=16)
        return (jax_gru.GRUScorer(jax_gru.GRUScorerConfig(**sizes)),
                gru.GRULM(gru.GRUScorerConfig(**sizes)))
    sizes = dict(vocab_size=1024, dim=32, depth=2, heads=2, seq_len=64)
    return (jax_lb.LogBERTScorer(jax_lb.LogBERTConfig(**sizes)),
            logbert.LogBERT(logbert.LogBERTConfig(**sizes)))


def _is_leaf(x):
    return isinstance(x, tuple)


def _bridge(qtree, pick):
    """A flax-shaped tree of one part of each quantized leaf, bridged into
    the port's keys and layouts (a 1-D leaf bridges as is)."""
    part = jax.tree_util.tree_map(lambda leaf: np.asarray(pick(leaf)), qtree,
                                  is_leaf=_is_leaf)
    return params_from_flax(part)


@pytest.fixture(scope="module", params=["mlp", "gru", "logbert"])
def quantized(request):
    jax_scorer, model = _family(request.param)
    params, _ = jax_scorer.init(jax.random.PRNGKey(3))
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict(state)
    qtree = jax_quant.quantize_tree(params)
    qstate = quant.quantize(model.state_dict(), quant.linear_weight_keys(model))
    return request.param, params, qtree, qstate


def test_same_leaves_quantize(quantized):
    name, _, qtree, qstate = quantized
    flags = _bridge(qtree, lambda leaf: np.full(1, len(leaf) == 2))
    want = {key for key, flag in flags.items() if bool(flag[0])}
    assert want == {key for key, leaf in qstate.items() if len(leaf) == 2}
    # the embedding always quantizes, no bias or norm vector does
    assert "tok_embed.weight" in want and not any(k.endswith("bias") for k in want)
    if name == "gru":
        assert {"rnns.0.hr.weight", "rnns.1.in.weight"} <= want and "bos_embed" not in want


def test_int8_payloads_equal(quantized):
    _, _, qtree, qstate = quantized
    want = _bridge(qtree, lambda leaf: leaf[0])   # int8 values, exact in fp32
    for key, leaf in qstate.items():
        if len(leaf) == 2:
            assert leaf[0].dtype == torch.int8
            assert torch.equal(leaf[0].float(), want[key]), key
        else:
            assert torch.equal(leaf[0], want[key]), key


def test_scales_within_one_ulp_on_flax_last_axis(quantized):
    _, _, qtree, qstate = quantized
    want = _bridge(qtree, lambda leaf: leaf[1] if len(leaf) == 2 else np.zeros(1))
    for key, leaf in qstate.items():
        if len(leaf) == 2:
            q, scale = leaf
            assert scale.dtype == torch.float32
            # one scale per flax output channel: rows of a Linear weight,
            # D columns of an embedding
            axis = 0 if key in quant.linear_weight_keys(_family(quantized[0])[1]) else 1
            assert scale.shape[axis] == q.shape[axis] and scale.numel() == q.shape[axis]
            np.testing.assert_array_max_ulp(scale.flatten().numpy(), want[key].numpy(), maxulp=1)


def test_quant_stats_equal(quantized):
    _, _, qtree, qstate = quantized
    assert quant.quant_stats(qstate) == jax_quant.quant_stats(qtree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches(quantized, dtype):
    _, _, qtree, qstate = quantized
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = params_from_flax(jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
        jax_quant.dequantize_tree(qtree, jdt)))
    got = quant.dequantize(qstate, tdt)
    assert set(got) == set(want)
    for key, value in got.items():
        if len(qstate[key]) == 2:
            assert value.dtype == tdt
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23
        np.testing.assert_allclose(value.float().numpy(), want[key].numpy(),
                                   rtol=ulp, atol=0, err_msg=key)


def test_rounding_floor_and_eligibility_match_the_jax_package():
    """Half-to-even rounding, the 1e-8 scale floor of an all-zero channel,
    and the size and rank rule, on constructed leaves."""
    w = np.zeros((32, 40), np.float32)
    w[:, 0] = 127.0                          # column 0: scale exactly 1
    w[:5, 0] = [2.5, 3.5, -2.5, -0.5, 127.0]
    w[:, 1] = np.linspace(-3, 3, 32)
    # column 2 stays all zero: floor scale
    tree = {"params": {"tok_embed": {"embedding": w}}}
    want_q, want_s = jax_quant.quantize_tree(tree)["params"]["tok_embed"]["embedding"]
    q, scale = quant.quantize({"tok_embed.weight": torch.from_numpy(w)}, ())["tok_embed.weight"]
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(scale.flatten().numpy(), np.asarray(want_s))
    assert q[:4, 0].tolist() == [2, 4, -2, 0]   # half to even
    assert scale[0, 2].item() == pytest.approx(1e-8 / 127) and not q[:, 2].any()
    for shape, want in (((32, 32), True), ((1023, 1), False), ((4096,), False),
                        ((2, 16, 32), True)):
        t = torch.zeros(shape)
        assert quant.eligible(t) == jax_quant.eligible(np.zeros(shape, np.float32)) == want
    assert not quant.eligible(torch.zeros((64, 64), dtype=torch.int32))
