"""The port's ring attention and sequence-parallel scoring
(``parallel/ring.py``, ``attn_impl: ring``) against the JAX package's
(``tests/test_parallel.py``'s counterparts; the mesh, the sharded scorer's
data and model axes and the detector's mesh mode are in
``test_torch_parallel.py``): blockwise and ring attention with and without
PAD masks, the ring's gradients, and LogBERT scoring and training on
dp×sp and pure sequence meshes.

The JAX side runs on the 8-device virtual CPU mesh; the port's meshes
repeat the CPU eight times (``mesh.local_devices``). Inputs are
numpy-seeded, weights bridged by ``models/convert.py``. Tolerances: fp32
attention and scores 1e-4 (blockwise 1e-5); one train step's loss and
weights 1e-5 on every element whose gradient is at least 1e-7 in
magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.ops import attention as jax_attention
from detectmateservice_tpu.parallel import ShardedScorer as JaxShardedScorer
from detectmateservice_tpu.parallel import make_mesh as jax_make_mesh
from detectmateservice_tpu.parallel import ring_attention as jax_ring_attention
from detectmateservice_tpu_torch.ops import attention
from detectmateservice_tpu_torch.parallel import ShardedScorer, make_mesh, ring_attention
from test_torch_parallel import (CPU, _assert_step_equal, _grads, _jax_logbert, _jax_mask,
                                 _port_logbert, _qkv, _sharded_pair)
from test_torch_parallel import eight_cpu_shards  # noqa: F401  (autouse fixture)


class TestAttentionVariants:
    def test_blockwise_matches_reference(self):
        q, k, v = _qkv(0, (2, 2, 32, 8))
        want = np.asarray(jax_attention.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                                            block_size=8))
        got = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)), block_size=8)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        ref = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
        assert float((ref - got).abs().max()) < 1e-5

    @pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "pad_mask"])
    def test_ring_matches_reference(self, padded):
        """{seq: 8} and {data: 2, seq: 4}: the port's ring against the JAX
        ring and the one-device einsum attention, within 1e-4."""
        q, k, v = _qkv(1 + padded)
        valid = np.broadcast_to(np.arange(64)[None, :] < (40 if padded else 64), (2, 64))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        ref = attention.dot_product_attention(
            tq, tk, tv, torch.from_numpy(valid.copy())[:, None, None, :])
        for shape, batch_axis in (({"seq": 8}, None), ({"data": 2, "seq": 4}, "data")):
            want = np.asarray(jax_ring_attention(
                *map(jnp.asarray, (q, k, v)), jax_make_mesh(shape),
                kv_valid=jnp.asarray(valid), batch_axis=batch_axis))
            got = ring_attention(tq, tk, tv, make_mesh(shape),
                                 kv_valid=torch.from_numpy(valid.copy()),
                                 batch_axis=batch_axis)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
            assert float((got - ref).abs().max()) < 1e-4

    def test_ring_gradients_match_the_jax_ring(self):
        """The ring is differentiable end to end, as JAX's lax.scan ring."""
        q, k, v = _qkv(3)
        valid = np.broadcast_to(np.arange(64)[None, :] < 50, (2, 64))
        jmesh = jax_make_mesh({"seq": 8})

        def jloss(q, k, v):
            return jnp.sum(jax_ring_attention(q, k, v, jmesh, kv_valid=jnp.asarray(valid)) ** 2)

        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        out = ring_attention(tq, tk, tv, make_mesh({"seq": 8}),
                             kv_valid=torch.from_numpy(valid.copy()))
        (out ** 2).sum().backward()
        for t, w in zip((tq, tk, tv), want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4)


class TestSequenceParallelScorer:
    """LogBERT with attn_impl ring: its attention runs as a ring over the
    mesh's seq axis, in scoring and in training."""

    def test_dp_sp_score_matches_einsum(self):
        jax_sharded, port = _sharded_pair({"data": 2, "seq": 4},
                                          _jax_logbert(attn_impl="ring"),
                                          _port_logbert(attn_impl="ring"))
        tokens = np.random.default_rng(11).integers(3, 512, (8, 16)).astype(np.int32)
        tokens[:, -3:] = 0  # PAD tail crosses the last seq shard
        einsum = _port_logbert(attn_impl="einsum")
        single = einsum.init_model(CPU)
        single.load_state_dict(port.state_dict())
        got = port.score(tokens)
        np.testing.assert_allclose(got, jax_sharded.score(tokens), atol=1e-4)
        np.testing.assert_allclose(got, einsum.score(single, torch.from_numpy(tokens)).numpy(),
                                   atol=1e-4)

    def test_pure_seq_mesh_score(self):
        jax_sharded, port = _sharded_pair({"seq": 8}, _jax_logbert(attn_impl="ring"),
                                          _port_logbert(attn_impl="ring"))
        tokens = np.random.default_rng(12).integers(3, 512, (5, 16)).astype(np.int32)
        np.testing.assert_allclose(port.score(tokens), jax_sharded.score(tokens), atol=1e-4)

    def test_dp_sp_training_converges(self):
        jax_sharded, port = _sharded_pair({"data": 2, "seq": 4},
                                          _jax_logbert(attn_impl="ring"),
                                          _port_logbert(attn_impl="ring"))
        tokens = np.random.default_rng(13).integers(3, 512, (8, 16)).astype(np.int32)
        rng = jax.random.PRNGKey(1)
        mask = _jax_mask(rng, tokens)
        grads = _grads(_port_logbert(attn_impl="einsum"), port.state_dict(), tokens, mask)
        first = port.train_step(tokens, mask=mask)
        _assert_step_equal(jax_sharded, port, grads, jax_sharded.train_step(rng, tokens), first)
        losses = [port.train_step(tokens, torch.Generator().manual_seed(i + 2))
                  for i in range(12)]
        assert np.isfinite(first) and min(losses) < first

    def test_seq_len_must_divide(self):
        with pytest.raises(ValueError, match="seq_len"):
            JaxShardedScorer(_jax_logbert(seq_len=12, attn_impl="ring"),
                             mesh=jax_make_mesh({"seq": 8}))
        with pytest.raises(ValueError, match="seq_len"):
            ShardedScorer(_port_logbert(seq_len=12, attn_impl="ring"),
                          mesh=make_mesh({"seq": 8}))

    def test_ring_without_mesh_context_raises(self):
        with pytest.raises(ValueError, match="ring"):
            _jax_logbert(attn_impl="ring").init(jax.random.PRNGKey(0))
        scorer = _port_logbert(attn_impl="ring")
        with pytest.raises(ValueError, match="ring"):
            scorer.score(scorer.init_model(CPU), torch.ones((2, 16), dtype=torch.long))


class TestMaskedRows:
    def test_blockwise_fully_masked_row_matches_reference(self):
        q, k, v = _qkv(4, (1, 2, 16, 8))
        mask = np.ones((1, 2, 16, 16), bool)
        mask[0, :, 3, :] = False
        want = np.asarray(jax_attention.blockwise_attention(
            *map(jnp.asarray, (q, k, v)), block_size=8, mask=jnp.asarray(mask)))
        got = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)), block_size=8,
                                            mask=torch.from_numpy(mask))
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
