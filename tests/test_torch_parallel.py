"""The port's chip plane (``detectmateservice_tpu_torch/parallel``) against
the JAX package's (``tests/test_parallel.py``'s counterparts): mesh
construction, the sharding rules, the sharded scorer's scores and train
steps on dp×tp and dp meshes, the ``model`` axis's split (each slice
against the JAX array's shard at the same mesh position, scores and one
step against the JAX ``ShardedScorer`` and against the port's whole
weights, the gathered head), int8 placement, the capture map, and the
detector's mesh mode (ring attention and the sequence axis:
``test_torch_ring.py``).

The JAX side runs on the 8-device virtual CPU mesh (``tests/conftest.py``);
the port's meshes repeat the CPU eight times, which ``mesh.local_devices``
gives them here (on one card, ``chip_smoke.py`` repeats ``cuda:0`` the same
way). Inputs are numpy-seeded; weights are bridged from the JAX tree by
``models/convert.py``, and the comparisons gather whole tensors whatever
the shard layout. Tolerances: fp32 scores and attention 1e-4; one train
step's loss and weights 1e-5 on every element whose gradient is at least
1e-7 in magnitude (AdamW's eps amplifies smaller ones, ROADMAP.md's
register); the split forward against the port's whole-weight forward 1e-5;
decisions at a threshold pinned at the JAX scores' median: no flip
farther than 1e-4 from it; slices and shards exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.models import LogBERTConfig as JaxLogBERTConfig
from detectmateservice_tpu.models import LogBERTScorer as JaxLogBERTScorer
from detectmateservice_tpu.models import MLPScorer as JaxMLPScorer
from detectmateservice_tpu.models import MLPScorerConfig as JaxMLPScorerConfig
from detectmateservice_tpu.parallel import LOGBERT_RULES as JAX_LOGBERT_RULES
from detectmateservice_tpu.parallel import ShardedScorer as JaxShardedScorer
from detectmateservice_tpu.parallel import make_mesh as jax_make_mesh
from detectmateservice_tpu.parallel import tree_shardings as jax_tree_shardings
from detectmateservice_tpu_torch.models import quant
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.models.logbert import LogBERTConfig, LogBERTScorer
from detectmateservice_tpu_torch.models.mlp import MLPScorer, MLPScorerConfig
from detectmateservice_tpu_torch.parallel import (LOGBERT_RULES, ShardedScorer, make_mesh,
                                                  tree_shardings)
from detectmateservice_tpu_torch.parallel import mesh as port_mesh

CPU = torch.device("cpu")
TINY = dict(vocab_size=512, dim=64, depth=2, heads=2, seq_len=16)


@pytest.fixture(autouse=True)
def eight_cpu_shards(monkeypatch):
    """The port's mesh devices: the CPU, eight times."""
    monkeypatch.setattr(port_mesh, "local_devices", lambda device_type="cuda": [CPU] * 8)


def _flat(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _jax_logbert(**kw):
    return JaxLogBERTScorer(JaxLogBERTConfig(**dict(TINY, dtype=jnp.float32, **kw)))


def _port_logbert(**kw):
    return LogBERTScorer(LogBERTConfig(**dict(TINY, dtype=torch.float32, **kw)))


def _sharded_pair(mesh_shape, jax_scorer, port_scorer, seed=0):
    """The JAX ShardedScorer and the port's on the same (bridged) weights."""
    jax_sharded = JaxShardedScorer(jax_scorer, mesh=jax_make_mesh(mesh_shape),
                                   rng=jax.random.PRNGKey(seed))
    port = ShardedScorer(port_scorer, mesh=make_mesh(mesh_shape, device_type="cpu"))
    port.install_params(_flat(jax_sharded.params))
    return jax_sharded, port


def _leaf_ids(params):
    """Port key -> a tensor filled with the index of its JAX leaf (in
    ``tree_leaves`` order): the bridge's map from flax paths to keys."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(leaf), i, np.float32) for i, leaf in enumerate(leaves)])
    return params_from_flax(ids)


def _qkv(seed, shape=(2, 2, 64, 8)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_mask(rng, tokens, mask_prob=0.15):
    """The mask the JAX LogBERT train step draws from ``rng`` over the
    padded batch (``models/logbert.py`` ``_train_impl``)."""
    mask_rng, _ = jax.random.split(rng)
    draw = np.asarray(jax.random.uniform(mask_rng, tokens.shape))
    return (draw < mask_prob) & (tokens != 0)


def _grads(port_scorer, state, tokens, mask):
    """Per-key gradient of one step's loss on one device (for the element
    filter of the step comparison)."""
    model = port_scorer.init_model(CPU)
    model.load_state_dict(state)
    tokens = torch.from_numpy(tokens).long()
    mask = None if mask is None else torch.from_numpy(mask)
    (port_scorer.loss_sum(model, tokens, mask)
     / torch.clamp(port_scorer.loss_count(tokens, mask), min=1.0)).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _assert_step_equal(jax_sharded, port, grads, jax_loss, port_loss):
    assert port_loss == pytest.approx(jax_loss, abs=1e-5)
    want, got = _flat(jax_sharded.params), port.state_dict()
    for key, g in grads.items():
        keep = g.abs() >= 1e-7
        np.testing.assert_allclose(got[key].detach()[keep].numpy(), want[key][keep].numpy(),
                                   atol=1e-5, err_msg=key)


class TestMesh:
    def test_default_mesh_all_devices(self):
        mesh = make_mesh()
        assert mesh.size == len(jax.devices()) == jax_make_mesh().devices.size == 8
        assert mesh.shape == {"data": 8} and mesh.lead == CPU

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError):
            jax_make_mesh({"data": 3})
        with pytest.raises(ValueError, match="needs 3 devices, have 8"):
            make_mesh({"data": 3})

    def test_logbert_tp_rules_shard_ffn(self):
        """Every leaf's spec is the JAX rule's, transposed for a Linear
        weight ([out, in] against flax's [in, out] kernel)."""
        params, _ = _jax_logbert().init(jax.random.PRNGKey(0))
        jax_specs = [tuple(s.spec) for s in jax.tree_util.tree_leaves(jax_tree_shardings(
            jax_make_mesh({"data": 4, "model": 2}), params, JAX_LOGBERT_RULES))]
        leaf_of = _leaf_ids(params)
        port = tree_shardings(make_mesh({"data": 4, "model": 2}), _flat(params),
                              LOGBERT_RULES)
        linear = quant.linear_weight_keys(_port_logbert().meta_model())
        for key, ident in leaf_of.items():
            ndim = ident.dim()
            want = (list(jax_specs[int(ident.flatten()[0])]) + [None] * ndim)[:ndim]
            if key in linear:
                want = want[::-1]
            got = (list(port[key].spec) + [None] * ndim)[:ndim]
            assert got == want, key
        assert port["blocks.0.qkv.weight"].spec == ("model", None)
        assert port["blocks.0.mlp_out.weight"].spec == (None, "model")


class TestShardedScorer:
    def test_dp_tp_train_and_score(self):
        """{data: 4, model: 2}, a ragged batch of 13: one step equals the
        JAX step (same mask), the loss then falls, scores keep the batch."""
        jax_sharded, port = _sharded_pair({"data": 4, "model": 2}, _jax_logbert(),
                                          _port_logbert())
        tokens = np.random.default_rng(7).integers(3, 512, (13, 16)).astype(np.int32)
        padded = tokens[np.arange(16) % 13]            # both pad by repeating rows
        rng = jax.random.PRNGKey(0)
        mask = _jax_mask(rng, padded)
        grads = _grads(port.scorer, port.state_dict(), padded, mask)
        jax_loss = jax_sharded.train_step(rng, tokens)
        port_loss = port.train_step(padded, mask=mask)
        _assert_step_equal(jax_sharded, port, grads, jax_loss, port_loss)
        losses = [port.train_step(tokens, torch.Generator().manual_seed(i)) for i in range(12)]
        assert min(losses) < port_loss
        scores = port.score(tokens)
        assert scores.shape == (13,)
        # the model axis's split is applied: every data row holds the
        # stepped qkv as two [96, 64] slices of the whole
        whole = port.state_dict()["blocks.0.qkv.weight"]
        assert port.shardings["blocks.0.qkv.weight"].spec == ("model", None) and port.split
        assert tuple(whole.shape) == (192, 64)
        for row in port._rows:
            assert [tuple(t.shape) for t in row["blocks.0.qkv.weight"]] == [(96, 64)] * 2
            torch.testing.assert_close(torch.cat(row["blocks.0.qkv.weight"]), whole,
                                       rtol=0, atol=0)

    @pytest.mark.parametrize("mesh_shape,heads", [({"data": 4, "model": 2}, 2),
                                                  ({"data": 2, "model": 4}, 4)],
                             ids=["data4-model2", "data2-model4"])
    def test_split_leaves_equal_the_jax_shards(self, mesh_shape, heads):
        """Each leaf the rules split: the port's slice on shard (d, j) is
        the JAX array's addressable shard at the same mesh position (a
        Linear's transposed), exactly; a replicated leaf stays whole on the
        row's first device, as JAX replicates it."""
        jax_sharded, port = _sharded_pair(mesh_shape, _jax_logbert(heads=heads),
                                          _port_logbert(heads=heads))
        assert port.split and port.model_parallelism == mesh_shape["model"]
        jmesh = jax_sharded.mesh
        leaves = jax.tree_util.tree_leaves(jax_sharded.params)
        leaf_of = _leaf_ids(jax_sharded.params)
        linear = quant.linear_weight_keys(port.scorer.meta_model())
        split = 0
        for key, ident in leaf_of.items():
            arr = leaves[int(ident.flatten()[0])]
            by_device = {shard.device: np.asarray(shard.data) for shard in arr.addressable_shards}
            spec = tuple(port.shardings[key].spec)
            for d in range(mesh_shape["data"]):
                parts = port._rows[d][key]
                if "model" not in spec:
                    assert len(parts) == 1, key
                    continue
                assert len(parts) == mesh_shape["model"], key
                for j, part in enumerate(parts):
                    want = by_device[jmesh.devices[d, j]]
                    want = want.T if key in linear else want
                    assert tuple(part.shape) == want.shape, key
                    np.testing.assert_array_equal(part.detach().numpy(), want, err_msg=key)
            split += "model" in spec
        # tok_embed, and qkv, proj, mlp_in, mlp_out weights and the two
        # column-parallel biases in each of the two blocks
        assert split == 1 + 2 * 6
        held = port.shard_bytes()
        assert held["per_shard"] == [[held["whole"] // mesh_shape["model"]]
                                     * mesh_shape["model"]] * mesh_shape["data"]

    @pytest.mark.parametrize("mesh_shape,heads,attn", [
        ({"data": 4, "model": 2}, 2, "auto"), ({"data": 2, "model": 4}, 4, "auto"),
        ({"data": 2, "seq": 2, "model": 2}, 2, "ring")],
        ids=["data4-model2", "data2-model4", "data2-seq2-model2"])
    def test_split_scores_and_step_against_jax(self, mesh_shape, heads, attn):
        """Scores against the JAX ShardedScorer on the same mesh and against
        the port's whole weights on one device, decisions at a pinned
        threshold, then one train step (same mask) against JAX's."""
        jax_sharded, port = _sharded_pair(mesh_shape, _jax_logbert(heads=heads, attn_impl=attn),
                                          _port_logbert(heads=heads, attn_impl=attn))
        assert port.split
        tokens = np.random.default_rng(11).integers(3, 512, (16, 16)).astype(np.int32)
        tokens[3, 7:] = 0
        want = np.asarray(jax_sharded.score(tokens))
        got = port.score(tokens)
        np.testing.assert_allclose(got, want, atol=1e-4)
        one = _port_logbert(heads=heads)     # whole weights, one device
        single = one.init_model(CPU)
        single.load_state_dict(port.state_dict())
        np.testing.assert_allclose(got, one.score(single, torch.from_numpy(tokens)).numpy(),
                                   atol=1e-5)
        threshold = float(np.median(want))
        flips = np.flatnonzero((got > threshold) != (want > threshold))
        assert all(abs(want[i] - threshold) < 1e-4 for i in flips)
        rng = jax.random.PRNGKey(3)
        mask = _jax_mask(rng, tokens)
        grads = _grads(one, port.state_dict(), tokens, mask)
        jax_loss = jax_sharded.train_step(rng, tokens)
        _assert_step_equal(jax_sharded, port, grads, jax_loss, port.train_step(tokens, mask=mask))

    def test_the_gathered_head_is_the_whole_embedding(self):
        """A row's head joins E's D-slices: the whole E, exactly, on the
        row's first device."""
        port = ShardedScorer(_port_logbert(), mesh=make_mesh({"data": 4, "model": 2}))
        whole = port.state_dict()["tok_embed.weight"]
        for d in range(4):
            joined = port.scorer.model_over_shards(port._rows[d]).tok_embed.weight
            assert joined.device == port.row_device(d)
            torch.testing.assert_close(joined, whole, rtol=0, atol=0)
        assert [tuple(t.shape) for t in port._rows[0]["tok_embed.weight"]] == [(512, 32)] * 2

    def test_heads_that_do_not_divide_keep_whole_rows(self):
        """Two heads over a model axis of 4: the rows keep whole weights
        (the spec still records the JAX layout) and score as one device."""
        port = ShardedScorer(_port_logbert(), mesh=make_mesh({"data": 2, "model": 4}))
        assert not port.split and port.shardings["blocks.0.qkv.weight"].spec == ("model", None)
        assert all(len(parts) == 1 for parts in port._rows[0].values())
        tokens = np.random.default_rng(12).integers(3, 512, (4, 16)).astype(np.int32)
        single = port.scorer.init_model(CPU)
        single.load_state_dict(port.state_dict())
        np.testing.assert_allclose(port.score(tokens), port.scorer.score(
            single, torch.from_numpy(tokens)).numpy(), atol=1e-5)

    def test_dp_only_mlp(self):
        cfg = dict(vocab_size=256, dim=32, seq_len=8)
        jax_sharded, port = _sharded_pair(
            {"data": 8}, JaxMLPScorer(JaxMLPScorerConfig(**cfg, dtype=jnp.float32)),
            MLPScorer(MLPScorerConfig(**cfg, dtype=torch.float32)))
        tokens = np.random.default_rng(3).integers(3, 256, (16, 8)).astype(np.int32)
        got = port.score(tokens)
        assert got.shape == (16,)
        np.testing.assert_allclose(got, jax_sharded.score(tokens), atol=1e-4)
        # a data-only step: the mean over the padded batch, as in JAX
        grads = _grads(port.scorer, port.state_dict(), tokens, None)
        jax_loss = jax_sharded.train_step(jax.random.PRNGKey(1), tokens)
        _assert_step_equal(jax_sharded, port, grads, jax_loss, port.train_step(tokens))

    def test_sharded_matches_single_device(self):
        jax_sharded, port = _sharded_pair({"data": 4, "model": 2}, _jax_logbert(),
                                          _port_logbert())
        tokens = np.random.default_rng(5).integers(3, 512, (8, 16)).astype(np.int32)
        tokens[2, 9:] = 0
        single = port.scorer.init_model(CPU)
        single.load_state_dict(port.state_dict())
        one = port.scorer.score(single, torch.from_numpy(tokens)).numpy()
        got = port.score(tokens)
        np.testing.assert_allclose(got, jax_sharded.score(tokens), atol=1e-4)
        np.testing.assert_allclose(got, one, atol=1e-5)

    def test_sharded_candidate_head_matches_single_device(self):
        """score_vocab (the candidate-vocab head) under {data: 8}: every row
        scores with the same seeded subset."""
        from detectmateservice_tpu.models.gru import GRUScorer as JaxGRU
        from detectmateservice_tpu.models.gru import GRUScorerConfig as JaxGRUConfig
        from detectmateservice_tpu_torch.models.gru import GRUScorer, GRUScorerConfig

        cfg = dict(vocab_size=512, dim=32, depth=1, seq_len=16, score_vocab=64)
        jax_sharded, port = _sharded_pair(
            {"data": 8}, JaxGRU(JaxGRUConfig(**cfg, dtype=jnp.float32)),
            GRUScorer(GRUScorerConfig(**cfg, dtype=torch.float32)))
        tokens = np.random.default_rng(9).integers(3, 500, (16, 16)).astype(np.int32)
        np.testing.assert_allclose(port.score(tokens), jax_sharded.score(tokens), atol=1e-4)

    def test_quant_shardings_follow_the_jax_rule(self):
        """An int8 payload is placed like its float leaf, its scale along the
        leaf's channel axis (flax's last axis), as ``quant_shardings`` in the
        JAX package places them."""
        from detectmateservice_tpu.models.quant import quant_shardings as jax_quant_shardings

        scorer = _jax_logbert()
        params, _ = scorer.init(jax.random.PRNGKey(0))
        jmesh = jax_make_mesh({"data": 4, "model": 2})
        jshard = jax_tree_shardings(jmesh, params, JAX_LOGBERT_RULES)
        jq = jax_quant_shardings(params, jshard, jmesh)
        port = ShardedScorer(_port_logbert(), mesh=make_mesh({"data": 4, "model": 2}))
        port.install_params(_flat(params))
        qstate = quant.quantize(port.state_dict(), port.linear_keys)
        placements = quant.quant_shardings(qstate, port.shardings, port.mesh)
        jq_leaves = jax.tree_util.tree_leaves(jq, is_leaf=lambda x: isinstance(x, tuple))
        leaf_of = _leaf_ids(params)
        for key, leaf in qstate.items():
            want = jq_leaves[int(leaf_of[key].flatten()[0])]
            assert len(want) == len(placements[key]), key
            assert placements[key][0] is port.shardings[key]
            if len(leaf) == 2:
                assert ("model" in tuple(placements[key][1].spec)) == \
                    ("model" in tuple(want[1].spec)), key
        port.install_quantized(qstate)
        tokens = np.random.default_rng(2).integers(3, 512, (8, 16)).astype(np.int32)
        deq = quant.dequantize(qstate, torch.float32)
        single = port.scorer.init_model(CPU)
        single.load_state_dict(deq)
        np.testing.assert_allclose(port.score(tokens), port.scorer.score(
            single, torch.from_numpy(tokens)).numpy(), atol=1e-5)

    def test_the_capture_map_serves_every_kind(self):
        """aot_compile_bucket keeps (kind, bucket) entries that _aot_call
        replays (None for a bucket not kept); warm_bucket, token_nlls_device
        and normscore_device give the one-device values on a data mesh."""
        port = ShardedScorer(_port_logbert(), mesh=make_mesh({"data": 8}))
        tokens = np.random.default_rng(8).integers(3, 512, (13, 16)).astype(np.int32)
        tokens[1, 10:] = 0
        single = port.scorer.init_model(CPU)
        single.load_state_dict(port.state_dict())
        t = torch.from_numpy(tokens)
        mu, sigma = np.full(16, 3.0, np.float32), np.full(16, 2.0, np.float32)
        port.aot_compile_bucket("score", tokens)
        assert port.warm.keys() == [("score", 16)] and port._aot_call("score", 8, tokens) is None
        np.testing.assert_allclose(port._aot_call("score", 16, tokens).numpy()[:13],
                                   port.scorer.score(single, t).numpy(), atol=1e-5)
        port.warm_bucket(tokens[:3])
        assert ("score", 8) in port.warm.keys()
        np.testing.assert_allclose(port.token_nlls_device(tokens).numpy()[:13],
                                   port.scorer.token_nlls(single, t).numpy(), atol=1e-5)
        np.testing.assert_allclose(
            port.normscore_device(tokens, mu, sigma).numpy()[:13],
            port.scorer.normscore(single, t, torch.from_numpy(mu), torch.from_numpy(sigma)
                                  ).numpy(), atol=1e-5)
        assert port.data_parallelism == 8

    def test_optimizer_state_moves_between_a_mesh_and_one_device(self):
        """A TP mesh's optimizer state (AdamW over the model axis's slices)
        is in the one-device layout and loads into another mesh shape
        unchanged."""
        port = ShardedScorer(_port_logbert(), mesh=make_mesh({"data": 4, "model": 2}))
        assert port.split
        tokens = np.random.default_rng(4).integers(3, 512, (8, 16)).astype(np.int32)
        port.train_step(tokens, torch.Generator().manual_seed(0))
        whole = port.optimizer.state_dict()
        single = port.scorer.init_model(CPU)
        one = port.scorer.make_optimizer(single)
        one.load_state_dict(whole)      # the one-device layout loads as is
        assert [tuple(e["exp_avg"].shape) for e in one.state_dict()["state"].values()] == \
            [tuple(p.shape) for p in single.parameters()]
        other = ShardedScorer(_port_logbert(heads=4), mesh=make_mesh({"data": 2, "model": 4}))
        other.install_params(port.state_dict(), whole)
        again = other.optimizer.state_dict()
        for j, entry in whole["state"].items():
            for name in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(again["state"][j][name], entry[name],
                                           rtol=0, atol=0)


class TestDetectorMeshMode:
    BLOCK = dict(auto_config=False, model="mlp", vocab_size=1024, dim=32, seq_len=16,
                 max_batch=64, dtype="float32", score_threshold=1e9, data_use_training=0,
                 mesh_shape={"data": 8})

    def test_mesh_mode_against_the_jax_detector(self):
        """Same weights, same tokens: the port's mesh-mode scores against the
        JAX detector's mesh mode, its device label and ledger backend."""
        from detectmateservice_tpu.library.detectors.jax_scorer import JaxScorerDetector
        from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector

        jax_det = JaxScorerDetector(config=dict(self.BLOCK, method_type="jax_scorer"))
        jax_det._ensure_scorer()
        port = TorchScorerDetector(config=dict(self.BLOCK, method_type="torch_scorer",
                                               device="cpu"))
        port._ensure_scorer()
        port.load_params(_flat(jax_det._sharded.params))
        tokens = np.random.default_rng(6).integers(3, 1024, (40, 16)).astype(np.int32)
        np.testing.assert_allclose(port.score_tokens(tokens), jax_det.score_tokens(tokens),
                                   atol=1e-4)
        assert port._device_label == jax_det._device == "mesh(data=8)"
        assert port._obs_backend == jax_det._obs_backend == "mesh"
        assert port._host_scorer is None and port.rollout_ready() is False
        assert port._warm.keys() == [("score", 64)]
        # eight rows of eight: one graph (here, one recorded call) per row
        assert [r.keys() for r in port._warm.rows] == [[("score", 8)]] * 8

    def test_a_mesh_needs_its_devices(self, monkeypatch):
        """Fewer devices than the mesh: both detectors raise ValueError."""
        from detectmateservice_tpu.library.detectors.jax_scorer import JaxScorerDetector
        from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector

        cfg = dict(self.BLOCK, mesh_shape={"data": 16})
        with pytest.raises(ValueError, match="16"):
            JaxScorerDetector(config=dict(cfg, method_type="jax_scorer"))._ensure_scorer()
        port = TorchScorerDetector(config=dict(cfg, method_type="torch_scorer", device="cpu"))
        with pytest.raises(ValueError, match="needs 16 devices, have 8"):
            port.setup_io()

    def test_mesh_checkpoints_move_between_a_mesh_and_one_device(self, tmp_path):
        """A fitted mesh detector's checkpoint restores bit-equal into a
        fresh mesh detector and into a one-device one; an
        install copies a candidate into every row in place (no capture)."""
        from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector

        block = dict(self.BLOCK, method_type="torch_scorer", device="cpu",
                     score_threshold=None, data_use_training=64, min_train_steps=4,
                     train_epochs=1, async_fit=False, mesh_shape={"data": 4, "model": 2},
                     model="logbert", depth=1, heads=2)
        msgs = [_message(i) for i in range(96)]
        det = TorchScorerDetector(config=block)
        det.setup_io()
        assert det._sharded.split
        det.process_batch(msgs[:64])
        tokens, _ = det._featurize_raw_batch(msgs[64:])
        want = det.score_tokens(tokens)
        det.save_checkpoint(str(tmp_path / "ckpt"))
        again = TorchScorerDetector(config=block)
        again.setup_io()
        again.load_checkpoint(str(tmp_path / "ckpt"))
        np.testing.assert_array_equal(again.score_tokens(tokens), want)
        assert again._threshold == det._threshold
        one = TorchScorerDetector(config=dict(block, mesh_shape=None))
        one.setup_io()
        one.load_checkpoint(str(tmp_path / "ckpt"))
        np.testing.assert_allclose(one.score_tokens(tokens), want, atol=1e-5)
        captures = again._warm.captures
        params = {k: v.clone() for k, v in det._sharded.state_dict().items()}
        result = again.install_candidate(params, det._sharded.optimizer.state_dict(), version=3)
        assert result["swapped"] and again._warm.captures == captures
        np.testing.assert_array_equal(again.score_tokens(tokens), want)
        assert again.rollout_ready() is False
        with pytest.raises(Exception, match="mesh"):
            again.rollout_fine_tune(tokens)
        with pytest.raises(Exception, match="mesh"):
            again.rollout_scores(params, tokens)


def _message(i):
    from detectmateservice_tpu_torch.schemas import ParserSchema

    rng = np.random.default_rng(i)
    return ParserSchema(EventID=1, template="user <*> logged in from <*> port <*>",
                        variables=[f"u{int(rng.integers(0, 5))}", f"10.0.0.{i % 7}", "22"],
                        logID=str(i), logFormatVariables={"Time": str(1_700_000_000 + i)}
                        ).serialize()
