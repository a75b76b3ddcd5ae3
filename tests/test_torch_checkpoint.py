"""The port's checkpoints (``utils/checkpoint.py``, ``utils/atomicio.py``)
and ``TorchScorerDetector.save_checkpoint`` / ``load_checkpoint``, held to
the JAX package's: the atomic commit writes the same bytes, a crash before
the meta commit keeps the previous generation, stale generations are
pruned, a tree-version mismatch raises before any tensor is read, the meta
carries the JAX detector's keys, and the detector's restore branches
(norm-mode mismatch, override, unfitted, candidate ids, int8) behave as
``tests/test_jax_scorer.py`` pins them for the JAX detector. Restored
scores are compared exactly (same weights, same CPU ops)."""
import json
import logging

import numpy as np
import pytest
import torch

from detectmateservice_tpu.library.detectors import JaxScorerDetector
from detectmateservice_tpu.utils import atomicio as jax_atomicio
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.schemas import ParserSchema
from detectmateservice_tpu_torch.utils import atomicio, checkpoint
from detectmateservice_tpu_torch.utils.checkpoint import CheckpointFormatError


def _config(**overrides):
    cfg = {"method_type": "torch_scorer", "auto_config": False, "model": "mlp",
           "data_use_training": 32, "train_epochs": 2, "min_train_steps": 4,
           "threshold_sigma": 4.0, "seq_len": 16, "dim": 32, "vocab_size": 1024,
           "max_batch": 32, "pipeline_depth": 2, "async_fit": False, "device": "cpu",
           "dtype": "float32"}
    cfg.update(overrides)
    return {"detectors": {"TorchScorerDetector": cfg}}


def _msg(template, variables, log_id="1"):
    return ParserSchema(EventID=1, template=template, variables=variables, logID=log_id,
                        logFormatVariables={"Time": "1700000000"}).serialize()


def _noisy(stable, noise, log_id="1"):
    return _msg("pid=<*> comm=<*> exe=<*>", [noise, stable, f"/usr/bin/{stable}"], log_id)


def _train_msgs(n, start=0):
    comms = ["cron", "sshd", "systemd", "bash"]
    return [_noisy(comms[i % 4], str(3000 + i * 17), log_id=str(start + i)) for i in range(n)]


def _fitted(n=32, **overrides):
    det = TorchScorerDetector(config=_config(data_use_training=n, **overrides))
    assert det.process_batch(_train_msgs(n)) == []
    assert det._fitted
    return det


_PROBE = np.random.default_rng(5).integers(2, 1000, (32, 16)).astype(np.int32)


# -- utils/atomicio.py and utils/checkpoint.py --------------------------------
def test_atomic_commit_writes_the_jax_packages_bytes(tmp_path):
    doc = {"threshold": 3.25, "norm_mu": [1.0, 2.5], "fitted": True, "b": None,
           "cand_key": [1024, 64], "inf": float("inf")}
    atomicio.write_json_atomic(tmp_path / "port.json", doc)
    jax_atomicio.write_json_atomic(tmp_path / "jax.json", doc)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax.json", "port.json"]


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g), "b": torch.randn(3, generator=g)}


def test_save_load_round_trip(tmp_path):
    params = _state(0)
    opt = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": torch.ones(4, 3)}},
           "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999), "params": [0],
                             "foreach": None}]}
    checkpoint.save_scorer_state(str(tmp_path), params, opt, {"threshold": 1.5},
                                 tree_version=2)
    got_params, got_opt, meta = checkpoint.load_scorer_state(
        str(tmp_path), accepted_tree_versions={2})
    assert set(got_params) == {"w", "b"}
    for key in params:
        assert torch.equal(got_params[key], params[key])
    assert torch.equal(got_opt["state"][0]["exp_avg"], torch.ones(4, 3))
    assert got_opt["param_groups"][0]["lr"] == 1e-3
    assert meta["threshold"] == 1.5 and meta["tree_version"] == 2
    nonce = meta["data_nonce"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "meta.json", f"opt_state.{nonce}.pt", f"params.{nonce}.pt"]


def test_crash_before_the_meta_commit_keeps_the_previous_generation(tmp_path, monkeypatch):
    checkpoint.save_scorer_state(str(tmp_path), _state(1), {}, {"gen": 1})

    def crash(*args, **kwargs):
        raise OSError("simulated crash before the meta commit")

    monkeypatch.setattr(checkpoint, "write_json_atomic", crash)
    with pytest.raises(OSError, match="simulated crash"):
        checkpoint.save_scorer_state(str(tmp_path), _state(2), {}, {"gen": 2})
    monkeypatch.undo()
    params, _, meta = checkpoint.load_scorer_state(str(tmp_path))
    assert meta["gen"] == 1 and torch.equal(params["w"], _state(1)["w"])
    # the crashed generation's files are orphans the next save prunes
    assert len(list(tmp_path.glob("params.*.pt"))) == 2
    checkpoint.save_scorer_state(str(tmp_path), _state(3), {}, {"gen": 3})
    assert len(list(tmp_path.glob("params.*.pt"))) == 1
    assert checkpoint.load_scorer_state(str(tmp_path))[2]["gen"] == 3


def test_stale_generations_are_pruned(tmp_path):
    (tmp_path / "params").mkdir()                      # legacy bare layout
    (tmp_path / "opt_state").write_bytes(b"legacy")
    (tmp_path / "params.orphan-1.pt").write_bytes(b"x")  # a crashed save
    (tmp_path / "keep.txt").write_text("unrelated")
    for gen in range(3):
        checkpoint.save_scorer_state(str(tmp_path), _state(gen), {}, {"gen": gen})
    nonce = json.loads((tmp_path / "meta.json").read_text())["data_nonce"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "keep.txt", "meta.json", f"opt_state.{nonce}.pt", f"params.{nonce}.pt"]


def test_version_mismatch_raises_before_any_tensor_is_read(tmp_path):
    checkpoint.save_scorer_state(str(tmp_path), _state(0), {}, {}, tree_version=99)
    for data in tmp_path.glob("*.pt"):
        data.unlink()   # a read would fail with FileNotFoundError instead
    with pytest.raises(CheckpointFormatError, match="tree version 99"):
        checkpoint.load_scorer_state(str(tmp_path), accepted_tree_versions={1, 2})


def test_tree_versions_are_the_jax_packages():
    from detectmateservice_tpu.utils import checkpoint as jax_checkpoint

    assert checkpoint.MODEL_TREE_VERSIONS == jax_checkpoint.MODEL_TREE_VERSIONS
    assert checkpoint.COMPATIBLE_TREE_VERSIONS == jax_checkpoint.COMPATIBLE_TREE_VERSIONS


# -- the detector ------------------------------------------------------------
@pytest.mark.parametrize("model,overrides", [
    ("mlp", {}),
    ("gru", {"score_vocab": 64, "depth": 1, "head_impl": "pallas"}),
    ("mlp", {"score_norm": "position", "data_use_training": 96}),
])
def test_meta_keys_equal_a_jax_detector_checkpoints(tmp_path, model, overrides):
    overrides = dict(overrides, model=model)
    port = _fitted(n=overrides.pop("data_use_training", 32), **overrides)
    port.save_checkpoint(str(tmp_path / "port"))
    jax_cfg = dict(_config(**overrides)["detectors"]["TorchScorerDetector"],
                   method_type="jax_scorer", data_use_training=port.config.data_use_training)
    del jax_cfg["device"]
    jax_det = JaxScorerDetector(config={"detectors": {"JaxScorerDetector": jax_cfg}})
    assert jax_det.process_batch(_train_msgs(port.config.data_use_training)) == []
    jax_det.save_checkpoint(str(tmp_path / "jax"))
    port_meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    jax_meta = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert set(port_meta) == set(jax_meta)
    assert port_meta["tree_version"] == jax_meta["tree_version"]
    if "cand_key" in jax_meta:
        assert port_meta["cand_key"] == jax_meta["cand_key"]
        assert port_meta["cand_ids"] == jax_meta["cand_ids"]


@pytest.mark.parametrize("model,overrides", [
    ("mlp", {}), ("gru", {"score_norm": "position", "data_use_training": 96})])
def test_detector_round_trip_scores_and_state(tmp_path, model, overrides):
    det = _fitted(n=overrides.pop("data_use_training", 32), model=model, **overrides)
    det.save_checkpoint(str(tmp_path / "ckpt"))
    fresh = TorchScorerDetector(config=_config(model=model, data_use_training=det._trained,
                                               **overrides))
    fresh.load_checkpoint(str(tmp_path / "ckpt"))
    assert fresh._fitted and fresh._trained == det._trained
    assert fresh._threshold == det._threshold and fresh._calib_stats == det._calib_stats
    np.testing.assert_array_equal(fresh.score_tokens(_PROBE), det.score_tokens(_PROBE))
    for key, value in det._model.state_dict().items():
        assert torch.equal(fresh._model.state_dict()[key], value), key
    want_opt, got_opt = det._optimizer.state_dict(), fresh._optimizer.state_dict()
    for index, state in want_opt["state"].items():
        for name, value in state.items():
            assert torch.equal(got_opt["state"][index][name], value)
    if overrides.get("score_norm") == "position":
        np.testing.assert_array_equal(fresh._norm_mu, det._norm_mu)
        np.testing.assert_array_equal(fresh._host_norm[1].numpy(), det._norm_sigma)
    # the host copy scores the restored weights
    host = fresh._score_host(_PROBE[:4])
    np.testing.assert_allclose(host, det.score_tokens(_PROBE[:4]), rtol=1e-6)


class TestCheckpointTreeVersion:
    """``tests/test_jax_scorer.py::TestCheckpointTreeVersion`` on the port."""

    def test_mismatched_tree_version_fails_with_clear_error(self, tmp_path):
        det = _fitted()
        det.save_checkpoint(str(tmp_path / "ckpt"))
        meta_path = tmp_path / "ckpt" / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["tree_version"] = 99
        meta_path.write_text(json.dumps(meta))
        fresh = TorchScorerDetector(config=_config())
        with pytest.raises(CheckpointFormatError, match="tree version"):
            fresh.load_checkpoint(str(tmp_path / "ckpt"))

    @pytest.mark.parametrize("stamp", ["absent", 2])
    def test_compatible_mlp_checkpoints_still_load(self, tmp_path, stamp):
        det = _fitted()
        det.save_checkpoint(str(tmp_path / "ckpt"))
        meta_path = tmp_path / "ckpt" / "meta.json"
        meta = json.loads(meta_path.read_text())
        if stamp == "absent":
            meta.pop("tree_version")
        else:
            meta["tree_version"] = stamp
        meta_path.write_text(json.dumps(meta))
        fresh = TorchScorerDetector(config=_config())
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        assert fresh._fitted


def _position_config(**overrides):
    """``TestPositionNorm._config`` of tests/test_jax_scorer.py: 100 train
    steps (the default ``min_train_steps``)."""
    return _config(score_norm="position", data_use_training=96, threshold_sigma=5.0,
                   min_train_steps=100, **overrides)


class TestLoadBranches:
    def test_checkpoint_preserves_calibration(self, tmp_path):
        """``tests/test_jax_scorer.py::TestPositionNorm``'s restore on the
        port: a restored position-norm detector still flags the unseen
        low-entropy value, and only it."""
        det = TorchScorerDetector(config=_position_config())
        det.process_batch(_train_msgs(96))
        det.save_checkpoint(str(tmp_path / "ckpt"))
        fresh = TorchScorerDetector(config=_position_config())
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        np.testing.assert_array_equal(fresh._norm_mu, det._norm_mu)
        np.testing.assert_array_equal(fresh._norm_sigma, det._norm_sigma)
        bad = [_noisy("xmrig", "77", log_id="7")]
        out = fresh.process_batch(_train_msgs(7, start=700) + bad) + fresh.flush()
        assert len([o for o in out if o is not None]) == 1

    @pytest.mark.parametrize("saved,loaded", [("position", "none"), ("none", "position")])
    def test_norm_mode_mismatch_discards_the_threshold(self, tmp_path, caplog, saved,
                                                       loaded):
        det = (TorchScorerDetector(config=_position_config()) if saved == "position"
               else TorchScorerDetector(config=_config(data_use_training=96)))
        det.process_batch(_train_msgs(96))
        det.save_checkpoint(str(tmp_path / "ckpt"))
        fresh = TorchScorerDetector(config=_config(score_norm=loaded, data_use_training=96))
        with caplog.at_level(logging.WARNING):
            fresh.load_checkpoint(str(tmp_path / "ckpt"))
        assert fresh._threshold == float("inf")
        assert "does not match config" in caplog.text
        assert fresh._norm_mu is None and fresh._norm_dev is None
        assert fresh._host_norm is None

    def test_configured_threshold_wins(self, tmp_path):
        det = _fitted()
        det.save_checkpoint(str(tmp_path / "ckpt"))
        fresh = TorchScorerDetector(config=_config(score_threshold=42.0))
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        assert fresh._threshold == 42.0 and fresh._calib_stats == det._calib_stats

    def test_unfitted_checkpoint_leaves_the_threshold_to_the_next_fit(self, tmp_path):
        det = TorchScorerDetector(config=_config())
        det.setup_io()
        det.save_checkpoint(str(tmp_path / "ckpt"))
        meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
        assert meta["fitted"] is False and meta["threshold"] is None
        fresh = _fitted()
        assert np.isfinite(fresh._threshold)
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        assert not fresh._fitted and fresh._threshold is None
        assert fresh.process_batch(_train_msgs(32, start=100)) == []
        assert fresh._fitted and np.isfinite(fresh._threshold)

    def test_fitted_checkpoint_without_threshold_fails_open(self, tmp_path):
        det = _fitted()
        det.save_checkpoint(str(tmp_path / "ckpt"))
        meta_path = tmp_path / "ckpt" / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["threshold"] = None
        meta_path.write_text(json.dumps(meta))
        fresh = TorchScorerDetector(config=_config())
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        assert fresh._fitted and fresh._threshold == float("inf")

    def test_candidate_ids_are_reused_verbatim_on_both_copies(self, tmp_path):
        det = _fitted(model="gru", depth=1, score_vocab=64, host_score_max_batch=8)
        det.save_checkpoint(str(tmp_path / "ckpt"))
        meta_path = tmp_path / "ckpt" / "meta.json"
        meta = json.loads(meta_path.read_text())
        assert meta["cand_key"] == [1024, 64] and len(meta["cand_ids"]) == 64
        ids = list(range(0, 128, 2))   # a subset the seed would never draw
        meta["cand_ids"] = ids
        meta_path.write_text(json.dumps(meta))
        fresh = TorchScorerDetector(config=_config(model="gru", depth=1, score_vocab=64,
                                                   host_score_max_batch=8))
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        for scorer in (fresh._scorer, fresh._host_scorer):
            assert scorer._candidate_ids(1024, 64).tolist() == ids
        assert fresh.state_dict()["cand_ids"] == ids

    def test_int8w_restore_reactivates_ungated(self, tmp_path):
        det = _fitted(dtype="int8w")
        assert det._int8_report["activated"] and det._int8_report["gated"]
        det.save_checkpoint(str(tmp_path / "ckpt"))
        fresh = TorchScorerDetector(config=_config(dtype="int8w"))
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        report = fresh._int8_report
        assert report["activated"] and report["gated"] is False
        assert report["where"] == "restore" and report["rows"] == 0
        assert fresh._qstate is not None
        np.testing.assert_array_equal(fresh.score_tokens(_PROBE), det.score_tokens(_PROBE))
