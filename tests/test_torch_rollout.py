"""The port's model lifecycle (``detectmateservice_tpu_torch/rollout/`` and
the detector's rollout seams) against the JAX package's, on the CPU.

* the sampler, the shadow gate and the versioned store are copies: the same
  seeds, offers, observations and verbs give the same reservoirs, verdicts
  and manifests as the JAX package's; keep-N pruning, pins and the
  manifest's crash atomicity hold;
* the seams: from the same fitted weights and Adam moments (bridged from
  the JAX detector, ``models/convert.py``), ``rollout_fine_tune`` on the
  same rows and seed gives candidate scores within rtol 1e-3, atol 1e-4 of
  the JAX candidate's (fp32, MLP and GRU; no decision flip outside 1e-2 of a
  pinned threshold); LogBERT, fed the masks the JAX fine-tune draws, lands
  on the JAX candidate at test_torch_logbert_train.py's tolerance; the live
  weights stay bit-equal; a float install captures nothing and an int8w one
  re-captures each warm bucket as expected; after installing the same
  candidate both detectors alert alike;
* the manager's gate, holdback, promote-by-version, rollback and pin;
* the settings' cross-checks and the admin routes' 404 and 400;
* the whole path: the port's Service on the in-process queue through
  ``scripts/rollout_smoke.py``'s flow over its admin HTTP.
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.library.detectors import JaxScorerDetector
from detectmateservice_tpu.models import logbert as jax_lb
from detectmateservice_tpu.rollout import CheckpointStore as RefStore
from detectmateservice_tpu.rollout import ShadowEvaluator as RefShadow
from detectmateservice_tpu.rollout import TrafficSampler as RefSampler
from detectmateservice_tpu.settings import ServiceSettings as RefSettings
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine import device_obs
from detectmateservice_tpu_torch.engine.socket import InprocQueueSocketFactory
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.rollout import (
    CheckpointStore,
    RolloutError,
    RolloutManager,
    ShadowEvaluator,
    StoreError,
    TrafficSampler,
)
from detectmateservice_tpu_torch.schemas import DetectorSchema, ParserSchema
from detectmateservice_tpu_torch.settings import ServiceSettings, SettingsError
from detectmateservice_tpu_torch.web import router


def msg(i: int) -> bytes:
    return ParserSchema(
        EventID=1, template="user <*> logged in from <*>",
        variables=[f"u{i % 8}", f"10.0.0.{i % 16}"], logID=str(i),
        logFormatVariables={"Time": "1700000000"},
    ).serialize()


# ---------------------------------------------------------------------------
# the framework-free copies against the JAX package's
# ---------------------------------------------------------------------------
def _offers(seed: int, n_batches: int = 40):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        n = int(rng.integers(1, 64))
        yield (rng.integers(0, 4096, size=(n, 16)).astype(np.int32),
               rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("capacity,ratio,seed,with_scores", [
    (32, 0.5, 7, True), (256, 0.05, 0, True), (64, 1.0, 3, False), (1000, 0.3, 11, True)])
def test_sampler_same_seed_and_offers_give_the_jax_reservoir(capacity, ratio, seed,
                                                            with_scores):
    now = [100.0]
    ref = RefSampler(capacity, ratio, seed=seed, clock=lambda: now[0])
    port = TrafficSampler(capacity, ratio, seed=seed, clock=lambda: now[0])
    for tokens, scores in _offers(seed):
        now[0] += 0.25
        got = port.offer_rows(tokens, scores if with_scores else None)
        assert got == ref.offer_rows(tokens, scores if with_scores else None)
    ref_rows, ref_scores = ref.snapshot(with_scores=True)
    rows, scores = port.snapshot(with_scores=True)
    assert np.array_equal(rows, ref_rows)
    np.testing.assert_array_equal(scores, ref_scores)
    assert port.stats() == ref.stats()
    assert port.last_offer_age() == ref.last_offer_age()


def test_sampler_rejects_what_the_jax_sampler_rejects():
    for kwargs in ({"capacity": 0, "ratio": 0.5}, {"capacity": 8, "ratio": 0.0},
                   {"capacity": 8, "ratio": 1.5}):
        with pytest.raises(ValueError):
            RefSampler(**kwargs)
        with pytest.raises(ValueError):
            TrafficSampler(**kwargs)
    sampler = TrafficSampler(8, 1.0)
    with pytest.raises(ValueError, match="pair 1:1"):
        sampler.offer_rows(np.zeros((3, 2), np.int32), np.zeros(2, np.float32))


@pytest.mark.parametrize("seed,track_top", [(0, 0), (1, 3), (2, 0)])
def test_shadow_same_inputs_give_the_jax_stats_and_verdicts(seed, track_top):
    rng = np.random.default_rng(seed)
    kwargs = dict(threshold=0.5, min_samples=64, max_mean_delta=0.3, max_flip_ratio=0.05,
                  track_top=track_top)
    ref, port = RefShadow(**kwargs), ShadowEvaluator(**kwargs)
    for step in range(8):
        live = rng.normal(size=20)
        cand = live + rng.normal(scale=0.05 * (step + 1), size=20)
        ids = list(range(step * 20, step * 20 + 20))
        np.testing.assert_array_equal(port.observe(live, cand, ids),
                                      ref.observe(live, cand, ids))
        assert port.verdict() == ref.verdict()
        assert port.stats() == ref.stats()
    assert port.verdict() in ("promote", "hold")


def test_shadow_rejects_mismatched_shapes_and_bad_minimum():
    ev = ShadowEvaluator(0.0, 1, 1.0, 1.0)
    with pytest.raises(ValueError):
        ev.observe(np.zeros(3), np.zeros(4))
    with pytest.raises(ValueError):
        ShadowEvaluator(0.0, 0, 1.0, 1.0)


def _store_verbs(store, root):
    for v in (1, 2, 3):
        store.version_dir(v).mkdir()
        (store.version_dir(v) / "blob").write_text("x")
        store.record(v, {"tag": f"v{v}", "warm_set": {"buckets": [1, 32]}},
                     status="shadowing")
    store.set_status(2, "holdback", divergence={"mean_abs_delta": 1.5})
    store.set_live(1, divergence={"samples": 512})
    store.set_live(3)
    store.update_meta(3, drift_baseline={"schema": "x", "rows": 4})
    store.pin(3)
    for v in (4, 5, 6):
        store.version_dir(v).mkdir()
        store.record(v, {"tag": f"v{v}"})
    store.pin(None)
    return (store.manifest(), store.previous_live(), store.allocate_version(),
            store.history(2), store.newest_created_unix(),
            sorted(p.name for p in root.iterdir()))


def test_store_same_verbs_give_the_jax_manifest(tmp_path):
    """With one injected clock the two manifests are equal field for field
    (timestamps included); keep-N pruned the same directories."""
    now = [1_700_000_000.0]

    def clock():
        now[0] += 1.5
        return now[0]

    ref = _store_verbs(RefStore(tmp_path / "ref", keep=3, clock=clock), tmp_path / "ref")
    now[0] = 1_700_000_000.0
    port = _store_verbs(CheckpointStore(tmp_path / "port", keep=3, clock=clock),
                        tmp_path / "port")
    assert port == ref
    manifest = port[0]
    assert [e["version"] for e in manifest["entries"]] == [3, 5, 6]
    assert manifest["live_version"] == 3 and manifest["pinned_version"] is None


def test_store_keep_n_never_prunes_live_pinned_or_newest(tmp_path):
    store = CheckpointStore(tmp_path / "s", keep=2)
    for v in range(1, 6):
        store.version_dir(v).mkdir()
        (store.version_dir(v) / "blob").write_text("x")
        store.record(v, {})
        if v == 1:
            store.set_live(1)
            store.pin(1)
    versions = [e["version"] for e in store.manifest()["entries"]]
    assert 1 in versions and 5 in versions
    assert not store.version_dir(2).exists()
    assert store.version_dir(1).exists() and store.version_dir(5).exists()
    with pytest.raises(StoreError):
        store.pin(99)
    with pytest.raises(ValueError):
        CheckpointStore(tmp_path / "t", keep=0)


def test_store_manifest_commit_is_atomic(tmp_path, monkeypatch):
    from detectmateservice_tpu_torch.utils import atomicio

    store = CheckpointStore(tmp_path / "s", keep=4)
    store.version_dir(1).mkdir()
    store.record(1, {"ok": True})
    before = (store.root / "MANIFEST.json").read_text()

    def crash(tmp, final):
        raise OSError("injected crash before the rename commit")

    monkeypatch.setattr(atomicio.os, "replace", crash)
    store.version_dir(2).mkdir()
    with pytest.raises(OSError):
        store.record(2, {"ok": False})
    monkeypatch.undo()
    assert (store.root / "MANIFEST.json").read_text() == before
    assert [e["version"] for e in store.history()] == [1]


def test_store_refuses_a_manifest_of_another_schema(tmp_path):
    store = CheckpointStore(tmp_path / "s")
    (store.root / "MANIFEST.json").write_text(json.dumps({"schema": "other"}))
    with pytest.raises(StoreError, match="schema"):
        store.manifest()


# ---------------------------------------------------------------------------
# the seams against the JAX detector's
# ---------------------------------------------------------------------------
BASE = {"auto_config": False, "data_use_training": 32, "train_epochs": 1,
        "min_train_steps": 5, "seq_len": 16, "dim": 32, "max_batch": 32,
        "async_fit": False, "host_score_max_batch": 0, "score_threshold": -1e9,
        "dtype": "float32", "vocab_size": 4096}


def make_port_detector(**overrides):
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        BASE, method_type="torch_scorer", device="cpu", **overrides)}})
    det.setup_io()
    assert det.process_batch([msg(i) for i in range(32)]) == []
    det.flush_final()
    return det


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


def _bridge(jax_params, jax_opt_state, port_det):
    """The JAX trees as the port's state dicts: weights, and the optimizer
    state of AdamW over the port module's parameters (Adam's step count and
    moments, bridged as the weights are)."""
    as_state = lambda tree: params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    adam = _adam(jax_opt_state)
    mu, nu = as_state(adam.mu), as_state(adam.nu)
    opt = port_det._optimizer.state_dict()
    names = [name for name, _ in port_det._model.named_parameters()]
    opt["state"] = {i: {"step": torch.tensor(float(adam.count)), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]} for i, name in enumerate(names)}
    return as_state(jax_params), opt


@pytest.fixture(scope="module", params=["mlp", "gru"])
def seam_pair(request):
    """A fitted JAX detector, and a port detector holding its fitted weights
    and Adam moments; both fine-tuned on the same rows and seed."""
    model = request.param
    extra = {"model": model, "depth": 1} if model == "gru" else {"model": model}
    jax_det = JaxScorerDetector(config={"detectors": {"JaxScorerDetector": dict(
        BASE, method_type="jax_scorer", **extra)}})
    jax_det.setup_io()
    assert jax_det.process_batch([msg(i) for i in range(32)]) == []
    jax_det.flush_final()
    port_det = make_port_detector(**extra)
    params, opt = _bridge(jax_det._params, jax_det._opt_state, port_det)
    port_det._model.load_state_dict(params)
    port_det._optimizer.load_state_dict(opt)
    rows = np.random.default_rng(0).integers(0, 100, size=(80, 16)).astype(np.int32)
    live = {k: v.clone() for k, v in port_det._model.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in port_det._optimizer.state_dict()["state"].items()}
    jax_cand = jax_det.rollout_fine_tune(rows, epochs=2, seed=3)
    port_cand = port_det.rollout_fine_tune(rows, epochs=2, seed=3)
    return dict(model=model, jax=jax_det, port=port_det, rows=rows, live=live,
                moments=moments, jax_cand=jax_cand, port_cand=port_cand)


def test_fine_tune_lands_on_the_jax_candidate(seam_pair):
    jax_params, _, jax_info = seam_pair["jax_cand"]
    params, _, info = seam_pair["port_cand"]
    assert info["steps"] == jax_info["steps"] == 4 and info["batch_size"] == 32
    np.testing.assert_allclose(info["loss"], jax_info["loss"], rtol=1e-3)
    evals = np.random.default_rng(1).integers(0, 200, size=(48, 16)).astype(np.int32)
    want = seam_pair["jax"].rollout_scores(jax_params, evals)
    got = seam_pair["port"].rollout_scores(params, evals)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    # no decision flips outside a 1e-2 band around a pinned threshold
    threshold = float(np.median(want))
    flips = (got > threshold) != (want > threshold)
    assert np.all(np.abs(want[flips] - threshold) < 1e-2)
    # the candidate moved off the live weights
    assert not torch.equal(params["tok_embed.weight"], seam_pair["live"]["tok_embed.weight"])


def test_fine_tune_leaves_the_live_weights_and_moments_bit_equal(seam_pair):
    det = seam_pair["port"]
    for key, value in det._model.state_dict().items():
        assert torch.equal(value, seam_pair["live"][key]), key
    state = det._optimizer.state_dict()["state"]
    for i, moments in seam_pair["moments"].items():
        for key, value in moments.items():
            assert torch.equal(state[i][key], value), (i, key)
    params, opt_state, _ = seam_pair["port_cand"]
    live_ptrs = {t.data_ptr() for t in det._model.state_dict().values()}
    assert not live_ptrs & {t.data_ptr() for t in params.values()}
    assert not {t.data_ptr() for s in state.values() for t in s.values()} & {
        t.data_ptr() for s in opt_state["state"].values() for t in s.values()}


def test_rollout_scores_of_the_live_weights_equal_a_clones(seam_pair):
    det = seam_pair["port"]
    rows = seam_pair["rows"][:40]
    live = det.rollout_scores(None, rows)
    clone = det.rollout_scores({k: v.clone() for k, v in det._model.state_dict().items()},
                               rows)
    assert live.shape == (40,) and np.array_equal(live, clone)
    assert det.rollout_scores(None, rows[:0]).shape == (0,)


def test_installs_of_the_same_candidate_alert_alike(seam_pair):
    """The JAX candidate installed into both detectors (bridged into the
    port); the same stream at a pinned threshold: the same alerts, scores
    within 1e-3, a decision apart only within 1e-2 of the threshold."""
    jax_det, port_det = seam_pair["jax"], seam_pair["port"]
    jax_params, jax_opt, _ = seam_pair["jax_cand"]
    params, opt = _bridge(jax_params, jax_opt, port_det)
    ref_swap = jax_det.install_candidate(jax_params, jax_opt, version=7)
    swap = port_det.install_candidate(params, opt, version=7)
    assert set(swap) - {"install"} == set(ref_swap)
    assert swap["swapped"] and swap["version"] == 7 and port_det.model_version() == 7
    for key, value in port_det._model.state_dict().items():
        assert torch.equal(value, params[key]), key
    stream = [msg(5000 + i) for i in range(64)]
    tokens, _ = port_det._featurize_raw_batch(stream)
    threshold = float(np.median(jax_det.rollout_scores(None, tokens)))
    jax_det._threshold = port_det._threshold = threshold
    alerts = {}
    for name, det in (("jax", jax_det), ("port", port_det)):
        out = det.process_batch(stream[:32]) + det.process_batch(stream[32:]) + det.flush()
        parsed = [DetectorSchema.from_bytes(a) for a in out if a is not None]
        alerts[name] = {p["logIDs"][0]: p["score"] for p in parsed}
    ref_scores = dict(zip((str(5000 + i) for i in range(64)),
                          jax_det.rollout_scores(None, tokens)))
    assert alerts["port"]
    for log_id in set(alerts["jax"]) ^ set(alerts["port"]):
        assert abs(ref_scores[log_id] - threshold) < 1e-2, log_id
    for log_id in set(alerts["jax"]) & set(alerts["port"]):
        np.testing.assert_allclose(alerts["port"][log_id], alerts["jax"][log_id], rtol=1e-3)


def test_checkpointed_candidate_loads_back_bit_equal(seam_pair, tmp_path):
    det = seam_pair["port"]
    params, opt_state, _ = seam_pair["port_cand"]
    det.save_params_checkpoint(str(tmp_path / "v1"), params, opt_state)
    loaded, loaded_opt, meta = det.load_params_checkpoint(str(tmp_path / "v1"))
    assert meta["tree_version"] in (1, 2) and meta["fitted"]
    for key, value in params.items():
        assert torch.equal(loaded[key], value)
    assert loaded_opt["state"].keys() == opt_state["state"].keys()


def test_a_store_version_the_jax_package_wrote_does_not_load_here(seam_pair, tmp_path):
    """A deliberate difference: the store's version directories are each
    package's own checkpoints (orbax trees there, ``torch.save`` files
    here), so a store shared with a JAX replica cannot be promoted from
    the port."""
    jax_params, jax_opt, _ = seam_pair["jax_cand"]
    seam_pair["jax"].save_params_checkpoint(str(tmp_path / "v1"), jax_params, jax_opt)
    with pytest.raises(FileNotFoundError, match=r"params\..*\.pt"):
        seam_pair["port"].load_params_checkpoint(str(tmp_path / "v1"))


LOGBERT = {"model": "logbert", "depth": 1, "heads": 2, "attn_impl": "einsum"}


def _jax_masks(jax_det, rows, seed):
    """The masks the JAX fine-tune draws, step by step: its key split per
    step, the mask key split from the step key (``_train_impl``)."""
    cfg = jax_det.config
    bs = min(cfg.train_batch_size, len(rows))
    order = np.random.default_rng(cfg.seed + seed).permutation(len(rows))
    rng = jax.random.PRNGKey(cfg.seed + 1 + seed)
    masks = []
    for start in range(0, len(rows) - bs + 1, bs):
        batch = rows[order[start:start + bs]]
        rng, step_rng = jax.random.split(rng)
        mask_rng, _ = jax.random.split(step_rng)
        draw = jax.random.uniform(mask_rng, batch.shape)
        masks.append((np.asarray(draw < jax_det._scorer.config.mask_prob) & (batch != 0),
                      batch))
    return masks


def test_logbert_fine_tune_with_the_jax_masks_lands_on_the_jax_candidate():
    """One step from the same initial weights and fresh moments, the port
    fed the mask the JAX fine-tune drew: the loss within 1e-5, and every
    weight whose gradient is at least 1e-7 within 1e-5 of the JAX
    candidate's (Adam's first update is lr * g / (|g| + eps))."""
    cfg = dict(BASE, **LOGBERT)
    jax_det = JaxScorerDetector(config={"detectors": {"JaxScorerDetector": dict(
        cfg, method_type="jax_scorer")}})
    jax_det._ensure_scorer()
    port_det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        cfg, method_type="torch_scorer", device="cpu")}})
    port_det.load_params(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                 jax_det._params)))
    port_det.setup_io()
    rows = np.random.default_rng(2).integers(3, 300, size=(32, 16)).astype(np.int32)
    rows[:, 12:] = 0
    (mask, batch), = _jax_masks(jax_det, rows, seed=4)
    assert mask.any()
    scorer = port_det._scorer
    step = scorer.train_step
    fed = []

    def with_jax_mask(model, optimizer, tokens, generator=None):
        fed.append(tokens.clone())
        return step(model, optimizer, tokens, generator=generator,
                    mask=torch.from_numpy(mask))

    scorer.train_step = with_jax_mask
    params, _, info = port_det.rollout_fine_tune(rows, seed=4)
    jax_params, _, jax_info = jax_det.rollout_fine_tune(rows, seed=4)
    assert np.array_equal(fed[0].numpy(), batch)
    assert info["steps"] == jax_info["steps"] == 1
    np.testing.assert_allclose(info["loss"], jax_info["loss"], rtol=1e-5)

    jtoks = jnp.asarray(batch)

    def loss_fn(p):
        corrupted = jnp.where(jnp.asarray(mask), 1, jtoks)
        return jax_lb.masked_lm_loss(jax_det._scorer.model.apply(p, corrupted), jtoks,
                                     jnp.asarray(mask))

    grads = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(jax_det._params)))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))
    for name, value in params.items():
        steady = grads[name].abs() >= 1e-7
        np.testing.assert_allclose(value[steady].numpy(), want[name][steady].numpy(),
                                   atol=1e-5, err_msg=name)


def _fresh_ledger(monkeypatch):
    ledger = device_obs.CompileLedger()
    previous = device_obs.activate(ledger)
    monkeypatch.setattr(device_obs, "_ACTIVE", ledger)
    return ledger, previous


def test_a_float_install_captures_nothing(monkeypatch):
    ledger, previous = _fresh_ledger(monkeypatch)
    try:
        det = make_port_detector()
        feed(det, 100)
        rows = np.random.default_rng(3).integers(0, 100, size=(64, 16)).astype(np.int32)
        params, opt, _ = det.rollout_fine_tune(rows, seed=1)
        before = ledger.snapshot()["totals"]
        swap = det.install_candidate(params, opt, version=3)
        assert ledger.snapshot()["totals"] == before
        assert swap["prewarmed_buckets"] == det.warm_set_spec()["buckets"]
        # a bucket the stored spec adds is captured, as an expected model_swap
        swap = det.install_candidate(params, opt, version=4,
                                     warm_set={"buckets": [4, 64], "seq_len": 16})
        new = ledger.snapshot()["compiles"][before["compiles"]:]
        assert [(e["bucket"], e["where"], e["unexpected"]) for e in new] == [
            ("4", "model_swap", False)]
        assert 4 in swap["prewarmed_buckets"] and 64 not in swap["prewarmed_buckets"]
        assert ledger.snapshot()["totals"]["unexpected"] == 0
    finally:
        device_obs.activate(previous)


def test_an_int8w_install_recaptures_every_warm_bucket_as_expected(monkeypatch):
    ledger, previous = _fresh_ledger(monkeypatch)
    try:
        det = make_port_detector(dtype="int8w", score_threshold=None, threshold_sigma=3.0)
        assert det._int8_report["activated"]
        feed(det, 200)
        warm = {b for _, b in det._warm.keys()}
        rows = np.random.default_rng(4).integers(0, 100, size=(64, 16)).astype(np.int32)
        params, opt, _ = det.rollout_fine_tune(rows, seed=2)
        n0 = ledger.snapshot()["totals"]["compiles"]
        swap = det.install_candidate(params, opt, version=2)
        new = ledger.snapshot()["compiles"][n0:]
        report = swap["int8"]
        assert report["where"] == "install" and report["rows"] == 32 and "flips" in report
        assert {int(e["bucket"]) for e in new} == warm
        assert all(e["where"] == "int8_activate" and not e["unexpected"] for e in new)
        assert ledger.snapshot()["totals"]["unexpected"] == 0
        if report["activated"]:
            stats = report["bytes"]
            assert sum(t.numel() * t.element_size() for leaf in det._qstate.values()
                       for t in leaf) == stats["int8_bytes"] + stats["float_bytes"]
    finally:
        device_obs.activate(previous)


def test_seams_refuse_while_a_background_fit_runs():
    det = make_port_detector()
    gate = threading.Event()
    fit = threading.Thread(target=gate.wait, daemon=True)
    fit.start()
    det._fit_thread = fit
    try:
        assert not det.rollout_ready()
        with pytest.raises(Exception, match="background fit"):
            det.rollout_scores(None, np.zeros((4, 16), np.int32))
        with pytest.raises(Exception, match="background fit"):
            det.rollout_fine_tune(np.zeros((4, 16), np.int32))
    finally:
        gate.set()
        fit.join()
        det._fit_thread = None
    assert det.rollout_ready()


def test_drained_rows_reach_the_sampler_with_their_scores_and_the_tap_sees_every_batch():
    det = make_port_detector(host_score_max_batch=8)
    sampler = TrafficSampler(capacity=256, ratio=1.0)
    taps = []
    det.set_rollout_sampler(sampler)
    det.set_capacity_tap(lambda rows, seconds: taps.append((rows, seconds)))
    stream = [msg(300 + i) for i in range(40)]
    det.process_batch(stream[:32])
    det.process_batch(stream[32:36])     # the CPU copy's path
    det.flush()
    rows, scores = sampler.snapshot(with_scores=True)
    tokens, _ = det._featurize_raw_batch(stream[:36])
    assert np.array_equal(rows, tokens)
    np.testing.assert_allclose(scores, det.rollout_scores(None, tokens), rtol=1e-6)
    assert [r for r, _ in taps] == [32, 4] and all(s >= 0 for _, s in taps)
    det.set_rollout_sampler(None)
    det.set_capacity_tap(None)
    det.process_batch(stream[36:])
    det.flush()
    assert len(sampler) == 36 and len(taps) == 2


def test_snapshots_never_tear_under_concurrent_offers():
    """More writer threads than cores, a short switch interval: every
    snapshot pairs each row with its own score."""
    import os
    import sys

    sampler = TrafficSampler(capacity=128, ratio=1.0, seed=3)
    stop = threading.Event()
    failures = []

    def writer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            vals = rng.integers(0, 10_000, size=32).astype(np.int32)
            sampler.offer_rows(vals.reshape(32, 1), scores=vals.astype(np.float32))

    threads = [threading.Thread(target=writer, args=(s,), daemon=True)
               for s in range((os.cpu_count() or 2) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for _ in range(300):
            rows, scores = sampler.snapshot(with_scores=True)
            if rows.shape[0] != len(scores) or (rows.shape[0] and not np.array_equal(
                    rows[:, 0].astype(np.float32), scores)):
                failures.append((rows[:4, 0], scores[:4]))
                break
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for t in threads:
            t.join(timeout=10)
    assert not failures and not any(t.is_alive() for t in threads)
    assert sampler.stats()["held_rows"] == 128


def test_no_scoring_call_sees_half_an_install():
    """Installs of two candidates in turns on one thread while another
    scores a fixed batch through the dispatch path's ``_score_dev``: every
    result is exactly one candidate's scores."""
    import sys

    det = make_port_detector()
    state = det._model.state_dict()
    candidates = [{k: v.clone() for k, v in state.items()},
                  {k: v.clone() * (1.5 if k == "tok_embed.weight" else 1.0)
                   for k, v in state.items()}]
    opt = det._optimizer.state_dict()
    tokens = np.random.default_rng(5).integers(0, 300, size=(32, 16)).astype(np.int32)
    want = []
    for cand in candidates:
        det.install_candidate(cand, opt)
        want.append(det._score_dev(tokens).numpy().copy())
    assert not np.array_equal(*want)
    stop = threading.Event()
    torn = []

    def score():
        while not stop.is_set():
            got = det._score_dev(tokens).numpy()
            if not any(np.array_equal(got, w) for w in want):
                torn.append(got)
                return

    scorer = threading.Thread(target=score, daemon=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        scorer.start()
        for i in range(60):
            det.install_candidate(candidates[i % 2], opt, version=i)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        scorer.join(timeout=30)
    assert not scorer.is_alive() and not torn


# ---------------------------------------------------------------------------
# the manager on the port's detector
# ---------------------------------------------------------------------------
def rollout_settings(tmp_path, **overrides) -> ServiceSettings:
    base = dict(
        component_type="core", component_name="rollout-test", http_port=0,
        rollout_enabled=True, rollout_dir=str(tmp_path / "store"),
        rollout_interval_s=3600.0, rollout_sample_ratio=1.0,
        rollout_sample_capacity=256, rollout_min_fit_rows=16,
        rollout_min_shadow_samples=16, rollout_shadow_timeout_s=30.0,
        rollout_max_mean_delta=5.0, rollout_max_flip_ratio=0.1,
        rollout_keep_checkpoints=4)
    base.update(overrides)
    return ServiceSettings(**base)


class EventSink:
    def __init__(self):
        self.events = []

    def emit_event(self, event, level=None):
        self.events.append(event)
        return event

    def kinds(self):
        return [e.get("kind") for e in self.events]


def make_manager(det, tmp_path, **overrides):
    sink = EventSink()
    mgr = RolloutManager(det, rollout_settings(tmp_path, **overrides),
                         labels={"component_type": "test",
                                 "component_id": f"rollout-{tmp_path.name}"},
                         monitor=sink)
    return mgr, sink


def feed(det, base, n=64):
    for start in range(0, n, 16):
        det.process_batch([msg(base + start + i) for i in range(16)])
    det.flush()


class TestRolloutManager:
    def test_cycle_promotes_through_the_gate(self, tmp_path):
        det = make_port_detector()
        mgr, sink = make_manager(det, tmp_path)
        try:
            feed(det, 1000)
            before = device_obs.get_ledger().snapshot()["totals"]["unexpected"]
            info = mgr.run_cycle(reason="test", block=True)
            outcome = info["outcome"]
            assert outcome["result"] == "promoted", info
            assert mgr.store.live_version() == outcome["version"] == det.model_version()
            assert outcome["swap"]["source"] == "fine_tune"
            assert device_obs.get_ledger().snapshot()["totals"]["unexpected"] == before
            assert "model_promoted" in sink.kinds()
            status = mgr.status()
            assert status["live_version"] == outcome["version"]
            assert status["sampler"]["rows_offered"] > 0
            entry = mgr.store.entry(outcome["version"])
            assert entry["meta"]["warm_set"] == det.warm_set_spec()
        finally:
            mgr.stop()

    def test_broken_candidate_holds_back_with_its_event(self, tmp_path):
        det = make_port_detector()
        mgr, sink = make_manager(det, tmp_path)
        try:
            feed(det, 2000)
            broken = {k: v * 10.0 for k, v in det._model.state_dict().items()}
            version = mgr.inject_candidate(broken, det._optimizer.state_dict(),
                                           tag="broken", min_samples=8)
            outcome = None
            for _ in range(20):
                outcome = mgr.shadow_tick()
                if outcome is not None:
                    break
            assert outcome is not None and outcome["result"] == "holdback"
            assert "model_canary_holdback" in sink.kinds()
            entry = mgr.store.entry(version)
            assert entry["status"] == "holdback"
            assert entry["meta"]["divergence"]["mean_abs_delta"] > 1.0
            assert det.model_version() == 0 and mgr.store.live_version() is None
            with pytest.raises(RolloutError):
                mgr.promote()
        finally:
            mgr.stop()

    def test_promote_by_version_and_rollback(self, tmp_path):
        det = make_port_detector()
        mgr, sink = make_manager(det, tmp_path)
        try:
            feed(det, 3000)
            v1 = mgr.run_cycle(block=True)["outcome"]["version"]
            feed(det, 3200)
            v2 = mgr.run_cycle(block=True)["outcome"]["version"]
            assert (v1, v2) == (1, 2) and mgr.store.live_version() == 2
            out = mgr.rollback()
            assert out["result"] == "rolled_back" and out["version"] == 1
            assert det.model_version() == 1 and mgr.store.live_version() == 1
            stored = det.load_params_checkpoint(str(mgr.store.version_dir(1)))[0]
            for key, value in det._model.state_dict().items():
                assert torch.equal(value, stored[key]), key
            out = mgr.promote(version=2)
            assert out["result"] == "promoted" and det.model_version() == 2
            assert "model_rolled_back" in sink.kinds()
            assert mgr.history()["live_version"] == 2
        finally:
            mgr.stop()

    def test_pin_suspends_cycles(self, tmp_path):
        det = make_port_detector()
        mgr, _sink = make_manager(det, tmp_path)
        try:
            feed(det, 4000)
            v1 = mgr.run_cycle(block=True)["outcome"]["version"]
            assert mgr.pin(v1)["version"] == v1
            assert "pinned" in mgr.run_cycle(reason="test")["skipped"]
            mgr.unpin()
            feed(det, 4200)
            assert mgr.run_cycle(block=True)["outcome"]["version"] == 2
        finally:
            mgr.stop()

    def test_rollback_without_history_and_cycle_without_rows(self, tmp_path):
        det = make_port_detector()
        mgr, _sink = make_manager(det, tmp_path)
        try:
            with pytest.raises(RolloutError):
                mgr.rollback()
            assert "sampled rows" in mgr.run_cycle()["skipped"]
        finally:
            mgr.stop()


# ---------------------------------------------------------------------------
# settings and admin plumbing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,needle", [
    ({"rollout_enabled": True}, "rollout_dir"),
    ({"drift_enabled": True}, "rollout_enabled"),
    ({"rollout_sample_ratio": 0.0}, "rollout_sample_ratio"),
    ({"rollout_keep_checkpoints": 65}, "rollout_keep_checkpoints"),
    ({"drift_ks_threshold": 1.5}, "drift_ks_threshold"),
    ({"capacity_window_s": 0.5}, "capacity_window_s"),
])
def test_settings_cross_checks_raise_in_both(kw, needle):
    with pytest.raises(ValueError):
        RefSettings(**kw)
    with pytest.raises(SettingsError, match=needle):
        ServiceSettings(**kw)


def test_model_routes_give_404_without_rollout_and_400_for_an_unknown_action():
    class Off:
        rollout = drift = None

    assert router._model(Off(), {}, None).status == 404
    assert router._model_control(Off(), {}, {"action": "promote"}).status == 404
    assert router._drift(Off(), {}, None).status == 404

    class On:
        rollout = object()   # present, never reached

    with pytest.raises(ValueError, match="unknown action"):
        router._model_control(On(), {}, {"action": "explode"})
    with pytest.raises(ValueError, match="integer"):
        router._model_control(On(), {}, {"action": "promote", "version": "x"})
    table = router.route_table()
    for key in (("GET", "/admin/model"), ("POST", "/admin/model"),
                ("GET", "/admin/drift"), ("GET", "/admin/slo")):
        assert key in table and key not in router.UNPORTED_ROUTES


def _http(port, path, payload=None):
    body = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if payload is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        text = resp.read().decode()
        return json.loads(text) if text.startswith(("{", "[")) else text


def _code(port, path, payload=None):
    try:
        _http(port, path, payload)
    except urllib.error.HTTPError as err:
        return err.code
    return 200


def _service(tmp_path, name, **settings):
    cfg = {"detectors": {"TorchScorerDetector": dict(
        BASE, method_type="torch_scorer", device="cpu", max_batch=64)}}
    return Service(ServiceSettings(
        component_type="detectors.torch_scorer.TorchScorerDetector", component_name=name,
        engine_addr=f"inproc://{name}", engine_autostart=False, http_port=0,
        log_to_file=False, watchdog_enabled=False, **settings),
        component_config=cfg, socket_factory=InprocQueueSocketFactory())


def test_admin_plane_without_the_lifecycle(tmp_path):
    svc = _service(tmp_path, "no-lifecycle")
    assert svc.rollout is None and svc.drift is None and svc.capacity is None
    svc.web_server.start()
    try:
        port = svc.web_server.port
        assert _code(port, "/admin/model") == 404
        assert _code(port, "/admin/model", {"action": "cycle"}) == 404
        assert _code(port, "/admin/drift") == 404
        slo = _http(port, "/admin/slo")
        assert slo["capacity"] is None and slo["burn"]["5m"]["burn_rate"] is None
    finally:
        svc.web_server.stop()
        svc.health.stop()


def test_whole_path_cycles_and_rolls_back_over_the_admin_plane(tmp_path):
    """``scripts/rollout_smoke.py``'s flow on the port's Service: cycle v1,
    cycle v2, roll back to v1, scores flowing after every swap, no
    unexpected capture, the lifecycle series exported; then a 400 for an
    unknown action and for a state conflict, and the stop order."""
    ledger = device_obs.CompileLedger()
    previous = device_obs.activate(ledger)
    svc = _service(tmp_path, "rollout-whole", rollout_enabled=True,
                   rollout_dir=str(tmp_path / "store"), rollout_interval_s=3600.0,
                   rollout_sample_ratio=1.0, rollout_sample_capacity=256,
                   rollout_min_fit_rows=32, rollout_min_shadow_samples=64,
                   rollout_shadow_timeout_s=60.0, rollout_max_mean_delta=5.0,
                   rollout_max_flip_ratio=0.1, rollout_keep_checkpoints=3,
                   drift_enabled=True, drift_interval_s=3600.0, capacity_enabled=True,
                   capacity_interval_s=3600.0)
    try:
        assert svc.rollout is not None and svc.drift is not None and svc.capacity is not None
        svc.setup_io()
        svc.web_server.start()
        port = svc.web_server.port
        det = svc.library_component
        assert det.process_batch([msg(i) for i in range(32)]) == []
        det.flush_final()
        feed(det, 100)

        def flow(base):
            outs = [o for o in det.process_batch([msg(base + i) for i in range(16)])
                    if o is not None]
            outs += [o for o in det.flush() if o is not None]
            assert outs

        for version, base in ((1, 300), (2, 400)):
            cycle = _http(port, "/admin/model", {"action": "cycle", "block": True})
            assert cycle["outcome"]["result"] == "promoted", cycle
            status = _http(port, "/admin/model")
            assert status["live_version"] == status["detector_version"] == version
            flow(base)
        rollback = _http(port, "/admin/model", {"action": "rollback"})
        assert rollback["result"] == "rolled_back"
        assert _http(port, "/admin/model")["detector_version"] == 1
        flow(500)
        history = _http(port, "/admin/model?history=1")
        assert {1, 2} <= {e["version"] for e in history["checkpoints"]}
        assert _http(port, "/admin/xla")["totals"]["unexpected"] == 0
        expo = _http(port, "/metrics")
        for needle in ('model_swaps_total{', 'result="promoted"', 'result="rolled_back"',
                       "model_version_info{", "model_shadow_divergence_count",
                       "model_checkpoint_age_seconds"):
            assert needle in expo, needle
        assert _code(port, "/admin/model", {"action": "explode"}) == 400
        assert _code(port, "/admin/model", {"action": "promote"}) == 400   # nothing shadows
        assert _code(port, "/admin/model", {"action": "promote", "version": 99}) == 400
        drift = _http(port, "/admin/drift")
        assert drift["drifting"] is False and drift["thresholds"]["ks"] == 0.25
        slo = _http(port, "/admin/slo")
        assert slo["capacity"]["window_s"] == 60.0
    finally:
        svc.shutdown()
        svc._teardown(save=False)
        device_obs.activate(previous)
    assert svc.rollout._thread is None and svc.drift._thread is None
    assert svc.capacity._thread is None and det._capacity_tap is None
    assert not svc.engine.running
