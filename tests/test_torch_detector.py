"""The port's ``TorchScorerDetector`` against the JAX package's
``JaxScorerDetector``: the same ParserSchema stream through both, from the
same bridged initial weights, in fp32 on the CPU, for the MLP, GRU, LogBERT
and int8w MLP detectors. Thresholds, alert decisions and alert fields must
agree (a decision may differ only within 1e-3 of a pinned threshold); the
int8 parity gate must install, keep decisions and refuse a corrupted
quantization as the JAX gate does; the options later slices port must
raise; and the port must import nothing of JAX or the JAX package."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from detectmateservice_tpu.library.common.core import LibraryError as RefLibraryError
from detectmateservice_tpu.library.detectors import JaxScorerDetector
from detectmateservice_tpu.schemas import DetectorSchema as RefDetectorSchema
from detectmateservice_tpu.schemas import ParserSchema as RefParserSchema
from detectmateservice_tpu_torch.library.common.core import LibraryError
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.schemas import DetectorSchema

REPO = Path(__file__).resolve().parents[1]
N_TRAIN = 128
BASE = {
    "auto_config": False, "model": "mlp", "data_use_training": N_TRAIN,
    "train_epochs": 1, "min_train_steps": 10, "train_batch_size": 32,
    "seq_len": 16, "dim": 32, "vocab_size": 4096, "max_batch": 64,
    "pipeline_depth": 2, "threshold_sigma": 3.0, "dtype": "float32",
    "async_fit": False, "host_score_max_batch": 16, "head_impl": "pallas",
}
# call sizes: full buckets, a ragged bucket, and host-path batches (<= 16)
CHUNKS = [64, 64, 50, 10, 64, 3, 64, 64, 33, 16]


def make_messages(n, anomaly_rate=0.05, seed=0):
    """bench.py's stream: audit lines with injected segfault anomalies."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n):
        if rng.random() < anomaly_rate and i >= N_TRAIN:
            template, variables = "segfault at <*> ip <*> sp <*>", [
                hex(rng.integers(2**30)) for _ in range(3)]
        else:
            template, variables = "type=<*> msg=audit(<*>): pid=<*> uid=<*> comm=<*>", [
                "SYSCALL", f"17000{i % 100}.{i % 997}", str(int(rng.integers(300, 500))),
                str(int(rng.integers(0, 4))), ["cron", "sshd", "systemd", "bash"][i % 4]]
        msgs.append(RefParserSchema(
            EventID=1, template=template, variables=variables, logID=str(i),
            logFormatVariables={"Time": str(1_700_000_000 + i)}).serialize())
    return msgs


STREAM = make_messages(N_TRAIN + sum(CHUNKS))


def _pair(**overrides):
    """A JAX and a port detector with the same config and the same initial
    weights (the JAX detector's seeded init, bridged into the port)."""
    cfg = dict(BASE, **overrides)
    jax_det = JaxScorerDetector(name="scorer", config=dict(cfg, method_type="jax_scorer"))
    port_det = TorchScorerDetector(name="scorer", config=dict(
        cfg, method_type="torch_scorer", device="cpu"))
    jax_det._ensure_scorer()
    port_det.load_params(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                 jax_det._params)))
    port_det.setup_io()
    return jax_det, port_det


def _run(det, stream=STREAM, chunks=(N_TRAIN, *CHUNKS)):
    out, pos = [], 0
    for size in chunks:
        out.extend(det.process_batch(stream[pos:pos + size]))
        pos += size
    out.extend(det.flush_final())
    return out


def _by_log_id(alerts, schema):
    parsed = [schema.from_bytes(a) for a in alerts]
    return {p["logIDs"][0]: p for p in parsed}


def _ref_scores(jax_det):
    """The JAX detector's score of every detect-phase message, by logID."""
    tokens, ok = jax_det._featurize_raw_batch(STREAM[N_TRAIN:])
    assert ok.all()
    scores = jax_det.score_tokens(tokens)
    return {str(N_TRAIN + i): float(s) for i, s in enumerate(scores)}


@pytest.fixture(scope="module")
def fitted_pair():
    jax_det, port_det = _pair()
    return jax_det, port_det, _run(jax_det), _run(port_det)


@pytest.fixture(scope="module")
def pinned_pair(fitted_pair):
    threshold = fitted_pair[0]._threshold
    jax_det, port_det = _pair(score_threshold=threshold)
    return jax_det, port_det, _run(jax_det), _run(port_det), threshold


class TestAgainstJaxDetector:
    def test_fitted_thresholds_match(self, fitted_pair):
        jax_det, port_det, _, _ = fitted_pair
        assert np.isfinite(port_det._threshold)
        np.testing.assert_allclose(port_det._threshold, jax_det._threshold, rtol=1e-3)
        np.testing.assert_allclose(port_det._calib_stats, jax_det._calib_stats, rtol=1e-3)

    def test_position_norm_thresholds_match(self):
        jax_det, port_det = _pair(score_norm="position")
        _run(jax_det, chunks=(N_TRAIN, 64))
        _run(port_det, chunks=(N_TRAIN, 64))
        np.testing.assert_allclose(port_det._norm_mu, jax_det._norm_mu, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(port_det._norm_sigma, jax_det._norm_sigma,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(port_det._threshold, jax_det._threshold, rtol=1e-3)

    def test_pinned_threshold_alert_decisions_identical(self, pinned_pair):
        jax_det, port_det, jax_out, port_out, threshold = pinned_pair
        assert port_det._threshold == jax_det._threshold == threshold
        jax_alerts = _by_log_id(jax_out, RefDetectorSchema)
        port_alerts = _by_log_id(port_out, DetectorSchema)
        assert jax_alerts and len(jax_alerts) < sum(CHUNKS)
        scores = _ref_scores(jax_det)
        for log_id in set(jax_alerts) ^ set(port_alerts):
            assert abs(scores[log_id] - threshold) < 1e-3, log_id
        # the device path and the host path both ran on both sides
        assert port_det.path_counts["device"] > 0 and port_det.path_counts["host"] > 0

    def test_alert_fields_match(self, pinned_pair):
        jax_det, port_det, jax_out, port_out, _ = pinned_pair
        assert len(port_out) == len(jax_out)
        for raw_port, raw_jax in zip(port_out, jax_out):
            got = DetectorSchema.from_bytes(raw_port).to_dict()
            want = RefDetectorSchema.from_bytes(raw_jax).to_dict()
            for key in ("detectionTimestamp", "receivedTimestamp"):
                assert got.pop(key) > 0 and want.pop(key) > 0
            np.testing.assert_allclose(got.pop("score"), want.pop("score"), rtol=1e-4)
            got_obtain, want_obtain = got.pop("alertsObtain"), want.pop("alertsObtain")
            assert list(got_obtain) == list(want_obtain) == ["scorer - score"]
            assert got_obtain["scorer - score"].split(" > ")[1] == \
                want_obtain["scorer - score"].split(" > ")[1]
            assert got.pop("detectorType") == "torch_scorer"
            assert want.pop("detectorType") == "jax_scorer"
            assert got.pop("description") == TorchScorerDetector.description
            assert want.pop("description") == JaxScorerDetector.description
            assert got == want

    def test_single_message_process_path_matches(self, pinned_pair):
        threshold = pinned_pair[4]
        jax_det, port_det = _pair(score_threshold=threshold)
        stream = STREAM[:N_TRAIN + 40]
        jax_out = [jax_det.process(m) for m in stream]
        port_out = [port_det.process(m) for m in stream]
        assert jax_out[:N_TRAIN] == port_out[:N_TRAIN] == [None] * N_TRAIN
        scores = _ref_scores(jax_det)
        for i in range(N_TRAIN, len(stream)):
            if (jax_out[i] is None) != (port_out[i] is None):
                assert abs(scores[str(i)] - threshold) < 1e-3
        hits = [o for o in port_out if o is not None]
        assert hits and DetectorSchema.from_bytes(hits[0])["score"] > threshold


def test_reconfigure_matches_the_jax_detector():
    """A live threshold_sigma change recomputes the threshold from the stored
    calibration stats; fields that need a rebuilt model are refused."""
    jax_det, port_det = _pair()
    _run(jax_det, chunks=(N_TRAIN, 16))
    _run(port_det, chunks=(N_TRAIN, 16))
    port_cfg = dict(BASE, method_type="torch_scorer", device="cpu")
    jax_det.reconfigure(dict(BASE, method_type="jax_scorer", threshold_sigma=1.0))
    port_det.reconfigure(dict(port_cfg, threshold_sigma=1.0))
    mean, std = port_det._calib_stats
    assert port_det._threshold == pytest.approx(mean + std)
    np.testing.assert_allclose(port_det._threshold, jax_det._threshold, rtol=1e-3)
    port_det.reconfigure(dict(port_cfg, score_threshold=7.5))
    assert port_det._threshold == 7.5
    with pytest.raises(LibraryError, match="dim"):
        port_det.reconfigure(dict(port_cfg, dim=64))
    with pytest.raises(LibraryError, match="device"):
        port_det.reconfigure(dict(port_cfg, device="cuda:0"))
    with pytest.raises(RefLibraryError, match="dim"):
        jax_det.reconfigure(dict(BASE, method_type="jax_scorer", dim=64))


def test_unparseable_time_falls_back_to_now_in_alerts():
    """A ``Time`` of "1e400" overflows ``int``; the alert then carries the
    detection time, as ``CoreDetector.extract_timestamp`` treats it (the JAX
    detector's batched alert raises OverflowError here)."""
    det = TorchScorerDetector(name="scorer", config=dict(
        BASE, method_type="torch_scorer", device="cpu", score_threshold=-1.0,
        data_use_training=0))
    raw = RefParserSchema(template="t <*>", variables=["v"], logID="9",
                          logFormatVariables={"Time": "1e400"}).serialize()
    out = det.process_batch([raw]) + det.flush_final()
    alert = DetectorSchema.from_bytes(out[0])
    assert alert["extractedTimestamps"] == [alert["detectionTimestamp"]]


class TestAsyncFit:
    def test_output_order_kept(self, fitted_pair):
        _, sync_det, _, sync_out = fitted_pair
        jax_det = JaxScorerDetector(name="scorer", config=dict(BASE, method_type="jax_scorer"))
        jax_det._ensure_scorer()
        det = TorchScorerDetector(name="scorer", config=dict(
            BASE, method_type="torch_scorer", device="cpu", async_fit=True))
        det.load_params(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                jax_det._params)))
        # the boundary fit starts mid-call; later calls land in the backlog
        out = _run(det, chunks=(N_TRAIN - 20, 84, *CHUNKS[1:], 20))
        ids = [int(DetectorSchema.from_bytes(a)["logIDs"][0]) for a in out]
        assert ids == sorted(ids)
        want = [int(DetectorSchema.from_bytes(a)["logIDs"][0]) for a in sync_out]
        assert ids == want
        assert det._fit_thread is None and not det._pending


def _frame_calls(stream=STREAM):
    """``process_frames`` calls over ``stream`` in order: packed frames of
    several sizes (one crossing the train/detect boundary at N_TRAIN),
    lone messages (host-path batches), empty frames, packed empty messages
    and corrupt batch frames (one truncated, one with trailing bytes)."""
    from detectmateservice_tpu_torch.engine.framing import pack_batch

    plan = [[40, 40], [40, "truncated", 40], [64, 1, 1, "empty"], [50, 64], [1],
            ["empties", 10], [64, 33, "trailing"], [64, 16], [32]]
    calls, pos = [], 0
    for group in plan:
        frames = []
        for item in group:
            if item == "empty":
                frames.append(b"")
            elif item == "truncated":
                frames.append(pack_batch(stream[pos:pos + 3])[:-2])
            elif item == "trailing":
                frames.append(pack_batch(stream[pos:pos + 3]) + b"\x01")
            elif item == "empties":
                frames.append(pack_batch([b"", b""]))
            elif item == 1:
                frames.append(stream[pos])
                pos += 1
            else:
                frames.append(pack_batch(stream[pos:pos + item][:3] + [b""]
                                         + stream[pos:pos + item][3:]))
                pos += item
        calls.append(frames)
    assert pos <= len(stream)
    return calls, pos


@pytest.mark.parametrize("native", [True, False])
def test_process_frames_matches_the_jax_detector(native, pinned_pair):
    """The same packed frames through both detectors' ``process_frames``,
    from the same weights at the pinned threshold: the training phase, the
    boundary inside a call, the steady state, lone messages on the host
    path and corrupt frames. Message and line counts are equal call by
    call; alerting logIDs may differ only within 1e-3 of the threshold, and
    the common alerts' scores agree to rtol 1e-4."""
    threshold = pinned_pair[4]
    jax_det, port_det = _pair(score_threshold=threshold, native_featurize=native)
    calls, n_msgs = _frame_calls()
    outs = {"jax": [], "port": []}
    for frames in calls:
        jax_ready, jax_n, jax_lines = jax_det.process_frames(frames)
        port_ready, port_n, port_lines = port_det.process_frames(frames)
        assert (port_n, port_lines) == (jax_n, jax_lines)
        outs["jax"].extend(jax_ready)
        outs["port"].extend(port_ready)
    outs["jax"].extend(jax_det.flush_final())
    outs["port"].extend(port_det.flush_final())
    assert sum(len(DetectorSchema.from_bytes(a)["logIDs"]) for a in outs["port"]) == \
        len(outs["port"])
    jax_alerts = _by_log_id(outs["jax"], RefDetectorSchema)
    port_alerts = _by_log_id(outs["port"], DetectorSchema)
    assert jax_alerts and len(port_alerts) < n_msgs - N_TRAIN
    assert all(int(i) >= N_TRAIN for i in port_alerts)
    scores = _ref_scores(jax_det)
    for log_id in set(jax_alerts) ^ set(port_alerts):
        assert abs(scores[log_id] - threshold) < 1e-3, log_id
    for log_id in set(jax_alerts) & set(port_alerts):
        np.testing.assert_allclose(port_alerts[log_id]["score"],
                                   jax_alerts[log_id]["score"], rtol=1e-4)
    assert port_det.path_counts["device"] > 0 and port_det.path_counts["host"] > 0
    rows = port_det.featurize_rows
    assert rows == ({"native": rows["native"], "fallback": 0} if native else
                    {"native": 0, "fallback": rows["fallback"]})
    assert max(rows.values()) >= n_msgs


LOGBERT = dict(BASE, model="logbert", depth=1, heads=2, score_topk=4,
               train_epochs=0, min_train_steps=0)
# per attention path, the head the test pairs it with (flash + the fused head
# is the GPU configuration)
LOGBERT_HEADS = {"einsum": "einsum", "flash": "pallas"}
LOGBERT_CHUNKS = (64, 64, 10, 64, 50)


@pytest.fixture(scope="module", params=["einsum", "flash"])
def logbert_pair(request):
    """The JAX and the port LogBERT detector from the same initial weights,
    fitted without train steps (calibration only, so the weights stay
    equal), then pinned to the JAX detector's threshold and run over the
    same detect stream."""
    attn = request.param
    cfg = dict(LOGBERT, attn_impl=attn, head_impl=LOGBERT_HEADS[attn])
    jax_det, port_det = _pair(**cfg)
    for det in (jax_det, port_det):
        assert det.process_batch(STREAM[:N_TRAIN]) == []
    fitted = (jax_det._threshold, port_det._threshold, jax_det._calib_stats,
              port_det._calib_stats)
    threshold = jax_det._threshold
    jax_det.reconfigure(dict(cfg, method_type="jax_scorer", score_threshold=threshold))
    port_det.reconfigure(dict(cfg, method_type="torch_scorer", device="cpu",
                              score_threshold=threshold))
    chunks = (0, *LOGBERT_CHUNKS)
    outs = [_run(det, stream=STREAM[N_TRAIN:], chunks=chunks) for det in (jax_det, port_det)]
    return attn, jax_det, port_det, fitted, threshold, outs


class TestLogBERTAgainstJaxDetector:
    def test_calibration_only_thresholds_match(self, logbert_pair):
        _, _, _, (jax_t, port_t, jax_stats, port_stats), _, _ = logbert_pair
        assert np.isfinite(port_t)
        np.testing.assert_allclose(port_t, jax_t, rtol=1e-3)
        np.testing.assert_allclose(port_stats, jax_stats, rtol=1e-3)

    def test_pinned_threshold_alert_decisions_identical(self, logbert_pair):
        attn, jax_det, port_det, _, threshold, (jax_out, port_out) = logbert_pair
        assert port_det._threshold == jax_det._threshold == threshold
        jax_alerts = _by_log_id(jax_out, RefDetectorSchema)
        port_alerts = _by_log_id(port_out, DetectorSchema)
        assert jax_alerts and len(jax_alerts) < sum(LOGBERT_CHUNKS)
        scores = _ref_scores(jax_det)
        for log_id in set(jax_alerts) ^ set(port_alerts):
            assert abs(scores[log_id] - threshold) < 1e-3, log_id
        for log_id in set(jax_alerts) & set(port_alerts):
            np.testing.assert_allclose(port_alerts[log_id]["score"],
                                       jax_alerts[log_id]["score"], rtol=1e-4)
        # flash has no host copy, so even the 10-row call rides the device
        assert port_det.path_counts["host"] == (0 if attn == "flash" else 1)


@pytest.mark.parametrize("attn,seq_len", [
    ("flash", 16), ("einsum", 16), ("blockwise", 16), ("auto", 16), ("auto", 2048)])
def test_host_copy_only_where_the_jax_detector_has_its_host_twin(attn, seq_len):
    """A logbert whose attention can take the flash kernels (``flash``, or
    ``auto`` at seq_len >= FLASH_MIN_SEQ) is device-only on both sides."""
    cfg = dict(LOGBERT, attn_impl=attn, seq_len=seq_len)
    jax_det = JaxScorerDetector(config=dict(cfg, method_type="jax_scorer"))
    port = TorchScorerDetector(config=dict(cfg, method_type="torch_scorer", device="cpu"))
    assert port._host_scoring_possible() == jax_det._host_scoring_possible()
    assert port._flash_reachable() == (not port._host_scoring_possible())
    port._ensure_scorer()
    assert (port._host_scorer is None) == (not jax_det._host_scoring_possible())


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_logbert_fit_trains(attn):
    """A real fit: the masked-LM steps give a finite loss, move the weights,
    and leave a finite threshold."""
    det = TorchScorerDetector(name="scorer", config=dict(
        LOGBERT, method_type="torch_scorer", device="cpu", attn_impl=attn,
        train_epochs=1, min_train_steps=3))
    det.setup_io()
    before = {k: v.clone() for k, v in det._model.state_dict().items()}
    det._train_buffer = list(det._featurize_raw_batch(STREAM[:N_TRAIN])[0])
    stats = det.fit()
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["threshold"])
    changed = [k for k, v in det._model.state_dict().items() if not torch.equal(v, before[k])]
    assert "blocks.0.qkv.weight" in changed and "pos_embed" in changed


GRU = dict(BASE, model="gru", depth=1, score_norm="position")


@pytest.fixture(scope="module")
def gru_pair():
    """The JAX and the port GRU detector (the fused head, position norm)
    from the same initial weights, each through its own fit, then pinned to
    the JAX detector's threshold and run over the same detect stream."""
    jax_det, port_det = _pair(**GRU)
    for det in (jax_det, port_det):
        assert det.process_batch(STREAM[:N_TRAIN]) == []
    fitted = (jax_det._threshold, port_det._threshold)
    threshold = jax_det._threshold
    jax_det.reconfigure(dict(GRU, method_type="jax_scorer", score_threshold=threshold))
    port_det.reconfigure(dict(GRU, method_type="torch_scorer", device="cpu",
                              score_threshold=threshold))
    outs = [_run(det, stream=STREAM[N_TRAIN:], chunks=(0, *CHUNKS)) for det in (jax_det, port_det)]
    return jax_det, port_det, fitted, threshold, outs


class TestGRUAgainstJaxDetector:
    def test_fitted_thresholds_and_norm_match(self, gru_pair):
        jax_det, port_det, (jax_t, port_t), _, _ = gru_pair
        assert np.isfinite(port_t)
        np.testing.assert_allclose(port_t, jax_t, rtol=1e-3)
        np.testing.assert_allclose(port_det._norm_mu, jax_det._norm_mu, rtol=1e-3, atol=1e-4)

    def test_pinned_threshold_alert_decisions_identical(self, gru_pair):
        """Zero flips farther than 1e-3 from the threshold (fp32)."""
        jax_det, port_det, _, threshold, (jax_out, port_out) = gru_pair
        jax_alerts = _by_log_id(jax_out, RefDetectorSchema)
        port_alerts = _by_log_id(port_out, DetectorSchema)
        assert jax_alerts and len(jax_alerts) < sum(CHUNKS)
        scores = _ref_scores(jax_det)
        for log_id in set(jax_alerts) ^ set(port_alerts):
            assert abs(scores[log_id] - threshold) < 1e-3, log_id
        for log_id in set(jax_alerts) & set(port_alerts):
            np.testing.assert_allclose(port_alerts[log_id]["score"],
                                       jax_alerts[log_id]["score"], rtol=1e-3)
        assert port_det.path_counts["device"] > 0 and port_det.path_counts["host"] > 0


INT8 = dict(BASE, dtype="int8w")


@pytest.fixture(scope="module")
def int8_pair():
    """The JAX and the port int8w MLP detector (fp32 activations on the
    CPU on both sides) from the same initial weights, each through its own
    fit and parity gate, then pinned to the JAX detector's threshold."""
    jax_det, port_det = _pair(**INT8)
    for det in (jax_det, port_det):
        assert det.process_batch(STREAM[:N_TRAIN]) == []
    reports = (jax_det._int8_report, port_det._int8_report)
    threshold = jax_det._threshold
    jax_det.reconfigure(dict(INT8, method_type="jax_scorer", score_threshold=threshold))
    port_det.reconfigure(dict(INT8, method_type="torch_scorer", device="cpu",
                              score_threshold=threshold))
    outs = [_run(det, stream=STREAM[N_TRAIN:], chunks=(0, *CHUNKS)) for det in (jax_det, port_det)]
    return jax_det, port_det, reports, threshold, outs


class TestInt8AgainstJaxDetector:
    def test_both_gates_install_at_zero_flips(self, int8_pair):
        jax_det, port_det, (jax_rep, port_rep), _, _ = int8_pair
        assert port_det._scorer.config.dtype == torch.float32   # fp32 on the CPU
        assert jax_rep["activated"] and port_rep["activated"]
        assert port_rep["gated"] and port_rep["where"] == "fit"
        assert port_rep["rows"] == jax_rep["rows"] == N_TRAIN
        assert port_rep["flips"] == jax_rep["flips"] == 0
        assert set(port_rep) == set(jax_rep)
        assert port_rep["bytes"] == jax_rep["bytes"]

    def test_pinned_threshold_alert_decisions_identical(self, int8_pair):
        """Zero flips farther than 1e-3 from the threshold."""
        jax_det, port_det, _, threshold, (jax_out, port_out) = int8_pair
        assert port_det._qstate is not None and jax_det._qparams is not None
        jax_alerts = _by_log_id(jax_out, RefDetectorSchema)
        port_alerts = _by_log_id(port_out, DetectorSchema)
        assert jax_alerts and len(jax_alerts) < sum(CHUNKS)
        scores = _ref_scores(jax_det)
        for log_id in set(jax_alerts) ^ set(port_alerts):
            assert abs(scores[log_id] - threshold) < 1e-3, log_id


def _int8_config(**overrides):
    return dict(BASE, method_type="torch_scorer", device="cpu", dtype="int8w",
                data_use_training=32, train_epochs=1, min_train_steps=5, max_batch=32,
                host_score_max_batch=0, threshold_sigma=4.0, **overrides)


def _int8_detector(**overrides):
    """``tests/test_warmstart.py``'s int8 detector on the port: a real
    calibrated threshold, so the gate judges decisions that can flip."""
    det = TorchScorerDetector(config=_int8_config(**overrides))
    det.setup_io()
    assert det.process_batch(STREAM[:32]) == []
    det.flush_final()
    return det


class TestInt8Parity:
    """The three gate cases of ``tests/test_warmstart.py::TestInt8Parity``."""

    def test_int8_activates_with_zero_flips(self):
        rep = _int8_detector()._int8_report
        assert rep is not None and rep["activated"]
        assert rep["gated"], "parity corpus missing: the gate never judged"
        assert rep["rows"] > 0
        assert rep["flips"] == 0 and rep["flip_ratio"] == 0.0
        assert rep["bytes"]["int8_bytes"] > 0

    def test_int8_decisions_match_float_path(self):
        det = _int8_detector()
        assert det._qstate is not None
        tokens = np.random.default_rng(11).integers(
            0, 100, size=(det.config.max_batch, det.config.seq_len)).astype(np.int32)
        q_scores = det.score_tokens(tokens)
        qstate, det._qstate = det._qstate, None
        try:
            f_scores = det.score_tokens(tokens)
        finally:
            det._qstate = qstate
        assert np.all(np.isfinite(q_scores))
        assert not np.array_equal(q_scores, f_scores)   # the int8 copy served
        thr = det._threshold
        assert np.array_equal(q_scores > thr, f_scores > thr)

    def test_parity_gate_refuses_corrupt_quantization(self, monkeypatch):
        from detectmateservice_tpu_torch.models import quant

        det = _int8_detector()
        assert det._int8_report["activated"]
        real_quantize = quant.quantize

        def corrupt_quantize(state, linear_keys):
            return real_quantize({k: v * 0.0 for k, v in state.items()}, linear_keys)

        monkeypatch.setattr(quant, "quantize", corrupt_quantize)
        rep = det._activate_int8(where="test")
        assert not rep["activated"]
        assert rep["flips"] > 0
        assert det._qstate is None, "refused int8 state left installed"
        scores = det.score_tokens(np.zeros((det.config.max_batch, det.config.seq_len), np.int32))
        assert np.all(np.isfinite(scores))


@pytest.mark.parametrize("score_norm", ["none", "position"])
def test_int8w_keeps_only_int8_payloads_scales_and_passthrough(score_norm, tmp_path):
    """After a gated activation the detector holds no second float model:
    the int8 state is exactly ``quant_stats``'s int8 and float bytes, shares
    no storage with the training model, and scores bit-equal to a float
    copy dequantized once (fp32 on the CPU); a checkpoint restore
    re-quantizes, ungated, to the same scores."""
    from detectmateservice_tpu_torch.models import quant

    det = _int8_detector(score_norm=score_norm)
    report = det._int8_report
    assert report["activated"] and report["gated"]
    modules = {name for name, value in vars(det).items()
               if isinstance(value, torch.nn.Module)}
    assert modules == {"_model", "_serving"}      # no host copy at host_score_max_batch 0
    assert all(p.is_meta for p in det._serving.parameters())
    leaves = [t for leaf in det._qstate.values() for t in leaf]
    int8_bytes = sum(t.numel() for t in leaves if t.dtype == torch.int8)
    float_bytes = sum(t.numel() * t.element_size() for t in leaves if t.is_floating_point())
    assert (int8_bytes, float_bytes) == (report["bytes"]["int8_bytes"],
                                         report["bytes"]["float_bytes"])
    assert int8_bytes + float_bytes < sum(
        p.numel() * p.element_size() for p in det._model.parameters()) / 3
    model_ptrs = {p.data_ptr() for p in det._model.parameters()}
    assert not any(t.data_ptr() in model_ptrs for t in leaves)

    tokens = np.random.default_rng(5).integers(
        3, 4096, size=(det.config.max_batch, det.config.seq_len)).astype(np.int32)
    tokens[:, 20:] = 0
    got = det.score_tokens(tokens)
    once = det._scorer.clone_model(det._model, torch.device("cpu"))
    once.load_state_dict(quant.dequantize(det._qstate, torch.float32))
    wide = torch.from_numpy(tokens).long()
    if score_norm == "position":
        want = det._scorer.normscore(once, wide, *det._norm_dev).numpy()
    else:
        want = det._scorer.score(once, wide).numpy()
    np.testing.assert_array_equal(got, want)

    det.save_checkpoint(str(tmp_path / "ckpt"))
    fresh = TorchScorerDetector(config=_int8_config(score_norm=score_norm))
    fresh.load_checkpoint(str(tmp_path / "ckpt"))
    assert fresh._int8_report["activated"] and fresh._int8_report["gated"] is False
    assert fresh._qstate is not None
    np.testing.assert_array_equal(fresh.score_tokens(tokens), got)


@pytest.mark.parametrize("field,value", [("model", "gru"), ("dtype", "int8w")])
def test_gru_and_int8w_are_accepted(field, value):
    det = TorchScorerDetector(config=dict(BASE, method_type="torch_scorer", device="cpu",
                                          **{field: value}))
    det.setup_io()
    assert det._scorer.name == ("gru" if field == "model" else "mlp")
    assert det.score_tokens(np.zeros((4, BASE["seq_len"]), np.int32)).shape == (4,)


class TestNotYetPorted:
    @pytest.mark.parametrize("field,value,raised", [
        ("attn_impl", "ring", "ring"),
        ("mesh_shape", {"data": 3}, "mesh shape"),
    ])
    def test_raises_naming_the_later_slice(self, field, value, raised):
        """Once ported, both options are accepted at construction and raise
        at setup_io where the JAX detector raises: ring attention without a
        sequence mesh, a mesh that needs more devices than there are."""
        cfg = dict(BASE, method_type="torch_scorer", device="cpu",
                   model="logbert" if field == "attn_impl" else BASE["model"])
        det = TorchScorerDetector(config=dict(cfg, **{field: value}))
        with pytest.raises(ValueError, match=raised):
            det.setup_io()

    @pytest.mark.parametrize("field,value", [
        ("head_impl", "cuda"), ("score_norm", "zscore"), ("dtype", "float8"),
        ("batch_target_occupancy", 0.0), ("model", "rnn")])
    def test_bad_values_rejected_as_the_jax_detector_rejects_them(self, field, value):
        cfg = dict(BASE, **{field: value})
        with pytest.raises(RefLibraryError):
            JaxScorerDetector(config=dict(cfg, method_type="jax_scorer"))
        with pytest.raises(LibraryError):
            TorchScorerDetector(config=dict(cfg, method_type="torch_scorer"))

    def test_config_mirrors_the_jax_config_field_for_field(self):
        from detectmateservice_tpu.library.detectors.jax_scorer import (
            JaxScorerDetectorConfig,
        )
        from detectmateservice_tpu_torch.library.detectors import TorchScorerDetectorConfig

        ref = JaxScorerDetectorConfig()
        port = TorchScorerDetectorConfig()
        for name, field in JaxScorerDetectorConfig.model_fields.items():
            if name == "method_type":
                continue
            assert getattr(port, name) == getattr(ref, name), name
        assert port.method_type == "torch_scorer"


class TestDevice:
    @pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
    def test_cuda_without_a_card_raises(self, device, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        det = TorchScorerDetector(config=dict(BASE, method_type="torch_scorer",
                                              device=device))
        with pytest.raises(LibraryError, match="CUDA"):
            det.setup_io()

    @pytest.mark.parametrize("device", ["tpu:0", "gpu", "cuda:x"])
    def test_unknown_device_raises(self, device):
        det = TorchScorerDetector(config=dict(BASE, method_type="torch_scorer",
                                              device=device))
        with pytest.raises(LibraryError, match="device"):
            det.setup_io()


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "detectmateservice_tpu",
              "google.protobuf", "pydantic")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """In a fresh interpreter (tests/conftest.py has already imported jax in
    this one): the port, its detector and warm set, its ops, its featurizer
    and framing, its service host (settings, config, engine, sockets,
    metrics, health, the capture ledger, admin plane, CLI), its model
    lifecycle (rollout, drift, capacity), its observability plane (the
    flight recorder, telemetry, the profiler), its chip plane (the mesh, the
    ring, the sharded scorer, the bootstrap), the demo stack's reader,
    parser and output, chip_smoke.py and bench_torch.py load without any of
    the forbidden modules."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import detectmateservice_tpu_torch\n"
        "import detectmateservice_tpu_torch.library.detectors.torch_scorer\n"
        "import detectmateservice_tpu_torch.ops.scorehead\n"
        "import detectmateservice_tpu_torch.ops.flash\n"
        "import detectmateservice_tpu_torch.ops.attention\n"
        "import detectmateservice_tpu_torch.models.logbert\n"
        "import detectmateservice_tpu_torch.models.gru\n"
        "import detectmateservice_tpu_torch.models.quant\n"
        "import detectmateservice_tpu_torch.utils.checkpoint\n"
        "import detectmateservice_tpu_torch.ops.cuda_build\n"
        "import detectmateservice_tpu_torch.models.convert\n"
        "import detectmateservice_tpu_torch.utils.device\n"
        "import detectmateservice_tpu_torch.utils.matchkern\n"
        "import detectmateservice_tpu_torch.engine.framing\n"
        "import detectmateservice_tpu_torch.settings\n"
        "import detectmateservice_tpu_torch.config\n"
        "import detectmateservice_tpu_torch.engine.engine\n"
        "import detectmateservice_tpu_torch.engine.socket\n"
        "import detectmateservice_tpu_torch.engine.metrics\n"
        "import detectmateservice_tpu_torch.engine.health\n"
        "import detectmateservice_tpu_torch.engine.device_obs\n"
        "import detectmateservice_tpu_torch.library.detectors.graphs\n"
        "import detectmateservice_tpu_torch.web.router\n"
        "import detectmateservice_tpu_torch.web.server\n"
        "import detectmateservice_tpu_torch.core\n"
        "import detectmateservice_tpu_torch.cli\n"
        "import detectmateservice_tpu_torch.rollout\n"
        "import detectmateservice_tpu_torch.obs\n"
        "import detectmateservice_tpu_torch.engine.tracing\n"
        "import detectmateservice_tpu_torch.telemetry\n"
        "import detectmateservice_tpu_torch.telemetry.otlp\n"
        "import detectmateservice_tpu_torch.telemetry.perfetto\n"
        "import detectmateservice_tpu_torch.utils.profiling\n"
        "import detectmateservice_tpu_torch.parallel.mesh\n"
        "import detectmateservice_tpu_torch.parallel.ring\n"
        "import detectmateservice_tpu_torch.parallel.sharded\n"
        "import detectmateservice_tpu_torch.parallel.distributed\n"
        "import detectmateservice_tpu_torch.library.readers\n"
        "import detectmateservice_tpu_torch.library.parsers\n"
        "import detectmateservice_tpu_torch.library.outputs\n"
        "import chip_smoke\n"
        "import bench_torch\n"
        "print(' '.join(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    bad = [m for m in loaded
           if any(m == f or m.startswith(f + ".") for f in _FORBIDDEN)]
    assert bad == []
    assert "detectmateservice_tpu_torch.library.detectors.torch_scorer" in loaded
    assert "detectmateservice_tpu_torch.ops.flash" in loaded
    assert "detectmateservice_tpu_torch.utils.checkpoint" in loaded
    assert "detectmateservice_tpu_torch.utils.matchkern" in loaded
    assert "detectmateservice_tpu_torch.core" in loaded
    assert "detectmateservice_tpu_torch.cli" in loaded
    assert "detectmateservice_tpu_torch.engine.device_obs" in loaded
    assert "detectmateservice_tpu_torch.library.detectors.graphs" in loaded
    assert "detectmateservice_tpu_torch.rollout.manager" in loaded
    assert "detectmateservice_tpu_torch.obs.drift" in loaded
    assert "detectmateservice_tpu_torch.obs.capacity" in loaded
    for name in ("engine.tracing", "telemetry.spans", "telemetry.collector",
                 "telemetry.otlp", "telemetry.perfetto", "utils.profiling",
                 "parallel.mesh", "parallel.ring", "parallel.sharded",
                 "parallel.distributed", "library.readers.log_file",
                 "library.parsers.template_matcher", "library.outputs.file_sink"):
        assert f"detectmateservice_tpu_torch.{name}" in loaded
    assert "bench_torch" in loaded


def _import_names(path):
    """Every module name an import statement of ``path`` names, lazy
    imports inside functions included."""
    import ast

    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_forbidden_import_statement_anywhere_in_the_port():
    """Lazy imports inside functions included: no source file of the port,
    and neither chip_smoke.py nor bench_torch.py, names a forbidden module in
    an import."""
    files = sorted((REPO / "detectmateservice_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    assert len(files) > 10
    for path in files:
        for name in _import_names(path):
            assert not any(name == f or name.startswith(f + ".") for f in _FORBIDDEN), \
                f"{path.relative_to(REPO)} imports {name}"


# the service host's three packages, and the only modules that import them
_SERVICE_ONLY = {"zmq": {"engine/socket.py"},
                 "yaml": {"settings.py", "config/manager.py"},
                 "prometheus_client": {"engine/metrics.py", "web/router.py"}}


def test_zmq_yaml_and_prometheus_client_only_in_the_service_modules():
    """Lazy imports included: only the named service modules of the port
    import zmq, yaml or prometheus_client; the library, models and ops load
    none of the three in a fresh interpreter."""
    root = REPO / "detectmateservice_tpu_torch"
    found = {pkg: set() for pkg in _SERVICE_ONLY}
    for path in sorted(root.rglob("*.py")):
        for name in _import_names(path):
            top = name.split(".")[0]
            if top in found:
                found[top].add(str(path.relative_to(root)))
    assert found == _SERVICE_ONLY
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import detectmateservice_tpu_torch.library.detectors.torch_scorer\n"
        "import detectmateservice_tpu_torch.models.logbert\n"
        "import detectmateservice_tpu_torch.ops.flash\n"
        "import detectmateservice_tpu_torch.utils.checkpoint\n"
        "import detectmateservice_tpu_torch.engine.framing\n"
        "import bench_torch\n"
        "print(' '.join(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    loaded = [m for m in proc.stdout.split() if m.split(".")[0] in _SERVICE_ONLY]
    assert loaded == []
