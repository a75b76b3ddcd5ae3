"""The port's capture ledger (``engine/device_obs.py``) and warm set
(``library/detectors/graphs.py``) on the CPU, held against the JAX
package's ``tests/test_device_obs.py``:

* the ledger's attribution, warm-up and unexpected-recompile rules, its
  bounded rings, the storm check's binding rule and ``emit_events``, with
  the same records as the JAX ledger gives;
* ``device_hbm_bytes``: nothing on the CPU; on a CUDA device the in-use and
  limit gauges read ``torch.cuda.memory_stats`` / ``mem_get_info`` at
  scrape time;
* the warm set: ``setup_io`` records one expected capture per warm bucket
  (``where="warmup"``), then ``warmup_complete``; a dispatch on a warm
  bucket records nothing; a bucket outside the set is captured as expected
  (``bucket_warm``); ``scorer_warmup_pending`` is UNHEALTHY while the set is
  captured; ``warm_set_spec()`` equals the JAX detector's;
* the Service path: an invalidated graph captured on the dispatch path is
  an unexpected recompile, counted, emitted, degrading deep health, and on
  ``GET /admin/xla`` with the JAX snapshot's top-level keys.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from detectmateservice_tpu.engine import device_obs as ref_device_obs
from detectmateservice_tpu.library.detectors import JaxScorerDetector
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine import device_obs
from detectmateservice_tpu_torch.engine import metrics as m
from detectmateservice_tpu_torch.engine.device_obs import (
    CompileLedger,
    RecompileStormCheck,
    WarmupPendingCheck,
)
from detectmateservice_tpu_torch.engine.health import EventLog, HealthMonitor
from detectmateservice_tpu_torch.engine.socket import InprocQueueSocketFactory
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.library.detectors import graphs
from detectmateservice_tpu_torch.settings import ServiceSettings

from conftest import wait_until

LABELS = {"component_type": "test_obs", "component_id": "obs-1"}
TORCH_SCORER = "detectmateservice_tpu_torch.library.detectors.torch_scorer.TorchScorerDetector"
SMALL = {"auto_config": False, "model": "mlp", "vocab_size": 256, "seq_len": 8, "dim": 8,
         "data_use_training": 8, "train_batch_size": 8, "max_batch": 16,
         "host_score_max_batch": 0, "dtype": "float32"}


def sample(name, labels):
    return m.REGISTRY.get_sample_value(name, labels)


def make_monitor(events=None):
    return HealthMonitor(dict(LABELS), events=events)


def both_ledgers(**bind):
    """The JAX ledger and the port's, bound alike (the port's with its
    metric factories)."""
    ref, port = ref_device_obs.CompileLedger(), CompileLedger()
    ref.bind(labels=LABELS, **bind)
    port.bind(labels=LABELS, metrics=m, **bind)
    return ref, port


def _same_event(ref_event, port_event):
    keys = ("bucket", "seconds", "where", "phase", "unexpected")
    assert {k: port_event[k] for k in keys} == {k: ref_event[k] for k in keys}


class TestCompileLedger:
    def test_warmup_compiles_are_recorded_but_never_flagged(self):
        ref, port = both_ledgers()
        for ledger in (ref, port):
            ledger.record_compile(0.5, bucket=8, backend="cpu", where="warmup", expected=True)
        _same_event(ref.snapshot()["compiles"][0], port.snapshot()["compiles"][0])
        snap = port.snapshot()
        assert snap["warmup_complete"] is False
        assert snap["totals"] == ref.snapshot()["totals"] == \
            {"compiles": 1, "seconds": 0.5, "unexpected": 0}
        assert sample("scorer_xla_compiles_total",
                      dict(LABELS, bucket="8", backend="cpu")) >= 1

    def test_dispatch_capture_after_warmup_is_flagged_and_emitted(self):
        events = EventLog()
        monitor = make_monitor(events)
        ledger = CompileLedger()
        ledger.bind(labels=LABELS, monitor=monitor, metrics=m)
        ledger.mark_warmup_complete()
        before = sample("scorer_xla_recompiles_unexpected_total", LABELS) or 0.0
        event = ledger.record_compile(1.25, bucket=64, backend="cuda", where="dispatch",
                                      expected=False)
        assert event["unexpected"] is True and event["phase"] == "runtime"
        assert sample("scorer_xla_recompiles_unexpected_total", LABELS) == before + 1
        recompiles = [e for e in events.snapshot()["events"]
                      if e.get("kind") == "unexpected_recompile"]
        assert recompiles and recompiles[-1]["bucket"] == "64"
        status, detail = RecompileStormCheck(ledger, monitor).evaluate(0.0)
        assert status == "degraded" and "unexpected recompile" in detail

    def test_external_records_are_kept_but_not_flagged(self):
        ref, port = both_ledgers()
        for ledger in (ref, port):
            ledger.mark_warmup_complete()
            event = ledger.record_compile(0.2)
            assert event["where"] == "external" and event["unexpected"] is False
            assert ledger.unexpected_in_window() == 0

    def test_expected_flag_is_inherited_through_nested_contexts(self):
        ref, port = both_ledgers()
        events = {}
        for name, ledger in (("ref", ref), ("port", port)):
            ledger.mark_warmup_complete()
            with ledger.context(bucket=32, where="dispatch", expected=False):
                with ledger.context(bucket=64, backend="mesh", where="sharded"):
                    first = ledger.record_compile(0.1)
            with ledger.context(where="fit", expected=True):
                with ledger.context(bucket=16, where="sharded"):
                    second = ledger.record_compile(0.1)
            events[name] = (first, second)
        for ref_event, port_event in zip(events["ref"], events["port"]):
            _same_event(ref_event, port_event)
        assert events["port"][0]["unexpected"] and events["port"][0]["bucket"] == "64"
        assert not events["port"][1]["unexpected"]

    def test_ring_and_span_log_are_bounded(self):
        ledger = CompileLedger(max_events=4, max_spans=3)
        ledger.bind(labels=LABELS, metrics=m)
        for i in range(10):
            ledger.record_compile(0.01, bucket=i, backend="cpu", where="warmup")
            ledger.record_span(8, 5, "device", 0.0, 0.01)
        snap = ledger.snapshot()
        assert len(snap["compiles"]) == 4 and len(snap["batches"]) == 3
        assert snap["totals"]["compiles"] == 10
        assert snap["compiles"][-1]["bucket"] == "9"

    def test_storm_check_passes_for_a_no_longer_bound_monitor(self):
        ledger = CompileLedger()
        old_monitor = make_monitor()
        ledger.bind(labels=LABELS, monitor=old_monitor, metrics=m)
        old_check = RecompileStormCheck(ledger, old_monitor)
        ledger.mark_warmup_complete()
        ledger.record_compile(1.0, bucket=8, where="dispatch", expected=False)
        assert old_check.evaluate(0.0)[0] == "degraded"
        new_monitor = make_monitor()
        ledger.bind(monitor=new_monitor)
        assert old_check.evaluate(0.0)[0] == "pass"
        new_check = RecompileStormCheck(ledger, new_monitor)
        assert new_check.evaluate(0.0)[0] == "pass"
        ledger.record_compile(1.0, bucket=8, where="dispatch", expected=False)
        assert new_check.evaluate(0.0)[0] == "degraded"

    def test_emit_events_off_still_counts_but_stays_silent(self):
        events = EventLog()
        ledger = CompileLedger()
        ledger.bind(labels=LABELS, monitor=make_monitor(events), emit_events=False, metrics=m)
        ledger.mark_warmup_complete()
        event = ledger.record_compile(0.3, bucket=8, where="dispatch", expected=False)
        assert event["unexpected"] is True
        assert not [e for e in events.snapshot()["events"]
                    if e.get("kind") == "unexpected_recompile"]

    def test_spans_and_snapshot_keys_match_the_jax_ledger(self):
        ref, port = both_ledgers()
        for ledger in (ref, port):
            ledger.set_bucket_state_provider(lambda: {"coalescing": False, "warm": [8],
                                                      "retired": []})
            ledger.record_span(16, 9, "device", 0.001, 0.02, trace_id="ab" * 8,
                               release="deadline")
            ledger.record_warmup_phase("aot", 0.5)
        ref_snap, port_snap = ref.snapshot(), port.snapshot()
        assert set(port_snap) == set(ref_snap)
        assert set(port_snap["compile_cache"]) == set(ref_snap["compile_cache"])
        span = {k: v for k, v in port_snap["batches"][-1].items() if k != "ts"}
        assert span == {k: v for k, v in ref_snap["batches"][-1].items() if k != "ts"}
        assert port_snap["warmup_phases"] == ref_snap["warmup_phases"] == {"aot": 0.5}

    def test_unbound_ledger_exports_no_series(self):
        ledger = CompileLedger()
        labels = {"component_type": "core", "component_id": "unknown"}
        before = sample("scorer_xla_compiles_total",
                        dict(labels, bucket="77", backend="cpu"))
        ledger.record_compile(0.1, bucket=77, backend="cpu", where="warmup")
        assert sample("scorer_xla_compiles_total",
                      dict(labels, bucket="77", backend="cpu")) == before
        assert ledger.snapshot()["totals"]["compiles"] == 1


class TestHbmGauges:
    def test_cpu_device_exports_nothing(self):
        labels = {"component_type": "hbm_cpu", "component_id": "none"}
        assert device_obs.export_hbm_gauges(labels, torch.device("cpu"), m) == 0
        assert sample("device_hbm_bytes", dict(labels, device="cpu", kind="in_use")) is None

    def test_cuda_device_exports_scrape_time_gauges(self, monkeypatch):
        stats = {"allocated_bytes.all.current": 1024}
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: dict(stats))
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (3072, 4096))
        labels = {"component_type": "hbm_fake", "component_id": "fake-1"}
        device = torch.device("cuda", 0)
        assert device_obs.export_hbm_gauges(labels, device, m) == 1
        key = dict(labels, device="cuda:0")
        assert (sample("device_hbm_bytes", dict(key, kind="in_use")),
                sample("device_hbm_bytes", dict(key, kind="limit"))) == (1024.0, 4096.0)
        stats["allocated_bytes.all.current"] = 2048   # read at scrape time
        assert sample("device_hbm_bytes", dict(key, kind="in_use")) == 2048.0
        assert device_obs.export_hbm_gauges(labels, device, None) == 0


# -- the warm set on the CPU -------------------------------------------------------
@pytest.fixture()
def ledger():
    """A fresh process ledger for one test, the previous one restored."""
    fresh = CompileLedger()
    previous = device_obs.activate(fresh)
    yield fresh
    device_obs.activate(previous)


def _port(**overrides):
    return TorchScorerDetector(config=dict(SMALL, method_type="torch_scorer", device="cpu",
                                           **overrides))


class TestWarmSet:
    def test_setup_io_records_expected_captures_then_warmup_complete(self, ledger):
        det = _port(score_norm="position")
        det.setup_io()
        snap = ledger.snapshot()
        assert snap["warmup_complete"] is True
        events = [(e["bucket"], e["where"], e["phase"], e["unexpected"], e["backend"])
                  for e in snap["compiles"]]
        # largest bucket first, then the calibration pass at the train bucket
        assert events == [("16", "warmup", "warmup", False, "cpu"),
                          ("8", "warmup", "warmup", False, "cpu"),
                          ("1", "warmup", "warmup", False, "cpu"),
                          ("8", "warmup", "warmup", False, "cpu")]
        assert det._warm.keys() == [("normscore", 1), ("normscore", 8), ("normscore", 16),
                                    ("token_nlls", 8)]
        assert set(snap["warmup_phases"]) == {"device_put", "cache_load", "aot"}

    def test_the_first_dispatch_records_nothing(self, ledger):
        det = _port()
        det.setup_io()
        compiles = ledger.snapshot()["totals"]["compiles"]
        tokens = np.zeros((16, SMALL["seq_len"]), np.int32)
        det._dispatch(tokens, [b""] * 16)
        det._dispatch(tokens[:1], [b""])
        assert ledger.snapshot()["totals"]["compiles"] == compiles

    def test_a_bucket_outside_the_set_is_captured_as_expected(self, ledger):
        det = _port()
        det.setup_io()
        tokens = np.zeros((3, SMALL["seq_len"]), np.int32)
        det._dispatch(tokens, [b"a", b"b", b"c"])   # bucket 4: not in {1, 8, 16}
        det.flush()
        snap = ledger.snapshot()
        grown = [e for e in snap["compiles"] if e["bucket"] == "4"]
        assert [(e["where"], e["unexpected"]) for e in grown] == [("bucket_warm", False)]
        assert 4 in det.warm_set_spec()["buckets"]
        assert snap["batches"][-1]["bucket"] == 4 and snap["batches"][-1]["real"] == 3

    def test_warmup_pending_is_unhealthy_while_the_set_is_captured(self, ledger,
                                                                   monkeypatch):
        monitor = make_monitor()
        ledger.bind(labels=LABELS, monitor=monitor, metrics=m)
        seen = []
        capture = graphs.WarmSet.capture

        def watching(self, *args, **kwargs):
            seen.append(WarmupPendingCheck(ledger, monitor).evaluate(time.monotonic())[0])
            return capture(self, *args, **kwargs)

        monkeypatch.setattr(graphs.WarmSet, "capture", watching)
        det = _port()
        det.setup_io()
        assert seen and set(seen) == {"unhealthy"}
        names = [c["name"] for c in monitor.evaluate()["checks"]]
        assert "scorer_warmup_pending" in names
        status = {c["name"]: c["status"] for c in monitor.evaluate()["checks"]}
        assert status["scorer_warmup_pending"] in ("pass", "unhealthy")  # hysteresis
        assert WarmupPendingCheck(ledger, monitor).evaluate(time.monotonic())[0] == "pass"

    @pytest.mark.parametrize("overrides", [
        {}, {"host_score_max_batch": 128}, {"score_norm": "position", "max_batch": 12},
        {"train_batch_size": 5, "max_batch": 64, "dtype": "auto"}])
    def test_warm_set_spec_equals_the_jax_detectors(self, ledger, overrides):
        cfg = dict(SMALL, **overrides)
        ref = JaxScorerDetector(config=dict(cfg, method_type="jax_scorer"))
        ref.setup_io()
        det = _port(**overrides)
        det.setup_io()
        assert det.warm_set_spec() == ref.warm_set_spec()

    def test_an_int8_cutover_recaptures_the_active_set_as_expected(self, ledger):
        det = _port(dtype="int8w", data_use_training=16, train_epochs=1, min_train_steps=2)
        det.setup_io()
        seq0 = ledger.snapshot()["compiles"][-1]["seq"]
        rng = np.random.default_rng(0)
        det._train_buffer = [rng.integers(4, 256, SMALL["seq_len"]).astype(np.int32)
                             for _ in range(16)]
        det.fit()
        report = det._int8_report
        assert report["gated"] if report["activated"] else report["flips"] > 0
        # the gate judged the int8 path through the warm set, and afterwards
        # no graph of other weights is left: all of it expected captures
        events = [e for e in ledger.snapshot()["compiles"] if e["seq"] > seq0]
        assert events and all(e["where"] == "int8_activate" and not e["unexpected"]
                              for e in events)
        assert det._warm.stale() == []
        assert {b for _, b in det._warm.keys()} == {1, 8, 16}


# -- the Service path end to end ----------------------------------------------------
def http_json(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_an_invalidated_graph_on_the_dispatch_path_is_an_unexpected_recompile(ledger):
    """A warm bucket whose graph is gone is captured on the dispatch path:
    counted, emitted, the storm check degrades deep health, and
    ``GET /admin/xla`` shows it, with the JAX snapshot's top-level keys."""
    factory = InprocQueueSocketFactory()
    svc = Service(ServiceSettings(component_type=TORCH_SCORER, component_name="devobs",
                                  engine_addr="inproc://tdo", http_port=0,
                                  log_to_file=False, log_to_console=False,
                                  watchdog_enabled=False),
                  component_config={"detectors": {"TorchScorerDetector": dict(
                      SMALL, method_type="torch_scorer", device="cpu")}},
                  socket_factory=factory)
    try:
        svc.setup_io()
        svc.web_server.start()
        assert wait_until(lambda: svc.web_server.port, 10.0)
        port = svc.web_server.port
        det = svc.library_component
        assert ledger.warmup_complete
        assert all(not e["unexpected"] for e in ledger.snapshot()["compiles"])
        labels = dict(component_type=TORCH_SCORER, component_id=svc.settings.component_id)
        before = sample("scorer_xla_recompiles_unexpected_total", labels) or 0.0
        det._warm.drop(8)                      # the bucket stays in the warm set
        tokens = np.zeros((5, SMALL["seq_len"]), np.int32)
        det._dispatch(tokens, [b"a"] * 5)
        det.flush()
        assert sample("scorer_xla_recompiles_unexpected_total", labels) == before + 1

        code, body = http_json(port, "/admin/xla?limit=5")
        ref_keys = set(ref_device_obs.CompileLedger().snapshot()) | {"buckets"}
        assert code == 200 and set(body) == ref_keys
        flagged = [e for e in body["compiles"] if e["unexpected"]]
        assert flagged and flagged[-1]["bucket"] == "8" and flagged[-1]["where"] == "dispatch"
        assert body["batches"][-1]["bucket"] == 8 and body["batches"][-1]["real"] == 5
        assert body["buckets"]["warm"] == [1, 8, 16] and len(body["compiles"]) <= 5

        code, events = http_json(port, "/admin/events")
        assert [e for e in events["events"] if e.get("kind") == "unexpected_recompile"]
        code, health = http_json(port, "/admin/health?deep=1")
        failing = {c["name"]: c["status"] for c in health["checks"] if c["status"] != "pass"}
        assert code == 503 and failing == {"xla_recompile_storm": "degraded"}
    finally:
        svc._teardown(save=False)


def test_recompile_alerts_off_registers_no_storm_check(ledger):
    svc = Service(ServiceSettings(component_type="core", engine_addr="inproc://tdo2",
                                  http_port=0, log_to_file=False, log_to_console=False,
                                  watchdog_enabled=False, recompile_alert_enabled=False),
                  socket_factory=InprocQueueSocketFactory())
    try:
        names = [c["name"] for c in svc.health.evaluate()["checks"]]
        assert "xla_recompile_storm" not in names
        assert ledger.monitor is svc.health
    finally:
        svc._teardown(save=False)


def test_candidate_ids_stay_in_one_device_tensor_across_a_restored_subset():
    """A graph that captured the candidate-vocab ids reads their storage: a
    restored subset is copied into it, and no upload happens on later
    calls."""
    from detectmateservice_tpu_torch.models.gru import GRUScorer, GRUScorerConfig

    scorer = GRUScorer(GRUScorerConfig(vocab_size=1024, dim=8, depth=1, seq_len=8,
                                       score_vocab=64, dtype=torch.float32))
    first = scorer._candidate_ids_on(1024, 64, torch.device("cpu"))
    assert scorer._candidate_ids_on(1024, 64, torch.device("cpu")) is first
    restored = np.arange(0, 128, 2, dtype=np.int32)
    scorer._cand_cache = ((1024, 64), restored)
    again = scorer._candidate_ids_on(1024, 64, torch.device("cpu"))
    assert again is first and again.tolist() == restored.tolist()
