"""The port's drift and capacity observability (``obs/``) against the JAX
package's, on the CPU: KS, PSI and ``DriftBaseline.fit``/``to_dict`` equal
on the same arrays; under one fake clock the drift monitors give the same
documents and events, start the same cycles and keep the same cooldown; a
baseline persisted in the port's store resumes after a restart; the capacity
monitors give equal documents from traffic arithmetic, the idle probe and
its hold; the SLO tracker computes the same burn windows from the same
counts, and on a traced Service its burn windows and dwell attribution
fill from the ``pipeline_*`` series."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from detectmateservice_tpu.obs import CapacityMonitor as RefCapacity
from detectmateservice_tpu.obs import DriftBaseline as RefBaseline
from detectmateservice_tpu.obs import DriftMonitor as RefDrift
from detectmateservice_tpu.obs import SloTracker as RefSlo
from detectmateservice_tpu.obs import ks_statistic as ref_ks
from detectmateservice_tpu.obs import psi as ref_psi
from detectmateservice_tpu.rollout import CheckpointStore as RefStore
from detectmateservice_tpu_torch.engine import metrics as port_metrics
from detectmateservice_tpu_torch.obs import (
    CapacityMonitor,
    DriftBaseline,
    DriftMonitor,
    SloTracker,
    ks_statistic,
    psi,
)
from detectmateservice_tpu_torch.rollout import CheckpointStore

LABELS = {"component_type": "detectors.torch_scorer.TorchScorerDetector",
          "component_id": "drift-port-test"}


def drift_settings(**over):
    base = dict(
        drift_interval_s=30.0, drift_baseline_size=256, drift_min_rows=16,
        drift_ks_threshold=0.25, drift_psi_threshold=0.2,
        drift_feature_psi_threshold=0.25, drift_trigger_intervals=3,
        drift_clear_intervals=2, drift_min_cycle_interval_s=900.0)
    base.update(over)
    return SimpleNamespace(**base)


def capacity_settings(**over):
    base = dict(capacity_interval_s=15.0, capacity_probe_rows=64,
                capacity_probe_idle_s=30.0, capacity_window_s=60.0)
    base.update(over)
    return SimpleNamespace(**base)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeSampler:
    """The reservoir is the test input."""

    def __init__(self):
        self.rows = np.zeros((0, 0), np.int32)
        self.scores = np.zeros(0, np.float32)

    def set(self, scores, rows=None):
        self.scores = np.asarray(scores, np.float32)
        self.rows = (np.asarray(rows, np.int32) if rows is not None
                     else np.zeros((len(self.scores), 0), np.int32))

    def snapshot(self, with_scores=False):
        return (self.rows, self.scores) if with_scores else self.rows

    def stats(self):
        return {"held_rows": len(self.rows)}


class FakeRollout:
    def __init__(self, result=None):
        self.result = result or {"version": 2, "reason": "drift"}
        self.calls = []

    def run_cycle(self, reason, block=False):
        self.calls.append(reason)
        return dict(self.result)


def normal(n, loc=0.0, scale=1.0, seed=0):
    return np.random.default_rng(seed).normal(loc, scale, n)


# ---------------------------------------------------------------------------
# statistics and the baseline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shift,scale,seed", [(0.0, 1.0, 1), (0.5, 1.0, 2), (2.0, 3.0, 3),
                                              (0.0, 0.2, 4)])
def test_ks_and_psi_equal_the_jax_statistics(shift, scale, seed):
    base = RefBaseline.fit(None, None, normal(3000, seed=seed), keep=512, pinned_unix=0.0)
    live = normal(1500, loc=shift, scale=scale, seed=seed + 10)
    assert ks_statistic(base.scores, live) == ref_ks(base.scores, live)
    assert psi(base.score_props, live, base.score_edges) == \
        ref_psi(base.score_props, live, base.score_edges)
    assert ks_statistic(np.array([]), live) == ref_ks(np.array([]), live) == 0.0


@pytest.mark.parametrize("n,keep,with_rows", [(600, 256, True), (100, 512, True),
                                              (4000, 512, False)])
def test_baseline_fit_and_document_equal_the_jax_baseline(n, keep, with_rows):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 50, size=(n, 6)).astype(np.int32) if with_rows else None
    if with_rows:
        rows[:, 2] = 7                       # a constant column: no PSI edges
    scores = normal(n, seed=n)
    scores[::17] = np.nan
    ref = RefBaseline.fit(3, rows, scores, keep=keep, pinned_unix=12.5)
    port = DriftBaseline.fit(3, rows, scores, keep=keep, pinned_unix=12.5)
    assert port.to_dict() == ref.to_dict()
    doc = json.loads(json.dumps(port.to_dict()))
    assert DriftBaseline.from_dict(doc).to_dict() == RefBaseline.from_dict(doc).to_dict()
    assert DriftBaseline.fit(None, None, np.full(10, np.nan), keep=8, pinned_unix=0) is None
    with pytest.raises(ValueError, match="schema"):
        DriftBaseline.from_dict({"schema": "bogus", "scores": []})


# ---------------------------------------------------------------------------
# the monitor: hysteresis, events, cycles, cooldown, persistence
# ---------------------------------------------------------------------------
def _pair(store_ref=None, store_port=None, rollout=True, **settings_over):
    """A JAX and a port monitor on one fake sampler and one clock each."""
    sampler = FakeSampler()
    out = []
    for cls, store in ((RefDrift, store_ref), (DriftMonitor, store_port)):
        clock = FakeClock()
        fake = FakeRollout() if rollout else None
        out.append((cls(drift_settings(**settings_over), sampler, store=store, rollout=fake,
                        labels=LABELS, clock=clock, wall_clock=lambda: 1_700_000_000.0),
                    clock, fake))
    return sampler, out


def _tick_both(pair):
    docs = [monitor.tick() for monitor, _, _ in pair]
    assert docs[1] == docs[0]
    return docs[1]


def test_hysteresis_events_and_cycles_follow_the_jax_monitor():
    sampler, pair = _pair(drift_trigger_intervals=3, drift_clear_intervals=2,
                          drift_min_cycle_interval_s=100.0)
    sampler.set(normal(500, seed=9), np.random.default_rng(9).integers(0, 40, (500, 4)))
    _tick_both(pair)                             # pins the in-memory baseline
    shifted = normal(500, loc=3.0, seed=10)
    clean = normal(500, seed=11)
    rows = np.random.default_rng(12).integers(0, 40, (500, 4))
    sequence = [shifted, clean] * 3 + [shifted] * 5 + [clean] * 3
    advances = [0.0] * 6 + [0.0, 0.0, 0.0, 50.0, 51.0] + [1.0] * 3
    for scores, dt in zip(sequence, advances):
        for _, clock, _ in pair:
            clock.advance(dt)
        sampler.set(scores, rows)
        doc = _tick_both(pair)
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds.count("drift_detected") == 1 and kinds.count("drift_cleared") == 1
    (_, _, ref_rollout), (_, _, port_rollout) = pair
    # latched at the 3rd shifted tick, again after the 100 s cooldown
    assert port_rollout.calls == ref_rollout.calls == ["drift", "drift"]
    assert doc["drifting"] is False


def test_a_deferred_cycle_does_not_consume_the_cooldown_in_either():
    sampler, pair = _pair(drift_trigger_intervals=1, drift_min_cycle_interval_s=1000.0)
    sampler.set(normal(500, seed=1))
    _tick_both(pair)
    for _, _, fake in pair:
        fake.result = {"skipped": "a candidate is already shadowing"}
    sampler.set(normal(500, loc=3.0, seed=13))
    for step in range(4):
        if step == 2:
            for _, _, fake in pair:
                fake.result = {"version": 2, "reason": "drift"}
        for _, clock, _ in pair:
            clock.advance(1.0)
        _tick_both(pair)
    (_, _, ref_rollout), (_, _, port_rollout) = pair
    assert port_rollout.calls == ref_rollout.calls == ["drift"] * 3


def test_too_few_rows_defer_evaluation_in_both():
    sampler, pair = _pair(rollout=False, drift_min_rows=64)
    sampler.set(normal(4, seed=16))
    doc = _tick_both(pair)
    assert doc["stats"]["ks"] is None and doc["drifting"] is False


def test_a_persisted_baseline_resumes_after_a_restart(tmp_path):
    store = CheckpointStore(tmp_path / "s")
    store.record(1, {"tag": "seed"})
    store.set_live(1)
    sampler = FakeSampler()
    sampler.set(normal(500, seed=7))
    first = DriftMonitor(drift_settings(), sampler, store=store, labels=LABELS,
                         clock=FakeClock(), wall_clock=lambda: 1000.0)
    first.tick()
    assert first.status()["baseline"]["persisted"] is True
    assert store.entry(1)["meta"]["tag"] == "seed"
    drifted = FakeSampler()
    drifted.set(normal(500, loc=3.0, seed=8))
    second = DriftMonitor(drift_settings(drift_trigger_intervals=1), drifted, store=store,
                          labels=LABELS, clock=FakeClock(), wall_clock=lambda: 2000.0)
    second.tick()
    snap = second.status()
    assert snap["baseline"]["pinned_unix"] == pytest.approx(1000.0)
    assert snap["stats"]["ks"] > 0.8 and snap["drifting"] is True
    assert [e["reason"] for e in snap["events"] if e["kind"] == "drift_baseline_pinned"] \
        == ["resume"]


def test_a_promotion_repins_in_both_stores(tmp_path):
    stores = (RefStore(tmp_path / "ref"), CheckpointStore(tmp_path / "port"))
    for store in stores:
        store.record(1, {})
        store.set_live(1)
    sampler, pair = _pair(*stores, rollout=False, drift_trigger_intervals=2,
                          drift_clear_intervals=2)
    sampler.set(normal(500, seed=14))
    _tick_both(pair)
    sampler.set(normal(500, loc=3.0, seed=15))
    _tick_both(pair)
    assert _tick_both(pair)["drifting"] is True
    for store in stores:
        store.record(2, {})
        store.set_live(2)
    doc = _tick_both(pair)
    assert doc["baseline"]["version"] == 2 and doc["baseline"]["persisted"]
    assert _tick_both(pair)["drifting"] is False
    assert stores[1].entry(2)["meta"]["drift_baseline"] == \
        stores[0].entry(2)["meta"]["drift_baseline"]


def test_the_health_check_degrades_while_drifting():
    from detectmateservice_tpu_torch.engine.health import DEGRADED, PASS
    from detectmateservice_tpu_torch.obs.drift import _DriftCheck

    sampler = FakeSampler()
    monitor = DriftMonitor(drift_settings(drift_trigger_intervals=1), sampler,
                           labels=LABELS, clock=FakeClock())
    check = _DriftCheck(monitor)
    assert check.evaluate(0.0)[0] == PASS
    sampler.set(normal(500, seed=1))
    monitor.tick()
    sampler.set(normal(500, loc=4.0, seed=2))
    monitor.tick()
    status, detail = check.evaluate(0.0)
    assert status == DEGRADED and "drifted" in detail


def test_start_runs_the_ticks_numpy_paths_before_the_thread(monkeypatch):
    """A deliberate difference from the JAX monitor (ROADMAP.md's
    register): ``start`` runs every numpy path a tick takes once on
    synthetic values (``warm_statistics``), on the caller's thread and
    before the monitor's thread starts, so a module numpy loads at its
    first call is not loaded inside a tick while traffic flows; the ticks'
    results stay the JAX monitor's."""
    from detectmateservice_tpu_torch.obs import drift as drift_mod

    calls = []
    warm = drift_mod.warm_statistics
    monkeypatch.setattr(drift_mod, "warm_statistics", lambda: calls.append(
        (drift_mod.threading.current_thread().name, monitor._thread)) or warm())
    monitor = DriftMonitor(drift_settings(drift_interval_s=3600.0), FakeSampler(),
                           labels=LABELS, clock=FakeClock())
    monitor.start()
    try:
        assert calls == [(drift_mod.threading.current_thread().name, None)]
        assert monitor._thread is not None and monitor._thread.is_alive()
    finally:
        monitor.stop()
    ref = RefDrift(drift_settings(drift_trigger_intervals=1), FakeSampler(), labels=LABELS,
                   clock=FakeClock())
    port = DriftMonitor(drift_settings(drift_trigger_intervals=1), FakeSampler(),
                        labels=LABELS, clock=FakeClock())
    for values in (normal(500, seed=1), normal(500, loc=4.0, seed=2)):
        for m in (ref, port):
            m.sampler.set(values)
            m.tick()
    assert port.status()["stats"] == ref.status()["stats"]
    assert port.status()["drifting"] == ref.status()["drifting"]


# ---------------------------------------------------------------------------
# capacity and the SLO tracker
# ---------------------------------------------------------------------------
def _capacity_pair(detector, **settings_over):
    clocks = (FakeClock(), FakeClock())
    monitors = (RefCapacity(detector, capacity_settings(**settings_over), labels=LABELS,
                            clock=clocks[0]),
                CapacityMonitor(detector, capacity_settings(**settings_over), labels=LABELS,
                                clock=clocks[1]))
    return clocks, monitors


def test_traffic_arithmetic_gives_the_jax_documents():
    clocks, monitors = _capacity_pair(SimpleNamespace(), capacity_probe_idle_s=1e9)
    for rows, seconds in [(1000, 1.0), (500, 0.5), (64, 0.01)]:
        for clock, monitor in zip(clocks, monitors):
            clock.advance(10.0)
            monitor.on_batch(rows, seconds)
        docs = [monitor.tick() for monitor in monitors]
        assert docs[1] == docs[0]
        assert monitors[1].status() == monitors[0].status()
    assert docs[1]["source"] == "traffic"
    assert docs[1]["capacity_lines_per_s"] == pytest.approx(1564 / 1.51)


def test_the_idle_probe_and_its_hold_give_the_jax_documents(monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.004))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    calls = []

    def rollout_scores(params, tokens):
        calls.append((params, tokens.shape, tokens.dtype))
        return np.zeros(len(tokens), np.float32)

    detector = SimpleNamespace(rollout_ready=lambda: True, rollout_scores=rollout_scores,
                               config=SimpleNamespace(vocab_size=50, seq_len=4))
    clocks, monitors = _capacity_pair(detector, capacity_probe_rows=64,
                                      capacity_probe_idle_s=5.0)
    docs = []
    for clock, monitor in zip(clocks, monitors):
        clock.advance(10.0)
        docs.append(monitor.tick())
    assert docs[1] == docs[0] and docs[1]["source"] == "probe"
    assert calls[0][0] is None and calls[0][1:] == calls[1][1:] == ((64, 4), np.int32)
    assert monitors[1].status() == monitors[0].status()
    detector.rollout_ready = lambda: False       # mid-fit: the last capacity holds
    held = []
    for clock, monitor in zip(clocks, monitors):
        clock.advance(10.0)
        held.append(monitor.tick())
    assert held[1] == held[0]
    assert held[1]["capacity_lines_per_s"] == docs[1]["capacity_lines_per_s"]
    assert monitors[1].status()["capacity_source"] == "probe"


def test_a_failed_probe_logs_and_yields_no_number(caplog):
    def boom(params, tokens):
        raise RuntimeError("device lost")

    detector = SimpleNamespace(rollout_ready=lambda: True, rollout_scores=boom,
                               config=SimpleNamespace(vocab_size=50, seq_len=4))
    monitor = CapacityMonitor(detector, capacity_settings(), labels=LABELS)
    assert monitor.probe_now() is None
    assert "capacity probe failed" in caplog.text
    assert monitor.status()["last_probe"] is None


def test_the_monitor_attaches_and_detaches_its_tap():
    taps = []
    detector = SimpleNamespace(set_capacity_tap=taps.append)
    monitor = CapacityMonitor(detector, capacity_settings(capacity_interval_s=3600.0),
                              labels=LABELS)
    monitor.start()
    monitor.stop()
    assert taps == [monitor.on_batch, None]


class _Scripted:
    """A tracker whose counters are the test's input."""

    @staticmethod
    def make(cls, clock):
        class Scripted(cls):
            def __init__(self):
                super().__init__(clock=clock)
                self.doc = {"e2e_count": 0.0, "e2e_under": 0.0, "dwell": {},
                            "transit_s": 0.0, "process_s": 0.0, "queue_wait_s": 0.0,
                            "device_s": 0.0}

            def _collect(self):
                return json.loads(json.dumps(self.doc))

        return Scripted()


def test_burn_windows_equal_the_jax_trackers_on_the_same_counts():
    clocks = (FakeClock(), FakeClock())
    trackers = [_Scripted.make(cls, clock) for cls, clock in zip((RefSlo, SloTracker), clocks)]
    script = [(0.0, dict(e2e_count=100.0, e2e_under=100.0, dwell={"parser": 1.0})),
              (250.0, dict(e2e_count=300.0, e2e_under=240.0,
                           dwell={"parser": 2.0, "detector": 6.0}, device_s=1.5)),
              (2000.0, dict(e2e_count=400.0, e2e_under=330.0))]
    for dt, update in script:
        for tracker, clock in zip(trackers, clocks):
            clock.advance(dt)
            tracker.doc.update(update)
        docs = [tracker.snapshot() for tracker in trackers]
        assert docs[1] == docs[0]
    assert docs[1]["burn"]["1h"]["traces"] == 300 and docs[1]["burn"]["5m"]["traces"] == 0


def test_on_a_traced_service_the_burn_windows_fill():
    """With trace stamping the tracker reads the ``pipeline_*`` series: a
    traced port Service in reply mode ends every trace it originates, so its
    e2e count, its burn windows and the dwell attribution of its stage fill,
    beside the detector's own sums; the document has the JAX keys."""
    import tempfile

    from detectmateservice_tpu_torch.core import Service
    from detectmateservice_tpu_torch.engine.socket import ZmqPairSocketFactory
    from detectmateservice_tpu_torch.settings import ServiceSettings

    for name in ("pipeline_e2e_latency_seconds", "pipeline_stage_dwell_seconds",
                 "pipeline_transit_seconds"):
        assert name in port_metrics.REGISTERED_SERIES
    port_metrics.BATCH_DEVICE_SECONDS().labels(**dict(LABELS, path="device")).observe(0.25)
    short = tempfile.mkdtemp(prefix="dmslo", dir="/tmp")
    settings = ServiceSettings(component_id="slo-traced", engine_addr=f"ipc://{short}/in.ipc",
                               engine_trace=True, http_port=0, log_to_file=False,
                               log_to_console=False, watchdog_enabled=False)
    with Service(settings) as svc:
        first = svc.slo.snapshot()
        svc.start()
        sender = ZmqPairSocketFactory().create_output(f"ipc://{short}/in.ipc")
        sender.recv_timeout = 5000
        try:
            for i in range(20):
                sender.send(b"line %d" % i)
                assert sender.recv() == b"line %d" % i
            deadline = time.monotonic() + 5.0
            while (svc.engine.trace_recorder.completed < 20
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            sender.close()
        snap = svc.slo.snapshot()
    assert svc.engine.trace_recorder.completed == 20
    assert snap["e2e"]["traces_total"] - first["e2e"]["traces_total"] == 20
    windows = snap["burn"].values()
    assert all(w["traces"] >= 20 and w["error_ratio"] is not None
               and w["burn_rate"] is not None for w in windows)
    assert snap["stages"]["dwell_seconds"]["core"] > 0
    assert "core" in snap["stages"]["dwell_share"]
    assert snap["stages"]["detector"]["device_seconds"] >= 0.25
    assert set(snap) == set(RefSlo().snapshot())