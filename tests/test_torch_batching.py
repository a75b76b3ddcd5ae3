"""Adaptive batching in the port (``library/detectors/torch_scorer.py``),
held against the JAX package's (``tests/test_batching.py``'s cases):

* the coalescer's mechanics: the same add/take script under the same
  injected clock through ``jax_scorer._BatchCoalescer`` and the port's gives
  equal takes (tokens, raws, oldest stamp) and releases, tenants included;
* coalesced dispatch: the JAX and the port detector, from the same bridged
  weights and one pinned threshold, on one stream: the same release
  sequence (reason, rows, bucket), the same alerts (scores to rtol 1e-4;
  a decision may differ only within 1e-3 of the threshold);
* runtime disable, flush on teardown, order under ``pipeline_depth``
  back-pressure, a queue wait that includes the hold;
* retirement, pad-up and resurrection through one expected capture;
* the engine honours ``drain_poll_ms`` (also through the port's Service)
  and ``flush_final`` drains held rows; a burst ends when held rows fall
  due, and over its zmq transport the alerts keep the JAX engine's order;
* upload workers: outputs identical to inline dispatch; a failed dispatch
  is counted for its rows, emits nothing, and the loop lives on;
* ``examples/scorer_config.yaml`` and ``examples/scorer_settings.yaml``
  build a port detector and start a port Service on the CPU.
"""
import time
import uuid
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from detectmateservice_tpu.engine import device_obs as ref_device_obs
from detectmateservice_tpu.library.detectors import JaxScorerDetector
from detectmateservice_tpu.library.detectors.jax_scorer import _BatchCoalescer as RefCoalescer
from detectmateservice_tpu.library.detectors.jax_scorer import _ChainRaws as RefChainRaws
from detectmateservice_tpu.schemas import DetectorSchema as RefDetectorSchema
from detectmateservice_tpu.schemas import ParserSchema as RefParserSchema
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine import device_obs
from detectmateservice_tpu_torch.engine.engine import Engine
from detectmateservice_tpu_torch.engine.socket import (
    InprocQueueSocketFactory, TransportTimeout, ZmqPairSocketFactory)
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.library.detectors.torch_scorer import (
    _BatchCoalescer,
    _ChainRaws,
)
from detectmateservice_tpu_torch.models.convert import params_from_flax
from detectmateservice_tpu_torch.schemas import DetectorSchema
from detectmateservice_tpu_torch.settings import ServiceSettings

from conftest import wait_until

REPO = Path(__file__).resolve().parents[1]
TORCH_SCORER = "detectmateservice_tpu_torch.library.detectors.torch_scorer.TorchScorerDetector"
BASE = {
    "auto_config": False, "model": "mlp", "data_use_training": 0, "seq_len": 16,
    "dim": 32, "vocab_size": 4096, "max_batch": 64, "pipeline_depth": 2,
    "dtype": "float32", "async_fit": False, "host_score_max_batch": 0,
    "batch_deadline_ms": 60000.0, "batch_target_occupancy": 0.9,
}


def msg(i: int) -> bytes:
    return RefParserSchema(
        EventID=1, template="user <*> logged in from <*>",
        variables=[f"u{i % 8}", f"10.0.{i % 7}.{i % 16}"], logID=str(i),
        logFormatVariables={"Time": str(1_700_000_000 + i)}).serialize()


def _unpack(frame):
    from detectmateservice_tpu_torch.engine.framing import unpack_batch

    return unpack_batch(frame)


def alert_ids(outs, schema=DetectorSchema) -> list:
    return [int(schema.from_bytes(o)["logIDs"][0]) for o in outs if o is not None]


def port_detector(**overrides) -> TorchScorerDetector:
    """A small port detector with coalescing on; by default an always-alert
    threshold, so the output order is visible per message."""
    cfg = dict(BASE, method_type="torch_scorer", device="cpu", score_threshold=-1e9,
               batch_deadline_ms=60.0)
    cfg.update(overrides)
    det = TorchScorerDetector(config=cfg)
    det.setup_io()
    return det


def new_spans(ledger, seq0: int) -> list:
    return [s for s in ledger.snapshot()["batches"] if s["seq"] > seq0]


def last_seq(ledger) -> int:
    spans = ledger.snapshot()["batches"]
    return spans[-1]["seq"] if spans else 0


# -- the coalescer's mechanics, both packages, one script -----------------------
def _rows(ids):
    return np.asarray(ids, np.int32).reshape(-1, 1), [str(i).encode() for i in ids]


def _both(deadline_s=1.0, target=0.9):
    return RefCoalescer(deadline_s, target), _BatchCoalescer(deadline_s, target)


def _same_take(ref, port, n):
    (rt, rr, ro), (pt, pr, po) = ref.take(n), port.take(n)
    np.testing.assert_array_equal(pt, rt)
    assert [pr[i] for i in range(len(pr))] == [rr[i] for i in range(len(rr))]
    assert po == ro
    return pt, pr, po


class TestChainRaws:
    SEGS = [[b"a", b"b"], [b"c"], [b"d", b"e"]]

    def test_indexes_across_segments_as_the_jax_chain(self):
        ref, port = RefChainRaws(self.SEGS), _ChainRaws(self.SEGS)
        assert len(port) == len(ref) == 5
        assert [port[i] for i in range(5)] == [ref[i] for i in range(5)]
        assert port[-1] == ref[-1] == b"e"
        with pytest.raises(IndexError):
            port[5]

    @pytest.mark.parametrize("sl", [slice(1, 4), slice(0, 0), slice(2, 5), slice(0, 5, 2)])
    def test_slices_match_the_jax_chain(self, sl):
        ref, port = RefChainRaws(self.SEGS)[sl], _ChainRaws(self.SEGS)[sl]
        assert [port[i] for i in range(len(port))] == [ref[i] for i in range(len(ref))]
        if sl.step is None:
            assert isinstance(port, _ChainRaws)


class TestCoalescerMechanics:
    def test_take_preserves_fifo_across_segments(self):
        ref, port = _both()
        for co in (ref, port):
            co.add(*_rows([1, 2, 3]), now=10.0)
            co.add(*_rows([4, 5]), now=11.0)
        tokens, _, t_oldest = _same_take(ref, port, 4)
        assert tokens[:, 0].tolist() == [1, 2, 3, 4] and t_oldest == 10.0
        assert len(port) == len(ref) == 1

    def test_split_segment_keeps_its_arrival_stamp(self):
        ref, port = _both()
        for co in (ref, port):
            co.add(*_rows([1, 2, 3]), now=10.0)
        _same_take(ref, port, 2)
        assert port.oldest_age(now=10.5) == ref.oldest_age(now=10.5) == pytest.approx(0.5)
        _, raws, t_oldest = _same_take(ref, port, 1)
        assert t_oldest == 10.0 and raws[0] == b"3"

    @pytest.mark.parametrize("now", [0.074, 0.0751, 5.0])
    def test_due_releases_one_tick_early(self, now):
        ref, port = _both(deadline_s=0.100)
        for co in (ref, port):
            co.add(*_rows([1]), now=0.0)
        assert port.due(now) == ref.due(now) == (now >= 0.075)

    def test_empty_coalescer_is_never_due(self):
        ref, port = _both(deadline_s=0.1)
        assert port.due(now=100.0) == ref.due(now=100.0) is False
        assert port.oldest_age(now=100.0) == ref.oldest_age(now=100.0) == 0.0

    def test_release_accounting(self):
        ref, port = _both(deadline_s=0.1)
        for co in (ref, port):
            co.note_release("deadline", 0.08)
            co.note_release("full", 0.01)
        for key in ("releases", "max_wait_s", "wait_sum_s", "wait_n"):
            assert getattr(port, key) == getattr(ref, key), key
        assert port.releases == {"full": 1, "deadline": 1, "flush": 0}

    def test_tenants_are_served_by_deficit_round_robin_as_in_the_jax_coalescer(self):
        """One noisy tenant holding many rows and two quiet ones: every take
        is equal on both sides, and a take of 6 gives each tenant its
        quantum, starting at the tenant with the oldest row."""
        ref, port = _both()
        script = [("noisy", range(0, 40), 1.0), ("quiet", range(100, 104), 2.0),
                  (None, range(200, 203), 3.0), ("noisy", range(40, 50), 4.0)]
        for co in (ref, port):
            for tenant, ids, now in script:
                co.add(*_rows(list(ids)), now=now, tenant=tenant)
        assert port.held_by_tenant() == ref.held_by_tenant() == \
            {"noisy": 50, "quiet": 4, "default": 3}
        tokens, _, t_oldest = _same_take(ref, port, 6)
        assert sorted(tokens[:, 0].tolist()) == [0, 1, 100, 101, 200, 201]
        assert t_oldest == 1.0
        for n in (5, 7, 1, 20):
            _same_take(ref, port, n)
        assert port.held_by_tenant() == ref.held_by_tenant()
        assert len(port) == len(ref)


# -- coalesced dispatch against the JAX detector ---------------------------------
# calls in rows: full releases, ragged remainders, and flushes between
CALLS = [20, 20, 20, 50, 7, 64, 3, "flush", 100, 1, 30, "flush", 9, 40, 40, 5]


@pytest.fixture(scope="module")
def coalesced_pair():
    """The JAX and the port detector with one config, the bridged initial
    weights and one threshold (the JAX scores' 85th percentile), on one
    stream of ``CALLS``: outputs, release spans and the JAX scores."""
    ref_ledger, port_ledger = ref_device_obs.get_ledger(), device_obs.get_ledger()
    jax_det = JaxScorerDetector(name="scorer", config=dict(BASE, method_type="jax_scorer"))
    port_det = TorchScorerDetector(name="scorer", config=dict(
        BASE, method_type="torch_scorer", device="cpu"))
    jax_det._ensure_scorer()
    port_det.load_params(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                 jax_det._params)))
    jax_det.setup_io()
    port_det.setup_io()
    n = sum(c for c in CALLS if c != "flush")
    stream = [msg(i) for i in range(n)]
    tokens, ok = jax_det._featurize_raw_batch(stream)
    assert ok.all()
    scores = jax_det.score_tokens(tokens)
    threshold = float(np.percentile(scores, 85))
    jax_det._threshold = port_det._threshold = threshold
    runs = {}
    for name, det, ledger in (("jax", jax_det, ref_ledger), ("port", port_det, port_ledger)):
        seq0, outs, pos = last_seq(ledger), [], 0
        for call in CALLS:
            if call == "flush":
                outs.extend(det.flush())
                continue
            outs.extend(det.process_batch(stream[pos:pos + call]))
            pos += call
        outs.extend(det.flush_final())
        runs[name] = dict(outs=outs, spans=new_spans(ledger, seq0),
                          stats=det.batching_stats())
    return runs, scores, threshold


class TestCoalescedDispatchAgainstJax:
    def test_the_same_release_sequence(self, coalesced_pair):
        runs, _, _ = coalesced_pair
        seq = {name: [(s["release"], s["real"], s["bucket"]) for s in run["spans"]]
               for name, run in runs.items()}
        assert seq["port"] == seq["jax"]
        assert {r for r, _, _ in seq["port"]} == {"full", "flush"}
        assert runs["port"]["stats"]["releases"] == runs["jax"]["stats"]["releases"]

    def test_the_same_alerts_with_scores_to_rtol_1e4(self, coalesced_pair):
        runs, scores, threshold = coalesced_pair
        port = {a["logIDs"][0]: a for a in map(DetectorSchema.from_bytes, runs["port"]["outs"])}
        ref = {a["logIDs"][0]: a for a in map(RefDetectorSchema.from_bytes, runs["jax"]["outs"])}
        assert ref and len(ref) < len(scores)
        for log_id in set(port) ^ set(ref):
            assert abs(scores[int(log_id)] - threshold) < 1e-3, log_id
        common = sorted(set(port) & set(ref), key=int)
        assert len(common) >= len(ref) - 1
        np.testing.assert_allclose([port[i]["score"] for i in common],
                                   [ref[i]["score"] for i in common], rtol=1e-4)
        # the order of the alerts is the order of the stream on both sides
        assert alert_ids(runs["port"]["outs"]) == sorted(alert_ids(runs["port"]["outs"]))


class TestCoalescedDispatch:
    def test_rows_held_across_calls_then_deadline_release_in_order(self):
        det = port_detector()
        ledger = device_obs.get_ledger()
        unexpected0 = ledger.snapshot()["totals"]["unexpected"]
        held = det.process_batch([msg(100), msg(101)]) + det.process_batch([msg(102)])
        assert held == [] and len(det._inflight) == 0
        assert det.pending_count() == 1
        deadline_s = det.config.batch_deadline_ms / 1000.0
        tick_s = det.drain_poll_ms / 1000.0
        outs, t0 = [], time.monotonic()
        while len(det._coalescer) and time.monotonic() - t0 < 5 * deadline_s:
            outs.extend(det.drain_ready())
            time.sleep(tick_s)
        outs.extend(det.flush())
        stats = det.batching_stats()
        assert stats["releases"]["deadline"] == 1
        assert stats["max_wait_s"] <= deadline_s + tick_s + 0.25
        assert alert_ids(outs) == [100, 101, 102]
        assert ledger.snapshot()["totals"]["unexpected"] == unexpected0

    def test_target_occupancy_triggers_full_release(self):
        det = port_detector(max_batch=32)
        out = det.process_batch([msg(200 + i) for i in range(70)])
        stats = det.batching_stats()
        assert stats["releases"]["full"] == 2 and stats["held_rows"] == 6
        out += det.flush()
        assert alert_ids(out) == list(range(200, 270))
        assert det.batching_stats()["occupancy_mean"] >= 0.9

    def test_flush_releases_everything_on_teardown(self):
        det = port_detector()
        assert det.process_batch([msg(300), msg(301)]) == []
        assert len(det._coalescer) == 2
        outs = det.flush_final()
        assert len(det._coalescer) == 0 and len(det._inflight) == 0
        assert det.batching_stats()["releases"]["flush"] >= 1
        assert alert_ids(outs) == [300, 301]

    def test_order_preserved_under_pipeline_depth_backpressure(self):
        det = port_detector(pipeline_depth=1, batch_deadline_ms=30.0)
        outs = []
        for start in range(0, 320, 20):
            outs.extend(det.process_batch([msg(1000 + start + j) for j in range(20)]))
        outs.extend(det.flush())
        assert alert_ids(outs) == list(range(1000, 1320))

    def test_queue_wait_includes_coalescer_hold(self):
        det = port_detector()
        det.process_batch([msg(1)])
        time.sleep(0.02)
        det.flush()
        span = device_obs.get_ledger().snapshot()["batches"][-1]
        assert span["release"] == "flush" and span["real"] == 1
        assert span["queue_wait_s"] >= 0.02 - 1e-3

    def test_default_config_keeps_legacy_dispatch(self):
        det = port_detector(batch_deadline_ms=0.0)
        assert det._get_coalescer() is None and det.drain_poll_ms is None
        outs = det.process_batch([msg(1), msg(2)])
        # dispatched at once: landed (and drained) or in flight, never held
        assert det._coalescer is None
        assert alert_ids(outs + det.flush()) == [1, 2]

    def test_runtime_disable_flushes_held_rows(self):
        det = port_detector()
        assert det.process_batch([msg(7)]) == []
        det.config.batch_deadline_ms = 0.0
        det.apply_config()
        outs = det.drain_ready() + det.flush()
        assert alert_ids(outs) == [7]
        assert det.batching_stats()["releases"]["flush"] >= 1

    def test_apply_config_rereads_deadline_and_target_live(self):
        det = port_detector()
        det.process_batch([msg(1)])
        det.config.batch_deadline_ms = 20.0
        det.config.batch_target_occupancy = 0.5
        det.apply_config()
        assert det._coalescer.deadline_s == 0.02 and det._coalescer.target_occupancy == 0.5
        assert det.drain_poll_ms == 5
        det.flush()


# -- bucket retirement and resurrection ------------------------------------------
class TestBucketRetirement:
    def _retiring(self):
        return port_detector(max_batch=32, bucket_retire_interval_s=60.0,
                             bucket_retire_min_dispatches=2)

    def test_underused_buckets_retire_and_the_largest_stays(self):
        det = self._retiring()
        det.process_batch([msg(i) for i in range(3)])
        det.flush()
        for _ in range(3):
            det.process_batch([msg(i) for i in range(32)])
            det.flush()
        det._retire_sweep(time.monotonic())
        det._drop_retired_graphs()
        stats = det.batching_stats()
        assert 4 in stats["retired_buckets"] and 32 in stats["warm_buckets"]
        assert not det._warm.has("score", 4)          # its graph went with it
        buckets = device_obs.get_ledger().snapshot()["buckets"]
        assert buckets["retired"] == stats["retired_buckets"]
        assert buckets["coalescing"] is True

    def test_retired_bucket_pads_up_without_a_capture(self):
        det = self._retiring()
        ledger = device_obs.get_ledger()
        det.process_batch([msg(i) for i in range(3)])
        det.flush()
        det._retire_sweep(time.monotonic())
        compiles0 = ledger.snapshot()["totals"]["compiles"]
        det.process_batch([msg(i) for i in range(3)])
        det.flush()
        span = ledger.snapshot()["batches"][-1]
        assert span["real"] == 3 and span["bucket"] > 4
        assert ledger.snapshot()["totals"]["compiles"] == compiles0

    def test_persistent_pressure_resurrects_with_one_expected_capture(self):
        det = self._retiring()
        ledger = device_obs.get_ledger()
        unexpected0 = ledger.snapshot()["totals"]["unexpected"]
        det.process_batch([msg(i) for i in range(3)])
        det.flush()
        det._retire_sweep(time.monotonic())
        det._drop_retired_graphs()
        assert 4 in det._retired_buckets and not det._warm.has("score", 4)
        seq0 = ledger.snapshot()["compiles"][-1]["seq"]
        buckets = []
        for _ in range(4):
            det.process_batch([msg(i) for i in range(3)])
            det.flush()
            buckets.append(ledger.snapshot()["batches"][-1]["bucket"])
        assert buckets == [32, 32, 4, 4]   # two pad-ups, then the bucket is back
        stats = det.batching_stats()
        assert 4 in stats["warm_buckets"] and 4 not in stats["retired_buckets"]
        snap = ledger.snapshot()
        captures = [e for e in snap["compiles"] if e["seq"] > seq0]
        assert [(e["bucket"], e["where"], e["unexpected"]) for e in captures] == \
            [("4", "bucket_warm", False)]
        assert snap["totals"]["unexpected"] == unexpected0


# -- the engine and the coalescer's contract -------------------------------------
class HoldingProcessor:
    """The coalescer's engine-visible contract: process_batch holds rows;
    drain_ready releases them (upper-cased) after some short-poll ticks;
    flush and flush_final release everything."""

    drain_poll_ms = 17

    def __init__(self, ticks_to_release: int = 2):
        self.held = []
        self.ticks = 0
        self.ticks_to_release = ticks_to_release
        self.flush_final_called = False

    def process(self, data):
        return data.upper()

    def process_batch(self, batch):
        self.held.extend(batch)
        return []

    def pending_count(self):
        return len(self.held)

    def drain_ready(self):
        self.ticks += 1
        if self.ticks < self.ticks_to_release:
            return []
        out, self.held = [d.upper() for d in self.held], []
        return out

    def flush(self):
        out, self.held = [d.upper() for d in self.held], []
        return out

    def flush_final(self):
        self.flush_final_called = True
        return self.flush()


def _engine_settings(addr: str, **overrides) -> ServiceSettings:
    base = dict(component_type="core", engine_addr=addr, out_addr=[], engine_batch_size=8,
                engine_recv_timeout=500, log_to_file=False, log_to_console=False)
    base.update(overrides)
    return ServiceSettings(**base)


class TestEngineDeferredOutputs:
    def test_short_poll_honours_drain_poll_ms(self):
        factory = InprocQueueSocketFactory()
        proc = HoldingProcessor(ticks_to_release=4)
        engine = Engine(_engine_settings("inproc://tb-coal1"), proc, factory)
        client = factory.create_output("inproc://tb-coal1")
        client.recv_timeout = 2000
        try:
            engine.start()
            client.send(b"held-row")
            assert wait_until(lambda: engine._pair_sock.recv_timeout == proc.drain_poll_ms, 2.0)
            assert client.recv() == b"HELD-ROW"
        finally:
            engine.stop()
            client.close()

    def test_short_poll_ends_when_the_held_rows_fall_due(self):
        """A deliberate difference from the JAX engine (ROADMAP.md's
        register): with ``drain_due_in_ms`` the short poll ends when the
        held rows fall due (rounded up, at least 1 ms), not up to a whole
        tick later; the tick still bounds it."""
        factory = InprocQueueSocketFactory()
        proc = HoldingProcessor(ticks_to_release=10**9)
        proc.due = 4.2
        proc.drain_due_in_ms = lambda: proc.due if proc.held else None
        engine = Engine(_engine_settings("inproc://tb-due"), proc, factory)
        client = factory.create_output("inproc://tb-due")
        try:
            engine.start()
            client.send(b"held-row")
            assert wait_until(lambda: engine._pair_sock.recv_timeout == 5, 2.0)
            proc.due = 0.0
            assert wait_until(lambda: engine._pair_sock.recv_timeout == 1, 2.0)
            proc.due = 60.0    # beyond the tick: the tick
            assert wait_until(lambda: engine._pair_sock.recv_timeout == 17, 2.0)
            ticks = proc.ticks
            assert wait_until(lambda: proc.ticks > ticks, 2.0)   # a tick drains
        finally:
            engine.stop()
            client.close()

    def test_the_detector_says_when_its_held_rows_fall_due(self):
        """The coalescing detector's ``drain_due_in_ms``: None while nothing
        is held, then 0.75 of the deadline less the oldest row's age."""
        det = TorchScorerDetector(config=dict(BASE, method_type="torch_scorer", device="cpu",
                                              batch_deadline_ms=40.0))
        assert det.drain_due_in_ms() is None
        co = det._get_coalescer()
        co.add(np.zeros((1, BASE["seq_len"]), np.int32), [b"x"], time.monotonic() - 0.010)
        due = det.drain_due_in_ms()
        assert 15.0 < due <= 20.0
        co.take(1)
        assert det.drain_due_in_ms() is None
        co.add(np.zeros((1, BASE["seq_len"]), np.int32), [b"y"], time.monotonic() - 1.0)
        assert det.drain_due_in_ms() == 0.0

    def test_stop_flush_final_drains_held_rows(self):
        factory = InprocQueueSocketFactory()
        proc = HoldingProcessor(ticks_to_release=10**9)
        engine = Engine(_engine_settings("inproc://tb-coal2"), proc, factory)
        client = factory.create_output("inproc://tb-coal2")
        client.recv_timeout = 2000
        try:
            engine.start()
            client.send(b"stuck-row")
            assert wait_until(lambda: proc.held, 2.0)
            engine.stop()
            assert proc.flush_final_called and proc.held == []
            assert client.recv() == b"STUCK-ROW"
        finally:
            client.close()

    @pytest.mark.parametrize("frame_batch", [1, 16])
    def test_alerts_leave_in_the_jax_engines_order(self, frame_batch):
        """The coalescing detector (every message alerts) hosted by the
        port's engine and by the JAX engine on the same frames: the same
        alerts in the same order, the stream's."""
        import prometheus_client

        from detectmateservice_tpu.engine import Engine as RefEngine
        from detectmateservice_tpu.engine.socket import InprocQueueSocketFactory as RefInproc
        from detectmateservice_tpu.settings import ServiceSettings as RefSettings
        from detectmateservice_tpu_torch.engine import metrics as port_metrics
        from detectmateservice_tpu_torch.engine.framing import pack_batch
        from test_torch_engine import _drive

        frames = []
        for start in range(0, 400, 40):
            chunk = [msg(5000 + start + j) for j in range(40)]
            frames += [pack_batch(chunk[:24])] + chunk[24:]
        kw = dict(engine_batch_size=64, engine_frame_batch=frame_batch)
        outs = {}
        for name, engine_cls, settings_cls, factory, registry in (
                ("jax", RefEngine, RefSettings, RefInproc(), prometheus_client.REGISTRY),
                ("port", Engine, ServiceSettings, InprocQueueSocketFactory(),
                 port_metrics.REGISTRY)):
            det = port_detector(batch_deadline_ms=20.0)
            got, _ = _drive(engine_cls, settings_cls, factory, registry, det, frames, **kw)
            outs[name] = alert_ids([m for f in got for m in (_unpack(f) or [f])])
        assert outs["port"] == outs["jax"] == list(range(5000, 5400))

    def test_a_burst_ends_when_rows_held_from_before_it_fall_due(self):
        """A deliberate difference from the JAX engine (ROADMAP.md's
        register): a burst lasts ``engine_batch_timeout_ms`` unless rows
        held from before it fall due sooner; then it ends at their due
        time, so the pump that releases them is not a burst late."""
        now = time.monotonic()
        assert Engine._burst_deadline(0.5, None) >= now + 0.5
        assert Engine._burst_deadline(0.5, now + 0.010) == now + 0.010
        assert Engine._burst_deadline(0.001, now + 60.0) < now + 1.0

        factory = ZmqPairSocketFactory()
        addr = f"inproc://tb-burst-{uuid.uuid4().hex[:8]}"
        proc = HoldingProcessor(ticks_to_release=10**9)
        proc.drain_due_in_ms = lambda: 0.0 if proc.held else None
        batches = []
        hold = proc.process_batch

        def process_batch(batch):
            batches.append((time.monotonic(), list(batch)))
            return hold(batch)

        proc.process_batch = process_batch
        engine = Engine(_engine_settings(addr, engine_batch_timeout_ms=3000.0), proc, factory)
        client = factory.create_output(addr)
        try:
            engine.start()
            client.send(b"first")
            assert wait_until(lambda: proc.held, 10.0)   # its burst waited out
            t_sent = time.monotonic()
            client.send(b"second")
            assert wait_until(lambda: len(batches) == 2, 2.0)
            assert batches[1][1] == [b"second"] and batches[1][0] - t_sent < 1.0
        finally:
            engine.stop()
            client.close()

    @pytest.mark.parametrize("frame_batch", [1, 16])
    def test_alerts_leave_in_the_jax_engines_order_over_zmq(self, frame_batch):
        """As the test above, with the port's engine on its zmq transport,
        where bursts end when held rows fall due: the same alerts in the
        same order as the JAX engine's."""
        import prometheus_client

        from detectmateservice_tpu.engine import Engine as RefEngine
        from detectmateservice_tpu.engine.socket import InprocQueueSocketFactory as RefInproc
        from detectmateservice_tpu.settings import ServiceSettings as RefSettings
        from detectmateservice_tpu_torch.engine.framing import pack_batch
        from test_torch_engine import _drive

        frames = []
        for start in range(0, 400, 40):
            chunk = [msg(5000 + start + j) for j in range(40)]
            frames += [pack_batch(chunk[:24])] + chunk[24:]
        kw = dict(engine_batch_size=64, engine_frame_batch=frame_batch)
        got, _ = _drive(RefEngine, RefSettings, RefInproc(), prometheus_client.REGISTRY,
                        port_detector(batch_deadline_ms=20.0), frames, **kw)
        want = alert_ids([m for f in got for m in (_unpack(f) or [f])])

        factory = ZmqPairSocketFactory()
        name = f"tb-{uuid.uuid4().hex[:8]}"
        sink = factory.create(f"inproc://{name}-out")
        sender = factory.create_output(f"inproc://{name}-in", buffer_size=4096)
        det = port_detector(batch_deadline_ms=20.0)
        # bursts longer than the hold, so held rows fall due inside them
        engine = Engine(_engine_settings(f"inproc://{name}-in", out_addr=[f"inproc://{name}-out"],
                                         engine_batch_timeout_ms=50.0, **kw), det, factory)
        cut = []
        burst_deadline = engine._burst_deadline

        def deadline(timeout_s, held_until):
            end = burst_deadline(timeout_s, held_until)
            cut.append(held_until is not None and end == held_until)
            return end

        engine._burst_deadline = deadline
        outs = []
        sink.recv_timeout = 100
        try:
            engine.start()
            time.sleep(0.2)  # the dial completes before frames are sent
            for frame in frames:
                sender.send(frame)
            deadline = time.monotonic() + 20.0
            while sum(len(_unpack(f) or [f]) for f in outs) < 400 and \
                    time.monotonic() < deadline:
                try:
                    outs.append(sink.recv())
                except TransportTimeout:
                    pass
        finally:
            engine.stop()
            sender.close()
            sink.close()
        assert any(cut), "no burst ended at a due time"
        assert alert_ids([m for f in outs for m in (_unpack(f) or [f])]) == want \
            == list(range(5000, 5400))

    def test_the_service_hands_the_detector_hint_to_the_engine(self):
        """Through the port's Service: the hosted coalescing detector's
        ``drain_poll_ms`` becomes the engine's short poll while rows are
        held, and ``note_tenant`` reaches the detector."""
        factory = InprocQueueSocketFactory()
        config = dict(BASE, method_type="torch_scorer", device="cpu", score_threshold=-1e9,
                      batch_deadline_ms=200.0)
        svc = Service(_engine_settings("inproc://tb-svc", component_type=TORCH_SCORER,
                                       out_addr=["inproc://tb-svc-out"], http_port=0,
                                       watchdog_enabled=False),
                      component_config={"detectors": {"TorchScorerDetector": config}},
                      socket_factory=factory)
        det = svc.library_component
        assert svc.processor.drain_poll_ms == det.drain_poll_ms == 50
        assert svc.processor.note_tenant == det.note_tenant
        assert svc.processor.drain_due_in_ms == det.drain_due_in_ms
        sink = factory.create("inproc://tb-svc-out")
        client = factory.create_output("inproc://tb-svc")
        sink.recv_timeout = 5000
        try:
            svc.setup_io()
            svc.start()
            client.send(msg(5))
            assert wait_until(lambda: svc.engine._pair_sock.recv_timeout == 50, 3.0)
            assert alert_ids([sink.recv()]) == [5]
        finally:
            svc.stop()
            client.close()
            sink.close()
            svc._teardown(save=False)


# -- upload workers ---------------------------------------------------------------
def _timeless(alert: bytes) -> bytes:
    """An alert with its wall-clock stamps (whole seconds of the host
    clock at detection) zeroed; every other byte as built."""
    doc = DetectorSchema.from_bytes(alert)
    doc["detectionTimestamp"] = doc["receivedTimestamp"] = 0
    return doc.serialize()


class TestUploadWorkers:
    def _stream(self, det):
        outs = []
        for start in range(0, 300, 30):
            outs.extend(det.process_batch([msg(2000 + start + j) for j in range(30)]))
        return outs + det.flush_final()

    def test_outputs_identical_to_inline_dispatch(self):
        inline = port_detector(max_batch=32, score_threshold=None, data_use_training=0)
        workers = port_detector(max_batch=32, score_threshold=None, data_use_training=0,
                                upload_workers=2)
        workers.load_params(inline._model.state_dict())
        tokens, _ = inline._featurize_raw_batch([msg(2000 + i) for i in range(300)])
        threshold = float(np.percentile(inline.score_tokens(tokens), 80))
        inline._threshold = workers._threshold = threshold
        want, got = self._stream(inline), self._stream(workers)
        assert len(want) > 10
        assert [_timeless(a) for a in got] == [_timeless(a) for a in want]
        assert workers._upload_threads == []          # stopped after the drain
        assert workers.batching_stats()["releases"] == inline.batching_stats()["releases"]

    def test_a_failed_dispatch_is_counted_and_the_loop_lives_on(self, monkeypatch):
        det = port_detector(max_batch=32, upload_workers=1)
        counted = []
        monkeypatch.setattr(det, "count_processing_errors",
                            lambda n, what: counted.append((n, what)))
        real = det._score_dev
        calls = []

        def flaky(chunk):
            calls.append(len(chunk))
            if len(calls) == 1:
                raise RuntimeError("injected dispatch failure")
            return real(chunk)

        monkeypatch.setattr(det, "_score_dev", flaky)
        first = det.process_batch([msg(i) for i in range(32)])
        second = det.process_batch([msg(100 + i) for i in range(32)])
        outs = first + second + det.flush_final()
        assert counted and counted[0][0] == 32 and "injected" in counted[0][1]
        assert alert_ids(outs) == list(range(100, 132))   # the failed batch emits nothing

    def test_workers_beat_the_dispatch_heartbeat(self):
        from detectmateservice_tpu_torch.engine.health import HealthMonitor

        det = port_detector(max_batch=32, upload_workers=1)
        det.health_monitor = HealthMonitor({"component_type": "t", "component_id": "hb"})
        det.process_batch([msg(i) for i in range(32)])
        det.flush_final()
        assert det._dispatch_hb is not None and det._dispatch_hb.name == "scorer_dispatch"
        assert det._dispatch_hb.age() < 5.0


# -- the repo's example stage on the port ---------------------------------------
def _example_on_the_port(tmp_path):
    """The example's settings and config with the port's component type
    (the settings' ``component_type``, the config block's name and
    ``method_type``) and ``device: cpu``; addresses under ``tmp_path``."""
    settings = yaml.safe_load((REPO / "examples" / "scorer_settings.yaml").read_text())
    config = yaml.safe_load((REPO / "examples" / "scorer_config.yaml").read_text())
    block = dict(config["detectors"]["JaxScorerDetector"], method_type="torch_scorer",
                 device="cpu")
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(
        {"detectors": {"TorchScorerDetector": block}}))
    settings.update(component_type=TORCH_SCORER, config_file=str(tmp_path / "config.yaml"),
                    engine_addr="inproc://tb-example", out_addr=["inproc://tb-example-out"],
                    http_port=0, log_dir=str(tmp_path / "logs"), log_to_console=False)
    return settings, block


def test_the_example_config_builds_a_port_detector(tmp_path):
    _, block = _example_on_the_port(tmp_path)
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": block}})
    cfg = det.config
    assert (cfg.batch_deadline_ms, cfg.batch_target_occupancy, cfg.bucket_retire_interval_s,
            cfg.bucket_retire_min_dispatches) == (8.0, 0.9, 300.0, 2)
    assert det.drain_poll_ms == 2


def test_the_example_settings_start_a_port_service(tmp_path):
    settings, _ = _example_on_the_port(tmp_path)
    svc = Service(ServiceSettings.model_validate(settings),
                  socket_factory=InprocQueueSocketFactory())
    try:
        svc.setup_io()
        det = svc.library_component
        assert det.batching_stats()["enabled"] is True
        assert det.warm_set_spec()["buckets"] == [32, 1024]
        assert device_obs.get_ledger().warmup_complete
    finally:
        svc._teardown(save=False)
