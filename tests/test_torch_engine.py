"""The port's engine (``detectmateservice_tpu_torch/engine``) against the JAX
package's: the same processors over the same wire frames through each
package's Engine and in-process queue transport must give byte-identical
output frames in the same order, and equal read, written, dropped and
processing-error counts; the port's zmq sockets must speak the JAX
package's wire in both directions; unported transports raise."""
import shutil
import tempfile
import time
import uuid

import prometheus_client
import pytest

from detectmateservice_tpu.engine import Engine as RefEngine
from detectmateservice_tpu.engine import framing as ref_framing
from detectmateservice_tpu.engine.socket import InprocQueueSocketFactory as RefInproc
from detectmateservice_tpu.engine.socket import TransportTimeout as RefTransportTimeout
from detectmateservice_tpu.engine.socket import ZmqPairSocketFactory as RefZmq
from detectmateservice_tpu.settings import ServiceSettings as RefSettings
from detectmateservice_tpu_torch.engine import framing
from detectmateservice_tpu_torch.engine import metrics as port_metrics
from detectmateservice_tpu_torch.engine.engine import Engine, EngineException
from detectmateservice_tpu_torch.engine.socket import (
    InprocQueueSocketFactory,
    TransportError,
    TransportTimeout,
    ZmqPairSocketFactory,
    make_socket_factory,
)
from detectmateservice_tpu_torch.settings import ServiceSettings

from conftest import wait_until

SERIES = ("data_read_bytes_total", "data_read_lines_total", "data_written_bytes_total",
          "data_written_lines_total", "data_dropped_bytes_total", "data_dropped_lines_total",
          "processing_errors_total")


# -- processors: plain Python, one class for both engines ----------------------

class Echo:
    def process(self, data):
        return data

    def process_batch(self, batch):
        return list(batch)


class Filter(Echo):
    """Filters every message that contains b"drop"."""

    def process(self, data):
        return None if b"drop" in data else data

    def process_batch(self, batch):
        return [self.process(d) for d in batch]


class Raising(Echo):
    """Raises on messages that contain b"poison"; a batch that holds one
    raises as a whole, so the engine isolates its messages."""

    def process(self, data):
        if b"poison" in data:
            raise ValueError("poison message")
        return data

    def process_batch(self, batch):
        return [self.process(d) for d in batch]


class Doubling(Echo):
    """Two outputs per message in a batch, the message twice in one."""

    def process(self, data):
        return data + data

    def process_batch(self, batch):
        return [d for d in batch for _ in (0, 1)]


class Pipelined(Echo):
    """Holds each batch's results one call (a device pipeline of depth 1);
    ``drain_ready`` and ``flush`` release what it holds."""

    def __init__(self):
        self.held = []

    def process_batch(self, batch):
        ready = [o for held in self.held for o in held]
        self.held = [list(batch)]
        return ready

    def pending_count(self):
        return len(self.held)

    def drain_ready(self):
        return self.flush()

    def flush(self):
        out = [o for held in self.held for o in held]
        self.held = []
        return out


class Frames(Echo):
    """The fused-frame contract: whole v1 wire units in, every message out
    reversed, the lines by the engine's newline rule."""

    def process_frames(self, frames):
        outs, n_lines = [], 0
        for frame in frames:
            try:
                msgs = ref_framing.unpack_batch(frame)
            except ref_framing.FramingError:
                continue
            msgs = [frame] if msgs is None else [m for m in msgs if m]
            outs.extend(m[::-1] for m in msgs)
            n_lines += sum(max(1, m.count(b"\n") + (0 if m.endswith(b"\n") else 1))
                           for m in msgs)
        return outs, len(outs), n_lines


# (processor, engine_batch_size): single-message, micro-batch and fused-frame
PROCESSORS = {
    "echo_single": (Echo, 1),
    "filter_single": (Filter, 1),
    "raising_single": (Raising, 1),
    "echo_batch": (Echo, 4),
    "filter_batch": (Filter, 4),
    "raising_batch": (Raising, 4),
    "doubling_batch": (Doubling, 4),
    "pipelined_batch": (Pipelined, 4),
    "frames": (Frames, 6),
}


def _msg(i, tag=b""):
    return b"m%03d" % i + tag + (b"\nline" if i % 3 == 0 else b"")


def _stream():
    """Plain, packed, oversized-packed, v2-traced and tenant-wrapped frames,
    with damaged trace and tenant blocks, a corrupt batch frame, packed
    empties, filtered and poison messages."""
    ctx = ref_framing.TraceContext.new(1_700_000_000_000_000_000)
    ctx.hops.append(ref_framing.Hop("parser", 1, 2))
    packed = framing.pack_batch([_msg(10), _msg(11, b"drop"), _msg(12)])
    damaged_trace = ref_framing.MAGIC_V2 + b"\x03abc" + _msg(40)
    return [
        _msg(0), _msg(1, b"drop"), _msg(2),
        packed,
        framing.pack_batch([_msg(20 + i) for i in range(11)]),          # oversized
        framing.pack_batch([_msg(31), b"", _msg(32, b"poison"), _msg(33)]),
        ref_framing.wrap_trace(_msg(34), ctx),
        ref_framing.wrap_trace(framing.pack_batch([_msg(35), _msg(36)]), ctx),
        damaged_trace,
        ref_framing.MAGIC_V2 + b"\x7f" + b"short",                        # runs past end
        ref_framing.wrap_tenant(_msg(50), "tenant-a"),
        ref_framing.wrap_tenant(framing.pack_batch([_msg(51), _msg(52, b"drop")]), "tenant-b"),
        ref_framing.wrap_tenant(ref_framing.wrap_trace(_msg(53), ctx), "tenant-c"),
        ref_framing.MAGIC_TEN + b"\x02\xff\xfe" + _msg(54),                # damaged id
        ref_framing.MAGIC_TEN + b"\x09ab",                                # runs past end
        framing.MAGIC + b"\x05\x01a",                                     # corrupt batch
        framing.pack_batch([]),
        _msg(60, b"poison"), _msg(61),
    ]


def _settings(cls, name, **kw):
    return cls(component_type="core", component_id=name, engine_addr=f"inproc://{name}-in",
               out_addr=[f"inproc://{name}-out"], engine_recv_timeout=20,
               engine_batch_timeout_ms=200.0, log_to_file=False, **kw)


def _counts(registry, name):
    labels = {"component_type": "core", "component_id": name}
    return {s: registry.get_sample_value(s, labels) or 0.0 for s in SERIES}


def _drive(engine_cls, settings_cls, factory, registry, processor, frames, **kw):
    """Preload ``frames`` into a fresh engine's ingress queue, run the
    engine until they are consumed and its processor holds nothing, stop
    it, and return (output frames, counts)."""
    name = f"t{uuid.uuid4().hex[:12]}"
    settings = _settings(settings_cls, name, **kw)
    sink = factory.create(f"inproc://{name}-out")
    sender = factory.create_output(f"inproc://{name}-in")
    for frame in frames:
        sender.send(frame)
    engine = engine_cls(settings, processor, factory)
    ingress = factory._pair(f"inproc://{name}-in").a_to_b
    engine.start()
    try:
        assert wait_until(lambda: ingress.empty(), 10.0)
        assert wait_until(lambda: not getattr(processor, "held", None), 10.0)
        time.sleep(0.3)  # the last burst's collection window
    finally:
        engine.stop()
    outs = []
    sink.recv_timeout = 50
    while True:
        try:
            outs.append(sink.recv())
        except (TransportTimeout, RefTransportTimeout):
            break
    return outs, _counts(registry, name)


@pytest.mark.parametrize("frame_batch", [1, 8])
@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_engine_matches_the_jax_engine(name, frame_batch):
    cls, batch_size = PROCESSORS[name]
    frames = _stream()
    kw = dict(engine_batch_size=batch_size, engine_frame_batch=frame_batch)
    want, want_counts = _drive(RefEngine, RefSettings, RefInproc(), prometheus_client.REGISTRY,
                               cls(), frames, **kw)
    got, got_counts = _drive(Engine, ServiceSettings, InprocQueueSocketFactory(),
                             port_metrics.REGISTRY, cls(), frames, **kw)
    assert got == want
    assert got_counts == want_counts
    assert want_counts["data_read_lines_total"] > 0 and want


def test_tenants_are_stamped_again_on_forwarded_frames():
    got, _ = _drive(Engine, ServiceSettings, InprocQueueSocketFactory(), port_metrics.REGISTRY,
                    Echo(), [ref_framing.wrap_tenant(_msg(1), "acme")])
    assert got == [ref_framing.wrap_tenant(_msg(1), "acme")]
    assert framing.unwrap_tenant(got[0]) == (_msg(1), "acme", False)


def test_shm_reference_frames_are_counted_and_dropped():
    frames = [ref_framing.MAGIC_SHM + b"\x01x\x00\x00\x00\x01", _msg(2)]
    got, counts = _drive(Engine, ServiceSettings, InprocQueueSocketFactory(),
                         port_metrics.REGISTRY, Echo(), frames)
    assert got == [_msg(2)]
    assert counts["processing_errors_total"] == 1


def test_call_in_loop_runs_on_the_loop_thread():
    import threading

    name = f"t{uuid.uuid4().hex[:12]}"
    engine = Engine(_settings(ServiceSettings, name), Echo(), InprocQueueSocketFactory())
    assert engine.call_in_loop(threading.current_thread) is threading.current_thread()
    engine.start()
    try:
        assert engine.call_in_loop(lambda: threading.current_thread().name) == "EngineLoop"
        with pytest.raises(KeyError):
            engine.call_in_loop(lambda: {}["missing"])
    finally:
        engine.stop()
    assert engine.call_in_loop(lambda: 7) == 7


def test_processor_without_process_is_refused():
    with pytest.raises(EngineException):
        Engine(_settings(ServiceSettings, "nope"), object(), InprocQueueSocketFactory())


# -- the zmq wire ---------------------------------------------------------------

@pytest.fixture()
def short_dir():
    """ipc paths must stay under 107 bytes: a short directory under /tmp."""
    path = tempfile.mkdtemp(prefix="dme", dir="/tmp")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zmq_wire_interop_over_ipc(short_dir, direction):
    """A JAX zmq output dials a port engine, whose output reaches a JAX zmq
    listener; and the reverse."""
    if direction == "jax_to_port":
        clients, engine_cls, settings_cls = RefZmq(), Engine, ServiceSettings
    else:
        clients, engine_cls, settings_cls = ZmqPairSocketFactory(), RefEngine, RefSettings
    settings = settings_cls(component_type="core", engine_addr=f"ipc://{short_dir}/in.ipc",
                            out_addr=[f"ipc://{short_dir}/out.ipc"], log_to_file=False,
                            engine_batch_size=4, engine_frame_batch=2)
    sink = clients.create(f"ipc://{short_dir}/out.ipc")
    sink.recv_timeout = 5000
    engine = engine_cls(settings, Echo())
    engine.start()
    try:
        sender = clients.create_output(f"ipc://{short_dir}/in.ipc")
        sender.send(framing.pack_batch([b"a", b"b"]))
        got = ref_framing.unpack_batch(sink.recv())
        assert got == [b"a", b"b"]
        sender.close()
    finally:
        engine.stop()
        sink.close()


def test_zmq_recv_many_takes_a_burst(short_dir):
    factory = ZmqPairSocketFactory()
    listener = factory.create(f"ipc://{short_dir}/b.ipc")
    sender = factory.create_output(f"ipc://{short_dir}/b.ipc")
    try:
        for i in range(5):
            sender.send(b"%d" % i)
        got = []
        while len(got) < 5:
            burst = listener.recv_many(3, 2000)
            assert 1 <= len(burst) <= 3
            got += burst
        assert got == [b"0", b"1", b"2", b"3", b"4"]
        with pytest.raises(TransportTimeout):
            listener.recv_many(1, 10)
    finally:
        sender.close()
        listener.close()


@pytest.mark.parametrize("addr", ["tls+tcp://127.0.0.1:9", "nng+tcp://127.0.0.1:9",
                                  "nng+tls+tcp://127.0.0.1:9", "ws://127.0.0.1:9"])
def test_unported_transports_raise(addr):
    factory = ZmqPairSocketFactory()
    for make in (factory.create, factory.create_output):
        with pytest.raises(TransportError, match="not ported"):
            make(addr)


def test_transport_backends():
    assert isinstance(make_socket_factory("auto"), ZmqPairSocketFactory)
    assert isinstance(make_socket_factory("zmq"), ZmqPairSocketFactory)
    with pytest.raises(TransportError, match="not ported"):
        make_socket_factory("native")


def test_the_port_registry_is_its_own():
    """The same series names live in both packages' registries apart."""
    assert port_metrics.REGISTRY is not prometheus_client.REGISTRY
    port_metrics.DATA_READ_LINES()
    assert "data_read_lines_total" in port_metrics.REGISTERED_SERIES
