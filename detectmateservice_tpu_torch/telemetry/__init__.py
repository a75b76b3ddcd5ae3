"""Cross-stage telemetry on the port: span export, trace assembly, tail
sampling and export.

The port's copy of ``detectmateservice_tpu/telemetry/``:

* :mod:`.spans` — the engine-side exporter: completed hop records leave the
  process as span frames through a bounded queue and a sender thread (one
  deque append per frame on the engine loop);
* :mod:`.collector` — assembles spans into whole-pipeline traces
  (out-of-order arrival, duplicate hops, watermark completion, timeouts)
  and tail-samples them: every anomalous trace, a ratio of the healthy;
* :mod:`.otlp` — OTLP/JSON encoding and its HTTP push;
* :mod:`.perfetto` — the cross-stage Chrome trace-event view.

The wire between exporter and collector is the span frame
(``engine/framing.py`` ``MAGIC_SPAN``); the settings are ``telemetry_*``.
"""
from .collector import TailSampler, TelemetryCollector, TraceAssembler
from .spans import SpanExporter

__all__ = ["SpanExporter", "TailSampler", "TelemetryCollector", "TraceAssembler"]
