"""Prometheus series of the port's service host.

The port's copy of the series ``detectmateservice_tpu/engine/metrics.py``
declares that the service host and its hosted detector emit, under the same
names, label sets and buckets: the exposition format is the observable
contract. Every collector lives in ``REGISTRY``, a ``CollectorRegistry`` of
the port's own and not ``prometheus_client.REGISTRY``: the JAX package
registers the same names on the global registry, and a process that imports
both packages must keep the two sets of series apart. ``GET /metrics``
exposes this registry.

Each series is created once, at its first use, through ``get_or_create``.
``REGISTERED_SERIES`` maps every declared exposition name to its metric
class.

The component library imports no metrics client: a hosting Service hands
its component this module (``CoreComponent.metrics``), and the component
counts through the factories below.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Sequence, Type

from prometheus_client import CollectorRegistry, Counter, Enum, Gauge, Histogram

REGISTRY = CollectorRegistry()
_LOCK = threading.Lock()
_CACHE: Dict[str, object] = {}


def get_or_create(metric_cls: Type, name: str, documentation: str,
                  labelnames: Sequence[str] = (), **kwargs):
    """The collector for ``name`` in ``REGISTRY``, created once."""
    with _LOCK:
        found = _CACHE.get(name)
        if found is None:
            found = metric_cls(name, documentation, labelnames=labelnames,
                               registry=REGISTRY, **kwargs)
            _CACHE[name] = found
        return found


LABELS = ("component_type", "component_id")
REGISTERED_SERIES: Dict[str, Type] = {}


def _series(metric_cls: Type, name: str, documentation: str,
            labelnames: Sequence[str] = LABELS, **kwargs) -> Callable:
    REGISTERED_SERIES[name] = metric_cls
    return lambda: get_or_create(metric_cls, name, documentation, labelnames, **kwargs)


# engine-owned series
DATA_READ_BYTES = _series(Counter, "data_read_bytes_total", "Bytes read from the engine socket")
DATA_READ_LINES = _series(Counter, "data_read_lines_total", "Lines read from the engine socket")
DATA_WRITTEN_BYTES = _series(Counter, "data_written_bytes_total", "Bytes written to outputs")
DATA_WRITTEN_LINES = _series(Counter, "data_written_lines_total", "Lines written to outputs")
DATA_DROPPED_BYTES = _series(Counter, "data_dropped_bytes_total",
                             "Bytes dropped on slow/dead outputs")
DATA_DROPPED_LINES = _series(Counter, "data_dropped_lines_total",
                             "Lines dropped on slow/dead outputs")
PROCESSING_ERRORS = _series(Counter, "processing_errors_total", "Exceptions raised by process()")
INGRESS_BACKLOG = _series(
    Gauge, "engine_ingress_backlog",
    "Messages drained into the current dispatch burst; pinned at "
    "engine_batch_size means the ingress is saturated")
OUTPUT_SEND_BACKLOG = _series(Gauge, "output_send_backlog",
                              "Output sockets currently waiting on a full peer queue")

# pipeline tracing (engine_trace): every tracing stage observes its dwell and
# the transit from the upstream stage; e2e only where a trace ends (no
# forwarding outputs, trace_terminal, or trace_observe_e2e), so its count is
# the pipeline's completed traces, not a per-hop multiple
_DWELL_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
PIPELINE_STAGE_DWELL = _series(
    Histogram, "pipeline_stage_dwell_seconds",
    "Frame time inside this stage: ingress recv to egress send", buckets=_DWELL_BUCKETS)
PIPELINE_TRANSIT = _series(
    Histogram, "pipeline_transit_seconds",
    "Wire + queue time from the upstream stage's send to this stage's recv",
    buckets=_DWELL_BUCKETS)
PIPELINE_E2E_LATENCY = _series(
    Histogram, "pipeline_e2e_latency_seconds",
    "Pipeline ingest to terminal-stage completion (terminal stage only)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))

# service-owned series
ENGINE_RUNNING = _series(Enum, "engine_running", "Engine run state",
                         states=["running", "stopped"])
ENGINE_STARTS = _series(Counter, "engine_starts_total", "Engine starts")
PROCESSING_DURATION = _series(
    Histogram, "processing_duration_seconds", "End-to-end process() duration",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
DATA_PROCESSED_BYTES = _series(Counter, "data_processed_bytes_total",
                               "Bytes handed to process()")
DATA_PROCESSED_LINES = _series(Counter, "data_processed_lines_total",
                               "Lines handed to process()")
BATCH_SIZE_HIST = _series(Histogram, "detector_batch_size", "Dispatched micro-batch sizes",
                          buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))

# self-diagnosis (engine/health.py)
ENGINE_HEALTH_STATE = _series(Enum, "engine_health_state",
                              "Watchdog roll-up of the per-subsystem health checks",
                              states=["healthy", "degraded", "unhealthy"])
HEARTBEAT_AGE = _series(Gauge, "engine_heartbeat_age_seconds",
                        "Seconds since the named loop last stamped its heartbeat",
                        ("component_type", "component_id", "loop"))
BUILD_INFO = _series(Gauge, "dm_build_info",
                     "Constant 1; the labels carry the deployed package version and the "
                     "native kernels' feature versions",
                     ("version", "dm_feature_version", "dmt_feature_version"))

# the hosted detector's device batches (library/detectors/torch_scorer.py)
DEVICE_LABELS = ("component_type", "component_id", "device")
DEVICE_BATCHES = _series(Counter, "detector_device_batches_total",
                         "Scored batches per device", DEVICE_LABELS)
DEVICE_LINES = _series(Counter, "detector_device_lines_total",
                       "Scored lines per device", DEVICE_LABELS)
PATH_LABELS = ("component_type", "component_id", "path")
BATCH_OCCUPANCY = _series(
    Histogram, "detector_batch_occupancy",
    "Real rows / padded bucket size per dispatched batch (1.0 = no padding)",
    PATH_LABELS, buckets=(0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
BATCH_QUEUE_WAIT = _series(
    Histogram, "detector_queue_wait_seconds",
    "Dispatch-call to scoring-call-start wait per batch (worker queue / inline ~0)",
    PATH_LABELS, buckets=_DWELL_BUCKETS)
BATCH_DEVICE_SECONDS = _series(
    Histogram, "detector_device_seconds",
    "Scoring-call start to host-readable scores per batch (device compute "
    "+ readback on the device path; synchronous compute on the host path)",
    PATH_LABELS, buckets=_DWELL_BUCKETS)
BUCKET_SELECTED = _series(
    Counter, "detector_bucket_selected_total",
    "Dispatches per compile bucket and scoring path (host CPU twin vs accelerator)",
    ("component_type", "component_id", "bucket", "path"))

# which path featurized each row (the detector's featurize_rows): native =
# rows the C featurizer tokenized, fallback = rows featurized in Python (the
# rows the C side refused, or every row with native_featurize off)
FEATURIZE_NATIVE_ROWS = _series(
    Counter, "featurize_native_rows_total",
    "Rows featurized by the native (C, row-parallel) kernel")
FEATURIZE_FALLBACK_ROWS = _series(
    Counter, "featurize_fallback_rows_total",
    "Rows featurized by the Python fallback path (kernel-flagged or kernel unavailable)")

# which path decoded and serialized each parser row (MatcherParser): native =
# the C row, fallback = the Python path (rows the C side flags, or every row
# with native_parse off)
PARSE_NATIVE_ROWS = _series(
    Counter, "parse_native_rows_total",
    "Parser rows decoded and serialized by the native (C) host path")
PARSE_FALLBACK_ROWS = _series(
    Counter, "parse_fallback_rows_total",
    "Parser rows that fell back to the Python path (kernel-flagged or kernel unavailable)")

# the capture ledger (engine/device_obs.py). The names keep "xla": they are
# the JAX package's series, which the repo's dashboards and alert rules read
# for both packages; on the card a "compile" is a CUDA-graph capture of one
# warm bucket or an nvcc kernel build, and the backend label is "cuda" (or
# "cpu" where the detector was asked for the CPU)
XLA_LABELS = ("component_type", "component_id", "bucket", "backend")
XLA_COMPILES = _series(
    Counter, "scorer_xla_compiles_total",
    "XLA backend compiles, attributed to the batch bucket that triggered them "
    "(on CUDA: graph captures and kernel builds)", XLA_LABELS)
XLA_COMPILE_SECONDS = _series(
    Counter, "scorer_xla_compile_seconds_total",
    "Wall seconds spent in XLA backend compiles per bucket (on CUDA: graph "
    "captures and kernel builds)", XLA_LABELS)
XLA_RECOMPILES_UNEXPECTED = _series(
    Counter, "scorer_xla_recompiles_unexpected_total",
    "Compiles on the dispatch path after warm-up completed (on CUDA: a dispatch "
    "on an active bucket that found no valid graph); a nonzero rate is a "
    "recompile storm")
SCORER_WARMUP_SECONDS = _series(
    Gauge, "scorer_warmup_seconds",
    "Wall seconds of the scorer's boot warm-up by phase: aot (warm-set graph "
    "captures), cache_load (loading already-built kernel libraries), "
    "device_put (model build and weights to the device); set once per boot",
    ("component_type", "component_id", "phase"))
DEVICE_HBM = _series(
    Gauge, "device_hbm_bytes",
    "Device memory, kind=in_use (torch.cuda.memory_stats allocated bytes) | "
    "limit (torch.cuda.mem_get_info total), read at scrape time",
    ("component_type", "component_id", "device", "kind"))

# the coalescer (library/detectors/torch_scorer.py): rows held across calls
# toward a warm bucket, and why each coalesced batch left
COALESCE_DEPTH = _series(
    Gauge, "detector_coalesce_depth",
    "Rows currently held by the adaptive batch coalescer, waiting for a "
    "bucket to fill or for the oldest row's deadline")
DEADLINE_RELEASES = _series(
    Counter, "detector_deadline_releases_total",
    "Coalesced micro-batch releases by reason: full (target occupancy "
    "reached), deadline (latency budget spent), flush (idle/teardown)",
    ("component_type", "component_id", "reason"))

# the model lifecycle (rollout/): cutovers by outcome (promoted,
# rolled_back, holdback, pinned, failed); the per-row |candidate - live|
# score delta while a candidate shadows; the newest stored checkpoint's age,
# read at scrape time off the store's manifest; and a constant-1 gauge
# whose labels carry the live version and model family
MODEL_SWAPS = _series(
    Counter, "model_swaps_total",
    "Model hot-swap/cutover attempts by outcome: promoted, rolled_back, "
    "holdback (canary gate refused), pinned, failed",
    ("component_type", "component_id", "result"))
MODEL_SHADOW_DIVERGENCE = _series(
    Histogram, "model_shadow_divergence",
    "Per-row |candidate - live| score delta while a candidate shadows",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 25.0))
MODEL_CHECKPOINT_AGE = _series(
    Gauge, "model_checkpoint_age_seconds",
    "Seconds since the rollout store's newest checkpoint was committed "
    "(read at scrape time; ages from manager start when none exists yet)")
MODEL_VERSION_INFO = _series(
    Gauge, "model_version_info",
    "Constant 1; the labels carry the live model checkpoint version and "
    "model family (0 = the boot-time fit, never hot-swapped)",
    ("component_type", "component_id", "version", "model"))

# drift and capacity (obs/): the live score distribution against the
# baseline pinned at promote time (stat="ks": two-sample Kolmogorov-Smirnov;
# stat="psi": population stability index), the token columns over the
# per-feature PSI threshold, the modeled capacity of this replica and the
# offered rate over it
MODEL_DRIFT_SCORE = _series(
    Gauge, "model_drift_score",
    "Live-vs-baseline score-distribution divergence, by statistic: "
    "stat=\"ks\" (two-sample Kolmogorov–Smirnov) or stat=\"psi\" "
    "(population stability index)",
    ("component_type", "component_id", "stat"))
MODEL_DRIFT_FEATURES = _series(
    Gauge, "model_drift_features_over_threshold",
    "Token feature columns whose per-feature PSI against the pinned "
    "baseline exceeds drift_feature_psi_threshold")
REPLICA_CAPACITY = _series(
    Gauge, "replica_capacity_lines_per_s",
    "Modeled scoring capacity of this replica (lines/s at full device "
    "busy): rows ÷ device-seconds over the live window, or the idle "
    "micro-probe's measured rate when no traffic flows")
CAPACITY_HEADROOM = _series(
    Gauge, "capacity_headroom_ratio",
    "Offered line rate ÷ modeled capacity (0 = idle, 1 = saturated); the "
    "predictive scale-out signal beside the reactive backlog gauge")

# cross-stage telemetry (telemetry/): spans the engine-side exporter dropped
# instead of blocking the loop; the collector's spans by the tail-sampling
# verdict of their trace, traces assembled, dropped by the sampler and
# flushed incomplete, duplicate hops, OTLP pushes and open traces
TELEMETRY_EXPORT_DROPPED = _series(
    Counter, "telemetry_spans_export_dropped_total",
    "Spans dropped by the engine-side exporter instead of blocking the hot "
    "loop (bounded queue full, or the telemetry link refused the frame)")
TELEMETRY_SPANS = _series(
    Counter, "telemetry_spans_total",
    "Hop spans ingested by the telemetry collector, by the tail-sampling "
    "verdict of the trace they were assembled into",
    ("component_type", "component_id", "verdict"))
TELEMETRY_TRACES_ASSEMBLED = _series(
    Counter, "telemetry_traces_assembled_total",
    "Pipeline traces fully assembled by the collector (terminal hop seen "
    "and the completion watermark passed)")
TELEMETRY_TRACES_DROPPED = _series(
    Counter, "telemetry_traces_dropped_total",
    "Healthy assembled traces the tail sampler declined to retain "
    "(1 - telemetry_sample_healthy_ratio of healthy traffic)")
TELEMETRY_TRACES_INCOMPLETE = _series(
    Counter, "telemetry_traces_incomplete_total",
    "Traces flushed by the collector without a terminal hop after "
    "telemetry_trace_timeout_s (a stage died, shed mid-pipeline, or its "
    "exporter dropped the span)")
TELEMETRY_SPANS_DEDUPED = _series(
    Counter, "telemetry_spans_deduped_total",
    "Duplicate (trace, stage) hop spans discarded during assembly — "
    "router at-least-once redelivery makes these normal")
TELEMETRY_OTLP_PUSHES = _series(
    Counter, "telemetry_otlp_pushes_total",
    "OTLP/JSON export batches pushed to telemetry_otlp_url, by result "
    "(ok / error)",
    ("component_type", "component_id", "result"))
TELEMETRY_COLLECTOR_BACKLOG = _series(
    Gauge, "telemetry_collector_backlog",
    "Open (not yet completed or flushed) traces held by the collector's "
    "assembler; sustained growth means the completion watermark is not "
    "advancing (a stage's exporter went quiet) or ingest outruns assembly")
