"""Admin route table: every HTTP route the port's admin plane serves.

The port's copy of the routes of ``detectmateservice_tpu/web/router.py``
that this package's subsystems back: ``GET /metrics`` (the port's own
registry), ``/admin/status``, ``/admin/health`` (``?deep=1`` evaluates the
checks and answers 503 unless healthy), ``/admin/events``, ``/admin/xla``
(the capture ledger's snapshot, ``?limit=``; host state only, no CUDA
tensor is touched from the HTTP thread), ``/admin/trace`` (the flight
recorder: JSON, or ``?format=chrome``, which on the stage hosting the
telemetry collector is the cross-stage Perfetto document), ``/admin/traces``
(the collector's assembled traces, ``?id=`` one of them, ``?format=perfetto``
or ``otlp``; 404 without a collector), the profiler's ``GET
/admin/profile`` (status) and ``/admin/profile/latest`` (the newest capture
as a zip; 404 before the first, 409 while one runs) and ``POST
/admin/profile`` (``?seconds=`` or a JSON body; 409 while a capture runs,
400 on bad seconds), the model lifecycle's ``GET
/admin/model`` (``?history=1`` for the checkpoint log), ``/admin/drift`` and
``/admin/slo`` (404 where the subsystem is off), and ``POST
/admin/start``, ``/stop``, ``/shutdown``, ``/reconfigure``, ``/checkpoint``
and ``/model`` (``promote``, ``rollback``, ``pin``, ``unpin``, ``cycle``;
an unknown action or a state conflict is a 400). The JAX package's other
routes (``UNPORTED_ROUTES``) answer 404 until their subsystem is ported.
``GET /metrics?format=openmetrics`` carries the exemplars: the trace id on
``pipeline_e2e_latency_seconds`` buckets where spans leave for a collector,
and on ``detector_queue_wait_seconds`` buckets of a traced pipeline.

Handlers take ``(service, query, payload)``: the parsed query string, and
the decoded JSON body (``{}`` when empty; GET handlers get ``None``).
``ValueError`` surfaces as HTTP 400, any other exception as HTTP 500.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from prometheus_client import CONTENT_TYPE_LATEST, generate_latest
from prometheus_client.openmetrics import exposition as openmetrics

from ..engine import device_obs
from ..engine.metrics import REGISTRY


@dataclass(frozen=True)
class Response:
    status: int
    body: Any                        # dict/list → JSON; bytes → raw
    content_type: str = "application/json"
    # runs after the reply is on the wire (shutdown answers first)
    after: Optional[Callable[[], None]] = None


@dataclass(frozen=True)
class Route:
    method: str
    path: str
    handler: Callable[..., Response]
    doc: str


def _int_param(query: Dict[str, List[str]], name: str,
               default: Optional[int] = None) -> Optional[int]:
    raw = (query.get(name) or [None])[0]
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer") from None


def _float_param(query: Dict[str, List[str]], name: str,
                 default: Optional[float] = None) -> Optional[float]:
    raw = (query.get(name) or [None])[0]
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number") from None


def _metrics(service, query, payload) -> Response:
    fmt = (query.get("format") or ["prometheus"])[0]
    if fmt == "openmetrics":
        return Response(200, openmetrics.generate_latest(REGISTRY),
                        openmetrics.CONTENT_TYPE_LATEST)
    if fmt != "prometheus":
        return Response(400, {"detail": f"unknown format {fmt!r}"})
    return Response(200, generate_latest(REGISTRY), CONTENT_TYPE_LATEST)


def _status(service, query, payload) -> Response:
    return Response(200, service.status())


def _health(service, query, payload) -> Response:
    deep = (query.get("deep") or ["0"])[0] not in ("", "0", "false")
    if deep:
        # a fresh evaluation with per-check detail; 503 on anything short
        # of healthy, for orchestration healthchecks
        report = service.health.evaluate()
        return Response(200 if report["state"] == "healthy" else 503, report)
    # cheap liveness: the watchdog's last roll-up; degraded stays 200
    state = service.health.state
    return Response(503 if state == "unhealthy" else 200, {"state": state})


def _events(service, query, payload) -> Response:
    limit = _int_param(query, "limit", default=-1)
    return Response(200, service.events.snapshot(limit if limit >= 0 else None))


def _xla(service, query, payload) -> Response:
    limit = _int_param(query, "limit", default=-1)
    return Response(200, device_obs.get_ledger().snapshot(
        limit if limit is not None and limit >= 0 else None))


def _trace(service, query, payload) -> Response:
    fmt = (query.get("format") or ["json"])[0]
    recorder = service.engine.trace_recorder
    if fmt == "chrome":
        # the stage hosting the collector serves the cross-stage view; any
        # other stage only its own hops, and says so
        collector = getattr(service, "telemetry", None)
        if collector is not None:
            return Response(200, collector.perfetto_events())
        doc = recorder.chrome_events()
        doc["localOnly"] = True
        return Response(200, doc)
    if fmt == "json":
        body = recorder.snapshot()
        body["tracing_enabled"] = bool(service.settings.engine_trace)
        return Response(200, body)
    return Response(400, {"detail": f"unknown format {fmt!r}"})


def _traces(service, query, payload) -> Response:
    collector = getattr(service, "telemetry", None)
    if collector is None:
        return Response(404, {"detail": "this stage runs no telemetry collector "
                                        "(telemetry_collector not set)"})
    trace_id = (query.get("id") or [None])[0]
    if trace_id is not None:
        trace = collector.trace(trace_id)
        if trace is None:
            return Response(404, {"detail": f"trace {trace_id!r} is not in the retained "
                                            "ring (sampled out, expired, or never seen)"})
        return Response(200, trace)
    fmt = (query.get("format") or ["json"])[0]
    if fmt == "perfetto":
        return Response(200, collector.perfetto_events())
    if fmt == "otlp":
        return Response(200, collector.otlp_payload())
    if fmt == "json":
        return Response(200, collector.snapshot(limit=_int_param(query, "limit")))
    return Response(400, {"detail": f"unknown format {fmt!r}"})


def _profile_dir(service) -> str:
    from ..utils.profiling import PROFILER

    return service.settings.profile_dir or PROFILER.default_dir()


def _profile_status(service, query, payload) -> Response:
    from ..utils.profiling import PROFILER

    status = PROFILER.status()
    status["profile_dir"] = _profile_dir(service)
    return Response(200, status)


def _profile_latest(service, query, payload) -> Response:
    from ..utils.profiling import PROFILER

    base_dir = _profile_dir(service)
    if PROFILER.status()["running"]:
        return Response(409, {"detail": "capture still running; retry when "
                                        "GET /admin/profile reports done"})
    archive = PROFILER.zip_latest(base_dir)
    if archive is None:
        return Response(404, {"detail": f"no completed capture under {base_dir}"})
    return Response(200, archive[1], content_type="application/zip")


def _start(service, query, payload) -> Response:
    return Response(200, {"detail": service.start()})


def _stop(service, query, payload) -> Response:
    service.stop()
    return Response(200, {"detail": "engine stopped"})


def _shutdown(service, query, payload) -> Response:
    return Response(200, {"detail": "service shutting down"}, after=service.shutdown)


def _reconfigure(service, query, payload) -> Response:
    config = (payload or {}).get("config") or {}
    persist = bool((payload or {}).get("persist", False))
    updated = service.reconfigure(config, persist=persist)
    return Response(200, {"detail": "reconfigured", "config": updated})


def _checkpoint(service, query, payload) -> Response:
    return Response(200, service.checkpoint())


def _model(service, query, payload) -> Response:
    rollout = getattr(service, "rollout", None)
    if rollout is None:
        return Response(404, {"detail": "model lifecycle is not enabled on "
                                        "this stage (rollout_enabled)"})
    if (query.get("history") or ["0"])[0] not in ("", "0", "false"):
        limit = _int_param(query, "limit", default=0) or None
        return Response(200, rollout.history(limit))
    return Response(200, rollout.status())


def _drift(service, query, payload) -> Response:
    drift = getattr(service, "drift", None)
    if drift is None:
        return Response(404, {"detail": "drift monitoring is not enabled "
                                        "on this stage (drift_enabled)"})
    return Response(200, drift.status())


def _slo(service, query, payload) -> Response:
    tracker = getattr(service, "slo", None)
    if tracker is None:
        return Response(404, {"detail": "service has no SLO tracker"})
    body = tracker.snapshot()
    capacity = getattr(service, "capacity", None)
    # the capacity model rides along: burn says how fast the budget goes,
    # headroom says whether more traffic would make it worse
    body["capacity"] = capacity.status() if capacity is not None else None
    return Response(200, body)


def _profile_start(service, query, payload) -> Response:
    from ..utils.profiling import PROFILER, ProfileBusyError

    payload = payload or {}
    seconds = _float_param(query, "seconds")
    if seconds is None:
        seconds = payload.get("seconds")
    if seconds is None:
        # the JAX package's older body shape
        seconds = float(payload.get("duration_ms", 1000)) / 1000.0
    base_dir = payload.get("out_dir") or _profile_dir(service)
    # the activities follow the hosted component's device (None: no device
    # work, the host only)
    device = getattr(service.library_component, "device", None)
    try:
        info = PROFILER.start(base_dir, float(seconds), service.settings.profile_max_captures,
                              device=device)
    except ProfileBusyError as exc:
        return Response(409, {"detail": str(exc)})
    info["detail"] = "capture started"
    return Response(200, info)


def _model_control(service, query, payload) -> Response:
    from ..rollout import RolloutError, StoreError

    rollout = getattr(service, "rollout", None)
    if rollout is None:
        return Response(404, {"detail": "model lifecycle is not enabled on "
                                        "this stage (rollout_enabled)"})
    payload = payload or {}
    action = str(payload.get("action", ""))
    version = payload.get("version")
    if version is not None:
        try:
            version = int(version)
        except (TypeError, ValueError):
            raise ValueError("version must be an integer") from None
    try:
        if action == "promote":
            return Response(200, rollout.promote(version))
        if action == "rollback":
            return Response(200, rollout.rollback())
        if action == "pin":
            return Response(200, rollout.pin(version))
        if action == "unpin":
            return Response(200, rollout.unpin())
        if action == "cycle":
            block = bool(payload.get("block", False))
            return Response(200, rollout.run_cycle(reason="operator", block=block))
    except (RolloutError, StoreError) as exc:
        # state conflicts (nothing shadowing, unknown version, nothing to
        # roll back to) are client errors, not server faults
        raise ValueError(str(exc)) from exc
    raise ValueError(f"unknown action {action!r} (expected 'promote', "
                     "'rollback', 'pin', 'unpin', or 'cycle')")


ROUTES: Tuple[Route, ...] = (
    Route("GET", "/metrics", _metrics, "Prometheus exposition"),
    Route("GET", "/admin/status", _status, "status report"),
    Route("GET", "/admin/health", _health, "liveness / deep health"),
    Route("GET", "/admin/events", _events, "structured event ring"),
    Route("GET", "/admin/trace", _trace, "pipeline flight recorder"),
    Route("GET", "/admin/traces", _traces,
          "telemetry collector: assembled cross-stage traces "
          "(?id=<hex> for one, ?format=perfetto|otlp for exports)"),
    Route("GET", "/admin/xla", _xla, "capture ledger + device-batch spans"),
    Route("GET", "/admin/profile", _profile_status, "profiler capture status"),
    Route("GET", "/admin/profile/latest", _profile_latest,
          "download the newest completed capture as a zip"),
    Route("GET", "/admin/model", _model,
          "model lifecycle status (?history=1 for the checkpoint log)"),
    Route("GET", "/admin/drift", _drift,
          "drift monitor snapshot: live-vs-baseline stats, hysteresis state, "
          "top drifting features"),
    Route("GET", "/admin/slo", _slo,
          "multi-window SLO burn rates, per-stage dwell attribution, and the "
          "capacity model"),
    Route("POST", "/admin/start", _start, "start the engine"),
    Route("POST", "/admin/stop", _stop, "stop the engine"),
    Route("POST", "/admin/shutdown", _shutdown, "shut the service down"),
    Route("POST", "/admin/reconfigure", _reconfigure, "validate + apply component config"),
    Route("POST", "/admin/checkpoint", _checkpoint, "checkpoint component state"),
    Route("POST", "/admin/profile", _profile_start,
          "start an on-demand torch.profiler capture"),
    Route("POST", "/admin/model", _model_control,
          "model lifecycle verbs: promote/rollback/pin/unpin/cycle"),
)

# the JAX package's routes whose subsystems are not ported: they answer 404
UNPORTED_ROUTES: Tuple[Tuple[str, str], ...] = (
    ("GET", "/admin/load"), ("GET", "/admin/replicas"), ("GET", "/admin/replay"),
    ("GET", "/admin/faults"), ("GET", "/admin/dlq"), ("GET", "/admin/tenants"),
    ("POST", "/admin/load"), ("POST", "/admin/replicas"),
    ("POST", "/admin/faults"), ("POST", "/admin/dlq"),
    ("POST", "/admin/replay"),
)


def route_table() -> Dict[Tuple[str, str], Route]:
    table: Dict[Tuple[str, str], Route] = {}
    for route in ROUTES:
        key = (route.method, route.path)
        if key in table:
            raise ValueError(f"duplicate route {key}")
        table[key] = route
    return table
