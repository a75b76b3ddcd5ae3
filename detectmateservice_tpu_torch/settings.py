"""Service settings: YAML and environment configuration with typed addresses.

The port's copy of ``detectmateservice_tpu/settings.py`` as a dataclass:

* the fields the port's service host honours, with the JAX package's
  defaults and bounds: identity, logging, the engine (``engine_*``), the
  outputs (``out_*``), the admin HTTP server (``http_*``), ``config_file``,
  ``checkpoint_dir``, the watchdog (``watchdog_*``), ``event_ring_size``,
  ``recompile_alert_enabled`` (the capture ledger's alerts), ``log_format``,
  ``send_batch_max``, ``transport_backend``, ``dlq_max_attempts`` (the
  attempt budget of poison isolation), the model lifecycle's
  ``rollout_*``, ``drift_*`` and ``capacity_*`` (``rollout_enabled``
  requires ``rollout_dir``, ``drift_enabled`` requires ``rollout_enabled``),
  pipeline tracing (``engine_trace``, ``trace_*``), cross-stage telemetry
  (``telemetry_*``; ``telemetry_addr`` requires ``engine_trace``,
  ``telemetry_collector`` requires ``telemetry_collector_addr``), the
  profiler's ``profile_dir`` and ``profile_max_captures``, and the chip
  plane's ``mesh_shape``, ``coordinator_address``, ``num_processes`` and
  ``process_id`` (``parallel/``);
* ``DETECTMATE_``-prefixed environment overrides with ``__`` nesting, env
  winning over YAML per field; strings from the environment are converted
  to the field's type;
* a deterministic UUIDv5 ``component_id``, stable across restarts;
* transport addresses checked against the JAX package's scheme set.

Every field of a JAX subsystem the port does not carry yet (the replica
router, the WAL and DLQ, shed, zero-copy framing, TLS, fault plans, the
compile cache, multi-ingress shards and the JAX platform pin) is known
with its default: set away from it, it raises ``SettingsError`` naming the
field and its subsystem. So are addresses whose transport is not ported. A
setting is never silently ignored.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import typing
import uuid
from typing import Any, Dict, List, Mapping, Optional

import yaml

ENV_PREFIX = "DETECTMATE_"
ENV_NESTED_DELIMITER = "__"

SUPPORTED_SCHEMES = ("ipc", "tcp", "tls+tcp", "nng+tcp", "nng+tls+tcp", "ws", "inproc")
# the schemes the port's transport carries (engine/socket.py)
PORTED_SCHEMES = ("ipc", "tcp", "inproc")


class SettingsError(Exception):
    """Raised for invalid service settings."""


def _validate_addr(addr: str) -> str:
    """Check a transport address against the supported scheme set."""
    if "://" not in addr:
        raise ValueError(f"address {addr!r} has no scheme; expected one of {SUPPORTED_SCHEMES}")
    scheme, rest = addr.split("://", 1)
    if scheme not in SUPPORTED_SCHEMES:
        raise ValueError(f"unsupported scheme {scheme!r} in {addr!r}; "
                         f"expected one of {SUPPORTED_SCHEMES}")
    if not rest:
        raise ValueError(f"address {addr!r} has an empty target")
    if scheme in ("tcp", "tls+tcp", "nng+tcp", "nng+tls+tcp", "ws"):
        if ":" not in rest.split("/", 1)[0]:
            raise ValueError(f"address {addr!r} requires an explicit port")
    return addr


def _field(default: Any, **checks: Any) -> Any:
    """A dataclass field with bounds (``ge``, ``gt``, ``le``), a regex
    ``pattern`` or ``addr=True`` in its metadata."""
    if isinstance(default, list):
        return dataclasses.field(default_factory=list, metadata=checks)
    return dataclasses.field(default=default, metadata=checks)


# field -> (the JAX package's default, the subsystem it belongs to)
UNPORTED: Dict[str, tuple] = {
    "engine_ingress_addrs": ([], "multi-ingress shards"),
    "tls_input": (None, "TLS"),
    "tls_output": (None, "TLS"),
    "zero_copy_framing": (False, "zero-copy framing"),
    "zero_copy_slots": (32, "zero-copy framing"),
    "zero_copy_slot_bytes": (262144, "zero-copy framing"),
    "backend": ("auto", "the JAX platform pin (the detector's device is set by "
                        "`device` in its component config)"),
    "router_replicas": ([], "the replica router"),
    "router_admin_urls": ([], "the replica router"),
    "router_policy": ("least_backlog", "the replica router"),
    "router_drain_timeout_s": (5.0, "the replica router"),
    "router_credit_window": (64, "the replica router"),
    "router_health_interval_s": (2.0, "the replica router"),
    "durable_ingress": (False, "the WAL"),
    "wal_dir": (None, "the WAL"),
    "wal_segment_bytes": (64 * 1024 * 1024, "the WAL"),
    "wal_fsync_interval_ms": (50.0, "the WAL"),
    "wal_retain_bytes": (1024 * 1024 * 1024, "the WAL"),
    "wal_retain_age_s": (86400.0, "the WAL"),
    "wal_on_disk_error": ("degrade", "the WAL"),
    "fault_plan_file": (None, "fault plans"),
    "dlq_max_frames": (1024, "the DLQ"),
    "dlq_dir": (None, "the DLQ"),
    "compile_cache_enabled": (False, "the compile cache"),
    "compile_cache_dir": (None, "the compile cache"),
    "shed_enabled": (False, "shed"),
    "tenants_file": (None, "shed"),
    "tenant_default_tier": ("best_effort", "shed"),
    "tenant_default_rate": (10000.0, "shed"),
    "tenant_default_burst": (None, "shed"),
    "shed_tenant_buckets": (16, "shed"),
    "shed_retry_after_ms": (100.0, "shed"),
    "shed_ladder_backlog_t1": (256.0, "shed"),
    "shed_ladder_backlog_t2": (1024.0, "shed"),
    "shed_ladder_backlog_t3": (4096.0, "shed"),
    "shed_ladder_recovery_intervals": (2, "shed"),
}


@dataclasses.dataclass
class ServiceSettings:
    """Per-process service configuration: the JAX package's fields that the
    port honours, with their defaults and bounds."""

    # -- identity ---------------------------------------------------------
    component_name: Optional[str] = None
    component_id: Optional[str] = None
    component_type: str = "core"
    component_config_class: Optional[str] = None

    # -- logging ----------------------------------------------------------
    log_level: str = "INFO"
    log_dir: str = "./logs"
    log_to_console: bool = True
    log_to_file: bool = True
    # "json" renders every log record as one JSON object per line
    log_format: str = _field("plain", pattern="^(plain|json)$")

    # -- engine data channel ----------------------------------------------
    engine_addr: str = _field("ipc:///tmp/detectmate.engine.ipc", addr=True)
    engine_autostart: bool = True
    engine_recv_timeout: int = _field(100, ge=1)  # ms
    engine_retry_count: int = _field(10, ge=1)
    engine_buffer_size: int = _field(100, ge=0, le=8192)
    # 1 keeps the strict per-message contract; > 1 micro-batches, and with
    # a process_frames component takes whole wire frames (fused-frame mode)
    engine_batch_size: int = _field(1, ge=1, le=16384)
    engine_batch_timeout_ms: float = _field(2.0, ge=0.0)
    # pack up to N results per outgoing wire frame (engine/framing.py)
    engine_frame_batch: int = _field(1, ge=1, le=8192)
    # batch-frame detection by magic rests on protobuf payloads; a pipeline
    # with other payloads turns it off
    engine_frame_autodetect: bool = True

    # -- pipeline tracing (engine/tracing.py) ------------------------------
    # stamp this stage's hop into v2 traced frames sent downstream (the
    # receivers strip or propagate them); needs engine_frame_autodetect
    engine_trace: bool = False
    # the hop's stage name; default component_name, else component_type
    trace_stage: Optional[str] = None
    # None: a stage with no forwarding outputs ends the trace (e2e, the
    # flight recorder); true: this stage ends it although it forwards, and
    # its downstream sees plain frames
    trace_terminal: Optional[bool] = None
    # observe e2e at every egress while still propagating the trace
    trace_observe_e2e: bool = False
    # the flight recorder: N slowest, a ring of sampled traces, 1 in K sampled
    trace_slowest: int = _field(32, ge=1, le=1024)
    trace_sampled: int = _field(128, ge=1, le=8192)
    trace_sample_every: int = _field(64, ge=1)

    # -- outputs ----------------------------------------------------------
    out_addr: List[str] = _field([], addr=True)
    out_dial_timeout: int = _field(1000, ge=0)  # ms
    # "drop": bounded retries, then drop and count; "block": flow control
    out_backpressure: str = _field("drop", pattern="^(drop|block)$")
    # block mode: the one window pending sends share to land after stop
    out_stop_drain_ms: float = _field(250.0, ge=0.0, le=1500.0)
    # the zmq transport sends frame by frame; kept for the JAX package's
    # batched native send
    send_batch_max: int = _field(64, ge=1, le=8192)
    # "zmq" and "auto" give the zmq transport; "native" is not ported
    transport_backend: str = _field("auto", pattern="^(auto|zmq|native)$")

    # -- admin HTTP -------------------------------------------------------
    http_host: str = "127.0.0.1"
    http_port: int = _field(8000, ge=0, le=65535)

    # -- component config and state -----------------------------------------
    config_file: Optional[str] = None
    # restore at setup_io when a checkpoint exists, save at clean shutdown
    # and on POST /admin/checkpoint
    checkpoint_dir: Optional[str] = None
    # processing attempts before poison isolation drops a message
    dlq_max_attempts: int = _field(3, ge=1, le=100)
    # on-demand torch.profiler captures (POST /admin/profile) land in
    # numbered subdirectories of profile_dir (default: a per-process
    # directory under the temp directory), pruned to the newest
    # profile_max_captures
    profile_dir: Optional[str] = None
    profile_max_captures: int = _field(4, ge=1, le=64)

    # -- the chip plane (parallel/) ------------------------------------------
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 8}
    # several processes join one process group (parallel/distributed.py);
    # the env layer reaches these fields by their names:
    # DETECTMATE_COORDINATOR_ADDRESS / _NUM_PROCESSES / _PROCESS_ID
    coordinator_address: Optional[str] = None  # "host:port"
    num_processes: int = _field(1, ge=1)
    process_id: int = _field(0, ge=0)

    # -- self-diagnosis (engine/health.py) --------------------------------
    watchdog_enabled: bool = True
    watchdog_interval_s: float = _field(2.0, ge=0.05, le=300.0)
    watchdog_stall_seconds: float = _field(10.0, gt=0.0)
    watchdog_unhealthy_seconds: float = _field(30.0, gt=0.0)
    watchdog_recovery_intervals: int = _field(2, ge=1)
    watchdog_ingest_stall_seconds: float = _field(0.0, ge=0.0)
    event_ring_size: int = _field(512, ge=8, le=65536)
    # an unexpected recompile (a graph capture on the dispatch path after
    # warm-up, engine/device_obs.py) emits a structured event and arms the
    # xla_recompile_storm check; the counter moves either way
    recompile_alert_enabled: bool = True

    # -- model lifecycle (rollout/) ---------------------------------------
    # a background trainer fine-tunes candidates on a sampled tail of live
    # traffic, a candidate shadow-scores sampled rows beside the live model,
    # and the gate hot-swaps it in or holds it back; needs a component with
    # the rollout hooks (the torch scorer) and a versioned store root
    rollout_enabled: bool = False
    rollout_dir: Optional[str] = None
    rollout_interval_s: float = _field(600.0, ge=0.05)
    # the dispatch-path tap: the share of drained rows offered, and the
    # reservoir's bound (capacity * seq_len * 4 bytes)
    rollout_sample_ratio: float = _field(0.05, gt=0.0, le=1.0)
    rollout_sample_capacity: int = _field(4096, ge=16, le=262144)
    rollout_min_fit_rows: int = _field(256, ge=1)
    rollout_train_epochs: int = _field(1, ge=1, le=100)
    # the shadow gate: at least this many rows, then promote only while the
    # mean |score delta| and the decision-flip ratio stay under their caps
    rollout_min_shadow_samples: int = _field(512, ge=1)
    rollout_shadow_timeout_s: float = _field(300.0, gt=0.0)
    rollout_max_mean_delta: float = _field(0.25, ge=0.0)
    rollout_max_flip_ratio: float = _field(0.01, ge=0.0, le=1.0)
    # false: a candidate that passes waits for POST /admin/model promote
    rollout_auto_promote: bool = True
    # keep-N rotation (live, pinned and newest never pruned)
    rollout_keep_checkpoints: int = _field(4, ge=1, le=64)

    # -- drift and capacity (obs/) ----------------------------------------
    # the live score distribution (the rollout reservoir's paired scores)
    # against a baseline pinned at promote time and kept in the store's
    # manifest; needs rollout_enabled
    drift_enabled: bool = False
    drift_interval_s: float = _field(30.0, ge=0.05)
    drift_baseline_size: int = _field(512, ge=16, le=65536)
    drift_min_rows: int = _field(64, ge=8)
    drift_ks_threshold: float = _field(0.25, ge=0.0, le=1.0)
    drift_psi_threshold: float = _field(0.2, ge=0.0)
    drift_feature_psi_threshold: float = _field(0.25, ge=0.0)
    # hysteresis: consecutive evaluations over (under) the thresholds before
    # drift_detected (drift_cleared)
    drift_trigger_intervals: int = _field(3, ge=1, le=1000)
    drift_clear_intervals: int = _field(2, ge=1, le=1000)
    # sustained drift starts a cycle at most this often (0: at every tick
    # that finds drift)
    drift_min_cycle_interval_s: float = _field(900.0, ge=0.0)
    # the capacity model: rows over device-seconds while traffic flows, an
    # idle probe through rollout_scores otherwise
    capacity_enabled: bool = False
    capacity_interval_s: float = _field(15.0, ge=0.05)
    capacity_probe_rows: int = _field(256, ge=1, le=65536)
    # probe only after this many idle seconds (0: probe at every idle tick)
    capacity_probe_idle_s: float = _field(30.0, ge=0.0)
    capacity_window_s: float = _field(60.0, ge=1.0)

    # -- cross-stage telemetry (telemetry/) -------------------------------
    # where this stage's engine ships its hop spans (the collector's
    # telemetry_collector_addr); needs engine_trace
    telemetry_addr: Optional[str] = _field(None, addr=True)
    # the bounded span queue on the engine loop: when full a span is
    # dropped and counted, never a frame
    telemetry_queue_size: int = _field(4096, ge=16, le=1048576)
    telemetry_flush_interval_ms: float = _field(50.0, ge=1.0, le=10000.0)
    # the collector (one stage per pipeline): assemble spans into traces,
    # tail-sample them, serve GET /admin/traces
    telemetry_collector: bool = False
    telemetry_collector_addr: Optional[str] = _field(None, addr=True)
    # the anomalous tail is always kept; healthy traces at this ratio, by a
    # hash of the trace id
    telemetry_sample_healthy_ratio: float = _field(0.05, ge=0.0, le=1.0)
    # e2e above this is "slow" (kept)
    telemetry_slo_ms: float = _field(1000.0, gt=0.0)
    # a trace with its terminal hop completes once the newest send time
    # seen across all spans is this far past the trace's own newest hop
    telemetry_settle_ms: float = _field(200.0, ge=0.0, le=60000.0)
    # collector-clock deadline after which a trace is flushed regardless
    telemetry_trace_timeout_s: float = _field(5.0, gt=0.0, le=600.0)
    telemetry_retain_traces: int = _field(256, ge=8, le=65536)
    # an OTLP/HTTP traces endpoint the kept traces are pushed to
    telemetry_otlp_url: Optional[str] = None

    def __post_init__(self) -> None:
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            value = _check(f, hints[f.name], getattr(self, f.name))
            object.__setattr__(self, f.name, value)
        telemetry = [a for a in (self.telemetry_addr, self.telemetry_collector_addr) if a]
        for addr in [self.engine_addr, *self.out_addr, *telemetry]:
            scheme = addr.split("://", 1)[0]
            if scheme not in PORTED_SCHEMES:
                raise SettingsError(
                    f"address {addr!r}: the {scheme}:// transport is not ported to "
                    f"detectmateservice_tpu_torch yet; use one of {PORTED_SCHEMES}")
        if self.watchdog_unhealthy_seconds < self.watchdog_stall_seconds:
            raise SettingsError(
                "watchdog_unhealthy_seconds must be >= watchdog_stall_seconds "
                f"({self.watchdog_unhealthy_seconds} < {self.watchdog_stall_seconds})")
        if self.rollout_enabled and not self.rollout_dir:
            raise SettingsError(
                "rollout_enabled requires rollout_dir (the versioned checkpoint store root)")
        if self.drift_enabled and not self.rollout_enabled:
            raise SettingsError(
                "drift_enabled requires rollout_enabled: the drift monitor reads the "
                "rollout traffic reservoir and pins its baseline in the rollout store")
        if self.telemetry_collector and not self.telemetry_collector_addr:
            raise SettingsError(
                "telemetry_collector requires telemetry_collector_addr "
                "(the address the collector listens for span frames on)")
        if self.telemetry_addr and not self.engine_trace:
            raise SettingsError(
                "telemetry_addr requires engine_trace: spans are built "
                "from the hop records the tracing path stamps")
        if not self.component_id:
            if self.component_name:
                seed = f"detectmate/{self.component_type}/{self.component_name}"
            else:
                seed = f"detectmate/{self.component_type}|{self.engine_addr}"
            self.component_id = uuid.uuid5(uuid.NAMESPACE_URL, seed).hex

    # -- loading -----------------------------------------------------------
    @classmethod
    def model_validate(cls, data: Mapping[str, Any]) -> "ServiceSettings":
        """Build from a mapping: every key must be a field of the port, or a
        field of an unported subsystem left at its default."""
        if not isinstance(data, Mapping):
            raise SettingsError(f"settings must be a mapping, got {type(data).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key in known:
                kwargs[key] = value
            elif key in UNPORTED:
                default, subsystem = UNPORTED[key]
                if value != default:
                    raise SettingsError(
                        f"{key}={value!r}: {subsystem} is not ported to "
                        f"detectmateservice_tpu_torch yet; leave {key} at its default "
                        f"({default!r})")
            else:
                raise SettingsError(f"unknown setting {key!r}")
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str) -> "ServiceSettings":
        """Load from YAML, apply environment overrides (env wins), validate.
        Exits the process on invalid settings, as the JAX CLI does."""
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = yaml.safe_load(fh) or {}
            if not isinstance(data, dict):
                raise SettingsError(f"settings file {path} must contain a mapping")
            return cls.model_validate(_deep_merge(data, _env_overrides()))
        except (OSError, yaml.YAMLError, SettingsError) as exc:
            print(f"Invalid service settings ({path}): {exc}", file=sys.stderr)
            raise SystemExit(1) from exc

    @classmethod
    def from_env(cls) -> "ServiceSettings":
        return cls.model_validate(_env_overrides())

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_BOOL_WORDS = {"0": False, "off": False, "f": False, "false": False, "n": False, "no": False,
               "1": True, "on": True, "t": True, "true": True, "y": True, "yes": True}


def _convert(name: str, tp: Any, value: Any) -> Any:
    """``value`` as the annotation ``tp`` wants it; a string (from the
    environment) converts to a number or a bool, an integral float to an
    int, an int to a float."""
    if typing.get_origin(tp) is typing.Union:
        if value is None:
            return None
        (tp,) = [a for a in typing.get_args(tp) if a is not type(None)]
    if typing.get_origin(tp) in (dict, Dict):
        if not isinstance(value, Mapping) or not all(isinstance(k, str) for k in value):
            raise SettingsError(f"{name}: expected a mapping of names to integers, "
                                f"got {value!r}")
        return {k: _convert(f"{name}.{k}", int, v) for k, v in value.items()}
    if typing.get_origin(tp) in (list, List):
        if not isinstance(value, (list, tuple)) or not all(isinstance(v, str) for v in value):
            raise SettingsError(f"{name}: expected a list of strings, got {value!r}")
        return list(value)
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.strip().lower() in _BOOL_WORDS:
            return _BOOL_WORDS[value.strip().lower()]
    elif tp is int:
        if isinstance(value, str):
            try:
                value = float(value) if "." in value or "e" in value.lower() else int(value)
            except ValueError:
                raise SettingsError(f"{name}: expected an integer, got {value!r}") from None
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
    elif tp is float:
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                raise SettingsError(f"{name}: expected a number, got {value!r}") from None
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
    elif tp is str:
        if isinstance(value, str):
            return value
    raise SettingsError(f"{name}: expected {getattr(tp, '__name__', tp)}, got {value!r}")


def _check(f: dataclasses.Field, tp: Any, value: Any) -> Any:
    value = _convert(f.name, tp, value)
    meta = f.metadata
    if value is None:
        return value
    if "ge" in meta and value < meta["ge"]:
        raise SettingsError(f"{f.name}={value!r} must be >= {meta['ge']}")
    if "gt" in meta and value <= meta["gt"]:
        raise SettingsError(f"{f.name}={value!r} must be > {meta['gt']}")
    if "le" in meta and value > meta["le"]:
        raise SettingsError(f"{f.name}={value!r} must be <= {meta['le']}")
    if "pattern" in meta and not re.match(meta["pattern"], value):
        raise SettingsError(f"{f.name}={value!r} must match {meta['pattern']}")
    if meta.get("addr"):
        try:
            for addr in (value if isinstance(value, list) else [value]):
                _validate_addr(addr)
        except ValueError as exc:
            raise SettingsError(f"{f.name}: {exc}") from None
    return value


def _env_overrides(environ: Optional[Mapping[str, str]] = None) -> Dict[str, Any]:
    """``DETECTMATE_*`` environment variables as a nested dict: ``__`` nests,
    and a value that starts with ``[`` or ``{`` is read as JSON."""
    environ = environ if environ is not None else os.environ
    out: Dict[str, Any] = {}
    for key, value in environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        path = key[len(ENV_PREFIX):].lower().split(ENV_NESTED_DELIMITER)
        parsed: Any = value
        stripped = value.strip()
        if stripped and stripped[0] in "[{":
            try:
                parsed = json.loads(stripped)
            except json.JSONDecodeError:
                parsed = value
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                break
        else:
            node[path[-1]] = parsed
    return out


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``override`` onto ``base``, override winning per field."""
    merged = dict(base)
    for key, value in override.items():
        if key in merged and isinstance(merged[key], dict) and isinstance(value, dict):
            merged[key] = _deep_merge(merged[key], value)
        else:
            merged[key] = value
    return merged
