"""Service: the control-plane core wrapping one Engine and one component.

The port's copy of ``LibraryComponentProcessor`` and ``Service`` of
``detectmateservice_tpu/core.py``. The Service owns an Engine and hands it a
processor that wraps the component with the service-level metrics; ``None``
from the component filters the message.

Lifecycle: ``run()`` starts the admin HTTP server, autostarts the engine and
parks until ``shutdown()``; ``start``/``stop`` wrap the Engine and flip
``engine_running``; ``reconfigure`` validates a new component config, applies
it to the running component and optionally persists it. Context-manager use
calls ``setup_io()`` on enter (the component builds its model there, and
restores ``checkpoint_dir`` when a checkpoint exists) and shuts down on exit;
a clean shutdown saves a checkpoint to ``checkpoint_dir``.

At load, the component gets the service's metric labels, health monitor and
metric factories, and a component with ``pending_count`` and
``drained_total`` gets the watchdog's ``device_inflight`` check. The
processor hands the engine the component's ``note_tenant``,
``drain_poll_ms`` and ``drain_due_in_ms`` (the coalescing detector's
seams). The process-wide
capture ledger (``engine/device_obs.py``) is bound to the service: its
identity, health plane (``xla_recompile_storm``, unless
``recompile_alert_enabled`` is off) and metric factories. A
component that cannot start (the torch detector without a CUDA device and
without ``device: cpu``) raises from ``setup_io``, and the Service does not
start. The admin plane reaches the component's device state only through
the engine's loop thread (``Engine.call_in_loop``).

The model lifecycle: with ``rollout_enabled`` a component with the
rollout seams (``install_candidate``) gets a ``RolloutManager`` (its thread,
its versioned store under ``rollout_dir``), with ``drift_enabled`` a
``DriftMonitor`` over the manager's reservoir and store, with
``capacity_enabled`` a component with ``set_capacity_tap`` a
``CapacityMonitor``; a component without the hooks gets a warning and no
subsystem. The threadless ``SloTracker`` serves ``GET /admin/slo``. These
threads reach the device through the detector's seams (``graphs.py`` says
how they serialize with the dispatch path). At teardown drift and capacity
stop first, then the manager, and only then the engine and the component.

Observability: with ``engine_trace`` the engine stamps hops and feeds its
flight recorder, which the health plane's events carry
(``HealthMonitor.trace_recorder``); with ``telemetry_collector`` the Service
builds a ``TelemetryCollector`` on its socket factory, starts it after the
lifecycle monitors (so it listens before any engine starts) and stops it
after the engine, so the exporters' final flushes still land. Profiler
captures (``utils/profiling.py``, ``/admin/profile``) are per process.

The JAX Service's shed, fault plans, compile cache and coordinator are not
ported (their settings raise in ``settings.py``).
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Type

from .config import ComponentLoader, ComponentResolver, ConfigClassLoader, ConfigManager
from .config.manager import ConfigError
from .engine import device_obs
from .engine import metrics as m
from .engine.engine import Engine, count_lines
from .engine.health import (
    EventLog,
    EventLogHandler,
    HealthMonitor,
    JsonLogFormatter,
    install_thread_excepthook,
    remove_excepthook_sink,
    set_build_info,
)
from .engine.socket import EngineSocketFactory, make_socket_factory
from .library.common.core import CoreComponent, CoreConfig
from .settings import ServiceSettings
from .web.server import WebServer

class ServiceError(Exception):
    pass


class LibraryComponentProcessor:
    """Wraps a CoreComponent with the service-level metrics; with no
    component it echoes its input."""

    def __init__(self, component: Optional[CoreComponent], labels: Dict[str, str]):
        self.component = component
        self._processed_b = m.DATA_PROCESSED_BYTES().labels(**labels)
        self._processed_l = m.DATA_PROCESSED_LINES().labels(**labels)
        self._duration = m.PROCESSING_DURATION().labels(**labels)
        self._batch_hist = m.BATCH_SIZE_HIST().labels(**labels)
        # the fused-frame contract only when the component has it, so the
        # engine's capability probe sees the truth through the adapter
        if callable(getattr(component, "process_frames", None)):
            self.process_frames = self._process_frames
        # the coalescing detector's seams: the tenant of each ingress frame,
        # and the short-poll tick its deadline needs
        if callable(getattr(component, "note_tenant", None)):
            self.note_tenant = component.note_tenant
        if callable(getattr(component, "drain_due_in_ms", None)):
            self.drain_due_in_ms = component.drain_due_in_ms

    @property
    def drain_poll_ms(self):
        """The component's short-poll hint, read when the engine loop starts
        (None without one)."""
        return getattr(self.component, "drain_poll_ms", None)

    def process(self, data: bytes) -> Optional[bytes]:
        self._processed_b.inc(len(data))
        self._processed_l.inc(count_lines(data))
        with self._duration.time():
            if self.component is None:
                return data
            return self.component.process(data)

    def process_batch(self, batch):
        """Batched dispatch; a component without ``process_batch`` gets one
        ``process`` call per message."""
        self._processed_b.inc(sum(map(len, batch)))
        self._processed_l.inc(sum(map(count_lines, batch)))
        self._batch_hist.observe(len(batch))
        with self._duration.time():
            if self.component is None:
                return list(batch)
            batch_fn = getattr(self.component, "process_batch", None)
            if callable(batch_fn):
                return batch_fn(batch)
            return [self.component.process(data) for data in batch]

    def _process_frames(self, frames):
        """Whole wire frames to the component → ``(outputs, n_messages,
        n_lines)``; bytes count wire bytes, lines the component's count."""
        self._processed_b.inc(sum(map(len, frames)))
        with self._duration.time():
            outs, n_msgs, n_lines = self.component.process_frames(frames)
        self._processed_l.inc(n_lines)
        self._batch_hist.observe(n_msgs)
        return outs, n_msgs, n_lines

    def flush(self):
        if self.component is None:
            return []
        flush_fn = getattr(self.component, "flush", None)
        return flush_fn() if callable(flush_fn) else []

    def pending_count(self) -> int:
        fn = getattr(self.component, "pending_count", None)
        return fn() if callable(fn) else 0

    def drain_ready(self):
        """Non-blocking drain of landed results; ``flush`` without the hook."""
        fn = getattr(self.component, "drain_ready", None)
        return fn() if callable(fn) else self.flush()

    def flush_final(self):
        """Stop-time drain, which may wait (a running fit)."""
        if self.component is None:
            return []
        final_fn = (getattr(self.component, "flush_final", None)
                    or getattr(self.component, "flush", None))
        return final_fn() if callable(final_fn) else []


class Service:
    def __init__(self, settings: ServiceSettings,
                 component_config: Optional[Dict[str, Any]] = None,
                 socket_factory: Optional[EngineSocketFactory] = None) -> None:
        self.settings = settings
        self.logger = self._setup_logging()
        # several processes: join the process group BEFORE any component
        # builds its device state; the import stays behind the check, as in
        # the JAX package
        if settings.coordinator_address or os.environ.get("DETECTMATE_COORDINATOR_ADDRESS"):
            from .parallel.distributed import initialize_from_settings

            initialize_from_settings(settings, self.logger)
        self._labels = dict(component_type=settings.component_type,
                            component_id=settings.component_id or "unknown")
        self._service_exit_event = threading.Event()
        self._teardown_lock = threading.Lock()
        self._torn_down = False
        self._ran = False

        self.events = EventLog(maxlen=settings.event_ring_size)
        self.health = HealthMonitor(
            dict(self._labels),
            stage=settings.trace_stage or settings.component_name or settings.component_type,
            stall_seconds=settings.watchdog_stall_seconds,
            unhealthy_seconds=settings.watchdog_unhealthy_seconds,
            interval_s=settings.watchdog_interval_s,
            recovery_intervals=settings.watchdog_recovery_intervals,
            ingest_stall_seconds=settings.watchdog_ingest_stall_seconds,
            events=self.events, logger=self.logger)
        # a re-created Service of the same identity reuses the logger: a
        # stale ring handler is replaced, not accumulated
        for handler in list(self.logger.handlers):
            if isinstance(handler, EventLogHandler):
                self.logger.removeHandler(handler)
        self.logger.addHandler(EventLogHandler(self.events))
        self._excepthook_sink = install_thread_excepthook(self.logger, self.events)
        set_build_info()

        self.web_server = WebServer(self)

        self._component_path: Optional[str] = None
        if settings.component_type and settings.component_type != "core":
            resolver = ComponentResolver(logger=self.logger)
            self._component_path, config_class_path = resolver.resolve(settings.component_type)
            if not settings.component_config_class and config_class_path:
                settings.component_config_class = config_class_path

        self.config_manager: Optional[ConfigManager] = None
        if settings.config_file:
            self.config_manager = ConfigManager(settings.config_file, self.get_config_schema(),
                                                logger=self.logger)
            try:
                component_config = self.config_manager.load()
            except ConfigError as exc:
                raise ServiceError(f"cannot load component config: {exc}") from exc

        self.library_component: Optional[CoreComponent] = None
        if self._component_path:
            loader = ComponentLoader(logger=self.logger)
            self.library_component = loader.load_component(self._component_path,
                                                           component_config)
            component = self.library_component
            component.metrics_labels = dict(self._labels)
            component.health_monitor = self.health
            component.metrics = m
            pending_fn = getattr(component, "pending_count", None)
            drained_fn = getattr(component, "drained_total", None)
            if callable(pending_fn) and callable(drained_fn):
                self.health.register_progress("device_inflight", pending_fn, drained_fn)

        self.processor = LibraryComponentProcessor(self.library_component, self._labels)
        self.engine = Engine(settings, self.processor, socket_factory, self.logger,
                             health=self.health)
        self.health.trace_recorder = self.engine.trace_recorder
        # the process-wide capture ledger takes this service's identity,
        # health plane and metric factories: an unexpected recompile lands in
        # the event ring, the xla_recompile_storm check and the scorer_xla_*
        # series under its labels
        device_obs.get_ledger().bind(
            labels=dict(self._labels), monitor=self.health,
            emit_events=settings.recompile_alert_enabled,
            register_check=settings.recompile_alert_enabled, metrics=m)
        if settings.watchdog_enabled:
            self.health.start()
        self._start_lifecycle()
        self.telemetry = None
        if settings.telemetry_collector:
            from .telemetry import TelemetryCollector

            factory = socket_factory or make_socket_factory(settings.transport_backend,
                                                            self.logger)
            self.telemetry = TelemetryCollector(settings, factory, labels=dict(self._labels),
                                                monitor=self.health, logger=self.logger)
            self.telemetry.start()
            self.logger.info("telemetry collector listening on %s (healthy sample ratio "
                             "%.3f, SLO %.0f ms)", settings.telemetry_collector_addr,
                             settings.telemetry_sample_healthy_ratio, settings.telemetry_slo_ms)

        self._running_metric = m.ENGINE_RUNNING().labels(**self._labels)
        self._starts_metric = m.ENGINE_STARTS().labels(**self._labels)
        self._running_metric.state("stopped")

    def _start_lifecycle(self) -> None:
        """The rollout manager, the drift and capacity monitors (each only
        when enabled, and only for a component with the hooks), and the SLO
        tracker."""
        settings, component = self.settings, self.library_component
        self.rollout = None
        if settings.rollout_enabled:
            if callable(getattr(component, "install_candidate", None)):
                from .rollout import RolloutManager

                self.rollout = RolloutManager(component, settings, labels=dict(self._labels),
                                              monitor=self.health, logger=self.logger)
                self.rollout.start()
            else:
                self.logger.warning(
                    "rollout_enabled but component %r has no rollout hooks; "
                    "model lifecycle disabled for this stage", settings.component_type)
        self.drift = None
        self.capacity = None
        if settings.drift_enabled and self.rollout is not None:
            from .obs import DriftMonitor

            self.drift = DriftMonitor(settings, sampler=self.rollout.sampler,
                                      store=self.rollout.store, rollout=self.rollout,
                                      labels=dict(self._labels), monitor=self.health,
                                      logger=self.logger)
            self.drift.start()
        if settings.capacity_enabled:
            if callable(getattr(component, "set_capacity_tap", None)):
                from .obs import CapacityMonitor

                self.capacity = CapacityMonitor(component, settings, labels=dict(self._labels),
                                                logger=self.logger)
                self.capacity.start()
            else:
                self.logger.warning(
                    "capacity_enabled but component %r has no capacity tap; "
                    "capacity model disabled for this stage", settings.component_type)
        from .obs import SloTracker

        self.slo = SloTracker()

    # ------------------------------------------------------------------
    def get_config_schema(self) -> Type[CoreConfig]:
        """The component's config class, or CoreConfig."""
        path = self.settings.component_config_class
        if path:
            try:
                return ConfigClassLoader(logger=self.logger).load_config_class(path)
            except (ImportError, AttributeError, RuntimeError) as exc:
                self.logger.warning("cannot load config class %s: %s", path, exc)
        return CoreConfig

    # -- lifecycle ------------------------------------------------------
    def setup_io(self) -> None:
        """The component builds its model (and kernels) here; with
        ``checkpoint_dir`` set and a checkpoint present, its state is
        restored."""
        if self.library_component is not None:
            self.library_component.setup_io()
            self._maybe_restore_checkpoint()
        self.logger.info("setup_io: ready to process messages")

    def _maybe_restore_checkpoint(self) -> None:
        directory = self.settings.checkpoint_dir
        load_fn = getattr(self.library_component, "load_checkpoint", None)
        if not directory or not callable(load_fn):
            return
        if not (Path(directory) / "meta.json").exists():
            self.logger.info("checkpoint_dir %s has no checkpoint yet; starting fresh",
                             directory)
            return
        try:
            load_fn(directory)
        except Exception as exc:
            # a present but unloadable checkpoint is the operator's problem:
            # starting fresh would discard the calibration they kept
            raise ServiceError(f"cannot restore checkpoint from {directory}: {exc}") from exc
        self.logger.info("component state restored from %s", directory)

    def checkpoint(self) -> Dict[str, Any]:
        """Save the component's state to ``checkpoint_dir`` (admin verb, and
        at clean shutdown), on the engine's loop thread while it runs."""
        directory = self.settings.checkpoint_dir
        if not directory:
            raise ServiceError("no checkpoint_dir configured (settings.checkpoint_dir)")
        save_fn = getattr(self.library_component, "save_checkpoint", None)
        if not callable(save_fn):
            raise ServiceError("component does not support checkpointing "
                               "(no save_checkpoint hook)")
        self.engine.call_in_loop(lambda: save_fn(directory))
        self.logger.info("component state checkpointed to %s", directory)
        return {"checkpoint": "saved", "directory": directory}

    def run(self) -> None:
        """Admin server up, engine (auto)started, park until shutdown."""
        self._ran = True
        device = getattr(self.library_component, "device", None)
        if getattr(device, "type", None) == "cuda":
            # Kineto initialized on the thread that registered it, before
            # any /admin/profile capture starts on a thread of its own
            from .utils.profiling import PROFILER

            t0 = time.monotonic()
            if PROFILER.init_on_this_thread(device):
                self.logger.info("profiler initialized on the main thread in %.3f s",
                                 time.monotonic() - t0)
        self.web_server.start()
        # the port that bound: with http_port 0 the operator finds it here
        self.logger.info("HTTP Admin active at %s:%s", self.settings.http_host,
                         self.web_server.port)
        try:
            if self.settings.engine_autostart:
                self.logger.info("Auto-starting engine...")
                self.start()
            self._service_exit_event.wait()
        finally:
            self._teardown()

    def start(self) -> str:
        result = self.engine.start()
        self._starts_metric.inc()
        self._running_metric.state("running")
        return result

    def stop(self) -> None:
        self.engine.stop()
        self._running_metric.state("stopped")

    def shutdown(self) -> None:
        self._service_exit_event.set()

    def _teardown(self, save: bool = True) -> None:
        with self._teardown_lock:
            if self._torn_down:
                return
            self._torn_down = True
        # drift may be inside a cycle of the manager and capacity holds a
        # tap into the detector: both quiesce before what they observe, and
        # the manager before the engine releases the device
        for monitor, what in ((self.drift, "drift"), (self.capacity, "capacity"),
                              (self.rollout, "rollout")):
            if monitor is not None:
                try:
                    monitor.stop()
                except Exception as exc:  # noqa: BLE001 — teardown goes on
                    self.logger.error("%s stop failed: %s", what, exc)
        try:
            self.stop()
        except Exception as exc:  # noqa: BLE001 — teardown goes on
            self.logger.error("engine stop during teardown failed: %s", exc)
        # after the engine: the exporters' final flushes still land, and the
        # collector's last pump flushes its own assembly tail
        if self.telemetry is not None:
            try:
                self.telemetry.stop()
            except Exception as exc:  # noqa: BLE001 — teardown goes on
                self.logger.error("telemetry collector stop failed: %s", exc)
        # the shutdown checkpoint: after the final flush landed, before the
        # component releases its state
        if (save and self.settings.checkpoint_dir and self.library_component is not None
                and callable(getattr(self.library_component, "save_checkpoint", None))):
            try:
                self.checkpoint()
            except Exception as exc:  # noqa: BLE001 — teardown goes on
                self.logger.error("shutdown checkpoint failed: %s", exc)
        if self.library_component is not None:
            try:
                self.library_component.teardown()
            except Exception as exc:  # noqa: BLE001 — teardown goes on
                self.logger.error("component teardown failed: %s", exc)
        self.health.stop()
        remove_excepthook_sink(self._excepthook_sink)
        self.web_server.stop()
        self.logger.info("service shut down")

    # -- admin verbs ----------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The status report: the JAX package's keys; the ``distributed``
        block is this process's place among the processes
        (``parallel/distributed.py``, importless without a coordinator)."""
        from .parallel.distributed import process_info

        return {
            "status": {
                "component_type": self.settings.component_type,
                "component_id": self.settings.component_id,
                "running": self.engine.running,
                "health": self.health.state,
            },
            "distributed": process_info(),
            "settings": self.settings.to_dict(),
            "configs": self.config_manager.get() if self.config_manager else {},
        }

    def reconfigure(self, config_data: Dict[str, Any], persist: bool = False) -> Dict[str, Any]:
        """Validate and apply a new component config, optionally persisted.
        The component applies it first: a change it refuses reaches neither
        the manager nor the file."""
        if self.config_manager is None:
            raise ServiceError("no config manager: service was started without config_file")
        if not config_data:
            return self.config_manager.get()
        hook = getattr(self.library_component, "reconfigure", None)
        if callable(hook):
            try:
                validated = self.config_manager.validate(config_data)
                self.engine.call_in_loop(lambda: hook(validated))
                self.logger.info("component reconfigured in place")
            except Exception as exc:
                self.logger.error("component reconfigure rejected: %s", exc)
                raise ServiceError(f"component rejected reconfigure: {exc}") from exc
        else:
            self.logger.warning(
                "component has no reconfigure hook; running instance keeps its old config")
        updated = self.config_manager.update(config_data)
        if persist:
            self.config_manager.save()
        return updated

    # -- context manager ------------------------------------------------
    def __enter__(self) -> "Service":
        try:
            self.setup_io()
        except BaseException:
            self._teardown(save=False)  # nothing was set up to save
            raise
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        if not self._ran:
            # run() never parked: release what construction started
            self._teardown()

    # -- logging --------------------------------------------------------
    def _setup_logging(self) -> logging.Logger:
        name = f"{self.settings.component_type}.{self.settings.component_id}"
        logger = logging.getLogger(name)
        logger.setLevel(self.settings.log_level.upper())
        logger.propagate = False
        have = {type(h).__name__ + getattr(h, "_dm_tag", "") for h in logger.handlers}
        if self.settings.log_format == "json":
            fmt: logging.Formatter = JsonLogFormatter(static=dict(
                component_type=self.settings.component_type,
                component_id=self.settings.component_id or "unknown"))
        else:
            fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(name)s: %(message)s")
        if self.settings.log_to_console and "StreamHandlerconsole" not in have:
            console = logging.StreamHandler(sys.__stdout__)
            console.setFormatter(fmt)
            console._dm_tag = "console"  # type: ignore[attr-defined]
            logger.addHandler(console)
        else:
            # a reused logger follows this settings' log_format
            for handler in logger.handlers:
                if getattr(handler, "_dm_tag", "") in ("console", "file"):
                    handler.setFormatter(fmt)
        if self.settings.log_to_file and "FileHandlerfile" not in have:
            log_dir = Path(self.settings.log_dir)
            try:
                log_dir.mkdir(parents=True, exist_ok=True)
                file_handler = logging.FileHandler(
                    log_dir / f"{self.settings.component_type.replace('.', '_')}_"
                              f"{self.settings.component_id}.log",
                    delay=True)
                file_handler.setFormatter(fmt)
                file_handler._dm_tag = "file"  # type: ignore[attr-defined]
                logger.addHandler(file_handler)
            except OSError as exc:
                logger.warning("cannot attach file handler: %s", exc)
        return logger
