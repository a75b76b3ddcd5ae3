"""The port's ``ServiceSettings`` against the JAX package's: the same YAML and
environment give equal values on every field the port keeps; every field of
an unported subsystem raises ``SettingsError`` naming itself when set away
from its default; bad addresses and out-of-bound values raise in both."""
import dataclasses

import pytest
import yaml

from detectmateservice_tpu.settings import ServiceSettings as RefSettings
from detectmateservice_tpu_torch.settings import UNPORTED, ServiceSettings, SettingsError

KEPT = sorted(f.name for f in dataclasses.fields(ServiceSettings))

# a YAML that moves every kept field the environment below does not
YAML = {
    "component_name": "detector-a", "component_type": "detectors.torch_scorer.X",
    "component_config_class": "detectors.torch_scorer.XConfig",
    "log_level": "DEBUG", "log_dir": "/tmp/dm-logs", "log_to_console": False,
    "log_to_file": False, "log_format": "json",
    "engine_addr": "ipc:///tmp/dm-a.ipc", "engine_autostart": False,
    "engine_recv_timeout": 50, "engine_retry_count": 3, "engine_buffer_size": 1000,
    "engine_batch_size": 16384, "engine_batch_timeout_ms": 5,
    "engine_frame_autodetect": False,
    "out_addr": ["ipc:///tmp/dm-b.ipc", "tcp://127.0.0.1:5555"], "out_dial_timeout": 10,
    "out_backpressure": "block", "out_stop_drain_ms": 100, "send_batch_max": 8,
    "transport_backend": "zmq", "http_host": "0.0.0.0",
    "config_file": "/tmp/c.yaml", "checkpoint_dir": "/tmp/ckpt", "dlq_max_attempts": 5,
    "watchdog_enabled": False, "watchdog_interval_s": 0.5, "watchdog_stall_seconds": 2,
    "watchdog_unhealthy_seconds": 4.0, "watchdog_recovery_intervals": 3,
    "watchdog_ingest_stall_seconds": 1.5, "event_ring_size": 64,
    "recompile_alert_enabled": False,
    "rollout_enabled": True, "rollout_dir": "/tmp/dm-store", "rollout_interval_s": 30,
    "rollout_sample_ratio": 0.5, "rollout_sample_capacity": 512, "rollout_min_fit_rows": 32,
    "rollout_train_epochs": 2, "rollout_min_shadow_samples": 64,
    "rollout_shadow_timeout_s": 60, "rollout_max_mean_delta": 0.5,
    "rollout_max_flip_ratio": 0.05, "rollout_auto_promote": False,
    "rollout_keep_checkpoints": 8, "drift_enabled": True, "drift_interval_s": 0.5,
    "drift_baseline_size": 256, "drift_min_rows": 16, "drift_ks_threshold": 0.3,
    "drift_psi_threshold": 0.4, "drift_feature_psi_threshold": 0.5,
    "drift_trigger_intervals": 2, "drift_clear_intervals": 3,
    "drift_min_cycle_interval_s": 0, "capacity_enabled": True, "capacity_interval_s": 0.5,
    "capacity_probe_rows": 128, "capacity_probe_idle_s": 1, "capacity_window_s": 10,
    "engine_trace": True, "trace_stage": "scorer", "trace_terminal": True,
    "trace_observe_e2e": True, "trace_slowest": 8, "trace_sampled": 16,
    "trace_sample_every": 4, "profile_dir": "/tmp/dm-profiles", "profile_max_captures": 2,
    "telemetry_addr": "ipc:///tmp/dm-tel.ipc", "telemetry_queue_size": 64,
    "telemetry_flush_interval_ms": 10, "telemetry_collector": True,
    "telemetry_collector_addr": "ipc:///tmp/dm-tel.ipc",
    "telemetry_sample_healthy_ratio": 0.5, "telemetry_slo_ms": 250,
    "telemetry_settle_ms": 50, "telemetry_trace_timeout_s": 2, "telemetry_retain_traces": 32,
    "telemetry_otlp_url": "http://127.0.0.1:4318/v1/traces",
    "mesh_shape": {"data": 2, "seq": 4}, "coordinator_address": "10.0.0.9:8476",
    "num_processes": 2, "process_id": 1,
    # unported subsystems at their defaults are accepted
    "router_replicas": [], "shed_enabled": False,
}
ENV = {"DETECTMATE_HTTP_PORT": "0", "DETECTMATE_ENGINE_FRAME_BATCH": "8",
       "DETECTMATE_COMPONENT_ID": "abc123"}


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    path = tmp_path_factory.mktemp("settings") / "s.yaml"
    path.write_text(yaml.safe_dump(YAML))
    with pytest.MonkeyPatch.context() as mp:
        for key, value in ENV.items():
            mp.setenv(key, value)
        return RefSettings.from_yaml(str(path)), ServiceSettings.from_yaml(str(path))


def test_every_jax_field_is_kept_or_unported_with_the_same_default():
    assert set(KEPT) | set(UNPORTED) == set(RefSettings.model_fields)
    assert not set(KEPT) & set(UNPORTED)
    for name, info in RefSettings.model_fields.items():
        default = info.default_factory() if info.default_factory else info.default
        if name in UNPORTED:
            assert UNPORTED[name][0] == default, name
        else:
            field = {f.name: f for f in dataclasses.fields(ServiceSettings)}[name]
            port_default = (field.default_factory() if field.default_factory
                            is not dataclasses.MISSING else field.default)
            assert port_default == default, name


@pytest.mark.parametrize("field", KEPT)
def test_yaml_and_environment_give_equal_values(loaded, field):
    ref, port = loaded
    assert getattr(port, field) == getattr(ref, field)
    assert type(getattr(port, field)) is type(getattr(ref, field))


def test_the_yaml_moves_every_kept_field(loaded):
    ref, _ = loaded
    moved = {f for f in KEPT if getattr(ref, f) != getattr(RefSettings(), f)}
    assert moved == set(KEPT)


def test_defaults_and_component_id_equal():
    for kw in ({}, {"component_name": "x"}, {"engine_addr": "ipc:///tmp/other.ipc"}):
        ref, port = RefSettings(**kw), ServiceSettings(**kw)
        assert all(getattr(port, f) == getattr(ref, f) for f in KEPT)


def _away_from(default):
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    if isinstance(default, list):
        return ["ipc:///tmp/x.ipc"]
    if isinstance(default, str):
        return default + "-x"
    return "set"


@pytest.mark.parametrize("field", sorted(UNPORTED))
def test_unported_field_raises_naming_itself(field):
    default, subsystem = UNPORTED[field]
    assert ServiceSettings.model_validate({field: default}) == ServiceSettings()
    with pytest.raises(SettingsError, match=field) as err:
        ServiceSettings.model_validate({field: _away_from(default)})
    assert "not ported" in str(err.value) and subsystem in str(err.value)


def test_unknown_field_raises():
    with pytest.raises(SettingsError, match="unknown setting 'no_such_field'"):
        ServiceSettings.model_validate({"no_such_field": 1})


@pytest.mark.parametrize("addr", ["no-scheme", "foo://x", "ipc://", "tcp://host",
                                  "tls+tcp://host", "ws://host"])
@pytest.mark.parametrize("field", ["engine_addr", "out_addr"])
def test_bad_addresses_raise_in_both(field, addr):
    value = [addr] if field == "out_addr" else addr
    with pytest.raises(ValueError):
        RefSettings(**{field: value})
    with pytest.raises(SettingsError, match=field):
        ServiceSettings(**{field: value})


@pytest.mark.parametrize("addr", ["tls+tcp://127.0.0.1:5", "nng+tcp://127.0.0.1:5",
                                  "nng+tls+tcp://127.0.0.1:5", "ws://127.0.0.1:5"])
def test_addresses_of_unported_transports_raise(addr):
    with pytest.raises(SettingsError, match="not ported"):
        ServiceSettings(out_addr=[addr])
    with pytest.raises(SettingsError, match="not ported"):
        ServiceSettings(engine_addr=addr)


@pytest.mark.parametrize("kw", [
    {"http_port": 70000}, {"engine_batch_size": 0}, {"engine_batch_size": 16385},
    {"engine_recv_timeout": 0}, {"out_backpressure": "wait"}, {"log_format": "xml"},
    {"transport_backend": "nng"}, {"watchdog_interval_s": 0.01}, {"event_ring_size": 4},
    {"watchdog_stall_seconds": 10.0, "watchdog_unhealthy_seconds": 5.0},
    {"engine_autostart": "maybe"}, {"component_type": 3}])
def test_out_of_bounds_values_raise_in_both(kw):
    with pytest.raises(ValueError):
        RefSettings(**kw)
    with pytest.raises(SettingsError):
        ServiceSettings(**kw)


def test_environment_values_convert_to_the_field_type(monkeypatch):
    monkeypatch.setenv("DETECTMATE_ENGINE_BATCH_SIZE", "16")
    monkeypatch.setenv("DETECTMATE_OUT_ADDR", '["ipc:///tmp/a.ipc"]')
    monkeypatch.setenv("DETECTMATE_LOG_TO_FILE", "false")
    monkeypatch.setenv("DETECTMATE_ENGINE_BATCH_TIMEOUT_MS", "7")
    ref, port = RefSettings.from_env(), ServiceSettings.from_env()
    for field in ("engine_batch_size", "out_addr", "log_to_file", "engine_batch_timeout_ms"):
        assert getattr(port, field) == getattr(ref, field)
    assert port.engine_batch_timeout_ms == 7.0 and isinstance(port.engine_batch_timeout_ms, float)


def test_from_yaml_exits_on_an_unported_setting(tmp_path, capsys):
    path = tmp_path / "s.yaml"
    path.write_text(yaml.safe_dump({"durable_ingress": True, "wal_dir": "/tmp/w"}))
    with pytest.raises(SystemExit) as err:
        ServiceSettings.from_yaml(str(path))
    assert err.value.code == 1
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [
    {"trace_slowest": 0}, {"trace_slowest": 1025}, {"trace_sampled": 0},
    {"trace_sampled": 8193}, {"trace_sample_every": 0}, {"profile_max_captures": 0},
    {"profile_max_captures": 65}, {"telemetry_queue_size": 15},
    {"telemetry_queue_size": 1048577}, {"telemetry_flush_interval_ms": 0.5},
    {"telemetry_flush_interval_ms": 10001}, {"telemetry_sample_healthy_ratio": -0.1},
    {"telemetry_sample_healthy_ratio": 1.5}, {"telemetry_slo_ms": 0},
    {"telemetry_settle_ms": -1}, {"telemetry_settle_ms": 60001},
    {"telemetry_trace_timeout_s": 0}, {"telemetry_trace_timeout_s": 601},
    {"telemetry_retain_traces": 7}, {"telemetry_retain_traces": 65537},
    {"engine_trace": True, "telemetry_addr": "tcp://host"},
    {"engine_trace": "sometimes"}, {"trace_terminal": "maybe"}])
def test_observability_bounds_raise_in_both(kw):
    with pytest.raises(ValueError):
        RefSettings(**kw)
    with pytest.raises(SettingsError):
        ServiceSettings(**kw)


@pytest.mark.parametrize("kw,needs", [
    ({"telemetry_addr": "ipc:///tmp/tel.ipc"}, "engine_trace"),
    ({"telemetry_collector": True}, "telemetry_collector_addr")])
def test_telemetry_cross_checks_raise_in_both(kw, needs):
    with pytest.raises(ValueError, match=needs):
        RefSettings(**kw)
    with pytest.raises(SettingsError, match=needs):
        ServiceSettings(**kw)
    fixed = dict(kw, **({"engine_trace": True} if needs == "engine_trace"
                        else {"telemetry_collector_addr": "ipc:///tmp/tel.ipc"}))
    ref, port = RefSettings(**fixed), ServiceSettings(**fixed)
    assert all(getattr(port, f) == getattr(ref, f) for f in KEPT if f != "component_id")


@pytest.mark.parametrize("addr", ["tls+tcp://127.0.0.1:5", "nng+tcp://127.0.0.1:5"])
def test_telemetry_addresses_of_unported_transports_raise(addr):
    with pytest.raises(SettingsError, match="not ported"):
        ServiceSettings(engine_trace=True, telemetry_addr=addr)
    with pytest.raises(SettingsError, match="not ported"):
        ServiceSettings(telemetry_collector=True, telemetry_collector_addr=addr)
