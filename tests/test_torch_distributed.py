"""The port's multi-process bootstrap (``parallel/distributed.py``) against
the JAX package's (``tests/test_distributed.py``'s counterparts): the
no-coordinator no-op, where the coordinates come from (settings or env,
decided by the coordinator's source), the env layer reaching the settings
fields, a real one-process group in a subprocess, and a two-process gloo
``all_reduce`` over a localhost coordinator."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from detectmateservice_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parent.parent
_ENV = dict(PYTHONPATH=str(REPO), PATH="/usr/bin:/bin", HOME="/tmp",
            CUDA_VISIBLE_DEVICES="")


@pytest.fixture()
def captured(monkeypatch):
    """``init_process_group`` replaced by a recorder; the module's latch
    cleared before and after."""
    calls = {}

    def fake_init(backend, init_method, world_size, rank):
        calls.update(backend=backend, addr=init_method, n=world_size, pid=rank)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setattr(distributed, "_initialized", False)
    yield calls
    monkeypatch.setattr(distributed, "_initialized", False)


def test_no_coordinator_is_a_noop(monkeypatch):
    from detectmateservice_tpu.parallel import distributed as jax_distributed

    monkeypatch.delenv("DETECTMATE_COORDINATOR_ADDRESS", raising=False)
    assert jax_distributed.initialize_from_settings(settings=None) is False
    assert distributed.initialize_from_settings(settings=None) is False
    assert distributed.process_info() == jax_distributed.process_info() == {
        "initialized": False, "process_index": 0, "process_count": 1, "local_devices": None}


def test_settings_coordinator_uses_settings_coords(monkeypatch, captured):
    """A settings-borne coordinator takes every coordinate from the
    settings: env coordinates must not half-apply."""
    monkeypatch.setenv("DETECTMATE_COORDINATOR_ADDRESS", "env-host:1")
    monkeypatch.setenv("DETECTMATE_NUM_PROCESSES", "9")

    class S:
        coordinator_address = "settings-host:2"
        num_processes = 4
        process_id = 3

    assert distributed.initialize_from_settings(S(), device_type="cpu") is True
    assert captured == {"backend": "gloo", "addr": "tcp://settings-host:2", "n": 4, "pid": 3}
    assert distributed.initialize_from_settings(S()) is True   # idempotent
    assert len(captured) == 4


def test_env_coordinator_uses_env_coords(monkeypatch, captured):
    """An env-borne coordinator takes the coordinates from the env too (the
    settings' 1/0 defaults cannot say 'unset'); a CUDA component gets NCCL."""
    from detectmateservice_tpu_torch.settings import ServiceSettings

    monkeypatch.setenv("DETECTMATE_COORDINATOR_ADDRESS", "10.0.0.9:8476")
    monkeypatch.setenv("DETECTMATE_NUM_PROCESSES", "2")
    monkeypatch.setenv("DETECTMATE_PROCESS_ID", "1")
    settings = ServiceSettings(engine_addr="inproc://dist-env")
    assert distributed.initialize_from_settings(settings, device_type="cuda") is True
    assert captured == {"backend": "nccl", "addr": "tcp://10.0.0.9:8476", "n": 2, "pid": 1}


def test_env_vars_reach_settings_fields_via_env_layer(monkeypatch, tmp_path):
    """The documented env names are the fields' names: the DETECTMATE_* env
    merge fills them in both packages alike, the mesh shape too."""
    from detectmateservice_tpu.settings import ServiceSettings as RefSettings
    from detectmateservice_tpu_torch.settings import ServiceSettings

    monkeypatch.setenv("DETECTMATE_COORDINATOR_ADDRESS", "10.1.2.3:777")
    monkeypatch.setenv("DETECTMATE_NUM_PROCESSES", "4")
    monkeypatch.setenv("DETECTMATE_PROCESS_ID", "2")
    monkeypatch.setenv("DETECTMATE_MESH_SHAPE", '{"data": 2, "seq": 4}')
    path = tmp_path / "s.yaml"
    path.write_text("engine_addr: inproc://dist-yaml\n")
    port, ref = ServiceSettings.from_yaml(str(path)), RefSettings.from_yaml(str(path))
    for field in ("coordinator_address", "num_processes", "process_id", "mesh_shape"):
        assert getattr(port, field) == getattr(ref, field), field
    assert (port.coordinator_address, port.num_processes, port.process_id) == \
        ("10.1.2.3:777", 4, 2)
    assert port.mesh_shape == {"data": 2, "seq": 4}


_ONE_PROCESS_CHILD = r"""
import sys
import torch
import torch.distributed as dist
from detectmateservice_tpu_torch.parallel import distributed, make_mesh

class S:
    coordinator_address = f"127.0.0.1:{sys.argv[1]}"
    num_processes = 1
    process_id = 0

assert distributed.initialize_from_settings(S(), device_type="cpu") is True
info = distributed.process_info()
assert info["initialized"] and info["process_count"] == 1 and info["process_index"] == 0, info
t = torch.tensor([3.0])
dist.all_reduce(t)
assert float(t) == 3.0
mesh = make_mesh({"data": 1}, device_type="cpu")   # a group of one takes a mesh
dist.destroy_process_group()
print("ONE_PROCESS_OK")
"""


def test_real_single_process_group(free_port, tmp_path):
    """A real gloo group of one over a localhost coordinator, in a
    subprocess so this process keeps no group: process_info reports it and
    a mesh of this process's devices still builds."""
    script = tmp_path / "one.py"
    script.write_text(_ONE_PROCESS_CHILD)
    result = subprocess.run([sys.executable, str(script), str(free_port)],
                            capture_output=True, text=True, timeout=60, env=_ENV)
    assert "ONE_PROCESS_OK" in result.stdout, result.stderr[-1500:]


_TWO_PROCESS_CHILD = r"""
import os, sys
import torch
import torch.distributed as dist
from detectmateservice_tpu_torch.parallel import distributed, make_mesh

pid, port = int(sys.argv[1]), sys.argv[2]
# one child takes the coordinator from settings, the other from the env:
# both sources of initialize_from_settings in one real bootstrap
if pid == 0:
    class S:
        coordinator_address = f"127.0.0.1:{port}"
        num_processes = 2
        process_id = 0
    assert distributed.initialize_from_settings(S(), device_type="cpu") is True
else:
    os.environ["DETECTMATE_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["DETECTMATE_NUM_PROCESSES"] = "2"
    os.environ["DETECTMATE_PROCESS_ID"] = "1"
    assert distributed.initialize_from_settings(None, device_type="cpu") is True
info = distributed.process_info()
assert info["process_count"] == 2 and info["process_index"] == pid, info
t = torch.tensor([float(pid + 1)])
dist.all_reduce(t)
assert float(t) == 3.0, t          # 1 (process 0) + 2 (process 1)
try:
    make_mesh({"data": 1}, device_type="cpu")
    raise AssertionError("a mesh under a group of two must be refused")
except ValueError as exc:
    assert "ROADMAP.md" in str(exc), exc
dist.destroy_process_group()
print(f"TWO_PROCESS_OK pid={pid}")
"""


def test_two_process_all_reduce_over_localhost(free_port, tmp_path):
    """Two processes join one gloo group over a localhost coordinator and
    an all_reduce sees both; a mesh spanning them is refused, naming the
    ROADMAP.md item that lifts it."""
    script = tmp_path / "two.py"
    script.write_text(_TWO_PROCESS_CHILD)
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), str(free_port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_ENV) for pid in (0, 1)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=90))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    for pid, (out, err) in enumerate(outs):
        assert f"TWO_PROCESS_OK pid={pid}" in out, err[-1500:]
