"""chip_smoke.py's refusals: without a CUDA device, and without the repo
around it, it exits non-zero and prints no result line. Its pieces that do
not need the card are checked on the CPU."""
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the script lives at the repo root)


def _run(cwd, *env_pairs):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", **dict(env_pairs)}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, check=False)


def test_without_a_cuda_device_it_fails_and_prints_no_result():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_messages_match_bench_generator():
    """The script's copy of bench.py's make_messages gives the same bytes."""
    import bench

    msgs, anomalies = chip_smoke.make_messages(300, anomaly_rate=0.05, seed=4)
    assert msgs == bench.make_messages(300, anomaly_rate=0.05, seed=4)
    assert anomalies and all(b"segfault" in msgs[int(i)] for i in anomalies)


def test_bound_picks_the_larger_of_bytes_and_operations():
    ms, by = chip_smoke.lse_bound(16384, 32768, 128, torch.bfloat16)
    assert by == "operations"
    assert abs(ms - 2 * 16384 * 32768 * 128 / 989e12 * 1e3) < 1e-9
    ms, by = chip_smoke.lse_bound(1, 32768, 128, torch.bfloat16)
    assert by == "bytes"
    assert abs(ms - ((1 + 32768) * 128 * 2 + 4) / 3.35e12 * 1e3) < 1e-12
