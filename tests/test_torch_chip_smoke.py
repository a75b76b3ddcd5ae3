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


def test_flash_bound_counts_operations_and_bytes():
    """Forward 4, dQ 6, dK/dV 8 · BH·S·T·D operations; at the LogBERT shapes
    the operations bound each kernel."""
    b, h, s, t, d = chip_smoke.FLASH_SCORING
    ms, by, ops = chip_smoke.flash_bound("forward", b, h, s, t, d, torch.bfloat16)
    assert by == "operations" and ops == 4.0 * b * h * s * t * d
    assert abs(ms - ops / 989e12 * 1e3) < 1e-12
    b, h, s, t, d = chip_smoke.FLASH_TRAINING
    for kind, factor in (("dq", 6.0), ("dkv", 8.0)):
        ms, by, ops = chip_smoke.flash_bound(kind, b, h, s, t, d, torch.bfloat16)
        assert by == "operations" and ops == factor * b * h * s * t * d
    # one query against one key: the bytes bound it
    ms, by, _ = chip_smoke.flash_bound("forward", 1, 1, 1, 1, 64, torch.float32)
    assert by == "bytes"
    assert abs(ms - (4 * 64 * 4 + 4) / 3.35e12 * 1e3) < 1e-15


def test_logbert_launch_counts_follow_the_fit():
    """512 training messages in steps of 32 over max(4, ceil(100 / 16)) = 7
    epochs: 112 steps, 16 calibration chunks, 4 layers."""
    want = chip_smoke.logbert_expected_launches(device_batches=16)
    assert want["train_steps"] == 112 and want["calibration_chunks"] == 16
    assert want["flash_forward"] == (112 + 16 + 16) * 4
    assert want["flash_dq"] == want["flash_dkv"] == 112 * 4
    assert want["candidate_lse"] == 16 + 16
    cfg = chip_smoke.LOGBERT_CONFIG
    assert (cfg["model"], cfg["attn_impl"], cfg["head_impl"]) == ("logbert", "flash", "pallas")
    assert (cfg["dim"], cfg["depth"], cfg["heads"], cfg["seq_len"]) == (256, 4, 4, 2048)
