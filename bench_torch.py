"""Detector throughput of the PyTorch/CUDA port on bench.py's wire-frame path.

    python3 bench_torch.py [--device cpu] [--n N]

The port's counterpart of ``bench.py``'s ``child_run``: the MLP detector at
``bench.py``'s ``BENCH_SCORER_CONFIG`` (vocab 32768, seq_len 32, dim 128,
max_batch 16384) with two changes, ``method_type: torch_scorer`` and
``head_impl: pallas`` (the fused vocab head's CUDA kernel scores every
device batch). It fits on 2048 messages of ``make_messages``, warms up on one
batch, then times ``process_frames`` over ``--n`` messages (default 262,144,
``bench.py``'s ``FULL_N``) packed into frames of 512 outside the timer, in
calls of ``max_batch // 512`` frames, and the final ``flush``. The p50 is
the median over 64 lone messages, each one ``process_frames([msg])`` and a
``flush``; at ``host_score_max_batch`` 128 they score on the detector's CPU
copy, as in the JAX detector, and the line says which path scored them.

It runs on ``cuda:0`` unless given ``--device cpu``; on the CPU it scores in
float32, as ``bench.py``'s CPU run does. It has no TPU target, no open-loop
phase, no upload workers and no child processes. It prints one JSON
line: the metric, its value in lines/s, ``p50_ms``, the alerts, ``n``, the
featurized rows by path, and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from detectmateservice_tpu_torch.engine.framing import pack_batch
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.schemas import ParserSchema

# bench.py's BENCH_SCORER_CONFIG with method_type torch_scorer and the fused
# head (head_impl pallas)
BENCH_SCORER_CONFIG = {
    "method_type": "torch_scorer", "auto_config": False, "model": "mlp",
    "data_use_training": 2048, "train_epochs": 2, "async_fit": False,
    "seq_len": 32, "dim": 128, "max_batch": 16384, "pipeline_depth": 8,
    "threshold_sigma": 6.0, "head_impl": "pallas",
}
FULL_N = 262144
FRAME_N = 512
N_SINGLE = 64


def make_messages(n: int, anomaly_rate: float = 0.01, seed: int = 0) -> List[bytes]:
    """``bench.py``'s ``make_messages`` over the port's ParserSchema: audit
    lines with ``anomaly_rate`` injected segfault lines."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n):
        if rng.random() < anomaly_rate:
            template, variables = "segfault at <*> ip <*> sp <*>", [
                hex(rng.integers(2**30)), hex(rng.integers(2**30)), hex(rng.integers(2**30))]
        else:
            template, variables = "type=<*> msg=audit(<*>): pid=<*> uid=<*> comm=<*>", [
                "SYSCALL", f"17000{i % 100}.{i % 997}", str(int(rng.integers(300, 500))),
                str(int(rng.integers(0, 4))), ["cron", "sshd", "systemd", "bash"][i % 4]]
        msgs.append(ParserSchema(
            EventID=1, template=template, variables=variables,
            logID=str(i), logFormatVariables={"Time": str(1_700_000_000 + i)},
        ).serialize())
    return msgs


def build_detector(device: str = "cuda:0", config: Optional[Dict[str, Any]] = None
                   ) -> TorchScorerDetector:
    """The bench detector (``config``, by default ``BENCH_SCORER_CONFIG``)
    on ``device``, float32 on the CPU; the caller runs ``setup_io``."""
    cfg = dict(BENCH_SCORER_CONFIG if config is None else config, device=device)
    if device == "cpu":
        cfg["dtype"] = "float32"
    return TorchScorerDetector(config={"detectors": {"TorchScorerDetector": cfg}})


def drive(det: TorchScorerDetector, n_bench: int) -> Dict[str, Any]:
    """Fit, warm up, then the timed ``process_frames`` loop and the p50 of
    lone messages (``child_run``'s steps); returns the numbers and the
    timed loop's alerts."""
    n_train = det.config.data_use_training
    batch = det.config.max_batch
    train_msgs = make_messages(n_train, anomaly_rate=0.0)
    for start in range(0, n_train, batch):
        det.process_batch(train_msgs[start:start + batch])
    det.flush()

    bench_msgs = make_messages(n_bench, anomaly_rate=0.01, seed=1)
    det.process_batch(bench_msgs[:batch])
    det.flush_final()
    # frames are packed outside the timer: packing is the sender's cost
    frames = [pack_batch(bench_msgs[i:i + FRAME_N]) for i in range(0, n_bench, FRAME_N)]
    frames_per_call = max(1, batch // FRAME_N)

    alerts: List[bytes] = []
    n_seen = 0
    t0 = time.perf_counter()
    for start in range(0, len(frames), frames_per_call):
        out, n_msgs, _n_lines = det.process_frames(frames[start:start + frames_per_call])
        alerts.extend(out)
        n_seen += n_msgs
    alerts.extend(det.flush())
    elapsed = time.perf_counter() - t0
    if n_seen != n_bench:
        raise RuntimeError(f"process_frames counted {n_seen} messages, sent {n_bench}")

    # p50 of a lone message through the same path; flush forces the readback
    # the pipelined path would overlap
    before = dict(det.path_counts)
    lat = []
    for msg in make_messages(N_SINGLE, anomaly_rate=0.0, seed=2):
        t = time.perf_counter()
        det.process_frames([msg])
        det.flush()
        lat.append(time.perf_counter() - t)
    return {
        "lines_per_s": n_bench / elapsed, "elapsed_s": elapsed, "n": n_bench,
        "p50_ms": statistics.median(lat) * 1000.0,
        "p50_paths": {k: det.path_counts[k] - before[k] for k in before},
        "alerts": alerts,
    }


def card_line(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[torch.device(device).index or 0]


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda:0", help="cuda:N or cpu")
    parser.add_argument("--n", type=int, default=FULL_N, help="messages timed")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    det = build_detector(args.device)
    det.setup_io()
    result = drive(det, args.n)
    print(json.dumps({
        "metric": "audit_log_lines_per_sec_through_detector",
        "value": result["lines_per_s"], "unit": "lines/s",
        "p50_ms": result["p50_ms"], "p50_paths": result["p50_paths"],
        "alerts": len(result["alerts"]), "n": result["n"], "elapsed_s": result["elapsed_s"],
        "featurize_rows": det.featurize_rows, "path_counts": det.path_counts,
        "device": (torch.cuda.get_device_name(torch.device(args.device))
                   if args.device != "cpu" else "cpu"),
        "card": card_line(args.device),
        "config": {k: getattr(det.config, k)
                   for k in (*BENCH_SCORER_CONFIG, "dtype", "device")},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
