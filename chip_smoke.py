"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printing one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every CUDA kernel of the port, compiled from ``ops/csrc``;
3. kernels against their plain PyTorch versions, at the main path's shapes
   and at edge shapes (TF32 off, so the yardstick itself is exact fp32);
4. timings: each kernel beside its plain version, one library call that
   computes the same function, and the card's bound for the same work;
5. the detector end to end at the full bench width (vocab 32768, seq_len
   32, dim 128, hidden 256, max_batch 16384, bf16, ``head_impl: pallas``):
   fit on 2048 messages, then 65,536 messages in ``process_batch`` calls of
   4096, with the kernel's launch count reset just before and read just
   after; the same stream through the einsum head on the same weights must
   give the same alert decisions.

Then the kernel summary line, and last ``{"ok": true, "device": ...}``. Any
failed phase raises, so the script exits non-zero and prints no result; so
does a machine without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.models.mlp import MLPScorer
from detectmateservice_tpu_torch.ops import cuda_build, scorehead
from detectmateservice_tpu_torch.schemas import DetectorSchema, ParserSchema

# published dense peaks of one H100 SXM (operations/s) and its HBM rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# the bench configuration (bench.py BENCH_SCORER_CONFIG) on the port
SCORER_CONFIG = {
    "method_type": "torch_scorer", "auto_config": False, "model": "mlp",
    "data_use_training": 2048, "train_epochs": 2, "async_fit": False,
    "seq_len": 32, "dim": 128, "max_batch": 16384, "pipeline_depth": 8,
    "threshold_sigma": 6.0, "head_impl": "pallas", "dtype": "auto",
}
N_DETECT = 65536
CALL_SIZE = 4096

# (N, C, D, dtype) of the kernel checks: the detect bucket, the warm-up
# bucket and the calibration bucket of the main path, then edge shapes
LSE_CASES = [
    (16384, 32768, 128, torch.bfloat16),
    (4096, 32768, 128, torch.bfloat16),
    (32, 32768, 128, torch.bfloat16),
    (1, 32768, 128, torch.bfloat16),
    (1000, 2048, 128, torch.float32),
    (100, 613, 16, torch.float32),
    (16, 16, 32, torch.float32),   # the extreme values of test_scorehead.py
    (37, 64, 256, torch.float16),
]
TIMED_N = (16384, 4096, 256)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def make_messages(n: int, anomaly_rate: float = 0.01, seed: int = 0):
    """bench.py's ``make_messages`` on the port's schemas; also returns the
    logIDs of the injected segfault anomalies."""
    rng = np.random.default_rng(seed)
    msgs, anomalies = [], set()
    for i in range(n):
        if rng.random() < anomaly_rate:
            template, variables = "segfault at <*> ip <*> sp <*>", [
                hex(rng.integers(2**30)), hex(rng.integers(2**30)), hex(rng.integers(2**30))]
            anomalies.add(str(i))
        else:
            template, variables = "type=<*> msg=audit(<*>): pid=<*> uid=<*> comm=<*>", [
                "SYSCALL", f"17000{i % 100}.{i % 997}", str(int(rng.integers(300, 500))),
                str(int(rng.integers(0, 4))), ["cron", "sshd", "systemd", "bash"][i % 4]]
        msgs.append(ParserSchema(
            EventID=1, template=template, variables=variables,
            logID=str(i), logFormatVariables={"Time": str(1_700_000_000 + i)},
        ).serialize())
    return msgs, anomalies


# -- phase 1 -----------------------------------------------------------------
def phase_card() -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    # what the machine offers beyond what the port uses (found, not imported)
    present = {mod: importlib.util.find_spec(mod) is not None
               for mod in ("pydantic", "yaml", "jax", "triton")}
    present["protobuf"] = (importlib.util.find_spec("google") is not None
                           and importlib.util.find_spec("google.protobuf") is not None)
    present["ninja"] = shutil.which("ninja") is not None
    emit("card", nvidia_smi=line, torch_name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)), present=present)
    return name, line


# -- phase 2 -----------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    report = scorehead.build_kernel()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         compile_seconds=cuda_build.build_seconds, ptxas=ptxas,
         max_dim=scorehead._library().dm_candidate_lse_max_dim())


# -- phase 3 -----------------------------------------------------------------
def _lse_inputs(n, c, d, dtype, gen):
    if (n, c, d) == (16, 16, 32):
        h = torch.full((n, d), 50.0, device="cuda")
        e = torch.cat([torch.full((8, d), 2.0), torch.full((8, d), -2.0)]).cuda()
    else:
        h = torch.randn(n, d, device="cuda", generator=gen)
        e = torch.randn(c, d, device="cuda", generator=gen)
    return h.to(dtype), e.to(dtype)


def phase_kernel_checks() -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for n, c, d, dtype in LSE_CASES:
        h, e = _lse_inputs(n, c, d, dtype, gen)
        got = scorehead.candidate_lse(h, e)
        torch.cuda.synchronize()
        want = scorehead.candidate_lse_reference(h, e)
        finite = bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        if dtype == torch.float32:
            tol = "rtol 1e-5, atol 1e-4"
            ok = finite and torch.allclose(got, want, rtol=1e-5, atol=1e-4)
        else:
            # the same low-precision operands on both sides; products are
            # exact in fp32, only the order of summation differs
            tol = "atol 2e-3"
            ok = finite and err <= 2e-3
        emit("kernel_check", kernel="candidate_lse", shape=[n, c, d],
             dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tol=tol,
             finite=finite, ok=bool(ok))
        if not ok:
            raise AssertionError(f"candidate_lse disagrees at {(n, c, d, dtype)}: {err}")
        worst = max(worst, err)
    return worst


# -- phase 4 -----------------------------------------------------------------
def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def lse_bound(n: int, c: int, d: int, dtype: torch.dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate (each
    input read once, the fp32 output written once) and the 2·N·C·D
    multiply-adds over the peak rate of the inputs' type."""
    size = torch.tensor([], dtype=dtype).element_size()
    bytes_ms = ((n + c) * d * size + n * 4) / PEAK_BYTES * 1e3
    ops_ms = 2.0 * n * c * d / PEAK_OPS[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_timings() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for n in TIMED_N:
        c, d, dtype = 32768, 128, torch.bfloat16
        h, e = _lse_inputs(n, c, d, dtype, gen)
        kernel_ms = time_ms(lambda: scorehead.candidate_lse(h, e))
        plain_ms = time_ms(lambda: scorehead.candidate_lse_reference(h, e))
        library_ms = time_ms(lambda: torch.logsumexp(torch.matmul(h, e.T).float(), -1))
        bound_ms, bound_by = lse_bound(n, c, d, dtype)
        rows[n] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        emit("timing", kernel="candidate_lse", shape=[n, c, d], dtype="bfloat16",
             ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
             library_call="torch.logsumexp(torch.matmul(h, e.T).float(), -1): "
                          "bf16 matmul with a bf16 [N, C] result, then fp32",
             plain_call="candidate_lse_reference: fp32 matmul (TF32 off), logsumexp",
             bound_ms=bound_ms, bound_by=bound_by, flops=2.0 * n * c * d,
             tflops=2.0 * n * c * d / kernel_ms / 1e9)
    return rows


# -- phase 5 -----------------------------------------------------------------
def _alerts_by_id(alerts):
    out = {}
    for raw in alerts:
        alert = DetectorSchema.from_bytes(raw)
        out[alert["logIDs"][0]] = alert
    return out


def phase_detector(device: str = "cuda") -> dict:
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": SCORER_CONFIG}})
    t0 = time.perf_counter()
    det.setup_io()
    setup_s = time.perf_counter() - t0
    train_msgs, _ = make_messages(SCORER_CONFIG["data_use_training"], anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(N_DETECT, anomaly_rate=0.01, seed=1)

    # the main path: launch count 0 just before, read just after
    scorehead.candidate_lse.launches = 0
    t0 = time.perf_counter()
    assert det.process_batch(train_msgs) == []   # sync fit at the boundary
    fit_s = time.perf_counter() - t0
    alerts = []
    t0 = time.perf_counter()
    for start in range(0, N_DETECT, CALL_SIZE):
        alerts.extend(det.process_batch(detect_msgs[start:start + CALL_SIZE]))
    alerts.extend(det.flush_final())
    detect_s = time.perf_counter() - t0
    launches = scorehead.candidate_lse.launches

    threshold = det._threshold
    calib_chunks = -(-SCORER_CONFIG["data_use_training"] // 32)
    if det.path_counts["device"] != N_DETECT // CALL_SIZE or det.path_counts["host"]:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    if launches != calib_chunks + det.path_counts["device"]:
        raise AssertionError(f"kernel launched {launches} times on the main path, "
                             f"expected {calib_chunks} calibration chunks + "
                             f"{det.path_counts['device']} device batches")
    if not np.isfinite(threshold):
        raise AssertionError(f"threshold {threshold} is not finite")

    by_id = _alerts_by_id(alerts)
    for log_id, alert in by_id.items():
        want_ts = 1_700_000_000 + int(log_id)
        if (alert["detectorID"] != "TorchScorerDetector"
                or alert["detectorType"] != "torch_scorer"
                or not alert["alertID"] or alert["detectionTimestamp"] <= 0
                or alert["receivedTimestamp"] <= 0
                or alert["extractedTimestamps"] != [want_ts]
                or alert["description"] != TorchScorerDetector.description
                or not alert["score"] > threshold
                or list(alert["alertsObtain"]) != ["TorchScorerDetector - score"]):
            raise AssertionError(f"malformed alert {alert!r}")
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))
    # host share: the same featurize pass alone, off the device
    t0 = time.perf_counter()
    det._featurize_raw_batch(detect_msgs)
    featurize_s = time.perf_counter() - t0

    # the same stream through the einsum head on the same fitted weights
    ein = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        SCORER_CONFIG, head_impl="einsum", data_use_training=0,
        score_threshold=threshold)}})
    ein.load_params(det._model.state_dict())
    ein_alerts = []
    for start in range(0, N_DETECT, CALL_SIZE):
        ein_alerts.extend(ein.process_batch(detect_msgs[start:start + CALL_SIZE]))
    ein_alerts.extend(ein.flush_final())
    if scorehead.candidate_lse.launches != launches:
        raise AssertionError("the einsum head launched the fused kernel")
    ein_by_id = _alerts_by_id(ein_alerts)
    flips = sorted(set(by_id) ^ set(ein_by_id), key=int)
    near = []
    if flips:
        tokens, ok = ein._featurize_raw_batch([detect_msgs[int(i)] for i in flips])
        assert ok.all()
        flip_scores = ein.score_tokens(tokens)
        near = [float(abs(s - threshold)) for s in flip_scores]
        if max(near) >= 1e-2:
            raise AssertionError(f"pallas and einsum heads disagree beyond 1e-2 of "
                                 f"the threshold: {list(zip(flips, near))}")

    # a small fp32 input held against the plain head on the host
    scorer = MLPScorer(dataclasses.replace(det._scorer.config, dtype=torch.float32))
    model_dev = scorer.clone_model(det._model, torch.device(device))
    model_cpu = scorer.clone_model(det._model, torch.device("cpu"))
    tokens, _ = det._featurize_raw_batch(detect_msgs[:256])
    got = scorer.score(model_dev, torch.from_numpy(tokens).to(device)).cpu()
    want = scorer.score(model_cpu, torch.from_numpy(tokens))
    small_err = (got - want).abs().max().item()
    if got.shape != (256,) or not torch.isfinite(got).all() or \
            not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"fp32 scores on the card disagree with the host: {small_err}")

    result = dict(
        setup_s=setup_s, fit_s=fit_s, detect_s=detect_s, featurize_s=featurize_s,
        lines_per_s=N_DETECT / detect_s, n_detect=N_DETECT, call_size=CALL_SIZE,
        threshold=threshold, alerts=len(by_id), anomalies=len(anomalies),
        recall=recall, precision=len(anomalies & set(by_id)) / max(1, len(by_id)),
        launches=launches, calibration_launches=calib_chunks,
        device_batches=det.path_counts["device"],
        einsum_alerts=len(ein_by_id), decision_flips=len(flips),
        flip_distances=near, small_fp32_max_abs_err=small_err,
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if device == "cuda" else None))
    emit("detector", **result)
    if recall < 0.9:
        raise AssertionError(f"recall on the injected anomalies is {recall}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, _smi = phase_card()
    phase_build()
    max_err = phase_kernel_checks()
    timings = phase_timings()
    detector = phase_detector()
    main_n = CALL_SIZE  # the detect bucket of the main path
    t = timings[main_n]
    print(json.dumps({"kernels": [{
        "name": "candidate_lse",
        "route": "cuda",
        "source": "detectmateservice_tpu_torch/ops/csrc/scorehead.cu",
        "replaces": "detectmateservice_tpu/ops/scorehead.py:55",
        "launches": detector["launches"],
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": [main_n, 32768, 128],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
