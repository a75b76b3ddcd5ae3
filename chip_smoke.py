"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printing JSON lines:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port (``ops/csrc``), one ``nvcc`` each,
   all started together, with the compile seconds and ``ptxas`` registers
   and spills of every kernel (``ptxas_summary``), the main paths'
   tensor-core kernels named apart (none of them may spill: checked at the
   end);
3. the fused head (kernel 1) against its plain PyTorch version, at the main
   paths' shapes (D = 128 for the MLP detector, D = 256 for LogBERT) and at
   edge shapes, fp32 ones (the CUDA-core variant) with bf16 twins (the
   tensor-core variants, split over C or not), each with its variant and
   split count (TF32 off, so the plain version is exact fp32);
4. the fused head's timings: kernel, plain version, one library call that
   computes the same function (over row chunks of 65,536 where its bf16
   [N, C] product would not fit), and the card's bound for the same work;
5. the flash kernels (forward, dQ, dK/dV) against their plain versions at
   the LogBERT scoring and training shapes and at ragged, tiny, fp16,
   fully-masked and D = 128 edge shapes, in fp32 (the CUDA-core variants)
   and in bf16 (the wgmma variants), and with q, k and v as strided views
   of one qkv tensor as the model passes them;
6. the flash kernels' timings beside their plain versions,
   ``F.scaled_dot_product_attention`` (forward, and its backward through
   autograd) as the library yardstick, and the bound, with each kernel's
   variant and share of the bound;
7. the MLP detector end to end at the full bench width (vocab 32768,
   seq_len 32, dim 128, hidden 256, max_batch 16384, bf16, ``head_impl:
   pallas``): fit on 2048 messages, then 65,536 messages in
   ``process_batch`` calls of 4096; the same stream through the einsum head
   on the same weights must give the same alert decisions;
8. the LogBERT detector end to end at ``examples/seqparallel_config.yaml``'s
   widths on one card (vocab 32768, dim 256, depth 4, heads 4, seq_len 2048,
   score_topk 8, max_batch 256, bf16) with ``attn_impl: flash`` and
   ``head_impl: pallas``: fit on 512 messages (112 train steps through the
   flash forward, dQ and dK/dV kernels), then 4096 messages in calls of 256;
   the same stream through the einsum attention and head on the same fitted
   weights must give the same alert decisions.

Each detector run resets every kernel's launch count just before and reads
them just after; the counts must be exactly what the path launches, and
every bf16 flash and fused-head launch on both paths must have taken its
tensor-core (wgmma) variant. Then
the kernel summary line, and last ``{"ok": true, "device": ...}``. Any
failed phase raises, so the script exits non-zero and prints no result; so
does a machine without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.models.mlp import MLPScorer
from detectmateservice_tpu_torch.ops import cuda_build, flash, scorehead
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

# examples/seqparallel_config.yaml on one card: attn_impl flash in place of
# ring over a mesh, and the fused head
LOGBERT_CONFIG = {
    "method_type": "torch_scorer", "auto_config": False, "model": "logbert",
    "attn_impl": "flash", "head_impl": "pallas", "vocab_size": 32768,
    "dim": 256, "depth": 4, "heads": 4, "seq_len": 2048, "score_topk": 8,
    "data_use_training": 512, "train_epochs": 4, "threshold_sigma": 5.0,
    "max_batch": 256, "host_score_max_batch": 0, "dtype": "auto",
    "async_fit": False,
}
LOGBERT_DETECT = 4096
LOGBERT_CALL = 256
LOGBERT_PLAIN_CALL = 64  # einsum attention: [64, 4, 2048, 2048] fp32 logits

# (N, C, D, dtype) of the fused-head checks: the MLP path's detect, warm-up
# and calibration buckets, the LogBERT path's detect batch and calibration
# chunk (N = B * 2048 rows), then edge shapes
LSE_CASES = [
    (16384, 32768, 128, torch.bfloat16),
    (4096, 32768, 128, torch.bfloat16),
    (32, 32768, 128, torch.bfloat16),
    (1, 32768, 128, torch.bfloat16),
    (524288, 32768, 256, torch.bfloat16),
    (65536, 32768, 256, torch.bfloat16),
    (1, 32768, 256, torch.bfloat16),
    (1000, 2048, 128, torch.float32),
    (100, 613, 16, torch.float32),
    (16, 16, 32, torch.float32),   # the extreme values of test_scorehead.py
    (37, 64, 256, torch.float16),
    (32, 1031, 256, torch.float16),
    (1, 1031, 256, torch.float16),
    # bf16 twins for the tensor-core variants: ragged C (not a whole number
    # of 128-column stages; 1031 splits in two at N = 100) at every D the
    # main paths and the plan take, D = 16, and the extreme values
    (100, 613, 64, torch.bfloat16),
    (100, 1031, 64, torch.bfloat16),
    (100, 613, 128, torch.bfloat16),
    (100, 1031, 128, torch.bfloat16),
    (100, 613, 256, torch.bfloat16),
    (100, 1031, 256, torch.bfloat16),
    (100, 613, 16, torch.bfloat16),
    (16, 16, 32, torch.bfloat16),
]
# (N, D) of the fused-head timings; the plain version runs in row chunks
LSE_TIMED = ((16384, 128), (4096, 128), (256, 128), (32, 128), (65536, 256),
             (524288, 256))
LSE_PLAIN_ROWS = 16384
# the library call's bf16 [N, C] product (4 GiB at 65,536 rows) fits at
# N <= 65536; beyond, it runs once per row chunk of this size
LSE_LIBRARY_ROWS = 65536

# (B, H, S, T, D, dtype, mask, backward, layout) of the flash checks: the
# LogBERT scoring and training shapes with real-row key masks (10-40 valid
# keys), then ragged, tiny, fp16 maskless, fully masked and D = 128 edge
# shapes, fp32 ones (CUDA-core variants) with bf16 twins (wgmma variants),
# and q, k, v as strided views of one [B, S, 3 H D] tensor ("qkv", as
# models/logbert.py makes them) beside separate contiguous tensors
FLASH_CASES = [
    (256, 4, 2048, 2048, 64, torch.bfloat16, "rows", False, "contiguous"),
    (32, 4, 2048, 2048, 64, torch.bfloat16, "rows", True, "contiguous"),
    (2, 3, 200, 384, 64, torch.float32, "random", True, "contiguous"),
    (2, 3, 200, 384, 64, torch.bfloat16, "random", True, "contiguous"),
    (2, 2, 100, 60, 32, torch.float32, "random", True, "contiguous"),
    (1, 1, 1, 1, 64, torch.float32, None, True, "contiguous"),
    (1, 1, 1, 1, 64, torch.bfloat16, None, True, "contiguous"),
    (2, 2, 64, 64, 128, torch.float16, None, True, "contiguous"),
    (2, 2, 70, 90, 64, torch.float32, "one_row_masked", True, "contiguous"),
    (2, 2, 70, 90, 64, torch.bfloat16, "one_row_masked", True, "contiguous"),
    (3, 2, 300, 300, 128, torch.bfloat16, "rows", True, "contiguous"),
    (4, 4, 520, 520, 64, torch.bfloat16, "rows", True, "qkv"),
]
FLASH_SCORING = (256, 4, 2048, 2048, 64)
FLASH_TRAINING = (32, 4, 2048, 2048, 64)
FLASH_REPS = 20


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


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


KERNEL_WRAPPERS = (scorehead.candidate_lse, flash.flash_forward, flash.flash_dq,
                   flash.flash_dkv)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.variants.clear()


def read_variants() -> dict:
    """Each wrapper's launches by kernel variant."""
    return {fn.__name__: dict(fn.variants) for fn in KERNEL_WRAPPERS}


def read_launches() -> dict:
    return {"candidate_lse": scorehead.candidate_lse.launches,
            "flash_forward": flash.flash_forward.launches,
            "flash_dq": flash.flash_dq.launches,
            "flash_dkv": flash.flash_dkv.launches}


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
_KERNEL_NAME = re.compile(
    r"([a-z_]+_kernel)I(?:Li(\d+)E)?(13__nv_bfloat16|6__half|f)E")
_PLAIN_KERNEL_NAME = re.compile(r"\d([a-z_]+_kernel)E")
_TYPE_NAMES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}
# the tensor-core kernels the main paths run, all bf16: the flash kernels of
# the LogBERT path (D = 64), the fused head at the MLP path's D = 128 and
# LogBERT's D = 256, and the merge of a split head launch
MAIN_PATH_WGMMA = {"forward": "flash_fwd_wgmma_kernel<64, bf16>",
                   "dq": "flash_dq_wgmma_kernel<64, bf16>",
                   "dkv": "flash_dkv_wgmma_kernel<64, bf16>",
                   "lse_d128": "lse_wgmma_kernel<128, bf16>",
                   "lse_d256": "lse_wgmma_kernel<256, bf16>",
                   "lse_combine": "lse_combine_kernel"}
# kernels whose ptxas report must show no spill
NO_SPILL = (*MAIN_PATH_WGMMA.values(), "flash_dq_wgmma_kernel<128, bf16>")


def ptxas_summary(report: str) -> dict:
    """Registers, stack and spill bytes of each kernel in an ``nvcc -Xptxas
    -v`` report, keyed ``name<D, type>`` (``name<type>`` without a D)."""
    out, entry = {}, None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = _KERNEL_NAME.search(found.group(1))
            plain = _PLAIN_KERNEL_NAME.search(found.group(1))
            if name is not None:
                entry = (f"{name.group(1)}<"
                         f"{name.group(2) + ', ' if name.group(2) else ''}"
                         f"{_TYPE_NAMES[name.group(3)]}>")
            else:
                entry = found.group(1) if plain is None else plain.group(1)
            out[entry] = {}
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame and entry is not None:
            out[entry].update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                              spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used and entry is not None:
            out[entry]["registers"] = int(used.group(1))
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    reports = cuda_build.build_all([scorehead.SOURCE, flash.SOURCE])
    wall = time.perf_counter() - t0
    scorehead.build_kernel()  # loads and types the libraries
    flash.build_kernel()
    ptxas = {src: ptxas_summary(rep) for src, rep in reports.items()}
    kernels = {name: row for rows in ptxas.values() for name, row in rows.items()}
    main_path = {name: kernels.get(name) for name in NO_SPILL}
    emit("build", seconds=wall, compile_seconds=cuda_build.build_seconds, ptxas=ptxas,
         main_path_wgmma=main_path,
         lse_max_dim=scorehead._library().dm_candidate_lse_max_dim(),
         flash_max_dim=flash._library().dm_flash_max_dim())
    return main_path


# -- phase 3 -----------------------------------------------------------------
def _lse_inputs(n, c, d, dtype, gen):
    if (n, c, d) == (16, 16, 32):
        h = torch.full((n, d), 50.0, device="cuda")
        e = torch.cat([torch.full((8, d), 2.0), torch.full((8, d), -2.0)]).cuda()
    else:
        h = torch.randn(n, d, device="cuda", generator=gen)
        e = torch.randn(c, d, device="cuda", generator=gen)
    return h.to(dtype), e.to(dtype)


def row_chunks(n: int, size: int) -> list:
    """Slices of [0, n) of at most ``size`` rows each, in order."""
    return [slice(i, min(n, i + size)) for i in range(0, n, size)]


def lse_plain(h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The plain version over row chunks, so the fp32 [rows, C] logits stay
    at 2 GiB at C = 32768."""
    return torch.cat([scorehead.candidate_lse_reference(h[sl], e)
                      for sl in row_chunks(h.shape[0], LSE_PLAIN_ROWS)])


def lse_library(h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The library yardstick: one ``torch.logsumexp(torch.matmul(h,
    e.T).float(), -1)`` per chunk of at most 65,536 rows (one call up to
    there)."""
    return torch.cat([torch.logsumexp(torch.matmul(h[sl], e.T).float(), -1)
                      for sl in row_chunks(h.shape[0], LSE_LIBRARY_ROWS)])


def phase_kernel_checks() -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for n, c, d, dtype in LSE_CASES:
        h, e = _lse_inputs(n, c, d, dtype, gen)
        got = scorehead.candidate_lse(h, e)
        torch.cuda.synchronize()
        want = lse_plain(h, e)
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
        taken = scorehead.variant(n, c, d, dtype)
        emit("kernel_check", kernel="candidate_lse", shape=[n, c, d],
             dtype=_dtype_name(dtype), variant=taken,
             splits=scorehead._library().dm_candidate_lse_splits(
                 n, c, d, scorehead._DTYPE_CODES[dtype]),
             max_abs_err=err, tol=tol, finite=finite, ok=bool(ok))
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


def _bound(ops: float, nbytes: float, dtype: torch.dtype) -> tuple:
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate of the inputs' type and the bytes over the HBM rate."""
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def lse_bound(n: int, c: int, d: int, dtype: torch.dtype) -> tuple:
    """Each input read once, the fp32 output written once; 2·N·C·D
    multiply-adds."""
    size = torch.tensor([], dtype=dtype).element_size()
    return _bound(2.0 * n * c * d, (n + c) * d * size + n * 4, dtype)


def phase_timings() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for n, d in LSE_TIMED:
        c, dtype = 32768, torch.bfloat16
        h, e = _lse_inputs(n, c, d, dtype, gen)
        chunks = len(row_chunks(n, LSE_LIBRARY_ROWS))
        reps = 5 if chunks > 1 else 25
        kernel_ms = time_ms(lambda: scorehead.candidate_lse(h, e), reps=reps)
        plain_ms = time_ms(lambda: lse_plain(h, e), reps=reps, warmup=1)
        library_ms = time_ms(lambda: lse_library(h, e), reps=reps, warmup=1)
        bound_ms, bound_by = lse_bound(n, c, d, dtype)
        taken = scorehead.variant(n, c, d, dtype)
        rows[(n, d)] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by, variant=taken,
                            bound_share=bound_ms / kernel_ms)
        emit("timing", kernel="candidate_lse", shape=[n, c, d], dtype="bfloat16",
             variant=taken, bound_share=bound_ms / kernel_ms, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, reps=reps,
             library_call=("torch.logsumexp(torch.matmul(h, e.T).float(), -1): "
                           "bf16 matmul with a bf16 [N, C] result, then fp32"
                           + (f"; {chunks} chunked calls of {LSE_LIBRARY_ROWS} rows "
                              "in one timed call" if chunks > 1 else "")),
             plain_call="candidate_lse_reference over 16384-row chunks: fp32 "
                        "matmul (TF32 off), logsumexp",
             bound_ms=bound_ms, bound_by=bound_by, flops=2.0 * n * c * d,
             tflops=2.0 * n * c * d / kernel_ms / 1e9)
    return rows


# -- phase 5 -----------------------------------------------------------------
def _flash_inputs(b, h, s, t, d, dtype, mask_kind, gen, layout="contiguous"):
    if layout == "qkv":
        # one [B, S, 3 H D] tensor cut into q, k, v heads, as the model does
        assert s == t
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen).to(dtype)
        q, k, v = (x.reshape(b, s, h, d).transpose(1, 2)
                   for x in qkv.split(h * d, dim=-1))
    else:
        q = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, h, t, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, h, t, d, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
    if mask_kind is None:
        mask = None
    elif mask_kind == "rows":
        # a tokenized log line: its first 10-40 positions are real tokens
        valid = torch.randint(10, 41, (b, 1), device="cuda", generator=gen)
        mask = torch.arange(t, device="cuda")[None, :] < valid
    else:
        mask = torch.rand(b, t, device="cuda", generator=gen) > 0.2
        if mask_kind == "one_row_masked":
            # as for an all-PAD row in the model: no key, and no gradient
            # flowing back into it
            mask[1] = False
            g[1] = 0
    return q, k, v, g, mask


def _close(got, want, dtype, grad: bool) -> tuple:
    """(ok, max_abs_err, tolerance) of a kernel result against its plain
    version on the same operands."""
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    finite = bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        return finite and err <= 1e-4, err, "atol 1e-4"
    if not grad:
        return finite and err <= 2e-2, err, "atol 2e-2"
    # gradients in 16-bit: 5e-2, plus one ulp of the type (a sum taken in
    # another order may round to the neighbouring value)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    ok = finite and bool(torch.allclose(got.float(), want.float(), rtol=ulp, atol=5e-2))
    return ok, err, f"atol 5e-2 + rtol {ulp}"


# the kernel each result held against its plain version comes from
_FLASH_RESULT_KERNEL = {"out": "flash_forward", "dq": "flash_dq", "dk": "flash_dkv",
                        "dv": "flash_dkv"}


def flash_case_results(case: tuple, gen: torch.Generator) -> dict:
    """Every result of one ``FLASH_CASES`` entry held against its plain
    version: name -> (ok, max_abs_err, tolerance)."""
    b, h, s, t, d, dtype, mask_kind, backward, layout = case
    q, k, v, g, mask = _flash_inputs(b, h, s, t, d, dtype, mask_kind, gen, layout)
    out, lse = flash.flash_forward(q, k, v, mask, want_lse=True)
    torch.cuda.synchronize()
    want_out, want_lse = flash.flash_forward_reference(q, k, v, mask)
    results = {"out": _close(out, want_out, dtype, grad=False)}
    lse_err = (lse - want_lse).abs().max().item()
    results["lse"] = (bool(torch.isfinite(lse).all())
                      and bool(torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-3)),
                      lse_err, "rtol 1e-5, atol 1e-3")
    scoring_out, _ = flash.flash_forward(q, k, v, mask, want_lse=False)
    results["out_without_lse"] = (bool(torch.equal(scoring_out, out)), 0.0, "equal")
    if backward:
        delta = flash.flash_delta(g, out)
        dq = flash.flash_dq(q, k, v, mask, g, lse, delta)
        dk, dv = flash.flash_dkv(q, k, v, mask, g, lse, delta)
        torch.cuda.synchronize()
        want_dq = flash.flash_dq_reference(q, k, v, mask, g, lse, delta)
        want_dk, want_dv = flash.flash_dkv_reference(q, k, v, mask, g, lse, delta)
        for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                                ("dv", dv, want_dv)):
            results[name] = _close(got, want, dtype, grad=True)
        if dtype == torch.float32:
            # an independent formulation too: autograd through the einsum
            # reference, the gradients of sum(out * g)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            ref_out = flash.reference_attention(*leaves, mask)
            for name, got, want in zip(
                    ("dq_autograd", "dk_autograd", "dv_autograd"), (dq, dk, dv),
                    torch.autograd.grad(ref_out, leaves, g)):
                results[name] = _close(got, want, dtype, grad=True)
        # dV is never all zero (with one key, dQ and dK are)
        grad_max = max(x.abs().max().item() for x in (dq, dk, dv))
        results["grad_max_abs"] = (dv.abs().max().item() > 0, grad_max, "dV nonzero")
    return results


def phase_flash_checks() -> dict:
    """Each flash kernel's largest |kernel - plain| over the cases."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"flash_forward": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for case in FLASH_CASES:
        b, h, s, t, d, dtype, mask_kind, backward, layout = case
        results = flash_case_results(case, gen)
        # every 16-bit kind runs its wgmma kernel, every fp32 one CUDA cores
        variants = {kind: flash.variant(kind, dtype, d) for kind in ("forward", "dq", "dkv")}
        route = "cuda_core" if dtype == torch.float32 else "wgmma_tma"
        ok = (all(r[0] for r in results.values())
              and all(v.startswith(route) for v in variants.values()))
        emit("flash_check", shape=[b, h, s, t, d], dtype=_dtype_name(dtype),
             mask=mask_kind, backward=backward, layout=layout, ok=ok,
             variants=variants,
             **{name: {"max_abs_err": r[1], "tol": r[2], "ok": r[0]}
                for name, r in results.items()})
        if not ok:
            raise AssertionError(f"flash kernels disagree at {(b, h, s, t, d, dtype)} "
                                 f"({variants}): {results}")
        for name, r in results.items():
            if name in _FLASH_RESULT_KERNEL:
                kernel = _FLASH_RESULT_KERNEL[name]
                worst[kernel] = max(worst[kernel], r[1])
        torch.cuda.empty_cache()
    return worst


# -- phase 6 -----------------------------------------------------------------
def flash_bound(kind: str, b, h, s, t, d, dtype, with_lse: bool = False) -> tuple:
    """Operations 4 (forward), 6 (dQ) or 8 (dK/dV) · BH·S·T·D; bytes: every
    input read once (q, k, v, the fp32 [B, T] bias, and dO, lse, delta for
    the backward), every output written once."""
    size = torch.tensor([], dtype=dtype).element_size()
    bh = b * h
    q_bytes, kv_bytes, rows = bh * s * d * size, bh * t * d * size, bh * s * 4
    bias = b * t * 4
    if kind == "forward":
        ops = 4.0 * bh * s * t * d
        nbytes = 2 * q_bytes + 2 * kv_bytes + bias + (rows if with_lse else 0)
    elif kind == "dq":
        ops = 6.0 * bh * s * t * d
        nbytes = 3 * q_bytes + 2 * kv_bytes + bias + 2 * rows
    else:
        ops = 8.0 * bh * s * t * d
        nbytes = 2 * q_bytes + 4 * kv_bytes + bias + 2 * rows
    return _bound(ops, nbytes, dtype) + (ops,)


def phase_flash_timings() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for label, shape in (("scoring", FLASH_SCORING), ("training", FLASH_TRAINING)):
        b, h, s, t, d = shape
        dtype = torch.bfloat16
        q, k, v, g, mask = _flash_inputs(b, h, s, t, d, dtype, "rows", gen)
        bias = flash.key_bias(mask)[:, None, None, :].to(dtype).expand(b, h, s, t)
        want_lse = label == "training"
        kinds = {"forward": (
            lambda: flash.flash_forward(q, k, v, mask, want_lse=want_lse),
            lambda: flash.flash_forward_reference(q, k, v, mask),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))}
        if label == "training":
            out, lse = flash.flash_forward(q, k, v, mask, want_lse=True)
            delta = flash.flash_delta(g, out)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)

            def sdpa_backward():
                torch.autograd.grad(sdpa_out, (qg, kg, vg), g, retain_graph=True)

            kinds["dq"] = (lambda: flash.flash_dq(q, k, v, mask, g, lse, delta),
                           lambda: flash.flash_dq_reference(q, k, v, mask, g, lse, delta),
                           sdpa_backward)
            kinds["dkv"] = (lambda: flash.flash_dkv(q, k, v, mask, g, lse, delta),
                            lambda: flash.flash_dkv_reference(q, k, v, mask, g, lse, delta),
                            sdpa_backward)
        for kind, (kernel, plain, library) in kinds.items():
            kernel_ms = time_ms(kernel, reps=FLASH_REPS)
            plain_ms = time_ms(plain, reps=FLASH_REPS, warmup=1)
            library_ms = time_ms(library, reps=FLASH_REPS)
            bound_ms, bound_by, ops = flash_bound(kind, b, h, s, t, d, dtype,
                                                  with_lse=want_lse)
            rows[(kind, label)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, shape=list(shape),
                                       variant=flash.variant(kind, dtype, d),
                                       bound_share=bound_ms / kernel_ms)
            emit("flash_timing", kernel=kind, label=label, shape=list(shape),
                 dtype="bfloat16", with_lse=want_lse if kind == "forward" else None,
                 variant=rows[(kind, label)]["variant"],
                 bound_share=rows[(kind, label)]["bound_share"],
                 ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                 library_call=("F.scaled_dot_product_attention with the additive "
                               "[B, T] bias" if kind == "forward" else
                               "torch.autograd.grad of that call's output: the whole "
                               "backward (dQ, dK and dV in one)"),
                 bound_ms=bound_ms, bound_by=bound_by, flops=ops,
                 tflops=ops / kernel_ms / 1e9, reps=FLASH_REPS)
        del q, k, v, g, mask, bias, kinds
        torch.cuda.empty_cache()
    return rows


# -- phases 7 and 8 ----------------------------------------------------------
def _alerts_by_id(alerts, threshold, detector_name="TorchScorerDetector"):
    """Alerts by logID, each checked for the fields every alert carries."""
    out = {}
    for raw in alerts:
        alert = DetectorSchema.from_bytes(raw)
        log_id = alert["logIDs"][0]
        want_ts = 1_700_000_000 + int(log_id)
        if (alert["detectorID"] != detector_name
                or alert["detectorType"] != "torch_scorer"
                or not alert["alertID"] or alert["detectionTimestamp"] <= 0
                or alert["receivedTimestamp"] <= 0
                or alert["extractedTimestamps"] != [want_ts]
                or alert["description"] != TorchScorerDetector.description
                or not alert["score"] > threshold
                or list(alert["alertsObtain"]) != [f"{detector_name} - score"]):
            raise AssertionError(f"malformed alert {alert!r}")
        out[log_id] = alert
    return out


def _flips(det_by_id, plain_by_id, plain_det, msgs, threshold, call: int) -> tuple:
    """Decisions that differ between two runs, and each one's distance from
    the threshold under the plain run's scores (scored in calls of at most
    ``call`` rows); fails beyond 1e-2."""
    flips = sorted(set(det_by_id) ^ set(plain_by_id), key=int)
    near = []
    if flips:
        tokens, ok = plain_det._featurize_raw_batch([msgs[int(i)] for i in flips])
        assert ok.all()
        scores = np.concatenate([plain_det.score_tokens(tokens[i:i + call])
                                 for i in range(0, len(tokens), call)])
        near = [float(abs(s - threshold)) for s in scores]
        if max(near) >= 1e-2:
            raise AssertionError(f"kernel and plain paths disagree beyond 1e-2 of "
                                 f"the threshold: {list(zip(flips, near))}")
    return flips, near


def phase_detector(device: str = "cuda") -> dict:
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": SCORER_CONFIG}})
    t0 = time.perf_counter()
    det.setup_io()
    setup_s = time.perf_counter() - t0
    train_msgs, _ = make_messages(SCORER_CONFIG["data_use_training"], anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(N_DETECT, anomaly_rate=0.01, seed=1)

    # the main path: launch counts 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    assert det.process_batch(train_msgs) == []   # sync fit at the boundary
    fit_s = time.perf_counter() - t0
    alerts = []
    t0 = time.perf_counter()
    for start in range(0, N_DETECT, CALL_SIZE):
        alerts.extend(det.process_batch(detect_msgs[start:start + CALL_SIZE]))
    alerts.extend(det.flush_final())
    detect_s = time.perf_counter() - t0
    counts = read_launches()
    launches = counts["candidate_lse"]

    threshold = det._threshold
    calib_chunks = -(-SCORER_CONFIG["data_use_training"] // 32)
    if det.path_counts["device"] != N_DETECT // CALL_SIZE or det.path_counts["host"]:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    if launches != calib_chunks + det.path_counts["device"]:
        raise AssertionError(f"kernel launched {launches} times on the main path, "
                             f"expected {calib_chunks} calibration chunks + "
                             f"{det.path_counts['device']} device batches")
    if counts["flash_forward"] or counts["flash_dq"] or counts["flash_dkv"]:
        raise AssertionError(f"the MLP path launched flash kernels: {counts}")
    variants = read_variants()["candidate_lse"]
    check_head_variants(variants, "wgmma_tma_d128_", launches, "MLP")
    if not np.isfinite(threshold):
        raise AssertionError(f"threshold {threshold} is not finite")

    by_id = _alerts_by_id(alerts, threshold)
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
    ein_by_id = _alerts_by_id(ein_alerts, threshold)
    flips, near = _flips(by_id, ein_by_id, ein, detect_msgs, threshold, CALL_SIZE)

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
        launches=launches, launch_counts=counts, variants=variants,
        calibration_launches=calib_chunks,
        device_batches=det.path_counts["device"],
        einsum_alerts=len(ein_by_id), decision_flips=len(flips),
        flip_distances=near, small_fp32_max_abs_err=small_err,
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if device == "cuda" else None))
    emit("detector", **result)
    if recall < 0.9:
        raise AssertionError(f"recall on the injected anomalies is {recall}")
    return result


def check_head_variants(variants: dict, prefix: str, launches: int, path: str) -> None:
    """Every fused-head launch of a path took a tensor-core variant at the
    path's D (``prefix``); fails otherwise."""
    if sum(variants.values()) != launches or \
            not all(name.startswith(prefix) for name in variants):
        raise AssertionError(f"the {path} path's {launches} fused-head launches took "
                             f"the variants {variants}, not all {prefix}*")


def logbert_expected_launches(device_batches: int) -> dict:
    """What the LogBERT path launches: the flash forward in every layer of
    every train step, calibration chunk and device batch; dQ and dK/dV in
    every layer of every train step; the fused head in every calibration
    chunk and device batch."""
    cfg = LOGBERT_CONFIG
    bs = 32  # train_batch_size
    steps_per_epoch = cfg["data_use_training"] // bs
    epochs = max(cfg["train_epochs"], -(-100 // steps_per_epoch))  # min_train_steps
    train_steps = epochs * steps_per_epoch
    calib = -(-cfg["data_use_training"] // bs)
    depth = cfg["depth"]
    return {"candidate_lse": calib + device_batches,
            "flash_forward": (train_steps + calib + device_batches) * depth,
            "flash_dq": train_steps * depth, "flash_dkv": train_steps * depth,
            "train_steps": train_steps, "calibration_chunks": calib}


def phase_logbert_detector() -> dict:
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": LOGBERT_CONFIG}})
    t0 = time.perf_counter()
    det.setup_io()
    setup_s = time.perf_counter() - t0
    if det._host_model is not None or det._host_scorer is not None:
        raise AssertionError("a flash-configured logbert built a host copy")
    train_msgs, _ = make_messages(LOGBERT_CONFIG["data_use_training"], anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(LOGBERT_DETECT, anomaly_rate=0.01, seed=1)
    torch.cuda.reset_peak_memory_stats()

    # the main path: launch counts 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    assert det.process_batch(train_msgs) == []   # sync fit at the boundary
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    alerts = []
    t0 = time.perf_counter()
    for start in range(0, LOGBERT_DETECT, LOGBERT_CALL):
        alerts.extend(det.process_batch(detect_msgs[start:start + LOGBERT_CALL]))
    alerts.extend(det.flush_final())
    detect_s = time.perf_counter() - t0
    counts = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    device_batches = det.path_counts["device"]
    if device_batches != LOGBERT_DETECT // LOGBERT_CALL or det.path_counts["host"]:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    expected = logbert_expected_launches(device_batches)
    if expected["train_steps"] != 112:
        raise AssertionError(f"the fit takes {expected['train_steps']} steps, not 112")
    for name in ("candidate_lse", "flash_forward", "flash_dq", "flash_dkv"):
        if counts[name] != expected[name]:
            raise AssertionError(f"{name} launched {counts[name]} times on the LogBERT "
                                 f"path, expected {expected[name]} ({expected})")
    # bf16 at head_dim 64: every flash launch took its wgmma variant, every
    # fused-head launch (D = 256) its tensor-core one
    variants = read_variants()
    want_variants = {name: {"wgmma_tma_d64": expected[name]}
                     for name in ("flash_forward", "flash_dq", "flash_dkv")}
    flash_variants = {name: variants[name] for name in want_variants}
    if flash_variants != want_variants:
        raise AssertionError(f"the LogBERT path took the flash variants "
                             f"{flash_variants}, expected {want_variants}")
    check_head_variants(variants["candidate_lse"], "wgmma_tma_d256_",
                        expected["candidate_lse"], "LogBERT")
    threshold = det._threshold
    if not np.isfinite(threshold):
        raise AssertionError(f"threshold {threshold} is not finite")
    by_id = _alerts_by_id(alerts, threshold)
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))

    # the same stream through einsum attention and the einsum head on the
    # same fitted weights, in calls of 64
    plain = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        LOGBERT_CONFIG, attn_impl="einsum", head_impl="einsum", data_use_training=0,
        score_threshold=threshold)}})
    plain.load_params(det._model.state_dict())
    plain_alerts = []
    t0 = time.perf_counter()
    for start in range(0, LOGBERT_DETECT, LOGBERT_PLAIN_CALL):
        plain_alerts.extend(plain.process_batch(
            detect_msgs[start:start + LOGBERT_PLAIN_CALL]))
    plain_alerts.extend(plain.flush_final())
    plain_s = time.perf_counter() - t0
    if read_launches() != counts:
        raise AssertionError("the einsum paths launched a kernel")
    plain_by_id = _alerts_by_id(plain_alerts, threshold)
    flips, near = _flips(by_id, plain_by_id, plain, detect_msgs, threshold,
                         LOGBERT_PLAIN_CALL)

    # a small fp32 input: the kernels on the card against the plain versions
    # on the host, same weights
    cfg32 = dataclasses.replace(det._scorer.config, dtype=torch.float32)
    scorer = type(det._scorer)(cfg32)
    model_dev = scorer.clone_model(det._model, torch.device("cuda"))
    model_cpu = scorer.clone_model(det._model, torch.device("cpu"))
    tokens, _ = det._featurize_raw_batch(detect_msgs[:4])
    before = read_launches()
    got = scorer.score(model_dev, torch.from_numpy(tokens).cuda()).cpu()
    if read_launches()["flash_forward"] == before["flash_forward"]:
        raise AssertionError("the fp32 check did not run the flash kernel")
    want = scorer.score(model_cpu, torch.from_numpy(tokens))
    small_err = (got - want).abs().max().item()
    if got.shape != (4,) or not torch.isfinite(got).all() or \
            not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"fp32 LogBERT scores on the card disagree with the "
                             f"host: {got} vs {want}")

    result = dict(
        setup_s=setup_s, fit_s=fit_s, detect_s=detect_s, plain_detect_s=plain_s,
        lines_per_s=LOGBERT_DETECT / detect_s, n_detect=LOGBERT_DETECT,
        call_size=LOGBERT_CALL, threshold=threshold, alerts=len(by_id),
        anomalies=len(anomalies), recall=recall,
        precision=len(anomalies & set(by_id)) / max(1, len(by_id)),
        launch_counts=counts, expected_launches=expected, variants=variants,
        device_batches=device_batches, plain_alerts=len(plain_by_id),
        decision_flips=len(flips), flip_distances=near,
        small_fp32_max_abs_err=small_err, peak_mem_gib=peak_gib)
    emit("logbert_detector", **result)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, _smi = phase_card()
    main_path_ptxas = phase_build()
    lse_err = phase_kernel_checks()
    lse_times = phase_timings()
    flash_err = phase_flash_checks()
    flash_times = phase_flash_timings()
    mlp = phase_detector()
    torch.cuda.empty_cache()
    logbert = phase_logbert_detector()
    mlp_row = lse_times[(CALL_SIZE, 128)]
    kernels = [{
        "name": "candidate_lse",
        "route": "cuda",
        "source": "detectmateservice_tpu_torch/ops/csrc/scorehead.cu",
        "replaces": "detectmateservice_tpu/ops/scorehead.py:55",
        "launches": mlp["launches"] + logbert["launch_counts"]["candidate_lse"],
        "launches_by_path": {"mlp": mlp["launches"],
                             "logbert": logbert["launch_counts"]["candidate_lse"]},
        "max_abs_err": lse_err,
        "ms": mlp_row["ms"],
        "plain_ms": mlp_row["plain_ms"],
        "bound_ms": mlp_row["bound_ms"],
        "bound_by": mlp_row["bound_by"],
        "library_ms": mlp_row["library_ms"],
        "shape": [CALL_SIZE, 32768, 128],
        "variant": mlp_row["variant"],
        "bound_share": mlp_row["bound_share"],
        "launches_by_variant": {"mlp": mlp["variants"],
                                "logbert": logbert["variants"]["candidate_lse"]},
        "ptxas": {name: main_path_ptxas[MAIN_PATH_WGMMA[name]]
                  for name in ("lse_d128", "lse_d256", "lse_combine")},
        "logbert_calibration_shape": dict(shape=[65536, 32768, 256],
                                          **lse_times[(65536, 256)]),
        "logbert_detect_shape": dict(shape=[524288, 32768, 256],
                                     **lse_times[(524288, 256)]),
        "mlp_calibration_shape": dict(shape=[32, 32768, 128], **lse_times[(32, 128)]),
    }]
    replaces = {"forward": "detectmateservice_tpu/ops/flash.py:64",
                "dq": "detectmateservice_tpu/ops/flash.py:221",
                "dkv": "detectmateservice_tpu/ops/flash.py:247"}
    main_label = {"forward": "scoring", "dq": "training", "dkv": "training"}
    for kind, fn_name in (("forward", "flash_forward"), ("dq", "flash_dq"),
                          ("dkv", "flash_dkv")):
        row = flash_times[(kind, main_label[kind])]
        entry = {
            "name": fn_name, "route": "cuda",
            "source": "detectmateservice_tpu_torch/ops/csrc/flash.cu",
            "replaces": replaces[kind],
            "launches": logbert["launch_counts"][fn_name],
            "max_abs_err": flash_err[fn_name],
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "shape", "variant",
                                         "bound_share")},
            "launches_by_variant": logbert["variants"][fn_name],
        }
        if kind in MAIN_PATH_WGMMA:
            entry["ptxas"] = main_path_ptxas[MAIN_PATH_WGMMA[kind]]
        if kind == "forward":
            entry["training_shape"] = flash_times[("forward", "training")]
        kernels.append(entry)
    spilled = {name: row for name, row in main_path_ptxas.items()
               if row is None or row.get("spill_stores") or row.get("spill_loads")}
    if spilled:
        raise AssertionError(f"ptxas reports spills (or no entry) for {spilled}")
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
