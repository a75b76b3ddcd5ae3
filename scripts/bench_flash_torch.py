"""Compare versions of the port's flash and fused-head kernels on one CUDA
card.

    python3 scripts/bench_flash_torch.py [ROOT ...]

Each ROOT is a directory that holds a copy of ``detectmateservice_tpu_torch``
(default: the repo root), for example a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists. Each runs in a process
of its own, in the order given, so list them as parent, change, change,
parent to see the spread. For each it builds ``ops/csrc/flash.cu`` and
``ops/csrc/scorehead.cu``, holds the 16-bit kernels against their plain
versions on a few edge shapes (as ``chip_smoke.py`` phases 3 and 5 do),
times the flash forward at the LogBERT scoring and training shapes, dQ and
dK/dV at the training shape (median of 20 CUDA-event timings) and the fused
head at the main paths' shapes (median of 25, 5 at N = 524,288), and prints
one JSON line with the times, the checks and the tensor-core kernels'
``ptxas`` registers and spills. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_CASES = [
    (2, 3, 200, 384, 64, "bfloat16", "random", True, "contiguous"),
    (2, 2, 70, 90, 64, "bfloat16", "one_row_masked", True, "contiguous"),
    (3, 2, 300, 300, 128, "bfloat16", "rows", True, "contiguous"),
    (4, 4, 520, 520, 64, "bfloat16", "rows", True, "qkv"),
    (32, 4, 2048, 2048, 64, "bfloat16", "rows", True, "contiguous"),
]
# (N, C, D) of the fused-head checks, bf16
LSE_CHECKS = [(100, 1031, 128), (100, 613, 256), (32, 32768, 128), (4096, 32768, 128)]
# (N, D) of the fused-head timings at C = 32768, bf16
LSE_TIMED = [(32, 128), (4096, 128), (16384, 128), (65536, 256), (524288, 256)]


def measure(root: str) -> dict:
    """Build, check and time the kernels of the package under root."""
    sys.path[:0] = [root, REPO]
    import torch

    import chip_smoke
    from detectmateservice_tpu_torch.ops import cuda_build, flash, scorehead

    for module in (flash, scorehead):
        if not module.__file__.startswith(os.path.abspath(root)):
            raise RuntimeError(f"imported {module.__file__}, not the copy under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    reports = cuda_build.build_all([flash.SOURCE, scorehead.SOURCE])
    ptxas = {name: row for report in reports.values()
             for name, row in chip_smoke.ptxas_summary(report).items()
             if "wgmma" in name or "lse" in name}
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = {}
    for case in CHECK_CASES:
        case = case[:5] + (getattr(torch, case[5]),) + case[6:]
        results = chip_smoke.flash_case_results(case, gen)
        checks[str(list(case[:5]))] = {
            "ok": all(r[0] for r in results.values()),
            **{name: r[1] for name, r in results.items()}}
    for n, c, d in LSE_CHECKS:
        h, e = chip_smoke._lse_inputs(n, c, d, torch.bfloat16, gen)
        err = (scorehead.candidate_lse(h, e) - chip_smoke.lse_plain(h, e)).abs().max().item()
        checks[f"lse {[n, c, d]}"] = {"ok": err <= 2e-3, "max_abs_err": err}
    gen = torch.Generator(device="cuda").manual_seed(3)
    times = {}
    for label, shape in (("scoring", chip_smoke.FLASH_SCORING),
                         ("training", chip_smoke.FLASH_TRAINING)):
        b, h, s, t, d = shape
        q, k, v, g, mask = chip_smoke._flash_inputs(b, h, s, t, d, torch.bfloat16,
                                                    "rows", gen)
        want_lse = label == "training"
        times[f"forward_{label}_ms"] = chip_smoke.time_ms(
            lambda: flash.flash_forward(q, k, v, mask, want_lse=want_lse),
            reps=chip_smoke.FLASH_REPS)
        if want_lse:
            out, lse = flash.flash_forward(q, k, v, mask, want_lse=True)
            delta = flash.flash_delta(g, out)
            times["dq_training_ms"] = chip_smoke.time_ms(
                lambda: flash.flash_dq(q, k, v, mask, g, lse, delta),
                reps=chip_smoke.FLASH_REPS)
            times["dkv_training_ms"] = chip_smoke.time_ms(
                lambda: flash.flash_dkv(q, k, v, mask, g, lse, delta),
                reps=chip_smoke.FLASH_REPS)
        del q, k, v, g, mask
        torch.cuda.empty_cache()
    for n, d in LSE_TIMED:
        h, e = chip_smoke._lse_inputs(n, 32768, d, torch.bfloat16, gen)
        times[f"lse_n{n}_d{d}_ms"] = chip_smoke.time_ms(
            lambda: scorehead.candidate_lse(h, e), reps=5 if n > 65536 else 25)
        del h, e
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "times": times, "checks": checks, "ptxas": ptxas}


def main(argv: list) -> int:
    roots = argv or [REPO]
    if len(roots) == 1:
        print(json.dumps(measure(roots[0])), flush=True)
        return 0
    rc = 0
    for root in roots:
        rc |= subprocess.run([sys.executable, __file__, root], check=False,
                             timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
