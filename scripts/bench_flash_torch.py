"""Compare versions of the port's flash kernels on one CUDA card.

    python3 scripts/bench_flash_torch.py [ROOT ...]

Each ROOT is a directory that holds a copy of ``detectmateservice_tpu_torch``
(default: the repo root), for example a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists. Each runs in a process
of its own, in the order given, so list them as parent, change, change,
parent to see the spread. For each it builds ``ops/csrc/flash.cu``, holds
the 16-bit kernels against their plain versions on a few edge shapes (as
``chip_smoke.py`` phase 5 does), times the forward at the LogBERT scoring
and training shapes and dK/dV at the training shape (median of 20
CUDA-event timings), and prints one JSON line with the times, the checks
and the wgmma kernels' ``ptxas`` registers and spills. Imports nothing of
JAX.
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


def measure(root: str) -> dict:
    """Build, check and time the flash kernels of the package under root."""
    sys.path[:0] = [root, REPO]
    import torch

    import chip_smoke
    from detectmateservice_tpu_torch.ops import cuda_build, flash

    if not flash.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {flash.__file__}, not the copy under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = cuda_build.build(flash.SOURCE)
    ptxas = {name: row for name, row in chip_smoke.ptxas_summary(report).items()
             if "wgmma" in name}
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = {}
    for case in CHECK_CASES:
        case = case[:5] + (getattr(torch, case[5]),) + case[6:]
        results = chip_smoke.flash_case_results(case, gen)
        checks[str(list(case[:5]))] = {
            "ok": all(r[0] for r in results.values()),
            **{name: r[1] for name, r in results.items()}}
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
            times["dkv_training_ms"] = chip_smoke.time_ms(
                lambda: flash.flash_dkv(q, k, v, mask, g, lse, delta),
                reps=chip_smoke.FLASH_REPS)
        del q, k, v, g, mask
        torch.cuda.empty_cache()
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
                             timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
