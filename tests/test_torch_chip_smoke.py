"""chip_smoke.py's refusals: without a CUDA device, and without the repo
around it, it exits non-zero and prints no result line. Its pieces that do
not need the card are checked on the CPU."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
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


def _case(case):
    return dict(zip(("b", "h", "s", "t", "d", "dtype", "mask", "backward", "layout"),
                    case))


def test_flash_cases_give_the_bf16_wgmma_variants_every_edge():
    """bf16 twins of the ragged, tiny and fully masked fp32 edge cases, a
    bf16 D = 128 case with real-row masks and one case of strided q, k, v
    views of one qkv tensor, all with a backward."""
    cases = [_case(c) for c in chip_smoke.FLASH_CASES]
    bf16 = [c for c in cases if c["dtype"] == torch.bfloat16 and c["backward"]]
    fp32 = [c for c in cases if c["dtype"] == torch.float32]
    for edge in fp32:
        if edge["d"] == 64:  # the fp32 edges at the main path's head dim
            twin = dict(edge, dtype=torch.bfloat16)
            assert twin in bf16, f"no bf16 twin of {edge}"
    assert any(c["s"] % 128 and c["t"] % 128 for c in bf16)          # ragged
    assert any(c["mask"] == "one_row_masked" for c in bf16)           # fully masked row
    assert any(c["s"] == c["t"] == 1 for c in bf16)                   # 1 x 1
    assert any(c["d"] == 128 and c["mask"] == "rows" for c in bf16)   # D = 128
    strided = [c for c in bf16 if c["layout"] == "qkv"]
    assert strided and all(c["s"] == c["t"] for c in strided)
    assert {c["layout"] for c in cases} == {"contiguous", "qkv"}


def test_library_yardstick_covers_every_row_in_chunks():
    """The kernel-1 library call runs over row chunks of 65,536 where its
    bf16 [N, C] product would not fit: 8 chunks at N = 524,288."""
    n = 524288
    chunks = chip_smoke.row_chunks(n, chip_smoke.LSE_LIBRARY_ROWS)
    assert len(chunks) == 8
    assert [sl.start for sl in chunks] == list(range(0, n, 65536))
    assert chunks[-1].stop == n
    covered = torch.zeros(n, dtype=torch.int32)
    for sl in chunks:
        covered[sl] += 1
    assert bool((covered == 1).all())
    assert chip_smoke.row_chunks(65536, chip_smoke.LSE_LIBRARY_ROWS) == [slice(0, 65536)]
    assert chip_smoke.row_chunks(100, 16384) == [slice(0, 100)]


def test_library_yardstick_equals_one_call_where_one_fits():
    h = torch.randn(300, 16)
    e = torch.randn(40, 16)
    one = torch.logsumexp(torch.matmul(h, e.T).float(), -1)
    torch.testing.assert_close(chip_smoke.lse_library(h, e), one)


_PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__31bccdf4_8_flash_cu_d04ea39622flash_fwd_wgmma_kernelILi64E13__nv_bfloat16EEvNS_6TcArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__31bccdf4_8_flash_cu_d04ea39622flash_fwd_wgmma_kernelILi64E13__nv_bfloat16EEvNS_6TcArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__31bccdf4_8_flash_cu_d04ea39615flash_dq_kernelILi128EfEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__31bccdf4_8_flash_cu_d04ea39615flash_dq_kernelILi128EfEEvNS_6ParamsE
    24 bytes stack frame, 24 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b1a7c10f_12_scorehead_cu_b7acb64510lse_kernelI6__halfEEvPKT_S4_Pfiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b1a7c10f_12_scorehead_cu_b7acb64516lse_wgmma_kernelILi256E13__nv_bfloat16EEvNS_7LseArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b1a7c10f_12_scorehead_cu_b7acb64518lse_combine_kernelEPKfPfii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers
"""


def test_ptxas_summary_reads_registers_and_spills_per_kernel():
    got = chip_smoke.ptxas_summary(_PTXAS)
    assert got == {
        "flash_fwd_wgmma_kernel<64, bf16>": {"stack": 0, "spill_stores": 0,
                                             "spill_loads": 0, "registers": 168},
        "flash_dq_kernel<128, fp32>": {"stack": 24, "spill_stores": 24,
                                       "spill_loads": 40, "registers": 255},
        "lse_kernel<fp16>": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                             "registers": 64},
        "lse_wgmma_kernel<256, bf16>": {"stack": 0, "spill_stores": 0,
                                        "spill_loads": 0, "registers": 168},
        "lse_combine_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                               "registers": 18},
    }
    # every tensor-core kernel of the main paths, keyed as ptxas_summary
    # names them, and none of them may spill
    assert chip_smoke.MAIN_PATH_WGMMA == {
        "forward": "flash_fwd_wgmma_kernel<64, bf16>",
        "dq": "flash_dq_wgmma_kernel<64, bf16>",
        "dkv": "flash_dkv_wgmma_kernel<64, bf16>",
        "lse_d128": "lse_wgmma_kernel<128, bf16>",
        "lse_d256": "lse_wgmma_kernel<256, bf16>",
        "lse_combine": "lse_combine_kernel"}
    assert set(chip_smoke.NO_SPILL) == {*chip_smoke.MAIN_PATH_WGMMA.values(),
                                        "flash_dq_wgmma_kernel<128, bf16>"}


def test_lse_cases_give_the_tensor_core_variants_every_edge():
    """bf16 twins of the ragged-C edge at every D the plan takes (613 and
    1031 columns, not whole 128-column stages), N = 1 at both main-path
    widths, the MLP calibration bucket N = 32, fp16 at D = 256 with N = 1,
    32 and 37, and the extreme values; the fp32 cases stay."""
    cases = set(chip_smoke.LSE_CASES)
    bf16 = torch.bfloat16
    for c in (613, 1031):
        for d in (64, 128, 256):
            assert (100, c, d, bf16) in cases
    assert {(1, 32768, 128, bf16), (1, 32768, 256, bf16), (32, 32768, 128, bf16),
            (37, 64, 256, torch.float16), (32, 1031, 256, torch.float16),
            (1, 1031, 256, torch.float16), (16, 16, 32, bf16)} <= cases
    fp32 = {case for case in cases if case[3] == torch.float32}
    assert fp32 == {(1000, 2048, 128, torch.float32), (100, 613, 16, torch.float32),
                    (16, 16, 32, torch.float32)}
    # every main-path bucket is timed, the MLP calibration one included
    assert {(32, 128), (4096, 128), (16384, 128), (65536, 256),
            (524288, 256)} <= set(chip_smoke.LSE_TIMED)


def test_head_variant_check_wants_every_launch_at_the_paths_width():
    chip_smoke.check_head_variants({"wgmma_tma_d128_split64": 64,
                                    "wgmma_tma_d128_split12": 16}, "wgmma_tma_d128_", 80,
                                   "MLP")
    for variants, launches in (({"cuda_core": 80}, 80),
                               ({"wgmma_tma_d128_split12": 16}, 80),
                               ({"wgmma_tma_d256_split1": 32}, 32)):
        with pytest.raises(AssertionError, match="fused-head launches"):
            chip_smoke.check_head_variants(variants, "wgmma_tma_d128_", launches, "MLP")
