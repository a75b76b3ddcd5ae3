"""chip_smoke.py's refusals: without a CUDA device, and without the repo
around it, it exits non-zero and prints no result line. Its pieces that do
not need the card are checked on the CPU."""
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench_torch  # noqa: E402  (the scripts live at the repo root)
import chip_smoke  # noqa: E402
from detectmateservice_tpu_torch.schemas import ParserSchema  # noqa: E402


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


def test_gru_launch_counts_follow_the_fit():
    """512 messages with position norm: a held-out split of 102 rows (4
    calibration chunks of 32 rows, N = 1,024 head rows each) and 410 train
    rows in steps of 32 over max(4, ceil(100 / 12)) = 9 epochs: 108 steps,
    which launch no kernel; 16 detect batches of N = 131,072 rows."""
    want = chip_smoke.gru_expected_launches(device_batches=16)
    assert want == {"candidate_lse": 4 + 16, "train_steps": 108, "calibration_chunks": 4,
                    "calibration_rows": 1024, "detect_rows": 131072}
    cfg = chip_smoke.GRU_CONFIG
    assert (cfg["model"], cfg["head_impl"], cfg["score_norm"]) == ("gru", "pallas", "position")
    assert (cfg["vocab_size"], cfg["dim"], cfg["depth"], cfg["seq_len"], cfg["max_batch"]) == \
        (32768, 128, 1, 32, 4096)
    assert chip_smoke.GRU_DETECT // chip_smoke.GRU_CALL == 16


def test_gru_config_is_the_example_but_the_head():
    """examples/gru_config.yaml's values, with head_impl pallas (and a
    synchronous fit) the only additions."""
    import yaml

    example = yaml.safe_load((REPO / "examples" / "gru_config.yaml").read_text())
    example = example["detectors"]["JaxScorerDetector"]
    cfg = dict(chip_smoke.GRU_CONFIG)
    for key, value in example.items():
        if key != "method_type":
            assert cfg.pop(key) == value, key
    assert cfg == {"method_type": "torch_scorer", "vocab_size": 32768, "head_impl": "pallas",
                   "dtype": "auto", "async_fit": False}


def test_int8_launch_counts_and_config():
    """Phase 7's configuration under int8w: 64 calibration chunks, the
    512-row parity corpus scored twice in chunks of 32, 16 detect batches."""
    want = chip_smoke.int8_expected_launches(device_batches=16)
    assert want == {"candidate_lse": 64 + 32 + 16, "calibration_chunks": 64,
                    "parity_chunks": 32, "device_batches": 16}
    assert chip_smoke.INT8_CONFIG == dict(chip_smoke.SCORER_CONFIG, dtype="int8w")


def test_gru_path_shapes_are_checked_and_timed():
    cases = set(chip_smoke.LSE_CASES)
    assert {(131072, 32768, 128, torch.bfloat16), (1024, 32768, 128, torch.bfloat16)} <= cases
    assert {(131072, 128), (1024, 128)} <= set(chip_smoke.LSE_TIMED)
    # the library yardstick runs the 8 GiB bf16 product in two chunks
    assert len(chip_smoke.row_chunks(131072, chip_smoke.LSE_LIBRARY_ROWS)) == 2


def test_frames_launch_counts_and_config():
    """Phase 7b: 64 calibration chunks, then the warm-up batch and 4 timed
    batches of 16,384 rows (32 frames of 512 a call); the lone messages
    launch nothing. The configuration is bench_torch.py's."""
    want = chip_smoke.frames_expected_launches(device_batches=5)
    assert want == {"candidate_lse": 64 + 5, "calibration_chunks": 64, "device_batches": 5}
    assert chip_smoke.SCORER_CONFIG == dict(bench_torch.BENCH_SCORER_CONFIG, dtype="auto")
    assert chip_smoke.N_DETECT // chip_smoke.SCORER_CONFIG["max_batch"] == 4
    assert chip_smoke.SCORER_CONFIG["max_batch"] // bench_torch.FRAME_N == 32


def test_frames_phase_line_on_the_cpu(monkeypatch, capsys):
    """Phase 7b at a tiny width on the CPU, with a counting stand-in for the
    fused head (its plain version underneath): rows bit-equal both ways,
    exact launches, no Python rows, recall, and one JSON line."""
    import json
    from collections import Counter

    from detectmateservice_tpu_torch.models import base
    from detectmateservice_tpu_torch.ops import scorehead

    def stand_in(h, e):
        stand_in.launches += 1
        stand_in.variants[f"wgmma_tma_d{h.shape[1]}_split1"] += 1
        return scorehead.candidate_lse_reference(h, e)

    stand_in.launches, stand_in.variants = 0, Counter()
    stand_in.__name__ = "candidate_lse"
    monkeypatch.setattr(scorehead, "candidate_lse", stand_in)
    monkeypatch.setattr(base, "candidate_lse", stand_in)
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", (stand_in, *chip_smoke.KERNEL_WRAPPERS[1:]))
    monkeypatch.setattr(chip_smoke, "SCORER_CONFIG", dict(
        chip_smoke.SCORER_CONFIG, vocab_size=1024, dim=128, max_batch=1024,
        data_use_training=128))
    monkeypatch.setattr(chip_smoke, "N_DETECT", 4096)
    result = chip_smoke.phase_frames("cpu", device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "frames" and line["card"] == "cpu"
    assert result["rows_bit_equal"] == {"batch": True, "frames": True}
    assert set(result["featurize_s"]) == {"native_batch", "native_frames", "python"}
    assert result["path_counts"] == {"device": 5, "host": 64}
    assert result["p50_paths"] == {"device": 0, "host": 64}
    assert result["launches"] == 4 + 5 == stand_in.launches
    assert result["featurize_rows"]["fallback"] == 0
    assert result["recall"] >= 0.9


def test_service_phase_on_the_cpu(monkeypatch, capsys):
    """Phase 12 at a tiny width on the CPU, with a counting stand-in for the
    fused head: every line read, every alert received once, the detector's
    own decisions, the admin plane, the restore and the CLI subprocess."""
    import json
    from collections import Counter

    from detectmateservice_tpu_torch.models import base
    from detectmateservice_tpu_torch.ops import scorehead

    def stand_in(h, e):
        stand_in.launches += 1
        stand_in.variants[f"wgmma_tma_d{h.shape[1]}_split1"] += 1
        return scorehead.candidate_lse_reference(h, e)

    stand_in.launches, stand_in.variants = 0, Counter()
    stand_in.__name__ = "candidate_lse"
    monkeypatch.setattr(scorehead, "candidate_lse", stand_in)
    monkeypatch.setattr(base, "candidate_lse", stand_in)
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", (stand_in, *chip_smoke.KERNEL_WRAPPERS[1:]))
    monkeypatch.setattr(chip_smoke, "SCORER_CONFIG", dict(
        chip_smoke.SCORER_CONFIG, vocab_size=1024, dim=128, max_batch=1024,
        data_use_training=128, dtype="float32"))
    monkeypatch.setattr(chip_smoke, "SERVICE_DETECT", 4096)
    monkeypatch.setattr(chip_smoke, "SERVICE_CLI_DETECT", 512)
    result = chip_smoke.phase_service("cpu", 1.0, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "service" and line["card"] == "cpu"
    assert result["read_lines"] == result["lines_sent"] > 4096
    assert result["written_lines"] == result["received_alert_lines"] > 0
    assert result["alerts"] == result["unique_alerts"] and result["recall"] >= 0.9
    # the calibration chunks and the device batches of the stream
    assert stand_in.launches > result["launches"] > 128 // 32
    assert result["health"] == 200 and result["checkpointed"]
    assert result["restore"] == {"threshold_equal": True, "bit_equal": True}
    assert result["cli"]["returncode"] == 0 and result["cli"]["alerts"] > 0
    assert result["lone_p99_ms"] >= result["lone_p50_ms"] > 0


def test_bench_torch_messages_match_bench_generator():
    import bench

    assert bench_torch.make_messages(300, anomaly_rate=0.05, seed=4) == \
        bench.make_messages(300, anomaly_rate=0.05, seed=4)
    msgs, _ = chip_smoke.make_messages(50, seed=1)
    assert msgs == bench_torch.make_messages(50, seed=1)


def test_bench_torch_config_is_bench_py_but_two_fields():
    import bench

    cfg = dict(bench_torch.BENCH_SCORER_CONFIG)
    assert cfg.pop("method_type") == "torch_scorer" and cfg.pop("head_impl") == "pallas"
    ref = dict(bench.BENCH_SCORER_CONFIG)
    ref.pop("method_type")
    assert cfg == ref
    assert bench_torch.FULL_N == bench.FULL_N


def test_bench_torch_drive_on_the_cpu():
    det = bench_torch.build_detector("cpu", dict(
        bench_torch.BENCH_SCORER_CONFIG, vocab_size=1024, dim=16, max_batch=1024,
        data_use_training=64))
    assert det.config.dtype == "float32" and det.config.device == "cpu"
    det.setup_io()
    run = bench_torch.drive(det, 2048)
    assert run["n"] == 2048 and run["lines_per_s"] > 0 and run["p50_ms"] > 0
    assert run["p50_paths"] == {"device": 0, "host": bench_torch.N_SINGLE}
    assert det.path_counts["device"] == 1 + 2048 // 1024
    # fit, warm-up, timed frames and lone messages: all native
    assert det.featurize_rows == {"native": 64 + 1024 + 2048 + bench_torch.N_SINGLE,
                                  "fallback": 0}
    assert all(isinstance(a, bytes) for a in run["alerts"])


def test_bench_torch_without_a_cuda_device_exits_2():
    proc = subprocess.run([sys.executable, "bench_torch.py", "--n", "512"], cwd=REPO,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 2
    assert "metric" not in proc.stdout


def _counting_stand_in(monkeypatch):
    """A counting stand-in for the fused head (its plain version under it),
    bound where the scorers and the script look it up."""
    from collections import Counter

    from detectmateservice_tpu_torch.models import base
    from detectmateservice_tpu_torch.ops import scorehead

    def stand_in(h, e):
        stand_in.launches += 1
        stand_in.variants[f"wgmma_tma_d{h.shape[1]}_split1"] += 1
        return scorehead.candidate_lse_reference(h, e)

    stand_in.launches, stand_in.variants = 0, Counter()
    stand_in.__name__ = "candidate_lse"
    monkeypatch.setattr(scorehead, "candidate_lse", stand_in)
    monkeypatch.setattr(base, "candidate_lse", stand_in)
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", (stand_in, *chip_smoke.KERNEL_WRAPPERS[1:]))
    return stand_in


def test_coalesce_files_change_only_what_the_phase_names(tmp_path):
    """The example's settings and config, with head_impl pallas, the
    addresses under the temp directory, a free HTTP port and the port's
    component type the only changes (on the card: no device)."""
    import yaml

    settings = yaml.safe_load(chip_smoke.coalesce_files(tmp_path).read_text())
    config = yaml.safe_load((tmp_path / "scorer_config.yaml").read_text())
    example = yaml.safe_load((REPO / "examples" / "scorer_settings.yaml").read_text())
    example_cfg = yaml.safe_load((REPO / "examples" / "scorer_config.yaml").read_text())
    moved = {k for k in set(settings) | set(example) if settings.get(k) != example.get(k)}
    assert moved == {"component_type", "engine_addr", "out_addr", "http_port", "log_dir",
                     "config_file"}
    assert settings["component_type"] == chip_smoke.TORCH_SCORER
    assert all(str(tmp_path) in str(settings[k])
               for k in ("engine_addr", "out_addr", "log_dir", "config_file"))
    block = config["detectors"]["TorchScorerDetector"]
    ref = example_cfg["detectors"]["JaxScorerDetector"]
    assert {k: v for k, v in block.items() if ref.get(k) != v} == {
        "method_type": "torch_scorer", "head_impl": "pallas"}
    assert set(ref) <= set(block)
    # the example's own widths and batching
    assert (block["dim"], block["seq_len"], block["max_batch"], block["score_norm"],
            block["data_use_training"], block["batch_deadline_ms"]) == \
        (128, 32, 1024, "position", 512, 8.0)
    assert settings["engine_batch_size"] == 32 and settings["engine_batch_timeout_ms"] == 2.0


def test_replays_add_the_launches_their_capture_recorded(monkeypatch):
    """A replay runs no wrapper code: the counts move by what the capture
    recorded, once per replay; the capture itself leaves them as they
    were. Exercised with a stand-in graph on the CPU."""
    import collections

    from detectmateservice_tpu_torch.engine.device_obs import CompileLedger
    from detectmateservice_tpu_torch.library.detectors import graphs

    stand_in = _counting_stand_in(monkeypatch)

    class Replayable:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1

    warm = graphs.WarmSet(torch.device("cpu"), CompileLedger(), "cuda",
                          eager=lambda kind, t: torch.zeros(len(t)), ident=lambda kind: None)
    # a capture that launched the head twice (a split launch counts once,
    # two heads twice): recorded on the entry, and the counts restored
    warm.cuda = True
    graph = Replayable()
    warm._entries[("score", 4)] = graphs._Entry(
        graph, torch.zeros(4, 2, dtype=torch.int16), torch.arange(4.0), None,
        [(2, collections.Counter({"wgmma_tma_d128_split1": 2})), (0, collections.Counter()),
         (0, collections.Counter()), (0, collections.Counter())], 0.0)
    out = warm.run("score", torch.ones(4, 2, dtype=torch.int16))
    out2 = warm.run("score", torch.ones(4, 2, dtype=torch.int16))
    assert graph.replays == 2 and out.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert out.data_ptr() != out2.data_ptr()      # a copy, not the static output
    assert stand_in.launches == 4 and stand_in.variants["wgmma_tma_d128_split1"] == 4
    assert warm.replay_launches["candidate_lse"] == 4
    assert warm.replays[("score", 4)] == 2

    class FakeDet:
        _warm = warm

    assert chip_smoke.replayed(FakeDet()) == {"candidate_lse": 4, "flash_forward": 0,
                                              "flash_dq": 0, "flash_dkv": 0}
    got = chip_smoke.replay_delta(FakeDet(), {"candidate_lse": 1})
    assert chip_smoke.check_replays(got, {"candidate_lse": 3}, "test")["candidate_lse"] == 3
    with pytest.raises(AssertionError, match="graph replays"):
        chip_smoke.check_replays(chip_smoke.replay_delta(FakeDet(), {}),
                                 {"candidate_lse": 3}, "test")


def test_a_cpu_capture_leaves_the_launch_counts(monkeypatch):
    from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector

    stand_in = _counting_stand_in(monkeypatch)
    det = TorchScorerDetector(config=dict(
        chip_smoke.SCORER_CONFIG, vocab_size=1024, dim=16, max_batch=64, device="cpu",
        dtype="float32", head_impl="pallas"))
    det.setup_io()
    assert stand_in.launches == 0 and det._warm.captures == 2   # buckets 32 and 64
    det._warm.capture("score", 4, det._zero_upload(4))
    assert stand_in.launches == 0
    det.score_tokens(np.zeros((4, 32), np.int32))   # scoring itself counts
    assert stand_in.launches == 1


def test_timeless_alerts_differ_only_in_the_wall_clock_stamps():
    from detectmateservice_tpu_torch.schemas import DetectorSchema

    doc = DetectorSchema(detectorID="d", alertID="7", detectionTimestamp=123,
                         receivedTimestamp=456, extractedTimestamps=[789], score=2.5)
    out = DetectorSchema.from_bytes(chip_smoke._timeless(doc.serialize()))
    assert (out["detectionTimestamp"], out["receivedTimestamp"]) == (0, 0)
    assert (out["alertID"], out["extractedTimestamps"], out["score"]) == ("7", [789], 2.5)


def test_coalesce_phase_on_the_cpu(monkeypatch, capsys):
    """Phase 13 at a narrowed width on the CPU with a counting stand-in for
    the fused head: (a) the example hosted by the Service, fed by a sender
    process, every check of the phase; (b) a bucket retires, pads up and
    comes back through one expected capture; (c) upload workers give the
    inline alerts."""
    import json

    _counting_stand_in(monkeypatch)
    monkeypatch.setattr(chip_smoke, "COALESCE_DETECT", 4096)
    # (b)'s resurrection needs three small releases inside one sweep interval
    # (a sweep restarts the pressure count): on a loaded host one release
    # of 200 rows scored on the CPU can take a third of a second
    monkeypatch.setattr(chip_smoke, "COALESCE_RETIRE_S", 3.0)
    result = chip_smoke.phase_coalesce("cpu", device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == ["coalesce", "coalesce_retire",
                                                 "coalesce_workers"]
    assert result["read_lines"] == result["lines_sent"]
    assert result["alerts"] == result["unique_alerts"] and result["recall"] >= 0.9
    # the wait bound is held on the card, where scoring leaves the loop
    assert result["release_wait_bound_ms"] == 12.0 and result["max_release_wait_ms"] > 0
    assert result["xla"]["totals"]["unexpected"] == 0 and result["unexpected_metric"] == 0
    assert sum(result["releases_with_lone"].values()) == sum(result["releases_metric"].values())
    assert result["deep_health"]["after"] == 200
    assert 256 in result["retire"]["retired_buckets"] and result["retire"]["graph_dropped"]
    assert [e["where"] for e in result["retire"]["resurrection_captures"]] == ["bucket_warm"]
    assert result["workers"]["identical"] and result["workers"]["workers_after"] == []


def test_lifecycle_settings_are_the_defaults_but_the_named_cuts():
    """Rollout, drift and capacity on, every other field of theirs at the
    JAX default, and only the cuts for run time away from it."""
    from detectmateservice_tpu_torch.settings import ServiceSettings

    cuts = {"rollout_interval_s": 3600.0, "drift_interval_s": 0.5,
            "drift_min_cycle_interval_s": 0.0, "capacity_interval_s": 0.5,
            "capacity_probe_idle_s": 1.0}
    switches = {"rollout_enabled": True, "drift_enabled": True, "capacity_enabled": True}
    assert chip_smoke.LIFECYCLE_SETTINGS == {**switches, **cuts}
    defaults = ServiceSettings()
    for name in cuts:
        assert getattr(defaults, name) != cuts[name]
    assert chip_smoke.LIFECYCLE_DETECT == chip_smoke.LIFECYCLE_SHIFTED == 65536
    assert chip_smoke.LIFECYCLE_CYCLE_AT >= defaults.rollout_min_fit_rows


def test_lifecycle_launch_arithmetic():
    """The LogBERT check: 8 steps of 32 rows run the forward, dQ and dK/dV
    once per layer each; 8 shadow chunks through the live graph and 8 op by
    op through the candidate run the forward per layer and kernel 1 once."""
    want = chip_smoke.logbert_expected_lifecycle(steps=8, chunks=8, depth=4)
    assert want == {"flash_forward": 96, "flash_dq": 32, "flash_dkv": 32, "candidate_lse": 16,
                    "replayed_candidate_lse": 8, "replayed_flash_forward": 32}
    # the detector's default train batch of 32
    assert "train_batch_size" not in chip_smoke.LOGBERT_CONFIG
    assert chip_smoke.LOGBERT_LIFECYCLE_ROWS // 32 == 8


def test_shifted_stream_is_half_a_template_the_fit_never_saw():
    msgs = chip_smoke.make_shifted_messages(400)
    fit, _ = chip_smoke.make_messages(512, anomaly_rate=0.0)
    templates = {ParserSchema.from_bytes(m)["template"] for m in fit}
    new = [m for m in msgs if ParserSchema.from_bytes(m)["template"] not in templates]
    assert 150 < len(new) < 250
    assert len({ParserSchema.from_bytes(m)["logID"] for m in msgs}) == 400


def test_uncounted_checks_leave_the_counts(monkeypatch):
    stand_in = _counting_stand_in(monkeypatch)
    det = type("Det", (), {})()
    det._warm = type("Warm", (), {"replay_launches": Counter({"candidate_lse": 3})})()
    stand_in.launches = 5
    with chip_smoke.uncounted(det):
        stand_in.launches += 7
        stand_in.variants["x"] += 7
        det._warm.replay_launches["candidate_lse"] += 7
    assert stand_in.launches == 5 and not stand_in.variants
    assert det._warm.replay_launches == {"candidate_lse": 3}


def test_lifecycle_phase_on_the_cpu(monkeypatch, capsys):
    """The lifecycle phase at a narrowed width on the CPU with a counting
    stand-in for the fused head, streams of 4,096 sampled at 0.5 into a
    reservoir of 1,024 and a shifted stream of 16,384 (at 4,096 the
    reservoir's share of shifted rows leaves KS at 0.20-0.29 against its
    0.25 threshold, run to run): (a) a
    cycle under load and one with lone messages, (b) promote and rollback
    with 0 captures and candidate scores bit-equal to live, (c) the broken
    candidate held back, (d) drift detected and a drift cycle, (e) a probed
    and a traffic capacity."""
    import json

    stand_in = _counting_stand_in(monkeypatch)
    monkeypatch.setattr(chip_smoke, "COALESCE_CPU_CHANGES",
                        dict(chip_smoke.COALESCE_CPU_CHANGES, dim=32, min_train_steps=20))
    monkeypatch.setattr(chip_smoke, "LIFECYCLE_DETECT", 4096)
    monkeypatch.setattr(chip_smoke, "LIFECYCLE_SHIFTED", 16384)
    monkeypatch.setattr(chip_smoke, "LIFECYCLE_CYCLE_AT", 512)
    monkeypatch.setattr(chip_smoke, "LIFECYCLE_SETTINGS", dict(
        chip_smoke.LIFECYCLE_SETTINGS, rollout_sample_ratio=0.5, rollout_sample_capacity=1024))
    result = chip_smoke.phase_lifecycle("cpu", device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == ["lifecycle_swap"] * len(result["swaps"]) + [
        "lifecycle"]
    assert result["read_lines"] == result["lines_sent"]
    assert result["alerts"] == result["unique_alerts"] and result["recall"] >= 0.9
    assert result["cycle"]["verdict"] in ("promoted", "holdback")
    assert result["cycle"]["shadow_ticks"] == 2
    assert [s["action"] for s in result["swaps"]][-2:] == ["promote", "rollback"]
    assert all(s["candidate_vs_live"]["bit_equal"] and s["captures"] == 0
               for s in result["swaps"])
    assert result["broken"]["status"] == "holdback" and result["broken"]["events"] == 1
    assert "drift_detected" in result["drift"]["events"] and result["drift"]["drift_cycles"]
    assert result["capacity"]["probe"]["capacity_source"] == "probe"
    assert result["capacity"]["traffic"]["capacity_source"] == "traffic"
    assert result["capacity"]["probe_failures"] == 0
    assert result["xla"]["totals"]["unexpected"] == 0
    assert stand_in.launches >= result["launches"] > 0


def test_device_busy_unions_kernel_intervals_inside_the_window():
    events = [{"cat": "Trace", "ph": "X", "ts": 0.0, "dur": 100.0},
              {"cat": "kernel", "ph": "X", "ts": 10.0, "dur": 20.0},
              {"cat": "kernel", "ph": "X", "ts": 25.0, "dur": 10.0},   # overlaps
              {"cat": "gpu_memcpy", "ph": "X", "ts": 50.0, "dur": 5.0},
              {"cat": "kernel", "ph": "X", "ts": 90.0, "dur": 30.0},   # past the end
              {"cat": "cpu_op", "ph": "X", "ts": 40.0, "dur": 50.0}]
    busy = chip_smoke.device_busy(events)
    assert busy["busy_share"] == pytest.approx((25 + 10) / 100)
    assert busy["busy_share_with_copies"] == pytest.approx((25 + 5 + 10) / 100)
    assert [g["ms"] for g in busy["idle_gaps"]] == pytest.approx([0.055, 0.01])
    assert busy["idle_gaps"][0]["at_ms"] == pytest.approx(0.035)


def test_histogram_quantile_interpolates_inside_its_bucket():
    hist = {"buckets": {0.01: 50.0, 0.1: 90.0, float("inf"): 100.0}, "count": 100.0}
    assert chip_smoke.histogram_quantile(hist, 0.5) == pytest.approx(0.01)
    assert chip_smoke.histogram_quantile(hist, 0.7) == pytest.approx(0.055)
    assert chip_smoke.histogram_quantile(hist, 0.99) == pytest.approx(0.1)


def test_trace_settings_change_only_what_the_phase_names(tmp_path):
    """The detector is the coalesce phase's, with tracing, trace_terminal,
    span export and a profile directory; the relay and the sink are core
    stages around it, flow-controlled."""
    import yaml

    from detectmateservice_tpu_torch.settings import ServiceSettings

    relay, det, sink = chip_smoke.trace_settings(tmp_path, "cuda")
    relay, sink = ServiceSettings(**relay), ServiceSettings(**sink)
    (tmp_path / "c").mkdir()
    coalesce = yaml.safe_load(chip_smoke.coalesce_files(tmp_path / "c").read_text())
    for key, value in coalesce.items():
        if key not in ("engine_addr", "out_addr", "http_port", "log_dir", "config_file"):
            assert getattr(det, key) == value, key
    assert (det.engine_trace, det.trace_terminal, det.trace_stage) == (True, True, "detector")
    assert det.telemetry_addr == relay.telemetry_addr == sink.telemetry_collector_addr
    assert det.profile_max_captures == 2
    assert relay.out_addr == [det.engine_addr] and sink.engine_addr == det.out_addr[0]
    assert relay.component_type == sink.component_type == "core"
    assert sink.telemetry_collector and sink.trace_terminal
    assert relay.out_backpressure == sink.out_backpressure == "block"


def test_trace_phase_on_the_cpu(monkeypatch, capsys):
    """Phase 15 at a narrowed width (vocab 1024) on the CPU with a counting
    stand-in for the fused head, without the capture's CUDA checks: the
    traced pipeline delivers every line and alert, the flight recorder,
    the pipeline counts, the SLO windows, the collector and its exemplar,
    the profile routes and the pruning hold."""
    import json

    stand_in = _counting_stand_in(monkeypatch)
    monkeypatch.setattr(chip_smoke, "TRACE_DETECT", 4096)
    monkeypatch.setattr(chip_smoke, "TRACE_PROFILE_S", 0.5)
    result = chip_smoke.phase_trace("cpu", device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == ["trace"]
    n = result["relay_frames"]
    assert n == 512 + 4096 + 64
    assert result["recorder"] == {"tracing_enabled": True, "completed": n,
                                  "hops": [["relay", "detector"]]}
    assert result["pipeline_counts"]["e2e_latency_seconds"]["detector"] == n
    assert result["alerts"] == result["unique_alerts"] and result["recall"] >= 0.9
    assert result["profile"]["post"] == 200 and result["profile"]["second_post"] == 409
    assert result["profile"]["kept"] == ["capture-0002", "capture-0003"]
    assert result["profile"]["capture"]["activities"] == ["cpu"]
    assert result["collector"]["two_hop"] > 0
    assert 0 < result["e2e_p50_ms"] <= result["e2e_p99_ms"]
    assert stand_in.launches >= result["launches"] > 0


def test_the_late_wire_frame_capture_on_the_cpu(monkeypatch, capsys):
    """Phase 7b's capture at a tiny width on the CPU: the host's activity
    only, the path driven while it records, one JSON line."""
    import json

    _counting_stand_in(monkeypatch)
    monkeypatch.setattr(chip_smoke, "SCORER_CONFIG", dict(
        chip_smoke.SCORER_CONFIG, vocab_size=1024, dim=128, max_batch=1024,
        data_use_training=128))
    monkeypatch.setattr(chip_smoke, "N_DETECT", 4096)
    monkeypatch.setattr(chip_smoke, "TRACE_PROFILE_S", 0.3)
    result = chip_smoke.phase_frames_profile("cpu", device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "frames_profile" and line["card"] == "cpu"
    assert result["capture"]["activities"] == ["cpu"] and result["capture"]["trace_bytes"] > 0
    assert result["lines_per_s"] > 0 and "device" not in result


def test_mesh_examples_change_only_the_class_name_and_the_head():
    """Phase mesh's (b) and (c) configurations are the examples' blocks with
    the port's method type and the fused head, and nothing else."""
    import yaml

    for name in ("mesh_scorer_config.yaml", "seqparallel_config.yaml"):
        ref = yaml.safe_load((REPO / "examples" / name).read_text())["detectors"][
            "JaxScorerDetector"]
        block = chip_smoke.example_block(name)
        assert {k: v for k, v in block.items() if ref.get(k) != v} == {
            "method_type": "torch_scorer", "head_impl": "pallas"}
        assert set(ref) <= set(block)
    assert chip_smoke.example_block("mesh_scorer_config.yaml")["mesh_shape"] == {"data": 8}
    seq = chip_smoke.example_block("seqparallel_config.yaml")
    assert (seq["attn_impl"], seq["mesh_shape"], seq["dim"], seq["depth"], seq["seq_len"]) == \
        ("ring", {"data": 2, "seq": 4}, 256, 4, 2048)


def test_mesh_phase_on_the_cpu(monkeypatch, capsys):
    """Phase mesh at a narrowed width on eight CPU shards with a counting
    stand-in for the fused head: (a) the ring against the blockwise
    attention, (b) the mesh example against one device with kernel 1 once
    per row and batch, (c) the sequence-parallel example through its fit
    against the one-device flash detector, (d) a mesh of one bit-equal, (e)
    a process group of one (gloo here, NCCL on the card), (f) and (g) the
    model axis computing, against one device, each shard holding half the
    split leaves' bytes."""
    import json

    stand_in = _counting_stand_in(monkeypatch)
    monkeypatch.setattr(chip_smoke, "RING_SHAPE", (4, 2, 64, 8))
    monkeypatch.setattr(chip_smoke, "RING_PAD_TAIL", 20)
    narrow = {"vocab_size": 1024, "dtype": "float32", "dim": 32, "max_batch": 256,
              "data_use_training": 128, "min_train_steps": 20}
    monkeypatch.setattr(chip_smoke, "MESH_CPU_CHANGES", narrow)
    monkeypatch.setattr(chip_smoke, "MESH_SEQ_CPU_CHANGES", {
        "vocab_size": 1024, "dtype": "float32", "dim": 32, "depth": 1, "seq_len": 64,
        "max_batch": 16, "data_use_training": 64, "train_epochs": 2, "min_train_steps": 10})
    monkeypatch.setattr(chip_smoke, "MESH_DETECT", 2048)
    monkeypatch.setattr(chip_smoke, "MESH_CALL", 256)
    monkeypatch.setattr(chip_smoke, "MESH_SEQ_DETECT", 64)
    monkeypatch.setattr(chip_smoke, "MESH_SEQ_CALL", 16)
    monkeypatch.setattr(chip_smoke, "MESH_ONE_DETECT", 256)
    monkeypatch.setattr(chip_smoke, "MESH_MODEL_CPU_CHANGES", narrow)
    monkeypatch.setattr(chip_smoke, "MESH_MODEL_FLASH_CPU_CHANGES", {
        "vocab_size": 1024, "dtype": "float32", "dim": 32, "depth": 1, "seq_len": 64,
        "max_batch": 16, "data_use_training": 64, "train_epochs": 2, "min_train_steps": 10})
    monkeypatch.setattr(chip_smoke, "MESH_MODEL_DETECT", 1024)
    monkeypatch.setattr(chip_smoke, "MESH_MODEL_CALL", 256)
    monkeypatch.setattr(chip_smoke, "MESH_MODEL_FLASH_DETECT", 64)
    monkeypatch.setattr(chip_smoke, "MESH_MODEL_FLASH_CALL", 16)
    result = chip_smoke.phase_mesh("cpu", device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == ["mesh_ring"] * 4 + [
        "mesh_scorer", "mesh_seqparallel", "mesh_of_one", "mesh_bootstrap", "mesh_model",
        "mesh_model_flash", "mesh"]
    assert all(max(r["max_abs_err"].values()) <= r["tolerance"] for r in result["ring"])
    scorer, seq = result["scorer"], result["seqparallel"]
    assert scorer["mesh"] == "mesh(data=8)" and seq["mesh"] == "mesh(data=2,seq=4)"
    # position norm: ceil(25 / 32) calibration chunk, 8 batches of 256, 8 rows
    assert scorer["launches"] == scorer["expected_launches"] == (1 + 8) * 8
    # 64 fit rows in chunks of max_batch 16, 4 batches of 16, 2 rows
    assert seq["launches"] == seq["expected_launches"] == (4 + 4) * 2
    assert scorer["vs_one_device"]["max_abs_delta"] < 1e-4 and scorer["alerts_match"]
    # kernel 1 held against its plain version at each shape the paths gave
    # it: a row's detect batch is 256 / 8 rows x 32 positions, (c)'s 16 / 2 x 64
    assert all(r["ok"] for r in scorer["head_checks"] + seq["head_checks"])
    assert [1024, 1024, 32] in [r["shape"] for r in scorer["head_checks"]]
    assert [512, 1024, 32] in [r["shape"] for r in seq["head_checks"]]
    assert seq["vs_one_device_flash"]["max_abs_delta"] < 1e-4
    assert seq["loss_last"] < seq["loss_first"]
    assert result["one"]["bit_equal"] and result["one"]["threshold_equal"]
    assert result["bootstrap"]["backend"] == "gloo" and result["bootstrap"]["returncode"] == 0
    assert result["launches"] == scorer["launches"] + seq["launches"]
    assert list(result["parts_s"]) == ["ring", "scorer", "seqparallel", "one", "bootstrap",
                                       "model", "model_flash"]
    model, model_flash = result["model"], result["model_flash"]
    assert model["mesh"] == "mesh(data=4,model=2)"
    assert model_flash["mesh"] == "mesh(data=2,model=2)"
    # (f): one calibration chunk and 4 batches of 256 over 4 rows; (g): 4
    # chunks of 16 and 4 batches of 16 over 2 rows
    assert model["launches"] == model["expected_launches"]["candidate_lse"] == (1 + 4) * 4
    assert model_flash["launches"] == model_flash["expected_launches"]["candidate_lse"] == \
        (4 + 4) * 2
    for path in (model, model_flash):
        assert path["vs_one_device"]["max_abs_delta"] < 1e-4 and path["alerts_match"]
        # the controls on one call's rows: the bound passes one device's
        # reordered sums and fails proj's head halves swapped
        controls = path["controls"]
        assert controls["rows"] == path["call_size"]
        assert max(controls["fp32"], controls["split"]) < 1e-4
        assert controls["reordered"] <= path["tolerance"] < controls["swapped"]
        assert set(path["parts_s"]) == {"path", "yardstick", "controls", "kernel_checks",
                                        "kernel_timings"}
        assert all(r["ok"] for r in path["head_checks"]) and path["head_checks"]
        split = path["split_bytes"]
        assert split["per_shard"] == [[split["one_mth"]] * 2] * len(split["per_shard"])
        assert path["loss_last"] < path["loss_first"]
    # the row's head: a 256 / 4 rows x 32 positions batch against the whole
    # E; (g)'s shards ran attention at 4 / 2 = 2 heads
    assert [2048, 1024, 32, "float32"] in model["head_shapes"]
    assert {tuple(s[:5]) for s in model_flash["flash_shapes"]} >= {(8, 2, 64, 64, 8)}
    assert {s[6] for s in model_flash["flash_shapes"]} == {False, True}
    # the counts restart before each path; the checks beside the paths run
    # uncounted
    assert stand_in.launches >= model_flash["launches"]


_SILENT_STAGE = """
import faulthandler, sys, threading, time
faulthandler.register(int(sys.argv[1]), all_threads=True)
def serve_forever():
    time.sleep(120)
def _run_loop():
    time.sleep(120)
threading.Thread(target=serve_forever, name="WebServerThread", daemon=True).start()
print("up", flush=True)
_run_loop()
"""


def test_a_silent_stage_leaves_its_thread_stacks(tmp_path):
    """Phase pipeline's evidence when a stage stops answering: each stage
    process dumps every thread's stack on ``PIPELINE_DUMP_SIGNAL`` into its
    stderr file, and ``dump_stage_stacks`` reads them back with each
    thread's role (the engine loop, the HTTP server) and innermost
    frames; a stage that has exited reports its code."""
    import subprocess
    import sys

    with open(tmp_path / "detector.err", "wb") as err:
        proc = subprocess.Popen([sys.executable, "-c", _SILENT_STAGE,
                                 str(int(chip_smoke.PIPELINE_DUMP_SIGNAL))],
                                stdout=subprocess.PIPE, stderr=err)
    done = subprocess.Popen([sys.executable, "-c", "pass"])
    done.wait(30)
    try:
        assert proc.stdout.readline() == b"up\n"
        stacks = chip_smoke.dump_stage_stacks({"detector": proc, "output": done}, tmp_path)
    finally:
        proc.kill()
        proc.wait(30)
    assert stacks["output"] == {"exited": 0}
    roles = {t["role"]: t["innermost"] for t in stacks["detector"]["threads"]}
    assert {"engine", "http"} <= set(roles)
    assert any("_run_loop" in f for f in roles["engine"])
    assert any("serve_forever" in f for f in roles["http"])


def test_pipeline_files_change_only_what_the_phase_names(tmp_path):
    """The demo stack's settings and configs as written but the detector's
    class and head, the addresses, the HTTP ports and the paths."""
    import yaml

    files = chip_smoke.pipeline_files(tmp_path)
    conf = REPO / "container" / "config"
    changed = {"engine_addr", "out_addr", "http_host", "http_port", "config_file"}
    for stage, path in files.items():
        got = yaml.safe_load(path.read_text())
        want = yaml.safe_load((conf / f"{stage}_settings.yaml").read_text())
        extra = {"component_type", "checkpoint_dir"} if stage == "detector" else set()
        assert {k for k in set(got) | set(want) if got.get(k) != want.get(k)} \
            <= changed | extra
        cfg = yaml.safe_load((tmp_path / f"{stage}_config.yaml").read_text())
        if stage == "detector":
            block = cfg["detectors"]["TorchScorerDetector"]
            jax = yaml.safe_load((conf / "detector_config.yaml").read_text())[
                "detectors"]["JaxScorerDetector"]
            assert block == dict(jax, method_type="torch_scorer", head_impl="pallas")
            assert got["component_type"] == chip_smoke.TORCH_SCORER
    assert yaml.safe_load(files["parser"].read_text())["out_addr"][1].endswith("tap.ipc")


def test_audit_log_is_seeded_and_holds_its_anomalies_past_the_fit():
    lines, anomalies = chip_smoke.make_audit_log(64, 1024)
    again, _ = chip_smoke.make_audit_log(64, 1024)
    assert lines == again and len(lines) == 1088
    assert anomalies and min(anomalies) >= 64
    assert all(any(exe in lines[i] for _, exe, _ in chip_smoke.AUDIT_ANOMALOUS)
               for i in anomalies)
    assert not any(exe in line for i, line in enumerate(lines) if i not in anomalies
                   for _, exe, _ in chip_smoke.AUDIT_ANOMALOUS)


def test_pipeline_phase_on_the_cpu(monkeypatch, capsys):
    """The pipeline phase at a narrowed detector width with the plain head:
    the four stages as port CLI processes, every line read by every stage,
    parser outputs equal to the plain path, recall, no flip against the
    einsum head on the shutdown checkpoint, a profiler capture of the
    detector's process, and every exit code 0."""
    import json

    monkeypatch.setattr(chip_smoke, "PIPELINE_DETECT", 4096)
    result = chip_smoke.phase_pipeline("cpu", device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"phase"')]
    assert [line["phase"] for line in lines] == ["pipeline"]
    assert result["stage_lines"]["reader"]["read"] == result["lines_sent"] == 2048 + 4096
    assert result["parser_outputs"] == result["lines_sent"] and result["parser_mismatches"] == 0
    assert result["recall"] >= 0.9 and result["alerts"] == result["unique_alerts"]
    assert result["decision_flips"] == 0 or max(result["flip_distances"]) < 1e-2
    assert result["profile"]["last"]["state"] == "done"
    assert set(result["exits"].values()) == {0} and result["detector_exit"] == 0
    assert result["head_shapes"] and result["end_to_end_lines_per_s"] > 0
