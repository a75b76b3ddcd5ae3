"""The port's fused logsumexp head (``ops/scorehead.candidate_lse``) against
the JAX package's Pallas kernel run in interpret mode, at the shapes and
tolerances of tests/test_scorehead.py::TestCandidateLse. On a CPU tensor
the port's wrapper computes its plain version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py. The split-C
arithmetic of the tensor-core variant and its routing rule, which the card
alone runs, are checked here through their plain version and the
constants of csrc/scorehead.cu."""
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.ops.scorehead import candidate_lse as jax_candidate_lse
from detectmateservice_tpu_torch.ops import cuda_build, flash, scorehead


def _pair(rng, n, c, d):
    return rng.normal(size=(n, d)), rng.normal(size=(c, d))


def _both(h, e, jax_dtype, torch_dtype):
    want = np.asarray(jax_candidate_lse(jnp.asarray(h, jax_dtype),
                                        jnp.asarray(e, jax_dtype), interpret=True))
    th = torch.from_numpy(np.asarray(h, np.float32)).to(torch_dtype)
    te = torch.from_numpy(np.asarray(e, np.float32)).to(torch_dtype)
    got = scorehead.candidate_lse(th, te)
    assert got.dtype == torch.float32 and got.shape == (len(h),)
    return got.numpy(), want


class TestCandidateLseAgainstPallas:
    @pytest.mark.parametrize("n,c,d", [(1000, 2048, 128), (256, 512, 64),
                                       (37, 64, 32), (8, 8, 8)])
    def test_matches_pallas_kernel(self, n, c, d):
        h, e = _pair(np.random.default_rng(n + c + d), n, c, d)
        got, want = _both(h, e, jnp.float32, torch.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    def test_bf16_inputs_fp32_accumulation(self):
        h, e = _pair(np.random.default_rng(0), 512, 256, 64)
        got, want = _both(h, e, jnp.bfloat16, torch.bfloat16)
        # the same bf16 operands, products exact in fp32 on both sides:
        # only the order of summation differs
        assert np.abs(got - want).max() < 2e-3

    def test_extreme_values_stay_finite(self):
        h = np.full((16, 32), 50.0)
        e = np.concatenate([np.full((8, 32), 2.0), np.full((8, 32), -2.0)])
        got, want = _both(h, e, jnp.float32, torch.float32)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)

    @pytest.mark.parametrize("c", [96, 1031, 613])
    def test_non_pow2_and_prime_candidate_counts(self, c):
        h, e = _pair(np.random.default_rng(c), 100, c, 16)
        got, want = _both(h, e, jnp.float32, torch.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version_and_count_no_launch(self):
        before = scorehead.candidate_lse.launches
        h = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
        e = torch.randn(7, 8, generator=torch.Generator().manual_seed(1))
        got = scorehead.candidate_lse(h, e)
        torch.testing.assert_close(got, torch.logsumexp(h @ e.T, dim=-1))
        assert scorehead.candidate_lse.launches == before

    def test_mixed_float_types_promote(self):
        h = torch.randn(4, 8, dtype=torch.float64)
        e = torch.randn(3, 8).bfloat16()
        want = torch.logsumexp(h.float() @ e.float().T, dim=-1)
        torch.testing.assert_close(scorehead.candidate_lse(h, e), want)

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="candidate_lse"):
            scorehead.candidate_lse(torch.zeros(4, 8), torch.zeros(3, 9))
        with pytest.raises(ValueError, match="candidate_lse"):
            scorehead.candidate_lse(torch.zeros(4, 8, 1), torch.zeros(3, 8))

    def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back(self):
        with pytest.raises(ValueError, match="CUDA"):
            scorehead.candidate_lse(torch.zeros(4, 8, device="meta"),
                                    torch.zeros(3, 8, device="meta"))

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(cuda_build, "_DEFAULT_CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(cuda_build.shutil, "which", lambda _name: None)
        with pytest.raises(cuda_build.KernelBuildError, match="nvcc"):
            cuda_build.find_nvcc()

    def test_build_key_follows_source_and_flags(self, monkeypatch):
        path = cuda_build.library_path(scorehead.SOURCE)
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith("scorehead-") and path.suffix == ".so"
        monkeypatch.setattr(cuda_build, "ARCH_FLAGS",
                            ["-gencode", "arch=compute_90,code=sm_90"])
        assert cuda_build.library_path(scorehead.SOURCE) != path

    def test_build_key_follows_every_header(self, monkeypatch, tmp_path):
        """Both sources include csrc/hopper.cuh: an edited header must give
        a new library name, or a stale .so would be reused."""
        assert '#include "hopper.cuh"' in (cuda_build.CSRC_DIR / "flash.cu").read_text()
        assert '#include "hopper.cuh"' in (cuda_build.CSRC_DIR / "scorehead.cu").read_text()
        csrc = tmp_path / "csrc"
        shutil.copytree(cuda_build.CSRC_DIR, csrc)
        monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
        before = {src: cuda_build.library_path(src) for src in ("flash.cu", "scorehead.cu")}
        header = csrc / "hopper.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        for src, path in before.items():
            assert cuda_build.library_path(src) != path
        # a new header counts too
        edited = {src: cuda_build.library_path(src) for src in before}
        (csrc / "extra.cuh").write_text("#pragma once\n")
        assert all(cuda_build.library_path(src) != edited[src] for src in before)


# -- the split over C and the routing rule -----------------------------------
SCOREHEAD_CU = (cuda_build.CSRC_DIR / "scorehead.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SCOREHEAD_CU).group(1))


def _plan(n: int, c: int, d: int, dtype: torch.dtype) -> str:
    """csrc/scorehead.cu's ``make_plan`` and variant name, from its
    constants: the rule the card's launches follow."""
    if dtype == torch.float32 or d % 16 or d > _constant("kMaxWgmmaDim"):
        return "cuda_core"
    kd = 64 if d <= 64 else 128 if d <= 128 else 256
    stages = -(-c // _constant("kLseCols"))
    tiles = -(-n // _constant("kLseRows"))
    splits = -(-_constant("kTargetCtas") // tiles)
    splits = max(1, min(splits, stages // _constant("kMinSplitStages")))
    per = -(-stages // splits)
    return f"wgmma_tma_d{kd}_split{-(-stages // per)}"


class TestSplitOverC:
    @pytest.mark.parametrize("splits", [1, 3, 8])
    @pytest.mark.parametrize("n,c,d", [(60, 1031, 16), (40, 613, 32), (33, 96, 16)])
    def test_split_reference_matches_plain_and_pallas(self, n, c, d, splits):
        h, e = _pair(np.random.default_rng(n * c + splits), n, c, d)
        th = torch.from_numpy(h.astype(np.float32))
        te = torch.from_numpy(e.astype(np.float32))
        got = scorehead.candidate_lse_split_reference(th, te, splits)
        assert got.dtype == torch.float32 and got.shape == (n,)
        torch.testing.assert_close(got, scorehead.candidate_lse_reference(th, te),
                                   rtol=1e-5, atol=1e-5)
        want = np.asarray(jax_candidate_lse(jnp.asarray(h, jnp.float32),
                                            jnp.asarray(e, jnp.float32), interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("splits", [1, 3, 8])
    def test_split_reference_extreme_values(self, splits):
        """h = 50, e = ±2: logits of ±3200, over ranges whose maxima differ
        by 6400; the merge must not overflow."""
        h = np.full((16, 32), 50.0)
        e = np.where(np.arange(700)[:, None] % 3 == 0, 2.0, -2.0) * np.ones((1, 32))
        th = torch.from_numpy(h.astype(np.float32))
        te = torch.from_numpy(e.astype(np.float32))
        got = scorehead.candidate_lse_split_reference(th, te, splits)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, scorehead.candidate_lse_reference(th, te),
                                   rtol=1e-5, atol=1e-3)
        # one range of only -3200 logits beside ranges holding +3200
        lone = scorehead.candidate_lse_split_reference(
            th, torch.cat([-torch.full((128, 32), 2.0), torch.full((300, 32), 2.0)]), 4)
        torch.testing.assert_close(lone, torch.full((16,), 3200 + np.log(300.0)),
                                   rtol=1e-6, atol=1e-3)

    @pytest.mark.parametrize("c,splits,want", [
        (1031, 1, [(0, 1031)]),
        (1031, 3, [(0, 384), (384, 768), (768, 1031)]),
        # 9 stages over 8 splits: 2 stages a range, so only 5 ranges
        (1031, 8, [(0, 256), (256, 512), (512, 768), (768, 1024), (1024, 1031)]),
        (96, 8, [(0, 96)]),
        (32768, 64, [(i * 512, i * 512 + 512) for i in range(64)]),
    ])
    def test_split_ranges_are_whole_stages_and_cover_c(self, c, splits, want):
        got = scorehead.split_ranges(c, splits)
        assert got == want
        assert all(start % scorehead.STAGE_COLS == 0 for start, _ in got)

    def test_stage_width_is_the_kernels(self):
        assert scorehead.STAGE_COLS == _constant("kLseCols")

    @pytest.mark.parametrize("n,c,d,dtype,want", [
        # the MLP path: calibration chunks and detect batches both split
        (32, 32768, 128, torch.bfloat16, "wgmma_tma_d128_split64"),
        (4096, 32768, 128, torch.bfloat16, "wgmma_tma_d128_split12"),
        (16384, 32768, 128, torch.bfloat16, "wgmma_tma_d128_split4"),
        # the LogBERT path: enough row tiles, no split
        (65536, 32768, 256, torch.bfloat16, "wgmma_tma_d256_split1"),
        (524288, 32768, 256, torch.bfloat16, "wgmma_tma_d256_split1"),
        (1, 32768, 256, torch.float16, "wgmma_tma_d256_split64"),
        (100, 1031, 64, torch.bfloat16, "wgmma_tma_d64_split2"),
        (100, 613, 16, torch.bfloat16, "wgmma_tma_d64_split1"),
        # fp32, D not a multiple of 16 and D past the plan: CUDA cores
        (4096, 32768, 128, torch.float32, "cuda_core"),
        (100, 613, 24, torch.bfloat16, "cuda_core"),
        (100, 613, 272, torch.bfloat16, "cuda_core"),
    ])
    def test_routing_rule(self, n, c, d, dtype, want):
        assert _plan(n, c, d, dtype) == want

    def test_split_depends_on_the_shape_alone(self):
        """No device query in the plan: the same shape sums in one order on
        any card."""
        plan = SCOREHEAD_CU[SCOREHEAD_CU.index("Plan make_plan("):]
        plan = plan[:plan.index("\n}\n")]
        assert "cudaGetDevice" not in plan and "multiProcessorCount" not in plan
        assert "cudaDeviceGetAttribute" not in SCOREHEAD_CU

    def test_variant_names_and_entry_points_in_the_source(self):
        for name in ('"cuda_core"', '"wgmma_tma_d%d_split%d"'):
            assert name in SCOREHEAD_CU
        for fn in ("int dm_candidate_lse(", "int dm_candidate_lse_split(",
                   "int dm_candidate_lse_splits(", "const char* dm_candidate_lse_variant(",
                   "lse_wgmma_kernel(", "lse_combine_kernel("):
            assert fn in SCOREHEAD_CU
        assert scorehead._DTYPE_CODES == {torch.float32: 0, torch.float16: 1,
                                          torch.bfloat16: 2}
        assert "// dtype 0 = float32, 1 = float16, 2 = bfloat16" in SCOREHEAD_CU


class TestTmaAlignment:
    def test_misaligned_bf16_hidden_is_refused(self):
        """A bf16 h whose base is 2 bytes past an aligned address, as a
        column slice of a wider tensor gives: the tensor-core variant's TMA
        cannot load it, so the wrapper raises instead of copying."""
        h = torch.zeros(64, 130, dtype=torch.bfloat16)[:, 1:129]
        with pytest.raises(ValueError, match="16-byte aligned") as info:
            flash.check_tma_alignment("candidate_lse", h)
        assert "candidate_lse" in str(info.value) and "base address" in str(info.value)

    def test_row_stride_not_a_multiple_of_16_bytes_is_refused(self):
        h = torch.zeros(64, 36, dtype=torch.bfloat16)[:, :32]   # 72-byte rows
        with pytest.raises(ValueError, match="stride 72 B along dim 0"):
            flash.check_tma_alignment("candidate_lse", h)

    @pytest.mark.parametrize("shape", [(64, 128), (1, 256), (4096, 16)])
    def test_contiguous_operands_pass(self, shape):
        flash.check_tma_alignment("candidate_lse", torch.zeros(shape, dtype=torch.bfloat16))
