"""The port's fused logsumexp head (``ops/scorehead.candidate_lse``) against
the JAX package's Pallas kernel run in interpret mode, at the shapes and
tolerances of tests/test_scorehead.py::TestCandidateLse. On a CPU tensor
the port's wrapper computes its plain version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.ops.scorehead import candidate_lse as jax_candidate_lse
from detectmateservice_tpu_torch.ops import cuda_build, scorehead


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
