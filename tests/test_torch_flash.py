"""The port's flash attention (``ops/flash.py``) and attention router
(``ops/attention.py``) against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port's wrappers
compute their plain versions on CPU tensors (the CUDA kernels themselves are
held against those plain versions on the card by ``chip_smoke.py``). Every
comparison feeds both packages the same seeded numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectmateservice_tpu.ops import attention as jax_attention
from detectmateservice_tpu.ops import flash as jax_flash
from detectmateservice_tpu_torch.ops import attention as port_attention
from detectmateservice_tpu_torch.ops import flash

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def make_qkv(b=2, h=3, s=128, t=None, d=64, seed=0):
    """``tests/test_flash.py``'s inputs as numpy: q, k, v and a [B, T] mask."""
    rng = np.random.default_rng(seed)
    t = t or s
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h, t, d)).astype(np.float32)
    v = rng.standard_normal((b, h, t, d)).astype(np.float32)
    mask = rng.random((b, t)) > 0.2
    return q, k, v, mask


def _both(arrays, dtype):
    jdt, tdt = _DTYPES[dtype]
    jx = [None if a is None else jnp.asarray(a, jdt if a.dtype != bool else bool)
          for a in arrays]
    pt = [None if a is None else (torch.from_numpy(a) if a.dtype == bool
                                  else torch.from_numpy(a).to(tdt))
          for a in arrays]
    return jx, pt


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# (name, make_qkv kwargs, masked, JAX block_q, block_k): the cases of
# tests/test_flash.py's TestFlashParity at S, T <= 128
PARITY_CASES = [
    ("fp32", dict(s=128), True, 256, 512),
    ("ragged", dict(s=100, t=120), True, 32, 48),
    ("no_mask", dict(s=128), False, 256, 512),
    ("multi_block", dict(s=128, t=96), True, 32, 32),
]


class TestFlashParity:
    @pytest.mark.parametrize("name,shape,masked,bq,bk", PARITY_CASES)
    def test_matches_the_jax_kernel_fp32(self, name, shape, masked, bq, bk):
        q, k, v, mask = make_qkv(**shape)
        (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(
            [q, k, v, mask if masked else None], "float32")
        want = jax_flash.flash_attention(jq, jk, jv, jm, bq, bk, True)
        got = flash.flash_attention(tq, tk, tv, tm)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)

    def test_matches_the_jax_kernel_bf16(self):
        q, k, v, mask = make_qkv()
        (jq, jk, jv, jm), (tq, tk, tv, tm) = _both([q, k, v, mask], "bfloat16")
        want = jax_flash.flash_attention(jq, jk, jv, jm, interpret=True)
        got = flash.flash_attention(tq, tk, tv, tm)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)

    def test_matches_einsum_and_blockwise(self):
        q, k, v, mask = make_qkv()
        _, (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        out = flash.flash_attention(tq, tk, tv, tm)
        ein = port_attention.dot_product_attention(tq, tk, tv, tm[:, None, None, :])
        blk = port_attention.blockwise_attention(tq, tk, tv, block_size=64,
                                                 mask=tm[:, None, None, :])
        torch.testing.assert_close(out, ein, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out, blk, rtol=1e-5, atol=1e-5)

    def test_fully_masked_rows_are_finite_means_of_v(self):
        """A row with every key masked comes out as the mean of v over its
        T real keys, the reference formulation's value, never NaN."""
        q, k, v, mask = make_qkv(s=40, t=24)
        mask[1] = False
        _, (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        out, lse = flash.flash_forward(tq, tk, tv, tm, want_lse=True)
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        want = tv[1].mean(dim=1, keepdim=True).expand(-1, 40, -1)
        torch.testing.assert_close(out[1], want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out, flash.reference_attention(tq, tk, tv, tm),
                                   rtol=1e-5, atol=1e-5)


    def test_fully_masked_row_differs_from_the_tpu_kernel_by_design(self):
        """The TPU kernel's fully masked row averages v over T padded up to
        its key block (its zero padding keys count): ΣV / T_pad, a value
        that depends on the block size. The port gives the mean over the T
        real keys, the reference formulation's value."""
        q, k, v, mask = make_qkv(b=1, h=1, s=8, t=12, d=64, seed=3)
        v = v + 3.0
        mask[0] = False
        (jq, jk, jv, jm), (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        tpu = np.asarray(jax_flash.flash_attention(jq, jk, jv, jm, 8, 8, True))
        t_pad = 16  # T = 12 padded to the 8-key block
        np.testing.assert_allclose(tpu[0, 0], np.broadcast_to(
            v[0, 0].sum(0) / t_pad, (8, 64)), rtol=1e-5, atol=1e-5)
        got = flash.flash_attention(tq, tk, tv, tm).numpy()
        np.testing.assert_allclose(got[0, 0], np.broadcast_to(
            v[0, 0].mean(0), (8, 64)), rtol=1e-5, atol=1e-5)


class TestFlashGradients:
    @pytest.mark.parametrize("s,t,bq,bk,masked", [
        (64, 64, 256, 512, True),    # single block (snapped)
        (48, 80, 16, 32, True),      # multi-block with S and T padding
        (64, 64, 32, 32, False),     # maskless
        (100, 60, 32, 16, True),     # ragged both ways
    ])
    def test_function_gradients_match_the_jax_custom_vjp(self, s, t, bq, bk, masked):
        """``tests/test_flash.py``'s gradient cases: the port's autograd
        Function (plain dQ and dK/dV on the CPU) against the JAX kernels'
        custom_vjp in interpret mode, same inputs, loss sum(out²)."""
        rng = np.random.default_rng(s * 1000 + t)
        q = rng.normal(size=(2, 2, s, 32)).astype(np.float32)
        k = rng.normal(size=(2, 2, t, 32)).astype(np.float32)
        v = rng.normal(size=(2, 2, t, 32)).astype(np.float32)
        mask = (rng.random((2, t)) > 0.2) if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        want = jax.grad(lambda q, k, v: (jax_flash.flash_attention(
            q, k, v, jm, bq, bk, True) ** 2).sum(), argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        tm = None if mask is None else torch.from_numpy(mask)
        out = flash.flash_attention(tq, tk, tv, tm)
        assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
        (out ** 2).sum().backward()
        for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    @pytest.mark.parametrize("s,t,masked", [(40, 72, True), (33, 33, False)])
    def test_plain_backward_matches_autograd_of_the_reference(self, s, t, masked):
        """The plain dQ and dK/dV (recompute p from lse, delta outside)
        against torch autograd through ``reference_attention``."""
        q, k, v, mask = make_qkv(b=2, h=2, s=s, t=t, d=32, seed=s)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        tm = torch.from_numpy(mask) if masked else None
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 2, s, 32)).astype(np.float32))
        ref = flash.reference_attention(tq, tk, tv, tm)
        want = torch.autograd.grad(ref, (tq, tk, tv), g)
        with torch.no_grad():
            out, lse = flash.flash_forward(tq, tk, tv, tm, want_lse=True)
            delta = flash.flash_delta(g, out)
            dq = flash.flash_dq_reference(tq, tk, tv, tm, g, lse, delta)
            dk, dv = flash.flash_dkv_reference(tq, tk, tv, tm, g, lse, delta)
        for got, ref_grad in zip((dq, dk, dv), want):
            torch.testing.assert_close(got, ref_grad, rtol=1e-4, atol=1e-4)

    def test_bf16_gradients_keep_the_input_dtypes(self):
        q, k, v, mask = make_qkv(b=1, h=2, s=24, t=40, d=32, seed=5)
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                      for a in (q, k, v))
        out = flash.flash_attention(tq, tk, tv, torch.from_numpy(mask))
        out.float().sum().backward()
        for x in (tq, tk, tv):
            assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
            assert torch.isfinite(x.grad.float()).all()


class TestWrappers:
    def test_lse_only_when_a_backward_is_pending(self):
        q, k, v, mask = make_qkv(b=1, h=1, s=16, t=16, d=32)
        _, (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        out, lse = flash.flash_forward(tq, tk, tv, tm)
        assert lse is None
        out2, lse2 = flash.flash_forward(tq, tk, tv, tm, want_lse=True)
        assert lse2.shape == (1, 16) and lse2.dtype == torch.float32
        torch.testing.assert_close(out, out2)
        # no grad pending: the plain forward, no autograd node
        assert flash.flash_attention(tq, tk, tv, tm).grad_fn is None

    def test_cpu_calls_launch_no_kernel(self):
        q, k, v, mask = make_qkv(b=1, h=2, s=16, t=24, d=32)
        before = (flash.flash_forward.launches, flash.flash_dq.launches,
                  flash.flash_dkv.launches)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        flash.flash_attention(tq, tk, tv, torch.from_numpy(mask)).sum().backward()
        assert (flash.flash_forward.launches, flash.flash_dq.launches,
                flash.flash_dkv.launches) == before

    def test_non_cpu_tensors_never_take_the_plain_version(self):
        """A tensor off the CPU launches the kernel or raises: here a meta
        tensor, which no kernel takes."""
        q = torch.empty((1, 1, 8, 32), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_forward(q, q, q)
        lse = torch.empty((1, 8), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_dq(q, q, q, None, q, lse, lse)
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_dkv(q, q, q, None, q, lse, lse)

    @pytest.mark.parametrize("shapes", [
        ((1, 2, 8, 32), (1, 2, 8, 16), (1, 2, 8, 16)),
        ((1, 2, 8, 32), (1, 3, 8, 32), (1, 3, 8, 32)),
        ((2, 8, 32), (2, 8, 32), (2, 8, 32)),
    ])
    def test_bad_shapes_raise(self, shapes):
        q, k, v = (torch.zeros(s) for s in shapes)
        with pytest.raises(ValueError):
            flash.flash_forward(q, k, v)

    def test_bad_mask_raises(self):
        q = torch.zeros((2, 1, 8, 32))
        with pytest.raises(ValueError, match="key_mask"):
            flash.flash_forward(q, q, q, torch.ones((2, 7), dtype=torch.bool))
        with pytest.raises(ValueError, match="key_mask"):
            flash.flash_forward(q, q, q, torch.ones((2, 8)))

    def test_plain_versions_chunk_over_batch_heads(self, monkeypatch):
        """A small chunk budget splits the batch·head axis; the result is
        the same."""
        q, k, v, mask = make_qkv(b=2, h=3, s=16, t=20, d=32)
        _, (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        whole = flash.flash_forward_reference(tq, tk, tv, tm)
        monkeypatch.setattr(flash, "_CHUNK_ELEMENTS", 16 * 20 * 2)
        assert len(list(flash._bh_chunks(6, 16, 20))) == 3
        parts = flash.flash_forward_reference(tq, tk, tv, tm)
        for a, b in zip(whole, parts):
            torch.testing.assert_close(a, b)


class TestRouting:
    def test_threshold_is_the_reference_constant(self):
        assert port_attention.FLASH_MIN_SEQ == jax_attention.FLASH_MIN_SEQ == 2048

    @pytest.mark.parametrize("impl", ["auto", "einsum", "blockwise", "flash", "typo"])
    def test_each_impl_matches_the_jax_router(self, impl):
        """On the CPU "auto" (and an unknown name) takes the einsum path on
        both sides; every impl agrees with the JAX package's."""
        q, k, v, mask = make_qkv(s=128)
        (jq, jk, jv, jm), (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        want = jax_attention.attention(jq, jk, jv, key_mask=jm, impl=impl)
        got = port_attention.attention(tq, tk, tv, key_mask=tm, impl=impl)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)

    def test_auto_takes_einsum_on_the_cpu_even_for_long_keys(self, monkeypatch):
        monkeypatch.setattr(port_attention, "FLASH_MIN_SEQ", 8)
        calls = []
        monkeypatch.setattr(port_attention, "flash_attention",
                            lambda *a, **kw: calls.append(a))
        q, k, v, mask = make_qkv(b=1, h=1, s=16, d=32)
        _, (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        port_attention.attention(tq, tk, tv, key_mask=tm, impl="auto")
        assert calls == []
        port_attention.attention(tq, tk, tv, key_mask=tm, impl="flash")
        assert len(calls) == 1

    def test_ring_raises_without_a_mesh(self):
        q, k, v, mask = make_qkv(b=1, h=1, s=16, d=32)
        (jq, jk, jv, jm), (tq, tk, tv, tm) = _both([q, k, v, mask], "float32")
        with pytest.raises(ValueError, match="ring"):
            jax_attention.attention(jq, jk, jv, key_mask=jm, impl="ring")
        with pytest.raises(ValueError, match="ring"):
            port_attention.attention(tq, tk, tv, key_mask=tm, impl="ring")

    def test_blockwise_needs_whole_blocks(self):
        q, k, v, _ = make_qkv(b=1, h=1, s=16, t=100, d=32)
        (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "float32")
        with pytest.raises(ValueError, match="divisible"):
            jax_attention.blockwise_attention(jq, jk, jv, block_size=64)
        with pytest.raises(ValueError, match="divisible"):
            port_attention.blockwise_attention(tq, tk, tv, block_size=64)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_einsum_and_blockwise_match_the_jax_ops(self, dtype):
        q, k, v, mask = make_qkv(s=64, t=128)
        (jq, jk, jv, jm), (tq, tk, tv, tm) = _both([q, k, v, mask], dtype)
        tol = 1e-5 if dtype == "float32" else 2e-2
        want = jax_attention.dot_product_attention(jq, jk, jv, jm[:, None, None, :])
        got = port_attention.dot_product_attention(tq, tk, tv, tm[:, None, None, :])
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        want = jax_attention.blockwise_attention(jq, jk, jv, block_size=32,
                                                 mask=jm[:, None, None, :])
        got = port_attention.blockwise_attention(tq, tk, tv, block_size=32,
                                                 mask=tm[:, None, None, :])
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
