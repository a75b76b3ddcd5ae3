"""Fused flash attention, forward and backward:
``softmax(q kᵀ · d^-½ + bias) v`` without the ``[S, T]`` scores in device
memory.

Counterpart of ``detectmateservice_tpu/ops/flash.py`` (``flash_attention``, a
``jax.custom_vjp`` over the Pallas kernels ``_flash_kernel``, ``_dq_kernel``
and ``_dkv_kernel``). Layout at the public function is the JAX package's:
q ``[B, H, S, D]``, k and v ``[B, H, T, D]``, ``key_mask`` ``[B, T]`` bool
with True meaning attend; PAD keys become an additive -1e30 bias.

Three wrappers, one per hand-written kernel of ``csrc/flash.cu`` (built with
nvcc at first use, see ``cuda_build``):

* ``flash_forward`` → out (and, with ``want_lse``, the per-row logsumexp
  ``lse`` as fp32 ``[B*H, S]``),
* ``flash_dq`` → dQ, recomputing p = exp(s - lse),
* ``flash_dkv`` → (dK, dV), the same recomputation per key tile.

On CPU tensors each wrapper computes its plain version
(``flash_forward_reference``, ``flash_dq_reference``,
``flash_dkv_reference``: the same math in torch, chunked over batch·head so
the fp32 scores stay bounded); on CUDA tensors it launches its kernel or
raises. Each counts its kernel launches in ``.launches``, and by kernel
variant in ``.variants``: bf16 and fp16 launches take the wgmma kernels fed
by TMA (``variant``), which want every operand's base address and batch,
head and sequence strides at multiples of 16 bytes and raise otherwise;
fp32 launches take the CUDA-core kernels.

``flash_attention`` is a ``torch.autograd.Function`` when a backward is
pending (grad mode on and an input requires grad): its forward saves lse and
its backward runs the dQ and dK/dV kernels, with delta = rowsum(dO∘O)
computed outside them as the JAX package does. Otherwise the forward runs
without lse, as the JAX scoring path does.

A fully masked row comes out as the mean of v over its T real keys (the
reference formulation's value), never NaN.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Iterator, Optional, Tuple

import torch

from . import cuda_build

SOURCE = "flash.cu"
NEG_BIG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KIND_CODES = {"forward": 0, "dq": 1, "dkv": 2}
# the alignment TMA wants of a 16-bit operand's base and strides
_TMA_ALIGN = 16
# fp32 score elements one chunk of a plain version may hold (1 GiB)
_CHUNK_ELEMENTS = 1 << 28


# -- plain versions ------------------------------------------------------------
def key_bias(key_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, T] bool key mask → fp32 additive bias (0 attend, -1e30 PAD)."""
    if key_mask is None:
        return None
    return torch.where(key_mask, 0.0, NEG_BIG).float()


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.reshape(b * h, n, d)


def _bh_chunks(bh: int, s: int, t: int) -> Iterator[slice]:
    """Slices of the batch·head axis whose [n, S, T] fp32 scores fit the
    chunk budget."""
    per = max(1, _CHUNK_ELEMENTS // max(1, s * t))
    for start in range(0, bh, per):
        yield slice(start, min(bh, start + per))


def _scores(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
            scale: float) -> torch.Tensor:
    """[n, S, D] · [n, T, D] → fp32 [n, S, T] scaled scores plus bias [n, T]."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias[:, None, :]
    return s


def _bias_bh(key_mask: Optional[torch.Tensor], h: int) -> Optional[torch.Tensor]:
    bias = key_bias(key_mask)
    return None if bias is None else bias.repeat_interleave(h, dim=0)


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out [B, H, S, D] in q's dtype,
    lse fp32 [B*H, S]). p is normalized, then rounded to v's dtype before
    p·v, as in the JAX package's reference formulation."""
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5
    qr, kr, vr = _flat(q), _flat(k), _flat(v)
    bias = _bias_bh(key_mask, h)
    out = torch.empty((b * h, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    for sl in _bh_chunks(b * h, s, t):
        sc = _scores(qr[sl], kr[sl], None if bias is None else bias[sl], scale)
        m = sc.amax(dim=-1, keepdim=True)
        e = torch.exp(sc - m)
        l = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        p = (e / l).to(v.dtype).float()
        out[sl] = torch.matmul(p, vr[sl].float()).to(q.dtype)
        lse[sl] = (m + torch.log(l))[..., 0]
    return out.view(b, h, s, d), lse


def _recompute(q, k, v, bias, do, lse, delta, scale):
    """p = exp(s - lse) and ds = p ∘ (dO·vᵀ - delta) for one chunk."""
    p = torch.exp(_scores(q, k, bias, scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_dq_reference(q, k, v, key_mask, do, lse, delta) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = (ds in k's dtype)·k·scale, in
    q's dtype [B, H, S, D]. ``lse``/``delta`` are fp32 [B*H, S]."""
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5
    qr, kr, vr, dor = _flat(q), _flat(k), _flat(v), _flat(do)
    bias = _bias_bh(key_mask, h)
    dq = torch.empty((b * h, s, d), dtype=q.dtype, device=q.device)
    for sl in _bh_chunks(b * h, s, t):
        _, ds = _recompute(qr[sl], kr[sl], vr[sl],
                           None if bias is None else bias[sl],
                           dor[sl], lse[sl], delta[sl], scale)
        dq[sl] = (torch.matmul(ds.to(k.dtype).float(), kr[sl].float())
                  * scale).to(q.dtype)
    return dq.view(b, h, s, d)


def flash_dkv_reference(q, k, v, key_mask, do, lse, delta
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: dV = (p in dO's dtype)ᵀ·dO and
    dK = (ds in q's dtype)ᵀ·q·scale, in k's and v's dtypes [B, H, T, D]."""
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5
    qr, kr, vr, dor = _flat(q), _flat(k), _flat(v), _flat(do)
    bias = _bias_bh(key_mask, h)
    dk = torch.empty((b * h, t, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b * h, t, d), dtype=v.dtype, device=v.device)
    for sl in _bh_chunks(b * h, s, t):
        p, ds = _recompute(qr[sl], kr[sl], vr[sl],
                           None if bias is None else bias[sl],
                           dor[sl], lse[sl], delta[sl], scale)
        dv[sl] = torch.matmul(p.to(do.dtype).float().transpose(1, 2),
                              dor[sl].float()).to(v.dtype)
        dk[sl] = (torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                               qr[sl].float()) * scale).to(k.dtype)
    return dk.view(b, h, t, d), dv.view(b, h, t, d)


def reference_attention(q, k, v, key_mask=None) -> torch.Tensor:
    """The einsum formulation the kernels match (the JAX package's
    ``_reference_attention``): fp32 scores, softmax, p in v's dtype."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
    if key_mask is not None:
        s = s + key_bias(key_mask)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


# -- the kernels -----------------------------------------------------------------
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_dm_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        dims = [i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        lib.dm_flash_forward.argtypes = [ptr, ptr, ptr, strides, ptr, ptr, ptr, *dims]
        lib.dm_flash_dq.argtypes = [ptr, ptr, ptr, ptr, strides, ptr, ptr, ptr, ptr,
                                    *dims]
        lib.dm_flash_dkv.argtypes = [ptr, ptr, ptr, ptr, strides, ptr, ptr, ptr, ptr,
                                     ptr, *dims]
        for fn in (lib.dm_flash_forward, lib.dm_flash_dq, lib.dm_flash_dkv):
            fn.restype = ctypes.c_int
        lib.dm_flash_variant.argtypes = [i32, i32, i32]
        lib.dm_flash_variant.restype = ctypes.c_char_p
        lib.dm_flash_max_dim.argtypes = []
        lib.dm_flash_max_dim.restype = ctypes.c_int
        lib.dm_flash_error_string.argtypes = [ctypes.c_int]
        lib.dm_flash_error_string.restype = ctypes.c_char_p
        lib._dm_typed = True
    return lib


def build_kernel() -> str:
    """Build (or find) the kernel library; returns nvcc's report."""
    report = cuda_build.build(SOURCE)
    _library()
    return report


def _check_shapes(q, k, v, key_mask, name: str) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} wants q [B, H, S, D], k and v [B, H, T, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not fit together")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or tuple(key_mask.shape) != (b, k.shape[2])):
        raise ValueError(f"{name}: key_mask must be bool [B, T] = "
                         f"{(b, k.shape[2])}, got {key_mask.dtype} "
                         f"{tuple(key_mask.shape)}")


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _cuda_operands(name: str, *tensors):
    """The operands in one supported dtype, each with unit stride along D,
    all on one CUDA device; raises on anything the kernels do not take."""
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: operands on {[str(t.device) for t in tensors]}; "
                         "all must be on one CUDA device")
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    out = []
    for t in tensors:
        t = t.to(dtype)
        out.append(t if t.stride(-1) == 1 else t.contiguous())
    return dtype, out


def _strides(*tensors) -> ctypes.Array:
    vals = []
    for t in tensors:
        vals.extend(t.stride()[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


def _bias_arg(key_mask, device) -> Optional[torch.Tensor]:
    if key_mask is None:
        return None
    return key_bias(key_mask.to(device)).contiguous()


def _raise_on(rc: int, lib, name: str, q: torch.Tensor, t: int, dtype) -> None:
    if rc != 0:
        b, h, s, d = q.shape
        raise RuntimeError(f"{name} kernel launch failed for B={b} H={h} S={s} "
                           f"T={t} D={d} {dtype}: "
                           f"{lib.dm_flash_error_string(rc).decode()}")


def _check_dim(lib, d: int, name: str) -> None:
    if d > lib.dm_flash_max_dim():
        raise ValueError(f"{name}: D={d} exceeds the kernel's {lib.dm_flash_max_dim()}")


def variant(kind: str, dtype: torch.dtype, d: int) -> str:
    """The kernel variant a launch of ``kind`` ("forward", "dq" or "dkv")
    takes for operands of ``dtype`` with head dimension ``d``, as
    ``csrc/flash.cu`` names it (``wgmma_tma_d64``, ``cuda_core_d128``, …)."""
    return _library().dm_flash_variant(_KIND_CODES[kind], _DTYPE_CODES[dtype],
                                       d).decode()


def check_tma_alignment(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless each operand's base address and its strides along
    every dimension but the last (of dimensions longer than 1: batch, head
    and sequence for flash, rows for the fused head) are multiples of 16
    bytes, as the wgmma kernels' TMA loads need. No copy is made: the
    caller's views either fit or are refused."""
    for t in tensors:
        size = t.element_size()
        bad = [f"stride {s * size} B along dim {i}"
               for i, (n, s) in enumerate(zip(t.shape[:-1], t.stride()[:-1]))
               if n > 1 and (s * size) % _TMA_ALIGN]
        if t.data_ptr() % _TMA_ALIGN:
            bad.insert(0, f"base address {t.data_ptr():#x}")
        if bad:
            raise ValueError(f"{name}: the {t.dtype} operand {tuple(t.shape)} is not "
                             f"{_TMA_ALIGN}-byte aligned for TMA ({', '.join(bad)})")


def _variant_for(lib, kind: str, dtype: torch.dtype, d: int, name: str,
                 *tensors: torch.Tensor) -> str:
    """The variant this launch takes, with its operands checked for it."""
    _check_dim(lib, d, name)
    taken = variant(kind, dtype, d)
    if taken.startswith("wgmma"):
        check_tma_alignment(name, *tensors)
    return taken


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_mask: Optional[torch.Tensor] = None, want_lse: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out [B, H, S, D] in q's dtype, lse fp32 [B*H, S] or None). The lse
    is written only with ``want_lse`` (a backward is pending)."""
    _check_shapes(q, k, v, key_mask, "flash_forward")
    if _on_cpu(q, k, v, key_mask):
        out, lse = flash_forward_reference(q, k, v, key_mask)
        return out, (lse if want_lse else None)
    dtype, (qc, kc, vc) = _cuda_operands("flash_forward", q, k, v)
    b, h, s, d = qc.shape
    t = kc.shape[2]
    lib = _library()
    taken = _variant_for(lib, "forward", dtype, d, "flash_forward", qc, kc, vc)
    bias = _bias_arg(key_mask, qc.device)
    out = torch.empty((b, h, s, d), dtype=dtype, device=qc.device)
    lse = (torch.empty((b * h, s), dtype=torch.float32, device=qc.device)
           if want_lse else None)
    with torch.cuda.device(qc.device):
        stream = torch.cuda.current_stream(qc.device).cuda_stream
        rc = lib.dm_flash_forward(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), _strides(qc, kc, vc),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, s, t, d, d ** -0.5, _DTYPE_CODES[dtype], stream)
    _raise_on(rc, lib, "flash_forward", qc, t, dtype)
    flash_forward.launches += 1
    flash_forward.variants[taken] += 1
    return out.to(q.dtype), lse


def _backward_operands(name, q, k, v, do, lse, delta):
    dtype, (qc, kc, vc, doc) = _cuda_operands(name, q, k, v, do)
    b, h, s, _ = qc.shape
    for what, rows in (("lse", lse), ("delta", delta)):
        if (rows.dtype != torch.float32 or tuple(rows.shape) != (b * h, s)
                or rows.device != qc.device):
            raise ValueError(f"{name}: {what} must be fp32 [B*H, S] = {(b * h, s)} "
                             f"on {qc.device}")
    return dtype, qc, kc, vc, doc, lse.contiguous(), delta.contiguous()


def flash_dq(q, k, v, key_mask, do, lse, delta) -> torch.Tensor:
    """dQ [B, H, S, D] in q's dtype from the saved ``lse`` and
    ``delta`` = rowsum(dO∘O), both fp32 [B*H, S]."""
    _check_shapes(q, k, v, key_mask, "flash_dq")
    if _on_cpu(q, k, v, key_mask, do, lse, delta):
        return flash_dq_reference(q, k, v, key_mask, do, lse, delta)
    dtype, qc, kc, vc, doc, lse, delta = _backward_operands(
        "flash_dq", q, k, v, do, lse, delta)
    b, h, s, d = qc.shape
    t = kc.shape[2]
    lib = _library()
    taken = _variant_for(lib, "dq", dtype, d, "flash_dq", qc, kc, vc, doc)
    bias = _bias_arg(key_mask, qc.device)
    dq = torch.empty((b, h, s, d), dtype=dtype, device=qc.device)
    with torch.cuda.device(qc.device):
        stream = torch.cuda.current_stream(qc.device).cuda_stream
        rc = lib.dm_flash_dq(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), doc.data_ptr(),
            _strides(qc, kc, vc, doc), None if bias is None else bias.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, s, t, d, d ** -0.5, _DTYPE_CODES[dtype], stream)
    _raise_on(rc, lib, "flash_dq", qc, t, dtype)
    flash_dq.launches += 1
    flash_dq.variants[taken] += 1
    return dq.to(q.dtype)


def flash_dkv(q, k, v, key_mask, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, H, T, D] in k's and v's dtypes, from the same saved
    rows as ``flash_dq``."""
    _check_shapes(q, k, v, key_mask, "flash_dkv")
    if _on_cpu(q, k, v, key_mask, do, lse, delta):
        return flash_dkv_reference(q, k, v, key_mask, do, lse, delta)
    dtype, qc, kc, vc, doc, lse, delta = _backward_operands(
        "flash_dkv", q, k, v, do, lse, delta)
    b, h, s, d = qc.shape
    t = kc.shape[2]
    lib = _library()
    taken = _variant_for(lib, "dkv", dtype, d, "flash_dkv", qc, kc, vc, doc)
    bias = _bias_arg(key_mask, qc.device)
    dk = torch.empty((b, h, t, d), dtype=dtype, device=qc.device)
    dv = torch.empty((b, h, t, d), dtype=dtype, device=qc.device)
    with torch.cuda.device(qc.device):
        stream = torch.cuda.current_stream(qc.device).cuda_stream
        rc = lib.dm_flash_dkv(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), doc.data_ptr(),
            _strides(qc, kc, vc, doc), None if bias is None else bias.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, s, t, d, d ** -0.5, _DTYPE_CODES[dtype], stream)
    _raise_on(rc, lib, "flash_dkv", qc, t, dtype)
    flash_dkv.launches += 1
    flash_dkv.variants[taken] += 1
    return dk.to(k.dtype), dv.to(v.dtype)


flash_forward.launches = 0  # type: ignore[attr-defined]
flash_dq.launches = 0  # type: ignore[attr-defined]
flash_dkv.launches = 0  # type: ignore[attr-defined]
# launches by kernel variant (``variant``), counted beside ``.launches``
flash_forward.variants = collections.Counter()  # type: ignore[attr-defined]
flash_dq.variants = collections.Counter()  # type: ignore[attr-defined]
flash_dkv.variants = collections.Counter()  # type: ignore[attr-defined]


def flash_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO∘O) as fp32 [B*H, S], computed outside the kernels
    as the JAX package computes it."""
    b, h, s, _ = out.shape
    return (do.float() * out.float()).sum(-1).reshape(b * h, s)


class FlashAttentionFunction(torch.autograd.Function):
    """Forward with lse saved; backward through the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        out, lse = flash_forward(q, k, v, key_mask, want_lse=True)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        delta = flash_delta(g, out)
        dq = flash_dq(q, k, v, key_mask, g, lse, delta)
        dk, dv = flash_dkv(q, k, v, key_mask, g, lse, delta)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention [B, H, S, D]; matches ``reference_attention`` and
    ``dot_product_attention`` with a broadcast key mask. Differentiable
    through the backward kernels when a backward is pending."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, key_mask)
    return flash_forward(q, k, v, key_mask, want_lse=False)[0]
