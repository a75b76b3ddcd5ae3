"""Fused vocab logsumexp head: ``logsumexp(hidden @ emb_c.T, -1)`` without
the ``[N, C]`` logits in device memory.

Counterpart of ``detectmateservice_tpu/ops/scorehead.py`` (``candidate_lse``
over the Pallas kernel ``_lse_kernel``). On a CUDA tensor ``candidate_lse``
launches the hand-written kernel in ``csrc/scorehead.cu`` (built with nvcc
at first use, see ``cuda_build``); on a CPU tensor it computes the plain
version, ``candidate_lse_reference``. A CUDA launch that fails raises: there
is no fallback to the plain version.

``candidate_lse.launches`` counts kernel launches, so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = "scorehead.cu"
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def candidate_lse_reference(hidden: torch.Tensor,
                            emb_c: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 logits, then logsumexp → fp32 [N]."""
    return torch.logsumexp(hidden.float() @ emb_c.float().T, dim=-1)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_dm_typed", False):
        lib.dm_candidate_lse.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.dm_candidate_lse.restype = ctypes.c_int
        lib.dm_candidate_lse_max_dim.argtypes = []
        lib.dm_candidate_lse_max_dim.restype = ctypes.c_int
        lib.dm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dm_cuda_error_string.restype = ctypes.c_char_p
        lib._dm_typed = True
    return lib


def build_kernel() -> str:
    """Build (or find) the kernel library; returns nvcc's report."""
    report = cuda_build.build(SOURCE)
    _library()
    return report


def candidate_lse(hidden: torch.Tensor, emb_c: torch.Tensor) -> torch.Tensor:
    """``hidden`` [N, D], ``emb_c`` [C, D], float32/float16/bfloat16 →
    fp32 [N]. Products and sums are fp32 on either path."""
    if hidden.dim() != 2 or emb_c.dim() != 2 or hidden.shape[1] != emb_c.shape[1]:
        raise ValueError(f"candidate_lse wants [N, D] and [C, D], got "
                         f"{tuple(hidden.shape)} and {tuple(emb_c.shape)}")
    if hidden.device.type == "cpu" and emb_c.device.type == "cpu":
        return candidate_lse_reference(hidden, emb_c)
    if hidden.device.type != "cuda" or hidden.device != emb_c.device:
        raise ValueError(f"candidate_lse: operands on {hidden.device} and "
                         f"{emb_c.device}; both must be on one CUDA device")
    dtype = torch.promote_types(hidden.dtype, emb_c.dtype)
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"candidate_lse: unsupported dtype {dtype}")
    n, d = hidden.shape
    c = emb_c.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.float32, device=hidden.device)
    if c == 0:
        raise ValueError("candidate_lse: emb_c has no rows")
    lib = _library()
    if d > lib.dm_candidate_lse_max_dim():
        raise ValueError(f"candidate_lse: D={d} exceeds the kernel's "
                         f"{lib.dm_candidate_lse_max_dim()}")
    h = hidden.to(dtype).contiguous()
    e = emb_c.to(dtype).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.dm_candidate_lse(h.data_ptr(), e.data_ptr(), out.data_ptr(),
                                  n, c, d, _DTYPE_CODES[dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"candidate_lse kernel launch failed for N={n} C={c} D={d} "
            f"{dtype}: {lib.dm_cuda_error_string(rc).decode()}")
    candidate_lse.launches += 1
    return out


candidate_lse.launches = 0  # type: ignore[attr-defined]
