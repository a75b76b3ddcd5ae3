"""Fused vocab logsumexp head: ``logsumexp(hidden @ emb_c.T, -1)`` without
the ``[N, C]`` logits in device memory.

Counterpart of ``detectmateservice_tpu/ops/scorehead.py`` (``candidate_lse``
over the Pallas kernel ``_lse_kernel``). On a CUDA tensor ``candidate_lse``
launches the hand-written kernel in ``csrc/scorehead.cu`` (built with nvcc
at first use, see ``cuda_build``); on a CPU tensor it computes the plain
version, ``candidate_lse_reference``. A CUDA launch that fails raises: there
is no fallback to the plain version.

The kernel's variant follows a stated rule of dtype and D (``variant``):
bf16 and fp16 with D a multiple of 16 up to 256 take the tensor-core
kernel fed by TMA (``wgmma_tma_d{64,128,256}_split{S}``), whose operands
must have 16-byte-aligned bases and row strides (else the wrapper raises);
fp32, or any other D, the CUDA-core kernel (``cuda_core``). Where the rows
alone would not fill the card, the tensor-core variant splits C into S
ranges, each giving a partial (max, sum) per row, and a second kernel
merges them (``candidate_lse_split_reference`` is that arithmetic in
torch); S depends on (N, C) alone.

``candidate_lse.launches`` counts calls that launched the kernel (one per
call, also where a split takes a second device launch to merge), and
``candidate_lse.variants`` the same calls by variant, so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
from typing import List, Tuple

import torch

from . import cuda_build
from .flash import check_tma_alignment

SOURCE = "scorehead.cu"
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# vocabulary rows per stage of the tensor-core kernel: a split of C is a
# whole number of stages
STAGE_COLS = 128


def candidate_lse_reference(hidden: torch.Tensor,
                            emb_c: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 logits, then logsumexp → fp32 [N]."""
    return torch.logsumexp(hidden.float() @ emb_c.float().T, dim=-1)


def split_ranges(c: int, splits: int) -> List[Tuple[int, int]]:
    """The column ranges [start, stop) of C that ``splits`` ranges of whole
    ``STAGE_COLS``-column stages give, as ``csrc/scorehead.cu`` cuts them:
    each range but perhaps the last holds ceil(stages / splits) stages, and
    no range is empty (so there may be fewer than ``splits``)."""
    stages = -(-c // STAGE_COLS)
    per = -(-stages // max(1, splits)) * STAGE_COLS
    return [(start, min(c, start + per)) for start in range(0, c, per)]


def candidate_lse_split_reference(hidden: torch.Tensor, emb_c: torch.Tensor,
                                  splits: int) -> torch.Tensor:
    """Plain version of the split launch: a partial (m, l) per row and range
    of C, then M = max m, L = Σ l·exp(m − M), out = log(max(L, 1e-30)) + M."""
    logits = hidden.float() @ emb_c.float().T
    ms, ls = [], []
    for start, stop in split_ranges(emb_c.shape[0], splits):
        part = logits[:, start:stop]
        m = part.amax(dim=-1)
        ms.append(m)
        ls.append(torch.exp(part - m[:, None]).sum(dim=-1))
    m, l = torch.stack(ms), torch.stack(ls)
    big = m.amax(dim=0)
    total = (l * torch.exp(m - big)).sum(dim=0)
    return torch.log(torch.clamp(total, min=1e-30)) + big


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_dm_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dm_candidate_lse.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.dm_candidate_lse.restype = i32
        lib.dm_candidate_lse_split.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                               i32, ptr]
        lib.dm_candidate_lse_split.restype = i32
        lib.dm_candidate_lse_splits.argtypes = [i32, i32, i32, i32]
        lib.dm_candidate_lse_splits.restype = i32
        lib.dm_candidate_lse_variant.argtypes = [i32, i32, i32, i32]
        lib.dm_candidate_lse_variant.restype = ctypes.c_char_p
        lib.dm_candidate_lse_max_dim.argtypes = []
        lib.dm_candidate_lse_max_dim.restype = i32
        lib.dm_cuda_error_string.argtypes = [i32]
        lib.dm_cuda_error_string.restype = ctypes.c_char_p
        lib._dm_typed = True
    return lib


def build_kernel() -> str:
    """Build (or find) the kernel library; returns nvcc's report."""
    report = cuda_build.build(SOURCE)
    _library()
    return report


def variant(n: int, c: int, d: int, dtype: torch.dtype) -> str:
    """The kernel variant a launch at [N, D] x [C, D] in ``dtype`` takes, as
    ``csrc/scorehead.cu`` names it (``cuda_core``, ``wgmma_tma_d256_split1``,
    ``wgmma_tma_d128_split12``, …)."""
    return _library().dm_candidate_lse_variant(n, c, d, _DTYPE_CODES[dtype]).decode()


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
    code = _DTYPE_CODES[dtype]
    taken = variant(n, c, d, dtype)
    if taken.startswith("wgmma"):
        check_tma_alignment("candidate_lse", h, e)
    splits = lib.dm_candidate_lse_splits(n, c, d, code)
    out = torch.empty(n, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if splits > 1:
            scratch = torch.empty((splits, n, 2), dtype=torch.float32, device=h.device)
            rc = lib.dm_candidate_lse_split(h.data_ptr(), e.data_ptr(), out.data_ptr(),
                                            scratch.data_ptr(), n, c, d, code, stream)
        else:
            rc = lib.dm_candidate_lse(h.data_ptr(), e.data_ptr(), out.data_ptr(),
                                      n, c, d, code, stream)
    if rc != 0:
        raise RuntimeError(
            f"candidate_lse kernel launch failed for N={n} C={c} D={d} "
            f"{dtype} ({taken}): {lib.dm_cuda_error_string(rc).decode()}")
    candidate_lse.launches += 1
    candidate_lse.variants[taken] += 1
    return out


candidate_lse.launches = 0  # type: ignore[attr-defined]
# launches by kernel variant (``variant``), counted beside ``.launches``
candidate_lse.variants = collections.Counter()  # type: ignore[attr-defined]
