"""Device resolution for the port's entry points.

Counterpart of ``detectmateservice_tpu/utils/backend.py``. The port runs on
a CUDA device unless the caller asks for the CPU: ``None`` means
``cuda:0``, ``"cuda"`` / ``"cuda:N"`` a CUDA device, ``"cpu"`` the host.
Anything else, or a CUDA device that is not there, raises ``LibraryError``;
the CPU is never chosen silently.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from ..library.common.core import LibraryError

_CUDA_RE = re.compile(r"cuda(?::(\d+))?")


def resolve_device(spec: Optional[str]) -> torch.device:
    if spec is None:
        spec = "cuda:0"
    name = str(spec).strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    match = _CUDA_RE.fullmatch(name)
    if match is None:
        raise LibraryError(
            f"unknown device {spec!r}; expected 'cpu', 'cuda' or 'cuda:N'")
    index = int(match.group(1) or 0)
    if not torch.cuda.is_available():
        raise LibraryError(
            f"device {spec!r} needs CUDA, but no CUDA device is available; "
            "pass device: 'cpu' to run on the host")
    if index >= torch.cuda.device_count():
        raise LibraryError(
            f"device {spec!r}: only {torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)
