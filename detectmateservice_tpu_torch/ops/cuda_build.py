"""Build a CUDA source of ``ops/csrc`` into a shared library and load it.

Each kernel source has a plain C interface, so ``nvcc`` compiles it in
seconds into a ``.so`` that ``ctypes`` loads; no PyTorch headers and no
``ninja`` are involved. The library goes into ``ops/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source, the headers of
``csrc/``, the flags and the target, so an edited source or header rebuilds
and an unchanged one is reused.

Nothing here runs at import time: the first launch of a kernel builds it.
A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_DEFAULT_CUDA_HOME = "/usr/local/cuda"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds each source took to compile in this process (0 = cache hit)
build_seconds: Dict[str, float] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), _DEFAULT_CUDA_HOME):
        if cand:
            path = Path(cand) / "bin" / "nvcc"
            if path.is_file():
                return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                               "PATH); the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    """Where ``source`` (a file name under csrc/) builds to: keyed by its
    bytes, every header of csrc/ (a source may include any of them) and
    the flags."""
    key = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{key.hexdigest()[:16]}.so"


def _start(source: str, out: Path):
    """Start nvcc on ``source``; returns (process, temp output, start time)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd: List[str] = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
                      str(CSRC_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, time.perf_counter()


def _finish(source: str, out: Path, proc, tmp: Path, t0: float) -> str:
    """Wait for nvcc; returns its output (the -Xptxas -v resource report)."""
    stdout, stderr = proc.communicate()
    build_seconds[source] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on {source} (rc {proc.returncode}):\n{stdout}\n{stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return stdout + stderr


def build_all(sources: List[str]) -> Dict[str, str]:
    """Compile every source whose keyed library is missing, one nvcc each,
    all started together; returns each compiler's report ("" on a cache
    hit). Every started nvcc is waited for, even when one fails."""
    reports: Dict[str, str] = {}
    started = []
    try:
        for source in sources:
            out = library_path(source)
            if out.is_file():
                build_seconds.setdefault(source, 0.0)
                reports[source] = ""
            else:
                started.append((source, out, *_start(source, out)))
    finally:
        errors = []
        for source, out, proc, tmp, t0 in started:
            try:
                reports[source] = _finish(source, out, proc, tmp, t0)
            except KernelBuildError as exc:
                errors.append(str(exc))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return reports


def build(source: str) -> str:
    """Compile ``source`` unless its keyed library exists; returns the
    compiler's report ("" on a cache hit)."""
    return build_all([source])[source]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building it on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build(source)
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
        return lib
