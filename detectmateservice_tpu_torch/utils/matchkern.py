"""ctypes bindings for the port's native featurizer (``native/dmfeat.c``).

Counterpart of the featurize part of ``detectmateservice_tpu/utils/matchkern.py``
(``set_featurize_threads``, ``featurize_threads``, ``featurize_batch``,
``FrameBatch``, ``SpanRaws``, ``featurize_frames``, ``encode_batch``) over
the port's own copy of the C source; it loads no library of the JAX package.

Nothing here runs at import time. The first call builds the source with the
host C compiler (``cc -O3 -shared -fPIC -pthread``) into ``native/_build/``
(listed in ``.gitignore``) under a name keyed by a hash of the source, the
compiler and the flags, renamed into place atomically, and loads it. A
failed build, or a library that reports another feature version, raises
``NativeBuildError``: there is no Python fallback here (the detector retries
in Python only the rows the C side refuses).

The featurize pool is process-wide (the C side keeps one); its threads
start lazily at the first large batch and sleep on a condvar between jobs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dmfeat.c"
BUILD_DIR = SOURCE.parent / "_build"
CC = "cc"
CFLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

# the feature version the library must report (``dm_feature_version``); the
# C source's default, bumped in lockstep with it
DM_FEATURE_VERSION = 7

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the build of this process took (0.0 = the keyed library existed)
build_seconds: Optional[float] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class NativeBuildError(RuntimeError):
    """The host compiler is missing or refused the source, or the library
    reports another feature version."""


def library_path() -> Path:
    """Where the source builds to: keyed by its bytes, the compiler and the
    flags, so an edited source rebuilds and an unchanged one is reused."""
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join((CC, *CFLAGS)).encode())
    return BUILD_DIR / f"dmfeat-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its keyed library exists; returns its path."""
    global build_seconds
    out = library_path()
    if out.is_file():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([CC, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300, check=False)
    except (OSError, subprocess.SubprocessError) as exc:
        raise NativeBuildError(f"cannot run the C compiler {CC!r}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{CC} failed on {SOURCE.name} (rc {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.dm_feature_version.restype = ctypes.c_int
        got = int(lib.dm_feature_version())
        if got != DM_FEATURE_VERSION:
            raise NativeBuildError(f"{SOURCE.name} reports feature version {got}, the "
                                   f"bindings expect {DM_FEATURE_VERSION}")
        lib.dm_featurize_batch.argtypes = [
            ctypes.c_char_p, _I64P, ctypes.c_int, _I32P, _U8P, ctypes.c_int, ctypes.c_int32]
        lib.dm_featurize_batch.restype = ctypes.c_int
        lib.dm_featurize_set_threads.argtypes = [ctypes.c_int]
        lib.dm_featurize_set_threads.restype = ctypes.c_int
        lib.dm_featurize_get_threads.argtypes = []
        lib.dm_featurize_get_threads.restype = ctypes.c_int
        lib.dm_encode_batch.argtypes = [
            ctypes.c_char_p, _I64P, ctypes.c_int, _I32P, ctypes.c_int, ctypes.c_int32]
        lib.dm_encode_batch.restype = ctypes.c_int
        lib.dm_count_frame_msgs.argtypes = [
            ctypes.c_char_p, _I64P, ctypes.c_int, _I32P, _U8P, _I64P]
        lib.dm_count_frame_msgs.restype = ctypes.c_int64
        lib.dm_featurize_frames.argtypes = [
            ctypes.c_char_p, _I64P, ctypes.c_int, _I32P, _U8P, _I32P, _U8P, _I64P,
            ctypes.c_int, ctypes.c_int32]
        lib.dm_featurize_frames.restype = ctypes.c_int64
        _lib = lib
        return lib


def lib_feature_version() -> int:
    """The feature version the loaded library reports."""
    return int(load().dm_feature_version())


def set_featurize_threads(n: int) -> int:
    """Set the featurize pool width; returns the effective width. 0 (or
    negative) = auto: min(4, online cores). The pool is process-wide; the
    last setter wins."""
    return int(load().dm_featurize_set_threads(int(n)))


def featurize_threads() -> int:
    """The current pool width (auto resolved to its value)."""
    return int(load().dm_featurize_get_threads())


def _pack(chunks: Sequence[bytes]) -> Tuple[bytes, np.ndarray]:
    offsets = np.zeros(len(chunks) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    return b"".join(chunks), offsets


def featurize_batch(msgs: Sequence[bytes], seq_len: int,
                    vocab_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Serialized ParserSchema bytes → ([N, seq_len] int32 tokens, [N] ok)."""
    lib = load()
    blob, offsets = _pack(msgs)
    out = np.zeros((len(msgs), seq_len), dtype=np.int32)
    ok = np.zeros(len(msgs), dtype=np.uint8)
    lib.dm_featurize_batch(blob, offsets.ctypes.data_as(_I64P), len(msgs),
                           out.ctypes.data_as(_I32P), ok.ctypes.data_as(_U8P),
                           seq_len, vocab_size)
    return out, ok.astype(bool)


class FrameBatch:
    """Result of ``featurize_frames``: token rows plus lazy raw access;
    ``raw(i)`` slices the frame blob only when asked."""

    __slots__ = ("tokens", "ok", "blob", "spans", "n_corrupt_frames", "n_lines")

    def __init__(self, tokens: np.ndarray, ok: np.ndarray, blob: bytes,
                 spans: np.ndarray, n_corrupt_frames: int, n_lines: int):
        self.tokens = tokens
        self.ok = ok
        self.blob = blob
        self.spans = spans                      # [n, 2] int64 [start, end)
        self.n_corrupt_frames = n_corrupt_frames
        self.n_lines = n_lines                  # engine newline-rule total

    def __len__(self) -> int:
        return len(self.ok)

    def raw(self, i: int) -> bytes:
        s, e = self.spans[i]
        return self.blob[s:e]


class SpanRaws:
    """List-of-bytes stand-in over (blob, spans): the indexing and slicing
    the detector's dispatch and drain use, without materializing N bytes
    objects."""

    __slots__ = ("blob", "spans")

    def __init__(self, blob: bytes, spans: np.ndarray):
        self.blob = blob
        self.spans = spans

    def __len__(self) -> int:
        return len(self.spans)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return SpanRaws(self.blob, self.spans[i])
        s, e = self.spans[i]
        return self.blob[s:e]


def featurize_frames(frames: Sequence[bytes], seq_len: int,
                     vocab_size: int) -> FrameBatch:
    """Wire frames (packed batch frames and/or single messages) → token
    rows, ok flags and lazy raw-byte spans, in two C calls for the whole
    burst (a count pass, then the rows)."""
    lib = load()
    blob, offsets = _pack(frames)
    n_frames = len(frames)
    counts = np.zeros(n_frames, dtype=np.int32)
    corrupt = np.zeros(n_frames, dtype=np.uint8)
    lines = np.zeros(1, dtype=np.int64)
    # the count pass filters packed empty messages, so rows are sized by
    # real payloads only
    total = int(lib.dm_count_frame_msgs(
        blob, offsets.ctypes.data_as(_I64P), n_frames, counts.ctypes.data_as(_I32P),
        corrupt.ctypes.data_as(_U8P), lines.ctypes.data_as(_I64P)))
    tokens = np.zeros((total, seq_len), dtype=np.int32)
    ok = np.zeros(total, dtype=np.uint8)
    spans = np.zeros((total, 2), dtype=np.int64)
    if total:
        lib.dm_featurize_frames(
            blob, offsets.ctypes.data_as(_I64P), n_frames, counts.ctypes.data_as(_I32P),
            corrupt.ctypes.data_as(_U8P), tokens.ctypes.data_as(_I32P),
            ok.ctypes.data_as(_U8P), spans.ctypes.data_as(_I64P), seq_len, vocab_size)
    return FrameBatch(tokens, ok.astype(bool), blob, spans, int(corrupt.sum()),
                      int(lines[0]))


def encode_batch(texts: Sequence[str], seq_len: int, vocab_size: int) -> np.ndarray:
    """Raw text lines → [N, seq_len] int32 token rows."""
    lib = load()
    blob, offsets = _pack([t.encode("utf-8") for t in texts])
    out = np.zeros((len(texts), seq_len), dtype=np.int32)
    lib.dm_encode_batch(blob, offsets.ctypes.data_as(_I64P), len(texts),
                        out.ctypes.data_as(_I32P), seq_len, vocab_size)
    return out
