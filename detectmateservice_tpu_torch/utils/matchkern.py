"""ctypes bindings for the port's native host kernels (``native/dmfeat.c``).

Counterpart of ``detectmateservice_tpu/utils/matchkern.py`` over the port's
own copy of the C source; it loads no library of the JAX package. The
featurizer (``set_featurize_threads``, ``featurize_threads``,
``featurize_batch``, ``FrameBatch``, ``SpanRaws``, ``featurize_frames``,
``encode_batch``) serves the detector; the template matcher and the parser
rows (``TemplateMatcher``, ``ParseKernel``, ``ParsedFrames``, ``LogsView``,
``parse_logs_batch``, ``parse_logs_frames``, ``ParserEmitter``) serve
``library/parsers/template_matcher.py``. The NewValueDetector scan and the
shm refcounts of the JAX package's library are not ported.

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
from typing import List, Optional, Sequence, Tuple

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
        _bind_parser(lib)
        _lib = lib
        return lib


def _bind_parser(lib: ctypes.CDLL) -> None:
    """Argument types of the template matcher and parser entry points."""
    seg = [ctypes.c_char_p, _I64P, _I32P, _U8P, _U8P, ctypes.c_int]
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.dm_match_templates.argtypes = [ctypes.c_char_p, ctypes.c_int, *seg]
    lib.dm_match_templates.restype = ctypes.c_int
    lib.dm_match_extract.argtypes = [ctypes.c_char_p, ctypes.c_int, *seg,
                                     _I32P, ctypes.c_int, _I32P]
    lib.dm_match_extract.restype = ctypes.c_int
    lib.dm_match_extract_batch.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int, *seg,
                                           _I32P, _I32P, _I32P, ctypes.c_int]
    lib.dm_match_extract_batch.restype = None
    # the parse context shared by the batch and frames entry points
    ctx = [ctypes.c_int,
           ctypes.c_char_p, _I64P, ctypes.c_int,
           ctypes.c_char_p, _I64P, ctypes.c_int, ctypes.c_int,
           *seg,
           ctypes.c_char_p, _I64P, ctypes.c_int,
           ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
           ctypes.c_char_p, ctypes.c_int,
           ctypes.c_int64, ctypes.c_char_p, _U8P, ctypes.c_int64]
    lib.dm_parse_batch.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int, *ctx, _I64P, i8p]
    lib.dm_parse_batch.restype = ctypes.c_int64
    lib.dm_parse_frames.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int, _I32P, _U8P,
                                    *ctx, _I64P, _I64P, i8p]
    lib.dm_parse_frames.restype = ctypes.c_int64
    lib.dm_parse_logs_batch.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int, ctypes.c_int,
                                        _I64P, i8p]
    lib.dm_parse_logs_batch.restype = None
    lib.dm_parse_logs_frames.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int, _I32P, _U8P,
                                         ctypes.c_int, _I64P, _I64P, i8p]
    lib.dm_parse_logs_frames.restype = ctypes.c_int64
    lib.dm_emit_parser_rows.argtypes = [
        ctypes.c_int, _I32P,
        ctypes.c_char_p, _I64P,
        ctypes.c_char_p, _I64P, _I32P,
        ctypes.c_char_p, _I64P,
        ctypes.c_char_p, _I64P,
        ctypes.c_char_p, _I64P, _I32P,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, _I64P, _I64P,
        _U8P, ctypes.c_int64, _I64P]
    lib.dm_emit_parser_rows.restype = ctypes.c_int64


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


# -- template matching and the parser rows -----------------------------------

# 1-element placeholders handed to the parse kernels when no template
# matcher is configured (n_templates == 0: the C side never dereferences)
_ZERO_I64 = np.zeros(1, dtype=np.int64)
_ZERO_I32 = np.zeros(1, dtype=np.int32)
_ZERO_U8 = np.zeros(1, dtype=np.uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)


class TemplateMatcher:
    """Native first-match scan over ``<*>`` templates (normalized as the
    parser normalizes them); the wildcard captures come from the scan's
    byte spans, and the regex of the selected template extracts them only
    where a span splits a multi-byte character."""

    def __init__(self, templates: List[str]):
        import re

        lib = load()
        self._lib = lib
        self._templates = templates
        segments: List[bytes] = []
        counts = np.zeros(len(templates), dtype=np.int32)
        starts = np.zeros(len(templates), dtype=np.uint8)
        ends = np.zeros(len(templates), dtype=np.uint8)
        self._extract_res = []
        for i, template in enumerate(templates):
            parts = template.split("<*>")
            segments.extend(p.encode("utf-8") for p in parts)
            counts[i] = len(parts)
            starts[i] = 1 if template.startswith("<*>") else 0
            ends[i] = 1 if template.endswith("<*>") else 0
            escaped = [re.escape(p) for p in parts]
            if len(escaped) > 1:
                pattern = "^" + "(.*?)".join(escaped[:-1]) + "(.*)" + escaped[-1] + "$"
            else:
                pattern = "^" + escaped[0] + "$"
            self._extract_res.append(re.compile(pattern))
        self._seg_blob, self._seg_offsets = _pack(segments)
        self._counts, self._starts, self._ends = counts, starts, ends
        # pointer conversions cost microseconds per ctypes call: made once
        self._seg_offsets_p = self._seg_offsets.ctypes.data_as(_I64P)
        self._counts_p = counts.ctypes.data_as(_I32P)
        self._starts_p = starts.ctypes.data_as(_U8P)
        self._ends_p = ends.ctypes.data_as(_U8P)
        self._max_caps = max(1, int(counts.max()) if len(counts) else 1)
        # one capture buffer, reused: the engine loop is the only caller
        self._caps = np.empty(2 * self._max_caps, dtype=np.int32)
        self._caps_p = self._caps.ctypes.data_as(_I32P)
        self._ncaps = np.zeros(1, dtype=np.int32)
        self._ncaps_p = self._ncaps.ctypes.data_as(_I32P)

    def _seg(self) -> tuple:
        return (self._seg_blob, self._seg_offsets_p, self._counts_p, self._starts_p,
                self._ends_p, len(self._templates))

    def _regex(self, idx: int, line: str) -> Tuple[int, List[str]]:
        found = self._extract_res[idx].match(line)
        if found is None:
            return -1, []
        return idx, [g for g in found.groups() if g is not None]

    def match(self, line: str) -> Tuple[int, List[str]]:
        """(0-based template index, wildcard captures), or (-1, [])."""
        raw = line.encode("utf-8")
        idx = self._lib.dm_match_extract(raw, len(raw), *self._seg(), self._caps_p,
                                         self._max_caps, self._ncaps_p)
        if idx == -1:
            return -1, []
        if idx >= 0:
            caps = self._caps
            try:
                return idx, [raw[caps[2 * k]:caps[2 * k + 1]].decode("utf-8")
                             for k in range(int(self._ncaps[0]))]
            except UnicodeDecodeError:
                return self._regex(idx, line)  # a span split a multi-byte char
        # -2: more captures than the buffer holds; the scan alone, then the regex
        idx2 = self._lib.dm_match_templates(raw, len(raw), *self._seg())
        return (-1, []) if idx2 < 0 else self._regex(idx2, line)

    def match_batch(self, lines: List[str]) -> List[Tuple[int, List[str]]]:
        """``match`` for every line, in one C call."""
        n = len(lines)
        if n == 0:
            return []
        raws = [line.encode("utf-8") for line in lines]
        blob, offsets = _pack(raws)
        idx_out = np.empty(n, dtype=np.int32)
        ncaps = np.empty(n, dtype=np.int32)
        caps = np.empty((n, 2 * self._max_caps), dtype=np.int32)
        self._lib.dm_match_extract_batch(
            blob, offsets.ctypes.data_as(_I64P), n, *self._seg(),
            idx_out.ctypes.data_as(_I32P), caps.ctypes.data_as(_I32P),
            ncaps.ctypes.data_as(_I32P), self._max_caps)
        idx_list, ncaps_list, caps_list = idx_out.tolist(), ncaps.tolist(), caps.tolist()
        results: List[Tuple[int, List[str]]] = []
        for i in range(n):
            idx = idx_list[i]
            if idx == -1:
                results.append((-1, []))
                continue
            if idx >= 0:
                raw, row = raws[i], caps_list[i]
                try:
                    results.append((idx, [raw[row[2 * k]:row[2 * k + 1]].decode("utf-8")
                                          for k in range(ncaps_list[i])]))
                    continue
                except UnicodeDecodeError:
                    pass
            results.append(self.match(lines[i]))
        return results


def has_parse_kernel() -> bool:
    """True once the library (built on this call if need be) carries the
    fused parser rows; a failed build raises ``NativeBuildError``."""
    return hasattr(load(), "dm_parse_batch")


class ParseKernel:
    """The MatcherParser row in C: LogSchema payloads → serialized
    ParserSchema bytes, one call per batch (``dm_parse_batch``) or per
    burst of wire frames (``dm_parse_frames``). ``status``: 1 emitted, 0
    filtered (None), -1 the row goes back to the Python path, which alone
    has its exact semantics (JSON records, invalid UTF-8, Unicode
    lowercase or whitespace, embedded newlines)."""

    def __init__(self, lits: List[str], names: List[str], norm_flags: int,
                 accept_raw: bool, matcher: Optional[TemplateMatcher],
                 raw_templates: List[str], method_type: str, parser_id: str,
                 version: str):
        self._lib = load()
        self._n_lits = len(lits)
        self._lit_blob, self._lit_offsets = _pack([s.encode() for s in lits])
        self._name_blob, self._name_offsets = _pack([s.encode() for s in names])
        self._lit_offsets_p = self._lit_offsets.ctypes.data_as(_I64P)
        self._name_offsets_p = self._name_offsets.ctypes.data_as(_I64P)
        # dict(zip(names, groups)) keeps the last of duplicate capture names
        self._content_cap = -1
        for i, nm in enumerate(names):
            if nm == "Content":
                self._content_cap = i
        self._norm_flags = norm_flags
        self._accept_raw = 1 if accept_raw else 0
        self._matcher = matcher
        self._tmpl_blob, self._tmpl_offsets = _pack([t.encode() for t in raw_templates])
        self._tmpl_offsets_p = self._tmpl_offsets.ctypes.data_as(_I64P)
        self._consts = (version.encode(), method_type.encode(), parser_id.encode())
        self._names_total = int(self._name_offsets[-1])
        self._tmpl_max = max((len(t.encode()) for t in raw_templates), default=0)

    def _ctx(self, now: int, rand_hex: bytes) -> tuple:
        """The parse context's arguments, up to the output buffer."""
        m = self._matcher
        if m is not None:
            seg, max_caps = m._seg(), m._max_caps
        else:
            seg = (b"", _ZERO_I64.ctypes.data_as(_I64P), _ZERO_I32.ctypes.data_as(_I32P),
                   _ZERO_U8.ctypes.data_as(_U8P), _ZERO_U8.ctypes.data_as(_U8P), 0)
            max_caps = 1
        version, method_type, parser_id = self._consts
        return (self._accept_raw,
                self._lit_blob, self._lit_offsets_p, self._n_lits,
                self._name_blob, self._name_offsets_p, self._content_cap, self._norm_flags,
                *seg,
                self._tmpl_blob, self._tmpl_offsets_p, max_caps,
                version, len(version), method_type, len(method_type),
                parser_id, len(parser_id), now, rand_hex)

    def _run_with_capacity(self, blob_len: int, n_rows: int, invoke) -> bytes:
        """Size the output buffer from the worst-case estimate and call
        ``invoke(out, cap) -> used`` again with a larger one while it
        returns -1 (too small); -2 (the C side's malloc failed) raises
        ``MemoryError`` at once."""
        cap = int(blob_len * 2 + n_rows * (256 + self._tmpl_max + self._names_total) + 1024)
        for _ in range(4):
            out = np.empty(cap, dtype=np.uint8)
            used = invoke(out, cap)
            if used >= 0:
                return out[:used].tobytes()
            if used == -2:
                raise MemoryError("parse kernel allocation failed (OOM)")
            if used != -1:
                raise RuntimeError(f"parse kernel returned unknown error code {used}")
            cap *= 4
        raise MemoryError("parse kernel output buffer kept overflowing")

    def parse_batch(self, payloads: Sequence[bytes]):
        """→ (status int8 array, output blob, [n+1] output offsets)."""
        n = len(payloads)
        blob, offsets = _pack(payloads)
        status = np.full(n, -1, dtype=np.int8)
        out_offsets = np.zeros(n + 1, dtype=np.int64)
        ctx = self._ctx(int(time.time()), os.urandom(16 * n).hex().encode() if n else b"")

        def invoke(out, cap):
            return int(self._lib.dm_parse_batch(
                blob, offsets.ctypes.data_as(_I64P), n, *ctx,
                out.ctypes.data_as(_U8P), cap,
                out_offsets.ctypes.data_as(_I64P), status.ctypes.data_as(_I8P)))

        return status, self._run_with_capacity(len(blob), n, invoke), out_offsets

    def parse_frames(self, frames: Sequence[bytes]) -> "ParsedFrames":
        """Wire frames (packed batch frames and single messages) → one
        serialized ParserSchema per contained message: a count pass, then
        one call for the whole burst."""
        blob, offsets = _pack(frames)
        n_frames = len(frames)
        counts = np.zeros(n_frames, dtype=np.int32)
        corrupt = np.zeros(n_frames, dtype=np.uint8)
        lines = np.zeros(1, dtype=np.int64)
        total = int(self._lib.dm_count_frame_msgs(
            blob, offsets.ctypes.data_as(_I64P), n_frames, counts.ctypes.data_as(_I32P),
            corrupt.ctypes.data_as(_U8P), lines.ctypes.data_as(_I64P)))
        status = np.full(total, -1, dtype=np.int8)
        out_offsets = np.zeros(total + 1, dtype=np.int64)
        spans = np.zeros((total, 2), dtype=np.int64)
        if total == 0:
            return ParsedFrames(status, b"", out_offsets, blob, spans, int(corrupt.sum()),
                                int(lines[0]))
        ctx = self._ctx(int(time.time()), os.urandom(16 * total).hex().encode())

        def invoke(out, cap):
            return int(self._lib.dm_parse_frames(
                blob, offsets.ctypes.data_as(_I64P), n_frames, counts.ctypes.data_as(_I32P),
                corrupt.ctypes.data_as(_U8P), *ctx,
                out.ctypes.data_as(_U8P), cap, spans.ctypes.data_as(_I64P),
                out_offsets.ctypes.data_as(_I64P), status.ctypes.data_as(_I8P)))

        out_blob = self._run_with_capacity(len(blob), total, invoke)
        return ParsedFrames(status, out_blob, out_offsets, blob, spans, int(corrupt.sum()),
                            int(lines[0]))


class ParsedFrames:
    """``ParseKernel.parse_frames``'s result: per-message outputs and lazy
    raw access for the rows that go back to Python."""

    __slots__ = ("status", "out_blob", "ends", "frames_blob", "spans",
                 "n_corrupt_frames", "n_lines")

    def __init__(self, status, out_blob, ends, frames_blob, spans, n_corrupt_frames,
                 n_lines):
        self.status = status              # [m] int8: 1 emitted / 0 filtered / -1 Python
        self.out_blob = out_blob          # packed ParserSchema bytes
        self.ends = ends                  # [m+1] prefix ends into out_blob
        self.frames_blob = frames_blob
        self.spans = spans                # [m, 2] raw-byte spans per message
        self.n_corrupt_frames = n_corrupt_frames
        self.n_lines = n_lines

    def __len__(self) -> int:
        return len(self.status)

    def raw(self, i: int) -> bytes:
        s, e = self.spans[i]
        return self.frames_blob[s:e]


def has_logs_kernel() -> bool:
    """True once the library carries the LogSchema decode and the
    ParserSchema emit; a failed build raises ``NativeBuildError``."""
    return hasattr(load(), "dm_parse_logs_batch")


class LogsView:
    """Lazy (log, logID) views over a decoded ingest blob: a field is
    sliced only when read. ``status``: 1 envelope, 2 raw line, 0 JSON
    record (Python's json path), -1 Python decode (a strict parse
    failure)."""

    __slots__ = ("blob", "spans", "fspans", "status", "n_corrupt_frames", "n_lines")

    def __init__(self, blob: bytes, spans, fspans, status, n_corrupt_frames: int = 0,
                 n_lines: int = 0):
        self.blob = blob
        self.spans = spans            # [n, 2] payload byte spans
        self.fspans = fspans          # [n, 4] log/logID field spans
        self.status = status          # [n] int8
        self.n_corrupt_frames = n_corrupt_frames
        self.n_lines = n_lines

    def __len__(self) -> int:
        return len(self.status)

    def raw(self, i: int) -> bytes:
        s, e = self.spans[i]
        return self.blob[s:e]

    def raws(self) -> SpanRaws:
        return SpanRaws(self.blob, self.spans)

    def log(self, i: int) -> str:
        """The row's ``log``: an envelope's was UTF-8-checked in C; a raw
        line decodes with errors="replace", as the bare-line shape does."""
        row = self.fspans[i]
        text = self.blob[row[0]:row[1]]
        if self.status[i] == 2:
            return text.decode("utf-8", errors="replace")
        return text.decode("utf-8")

    def log_id(self, i: int) -> str:
        row = self.fspans[i]
        return self.blob[row[2]:row[3]].decode("utf-8")


def parse_logs_batch(payloads: Sequence[bytes], accept_raw: bool) -> LogsView:
    """Payloads → lazy (log, logID) views, one C call."""
    lib = load()
    blob, offsets = _pack(payloads)
    n = len(payloads)
    fspans = np.zeros((n, 4), dtype=np.int64)
    status = np.full(n, -1, dtype=np.int8)
    if n:
        lib.dm_parse_logs_batch(blob, offsets.ctypes.data_as(_I64P), n,
                                1 if accept_raw else 0, fspans.ctypes.data_as(_I64P),
                                status.ctypes.data_as(_I8P))
    spans = np.stack([offsets[:-1], offsets[1:]], axis=1)
    return LogsView(blob, spans, fspans, status)


def parse_logs_frames(frames: Sequence[bytes], accept_raw: bool) -> LogsView:
    """Wire frames → lazy per-message (log, logID) views: frame expansion
    and LogSchema decode in one C pass."""
    lib = load()
    blob, offsets = _pack(frames)
    n_frames = len(frames)
    counts = np.zeros(n_frames, dtype=np.int32)
    corrupt = np.zeros(n_frames, dtype=np.uint8)
    lines = np.zeros(1, dtype=np.int64)
    total = int(lib.dm_count_frame_msgs(
        blob, offsets.ctypes.data_as(_I64P), n_frames, counts.ctypes.data_as(_I32P),
        corrupt.ctypes.data_as(_U8P), lines.ctypes.data_as(_I64P)))
    spans = np.zeros((total, 2), dtype=np.int64)
    fspans = np.zeros((total, 4), dtype=np.int64)
    status = np.full(total, -1, dtype=np.int8)
    if total:
        lib.dm_parse_logs_frames(
            blob, offsets.ctypes.data_as(_I64P), n_frames, counts.ctypes.data_as(_I32P),
            corrupt.ctypes.data_as(_U8P), 1 if accept_raw else 0,
            spans.ctypes.data_as(_I64P), fspans.ctypes.data_as(_I64P),
            status.ctypes.data_as(_I8P))
    return LogsView(blob, spans, fspans, status, int(corrupt.sum()), int(lines[0]))


class ParserEmitter:
    """ParserSchema rows serialized in C into an output arena that is
    kept across calls (grown when a batch does not fit)."""

    def __init__(self, version: str, method_type: str, parser_id: str):
        self._lib = load()
        self._consts = (version.encode(), method_type.encode(), parser_id.encode())
        self._arena = np.empty(1 << 16, dtype=np.uint8)

    def emit(self, event_ids, templates, variables, log_ids, kv_items, now: int,
             rand_hex: bytes):
        """Serialize ``n`` rows → ``(arena, offsets)``, row i being
        ``arena[offsets[i]:offsets[i+1]]``. ``variables``: per-row lists of
        bytes; ``kv_items``: per-row lists of (key, value) bytes, already
        deduplicated in dict order; ``rand_hex``: 32 hex chars per row (the
        parsedLogIDs)."""
        n = len(event_ids)
        eid = np.asarray(event_ids, dtype=np.int32)
        tmpl_blob, tmpl_offs = _pack(templates)
        var_blob, var_offs = _pack([v for row in variables for v in row])
        var_counts = np.asarray([len(row) for row in variables], dtype=np.int32)
        id_blob, id_offs = _pack(log_ids)
        key_blob, key_offs = _pack([k for row in kv_items for k, _ in row])
        val_blob, val_offs = _pack([v for row in kv_items for _, v in row])
        kv_counts = np.asarray([len(row) for row in kv_items], dtype=np.int32)
        ts = np.full(n, int(now), dtype=np.int64)
        version, method_type, parser_id = self._consts
        out_offsets = np.zeros(n + 1, dtype=np.int64)
        while True:
            used = int(self._lib.dm_emit_parser_rows(
                n, eid.ctypes.data_as(_I32P),
                tmpl_blob, tmpl_offs.ctypes.data_as(_I64P),
                var_blob, var_offs.ctypes.data_as(_I64P), var_counts.ctypes.data_as(_I32P),
                id_blob, id_offs.ctypes.data_as(_I64P),
                key_blob, key_offs.ctypes.data_as(_I64P),
                val_blob, val_offs.ctypes.data_as(_I64P), kv_counts.ctypes.data_as(_I32P),
                version, len(version), method_type, len(method_type),
                parser_id, len(parser_id), rand_hex,
                ts.ctypes.data_as(_I64P), ts.ctypes.data_as(_I64P),
                self._arena.ctypes.data_as(_U8P), len(self._arena),
                out_offsets.ctypes.data_as(_I64P)))
            if used >= 0:
                return self._arena, out_offsets
            need = (len(tmpl_blob) + len(var_blob) + len(id_blob) + len(key_blob)
                    + len(val_blob) + 256 * n + 1024)
            self._arena = np.empty(max(len(self._arena) * 2, need), dtype=np.uint8)
