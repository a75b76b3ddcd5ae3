"""MatcherParser: log-format tokenization and template matching.

The port's copy of ``detectmateservice_tpu/library/parsers/template_matcher.py``
over the port's own schema codec and native library:

* ``log_format`` is a token template such as
  ``type=<Type> msg=audit(<Time>): <Content>``; each ``<Name>`` captures one
  field into ``logFormatVariables``;
* the ``<Content>`` capture (or, without one, the whole line) is normalized
  (``remove_spaces`` / ``remove_punctuation`` / ``lowercase``) and matched
  against the ``<*>`` templates of ``path_templates``; the first matching
  template's 1-based index is ``EventID`` and its wildcard captures are
  ``variables``;
* the output's ``log`` field is the parser's name, not the input line.

With ``native_parse`` (the default) the rows run through the port's C
(``utils/matchkern.py`` over ``native/dmfeat.c``): the fused row kernel when
no ``time_format`` is set, else the LogSchema decode and the ParserSchema
emit around Python's header extraction. That library is built at the
parser's first use; if it cannot be built, ``setup_io`` (and any call that
needs it) raises ``LibraryError`` naming it, and no Python path runs in its
place. With ``native_parse: false`` every row takes the pure-Python path
(``_process_batch_plain``), the plain version the native rows are held
against.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import string
import time
import uuid
from pathlib import Path
from typing import Any, List, Optional, Pattern, Tuple

from ...schemas import SCHEMA_VERSION, LogSchema, ParserSchema, SchemaError
from ..common.core import CoreComponent, CoreConfig, LibraryError

_TOKEN_RE = re.compile(r"<([A-Za-z_][A-Za-z0-9_]*)>")
_PUNCT_TABLE = str.maketrans("", "", string.punctuation)
# LogSchema's fields: one present on the wire <=> the bytes are an
# envelope, not text that happens to parse as protobuf
_LOGSCHEMA_FIELDS = ("__version__", "logID", "log", "logSource", "hostname")


@dataclasses.dataclass
class MatcherParserConfig(CoreConfig):
    method_type: str = "matcher_parser"
    log_format: Optional[str] = None
    time_format: Optional[str] = None
    # flattened from params by CoreConfig.from_dict
    remove_spaces: bool = False
    remove_punctuation: bool = False
    lowercase: bool = False
    path_templates: Optional[str] = None
    # true: payloads that are not LogSchema protobufs are taken as a JSON
    # record ({"message": line, "logSource": ..., "hostname": ...}) or as
    # the bare line; false: such payloads raise
    accept_raw_lines: bool = False
    # the rows in the port's C (false: the pure-Python path throughout)
    native_parse: bool = True


def decode_ingest_payload(data: bytes, accept_raw: bool) -> LogSchema:
    """One ingest payload → a LogSchema message. Tried in order: a LogSchema
    protobuf (in strict mode whatever parses; with ``accept_raw`` only bytes
    that parse with at least one LogSchema field present), then, with
    ``accept_raw``, a JSON record (message → log, logID, logSource,
    hostname) and last the bare line minus one trailing newline. Without
    ``accept_raw`` a payload that does not parse raises SchemaError."""
    msg = LogSchema()
    try:
        msg.deserialize(data)
    except SchemaError as exc:
        if not accept_raw:
            raise SchemaError(f"cannot parse LogSchema: {exc}") from exc
        envelope = False
    else:
        if not accept_raw:
            return msg
        envelope = any(msg.has(f) for f in _LOGSCHEMA_FIELDS)
    if envelope:
        return msg
    out = LogSchema()
    if data[:1] == b"{":
        try:
            rec = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            rec = None
        if isinstance(rec, dict) and ("message" in rec or "log" in rec):
            out.log = str(rec.get("message", rec.get("log", "")))
            if rec.get("logID"):
                out.logID = str(rec["logID"])
            if rec.get("logSource"):
                out.logSource = str(rec["logSource"])
            if rec.get("hostname"):
                out.hostname = str(rec["hostname"])
            return out
    line = data.decode("utf-8", errors="replace")
    if line.endswith("\n"):          # a line formatter's trailing newline
        line = line[:-1]
    out.log = line
    return out


def split_log_format(log_format: str) -> Tuple[List[str], List[str]]:
    """A ``<Name>`` token template → (literal segments, capture names),
    ``len(lits) == len(names) + 1``: the one home of the capture-token
    grammar, for the regex path and the C row alike."""
    lits: List[str] = []
    names: List[str] = []
    pos = 0
    for match in _TOKEN_RE.finditer(log_format):
        lits.append(log_format[pos:match.start()])
        names.append(match.group(1))
        pos = match.end()
    lits.append(log_format[pos:])
    return lits, names


def compile_log_format(log_format: str) -> Tuple[Pattern, List[str]]:
    """A ``<Name>`` token template → a regex and its capture names."""
    lits, names = split_log_format(log_format)
    pattern_parts: List[str] = ["^"]
    for i, name in enumerate(names):
        pattern_parts.append(re.escape(lits[i]))
        # the capture that ends the format is greedy; all others lazy
        trailing = i == len(names) - 1 and lits[i + 1] == ""
        pattern_parts.append("(.*)" if trailing else "(.*?)")
    pattern_parts.append(re.escape(lits[-1]))
    pattern_parts.append("$")
    return re.compile("".join(pattern_parts)), names


def compile_template(template: str) -> Pattern:
    """A ``<*>`` template → its matching regex, with the C scan's semantics
    (the match the JAX parser makes with its library loaded): a wildcard
    spans newlines too, and the last segment ends the string."""
    parts = [re.escape(piece) for piece in template.split("<*>")]
    return re.compile("^" + "(.*?)".join(parts[:-1]) + ("(.*)" if len(parts) > 1 else "")
                      + parts[-1] + r"\Z", re.DOTALL)


class MatcherParser(CoreComponent):
    config_class = MatcherParserConfig
    category = "parsers"

    def __init__(self, name: Optional[str] = None, config: Any = None) -> None:
        super().__init__(name=name, config=config)
        self.config: MatcherParserConfig
        self._parse_counters = None
        self._native_ready = False
        self.apply_config()

    def apply_config(self) -> None:
        """(Re)build the config-derived state; also the runtime reconfigure
        hook. Everything is built first and swapped in at the end, so a
        failure (a bad log_format, a missing templates file, a library that
        does not build) leaves the running parser as it was."""
        format_re: Optional[Pattern] = None
        format_names: List[str] = []
        if self.config.log_format:
            format_re, format_names = compile_log_format(self.config.log_format)
        templates: List[str] = []
        template_res: List[Pattern] = []
        if self.config.path_templates:
            templates, template_res = self._read_templates(self.config.path_templates)
        native = self._build_native(templates) if self._native_ready else (None,) * 4
        self._format_re, self._format_names = format_re, format_names
        self._templates, self._template_res = templates, template_res
        self._native, self._parse_native, self._logs_native, self._emitter = native

    def setup_io(self) -> None:
        """Build the native library when ``native_parse`` is on; raises
        ``LibraryError`` naming it when it does not build."""
        self._ensure_native()

    def _ensure_native(self) -> None:
        if self.config.native_parse and not self._native_ready:
            native = self._build_native(self._templates)
            self._native, self._parse_native, self._logs_native, self._emitter = native
            self._native_ready = True

    def _build_native(self, templates: List[str]) -> tuple:
        """(template matcher, fused row kernel, decode module, emitter) from
        the library; all None with ``native_parse`` off. A ``time_format``
        needs Python's strptime, so it keeps the fused row kernel out."""
        if not self.config.native_parse:
            return None, None, None, None
        from ...utils import matchkern

        try:
            matcher = (matchkern.TemplateMatcher([self._normalize(t) for t in templates])
                       if templates else None)
            parse_native = None
            if not self.config.time_format and matchkern.has_parse_kernel():
                flags = ((1 if self.config.remove_spaces else 0)
                         | (2 if self.config.remove_punctuation else 0)
                         | (4 if self.config.lowercase else 0))
                lits, names = (split_log_format(self.config.log_format)
                               if self.config.log_format else ([], []))
                parse_native = matchkern.ParseKernel(
                    lits=lits, names=names, norm_flags=flags,
                    accept_raw=self.config.accept_raw_lines, matcher=matcher,
                    raw_templates=templates, method_type=self.config.method_type,
                    parser_id=self.name, version=SCHEMA_VERSION)
            emitter = matchkern.ParserEmitter(SCHEMA_VERSION, self.config.method_type,
                                              self.name)
        except matchkern.NativeBuildError as exc:
            raise LibraryError(
                f"{self.name}: native_parse is on but the native parser library "
                f"({matchkern.SOURCE.name}) did not build: {exc}") from exc
        return matcher, parse_native, matchkern, emitter

    def _read_templates(self, path: str):
        try:
            text = Path(path).read_text(encoding="utf-8")
        except OSError as exc:
            raise LibraryError(f"{self.name}: cannot read templates file {path}: {exc}") from exc
        templates = [line.rstrip("\n") for line in text.splitlines() if line.strip()]
        return templates, [compile_template(self._normalize(t)) for t in templates]

    # ------------------------------------------------------------------
    def _normalize(self, text: str) -> str:
        if self.config.lowercase:
            text = text.lower()
        if self.config.remove_punctuation:
            # keep the <*> wildcard intact while stripping punctuation
            text = "\x00*\x00".join(
                piece.translate(_PUNCT_TABLE) for piece in text.split("<*>")
            ).replace("\x00*\x00", "<*>")
        if self.config.remove_spaces:
            text = "<*>".join(piece.replace(" ", "") for piece in text.split("<*>"))
        return text

    def match_templates(self, content: str) -> Tuple[int, str, List[str]]:
        """(EventID, template, variables); EventID is the 1-based index of
        the first matching template, -1 when none matches."""
        self._ensure_native()
        normalized = self._normalize(content)
        if self._native is not None:
            idx, variables = self._native.match(normalized)
            if idx >= 0:
                return idx + 1, self._templates[idx], variables
            return -1, "", []
        for idx, template_re in enumerate(self._template_res):
            found = template_re.match(normalized)
            if found:
                return idx + 1, self._templates[idx], [g for g in found.groups()
                                                       if g is not None]
        return -1, "", []

    def _extract_header(self, log_line: str):
        """``log_format`` header capture and Time conversion →
        (header_vars, content); None for a blank line (filtered)."""
        if not log_line.strip():
            return None
        header_vars = {}
        content = log_line
        if self._format_re is not None:
            found = self._format_re.match(log_line)
            if found:
                header_vars = dict(zip(self._format_names, found.groups()))
                content = header_vars.get("Content", log_line)
        if self.config.time_format and "Time" in header_vars:
            try:
                parsed = time.strptime(header_vars["Time"], self.config.time_format)
                header_vars["Time"] = str(int(time.mktime(parsed)))
            except (ValueError, OverflowError, OSError):
                pass  # a bad Time keeps its raw string
        return header_vars, content

    def parse_line(self, log_line: str, log_id: str = "",
                   received_ts: Optional[int] = None) -> Optional[ParserSchema]:
        """One raw line → a ParserSchema (None: blank, filtered)."""
        extracted = self._extract_header(log_line)
        if extracted is None:
            return None
        header_vars, content = extracted
        event_id, template, variables = (
            self.match_templates(content) if self._templates else (-1, "", []))
        now = int(time.time())
        out = ParserSchema()
        out["parserType"] = self.config.method_type
        out["parserID"] = self.name
        out["EventID"] = event_id
        out["template"] = template
        out["variables"] = variables
        out["parsedLogID"] = uuid.uuid4().hex
        out["logID"] = log_id
        out["log"] = self.name  # the parser's name, not the line
        out["logFormatVariables"] = header_vars
        out["receivedTimestamp"] = received_ts if received_ts is not None else now
        out["parsedTimestamp"] = now
        return out

    def process(self, data: bytes) -> Optional[bytes]:
        try:
            msg = decode_ingest_payload(data, self.config.accept_raw_lines)
        except SchemaError as exc:
            raise LibraryError(f"{self.name}: cannot deserialize LogSchema: {exc}") from exc
        parsed = self.parse_line(msg.log, log_id=msg.logID)
        return parsed.serialize() if parsed is not None else None

    def process_batch(self, batch: List[bytes]) -> List[Optional[bytes]]:
        """The engine's batched path, with ``process``'s field semantics:
        the fused C row when it applies (rows it flags are re-run in
        Python, in one batched call), else the batched Python path."""
        self._ensure_native()
        if self._parse_native is not None:
            status, blob, ends = self._parse_native.parse_batch(batch)
            return self._assemble_native_outputs(status, ends, blob, batch.__getitem__)
        return self._process_batch_python(batch)

    def _count_parse_rows(self, native: int, fallback: int) -> None:
        """``parse_native_rows_total`` / ``parse_fallback_rows_total`` under
        a hosting Service: which path decoded and serialized how many rows."""
        if self.metrics is None or not (native or fallback):
            return
        if self._parse_counters is None:
            self._parse_counters = (
                self.metrics.PARSE_NATIVE_ROWS().labels(**self.metrics_labels),
                self.metrics.PARSE_FALLBACK_ROWS().labels(**self.metrics_labels))
        if native:
            self._parse_counters[0].inc(native)
        if fallback:
            self._parse_counters[1].inc(fallback)

    def _assemble_native_outputs(self, status, ends, blob, raw_fn) -> List[Optional[bytes]]:
        """Status → outputs for the batch and frames kernels: 1 the emitted
        bytes, 0 filtered (None), -1 the row's raw payload (``raw_fn(i)``)
        re-run through the batched Python path, all flagged rows in one
        call, spliced back in order."""
        status_list = status.tolist()
        n = len(status_list)
        flagged = [i for i, st in enumerate(status_list) if st == -1]
        # flagged rows are counted by the Python call that handles them
        self._count_parse_rows(n - len(flagged), 0)
        if len(flagged) == n:
            return self._process_batch_python([raw_fn(i) for i in range(n)])
        outs: List[Optional[bytes]] = [None] * n
        if flagged:
            sub = self._process_batch_python([raw_fn(i) for i in flagged])
            for j, i in enumerate(flagged):
                outs[i] = sub[j]
        ends_list = ends.tolist()
        for i, st in enumerate(status_list):
            if st == 1:
                outs[i] = blob[ends_list[i]:ends_list[i + 1]]
        return outs

    def process_frames(self, frames: List[bytes]):
        """Whole wire frames in, ``(outputs, n_messages, n_lines)`` out: frame
        expansion and the whole row in one C pass (``dm_parse_frames``);
        without the fused kernel (a ``time_format``) expansion and decode
        in C around the Python header extraction; with ``native_parse``
        off, frames expanded in Python and handed to ``process_batch``."""
        self._ensure_native()
        if self._parse_native is None:
            if self._logs_native is not None:
                view = self._logs_native.parse_logs_frames(frames,
                                                           self.config.accept_raw_lines)
                if view.n_corrupt_frames:
                    self.count_processing_errors(view.n_corrupt_frames,
                                                 "corrupt batch frame(s)")
                return self._outputs_from_view(view, view.raw), len(view), view.n_lines
            from ...engine.framing import FramingError, unpack_batch

            msgs: List[bytes] = []
            n_corrupt = 0
            for frame in frames:
                try:
                    unpacked = unpack_batch(frame)
                except FramingError:
                    n_corrupt += 1
                    continue
                if unpacked is None:
                    if frame:
                        msgs.append(frame)
                else:
                    msgs.extend(m for m in unpacked if m)
            if n_corrupt:
                self.count_processing_errors(n_corrupt, "corrupt batch frame(s)")
            n_lines = sum(max(1, d.count(b"\n") + (0 if d.endswith(b"\n") else 1))
                          for d in msgs)
            return self.process_batch(msgs), len(msgs), n_lines
        pf = self._parse_native.parse_frames(frames)
        if pf.n_corrupt_frames:
            self.count_processing_errors(pf.n_corrupt_frames, "corrupt batch frame(s)")
        outs = self._assemble_native_outputs(pf.status, pf.ends, pf.out_blob, pf.raw)
        return outs, len(pf.status), pf.n_lines

    def _process_batch_python(self, batch) -> List[Optional[bytes]]:
        """The batched Python path: with the library, its LogSchema decode
        and ParserSchema emit around Python's header extraction and match;
        without it (``native_parse`` off) the plain path."""
        if self._logs_native is not None and self._emitter is not None:
            view = self._logs_native.parse_logs_batch(batch, self.config.accept_raw_lines)
            return self._outputs_from_view(view, batch.__getitem__)
        return self._process_batch_plain(batch)

    def _decode_json_row(self, data: bytes) -> Tuple[str, str]:
        """``decode_ingest_payload``'s JSON and bare-line shapes → (log,
        logID), the only fields the row reads."""
        rec = None
        if data[:1] == b"{":
            try:
                rec = json.loads(data)
            except (ValueError, UnicodeDecodeError):
                rec = None
        if isinstance(rec, dict) and ("message" in rec or "log" in rec):
            log = str(rec.get("message", rec.get("log", "")))
            log_id = str(rec["logID"]) if rec.get("logID") else ""
            return log, log_id
        line = data.decode("utf-8", errors="replace")
        if line.endswith("\n"):
            line = line[:-1]
        return line, ""

    def _outputs_from_view(self, view, raw_fn) -> List[Optional[bytes]]:
        """Outputs from a ``LogsView``: statuses 1 and 2 read their fields
        from the blob, 0 (JSON) takes the dict mapping, -1 the per-row
        decode (a strict-mode failure is counted as an error); the rows
        then go through ``_assemble_decoded``."""
        status = view.status.tolist()
        decode_errors = native_rows = fallback_rows = 0
        decoded: List[Any] = []          # (log, logID) | False (error)
        for i, st in enumerate(status):
            if st == 1 or st == 2:
                decoded.append((view.log(i), view.log_id(i)))
                native_rows += 1
                continue
            fallback_rows += 1
            if st == 0:
                decoded.append(self._decode_json_row(raw_fn(i)))
                continue
            try:
                msg = decode_ingest_payload(raw_fn(i), self.config.accept_raw_lines)
            except SchemaError:
                decode_errors += 1
                decoded.append(False)
                continue
            decoded.append((msg.log, msg.logID))
        outs = self._assemble_decoded(decoded)
        if decode_errors:
            self.count_processing_errors(decode_errors, "undecodable LogSchema message(s)")
        self._count_parse_rows(native_rows, fallback_rows)
        return outs

    def _assemble_decoded(self, decoded) -> List[Optional[bytes]]:
        """(log, logID) rows → serialized ParserSchema bytes through the C
        emitter, one call for the batch."""
        outs: List[Optional[bytes]] = [None] * len(decoded)
        emit_idx: List[int] = []
        extracted_list = []
        for i, item in enumerate(decoded):
            if item is False:
                continue
            extracted = self._extract_header(item[0])
            if extracted is None:
                continue                 # blank line: filtered
            emit_idx.append(i)
            extracted_list.append(extracted)
        if not emit_idx:
            return outs
        have_templates = bool(self._templates)
        matches = (self._native.match_batch([self._normalize(c) for _, c in extracted_list])
                   if have_templates and self._native is not None else None)
        event_ids: List[int] = []
        templates: List[bytes] = []
        variables: List[List[bytes]] = []
        log_ids: List[bytes] = []
        kv_items: List[List[Tuple[bytes, bytes]]] = []
        for j, i in enumerate(emit_idx):
            header_vars, content = extracted_list[j]
            if not have_templates:
                event_id, template, caps = -1, "", []
            elif matches is not None:
                idx, caps = matches[j]
                if idx >= 0:
                    event_id, template = idx + 1, self._templates[idx]
                else:
                    event_id, template, caps = -1, "", []
            else:
                event_id, template, caps = self.match_templates(content)
            event_ids.append(event_id)
            templates.append(template.encode("utf-8"))
            variables.append([v.encode("utf-8") for v in caps])
            log_ids.append(decoded[i][1].encode("utf-8"))
            kv_items.append([(k.encode("utf-8"),
                              (v if v is not None else "").encode("utf-8"))
                             for k, v in header_vars.items()])
        now = int(time.time())
        rand_hex = os.urandom(16 * len(emit_idx)).hex().encode()
        arena, offs = self._emitter.emit(event_ids, templates, variables, log_ids, kv_items,
                                         now, rand_hex)
        offs_list = offs.tolist()
        for j, i in enumerate(emit_idx):
            outs[i] = arena[offs_list[j]:offs_list[j + 1]].tobytes()
        return outs

    def _process_batch_plain(self, batch) -> List[Optional[bytes]]:
        """The plain version: every row decoded, matched and serialized in
        Python, the regex template scan included."""
        outs: List[Optional[bytes]] = []
        method_type = self.config.method_type
        name = self.name
        have_templates = bool(self._templates)
        decode_errors = 0
        accept_raw = self.config.accept_raw_lines
        for data in batch:
            try:
                msg = decode_ingest_payload(data, accept_raw)
            except SchemaError:
                decode_errors += 1
                outs.append(None)
                continue
            extracted = self._extract_header(msg.log)
            if extracted is None:
                outs.append(None)
                continue
            header_vars, content = extracted
            event_id, template, variables = (self.match_templates(content) if have_templates
                                             else (-1, "", []))
            now = int(time.time())
            out = ParserSchema()
            out.parserType = method_type
            out.parserID = name
            out.EventID = event_id
            out.template = template
            out.variables = variables
            out.parsedLogID = os.urandom(16).hex()
            out.logID = msg.logID  # set even when empty: its presence is written
            out.log = name
            out.logFormatVariables = {k: (v if v is not None else "")
                                      for k, v in header_vars.items()}
            out.receivedTimestamp = now
            out.parsedTimestamp = now
            outs.append(out.serialize())
        if decode_errors:
            # the single-message path raises per message, which the engine
            # counts; the batched path counts in the same series
            self.count_processing_errors(decode_errors, "undecodable LogSchema message(s)")
        self._count_parse_rows(0, len(batch))
        return outs
