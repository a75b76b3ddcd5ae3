"""Detector base: train-then-detect streaming components.

Counterpart of ``detectmateservice_tpu/library/common/detector.py``:

* ``CoreDetector(name, buffer_mode, config)`` with overridable
  ``train(input_)`` and ``detect(input_, output_) -> bool``,
* config structure *events → EventID → instance → {params, variables
  [{pos,name,params}], header_variables [{pos,params}]}* plus a ``global``
  scope applying to every event,
* the first ``data_use_training`` messages only train (and are filtered);
  afterwards ``detect`` runs and a ``DetectorSchema`` alert is emitted only
  when it returns True — "no detection" produces no output at all.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Union

from ...schemas import DetectorSchema, ParserSchema, SchemaError
from ..utils.data_buffer import BufferMode, DataBuffer
from .core import CoreComponent, CoreConfig, LibraryError


def _extra(raw: Dict[str, Any], declared) -> Dict[str, Any]:
    """The keys of ``raw`` no field declares, kept as given (the pydantic
    models of the JAX package allow extra keys)."""
    return {k: v for k, v in raw.items() if k not in declared}


def _params(value: Any, where: str) -> Dict[str, Any]:
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise LibraryError(f"{where}: params must be a mapping")
    return dict(value)


@dataclasses.dataclass
class Variable:
    """A positional variable watched by a detector instance (``pos`` indexes
    into ``ParserSchema.variables``)."""

    pos: Union[int, str]
    name: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # keys no field declares, kept as given and dumped back
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        return self.name if self.name is not None else str(self.pos)

    @classmethod
    def parse(cls, raw: Any, where: str) -> "Variable":
        if not isinstance(raw, dict) or "pos" not in raw:
            raise LibraryError(f"{where}: a variable needs a 'pos'")
        pos = raw["pos"]
        if isinstance(pos, bool) or not isinstance(pos, (int, str)):
            raise LibraryError(f"{where}: pos must be an int or a str")
        name = raw.get("name")
        if name is not None and not isinstance(name, str):
            raise LibraryError(f"{where}: name must be a str")
        return cls(pos=pos, name=name, params=_params(raw.get("params"), where),
                   extra=_extra(raw, ("pos", "name", "params")))


@dataclasses.dataclass
class HeaderVariable:
    """A named variable watched via ``ParserSchema.logFormatVariables``."""

    pos: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        return self.pos

    @classmethod
    def parse(cls, raw: Any, where: str) -> "HeaderVariable":
        if not isinstance(raw, dict) or not isinstance(raw.get("pos"), str):
            raise LibraryError(f"{where}: a header variable needs a str 'pos'")
        return cls(pos=raw["pos"], params=_params(raw.get("params"), where),
                   extra=_extra(raw, ("pos", "params")))


@dataclasses.dataclass
class InstanceConfig:
    """One named detector instance within an event (or global) scope."""

    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    variables: List[Variable] = dataclasses.field(default_factory=list)
    header_variables: List[HeaderVariable] = dataclasses.field(default_factory=list)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def get_all(self) -> Dict[str, Union[Variable, HeaderVariable]]:
        """All watched fields keyed by label."""
        out: Dict[str, Union[Variable, HeaderVariable]] = {}
        for var in self.variables:
            out[var.label] = var
        for hvar in self.header_variables:
            out[hvar.label] = hvar
        return out

    @classmethod
    def parse(cls, raw: Any, where: str) -> "InstanceConfig":
        if raw is None:
            return cls()
        if not isinstance(raw, dict):
            raise LibraryError(f"{where}: an instance must be a mapping")
        return cls(
            params=_params(raw.get("params"), where),
            variables=[Variable.parse(v, where) for v in raw.get("variables") or []],
            header_variables=[HeaderVariable.parse(v, where)
                              for v in raw.get("header_variables") or []],
            extra=_extra(raw, ("params", "variables", "header_variables")))


def _parse_instances(raw: Any, where: str) -> Dict[str, InstanceConfig]:
    if not isinstance(raw, dict):
        raise LibraryError(f"{where}: expected a mapping of instances")
    return {str(k): InstanceConfig.parse(v, f"{where}.{k}") for k, v in raw.items()}


def _parse_events(raw: Any, where: str) -> Dict[Union[int, str], Dict[str, InstanceConfig]]:
    if not isinstance(raw, dict):
        raise LibraryError(f"{where}: expected a mapping of event ids")
    return {k: _parse_instances(v, f"{where}.{k}") for k, v in raw.items()}


@dataclasses.dataclass
class CoreDetectorConfig(CoreConfig):
    method_type: str = "core_detector"
    data_use_training: int = 0
    # "no_buf" | "fixed" | "micro_batch": overrides the constructor default
    # so a loader that only passes config can select FIXED windowed
    # detection; None keeps the component's own default
    buffer_mode: Optional[str] = None
    buffer_size: int = 32  # FIXED mode: messages per detection window
    events: Dict[Union[int, str], Dict[str, InstanceConfig]] = dataclasses.field(
        default_factory=dict, metadata={"parse": _parse_events})
    global_: Dict[str, InstanceConfig] = dataclasses.field(
        default_factory=dict, metadata={"alias": "global", "parse": _parse_instances})

    def event_instances(self, event_id: Any) -> Dict[str, InstanceConfig]:
        """Instances for one event id (int/str keys both accepted)."""
        for key in (event_id, str(event_id)):
            if key in self.events:
                return self.events[key]
        try:
            as_int = int(event_id)
        except (TypeError, ValueError):
            return {}
        return self.events.get(as_int, {})


class CoreDetector(CoreComponent):
    """Streaming detector: deserialize → (train | detect) → alert | None."""

    config_class = CoreDetectorConfig
    category = "detectors"
    description = "CoreDetector base class."

    def __init__(
        self,
        name: Optional[str] = None,
        buffer_mode: BufferMode = BufferMode.NO_BUF,
        config: Any = None,
    ) -> None:
        super().__init__(name=name, config=config)
        self.config: CoreDetectorConfig
        cfg_mode = getattr(self.config, "buffer_mode", None)
        if cfg_mode:  # the config wins over the constructor default
            try:
                buffer_mode = BufferMode(cfg_mode)
            except ValueError as exc:
                raise LibraryError(
                    f"{self.name}: unknown buffer_mode {cfg_mode!r}; expected "
                    f"one of {[m.value for m in BufferMode]}") from exc
        self.buffer_mode = buffer_mode
        self._buffer = (DataBuffer(int(getattr(self.config, "buffer_size", 32)))
                        if buffer_mode == BufferMode.FIXED else None)
        self._pending_outputs: List[bytes] = []  # windows detected off-path
        self._trained = 0
        self._alert_ids = itertools.count(int(getattr(self.config, "start_id", 0)))

    def validate_reconfigure(self, new_config) -> None:
        """``buffer_mode`` shapes the processing topology; it cannot flip on
        a live instance (an absent field keeps the current mode)."""
        new_mode = getattr(new_config, "buffer_mode", None) or self.buffer_mode.value
        if new_mode != self.buffer_mode.value:
            raise LibraryError(
                f"buffer_mode cannot change at runtime (current="
                f"{self.buffer_mode.value!r} new={new_mode!r}); restart the service")

    def apply_config(self) -> None:
        """A changed ``buffer_size`` rebuilds the FIXED window in place;
        windows that fill during the carry-over are detected now and their
        alerts surface via ``flush()``."""
        if self._buffer is not None:
            new_size = max(1, int(getattr(self.config, "buffer_size", 32)))
            if new_size != self._buffer._size:
                old_items = self._buffer.flush()
                self._buffer = DataBuffer(new_size)
                for item in old_items:
                    window = self._buffer.push(item)
                    if window is not None:
                        out = self._detect_over_window(window)
                        if out is not None:
                            self._pending_outputs.append(out)

    def flush(self) -> List[Optional[bytes]]:
        """Engine idle hook: alerts produced off the process() path."""
        out, self._pending_outputs = self._pending_outputs, []
        return out

    # -- overridables ---------------------------------------------------
    def train(self, input_: Union[ParserSchema, List[ParserSchema]]) -> None:
        """Consume training messages (first ``data_use_training`` messages)."""

    def detect(self, input_: ParserSchema, output_: DetectorSchema) -> bool:
        """Populate ``output_`` and return True to emit an alert."""
        raise NotImplementedError

    # -- engine contract ------------------------------------------------
    def process(self, data: bytes) -> Optional[bytes]:
        try:
            input_ = ParserSchema.from_bytes(data)
        except SchemaError as exc:
            raise LibraryError(f"{self.name}: cannot deserialize ParserSchema: {exc}") from exc
        return self.process_parsed(input_)

    def process_parsed(self, input_: ParserSchema) -> Optional[bytes]:
        if self._trained < self.config.data_use_training:
            self.train(input_)
            self._trained += 1
            return None
        if self._buffer is not None:  # FIXED: windowed detection
            window = self._buffer.push(input_)
            if window is None:
                return None
            return self._detect_over_window(window)
        output_ = self.make_output(input_)
        if self.detect(input_, output_):
            return output_.serialize()
        return None

    # -- FIXED (windowed) mode ------------------------------------------
    def _detect_over_window(self, window: List[ParserSchema]) -> Optional[bytes]:
        """One alert per window: the skeleton comes from the newest message,
        ``logIDs``/``extractedTimestamps`` cover the whole window."""
        output_ = self.make_output(window[-1])
        output_["logIDs"] = [m["logID"] for m in window if m.get("logID")]
        stamps = [self.extract_timestamp(m) for m in window]
        output_["extractedTimestamps"] = [s for s in stamps if s is not None]
        if self.detect_window(window, output_):
            return output_.serialize()
        return None

    def detect_window(self, window: List[ParserSchema],
                      output_: DetectorSchema) -> bool:
        """FIXED-mode hook: the default ORs the per-message ``detect``."""
        hit = False
        for input_ in window:
            hit = self.detect(input_, output_) or hit
        return hit

    def flush_final(self) -> List[Optional[bytes]]:
        """Stop-time drain: pending off-path alerts plus a partial FIXED
        window — no buffered message is silently lost at shutdown."""
        out = self.flush()
        if self._buffer is not None and len(self._buffer):
            out.append(self._detect_over_window(self._buffer.flush()))
        return out

    def make_output(self, input_: ParserSchema) -> DetectorSchema:
        """Prefill a DetectorSchema alert skeleton."""
        now = int(time.time())
        output_ = DetectorSchema()
        output_["detectorID"] = self.name
        output_["detectorType"] = self.config.method_type
        output_["alertID"] = str(next(self._alert_ids))
        output_["detectionTimestamp"] = now
        output_["receivedTimestamp"] = now
        if input_.get("logID"):
            output_["logIDs"] = [input_["logID"]]
        ts = self.extract_timestamp(input_)
        output_["extractedTimestamps"] = [ts if ts is not None else now]
        output_["description"] = self.description
        return output_

    @staticmethod
    def extract_timestamp(input_: ParserSchema) -> Optional[int]:
        lfv = input_["logFormatVariables"]
        for key in ("Time", "time", "timestamp"):
            value = lfv.get(key)
            if value:
                try:
                    return int(float(value))
                except (ValueError, OverflowError):
                    # '1e400'/'inf' means "no timestamp", not an exception
                    return None
        if input_.get("receivedTimestamp"):
            return int(input_["receivedTimestamp"])
        return None
