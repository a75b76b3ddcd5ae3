"""Base component contract: ``CoreComponent`` + ``CoreConfig``.

Counterpart of ``detectmateservice_tpu/library/common/core.py`` with
dataclasses in place of pydantic models:

* ``CoreComponent(name=None, config=None)`` with ``process(bytes) -> bytes|None``,
* ``CoreConfig`` with ``from_dict`` / ``to_dict``; each field's value is
  checked against its annotation when a config is built from a mapping, and
  keys no field declares are kept in ``extra`` (the pydantic models allow
  extra keys too),
* the same normalization: ``auto_config`` gate, ``method_type`` check,
  ``all_``-prefix parameter broadcast, flattening of ``params`` into the top
  level.
"""
from __future__ import annotations

import dataclasses
import logging
import typing
from typing import Any, Dict, Optional, Type, TypeVar, Union

CATEGORIES = ("detectors", "parsers", "readers", "outputs")

C = TypeVar("C", bound="CoreConfig")


class LibraryError(Exception):
    """Base error for component-library failures."""


class AutoConfigError(LibraryError):
    """auto_config is disabled but no usable parameters were provided."""


class MethodTypeError(LibraryError):
    """Configured method_type does not match the component."""


def _coerce(value: Any, tp: Any, where: str) -> Any:
    """Check ``value`` against the annotation ``tp``; ints widen to float
    and integral floats narrow to int, as pydantic's lax mode does."""
    if tp is Any:
        return value
    origin = typing.get_origin(tp)
    if origin is Union:
        args = typing.get_args(tp)
        if value is None and type(None) in args:
            return None
        errors = []
        for arg in args:
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg, where)
            except LibraryError as exc:
                errors.append(str(exc))
        raise LibraryError("; ".join(errors))
    if origin in (dict, Dict):
        if not isinstance(value, dict):
            raise LibraryError(f"{where}: expected a mapping, got {type(value).__name__}")
        return dict(value)
    if tp is bool:
        if isinstance(value, bool):
            return value
    elif tp is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
    elif tp is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
    elif tp is str:
        if isinstance(value, str):
            return value
    else:
        raise LibraryError(f"{where}: unsupported annotation {tp!r}")
    raise LibraryError(f"{where}: expected {tp.__name__}, got {value!r}")


@dataclasses.dataclass
class CoreConfig:
    """Base configuration for all components."""

    method_type: str = "core"
    auto_config: bool = True
    start_id: int = 0
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # keys no field declares, kept as given
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls: Type[C], data: Dict[str, Any], name: Optional[str] = None) -> C:
        """Build a config from the namespaced on-disk shape (the full
        *category → ClassName → params* document, or the already-extracted
        per-component mapping), after the normalization pipeline."""
        section = _extract_section(data, name)
        section = normalize_config(dict(section), expected_method_type=_expected_method_type(cls))
        try:
            return cls.model_validate(section)
        except LibraryError as exc:
            raise LibraryError(f"invalid config for {name or cls.__name__}: {exc}") from exc

    @classmethod
    def model_validate(cls: Type[C], section: Dict[str, Any]) -> C:
        """Check every known key against its field's annotation."""
        hints = typing.get_type_hints(cls)
        by_key = {}
        for f in dataclasses.fields(cls):
            if f.name != "extra":
                by_key[f.metadata.get("alias", f.name)] = f
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        for key, value in section.items():
            f = by_key.get(key)
            if f is None:
                extra[key] = value
                continue
            parse = f.metadata.get("parse")
            kwargs[f.name] = (parse(value, key) if parse is not None
                              else _coerce(value, hints[f.name], key))
        return cls(**kwargs, extra=extra)

    def to_dict(self) -> Dict[str, Any]:
        """Dump with defaults stripped at every level, keys under their
        aliases (pydantic's ``exclude_defaults=True, by_alias=True``)."""
        return _dump(self)


def _dump(value: Any) -> Any:
    if dataclasses.is_dataclass(value):
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(value):
            if f.name == "extra":
                continue
            item = getattr(value, f.name)
            default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else f.default)
            if item != default:
                out[f.metadata.get("alias", f.name)] = _dump(item)
        out.update(getattr(value, "extra", {}))
        return out
    if isinstance(value, dict):
        return {k: _dump(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_dump(v) for v in value]
    return value


def _expected_method_type(cls: Type[CoreConfig]) -> Optional[str]:
    for f in dataclasses.fields(cls):
        if f.name == "method_type" and isinstance(f.default, str) and f.default != "core":
            return f.default
    return None


def _extract_section(data: Dict[str, Any], name: Optional[str]) -> Dict[str, Any]:
    if not isinstance(data, dict):
        raise LibraryError(f"config must be a mapping, got {type(data).__name__}")
    for category in CATEGORIES:
        block = data.get(category)
        if isinstance(block, dict):
            if name and name in block:
                return block[name]
            if len(block) == 1:
                return next(iter(block.values())) or {}
    return data


def normalize_config(section: Dict[str, Any], expected_method_type: Optional[str] = None) -> Dict[str, Any]:
    """Apply the reference library's config normalization pipeline."""
    method_type = section.get("method_type")
    if expected_method_type and method_type and method_type != expected_method_type:
        raise MethodTypeError(
            f"method_type {method_type!r} does not match expected {expected_method_type!r}"
        )
    auto_config = section.get("auto_config", True)
    params = section.get("params") or {}
    has_structure = any(
        section.get(k) for k in ("events", "global", "variables", "header_variables")
    )
    meaningful = {k for k in section if k not in ("method_type", "auto_config", "params")}
    if not auto_config and not params and not has_structure and not meaningful:
        raise AutoConfigError(
            "auto_config is disabled but no parameters were provided"
        )
    # ``all_`` broadcast: all_<key> in params becomes <key>, pushed down into
    # every variable/instance params block that does not already set it
    broadcast = {k[len("all_"):]: v for k, v in params.items() if k.startswith("all_")}
    params = {k: v for k, v in params.items() if not k.startswith("all_")}
    if broadcast:
        params.update({k: v for k, v in broadcast.items() if k not in params})
        for events_key in ("events", "global"):
            block = section.get(events_key)
            if isinstance(block, dict):
                _push_down_params(block, broadcast)
    # flatten: top level absorbs params, params key removed
    flattened = dict(section)
    flattened.pop("params", None)
    for key, value in params.items():
        flattened.setdefault(key, value)
    return flattened


def _push_down_params(node: Any, broadcast: Dict[str, Any]) -> None:
    """Recursively seed every variables/header_variables params block with the
    broadcast values (without overriding explicit per-variable params)."""
    if not isinstance(node, dict):
        return
    for var_key in ("variables", "header_variables"):
        var_list = node.get(var_key)
        if isinstance(var_list, list):
            for var in var_list:
                if isinstance(var, dict):
                    var_params = var.setdefault("params", {})
                    for k, v in broadcast.items():
                        var_params.setdefault(k, v)
    for value in node.values():
        if isinstance(value, dict):
            _push_down_params(value, broadcast)


class CoreComponent:
    """Base processing component."""

    config_class: Type[CoreConfig] = CoreConfig
    category: str = "core"

    def __init__(self, name: Optional[str] = None, config: Any = None) -> None:
        self.name = name or type(self).__name__
        if isinstance(config, dict):
            config = self.config_class.from_dict(config, self.name)
        elif config is None:
            config = self.config_class()
        elif not isinstance(config, CoreConfig):
            raise LibraryError(
                f"config must be a dict or CoreConfig, got {type(config).__name__}"
            )
        self.config = config
        # what a hosting Service sets: its metric labels (so component-side
        # error counts land in the service's processing_errors_total), its
        # health monitor, and its metric factories (the port's
        # engine/metrics.py module; the library imports no metrics client).
        # A component built without a Service counts nothing.
        self.metrics_labels: Dict[str, str] = dict(
            component_type=getattr(config, "method_type", self.category),
            component_id=self.name)
        self.health_monitor: Any = None
        self.metrics: Any = None

    def count_processing_errors(self, n: int, what: str) -> None:
        """Count and log n per-message failures the component contained
        (batched paths swallow per-message errors instead of raising)."""
        if self.metrics is not None:
            self.metrics.PROCESSING_ERRORS().labels(**self.metrics_labels).inc(n)
        logging.getLogger(type(self).__module__).error(
            "%s: %d %s dropped", self.name, n, what)

    def process(self, data: bytes) -> Optional[bytes]:
        """Process one message; ``None`` filters it (no output is sent)."""
        raise NotImplementedError

    def setup_io(self) -> None:
        """Hook for expensive IO/model loading."""

    def teardown(self) -> None:
        """Hook for releasing resources."""

    def reconfigure(self, config: Dict[str, Any]) -> None:
        """Apply a new config document to the running instance: re-parse it
        through the component's config class, swap it in, then let
        ``apply_config`` rebuild derived state (the old config comes back
        if that fails)."""
        new_config = self.config_class.from_dict(config, self.name)
        self.validate_reconfigure(new_config)
        old_config = self.config
        self.config = new_config
        try:
            self.apply_config()
        except Exception:
            self.config = old_config
            raise

    def validate_reconfigure(self, new_config: "CoreConfig") -> None:
        """Hook: veto a runtime config change (raise LibraryError)."""

    def apply_config(self) -> None:
        """Hook: react to a swapped-in config (rebuild derived state)."""
