"""Component-config lifecycle: load, save and update, lock-guarded.

The port's copy of ``detectmateservice_tpu/config/manager.py``. The on-disk
config is namespaced *category → ClassName → params*; ``load()`` writes the
config class's defaults when the file is missing. Where the JAX manager checks
the category namespacing with a pydantic model, this one checks it by hand
and then validates the document through the component's dataclass config
(``CoreConfig.from_dict``), so a document the component would refuse never
reaches the running instance or the file.
"""
from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Type

import yaml

from ..library.common.core import CATEGORIES, CoreConfig, LibraryError


class ConfigError(Exception):
    """Raised on config load/validate/save failures."""


class ConfigManager:
    """Owns the component config file and its in-memory copy."""

    def __init__(self, config_file: str, config_schema: Optional[Type[CoreConfig]] = None,
                 logger: Optional[logging.Logger] = None) -> None:
        self._path = Path(config_file)
        self._schema = config_schema
        self._logger = logger or logging.getLogger(__name__)
        self._lock = threading.RLock()
        self._config: Dict[str, Any] = {}

    def load(self) -> Dict[str, Any]:
        """Read and validate the file; create it with defaults if missing."""
        with self._lock:
            if not self._path.exists():
                self._logger.info("config file %s missing; writing defaults", self._path)
                self._config = self._default_config()
                self._write(self._config)
                return dict(self._config)
            try:
                with open(self._path, "r", encoding="utf-8") as fh:
                    data = yaml.safe_load(fh) or {}
            except (OSError, yaml.YAMLError) as exc:
                raise ConfigError(f"cannot read config file {self._path}: {exc}") from exc
            self._config = self._validate(data)
            return dict(self._config)

    def get(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._config)

    def update(self, data: Dict[str, Any]) -> Dict[str, Any]:
        """Replace the in-memory config after validation."""
        with self._lock:
            self._config = self._validate(data)
            return dict(self._config)

    def validate(self, data: Dict[str, Any]) -> Dict[str, Any]:
        """Validate without changing state."""
        with self._lock:
            return dict(self._validate(data))

    def save(self, data: Optional[Dict[str, Any]] = None) -> None:
        """Write the config to disk."""
        with self._lock:
            payload = self._config if data is None else self._validate(data)
            self._write(payload)
            self._config = dict(payload)

    def _validate(self, data: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(data, dict):
            raise ConfigError(f"component config must be a mapping, got {type(data).__name__}")
        for category in CATEGORIES:
            block = data.get(category)
            if block is not None and not isinstance(block, dict):
                raise ConfigError(f"invalid component config: {category!r} must be a mapping")
        if self._schema is not None:
            try:
                self._schema.from_dict(data)
            except LibraryError as exc:
                raise ConfigError(f"invalid component config: {exc}") from exc
        return dict(data)

    def _default_config(self) -> Dict[str, Any]:
        if self._schema is None:
            return {}
        try:
            return self._schema().to_dict()
        except Exception:  # noqa: BLE001 — a config class without defaults writes {}
            self._logger.warning("could not build defaults from %s", self._schema)
            return {}

    def _write(self, data: Dict[str, Any]) -> None:
        try:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            with open(self._path, "w", encoding="utf-8") as fh:
                yaml.safe_dump(data, fh, sort_keys=False)
        except OSError as exc:
            raise ConfigError(f"cannot write config file {self._path}: {exc}") from exc
