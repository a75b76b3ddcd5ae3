"""Dynamic component and config-class loading.

The port's copy of ``detectmateservice_tpu/config/loader.py``: the module
path is imported as given, then under the port's library root; the class is
instantiated as ``cls(config=config)`` (no arguments when the config is
empty) and must be a ``CoreComponent`` of the port; a config class must
subclass the port's ``CoreConfig``. ImportError for a missing module,
AttributeError for a missing class, RuntimeError for a contract violation.

A path into the JAX package, or one that only the JAX package's library
holds (``detectors.new_value_detector.NewValueDetector``), raises ImportError
saying that the component is not ported: the port never imports the JAX
package.
"""
from __future__ import annotations

import importlib
import inspect
import logging
from typing import Any, Optional, Type

from . import resolver as _resolver_mod

_JAX_PACKAGE = "detectmateservice_tpu"


def _import_with_fallback(path: str, root: str) -> tuple:
    """``(module, class_name)``: ``path`` as given, then under ``root``."""
    module_path, cls_name = path.rsplit(".", 1)
    if module_path == _JAX_PACKAGE or module_path.startswith(_JAX_PACKAGE + "."):
        raise ImportError(
            f"component path {path!r} names the JAX package; the PyTorch port loads "
            f"components from {root} only")
    last_exc: Optional[ImportError] = None
    for candidate in (module_path, f"{root}.{module_path}"):
        try:
            return importlib.import_module(candidate), cls_name
        except ImportError as exc:
            last_exc = exc
    raise ImportError(
        f"cannot import module for component path {path!r}: {last_exc}; the component "
        f"is not ported to detectmateservice_tpu_torch (its library is {root})")


class ComponentLoader:
    def __init__(self, root: Optional[str] = None, logger: Optional[logging.Logger] = None):
        self._root = root or _resolver_mod.DEFAULT_ROOT
        self._logger = logger or logging.getLogger(__name__)

    def load_component(self, path: str, config: Any = None) -> Any:
        """Import, instantiate and contract-check a component."""
        from ..library.common.core import CoreComponent

        if "." not in path:
            raise ImportError(f"component path {path!r} must be dotted (module.ClassName); "
                              "use ComponentResolver for short names")
        module, cls_name = _import_with_fallback(path, self._root)
        cls = getattr(module, cls_name, None)
        if cls is None:
            raise AttributeError(f"module {module.__name__!r} has no class {cls_name!r}")
        try:
            instance = cls(config=config) if config else cls()
        except TypeError as exc:
            raise RuntimeError(f"cannot instantiate component {path!r}: {exc}") from exc
        if not isinstance(instance, CoreComponent):
            raise RuntimeError(
                f"{path!r} resolved to {type(instance).__name__}, which is not a CoreComponent")
        self._logger.info("loaded component %s", path)
        return instance


class ConfigClassLoader:
    def __init__(self, root: Optional[str] = None, logger: Optional[logging.Logger] = None):
        self._root = root or _resolver_mod.DEFAULT_ROOT
        self._logger = logger or logging.getLogger(__name__)

    def load_config_class(self, path: str) -> Type:
        """Import and contract-check a config class (a CoreConfig subclass)."""
        from ..library.common.core import CoreConfig

        if "." not in path:
            raise ImportError(f"config class path {path!r} must be dotted (module.ClassName)")
        module, cls_name = _import_with_fallback(path, self._root)
        cls = getattr(module, cls_name, None)
        if cls is None:
            raise AttributeError(f"module {module.__name__!r} has no class {cls_name!r}")
        if not (inspect.isclass(cls) and issubclass(cls, CoreConfig)):
            raise RuntimeError(f"{path!r} is not a CoreConfig subclass")
        return cls
