"""Short-name → dotted-path component resolution by package walk.

The port's copy of ``detectmateservice_tpu/config/resolver.py``, resolving
under the port's component library (``detectmateservice_tpu_torch.library``):
a bare class name is found by walking every module under the library root
for the first ``CoreComponent`` subclass of that name; a dotted path passes
through with a sibling ``<ClassName>Config`` guess.
"""
from __future__ import annotations

import importlib
import inspect
import logging
import pkgutil
from typing import Optional, Tuple

# module-level seam: tests point resolution at another package
DEFAULT_ROOT = "detectmateservice_tpu_torch.library"


class ResolverError(Exception):
    """Raised when a component name cannot be resolved."""


class ComponentResolver:
    def __init__(self, root: Optional[str] = None, logger: Optional[logging.Logger] = None):
        self._root = root or DEFAULT_ROOT
        self._logger = logger or logging.getLogger(__name__)

    def resolve(self, name: str) -> Tuple[str, Optional[str]]:
        """``name`` → ``(component_path, config_class_path | None)``."""
        if "." in name:
            module_path, cls_name = name.rsplit(".", 1)
            return name, f"{module_path}.{cls_name}Config"
        module_name, cls_name = self._find_by_walk(name)
        return f"{module_name}.{cls_name}", self._find_config_class(module_name, cls_name)

    def _find_by_walk(self, short_name: str) -> Tuple[str, str]:
        from ..library.common.core import CoreComponent

        try:
            root_pkg = importlib.import_module(self._root)
        except ImportError as exc:
            raise ResolverError(
                f"component library root {self._root!r} not importable: {exc}") from exc
        candidates = [self._root]
        if hasattr(root_pkg, "__path__"):
            for info in pkgutil.walk_packages(root_pkg.__path__, prefix=self._root + "."):
                candidates.append(info.name)
        for module_name in candidates:
            try:
                module = importlib.import_module(module_name)
            except Exception:  # a broken optional module must not kill the walk
                continue
            for attr_name, attr in vars(module).items():
                if (inspect.isclass(attr) and attr.__name__ == short_name
                        and issubclass(attr, CoreComponent) and attr is not CoreComponent):
                    return module_name, attr_name
        raise ResolverError(
            f"no CoreComponent subclass named {short_name!r} under {self._root!r}: the "
            "component is not ported to detectmateservice_tpu_torch (or does not exist)")

    def _find_config_class(self, module_name: str, cls_name: str) -> Optional[str]:
        from ..library.common.core import CoreConfig

        config_name = f"{cls_name}Config"
        try:
            module = importlib.import_module(module_name)
        except ImportError:
            return None
        attr = getattr(module, config_name, None)
        if inspect.isclass(attr) and issubclass(attr, CoreConfig):
            return f"{module_name}.{config_name}"
        return f"{DEFAULT_ROOT}.common.core.CoreConfig"
