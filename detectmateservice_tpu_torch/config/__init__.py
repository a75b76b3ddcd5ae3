"""Component resolution, loading and config-file management."""
from .loader import ComponentLoader, ConfigClassLoader
from .manager import ConfigError, ConfigManager
from .resolver import ComponentResolver, ResolverError

__all__ = ["ComponentLoader", "ConfigClassLoader", "ConfigError", "ConfigManager",
           "ComponentResolver", "ResolverError"]
