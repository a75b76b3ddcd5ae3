"""File reader: raw text lines → LogSchema messages.

The port's copy of ``detectmateservice_tpu/library/readers/log_file.py``:

* as a pipeline component, ``process`` wraps incoming raw text into
  LogSchema bytes (its first non-empty line), the ingress adapter a tailer
  plays in front of the parser;
* ``read()`` iterates a configured file and yields a LogSchema per
  non-empty line.
"""
from __future__ import annotations

import dataclasses
import socket
import uuid
from pathlib import Path
from typing import Any, Iterator, Optional

from ...schemas import LogSchema
from ..common.core import CoreComponent, CoreConfig, LibraryError


@dataclasses.dataclass
class LogFileConfig(CoreConfig):
    method_type: str = "log_file"
    path: Optional[str] = None
    log_source: Optional[str] = None


class LogFileReader(CoreComponent):
    config_class = LogFileConfig
    category = "readers"

    def __init__(self, name: Optional[str] = None, config: Any = None) -> None:
        super().__init__(name=name, config=config)
        self.config: LogFileConfig
        self._hostname = socket.gethostname()

    def make_log(self, line: str) -> LogSchema:
        return LogSchema(
            logID=str(uuid.uuid4()),
            log=line,
            logSource=self.config.log_source or self.config.path or self.name,
            hostname=self._hostname,
        )

    def process(self, data: bytes) -> Optional[bytes]:
        """Wrap raw text into a LogSchema (its first non-empty line)."""
        text = data.decode("utf-8", errors="replace")
        for line in text.splitlines():
            if line.strip():
                return self.make_log(line).serialize()
        return None

    def read(self, path: Optional[str] = None) -> Iterator[LogSchema]:
        """Yield a LogSchema per non-empty line of the file."""
        target = path or self.config.path
        if not target:
            raise LibraryError(f"{self.name}: no file path configured")
        try:
            with open(Path(target), "r", encoding="utf-8", errors="replace") as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if line.strip():
                        yield self.make_log(line)
        except OSError as exc:
            raise LibraryError(f"{self.name}: cannot read {target}: {exc}") from exc
