"""Run one service process of the PyTorch port.

    python -m detectmateservice_tpu_torch.cli --settings S.yaml [--config C.yaml]

The port's copy of ``detectmateservice_tpu/cli.py``: root logging sends
records below ERROR to stdout and ERROR and above to stderr; ``--settings``
is required, ``--config`` names the component config when the settings do
not; the process runs until ``POST /admin/shutdown`` or Ctrl-C and exits 0.
A component that cannot start (the torch detector without a CUDA device and
without ``device: cpu`` in its config) makes it exit non-zero.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from .core import Service
from .settings import ServiceSettings


class _MaxLevelFilter(logging.Filter):
    def __init__(self, max_level: int):
        super().__init__()
        self.max_level = max_level

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno < self.max_level


def setup_logging(level: str = "INFO", log_format: str = "plain") -> None:
    """stdout for records below ERROR, stderr for ERROR and above;
    ``log_format="json"`` writes one JSON object per record."""
    root = logging.getLogger()
    root.setLevel(level.upper())
    for handler in list(root.handlers):
        root.removeHandler(handler)
    if log_format == "json":
        from .engine.health import JsonLogFormatter

        fmt: logging.Formatter = JsonLogFormatter()
    else:
        fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(name)s: %(message)s")
    out_handler = logging.StreamHandler(sys.stdout)
    out_handler.addFilter(_MaxLevelFilter(logging.ERROR))
    out_handler.setFormatter(fmt)
    err_handler = logging.StreamHandler(sys.stderr)
    err_handler.setLevel(logging.ERROR)
    err_handler.setFormatter(fmt)
    root.addHandler(out_handler)
    root.addHandler(err_handler)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="detectmate-torch",
        description="Run one DetectMate service process on the PyTorch port")
    parser.add_argument("--settings", required=True, help="service settings YAML")
    parser.add_argument("--config", default=None, help="component config YAML")
    args = parser.parse_args(argv)

    settings = ServiceSettings.from_yaml(args.settings)
    if args.config and not settings.config_file:
        settings.config_file = args.config
    setup_logging(settings.log_level, settings.log_format)

    service = Service(settings)
    try:
        with service:
            service.run()
    except KeyboardInterrupt:
        service.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
