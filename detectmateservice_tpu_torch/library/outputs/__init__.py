"""Output and aggregation components."""
from .file_sink import OutputWriter, OutputWriterConfig

__all__ = ["OutputWriter", "OutputWriterConfig"]
