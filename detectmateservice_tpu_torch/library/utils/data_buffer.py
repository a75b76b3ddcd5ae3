"""Buffering modes for detectors (counterpart of
``detectmateservice_tpu/library/utils/data_buffer.py``).

``MICRO_BATCH``: the engine-side micro-batcher hands the detector lists of
messages for fixed-shape scoring.
"""
from __future__ import annotations

import enum
from collections import deque
from typing import Deque, List, Optional


class BufferMode(enum.Enum):
    NO_BUF = "no_buf"            # process each message immediately
    FIXED = "fixed"              # buffer N messages, then process the window
    MICRO_BATCH = "micro_batch"  # engine-driven batches


class DataBuffer:
    """Bounded FIFO window used by detectors in ``FIXED`` mode."""

    def __init__(self, size: int = 32):
        self._size = max(1, size)
        self._items: Deque = deque(maxlen=self._size)

    def push(self, item) -> Optional[List]:
        """Add an item; returns the full window when it fills, else None."""
        self._items.append(item)
        if len(self._items) == self._size:
            window = list(self._items)
            self._items.clear()
            return window
        return None

    def flush(self) -> List:
        window = list(self._items)
        self._items.clear()
        return window

    def __len__(self) -> int:
        return len(self._items)
