"""OutputWriter: the pipeline's aggregation and sink stage.

The port's copy of ``detectmateservice_tpu/library/outputs/file_sink.py``:
it consumes ``DetectorSchema`` alerts, aggregates ``aggregate_count`` of
them into one ``OutputSchema`` record (its repeated fields concatenate,
``alertsObtain`` merges), appends each record as a JSON line to a
strftime-dated file under ``output_dir`` (``output.%Y%m%d`` by default),
and forwards the serialized record downstream.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import IO, Any, Dict, List, Optional

from ...schemas import DetectorSchema, OutputSchema, SchemaError
from ..common.core import CoreComponent, CoreConfig


@dataclasses.dataclass
class OutputWriterConfig(CoreConfig):
    method_type: str = "output_writer"
    output_dir: str = "."
    file_pattern: str = "output.%Y%m%d"
    # alerts aggregated into one OutputSchema record; 1 = one record per alert
    aggregate_count: int = 1
    # > 0: a partial group older than this flushes on the next message or flush
    aggregate_window_ms: int = 1000
    write_files: bool = True
    # also send the serialized OutputSchema to downstream sockets
    emit_records: bool = True


class OutputWriter(CoreComponent):
    config_class = OutputWriterConfig
    description = "OutputWriter aggregates alerts into dated OutputSchema records."

    def __init__(self, name: Optional[str] = None, config: Any = None) -> None:
        super().__init__(name=name or "OutputWriter", config=config)
        self.config: OutputWriterConfig
        self._pending: List[DetectorSchema] = []
        self._group_started: float = 0.0
        self._sink: Optional[IO[str]] = None
        self._sink_path: Optional[str] = None
        self.records_written = 0

    # -- engine contract -------------------------------------------------
    def process(self, data: bytes) -> Optional[bytes]:
        """DetectorSchema bytes in → OutputSchema bytes out (or ``None``
        while a group is still filling)."""
        try:
            alert = DetectorSchema.from_bytes(data)
        except SchemaError:
            return None  # a corrupt frame is filtered, never kills the loop
        if not self._pending:
            self._group_started = time.monotonic()
        self._pending.append(alert)
        if len(self._pending) >= max(1, self.config.aggregate_count):
            return self._emit_group()
        if self._window_expired():
            return self._emit_group()
        return None

    def flush(self) -> List[Optional[bytes]]:
        """Engine idle hook: emit a partial group once its window expired."""
        if self._pending and self._window_expired():
            return [self._emit_group()]
        return []

    def flush_final(self) -> List[Optional[bytes]]:
        """Stop-time drain: emit whatever is pending, then close the file."""
        out: List[Optional[bytes]] = []
        if self._pending:
            out.append(self._emit_group())
        self.teardown()
        return out

    def apply_config(self) -> None:
        """Runtime reconfigure: the next record reopens the sink under the
        (possibly new) output_dir and file_pattern."""
        self.teardown()

    def teardown(self) -> None:
        if self._sink is not None:
            try:
                self._sink.close()
            finally:
                self._sink = None
                self._sink_path = None

    # -- aggregation -----------------------------------------------------
    def _window_expired(self) -> bool:
        window = self.config.aggregate_window_ms
        return bool(window > 0 and self._pending
                    and (time.monotonic() - self._group_started) * 1000.0 >= window)

    def _emit_group(self) -> Optional[bytes]:
        alerts, self._pending = self._pending, []
        record = self._aggregate(alerts)
        if self.config.write_files:
            self._write_record(record)
        self.records_written += 1
        return record.serialize() if self.config.emit_records else None

    def _aggregate(self, alerts: List[DetectorSchema]) -> OutputSchema:
        """N DetectorSchema → one OutputSchema."""
        record = OutputSchema(outputTimestamp=int(time.time()))
        obtain: Dict[str, str] = {}
        descriptions: List[str] = []
        for alert in alerts:
            record["detectorIDs"].append(alert.detectorID)
            record["detectorTypes"].append(alert.detectorType)
            record["alertIDs"].append(alert.alertID)
            record["logIDs"].extend(alert.logIDs)
            record["extractedTimestamps"].extend(alert.extractedTimestamps)
            if alert.description:
                descriptions.append(alert.description)
            obtain.update(dict(alert.alertsObtain))
        if descriptions:
            record["description"] = "; ".join(descriptions)
        if obtain:
            record["alertsObtain"].update(obtain)
        return record

    # -- file sink -------------------------------------------------------
    def _write_record(self, record: OutputSchema) -> None:
        path = os.path.join(self.config.output_dir, time.strftime(self.config.file_pattern))
        if path != self._sink_path:  # first write, or the date rolled over
            self.teardown()
            os.makedirs(self.config.output_dir, exist_ok=True)
            self._sink = open(path, "a", encoding="utf-8")
            self._sink_path = path
        self._sink.write(json.dumps(record.to_dict(), sort_keys=True) + "\n")
        self._sink.flush()
