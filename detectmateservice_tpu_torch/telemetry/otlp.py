"""OTLP/JSON encoding of assembled traces, and its HTTP push.

The port's copy of ``detectmateservice_tpu/telemetry/otlp.py``: assembled
pipeline traces → one ``ExportTraceServiceRequest`` JSON document (the
OTLP/HTTP ``v1/traces`` shape), POSTed with urllib, with no OpenTelemetry
SDK. The pipeline's 64-bit trace id is left-padded to OTLP's 128 bits; each
hop is one span whose ``spanId`` is a blake2b of (trace id, stage), stable
across exports, parented on the previous hop in receive order; verdict,
flags and tenant bucket ride as attributes, and an ``error`` or
``quarantined`` verdict sets status ERROR.
"""
from __future__ import annotations

import hashlib
import json
import urllib.request
from typing import Any, Dict, List, Optional

_SPAN_KIND_INTERNAL = 1
_STATUS_OK = 1
_STATUS_ERROR = 2
_ERROR_VERDICTS = ("error", "quarantined")


def span_id(trace_id: str, stage: str) -> str:
    """The stable 16-hex OTLP span id of one (trace, stage) hop."""
    return hashlib.blake2b(f"{trace_id}/{stage}".encode("utf-8"), digest_size=8).hexdigest()


def _attr(key: str, value: Any) -> Dict[str, Any]:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def encode_traces(traces: List[Dict[str, Any]],
                  resource: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Assembled trace dicts (the collector's shape) → an OTLP/JSON
    ``ExportTraceServiceRequest``."""
    resource_attrs = [_attr("service.name", "detectmate")]
    for key, value in sorted((resource or {}).items()):
        resource_attrs.append(_attr(f"detectmate.{key}", value))
    spans: List[Dict[str, Any]] = []
    for trace in traces:
        otlp_trace_id = trace["trace_id"].rjust(32, "0")
        verdict = trace.get("verdict") or "healthy"
        is_error = (verdict in _ERROR_VERDICTS
                    or any(f in _ERROR_VERDICTS for f in trace.get("flags", ())))
        parent = ""
        for hop in trace["hops"]:
            attrs = [_attr("detectmate.stage", hop["stage"]),
                     _attr("detectmate.verdict", verdict)]
            if hop.get("replica"):
                attrs.append(_attr("detectmate.replica", hop["replica"]))
            if trace.get("tenant_bucket") is not None:
                attrs.append(_attr("detectmate.tenant_bucket", trace["tenant_bucket"]))
            for flag in trace.get("flags", ()):
                attrs.append(_attr(f"detectmate.flag.{flag}", True))
            if not trace.get("complete", True):
                attrs.append(_attr("detectmate.incomplete", True))
            sid = span_id(trace["trace_id"], hop["stage"])
            spans.append({
                "traceId": otlp_trace_id,
                "spanId": sid,
                "parentSpanId": parent,
                "name": hop["stage"],
                "kind": _SPAN_KIND_INTERNAL,
                "startTimeUnixNano": str(hop["recv_ns"]),
                "endTimeUnixNano": str(max(hop["recv_ns"], hop["send_ns"])),
                "attributes": attrs,
                "status": {"code": _STATUS_ERROR if is_error else _STATUS_OK},
            })
            parent = sid
    return {"resourceSpans": [{
        "resource": {"attributes": resource_attrs},
        "scopeSpans": [{"scope": {"name": "detectmate.telemetry", "version": "1"},
                        "spans": spans}],
    }]}


def push(url: str, doc: Dict[str, Any], timeout: float = 5.0) -> int:
    """POST the document to an OTLP/HTTP traces endpoint; the HTTP status,
    raising on a transport or HTTP failure (the caller counts it)."""
    body = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status
