"""Cross-stage Perfetto (Chrome trace-event) export of assembled traces.

The port's copy of ``detectmateservice_tpu/telemetry/perfetto.py``: the
document shape of ``FlightRecorder.chrome_events`` (one pid per trace, "X"
slices per hop, "transit" slices for the wire and queue gaps), built from
the collector's assembled traces, so the slices span every stage of the
pipeline. ``GET /admin/trace?format=chrome`` serves it on the stage that
hosts the collector.
"""
from __future__ import annotations

from typing import Any, Dict, List


def trace_events(traces: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Assembled trace dicts (hops sorted by receive time) → a Chrome
    trace-event document; verdict and flags ride in the slice args."""
    seen = set()
    events: List[Dict[str, Any]] = []
    for trace in traces:
        if trace["trace_id"] in seen:
            continue
        seen.add(trace["trace_id"])
        pid = int(trace["trace_id"], 16) % (1 << 31)
        name = f"trace {trace['trace_id']}"
        verdict = trace.get("verdict")
        if verdict:
            name += f" [{verdict}]"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": name}})
        prev_send = trace.get("ingest_ns")
        for hop in trace["hops"]:
            if prev_send is not None and hop["recv_ns"] > prev_send:
                events.append({"name": "transit", "cat": "pipeline", "ph": "X",
                               "pid": pid, "tid": 0, "ts": prev_send / 1000.0,
                               "dur": (hop["recv_ns"] - prev_send) / 1000.0})
            args: Dict[str, Any] = {"trace_id": trace["trace_id"]}
            if verdict:
                args["verdict"] = verdict
            if trace.get("flags"):
                args["flags"] = list(trace["flags"])
            if hop.get("replica"):
                args["replica"] = hop["replica"]
            events.append({"name": hop["stage"], "cat": "pipeline", "ph": "X",
                           "pid": pid, "tid": 0, "ts": hop["recv_ns"] / 1000.0,
                           "dur": max(0, hop["send_ns"] - hop["recv_ns"]) / 1000.0,
                           "args": args})
            prev_send = hop["send_ns"]
    return {"traceEvents": events, "displayTimeUnit": "ms"}
