"""Chrome trace-event JSON export (Perfetto / chrome://tracing loadable); a
copy of ``repro.core.telemetry.export`` over the port's ``SpanEvent``.

One pid for the engine process, one tid per tracer track, ``M`` metadata
events naming each track, ``X`` complete events for spans and ``i``
instants for point events — the subset of the trace-event format every
viewer supports. ``tools/trace_summary.py`` reads the same file back.
Standard library only.
"""
from __future__ import annotations

import json
from typing import Iterable, Optional

from repro_torch.core.telemetry.tracer import SpanEvent

_PID = 1


def chrome_trace(events: Iterable[SpanEvent],
                 metadata: Optional[dict] = None) -> dict:
    """Convert recorded span events to a trace-event JSON object dict.

    Tracks are assigned tids in first-appearance order; every track gets
    a ``thread_name`` metadata event so viewers label it. ``metadata``
    lands under ``otherData`` (engine config summary, arch name, ...)."""
    tids: dict = {}
    out = []
    for ev in events:
        tid = tids.get(ev.track)
        if tid is None:
            tid = tids[ev.track] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                        "tid": tid, "args": {"name": ev.track}})
        rec = {"name": ev.name, "cat": ev.track, "pid": _PID, "tid": tid,
               "ts": round(ev.ts, 3)}
        if ev.dur is None:
            rec["ph"] = "i"
            rec["s"] = "t"
        else:
            rec["ph"] = "X"
            rec["dur"] = round(ev.dur, 3)
        if ev.args:
            rec["args"] = dict(ev.args)
        out.append(rec)
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if metadata:
        doc["otherData"] = dict(metadata)
    return doc


def write_chrome_trace(path: str, tracer,
                       metadata: Optional[dict] = None) -> str:
    """Serialize a tracer's ring buffer to ``path``; returns the path."""
    doc = chrome_trace(tracer.events, metadata=metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path
