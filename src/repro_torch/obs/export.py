"""Trace export: JSONL records and Chrome ``trace_event`` JSON.

JSONL is the archival format — one :meth:`Span.to_record` /
:meth:`Instant.to_record` dict per line, plus optional ``timing`` and
``meta`` records — cheap to append, trivially greppable, and the input
to ``python -m repro_torch.obs.report``.

:func:`chrome_trace` converts a trace to the Chrome ``trace_event``
format (the "JSON Array Format" with a ``traceEvents`` envelope) that
https://ui.perfetto.dev opens directly: each track becomes a named
thread (``tid = track + 2`` so the scheduler track -1 maps to tid 1),
closed spans become ``ph="X"`` complete events, instants become
``ph="i"`` thread-scoped instants, and timestamps are microseconds
relative to the earliest event (Perfetto wants small positive µs, not
raw ``time.monotonic`` epochs). Spans still open at export time are
emitted with zero duration rather than dropped — an in-flight request
at crash time should be visible, not invisible.
"""

from __future__ import annotations

import json
from typing import Any, Dict, IO, Iterable, List, Optional, Union

from repro_torch.obs.trace import SCHED_TRACK, Tracer

__all__ = ["trace_records", "write_jsonl", "read_jsonl", "chrome_trace",
           "write_chrome"]


def trace_records(tracer: Tracer,
                  timings: Iterable[Any] = (),
                  meta: Optional[Dict[str, Any]] = None
                  ) -> List[Dict[str, Any]]:
    """Flatten a tracer (+ per-request timings, + run metadata) into
    the JSONL record list."""
    recs: List[Dict[str, Any]] = []
    if meta:
        recs.append({"kind": "meta", **meta})
    recs.extend(tracer.records())
    for tm in timings:
        recs.append({"kind": "timing", **tm.to_record()})
    return recs


def write_jsonl(path: str, records: Iterable[Dict[str, Any]]) -> int:
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _track_name(track: int) -> str:
    return "scheduler" if track == SCHED_TRACK else f"request {track}"


def chrome_trace(records: Iterable[Dict[str, Any]], *,
                 process_name: str = "repro_torch.serve") -> Dict[str, Any]:
    """Chrome ``trace_event`` document from JSONL-shaped records.

    Accepts the output of :func:`trace_records` (or :func:`read_jsonl`),
    so conversion works both live and from an archived trace file.
    """
    recs = [r for r in records if r.get("kind") in ("span", "instant")]
    t_origin = min((r.get("t0", r.get("t", 0.0)) for r in recs),
                   default=0.0)

    def us(t: float) -> float:
        return round(1e6 * (t - t_origin), 3)

    pid = 1
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": process_name}}]
    tracks = sorted({r["track"] for r in recs})
    tids = {track: i + 1 for i, track in enumerate(tracks)}
    for track in tracks:
        events.append({"ph": "M", "pid": pid, "tid": tids[track],
                       "name": "thread_name",
                       "args": {"name": _track_name(track)}})
        # sort_index keeps the scheduler on top, requests in rid order
        events.append({"ph": "M", "pid": pid, "tid": tids[track],
                       "name": "thread_sort_index",
                       "args": {"sort_index": track}})
    for r in recs:
        tid = tids[r["track"]]
        if r["kind"] == "span":
            t1 = r["t1"] if r["t1"] is not None else r["t0"]
            events.append({"ph": "X", "pid": pid, "tid": tid,
                           "name": r["name"], "ts": us(r["t0"]),
                           "dur": round(1e6 * (t1 - r["t0"]), 3),
                           "args": r.get("args") or {}})
        else:
            events.append({"ph": "i", "pid": pid, "tid": tid, "s": "t",
                           "name": r["name"], "ts": us(r["t"]),
                           "args": r.get("args") or {}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(path_or_file: Union[str, IO[str]],
                 records: Iterable[Dict[str, Any]], *,
                 process_name: str = "repro_torch.serve") -> int:
    doc = chrome_trace(records, process_name=process_name)
    if hasattr(path_or_file, "write"):
        json.dump(doc, path_or_file)
    else:
        with open(path_or_file, "w") as f:
            json.dump(doc, f)
    return len(doc["traceEvents"])
