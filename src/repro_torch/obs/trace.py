"""Span recorder for request-lifecycle tracing.

A trace is a flat list of :class:`Span` / :class:`Instant` records on
integer *tracks*. Track ``rid`` carries one request's lifecycle; track
:data:`SCHED_TRACK` (-1) carries scheduler-wide events (ticks, fault
injections before they hit a specific request). Within a track, spans
are **well-nested by construction**: :meth:`Tracer.begin` pushes onto a
per-track stack and :meth:`Tracer.end` pops it, so a child can never
outlive its parent — the property the telemetry tests assert for every
terminal request. Time comes from an injectable ``now_fn`` (the same
clock the scheduler runs on), so traces recorded under a test
``FakeClock`` are deterministic.

The record shapes are dicts-of-plain-values on purpose: JSONL export is
``json.dumps`` per record, and the Chrome ``trace_event`` conversion in
:mod:`repro_torch.obs.export` is a field remap, not a serializer.

:class:`RequestTiming` is the derived per-request stat block (queue
time, TTFT, time-between-tokens percentiles) computed from the raw
host timestamps the scheduler stamps on every request — those stamps
are always on (they're three float stores per token), so terminal
:class:`~repro_torch.serve.scheduler.StreamEvent`\\ s carry timing even with
``REPRO_OBS=0``; the full span trace is what the env knob gates.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["SCHED_TRACK", "Span", "Instant", "Tracer", "RequestTiming",
           "percentile"]

#: Track id for scheduler-wide (non-request) events.
SCHED_TRACK = -1


@dataclass
class Span:
    """A named interval on a track. ``t1 is None`` while still open."""
    track: int
    name: str
    t0: float
    t1: Optional[float] = None
    depth: int = 0
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_record(self) -> Dict[str, Any]:
        return {"kind": "span", "track": self.track, "name": self.name,
                "t0": self.t0, "t1": self.t1, "depth": self.depth,
                "args": self.args}


@dataclass
class Instant:
    """A point event on a track (``prefix_hit``, ``fault``, ...)."""
    track: int
    name: str
    t: float
    args: Dict[str, Any] = field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        return {"kind": "instant", "track": self.track, "name": self.name,
                "t": self.t, "args": self.args}


class Tracer:
    """Append-only span recorder with per-track open-span stacks.

    Spans are appended to :attr:`spans` at ``begin`` time (so a crashed
    run's trace still shows what was in flight); ``end`` fills in
    ``t1``. ``end`` with a non-matching name raises — a mis-nested
    instrumentation site is a bug we want loud, not a trace we want
    pretty.
    """

    def __init__(self, now_fn: Optional[Callable[[], float]] = None):
        self.now = now_fn or time.monotonic
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self._open: Dict[int, List[Span]] = {}

    # -- recording ----------------------------------------------------
    def begin(self, track: int, name: str, t: Optional[float] = None,
              **args: Any) -> Span:
        stack = self._open.setdefault(track, [])
        span = Span(track, name, self.now() if t is None else t,
                    depth=len(stack), args=dict(args))
        stack.append(span)
        self.spans.append(span)
        return span

    def end(self, track: int, name: str, t: Optional[float] = None,
            **args: Any) -> Span:
        stack = self._open.get(track) or []
        if not stack or stack[-1].name != name:
            got = stack[-1].name if stack else None
            raise RuntimeError(
                f"trace mis-nesting on track {track}: end({name!r}) "
                f"but innermost open span is {got!r}")
        span = stack.pop()
        span.t1 = self.now() if t is None else t
        span.args.update(args)
        return span

    def instant(self, track: int, name: str, t: Optional[float] = None,
                **args: Any) -> Instant:
        ev = Instant(track, name, self.now() if t is None else t,
                     args=dict(args))
        self.instants.append(ev)
        return ev

    def close_track(self, track: int, t: Optional[float] = None, *,
                    keep: int = 0, **args: Any) -> None:
        """Close every span still open on ``track`` past depth ``keep``,
        innermost first.

        Terminal transitions (cancel, deadline, poison, preempt-then-
        fail) can fire from *any* lifecycle phase; closing the whole
        stack keeps the trace well-formed without the call sites having
        to know which phase the request died in. ``keep=1`` closes the
        phase spans but leaves the root open — the preemption path,
        where the request's lifecycle continues after a requeue.
        """
        stack = self._open.get(track) or []
        t = self.now() if t is None else t
        while len(stack) > keep:
            span = stack.pop()
            span.t1 = t
            if args:
                span.args.update(args)

    # -- inspection ---------------------------------------------------
    def open_depth(self, track: int) -> int:
        return len(self._open.get(track) or [])

    def track_spans(self, track: int) -> List[Span]:
        return [s for s in self.spans if s.track == track]

    def records(self) -> List[Dict[str, Any]]:
        """All events, merged and time-ordered (spans by start)."""
        recs = [s.to_record() for s in self.spans]
        recs += [i.to_record() for i in self.instants]
        recs.sort(key=lambda r: (r.get("t0", r.get("t", 0.0)),
                                 r.get("depth", 0)))
        return recs


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input.

    The JAX package's convention (its ``obs.trace.percentile`` and its
    benchmark's), so TTFT p50/p99 agree on the same data.
    """
    if not xs:
        return 0.0
    ordered = sorted(xs)
    rank = math.ceil(q / 100.0 * len(ordered))
    return ordered[min(len(ordered) - 1, max(0, rank - 1))]


@dataclass(frozen=True)
class RequestTiming:
    """Derived per-request latency stats, all in milliseconds.

    * ``queue_ms`` — submit → admitted (first pages secured)
    * ``ttft_ms`` — submit → first generated token
    * ``tbt_ms_p50`` / ``tbt_ms_p99`` — time-between-tokens percentiles
      over the decode stream (0.0 for single-token requests)
    * ``total_ms`` — submit → terminal event
    """
    rid: int
    status: str
    n_tokens: int
    queue_ms: float
    ttft_ms: float
    tbt_ms_p50: float
    tbt_ms_p99: float
    total_ms: float

    @staticmethod
    def from_stamps(rid: int, status: str, *, t_submit: float,
                    t_admit: Optional[float], t_first: Optional[float],
                    tok_times: Sequence[float], t_end: float
                    ) -> "RequestTiming":
        gaps = [1e3 * (b - a) for a, b in zip(tok_times, tok_times[1:])]
        return RequestTiming(
            rid=rid, status=status, n_tokens=len(tok_times),
            queue_ms=1e3 * ((t_admit - t_submit)
                            if t_admit is not None else 0.0),
            ttft_ms=1e3 * ((t_first - t_submit)
                           if t_first is not None else 0.0),
            tbt_ms_p50=percentile(gaps, 50.0),
            tbt_ms_p99=percentile(gaps, 99.0),
            total_ms=1e3 * (t_end - t_submit))

    def to_record(self) -> Dict[str, Any]:
        return {"rid": self.rid, "status": self.status,
                "n_tokens": self.n_tokens, "queue_ms": self.queue_ms,
                "ttft_ms": self.ttft_ms, "tbt_ms_p50": self.tbt_ms_p50,
                "tbt_ms_p99": self.tbt_ms_p99, "total_ms": self.total_ms}
