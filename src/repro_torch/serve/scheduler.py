"""Continuous-batching scheduler over the paged takum-wire KV pool.

Serving as a stream, as in the JAX package's scheduler:

* **submit** enqueues a request after checking it can ever fit the page
  budget (:class:`~repro_torch.serve.paged.AdmissionError` otherwise),
  with a ``priority``, per-request ``temperature``/``top_p``/``seed`` and
  an optional ``deadline_ms``;
* **admission** is by effective priority (FIFO within a band, +1 every
  ``AGING_TICKS`` ticks queued), head-of-line blocking by design;
* **prompts are never padded**: a request's tokens sit at absolute
  positions ``[0, plen)``, so its KV words are what a batch-of-1 run
  writes, whatever else is in flight (what makes prefix sharing sound);
* **prefix cache**: shared full prompt pages, refcounted, copy-on-write
  for the last page of a fully cached prompt
  (:class:`~repro_torch.serve.prefix.PrefixCache`);
* **prefill is chunked**: one ``page_size`` chunk per slot and tick on a
  private contiguous cache seeded with the shared prefix
  (``gather_prefix``), then scattered into pages (``scatter_prefill``);
* **decode packs** every active sequence into one fixed-width step over
  the paged pool; idle slots point at the scratch page. On the card the
  step is replayed from a CUDA graph (:class:`~repro_torch.serve.graphs.
  DecodeStep`, the reference's ``jax.jit(_step_paged)``), which also
  returns each row's greedy token and NaN flag in one tensor;
* **release is immediate**: the step a sequence emits EOS or reaches
  ``max_new``, its pages are unreferenced.

Greedy tokens are deterministic per request and independent of the
schedule: priorities, preemption and page pressure change when a token
comes, never its value.

**Failure model** (the reference's): every request ends in exactly one
state of :data:`TERMINAL`, with exactly one ``done=True`` event:

* **preemption**: when admission cannot secure a slot or pages, the
  running request of lowest effective priority (strictly below the
  candidate) is preempted: its pages are unreferenced, and it is requeued
  at its priority with its generated tokens as a prompt extension
  (``Request.prefill_tokens``). Its re-prefill writes the same words
  (absolute positions, post-RoPE words), so its greedy tokens equal an
  uninterrupted run's; a sampled request keeps its ``torch.Generator``,
  whose draws resume where they stopped;
* **deadlines and cancellation**: ``submit(deadline_ms=)`` and
  :meth:`Scheduler.cancel` end a request with a terminal
  ``StreamEvent(status="timeout" | "cancelled", token=-1)``, its pages
  released. Deadlines are read once a tick on the ``now_fn`` clock, which
  also feeds the watchdog a heartbeat a tick (:meth:`stalled`);
* **NaR quarantine**: a corrupted wire page (``serve/faults.py`` injects
  them) decodes to NaN; a request whose completed prefill or decode row
  has a NaN logit ends ``"poisoned"``, its pages are quarantined out of
  the free list and evicted from the prefix tree, and every other
  request goes on unchanged on its own pages.

Telemetry (``REPRO_OBS``, :mod:`repro_torch.obs`): spans per request,
instants at the transitions, gauges per tick; the timing stamps behind
:meth:`Scheduler.timing` are taken always.

Sampled tokens come from a per-request ``torch.Generator`` seeded from the
request's seed (or the engine's seed and the request id): they follow the
reference's distribution, not its threefry draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ft.watchdog import Heartbeat, Watchdog
from repro_torch.models import model
from repro_torch.models.layers import ATTN_CHUNK_T
from repro_torch.models.transformer import paged_supported
from repro_torch.obs import obs_from_env
from repro_torch.obs.trace import SCHED_TRACK, RequestTiming
from repro_torch.serve.faults import injector_from_env
from repro_torch.serve.graphs import DecodeStep
from repro_torch.serve.paged import AdmissionError, PagePool, pages_for
from repro_torch.serve.prefix import PrefixCache, PrefixPlan

__all__ = ["Scheduler", "Request", "StreamEvent", "RequestFailed",
           "sample_rows", "AGING_TICKS", "ATTN_CHUNK_T", "TERMINAL"]

AGING_TICKS = 32
# every request ends in exactly one of these; "done" is the only success
TERMINAL = ("done", "timeout", "cancelled", "poisoned")


class RequestFailed(RuntimeError):
    """``result()`` of a request that ended without completing: carries
    the terminal ``status`` and the tokens generated before it."""

    def __init__(self, rid: int, status: str, tokens: List[int]):
        super().__init__(
            f"request {rid} terminated with status {status!r} after "
            f"{len(tokens)} generated tokens")
        self.rid = rid
        self.status = status
        self.tokens = tokens


def sample_rows(logits: torch.Tensor, temps, top_ps, gens) -> List[int]:
    """One token per row: argmax where the temperature is 0, otherwise a
    draw from softmax(logits / temp) kept to the top-p nucleus (a token
    stays while the probability mass strictly before it is < top_p),
    using that row's ``torch.Generator``."""
    out = []
    for i, (temp, top_p, gen) in enumerate(zip(temps, top_ps, gens)):
        lg = logits[i].to(torch.float32)
        if temp <= 0.0:
            out.append(int(torch.argmax(lg)))
            continue
        probs = torch.softmax(lg / max(temp, 1e-6), dim=-1)
        if top_p < 1.0:
            sp, order = torch.sort(probs, descending=True)
            keep = (torch.cumsum(sp, 0) - sp) < top_p
            probs = torch.zeros_like(probs).scatter(0, order, sp * keep)
        out.append(int(torch.multinomial(probs, 1, generator=gen)))
    return out




@dataclasses.dataclass
class Request:
    """One submitted generation request and its lifecycle state."""
    rid: int
    prompt: List[int]
    max_new: int
    eos_id: int
    pages_needed: int           # worst-case pages, secured at admission
    priority: int = 0
    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = None
    deadline: Optional[float] = None   # absolute now_fn() seconds
    state: str = "queued"       # queued | prefilling | active | TERMINAL
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: Tuple[int, ...] = ()
    submit_tick: int = 0
    # host stamps on the scheduler clock, always taken (tok_times[i] is
    # when generated[i] was read on the host); REPRO_OBS gates the spans
    t_submit: float = 0.0
    t_admit: Optional[float] = None     # first pages secured
    t_first: Optional[float] = None     # first generated token
    t_end: Optional[float] = None       # terminal transition
    tok_times: List[float] = dataclasses.field(default_factory=list)
    _timing: object = None              # terminal RequestTiming
    _contig: object = None      # private contiguous prefill cache
    _cursor: int = 0            # next prefill position
    _first_page: int = 0        # first contiguous page scattered back
    _gen: Optional[torch.Generator] = None   # sampling state (temp > 0)

    @property
    def done(self) -> bool:
        """Terminated, successfully or not (see :data:`TERMINAL`)."""
        return self.state in TERMINAL

    @property
    def prefill_tokens(self) -> List[int]:
        """What prefill covers: the prompt, and after a preemption the
        tokens generated before it (re-prefilled into the same words)."""
        return list(self.prompt) + list(self.generated)

    def output(self) -> List[int]:
        return list(self.prompt) + list(self.generated)


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One streamed token; ``done`` marks the request's last event.

    ``status`` is ``"ok"`` on token events; a failed request emits one
    terminal event with ``token=-1``, ``done=True`` and ``status`` in
    ``("timeout", "cancelled", "poisoned")``. ``t`` is the event's time
    on the scheduler clock; the ``done=True`` event also carries the
    request's :class:`~repro_torch.obs.trace.RequestTiming`."""
    rid: int
    token: int
    done: bool
    status: str = "ok"
    t: float = 0.0
    timing: Optional[RequestTiming] = None

    def matches(self, rid: int, token: int, done: bool,
                status: str = "ok") -> bool:
        """Equality on the payload, the timing fields left out."""
        return (self.rid, self.token, self.done, self.status) == \
            (rid, token, done, status)


class Scheduler:
    """Continuous batching over a :class:`PagePool` for a ``ServeEngine``.

    ``now_fn`` is the clock of deadlines, the watchdog and the timing
    stamps (``time.monotonic`` unless given); ``stall_after`` the seconds
    without a tick after which :meth:`stalled` says so; ``injector`` a
    :class:`~repro_torch.serve.faults.FaultInjector`, None, or ``"env"``
    (built from ``REPRO_FAULT_*``, off by default)."""

    def __init__(self, engine, *, page_size: int, max_pages: int,
                 num_pages: int, decode_batch: int,
                 prefix_cache: bool = True, preempt: bool = True,
                 now_fn: Optional[Callable[[], float]] = None,
                 stall_after: float = 60.0, injector="env"):
        if not paged_supported(engine.cfg):
            raise ValueError(f"continuous batching needs an attention-only "
                             f"model; family {engine.cfg.family!r}")
        if page_size >= ATTN_CHUNK_T:
            # a chunk that long would take the fresh-prefill attention,
            # which assumes pos == 0
            raise ValueError(f"page_size must be < {ATTN_CHUNK_T}, "
                             f"got {page_size}")
        self.engine = engine
        self.decode_batch = decode_batch
        self.page_size = page_size
        self.pool = PagePool(engine.cfg, batch=decode_batch,
                             num_pages=num_pages, page_size=page_size,
                             max_pages=max_pages, device=engine.device)
        self.prefix: Optional[PrefixCache] = \
            PrefixCache(self.pool) if prefix_cache else None
        self.step = DecodeStep(engine, self.pool)
        self._queue: List[Request] = []
        self._requests: Dict[int, Request] = {}
        self._slots: List[Optional[Request]] = [None] * decode_batch
        self._next_rid = 0
        self._tick = 0
        self._plan: Optional[PrefixPlan] = None   # _secure -> _start handoff
        self.prompt_tokens_submitted = 0
        self._now: Callable[[], float] = now_fn or time.monotonic
        # telemetry bundle, None when REPRO_OBS is off: every hook below
        # is a None check
        self.obs = obs_from_env(self._now)
        self.watchdog = Watchdog(
            1, dead_after=stall_after, now_fn=self._now,
            on_transition=None if self.obs is None else self._obs_host)
        self._pending: List[StreamEvent] = []   # terminal failure events
        self.preempt = preempt
        self.preemptions = 0
        self.injector = (injector_from_env(self.pool)
                         if injector == "env" else injector)

    # -- queueing ----------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int,
               eos_id: Optional[int] = None, *, priority: int = 0,
               temperature: Optional[float] = None, top_p: float = 1.0,
               seed: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Enqueue a request; returns its id. Raises
        :class:`AdmissionError` when its worst-case pages exceed the
        block table or the pool. ``deadline_ms`` bounds its total latency
        from now on the scheduler clock: past it, the request (queued or
        in flight) ends ``"timeout"`` at the next tick."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        temperature = (self.engine.temperature if temperature is None
                       else float(temperature))
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        ps = self.page_size
        # the last KV write lands at plen + max_new - 2 (the final token
        # is sampled, never written)
        needed = pages_for(len(prompt) + max_new - 1, ps)
        pool = self.pool
        if needed > pool.max_pages:
            raise AdmissionError(
                f"request needs {needed} pages of {ps} ({len(prompt)} "
                f"prompt + {max_new} new tokens) but the block table holds "
                f"{pool.max_pages} pages/sequence — raise "
                "ServeEngine.max_len or the page budget")
        if needed > pool.num_pages - 1:
            raise AdmissionError(
                f"request needs {needed} pages of {ps} but the "
                f"{pool.spec.name} pool budget is {pool.num_pages - 1} "
                f"allocatable pages ({pool.hbm_bytes()} bytes)")
        # the id is taken before the deadline check, as in the reference
        rid = self._next_rid
        self._next_rid += 1
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        now = self._now()
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      eos_id=self.engine.eos_id if eos_id is None else eos_id,
                      pages_needed=needed, priority=priority,
                      temperature=temperature, top_p=top_p, seed=seed,
                      deadline=(None if deadline_ms is None
                                else now + deadline_ms / 1000.0),
                      submit_tick=self._tick, t_submit=now)
        self._requests[rid] = req
        self._queue.append(req)
        self.prompt_tokens_submitted += len(prompt)
        if self.obs is not None:
            tr = self.obs.tracer
            tr.begin(rid, "request", t=now, prompt_tokens=len(prompt),
                     max_new=max_new, priority=priority,
                     pages_needed=needed)
            tr.begin(rid, "queued", t=now)
            self.obs.metrics.counter("sched.requests_submitted").inc()
        return rid

    def _get(self, rid: int) -> Request:
        if rid not in self._requests:
            raise KeyError(f"unknown or forgotten request id {rid}")
        return self._requests[rid]

    def result(self, rid: int) -> List[int]:
        """Finished request's prompt + generated tokens. Raises
        :class:`RequestFailed` (its status and partial tokens) for a
        request that timed out, was cancelled or was poisoned."""
        req = self._get(rid)
        if not req.done:
            raise ValueError(f"request {rid} is {req.state}, not done")
        if req.state != "done":
            raise RequestFailed(rid, req.state, list(req.generated))
        return req.output()

    def status(self, rid: int) -> str:
        return self._get(rid).state

    def timing(self, rid: int) -> RequestTiming:
        """Queue/TTFT/TBT/total milliseconds on the scheduler clock: the
        terminal snapshot (the one the ``done=True`` event carried), or a
        live view of a request in flight (``total_ms`` up to now)."""
        req = self._get(rid)
        if req._timing is not None:
            return req._timing
        return RequestTiming.from_stamps(
            req.rid, req.state, t_submit=req.t_submit,
            t_admit=req.t_admit, t_first=req.t_first,
            tok_times=req.tok_times,
            t_end=req.t_end if req.t_end is not None else self._now())

    def cancel(self, rid: int) -> bool:
        """End a request in flight (pages released, slot cleared, a
        terminal ``"cancelled"`` event at the next drain of the stream).
        False when it had already ended."""
        req = self._get(rid)
        if req.done:
            return False
        self._fail(req, "cancelled")
        return True

    def forget(self, rid: int) -> None:
        """Drop a request's record; one in flight is cancelled first (no
        page or slot leaks), and its pending terminal event goes with the
        record."""
        req = self._requests.get(rid)
        if req is None:
            return
        if not req.done:
            self._fail(req, "cancelled")
        self._pending = [e for e in self._pending if e.rid != rid]
        del self._requests[rid]

    def adopt_finished(self, other: "Scheduler") -> None:
        """Carry an idle scheduler's finished records and rid counter."""
        self._requests.update(
            {r: q for r, q in other._requests.items() if q.done})
        self._next_rid = max(self._next_rid, other._next_rid)

    def pending(self) -> int:
        return sum(1 for r in self._requests.values() if not r.done)

    # -- the serving loop --------------------------------------------------

    def run(self) -> Iterator[StreamEvent]:
        """Serve until queue and batch drain, streaming every token (and
        every failed request's one terminal event)."""
        obs = self.obs
        while (self._queue or self._pending
               or any(s is not None for s in self._slots)):
            self._tick += 1
            if obs is not None:
                # wire an injector installed after construction
                inj = self.injector
                if inj is not None and getattr(inj, "observer", 1) is None:
                    inj.observer = self._obs_fault
                obs.tracer.begin(SCHED_TRACK, "tick", tick=self._tick)
            self._heartbeat()
            if self.injector is not None:
                self.injector.step(self._tick)
            self._check_deadlines()
            yield from self._drain_pending()
            self._admit()
            yield from self._prefill_tick()
            yield from self._decode_step()
            yield from self._drain_pending()
            if obs is not None:
                self._obs_sample()
                obs.tracer.end(SCHED_TRACK, "tick")

    def _drain_pending(self) -> Iterator[StreamEvent]:
        events, self._pending = self._pending, []
        yield from events

    # -- telemetry hooks (every call site checks obs for None) -------------

    def _obs_host(self, host: int, state: str) -> None:
        """A watchdog transition -> an instant on the scheduler track."""
        self.obs.tracer.instant(SCHED_TRACK, f"watchdog_{state}",
                                host=host)
        self.obs.metrics.counter(f"watchdog.{state}").inc()

    def _obs_fault(self, rec) -> None:
        """A FaultRecord -> an instant on its slot's request track (the
        scheduler track without one)."""
        req = (self._slots[rec.slot]
               if 0 <= rec.slot < len(self._slots) else None)
        track = req.rid if req is not None else SCHED_TRACK
        self.obs.tracer.instant(track, "fault", tick=rec.tick,
                                page=rec.page, kind=rec.kind,
                                key=rec.key, slot=rec.slot)
        self.obs.metrics.counter("faults.injected").inc()

    def _finish(self, req: Request) -> RequestTiming:
        """Stamp the terminal transition, once a request: freeze its
        timing, close its span track, feed the latency histograms."""
        req.t_end = self._now()
        tm = RequestTiming.from_stamps(
            req.rid, req.state, t_submit=req.t_submit,
            t_admit=req.t_admit, t_first=req.t_first,
            tok_times=req.tok_times, t_end=req.t_end)
        req._timing = tm
        if self.obs is not None:
            tr = self.obs.tracer
            tr.instant(req.rid, "terminal", t=req.t_end, status=req.state,
                       n_tokens=tm.n_tokens)
            tr.close_track(req.rid, t=req.t_end, status=req.state)
            m = self.obs.metrics
            m.counter(f"sched.terminal.{req.state}").inc()
            if tm.n_tokens:
                m.histogram("sched.ttft_ms").observe(tm.ttft_ms)
                m.histogram("sched.tbt_ms_p99").observe(tm.tbt_ms_p99)
        return tm

    def _obs_sample(self) -> None:
        """Once a tick: the pool, queue and tree state into gauges, and
        every instrument into its ring; at ``REPRO_OBS=2`` also the pool's
        NaR scan (a device read)."""
        m = self.obs.metrics
        st = self.pool.stats()
        m.gauge("pool.free").set(st.free)
        m.gauge("pool.in_use").set(st.in_use)
        m.gauge("pool.peak_in_use").set(st.peak_in_use)
        m.gauge("pool.shared_pages").set(st.shared_pages)
        m.gauge("pool.prefix_hit_tokens").set(st.prefix_hit_tokens)
        m.gauge("pool.quarantined").set(st.quarantined)
        m.gauge("sched.queue_depth").set(len(self._queue))
        m.gauge("sched.batch_active").set(
            sum(1 for s in self._slots
                if s is not None and s.state == "active"))
        m.gauge("sched.batch_prefilling").set(
            sum(1 for s in self._slots
                if s is not None and s.state == "prefilling"))
        if self.prefix is not None:
            for key, val in self.prefix.stats().items():
                m.gauge(f"prefix.{key}").set(val)
        if self.obs.numeric and self.pool.cache is not None:
            m.gauge("pool.nar_words").set(self.pool.scan_nar())
        m.sample(self._tick)

    def trace_records(self, meta: Optional[dict] = None) -> List[dict]:
        """The run's trace as JSONL-shaped records (spans, instants, and a
        ``timing`` record per terminal request still remembered). Raises
        unless ``REPRO_OBS`` turned tracing on at construction."""
        if self.obs is None:
            raise RuntimeError("tracing is off: construct the scheduler "
                               "with REPRO_OBS=1 (or 2)")
        from repro_torch.obs import export
        timings = [r._timing for r in self._requests.values()
                   if r._timing is not None]
        info = {"page_size": self.page_size,
                "num_pages": self.pool.num_pages,
                "decode_batch": self.decode_batch,
                "kv_quant": self.pool.spec.name}
        info.update(meta or {})
        return export.trace_records(self.obs.tracer, timings, meta=info)

    # -- failure paths -----------------------------------------------------

    def _fail(self, req: Request, status: str) -> None:
        """End ``req`` with a failure ``status``: off the queue or its
        slot, pages unreferenced (shared pages live on under their other
        owners), the cleared table row pushed to the device, and its
        terminal event buffered."""
        if req.state == "queued":
            self._queue.remove(req)
        for p in req.pages:
            self.pool.unref(p)
        req.pages = ()
        req._contig = None
        if req.slot >= 0:
            self.pool.clear(req.slot)
            self._slots[req.slot] = None
            req.slot = -1
            # the freed pages may be reallocated this very tick
            self.pool.push_tables()
        req.state = status
        tm = self._finish(req)
        self._pending.append(StreamEvent(req.rid, -1, True, status,
                                         t=req.t_end, timing=tm))

    def _poison(self, req: Request) -> None:
        """Fail ``req`` as poisoned and quarantine every page of its
        table, shared ones too (the NaN in its logits cannot name the
        page), before the tree eviction and the unrefs, so that those
        retire the pages instead of recycling them."""
        pages = set(req.pages)
        for p in pages:
            self.pool.quarantine(p)
        if self.prefix is not None:
            self.prefix.evict_pages(pages)
        if self.obs is not None:
            self.obs.tracer.instant(req.rid, "quarantine",
                                    pages=sorted(pages))
        self._fail(req, "poisoned")

    def _check_deadlines(self) -> None:
        now = self._now()
        for req in list(self._requests.values()):
            if (not req.done and req.deadline is not None
                    and now >= req.deadline):
                self._fail(req, "timeout")

    def _heartbeat(self) -> None:
        """One beat a tick into the watchdog: if a step wedges, the beats
        stop and :meth:`stalled` says so after ``stall_after``."""
        now = self._now()
        prev = self.watchdog.last.get(0)
        self.watchdog.beat(Heartbeat(
            host=0, step=self._tick, t=now,
            step_time=now - prev.t if prev is not None else 0.0))

    def stalled(self) -> bool:
        """Whether the loop has not ticked for ``stall_after`` seconds."""
        return not self.watchdog.healthy()

    # -- admission ---------------------------------------------------------

    def _effective_priority(self, req: Request) -> int:
        return req.priority + (self._tick - req.submit_tick) // AGING_TICKS

    def _admit(self) -> None:
        """Admit queued requests in effective-priority order while a slot
        and their worst-case pages can be secured; stop at the first that
        does not fit (head-of-line blocking), unless preempting a running
        request of strictly lower effective priority makes room."""
        while self._queue:
            req = min(self._queue,
                      key=lambda r: (-self._effective_priority(r), r.rid))
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None or not self._secure_pages(req):
                if (self.preempt and
                        self._preempt_for(self._effective_priority(req))):
                    continue
                if slot is not None and all(s is None for s in self._slots):
                    # nothing runs that could release pages, and the tree
                    # has evicted what it can: the pool, shrunk by
                    # quarantine, can never serve this request
                    self._fail(req, "cancelled")
                    continue
                return
            self._queue.remove(req)
            self._start_prefill(req, slot)

    def _preempt_for(self, min_eff: int) -> bool:
        """Preempt the running request of lowest effective priority if it
        is strictly below ``min_eff`` (the youngest on a tie). Returns
        whether one was preempted."""
        running = [s for s in self._slots if s is not None]
        if not running:
            return False
        victim = min(running, key=lambda r: (self._effective_priority(r),
                                             -r.rid))
        if self._effective_priority(victim) >= min_eff:
            return False
        self._preempt(victim)
        return True

    def _preempt(self, req: Request) -> None:
        """Back onto the queue: pages unreferenced (tree-donated ones live
        on in the tree, so re-admission mostly references them again),
        generated tokens kept as a prompt extension; aging restarts."""
        for p in req.pages:
            self.pool.unref(p)
        req.pages = ()
        req._contig = None
        req._cursor = 0
        req._first_page = 0
        if req.slot >= 0:
            self.pool.clear(req.slot)
            self._slots[req.slot] = None
            req.slot = -1
            self.pool.push_tables()
        req.state = "queued"
        req.submit_tick = self._tick
        self._queue.append(req)
        self.preemptions += 1
        if self.obs is not None:
            tr = self.obs.tracer
            now = self._now()
            # the phase spans close, the "request" root stays open
            tr.close_track(req.rid, t=now, keep=1, preempted=True)
            tr.instant(req.rid, "preempt", t=now, tick=self._tick,
                       generated=len(req.generated))
            tr.begin(req.rid, "queued", t=now, requeue=True)
            self.obs.metrics.counter("sched.preemptions").inc()

    def _secure_pages(self, req: Request) -> bool:
        """Reserve ``req``'s worst-case pages: shared prefix pages by
        reference, the private rest from the free list (evicting LRU tree
        leaves as needed). Plans over ``prefill_tokens``, so a preempted
        request finds the pages it donated."""
        pool = self.pool
        stream = req.prefill_tokens
        plan = (self.prefix.plan(stream) if self.prefix is not None
                else PrefixPlan(shared=(), cow_src=None, suffix_start=0))
        n_private = req.pages_needed - len(plan.shared)
        if self.prefix is not None:
            self.prefix.acquire(stream, plan)
            if plan.cow_src is not None:
                pool.ref(plan.cow_src)   # pinned for the gather below
            self.prefix.evict_for(n_private)
        if pool.pages_free() < n_private:
            if self.prefix is not None:
                if plan.cow_src is not None:
                    pool.unref(plan.cow_src)
                for p in plan.shared:
                    pool.unref(p)
            return False
        req.pages = plan.shared + pool.alloc(n_private)
        req._cursor = plan.suffix_start
        req._first_page = plan.suffix_start // self.page_size
        if plan.hit_tokens:
            pool.note_prefix_hits(plan.hit_tokens)
        self._plan = plan
        return True

    def _start_prefill(self, req: Request, slot: int) -> None:
        """Build the request's private contiguous cache, seeded with the
        shared prefix pages (and the copy-on-write source page)."""
        plan, self._plan = self._plan, None
        ps = self.page_size
        plen = len(req.prefill_tokens)
        # one slack page: the last chunk is right-padded to ps
        width = (pages_for(plen, ps) + 1) * ps
        contig = model.init_cache(self.engine.cfg, 1, width,
                                  device=self.engine.device)
        gather = plan.shared + ((plan.cow_src,)
                                if plan.cow_src is not None else ())
        self.pool.gather_prefix(contig, gather, pos=plan.suffix_start)
        if plan.cow_src is not None:
            self.pool.unref(plan.cow_src)
        req._contig = contig
        req.state = "prefilling"
        req.slot = slot
        self._slots[slot] = req
        now = self._now()
        if req.t_admit is None:     # a preempted request keeps its first
            req.t_admit = now
        if self.obs is not None:
            tr = self.obs.tracer
            tr.end(req.rid, "queued", t=now)
            tr.begin(req.rid, "prefill", t=now, slot=slot, plen=plen,
                     cursor=req._cursor)
            if plan.hit_tokens:
                tr.instant(req.rid, "prefix_hit", t=now,
                           tokens=plan.hit_tokens,
                           shared_pages=len(plan.shared),
                           cow=plan.cow_src is not None)

    # -- chunked prefill ---------------------------------------------------

    def _request_gen(self, req: Request) -> torch.Generator:
        if req._gen is None:
            seed = (req.seed if req.seed is not None
                    else self.engine.seed * 1_000_003 + req.rid)
            req._gen = torch.Generator(device=self.engine.device)
            req._gen.manual_seed(seed)
        return req._gen

    def _sample_row(self, logits: torch.Tensor, req: Request) -> int:
        """A sampled request's next token from its logits row [V]."""
        return sample_rows(logits[None], [req.temperature], [req.top_p],
                           [self._request_gen(req)])[0]

    def _prefill_tick(self) -> Iterator[StreamEvent]:
        """One ``page_size`` chunk for every prefilling slot; a request
        whose last chunk lands samples its next token (a NaN in those
        logits poisons it instead: a corrupted page reached its prefill),
        scatters its computed pages into the pool, donates its full pages
        to the prefix tree and joins the decode batch. Events are yielded
        after ``push_tables`` has committed the new device state."""
        eng = self.engine
        ps = self.page_size
        events = []
        activated = False
        for slot in range(self.decode_batch):
            req = self._slots[slot]
            if req is None or req.state != "prefilling":
                continue
            stream = req.prefill_tokens
            plen = len(stream)
            chunk = stream[req._cursor:req._cursor + ps]
            tokens = torch.zeros((1, ps), dtype=torch.long)
            tokens[0, :len(chunk)] = torch.as_tensor(chunk)
            if self.obs is not None:
                self.obs.tracer.begin(req.rid, "chunk",
                                      pos=req._cursor, n=len(chunk))
            row, req._contig = model.prefill_chunk(
                eng.params, tokens.to(eng.device), eng.cfg, req._contig,
                pos=req._cursor, last_idx=len(chunk) - 1)
            req._cursor += len(chunk)
            if self.obs is not None:
                self.obs.tracer.end(req.rid, "chunk")
            if req._cursor < plen:
                continue
            # the greedy token and the row's NaN flag in one read
            tok0, bad = torch.stack([torch.argmax(row[0]),
                                     torch.isnan(row[0]).any().long()]
                                    ).tolist()
            if bad:
                self._poison(req)
                continue
            if req.temperature > 0.0:
                tok0 = self._sample_row(row[0], req)
            n_prompt_pages = pages_for(plen, ps)
            self.pool.scatter_prefill(
                req._contig, req.pages[req._first_page:n_prompt_pages],
                first_page=req._first_page)
            req._contig = None
            if self.prefix is not None:
                self.prefix.insert(stream, req.pages[:plen // ps])
            req.state = "active"
            req.generated.append(tok0)
            now = self._now()
            req.t_first = now
            req.tok_times.append(now)
            self.pool.assign(slot, req.pages, pos=plen)
            activated = True
            if self.obs is not None:
                tr = self.obs.tracer
                tr.end(req.rid, "prefill", t=now)
                tr.instant(req.rid, "first_token", t=now, token=tok0)
                tr.begin(req.rid, "decode", t=now)
                self.obs.metrics.counter("sched.tokens").inc()
            done = tok0 == req.eos_id or len(req.generated) >= req.max_new
            tm = None
            if done:
                self._release(req)
                tm = self._finish(req)
            events.append(StreamEvent(req.rid, tok0, done, t=now,
                                      timing=tm))
        if activated:
            self.pool.push_tables()
        yield from events

    # -- packed decode -----------------------------------------------------

    def _decode_step(self) -> Iterator[StreamEvent]:
        """One step for every active slot; a row with a NaN logit poisons
        its request, finished sequences release their pages the same
        step."""
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.state == "active"]
        if not active:
            return
        if self.obs is not None:
            self.obs.tracer.begin(SCHED_TRACK, "decode_step",
                                  batch=len(active))
        tok = torch.zeros((self.decode_batch, 1), dtype=torch.long)
        for i in active:
            tok[i, 0] = self._slots[i].generated[-1]
        pos = torch.from_numpy(self.pool.pos[:, None].astype(np.int64))
        logits, head = self.step(tok, pos)
        self.pool.advance(active)
        # greedy tokens and NaN flags of every row: one copy, the step's
        # one wait (idle and prefilling slots read the scratch page and
        # may be NaN: only active rows are looked at)
        greedy, bad = head.tolist()
        now = self._now()
        if self.obs is not None:
            self.obs.tracer.end(SCHED_TRACK, "decode_step", t=now)
        events = []
        released = False
        for i in active:
            req = self._slots[i]
            if bad[i]:
                self._poison(req)
                continue
            tk = (self._sample_row(logits[i], req) if req.temperature > 0.0
                  else greedy[i])
            req.generated.append(tk)
            if req.t_first is None:
                req.t_first = now
            req.tok_times.append(now)
            if self.obs is not None:
                self.obs.tracer.instant(req.rid, "token", t=now, token=tk)
                self.obs.metrics.counter("sched.tokens").inc()
            done = tk == req.eos_id or len(req.generated) >= req.max_new
            tm = None
            if done:
                self._release(req)
                released = True
                tm = self._finish(req)
            events.append(StreamEvent(req.rid, tk, done, t=now, timing=tm))
        if released:
            self.pool.push_tables()
        yield from events

    def _release(self, req: Request) -> None:
        """Unreference the request's pages and free its slot."""
        for p in req.pages:
            self.pool.unref(p)
        if req.slot >= 0:
            self.pool.clear(req.slot)
            self._slots[req.slot] = None
        req.state = "done"
