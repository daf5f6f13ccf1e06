"""Continuous-batching scheduler over the paged takum-wire KV pool.

Serving as a stream, as in the JAX package's scheduler:

* **submit** enqueues a request after checking it can ever fit the page
  budget (:class:`~repro_torch.serve.paged.AdmissionError` otherwise),
  with a ``priority`` and per-request ``temperature``/``top_p``/``seed``;
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
  DecodeStep`, the reference's ``jax.jit(_step_paged)``);
* **release is immediate**: the step a sequence emits EOS or reaches
  ``max_new``, its pages are unreferenced.

Greedy tokens are deterministic per request and independent of the
schedule. Preemption, deadlines, cancellation, NaR quarantine, fault
injection, tracing and the watchdog are not in this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import model
from repro_torch.serve.graphs import DecodeStep
from repro_torch.serve.paged import AdmissionError, PagePool, pages_for
from repro_torch.serve.prefix import PrefixCache, PrefixPlan

__all__ = ["Scheduler", "Request", "StreamEvent", "sample_rows",
           "AGING_TICKS", "ATTN_CHUNK_T"]

AGING_TICKS = 32
# the reference serves prefill chunks of this length or longer through a
# fresh-prefill path that assumes pos == 0; page sizes stay below it
ATTN_CHUNK_T = 2048


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
    state: str = "queued"       # queued | prefilling | active | done
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: Tuple[int, ...] = ()
    submit_tick: int = 0
    _contig: object = None      # private contiguous prefill cache
    _cursor: int = 0            # next prompt position to prefill
    _first_page: int = 0        # first contiguous page scattered back
    _gen: Optional[torch.Generator] = None   # sampling state (temp > 0)

    @property
    def done(self) -> bool:
        return self.state == "done"

    def output(self) -> List[int]:
        return list(self.prompt) + list(self.generated)


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One streamed token; ``done`` marks the request's last event."""
    rid: int
    token: int
    done: bool


class Scheduler:
    """Continuous batching over a :class:`PagePool` for a ``ServeEngine``."""

    def __init__(self, engine, *, page_size: int, max_pages: int,
                 num_pages: int, decode_batch: int,
                 prefix_cache: bool = True):
        if engine.cfg.family != "dense":
            raise ValueError(f"continuous batching needs an attention-only "
                             f"model; family {engine.cfg.family!r}")
        if page_size >= ATTN_CHUNK_T:
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

    # -- queueing ----------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int,
               eos_id: Optional[int] = None, *, priority: int = 0,
               temperature: Optional[float] = None, top_p: float = 1.0,
               seed: Optional[int] = None) -> int:
        """Enqueue a request; returns its id. Raises
        :class:`AdmissionError` when its worst-case pages exceed the
        block table or the pool."""
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
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      eos_id=self.engine.eos_id if eos_id is None else eos_id,
                      pages_needed=needed, priority=priority,
                      temperature=temperature, top_p=top_p, seed=seed,
                      submit_tick=self._tick)
        self._requests[rid] = req
        self._queue.append(req)
        return rid

    def result(self, rid: int) -> List[int]:
        """Finished request's prompt + generated tokens."""
        if rid not in self._requests:
            raise KeyError(f"unknown or forgotten request id {rid}")
        req = self._requests[rid]
        if not req.done:
            raise ValueError(f"request {rid} is {req.state}, not done")
        return req.output()

    def status(self, rid: int) -> str:
        if rid not in self._requests:
            raise KeyError(f"unknown or forgotten request id {rid}")
        return self._requests[rid].state

    def forget(self, rid: int) -> None:
        """Drop a finished request's record."""
        req = self._requests.get(rid)
        if req is None:
            return
        if not req.done:
            raise NotImplementedError("forgetting an in-flight request "
                                      "needs cancellation (not ported yet)")
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
        """Serve until queue and batch drain, streaming every token."""
        while self._queue or any(s is not None for s in self._slots):
            self._tick += 1
            self._admit()
            yield from self._prefill_tick()
            yield from self._decode_step()

    # -- admission ---------------------------------------------------------

    def _effective_priority(self, req: Request) -> int:
        return req.priority + (self._tick - req.submit_tick) // AGING_TICKS

    def _admit(self) -> None:
        """Admit queued requests in effective-priority order while a slot
        and their worst-case pages can be secured; stop at the first that
        does not fit (head-of-line blocking)."""
        while self._queue:
            req = min(self._queue,
                      key=lambda r: (-self._effective_priority(r), r.rid))
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None or not self._secure_pages(req):
                return
            self._queue.remove(req)
            self._start_prefill(req, slot)

    def _secure_pages(self, req: Request) -> bool:
        """Reserve ``req``'s worst-case pages: shared prefix pages by
        reference, the private rest from the free list (evicting LRU
        tree leaves as needed)."""
        pool = self.pool
        stream = req.prompt
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
        # one slack page: the last chunk is right-padded to ps
        width = (pages_for(len(req.prompt), ps) + 1) * ps
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

    # -- chunked prefill ---------------------------------------------------

    def _request_gen(self, req: Request) -> torch.Generator:
        if req._gen is None:
            seed = (req.seed if req.seed is not None
                    else self.engine.seed * 1_000_003 + req.rid)
            req._gen = torch.Generator(device=self.engine.device)
            req._gen.manual_seed(seed)
        return req._gen

    def _sample(self, logits: torch.Tensor, reqs: List[Request]) -> List[int]:
        """One token per row of ``logits`` for the requests ``reqs``."""
        if all(r.temperature == 0.0 for r in reqs):
            return torch.argmax(logits, dim=-1).tolist()
        return sample_rows(logits, [r.temperature for r in reqs],
                           [r.top_p for r in reqs],
                           [self._request_gen(r) if r.temperature > 0.0
                            else None for r in reqs])

    def _prefill_tick(self) -> Iterator[StreamEvent]:
        """One ``page_size`` chunk for every prefilling slot; a request
        whose last chunk lands samples its first token, scatters its
        computed pages into the pool, donates its full prompt pages to
        the prefix tree and joins the decode batch."""
        eng = self.engine
        ps = self.page_size
        events = []
        activated = False
        for slot in range(self.decode_batch):
            req = self._slots[slot]
            if req is None or req.state != "prefilling":
                continue
            plen = len(req.prompt)
            chunk = req.prompt[req._cursor:req._cursor + ps]
            tokens = torch.zeros((1, ps), dtype=torch.long)
            tokens[0, :len(chunk)] = torch.as_tensor(chunk)
            row, req._contig = model.prefill_chunk(
                eng.params, tokens.to(eng.device), eng.cfg, req._contig,
                pos=req._cursor, last_idx=len(chunk) - 1)
            req._cursor += len(chunk)
            if req._cursor < plen:
                continue
            tok0 = self._sample(row, [req])[0]
            n_prompt_pages = pages_for(plen, ps)
            self.pool.scatter_prefill(
                req._contig, req.pages[req._first_page:n_prompt_pages],
                first_page=req._first_page)
            req._contig = None
            if self.prefix is not None:
                self.prefix.insert(req.prompt, req.pages[:plen // ps])
            req.state = "active"
            req.generated.append(tok0)
            self.pool.assign(slot, req.pages, pos=plen)
            activated = True
            done = tok0 == req.eos_id or len(req.generated) >= req.max_new
            if done:
                self._release(req)
            events.append(StreamEvent(req.rid, tok0, done))
        if activated:
            self.pool.push_tables()
        yield from events

    # -- packed decode -----------------------------------------------------

    def _decode_step(self) -> Iterator[StreamEvent]:
        """One step for every active slot; finished sequences release
        their pages the same step."""
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.state == "active"]
        if not active:
            return
        tok = torch.zeros((self.decode_batch, 1), dtype=torch.long)
        for i in active:
            tok[i, 0] = self._slots[i].generated[-1]
        pos = torch.from_numpy(self.pool.pos[:, None].astype(np.int64))
        logits = self.step(tok, pos)
        self.pool.advance(active)
        toks = self._sample(logits[active], [self._slots[i] for i in active])
        events = []
        released = False
        for i, tk in zip(active, toks):
            req = self._slots[i]
            req.generated.append(tk)
            done = tk == req.eos_id or len(req.generated) >= req.max_new
            if done:
                self._release(req)
                released = True
            events.append(StreamEvent(req.rid, tk, done))
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
