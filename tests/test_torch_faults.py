"""The port's failure model against the JAX package's, on the CPU.

The semantics of tests/test_faults.py, held in the port
(``repro_torch.serve``), with the reduced phi3-medium-14b config, the
reference's ``model.init`` weights (PRNGKey 0) carried over with
``convert.params_from_numpy``, a takum8 KV cache, pages of 8 positions
and a fake clock:

* a preempted request resumes to the tokens of an uninterrupted solo run
  (greedy: the JAX engine's ``generate_lockstep``; sampled: the port's
  own uninterrupted run, the draws coming from torch generators);
* every request ends in exactly one state of ``TERMINAL``, with exactly
  one ``done=True`` event, under cancellation, deadlines, ``forget`` and
  seeded NaR injection;
* a NaR word poisons exactly the request that reads it: its pages are
  quarantined and evicted from the prefix tree, every other request's
  tokens equal the JAX engine's solo lockstep;
* after a drain, the pool is free pages + tree pages + quarantined pages.

The reference's tests run twice, once per attention dispatch (its Pallas
kernel and its oracle); on the CPU the port has one path, the plain
versions. Beyond the reference's tests: the same faulted schedule served
by both packages' schedulers gives the same fault records and statuses,
a reference fault record replays into the port's pool, and a bit flip
changes one bit. The watchdog is held to tests/test_ft.py's cases.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.faults import FaultInjector as JFaultInjector
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.bitops import carrier
from repro_torch.ft.watchdog import Heartbeat, Watchdog
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjector, injector_from_env
from repro_torch.serve.scheduler import TERMINAL, RequestFailed

PS = 8


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def pair():
    """(reference config, port config, reference params, port params),
    takum8 KV, float weights."""
    jcfg = dataclasses.replace(jget_arch("phi3-medium-14b").reduced,
                               kv_quant="takum8")
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              kv_quant="takum8")
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, params_from_numpy(tree, cfg, "cpu")


_SOLO = {}


def solo(pair, prompt, max_new):
    """The JAX engine's solo ``generate_lockstep`` (prompt + tokens)."""
    key = (tuple(prompt), max_new)
    if key not in _SOLO:
        jcfg, _, jp, _ = pair
        eng = JServeEngine(jp, jcfg, max_len=48, page_size=PS)
        _SOLO[key] = [int(t) for t in
                      eng.generate_lockstep([list(prompt)], max_new)[0]]
    return _SOLO[key]


def _engine(pair, **kw):
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", PS)
    return ServeEngine(pair[3], pair[1], device="cpu", **kw)


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, n))) for n in lens]


def _drain(sched_or_eng):
    return list(sched_or_eng.run())


def _assert_pool_clean(sched):
    """After a drain only the tree and the quarantine hold pages; clearing
    the tree leaves exactly the quarantined pages off the free list."""
    pool = sched.pool
    if sched.prefix is not None:
        assert pool.pages_in_use() == sched.prefix.pages_held()
        sched.prefix.clear()
    retired = sum(1 for p in pool.quarantined_pages()
                  if pool.refcount(p) == 0)
    assert pool.pages_in_use() == 0
    assert pool.pages_free() == pool.num_pages - 1 - retired
    assert not (set(pool._free) & pool.quarantined_pages())


# -- preemption under page pressure -------------------------------------------


def test_preempted_request_is_bit_identical(pair):
    """A priority-5 submit under page pressure preempts the running
    request; both finish with the JAX engine's solo lockstep tokens."""
    low, high = _prompts(pair[1].vocab, (PS, PS), seed=7)
    # each request needs 2 pages; 3 allocatable pages hold one of them
    eng = _engine(pair, num_pages=4, decode_batch=2)
    r_low = eng.submit(low, 6, priority=0)
    sched = eng.scheduler()
    stream = sched.run()
    got = []
    for ev in stream:
        got.append(ev)
        if sum(e.rid == r_low for e in got) == 2:
            break
    r_high = eng.submit(high, 6, priority=5)
    got += list(stream)
    assert sched.preemptions >= 1, "page pressure never forced preemption"
    assert eng.result(r_low) == solo(pair, low, 6), "preempted request"
    assert eng.result(r_high) == solo(pair, high, 6)
    done = [e for e in got if e.done]
    assert sorted(e.rid for e in done) == sorted([r_low, r_high])
    assert all(e.status == "ok" for e in got)
    _assert_pool_clean(sched)


def test_preempt_disabled_keeps_head_of_line_blocking(pair):
    low, high = _prompts(pair[1].vocab, (PS, PS), seed=7)
    eng = _engine(pair, num_pages=4, decode_batch=2, preempt=False)
    r_low = eng.submit(low, 6, priority=0)
    sched = eng.scheduler()
    stream = sched.run()
    seen = 0
    for ev in stream:
        seen += ev.rid == r_low
        if seen == 2:
            break
    r_high = eng.submit(high, 6, priority=5)
    _ = list(stream)
    assert sched.preemptions == 0
    assert eng.result(r_low) == solo(pair, low, 6)
    assert eng.result(r_high) == solo(pair, high, 6)


def test_preemption_resumes_sampled_draws(pair):
    """A sampled request keeps its torch.Generator through preemption: it
    draws the tokens of an uninterrupted run."""
    low, high = _prompts(pair[1].vocab, (PS, PS), seed=19)
    free = _engine(pair, num_pages=16, decode_batch=2)
    r = free.submit(low, 6, temperature=0.8, seed=123)
    _drain(free)
    want = free.result(r)
    eng = _engine(pair, num_pages=4, decode_batch=2)
    r_low = eng.submit(low, 6, temperature=0.8, seed=123)
    sched = eng.scheduler()
    stream = sched.run()
    seen = 0
    for ev in stream:
        seen += ev.rid == r_low
        if seen == 2:
            break
    eng.submit(high, 6, priority=5)
    _ = list(stream)
    assert sched.preemptions >= 1
    assert eng.result(r_low) == want, "preemption perturbed the draws"


# -- cancellation, deadlines, forget ------------------------------------------


def test_cancel_queued_and_inflight(pair):
    p1, p2, p3 = _prompts(pair[1].vocab, (PS, 11, 5), seed=5)
    eng = _engine(pair, decode_batch=2)
    r1 = eng.submit(p1, 5)
    assert eng.cancel(r1) is True
    assert eng.status(r1) == "cancelled"
    with pytest.raises(RequestFailed) as ei:
        eng.result(r1)
    assert ei.value.status == "cancelled" and ei.value.tokens == []
    r2 = eng.submit(p2, 5)
    r3 = eng.submit(p3, 5)
    sched = eng.scheduler()
    stream = sched.run()
    events = [next(stream)]            # r1's buffered terminal event
    assert events[0].matches(r1, -1, True, "cancelled")
    while not any(e.rid == r3 and e.status == "ok" for e in events):
        events.append(next(stream))
    assert eng.cancel(r3) is True
    events += list(stream)
    term3 = [e for e in events if e.rid == r3 and e.done]
    assert len(term3) == 1 and term3[0].status == "cancelled"
    assert term3[0].token == -1
    assert eng.result(r2) == solo(pair, p2, 5), "cancel moved a neighbour"
    assert eng.cancel(r2) is False
    with pytest.raises(KeyError):
        eng.cancel(10_000)
    _assert_pool_clean(sched)


def test_deadline_timeout_on_fake_clock(pair):
    p1, p2 = _prompts(pair[1].vocab, (PS, 11), seed=9)
    clk = FakeClock()
    eng = _engine(pair, decode_batch=2, now_fn=clk)
    r1 = eng.submit(p1, 8, deadline_ms=500.0)
    r2 = eng.submit(p2, 8)
    sched = eng.scheduler()
    stream = sched.run()
    events = []
    while sum(e.rid == r1 for e in events) < 3:
        events.append(next(stream))
    clk.t = 0.6                        # past r1's 0.5 s deadline
    events += list(stream)
    term1 = [e for e in events if e.rid == r1 and e.done]
    assert len(term1) == 1 and term1[0].status == "timeout"
    assert eng.status(r1) == "timeout"
    with pytest.raises(RequestFailed) as ei:
        eng.result(r1)
    gen1 = ei.value.tokens
    want1 = solo(pair, p1, 8)
    assert 0 < len(gen1) < 8
    assert gen1 == want1[len(p1):len(p1) + len(gen1)]
    assert eng.result(r2) == solo(pair, p2, 8)
    assert eng.timing(r1).status == "timeout"
    _assert_pool_clean(sched)


def test_queued_deadline_and_zero_validation(pair):
    (p1,) = _prompts(pair[1].vocab, (PS,), seed=2)
    clk = FakeClock()
    eng = _engine(pair, now_fn=clk)
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.submit(p1, 2, deadline_ms=0)
    rid = eng.submit(p1, 4, deadline_ms=100.0)
    clk.t = 1.0                        # expires while queued
    events = _drain(eng)
    (ev,) = [e for e in events if e.rid == rid]
    assert ev.matches(rid, -1, True, "timeout")
    with pytest.raises(RequestFailed) as ei:
        eng.result(rid)
    assert ei.value.tokens == []


def test_forget_inflight_routes_through_cancel(pair):
    p1, p2 = _prompts(pair[1].vocab, (PS, 9), seed=13)
    eng = _engine(pair, decode_batch=2)
    r1 = eng.submit(p1, 5)
    r2 = eng.submit(p2, 5)
    sched = eng.scheduler()
    stream = sched.run()
    events = [next(stream), next(stream)]
    eng.forget(r1)
    with pytest.raises(KeyError, match="forgotten"):
        eng.result(r1)
    events += list(stream)
    assert not any(e.rid == r1 and e.done for e in events)
    assert eng.result(r2) == solo(pair, p2, 5)
    assert sched.pending() == 0
    _assert_pool_clean(sched)


# -- fault injection and NaR quarantine --------------------------------------


def test_nar_injection_poisons_only_the_owner(pair):
    """One seeded NaR in a live page: its owner ends poisoned with its
    pages quarantined, the others give the solo lockstep tokens; the
    reference's scheduler, served the same way, injects the same fault
    and ends every request in the same state."""
    jcfg, cfg, jp, _ = pair
    prompts = _prompts(cfg.vocab, (PS, 11, 6), seed=21)
    runs = {}
    for side in ("ref", "port"):
        if side == "ref":
            eng = JServeEngine(jp, jcfg, max_len=48, page_size=PS,
                               decode_batch=2, prefix_cache=False)
            inj_cls = JFaultInjector
        else:
            eng = _engine(pair, decode_batch=2, prefix_cache=False)
            inj_cls = FaultInjector
        rids = [eng.submit(p, 6) for p in prompts]
        sched = eng.scheduler()
        sched.injector = inj_cls(sched.pool, rate=1.0, seed=0, kind="nar",
                                 target="live", max_faults=1)
        events = _drain(sched)
        runs[side] = (eng, sched, rids, events)
    eng, sched, rids, events = runs["port"]
    jsched = runs["ref"][1]
    assert sched.injector.injected == [
        type(sched.injector.injected[0])(**dataclasses.asdict(r))
        for r in jsched.injector.injected]
    assert [sched.status(r) for r in rids] == \
        [jsched.status(r) for r in runs["ref"][2]]
    assert len(sched.injector.injected) == 1
    faulted = sched.injector.faulted_pages()
    poisoned = [r for r in rids if sched.status(r) == "poisoned"]
    assert len(poisoned) == 1
    for r in rids:
        assert sum(e.rid == r and e.done for e in events) == 1
    with pytest.raises(RequestFailed, match="poisoned"):
        eng.result(poisoned[0])
    assert faulted <= sched.pool.quarantined_pages()
    assert sched.pool.stats().quarantined == len(
        sched.pool.quarantined_pages()) >= 1
    for r, p in zip(rids, prompts):
        if r not in poisoned:
            assert eng.result(r) == solo(pair, p, 6), "the fault leaked"
    _assert_pool_clean(sched)


def test_poisoned_shared_page_evicted_from_tree(pair):
    (prompt,) = _prompts(pair[1].vocab, (2 * PS,), seed=4)
    eng = _engine(pair, decode_batch=2)
    r1 = eng.submit(prompt, 4)
    sched = eng.scheduler()
    sched.injector = FaultInjector(sched.pool, rate=1.0, seed=3,
                                   kind="nar", target="live", max_faults=1)
    _drain(sched)
    assert sched.status(r1) == "poisoned"
    held = sched.prefix.pages_held()
    tree_pages = set()
    stack = list(sched.prefix._root.values())
    while stack:
        n = stack.pop()
        tree_pages.add(n.page)
        stack.extend(n.children.values())
    assert len(tree_pages) == held
    assert not (tree_pages & sched.pool.quarantined_pages())
    sched.injector = None
    r2 = eng.submit(prompt, 4)
    _drain(sched)
    assert eng.result(r2) == solo(pair, prompt, 4)
    _assert_pool_clean(sched)


def test_injector_determinism_and_env_gate(pair, monkeypatch):
    (p,) = _prompts(pair[1].vocab, (PS,), seed=1)

    def run_once():
        e = _engine(pair, decode_batch=2, prefix_cache=False)
        e.submit(p, 5)
        s = e.scheduler()
        s.injector = FaultInjector(s.pool, rate=1.0, seed=42, kind="nar",
                                   target="live", max_faults=2)
        _drain(s)
        return [(r.tick, r.slot, r.page, r.node, r.key, r.rep, r.offset)
                for r in s.injector.injected]

    assert run_once() == run_once()
    eng = _engine(pair, decode_batch=2, prefix_cache=False)
    monkeypatch.delenv("REPRO_FAULT_RATE", raising=False)
    assert injector_from_env(eng.scheduler().pool) is None
    monkeypatch.setenv("REPRO_FAULT_RATE", "0")
    assert injector_from_env(eng.scheduler().pool) is None
    monkeypatch.setenv("REPRO_FAULT_RATE", "0.5")
    monkeypatch.setenv("REPRO_FAULT_SEED", "7")
    monkeypatch.setenv("REPRO_FAULT_KIND", "flip")
    inj = injector_from_env(eng.scheduler().pool)
    assert (inj.rate, inj.seed, inj.kind) == (0.5, 7, "flip")
    with pytest.raises(ValueError, match="kind"):
        FaultInjector(eng.scheduler().pool, kind="zap")


def test_unservable_after_quarantine_fails_definitively(pair):
    (p,) = _prompts(pair[1].vocab, (PS,), seed=6)
    eng = _engine(pair, num_pages=4, decode_batch=2)
    sched = eng.scheduler()
    for page in (1, 2):                 # 3 allocatable -> 1 left
        sched.pool.quarantine(page)
    rid = eng.submit(p, 6)              # needs 2 pages: can never fit
    events = _drain(sched)
    assert sched.status(rid) == "cancelled"
    (ev,) = [e for e in events if e.rid == rid]
    assert ev.matches(rid, -1, True, "cancelled")
    assert sched.pool.release_quarantined() == 2
    rid2 = eng.submit(p, 6)
    _drain(sched)
    assert eng.result(rid2) == solo(pair, p, 6)


@pytest.mark.parametrize("kv", ["takum8", "takum16", "none"])
def test_reference_fault_records_replay_into_the_port_pool(pair, kv):
    """A JAX FaultRecord names (page, node, key, rep, offset) in the
    reference's stacked cache; replayed into the port's per-layer pool it
    lands on the same word: the same count of NaR words in each layer,
    K and V, at the same places."""
    jcfg = dataclasses.replace(pair[0], kv_quant=kv)
    cfg = dataclasses.replace(pair[1], kv_quant=kv, dtype="f32")
    from repro.serve.paged import PagePool as JPagePool
    from repro_torch.serve.paged import PagePool
    args = dict(batch=2, num_pages=6, page_size=PS, max_pages=3)
    jpool = JPagePool(jcfg, **args)
    pool = PagePool(cfg, device="cpu", **args)
    for pl in (jpool, pool):
        pl.assign(0, pl.alloc(2), pos=13)
        pl.assign(1, pl.alloc(1), pos=5)
    jinj = JFaultInjector(jpool, rate=3.0, seed=9, kind="nar")
    inj = FaultInjector(pool, rate=3.0, seed=9, kind="nar")
    jrecs = jinj.step(1)
    for rec in jrecs:
        inj.replay(rec)
    assert len(jrecs) == 3
    assert pool.scan_nar() == jpool.scan_nar() == 3
    attn = jpool.cache[0]["b0"]["attn"]
    for layer in range(cfg.n_layers):
        for key in ("k", "v"):
            want = np.isnan(np.asarray(attn[key][layer], np.float32)) \
                if kv == "none" else \
                np.asarray(attn[key][layer]) == jpool.spec.nar_word
            words = carrier(pool.cache[layer][key])
            got = (torch.isnan(words) if kv == "none" else
                   (words.to(torch.int64) & 0xFFFF) == pool.spec.nar_word)
            np.testing.assert_array_equal(got.numpy(), want)
    # the port's own injector makes the reference's draws on this pool
    assert inj.step(1) and [r.offset for r in inj.injected] == \
        [r.offset for r in jrecs]


@pytest.mark.parametrize("kv", ["takum16", "none"])
def test_flip_changes_one_bit(pair, kv):
    cfg = dataclasses.replace(pair[1], kv_quant=kv, dtype="f32")
    from repro_torch.serve.paged import PagePool
    pool = PagePool(cfg, batch=1, num_pages=3, page_size=PS, max_pages=2,
                    device="cpu")
    pool.assign(0, pool.alloc(1), pos=6)
    before = [carrier(layer[key]).clone() for layer in pool.cache
              for key in ("k", "v")]
    (rec,) = FaultInjector(pool, seed=4, kind="flip").step(1)
    after = [carrier(layer[key]) for layer in pool.cache
             for key in ("k", "v")]
    width = 16 if kv == "takum16" else 32
    flips = []
    for a, b in zip(after, before):
        d = ((a.view(torch.int16 if width == 16 else torch.int32)
              ^ b.view(torch.int16 if width == 16 else torch.int32))
             .to(torch.int64) & ((1 << width) - 1))
        flips += [bin(x).count("1") for x in d[d != 0].tolist()]
    bits = sum(flips)
    assert bits == 1 and rec.kind == "flip" and rec.page in pool._refs


# -- the scheduler's heartbeat and the watchdog ------------------------------


def test_scheduler_heartbeat_drives_watchdog(pair):
    (p,) = _prompts(pair[1].vocab, (PS,), seed=8)
    clk = FakeClock()
    eng = _engine(pair, now_fn=clk)
    eng.submit(p, 3)
    sched = eng.scheduler()
    assert sched.stalled(), "no tick yet: the loop has never beaten"
    _drain(sched)
    assert not sched.stalled()
    assert sched.watchdog.last[0].step == sched._tick
    clk.t += sched.watchdog.dead_after + 1.0
    assert sched.stalled()


def test_watchdog_dead_host_detection():
    clk = FakeClock()
    wd = Watchdog(4, dead_after=60.0, now_fn=clk)
    for h in range(4):
        wd.beat(Heartbeat(host=h, step=10, t=0.0, step_time=1.0))
    assert wd.healthy()
    clk.t = 30.0
    for h in range(3):
        wd.beat(Heartbeat(host=h, step=11, t=30.0, step_time=1.0))
    clk.t = 70.0
    assert wd.dead_hosts() == [3]
    assert not wd.healthy()


def test_watchdog_straggler_detection():
    wd = Watchdog(4, straggle_factor=2.0, now_fn=FakeClock())
    for h, st in enumerate([1.0, 1.1, 0.9, 5.0]):
        wd.beat(Heartbeat(host=h, step=5, t=0.0, step_time=st))
    assert wd.stragglers() == [3]


def test_watchdog_even_fleet_median():
    wd = Watchdog(4, straggle_factor=1.2, now_fn=FakeClock())
    for h, st in enumerate([1.0, 1.0, 2.0, 2.1]):
        wd.beat(Heartbeat(host=h, step=1, t=0.0, step_time=st))
    assert sorted(wd.stragglers()) == [2, 3]


def test_watchdog_empty_and_partial_fleet():
    wd = Watchdog(3, dead_after=10.0, now_fn=FakeClock())
    assert wd.stragglers() == [] and wd.dead_hosts() == [0, 1, 2]
    assert not wd.healthy()
    wd.beat(Heartbeat(host=1, step=1, t=0.0, step_time=1.0))
    assert wd.stragglers() == [] and wd.dead_hosts() == [0, 2]
    wd.beat(Heartbeat(host=2, step=1, t=0.0, step_time=9.0))
    assert wd.stragglers() == []
    wd.beat(Heartbeat(host=0, step=1, t=0.0, step_time=1.0))
    assert wd.stragglers() == [2] and wd.dead_hosts() == [] and wd.healthy()


# -- the chaos acceptance pin ------------------------------------------------


def test_chaos_overload_injection_acceptance(pair):
    """Overload (priorities forcing preemption), a cancel in flight, a
    deadline and seeded NaR injection: every request ends in a definite
    state with one terminal event, every completed one (and every partial
    output) equals the JAX engine's solo lockstep, and the pool is free +
    tree + quarantined at the end."""
    cfg = pair[1]
    lens = (PS, 11, 2 * PS, 6, 13, PS)
    prios = (0, 0, 1, 0, 0)
    prompts = _prompts(cfg.vocab, lens, seed=17)
    clk = FakeClock()
    eng = _engine(pair, num_pages=6, decode_batch=2, now_fn=clk)
    rids = [eng.submit(p, 5, priority=pr,
                       deadline_ms=(3000.0 if i == 4 else None))
            for i, (p, pr) in enumerate(zip(prompts[:5], prios))]
    sched = eng.scheduler()
    sched.injector = FaultInjector(sched.pool, rate=0.3, seed=11,
                                   kind="nar", target="live", max_faults=1)
    events = []
    cancelled = vip = False
    for ev in sched.run():
        events.append(ev)
        clk.t += 1.0
        if not cancelled and len(events) >= 4:
            eng.cancel(rids[1])
            cancelled = True
        if not vip and len(events) >= 6:
            rids.append(eng.submit(prompts[5], 5, priority=5))
            vip = True
    statuses = {r: sched.status(r) for r in rids}
    assert set(statuses.values()) <= set(TERMINAL)
    for r in rids:
        assert sum(e.rid == r and e.done for e in events) == 1
    assert statuses[rids[1]] == "cancelled"
    assert statuses[rids[4]] == "timeout"
    assert sched.preemptions >= 1
    assert sched.injector.injected
    completed = [r for r in rids if statuses[r] == "done"]
    assert completed
    for r, p in zip(rids, prompts):
        want = solo(pair, p, 5)
        if statuses[r] == "done":
            assert eng.result(r) == want, r
        elif statuses[r] in ("timeout", "cancelled"):
            with pytest.raises(RequestFailed) as ei:
                eng.result(r)
            assert ei.value.tokens == want[len(p):len(p) + len(ei.value.tokens)]
    _assert_pool_clean(sched)
