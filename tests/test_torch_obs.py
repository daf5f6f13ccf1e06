"""The port's serving telemetry (``repro_torch.obs``) against the JAX
package's, on the CPU.

The semantics of tests/test_obs.py, held in the port: tracer nesting,
metrics, exports, the re-capture detector, scheduler integration and the
token-neutrality pin (the same workload under ``REPRO_OBS=2`` and unset
gives the same stream), on the reduced phi3-medium-14b config with the
reference's ``model.init`` weights (PRNGKey 0) carried over by
``convert.params_from_numpy``, a takum8 KV cache and a fake clock. Where
the reference's object can be built without a model (a tracer, a
registry, the export), the port's output is held equal to it.

Two tests of tests/test_obs.py have no counterpart: the tensor-parallel
residual norms (the port has no tensor parallelism yet) and the
environment-knob audit (``launch/env.py``, not ported). The reference's
compile watcher hooks ``jax.monitoring``; the port's counts the decode
step's CUDA-graph captures, which on the CPU never happen, so its test
drives ``record_capture`` directly (tests/test_torch_gpu.py drives a real
capture).
"""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import model as jmodel
from repro.obs import export as jexport
from repro.obs.trace import Tracer as JTracer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.ft.watchdog import Heartbeat, Watchdog
from repro_torch.obs import ServeObs, export, level, obs_from_env, report
from repro_torch.obs.metrics import (GLOBAL, CompileWatcher, MetricsRegistry,
                                     record_capture)
from repro_torch.obs.trace import (SCHED_TRACK, RequestTiming, Tracer,
                                   percentile)
from repro_torch.serve.engine import ServeEngine, quantize_weights
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.scheduler import TERMINAL

PS = 8


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


@pytest.fixture(scope="module")
def pair():
    """(port config with a takum8 KV cache, port params)."""
    jp = jmodel.init(jax.random.PRNGKey(0),
                     jget_arch("phi3-medium-14b").reduced)
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              kv_quant="takum8")
    return cfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, "cpu")


def _engine(pair, **kw):
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", PS)
    kw.setdefault("decode_batch", 2)
    kw.setdefault("now_fn", FakeClock())
    return ServeEngine(pair[1], pair[0], device="cpu", **kw)


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, n))) for n in lens]


# -- the tracer ---------------------------------------------------------------


def _nested(tr):
    tr.begin(7, "request")
    tr.begin(7, "queued")
    tr.end(7, "queued")
    tr.begin(7, "prefill")
    tr.begin(7, "chunk")
    depth = tr.open_depth(7)
    tr.close_track(7, keep=1, preempted=True)
    kept = tr.open_depth(7)
    tr.begin(7, "queued", requeue=True)
    tr.close_track(7)
    return depth, kept


def test_tracer_nesting_and_close_track():
    tr = Tracer(FakeClock())
    depth, kept = _nested(tr)
    assert (depth, kept) == (3, 1)
    assert tr.open_depth(7) == 0
    spans = tr.track_spans(7)
    assert all(s.t1 is not None for s in spans)
    assert spans[3].args["preempted"] is True
    assert [s.depth for s in spans] == [0, 1, 1, 2, 1]
    # the reference's tracer records the same trace
    jtr = JTracer(FakeClock())
    assert _nested(jtr) == (depth, kept)
    assert tr.records() == jtr.records()


def test_tracer_misnesting_raises():
    tr = Tracer(FakeClock())
    tr.begin(0, "a")
    tr.begin(0, "b")
    with pytest.raises(RuntimeError, match="mis-nesting"):
        tr.end(0, "a")
    with pytest.raises(RuntimeError, match="mis-nesting"):
        tr.end(1, "a")


def test_percentile_nearest_rank():
    xs = [10.0, 20.0, 30.0, 40.0]
    assert percentile(xs, 50) == 20.0
    assert percentile(xs, 99) == 40.0
    assert percentile(xs, 0) == 10.0
    assert percentile([], 50) == 0.0
    assert percentile([5.0], 99) == 5.0


def test_request_timing_from_stamps():
    tm = RequestTiming.from_stamps(
        3, "done", t_submit=1.0, t_admit=1.5, t_first=2.0,
        tok_times=[2.0, 2.1, 2.3], t_end=2.4)
    assert tm.queue_ms == pytest.approx(500.0)
    assert tm.ttft_ms == pytest.approx(1000.0)
    assert tm.total_ms == pytest.approx(1400.0)
    assert tm.n_tokens == 3
    assert tm.tbt_ms_p50 == pytest.approx(100.0)
    assert tm.tbt_ms_p99 == pytest.approx(200.0)
    tq = RequestTiming.from_stamps(4, "timeout", t_submit=1.0,
                                   t_admit=None, t_first=None,
                                   tok_times=[], t_end=3.0)
    assert tq.queue_ms == tq.ttft_ms == 0.0 and tq.total_ms > 0


# -- metrics and the re-capture detector -----------------------------------------


def test_metrics_registry_kinds_and_rings():
    m = MetricsRegistry(ring=4, now_fn=FakeClock())
    m.counter("c").inc()
    m.counter("c").inc(2)
    assert m.counter("c").get() == 3
    with pytest.raises(ValueError, match="negative"):
        m.counter("c").inc(-1)
    with pytest.raises(TypeError, match="counter"):
        m.gauge("c")
    m.gauge("g").set(7)
    m.histogram("h").observe(3.0)
    m.histogram("h").observe(700.0)
    assert m.histogram("h").get() == 2
    assert m.histogram("h").mean == pytest.approx(351.5)
    for tick in range(6):
        m.sample(tick)
    assert len(m.series("c")) == 4
    assert [v for _, _, v in m.series("c")] == [3.0] * 4
    assert m.snapshot() == {"c": 3.0, "g": 7.0, "h": 2.0}
    dump = m.dump()
    assert "# TYPE c counter" in dump and 'h_bucket{le="+Inf"} 2' in dump


def test_obs_level_gate(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    assert level() == 0 and obs_from_env() is None
    monkeypatch.setenv("REPRO_OBS", "1")
    obs = obs_from_env(FakeClock())
    assert isinstance(obs, ServeObs) and not obs.numeric
    obs.close()
    monkeypatch.setenv("REPRO_OBS", "2")
    obs = obs_from_env(FakeClock())
    assert obs.numeric
    obs.close()
    monkeypatch.setenv("REPRO_OBS", "yes")
    with pytest.raises(ValueError, match="REPRO_OBS"):
        level()


def test_compile_watcher_counts_and_arms():
    """A capture before ``arm`` is warm-up; after it, a steady-state
    recompile; a stopped watcher counts nothing."""
    reg = MetricsRegistry(now_fn=FakeClock())
    with CompileWatcher(registry=reg) as w:
        record_capture(0.5)
        assert w.compiles == 1 and w.compile_secs == 0.5
        assert reg.counter("graph.captures").get() == 1
        w.arm()
        assert w.steady_state_recompiles == 0
        assert reg.counter("graph.recompiles_steady_state").get() == 0
        record_capture(0.25)
        assert w.steady_state_recompiles == 1
        assert reg.counter("graph.recompiles_steady_state").get() == 1
    record_capture(0.1)
    assert w.compiles == 2
    obs = ServeObs(FakeClock())
    obs.arm_steady()
    record_capture(0.1)
    assert obs.steady_state_recompiles == 1
    obs.close()
    record_capture(0.1)
    assert obs.steady_state_recompiles == 1


# -- exports --------------------------------------------------------------------


def _small_trace(tracer_cls):
    tr = tracer_cls(FakeClock())
    tr.begin(0, "request", prompt_tokens=4)
    tr.begin(0, "queued")
    tr.end(0, "queued")
    tr.instant(0, "first_token", token=9)
    tr.begin(SCHED_TRACK, "tick", tick=1)
    tr.end(SCHED_TRACK, "tick")
    tr.close_track(0)
    return tr


def test_exports_roundtrip_and_chrome_shape(tmp_path, capsys):
    tr = _small_trace(Tracer)
    tm = RequestTiming.from_stamps(0, "done", t_submit=0.0, t_admit=0.1,
                                   t_first=0.2, tok_times=[0.2], t_end=0.3)
    recs = export.trace_records(tr, [tm], meta={"run": "unit"})
    assert recs[0] == {"kind": "meta", "run": "unit"}
    p = tmp_path / "t.jsonl"
    export.write_jsonl(p, recs)
    assert export.read_jsonl(p) == recs
    doc = export.chrome_trace(recs)
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} == {"X", "i", "M"}
    names = {e["args"]["name"] for e in events
             if e["name"] == "thread_name"}
    assert names == {"scheduler", "request 0"}
    assert all(e["ts"] >= 0 for e in events if e["ph"] != "M")
    buf = io.StringIO()
    export.write_chrome(buf, recs)
    assert json.loads(buf.getvalue()) == doc
    # the reference's export of the same trace, the process name aside
    jrecs = jexport.trace_records(_small_trace(JTracer), [tm],
                                  meta={"run": "unit"})
    assert jrecs == recs
    assert jexport.chrome_trace(jrecs, process_name="repro_torch.serve") \
        == doc
    # the report CLI (python -m repro_torch.obs.report)
    out = tmp_path / "t.perfetto.json"
    assert report.main([str(p), "--chrome", str(out)]) == 0
    text = capsys.readouterr().out
    assert "1 request timings" in text and "first_token=1" in text
    assert json.loads(out.read_text()) == doc


# -- scheduler integration --------------------------------------------------------


def _serve_chaos(pair, monkeypatch, obs_level):
    """One deterministic faulted workload: (engine, rids, payloads)."""
    cfg = pair[0]
    if obs_level:
        monkeypatch.setenv("REPRO_OBS", str(obs_level))
    else:
        monkeypatch.delenv("REPRO_OBS", raising=False)
    eng = _engine(pair)
    sched = eng.scheduler()
    sched.injector = FaultInjector(sched.pool, rate=0.3, seed=5,
                                   kind="nar", target="live", max_faults=2)
    prompts = _prompts(cfg.vocab, (3, 11, 19, PS, 5), seed=9)
    rids = [eng.submit(p, 4, priority=i % 3,
                       temperature=0.7 if i == 2 else 0.0, seed=i)
            for i, p in enumerate(prompts)]
    # a deadline far past the fake clock's horizon: the bookkeeping runs,
    # the schedule does not depend on how often the clock is read
    rids.append(eng.submit(_prompts(cfg.vocab, (PS,), seed=1)[0], 4,
                           deadline_ms=60_000.0))
    victim = eng.submit(_prompts(cfg.vocab, (6,), seed=2)[0], 6)
    rids.append(victim)
    payloads = []
    for i, ev in enumerate(eng.run()):
        payloads.append((ev.rid, ev.token, ev.done, ev.status))
        if i == 3:
            eng.cancel(victim)
    return eng, rids, payloads


def test_token_neutrality_and_span_completeness(pair, monkeypatch):
    eng_off, rids, pay_off = _serve_chaos(pair, monkeypatch, 0)
    assert eng_off.obs is None
    eng_on, rids_on, pay_on = _serve_chaos(pair, monkeypatch, 2)
    assert rids_on == rids
    assert pay_on == pay_off
    statuses = {eng_on.status(r) for r in rids}
    assert "poisoned" in statuses and "cancelled" in statuses
    for r in rids:
        assert eng_on.status(r) == eng_off.status(r)
    tr = eng_on.obs.tracer
    for r in rids:
        assert eng_on.status(r) in TERMINAL
        assert tr.open_depth(r) == 0
        spans = tr.track_spans(r)
        assert spans and spans[0].name == "request"
        assert all(s.t1 is not None and s.t1 >= s.t0 for s in spans)
        assert [s.depth for s in spans].count(0) == 1
    terminals = [i for i in tr.instants if i.name == "terminal"]
    assert sorted(i.track for i in terminals) == sorted(rids)
    for eng in (eng_off, eng_on):
        for r in rids:
            tm = eng.timing(r)
            assert tm.status == eng.status(r) and tm.total_ms > 0
    # the trace exports as Chrome JSON, one named track per request
    recs = eng_on.trace_records({"run": "chaos"})
    assert recs[0]["kind"] == "meta" and recs[0]["kv_quant"] == "takum8"
    doc = json.loads(json.dumps(export.chrome_trace(recs)))
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    assert {f"request {r}" for r in rids} <= names
    # no capture on the CPU: nothing to count after arming
    eng_on.obs.arm_steady()
    assert eng_on.obs.steady_state_recompiles == 0
    eng_on.obs.close()


def test_metric_gauges_match_pool_stats_every_tick(pair, monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "2")
    eng = _engine(pair)
    sched = eng.scheduler()
    m = sched.obs.metrics
    checked = {"n": 0}
    orig = sched._obs_sample

    def sampled():
        orig()
        st = sched.pool.stats()
        assert m.gauge("pool.free").get() == st.free
        assert m.gauge("pool.in_use").get() == st.in_use
        assert m.gauge("pool.shared_pages").get() == st.shared_pages
        assert m.gauge("pool.quarantined").get() == st.quarantined
        for key, val in sched.prefix.stats().items():
            assert m.gauge(f"prefix.{key}").get() == val
        checked["n"] += 1

    monkeypatch.setattr(sched, "_obs_sample", sampled)
    base = _prompts(pair[0].vocab, (2 * PS,), seed=4)[0]
    r1 = eng.submit(base, 3)
    for _ in eng.run():
        pass
    r2 = eng.submit(base + _prompts(pair[0].vocab, (3,), seed=5)[0], 3)
    for _ in eng.run():
        pass
    assert checked["n"] == sched._tick > 0
    assert eng.status(r1) == eng.status(r2) == "done"
    assert m.gauge("prefix.hit_tokens").get() >= PS
    for name in ("sched.requests_submitted", "sched.tokens"):
        vals = [v for _, _, v in m.series(name)]
        assert vals == sorted(vals) and vals[-1] > 0
    assert [v for _, _, v in m.series("pool.nar_words")][-1] == 0
    sched.obs.close()


@pytest.mark.parametrize("kv", ["takum8", "takum16", "none"])
def test_scan_nar_counts_injected_words(pair, monkeypatch, kv):
    monkeypatch.setenv("REPRO_OBS", "2")
    cfg = dataclasses.replace(pair[0], kv_quant=kv)
    eng = ServeEngine(pair[1], cfg, max_len=48, page_size=PS,
                      decode_batch=2, now_fn=FakeClock(),
                      prefix_cache=False, device="cpu")
    sched = eng.scheduler()
    rid = eng.submit(_prompts(cfg.vocab, (PS,), seed=7)[0], 6)
    stream = eng.run()
    next(stream)                        # prefill done: pages are live
    assert sched.pool.scan_nar() == 0
    inj = FaultInjector(sched.pool, rate=2.0, seed=0, kind="nar",
                        target="live", max_faults=2)
    recs = inj.step(sched._tick)
    sites = {(r.page, r.rep, r.key, r.offset) for r in recs}
    assert sched.pool.scan_nar() == len(sites) >= 1
    assert sched.pool.scan_nar(pages=[recs[0].page]) >= 1
    for _ in stream:
        pass
    assert eng.status(rid) == "poisoned"
    assert sched.pool.stats().quarantined >= 1
    sched.obs.close()


def test_fault_observer_does_not_change_schedule(pair):
    def run(with_observer):
        eng = _engine(pair, prefix_cache=False)
        sched = eng.scheduler()
        inj = FaultInjector(sched.pool, rate=0.5, seed=11, kind="nar",
                            target="live", max_faults=3)
        seen = []
        if with_observer:
            inj.observer = seen.append
        sched.injector = inj
        for p in _prompts(pair[0].vocab, (PS, 11), seed=8):
            eng.submit(p, 4)
        for _ in eng.run():
            pass
        return inj.injected, seen

    ledger_plain, _ = run(False)
    ledger_obs, seen = run(True)
    assert ledger_obs == ledger_plain
    assert seen == ledger_obs


def test_trace_records_raises_when_off(pair, monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    eng = _engine(pair)
    eng.scheduler()
    with pytest.raises(RuntimeError, match="REPRO_OBS"):
        eng.trace_records()


def test_quantize_weights_saturation_counters(monkeypatch):
    """Weights beyond the format's finite range are counted under
    ``REPRO_OBS``; the range is the reference's."""
    from repro import formats as jformats
    from repro.serve.engine import _format_max as jformat_max
    from repro_torch import formats
    from repro_torch.serve.engine import _format_max
    for name in ("takum8", "takum16", "posit8", "lns-takum8"):
        assert _format_max(formats.resolve_wire(name)) == \
            jformat_max(jformats.resolve_wire(name)), name
    # posit8's range (2^24) keeps 3 x fmax finite in f32; takum8's
    # (about 2^183) would not
    fmax = _format_max(formats.resolve_wire("posit8"))
    assert 0 < fmax < float("inf")
    params = {"blk": {"w1": torch.tensor([[1.0, 2.0 * fmax],
                                          [-3.0 * fmax, 0.5]])}}
    monkeypatch.delenv("REPRO_OBS", raising=False)
    base = GLOBAL.counter("quant.saturated").get()
    quantize_weights(params, "posit8", verbose=False)
    assert GLOBAL.counter("quant.saturated").get() == base
    monkeypatch.setenv("REPRO_OBS", "1")
    quantize_weights(params, "posit8", verbose=False)
    assert GLOBAL.counter("quant.saturated").get() == base + 2


def test_watchdog_transition_hook():
    clk = FakeClock()
    seen = []
    wd = Watchdog(2, dead_after=1.0, now_fn=clk,
                  on_transition=lambda h, s: seen.append((h, s)))
    for h in (0, 1):
        wd.beat(Heartbeat(host=h, step=0, t=clk(), step_time=0.0))
    assert wd.dead_hosts() == [] and seen == []
    clk.t += 5.0
    wd.beat(Heartbeat(host=0, step=1, t=clk(), step_time=0.0))
    assert wd.dead_hosts() == [1]
    assert seen == [(1, "dead")]
    wd.beat(Heartbeat(host=1, step=1, t=clk(), step_time=0.0))
    assert wd.dead_hosts() == []
    assert seen == [(1, "dead"), (1, "alive")]
    assert wd.dead_hosts() == [] and len(seen) == 2
