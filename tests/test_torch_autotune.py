"""The launch-plan autotuner (``repro_torch/kernels/autotune.py``) against
the JAX package's block autotuner (``repro/kernels/autotune.py``).

The reference's semantics with an injected clock in place of sleeps:
``force`` sweeps and records, a hit in mode ``1`` returns the same plan
untimed, ``force`` sweeps again to the same answer; mode ``0`` and a
mode-``1`` miss take the space's first (the planner's) plan untimed; an
invalid mode raises; a failing candidate is skipped and named. The key
space (buckets, key format) is the reference's. With the checked-in
table, and with ``REPRO_AUTOTUNE=0``, every resolved plan is the
planner's own (``launch_plan``, ``DEFAULT_BK``) over a grid of shapes;
a swept entry is fitted to each shape of its bucket. (On the card, a
wrapper called without a plan launches the resolved one:
tests/test_torch_gpu.py, which imports no JAX.)
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import json

import pytest

from repro.kernels import autotune as jautotune
from repro_torch import formats
from repro_torch.kernels import autotune
from repro_torch.kernels import lns_matmul as klns
from repro_torch.kernels import takum_attention, takum_matmul
from repro_torch.obs.metrics import GLOBAL

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def fresh(tmp_path, monkeypatch):
    """Each test with its own local cache, no remembered plans."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.clear()
    yield tmp_path / "tune.json"
    autotune.clear()


def _clock(times, calls):
    """A timer giving each plan its seconds from ``times`` (no sleeps)."""
    def timer(run):
        return run()

    def runner(plan):
        def run():
            calls.append(plan)
            return times[plan]
        return run
    return timer, runner


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 5120, 17920),
                                   (256, 5120, 17920), (9, 100, 3000),
                                   (4096, 73728, 18432)])
def test_buckets_are_the_reference_s(m, k, n):
    assert autotune.matmul_bucket(m, k, n) == jautotune.matmul_bucket(m, k, n)
    assert autotune.attention_bucket(k) == jautotune.attention_bucket(k)
    assert autotune.OPS == jautotune.OPS


def test_force_then_cache_hit_then_resweep(fresh, monkeypatch):
    space = ((1, 1), (1, 2), (1, 4))
    times = {(1, 1): 3e-4, (1, 2): 1e-4, (1, 4): 2e-4}
    calls = []
    timer, runner = _clock(times, calls)
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    plan, us, swept = autotune.cached_or_sweep(
        "qmatmul", "takum8", "m256k8192n32768", space, runner, timer=timer)
    assert swept and plan == (1, 2) and us == pytest.approx(100.0)
    assert set(calls) == set(space)
    doc = json.loads(fresh.read_text())
    key = f"qmatmul|takum8|m256k8192n32768|{autotune.backend()}"
    assert doc["entries"][key]["plan"] == [1, 2]
    assert doc["entries"][key]["skipped"] == []

    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    calls.clear()
    plan2, _, swept2 = autotune.cached_or_sweep(
        "qmatmul", "takum8", "m256k8192n32768", space, runner, timer=timer)
    assert plan2 == plan and not swept2 and calls == []
    assert autotune.lookup("qmatmul", "takum8", "m256k8192n32768") == plan

    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    calls.clear()
    plan3, _, swept3 = autotune.cached_or_sweep(
        "qmatmul", "takum8", "m256k8192n32768", space, runner, timer=timer)
    assert swept3 and plan3 == plan and set(calls) == set(space)


def test_ties_keep_the_planner_s_choice(monkeypatch):
    space = ((0, 4), (0, 1), (1, 1))
    times = {(0, 4): 1e-4, (0, 1): 1e-4, (1, 1): 1e-4}
    timer, runner = _clock(times, [])
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    plan, _, _ = autotune.cached_or_sweep(
        "qmatmul", "takum8", "m8k8192n32768", space, runner, timer=timer)
    assert plan == (0, 4)


def test_mode_semantics(monkeypatch):
    space = ((0, 2), (1, 1))
    calls = []
    timer, runner = _clock({(0, 2): 2e-4, (1, 1): 1e-4}, calls)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    plan, us, swept = autotune.cached_or_sweep(
        "qmatmul", "takum8", "m8k8n8", space, runner, timer=timer)
    assert plan == (0, 2) and us is None and not swept and calls == []
    assert autotune.lookup("qmatmul", "takum8", "m8k8192n32768") is None
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    plan, us, swept = autotune.cached_or_sweep(
        "qmatmul", "takum8", "m8k8n8", space, runner, timer=timer)
    assert plan == (0, 2) and not swept and calls == []
    for bad in ("2", "true", ""):
        monkeypatch.setenv("REPRO_AUTOTUNE", bad)
        with pytest.raises(ValueError):
            autotune.mode()
        with pytest.raises(ValueError):
            jautotune.mode()


def test_sweep_skips_and_names_failing_candidates(fresh, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    log = []

    def runner(plan):
        if plan == (1, 64):
            raise RuntimeError("takum_qmatmul: CUDA error 1 at launch")
        return lambda: None
    plan, _, swept = autotune.cached_or_sweep(
        "qmatmul", "posit16", "m8k8n8", ((0, 1), (1, 64)), runner,
        log=log.append, timer=lambda run: (run(), 1e-4)[1])
    assert swept and plan == (0, 1)
    assert any("(1, 64): skipped (RuntimeError" in line for line in log)
    doc = json.loads(fresh.read_text())
    ent = doc["entries"][f"qmatmul|posit16|m8k8n8|{autotune.backend()}"]
    assert ent["skipped"] == [[1, 64]]
    # a sweep in which nothing ran chooses nothing
    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.cached_or_sweep(
            "qmatmul", "posit16", "m16k8n8", ((1, 64),), runner,
            timer=lambda run: (run(), 1e-4)[1])


def test_defaults_table_is_valid():
    doc = json.loads(open(autotune.DEFAULTS_PATH).read())
    assert doc["schema"] == 1 and isinstance(doc["entries"], dict)
    # no tuned plan is committed: every call takes the planner's choice
    # until a sweep writes the local cache
    assert doc["entries"] == {}
    assert autotune._load(autotune.DEFAULTS_PATH) == doc


GRID = [(m, k, n) for m in (1, 4, 16, 17, 256, 2048)
        for k in (64, 5120, 8192) for n in (128, 17920, 32768)]


@pytest.mark.parametrize("backend", ["cpu", H100])
@pytest.mark.parametrize("mode", ["0", "1"])
def test_checked_in_table_gives_the_planner_s_plans(monkeypatch, backend,
                                                    mode):
    monkeypatch.setenv("REPRO_AUTOTUNE", mode)
    monkeypatch.setattr(autotune, "_BACKEND", [backend])
    for name in ("takum8", "takum16", "posit8", "posit16"):
        spec = formats.get(name)
        for shape in GRID:
            assert autotune.resolved_plan("qmatmul", spec, shape) == \
                takum_matmul.launch_plan(*shape, spec.n), (name, shape)
    for name in ("lns-takum8", "lns-takum16"):
        spec = formats.get(name)
        for shape in GRID:
            assert autotune.resolved_plan("lns_qmatmul", spec, shape) == \
                klns.launch_plan(*shape, "linear", spec.n), (name, shape)
    for name in ("takum8", "lns-takum8", "posit8", "none"):
        spec = formats.resolve(name)
        for t in (64, 1024, 8192, 32832):
            assert autotune.resolved_plan("attention", spec, (t,)) == \
                (takum_attention.DEFAULT_BK,)


def test_lookups_count_hits_and_misses(fresh, monkeypatch):
    spec = formats.get("takum8")
    fresh.write_text(json.dumps({"schema": 1, "entries": {
        f"qmatmul|takum8|m8k8192n32768|{autotune.backend()}":
            {"plan": [0, 16]}}}))
    hit0 = GLOBAL.counter("autotune.hit").get()
    miss0 = GLOBAL.counter("autotune.miss").get()
    # a swept bucket: a hit; another: a miss; the same shape again:
    # remembered, no lookup
    autotune.resolved_plan("qmatmul", spec, (4, 5120, 17920))
    autotune.resolved_plan("qmatmul", spec, (3, 100, 100))
    autotune.resolved_plan("qmatmul", spec, (4, 5120, 17920))
    assert GLOBAL.counter("autotune.hit").get() == hit0 + 1
    assert GLOBAL.counter("autotune.miss").get() == miss0 + 1
    # a mode read once a process: changed, it takes effect after clear()
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    autotune.clear()
    autotune.resolved_plan("qmatmul", spec, (5, 100, 100))
    assert GLOBAL.counter("autotune.miss").get() == miss0 + 1


def test_a_swept_entry_is_fitted_to_each_shape(fresh, monkeypatch):
    be = autotune.backend()
    fresh.write_text(json.dumps({"schema": 1, "entries": {
        f"qmatmul|takum8|m256k8192n32768|{be}": {"plan": [1, 4]},
        f"qmatmul|takum16|m8k8192n32768|{be}": {"plan": [0, 2]},
        f"lns_qmatmul|lns-takum8|m256k8192n32768|{be}": {"plan": [1, 3]},
        f"attention|takum8|t1024|{be}": {"plan": [128]},
    }}))
    t8, t16 = formats.get("takum8"), formats.get("takum16")
    # K 5120 = 160 tiles of 32: 4 splits of 40
    assert autotune.resolved_plan("qmatmul", t8, (256, 5120, 17920)) == \
        (1, 4, 40)
    # K 8000 = 250 tiles: 4 splits of 63 (the last shorter)
    assert autotune.resolved_plan("qmatmul", t8, (200, 8000, 20000)) == \
        (1, 4, 63)
    # the streaming kernel's x stage caps a split at 32 tiles (16-bit
    # words: 8 rows x 32 x 32 floats)
    assert autotune.resolved_plan("qmatmul", t16, (8, 5120, 17920)) == \
        (0, 5, 32)
    lt8 = formats.get("lns-takum8")
    assert autotune.resolved_plan("lns_qmatmul", lt8, (256, 5120, 17920)) \
        == (1, 3, 107)
    assert autotune.resolved_plan("attention", t8, (1000,)) == (128,)
    # another bucket keeps the planner's
    assert autotune.resolved_plan("qmatmul", t8, (4, 5120, 17920)) == \
        takum_matmul.launch_plan(4, 5120, 17920, 8)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    autotune.clear()
    assert autotune.resolved_plan("qmatmul", t8, (256, 5120, 17920)) == \
        takum_matmul.launch_plan(256, 5120, 17920, 8)


def test_spaces_start_with_the_planner_s_plan():
    for shape in ((4, 5120, 17920), (256, 5120, 17920), (16, 64, 64)):
        for bits in (8, 16):
            sp = autotune.qmm_space(shape, bits)
            assert sp[0] == takum_matmul.launch_plan(*shape, bits)[:2]
            assert len(set(sp)) == len(sp)
            for plan in sp:
                assert autotune.fit_plan("qmatmul", plan, shape, bits)
            ls = autotune.lns_space(shape, bits)
            assert ls[0] == klns.launch_plan(*shape, "linear", bits)[:2]
        # the streaming kernel only for decode batches
        assert all(p[0] == 1 for p in autotune.qmm_space((256, 64, 64)))
    assert autotune.attn_space(256)[0] == (256,)
