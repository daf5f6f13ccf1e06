"""The port's serving slice against the JAX package, on the CPU.

The reduced phi3-medium-14b config, the reference's ``model.init``
weights (PRNGKey 0) quantised by the reference's
``quantize_weights(mode="wire")`` and carried over with
``convert.params_from_numpy``, served by both ``ServeEngine``s on the
prompts of tests/test_serve_scheduler.py (lengths 16, 9, 4, 13; page
size 16; a pool large enough that the reference never preempts):

* ``prefill_chunk`` and ``decode_step`` logits agree within
  ``rtol=1e-4, atol=1e-4`` (f32 sums in another order, then takum
  rounding of the K/V words);
* ``generate`` at temperature 0 gives token-identical streams, with the
  prefix tree cold and warm, and equal ``PageStats``;
* the page pool and the prefix tree make the same decisions as the
  reference's on the same operation sequences.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels.ops import WireMatrix as JWireMatrix
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import quantize_weights as jquantize
from repro.serve.paged import PagePool as JPagePool
from repro.serve.prefix import PrefixCache as JPrefixCache
from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.device import check_generator
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine, quantize_weights
from repro_torch.serve.paged import AdmissionError, PagePool, PagePoolError
from repro_torch.serve.prefix import PrefixCache

PLENS = (16, 9, 4, 13)
COMBOS = [(w, kv) for w in ("takum8", "takum16")
          for kv in ("takum8", "takum16")]


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda leaf: ((np.asarray(leaf.words), leaf.spec.name)
                      if isinstance(leaf, JWireMatrix) else np.asarray(leaf)),
        tree, is_leaf=lambda leaf: isinstance(leaf, JWireMatrix))


@pytest.fixture(scope="module")
def ref_params():
    return jmodel.init(jax.random.PRNGKey(0),
                       jget_arch("phi3-medium-14b").reduced)


@pytest.fixture(scope="module")
def wired(ref_params):
    """weight format -> (reference wire params, port params)."""
    cfg = get_arch("phi3-medium-14b").reduced
    out = {}
    for fmt in ("takum8", "takum16"):
        # the reference's own quantize_weights, traced once (the eager call
        # gives the same words, several times slower)
        jp = jax.jit(lambda p, f=fmt: jquantize(p, f, mode="wire",
                                                 verbose=False))(ref_params)
        out[fmt] = (jp, params_from_numpy(_to_numpy(jp), cfg, "cpu"))
    return out


def _cfgs(kv):
    return (dataclasses.replace(jget_arch("phi3-medium-14b").reduced,
                                kv_quant=kv),
            dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                                kv_quant=kv))


def _stats(pool):
    return dataclasses.asdict(pool.stats())


def _prompts(vocab, lens=PLENS, seed=3):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, n)) for n in lens]


@pytest.mark.parametrize("wfmt,kv", COMBOS)
def test_generate_tokens_and_step_logits(wired, wfmt, kv):
    jcfg, cfg = _cfgs(kv)
    jp, tp = wired[wfmt]
    prompts = _prompts(cfg.vocab)
    jeng = JServeEngine(jp, jcfg, max_len=48, page_size=16)
    teng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
    for label in ("cold", "warm"):
        want = jeng.generate(prompts, max_new=4)
        got = teng.generate(prompts, max_new=4)
        assert got == want, (wfmt, kv, label)
    assert _stats(teng.scheduler().pool) == _stats(jeng.scheduler().pool)
    assert teng.scheduler().pool.stats().prefix_hit_tokens > 0

    # prefill_chunk logits, through the reference engine's own compiled
    # chunk step (contiguous cache of 32 positions, 16-token chunk)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :13] = prompts[3]
    jcache = jmodel.init_cache(jcfg, batch=1, max_len=32)
    jrow, jcache = jeng._prefill_chunk(jp, jnp.asarray(tokens), jcache,
                                       jnp.asarray(0, jnp.int32),
                                       jnp.asarray(12, jnp.int32))
    cache = model.init_cache(cfg, 1, 32, device="cpu")
    row, cache = model.prefill_chunk(teng.params,
                                     torch.from_numpy(tokens).long(), cfg,
                                     cache, pos=0, last_idx=12)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=1e-4,
                               atol=1e-4)
    # layer 0's K/V words come straight from the embeddings: each is the
    # reference's word or its takum neighbour (a value at a rounding
    # boundary reached through another f32 sum order; takum words order
    # like two's complement). Deeper layers inherit those flips and the
    # ulp-level differences of every f32 op before them, so they are held
    # through the logits above, not word by word.
    n = int(kv[5:])
    for key in ("k", "v"):
        want = np.asarray(jcache[0]["b0"]["attn"][key][0, :, :13])
        got = cache[0][key][:, :13].numpy()
        step = (got.astype(np.int64) - want.astype(np.int64)) % (1 << n)
        assert np.isin(step, (0, 1, (1 << n) - 1)).all(), key
        assert (step != 0).mean() < 0.01, key

    # one packed decode step over each engine's own pool, slot 0 holding
    # that prefill at page 1 and the other slots idle on the scratch page
    jpool, pool = jeng.scheduler().pool, teng.scheduler().pool
    tok = np.zeros((8, 1), np.int32)
    tok[0, 0] = int(np.argmax(np.asarray(jrow)))
    for p, c in ((jpool, jcache), (pool, cache)):
        p.scatter_prefill(c, [1], first_page=0)
        for slot in range(8):
            p.clear(slot)
        p.assign(0, [1], pos=13)
        p.push_tables()
    pos = jpool.pos[:, None].copy()
    jlog, _ = jax.jit(lambda p, t, c, q: jmodel.decode_step(
        p, t, jcfg, c, pos=q))(jp, jnp.asarray(tok), jpool.cache,
                               jnp.asarray(pos))
    log, _ = model.decode_step(teng.params, torch.from_numpy(tok).long(), cfg,
                               pool.cache, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(log[0].numpy(), np.asarray(jlog)[0],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_float_kv_cache_serves_like_the_reference(wired, dtype):
    """The registered config's own KV setting, ``kv_quant="none"``: a
    float cache in the activation dtype (bf16 or f32), takum8 wire
    weights, cold and warm prefix tree, equal ``PageStats``.

    f32: greedy streams token-identical to the JAX engine's. bf16: the
    same streams up to a position where the reference's own two best
    logits tie within bf16 rounding (2^-5 of the largest logit: a few
    bf16 units, which the bf16 activations of both engines accumulate
    through the layers in different places); there, teacher-forced with
    the reference's stream, the port's logits lie within that rounding
    of the reference's and the port picks one of the tied tokens. (Such a tie is no defect of the
    float cache: bf16 serving with takum8 KV words meets it at the same
    place.)"""
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in _cfgs("none"))
    jp, tp = wired["takum8"]
    prompts = _prompts(cfg.vocab)
    jeng = JServeEngine(jp, jcfg, max_len=48, page_size=16)
    teng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
    ties = 0
    for label in ("cold", "warm"):
        want = [[int(t) for t in seq] for seq in jeng.generate(prompts, 4)]
        got = teng.generate(prompts, max_new=4)
        if dtype == "f32":
            assert got == want, label
            continue
        for seq, mine in zip(want, got):
            if mine == seq:
                continue
            i = next(i for i, (a, b) in enumerate(zip(seq, mine)) if a != b)
            tokens = np.zeros((1, 16), np.int32)
            tokens[0, :i] = seq[:i]
            jrow, _ = jeng._prefill_chunk(
                jp, jnp.asarray(tokens), jmodel.init_cache(jcfg, 1, 32),
                jnp.asarray(0, jnp.int32), jnp.asarray(i - 1, jnp.int32))
            row, _ = model.prefill_chunk(
                teng.params, torch.from_numpy(tokens).long(), cfg,
                model.init_cache(cfg, 1, 32, device="cpu"), pos=0,
                last_idx=i - 1)
            j = np.asarray(jrow, np.float32).ravel()
            t = row.float().numpy().ravel()
            tol = 2.0 ** -5 * np.abs(j).max()
            top2 = np.sort(j)[-2:]
            assert top2[1] - top2[0] <= tol, (label, i)       # a tie
            assert np.abs(j - t).max() <= tol, (label, i)
            assert j[mine[i]] >= j.max() - tol, (label, i)
            ties += 1
    assert ties <= 2 * len(prompts)
    pool = teng.scheduler().pool
    want_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    assert pool.cache[0]["k"].dtype == want_dtype
    assert _stats(pool) == _stats(jeng.scheduler().pool)


def test_submit_run_streams_match_generate(wired):
    jcfg, cfg = _cfgs("takum8")
    tp = wired["takum8"][1]
    prompts = _prompts(cfg.vocab)
    eng = ServeEngine(tp, cfg, max_len=48, page_size=16, decode_batch=2,
                      device="cpu")
    rids = [eng.submit(p, 3) for p in prompts]
    streamed = {r: [] for r in rids}
    for ev in eng.run():
        streamed[ev.rid].append(ev.token)
    want = ServeEngine(tp, cfg, max_len=48, page_size=16, decode_batch=2,
                       device="cpu").generate(prompts, 3)
    for r, p, w in zip(rids, prompts, want):
        assert eng.result(r) == p + streamed[r] == w


def test_priorities_admit_first_and_tokens_stay_put(wired):
    _, cfg = _cfgs("takum16")
    tp = wired["takum16"][1]
    prompts = _prompts(cfg.vocab)
    eng = ServeEngine(tp, cfg, max_len=48, page_size=16, decode_batch=1,
                      device="cpu")
    rids = [eng.submit(p, 2, priority=i) for i, p in enumerate(prompts)]
    order = []
    for ev in eng.run():
        if ev.done:
            order.append(ev.rid)
    assert order == rids[::-1]
    solo = ServeEngine(tp, cfg, max_len=48, page_size=16,
                       device="cpu").generate(prompts, 2)
    assert [eng.result(r) for r in rids] == solo


def test_quantize_weights_wires_the_projections():
    cfg = get_arch("phi3-medium-14b").reduced
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    wp = quantize_weights(params, "takum8", mode="wire", verbose=False)
    layer = wp["layers"][0]
    for name in ("wq", "wk", "wv", "wo"):
        assert layer["attn"][name].spec.name == "takum8"
    for name in ("wg", "w1", "w2"):
        assert layer["mlp"][name].words.dtype == torch.uint8
    assert wp["embed_tokens"] is params["embed_tokens"]
    # mode="fake" (the default) rounds every projection in place through
    # the format's grid (parity with the reference:
    # tests/test_torch_fake_quant.py)
    fq = quantize_weights(params, "posit8", verbose=False)
    for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                        ("mlp", ("wg", "w1", "w2"))):
        for name in names:
            w = params["layers"][1][part][name]
            got = fq["layers"][1][part][name]
            assert got.dtype == w.dtype and got.shape == w.shape
            assert torch.equal(got, formats.get("posit8").fake_quant(w))
    norm = params["layers"][0]["ln1"]["scale"]
    assert fq["layers"][0]["ln1"]["scale"] is norm


def test_engine_refuses_what_is_not_ported(wired):
    """Multi-device serving (``shard=``) needs a launched job: a plan of
    more than one rank without an initialised process group is refused,
    naming how to launch (tests/test_torch_shard.py serves over gloo
    ranks), and a family without the TP seams is refused by name; a plan
    of one rank is the plain engine, as the reference's. Preemption (the
    default), deadlines and cancellation are served
    (tests/test_torch_faults.py)."""
    from repro_torch.serve.shard import ShardPlan
    _, cfg = _cfgs("takum8")
    tp = wired["takum8"][1]
    with pytest.raises(ValueError, match="init_process_group"):
        ServeEngine(tp, cfg, max_len=48, device="cpu", shard=ShardPlan(tp=2))
    rwkv = get_arch("rwkv6-1.6b").reduced
    with pytest.raises(ValueError, match="'rwkv6'"):
        ServeEngine({}, rwkv, max_len=48, device="cpu", shard=ShardPlan(tp=2))
    one = ServeEngine(tp, cfg, max_len=48, device="cpu", shard=ShardPlan())
    assert one.run_cfg is one.cfg and one.graphable
    eng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
    assert eng.preempt
    rid = eng.submit([1, 2], 2, deadline_ms=5.0)
    assert eng.cancel(rid) and eng.status(rid) == "cancelled"
    with pytest.raises(AdmissionError):
        eng.submit([1] * 40, 20)


def test_engine_needs_a_card_unless_told_cpu(wired):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, cfg = _cfgs("takum8")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(wired["takum8"][1], cfg, max_len=48)


_ENTRY_POINTS = {
    "init": lambda cfg, tree: model.init(torch.Generator(), cfg),
    "init_cache": lambda cfg, tree: model.init_cache(cfg, 1, 16),
    "init_paged_cache": lambda cfg, tree: model.init_paged_cache(
        cfg, 2, 4, 16, 2),
    "params_from_numpy": lambda cfg, tree: params_from_numpy(tree, cfg),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_need_a_card_unless_told_cpu(ref_params, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, cfg = _cfgs("takum8")
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[entry](cfg, _to_numpy(ref_params))


def test_init_refuses_a_generator_on_another_device():
    cfg = get_arch("phi3-medium-14b").reduced
    with pytest.raises(ValueError, match="generator"):
        check_generator(torch.Generator(), torch.device("cuda"))
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["unembed"].device.type == "cpu"


def test_sampled_requests_are_seeded_per_request(wired):
    _, cfg = _cfgs("takum8")
    tp = wired["takum8"][1]
    prompts = _prompts(cfg.vocab)
    outs = []
    for _ in range(2):
        eng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
        rids = [eng.submit(p, 4, temperature=0.8, top_p=0.9, seed=7 + i)
                for i, p in enumerate(prompts)]
        list(eng.run())
        outs.append([eng.result(r) for r in rids])
    assert outs[0] == outs[1]
    assert all(len(o) == len(p) + 4 for o, p in zip(outs[0], prompts))


# -- page pool and prefix tree against the reference's -------------------------


def _pool_pair(cfg_kv="takum8", **kw):
    jcfg, cfg = _cfgs(cfg_kv)
    args = dict(batch=2, num_pages=9, page_size=16, max_pages=4,
                alloc_device=False, **kw)
    return JPagePool(jcfg, **args), PagePool(cfg, **args)


def test_page_pool_follows_the_reference_allocator():
    jpool, pool = _pool_pair()
    rng = np.random.default_rng(0)
    held = []
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0 and pool.pages_free():
            n = int(rng.integers(1, pool.pages_free() + 1))
            got, want = pool.alloc(n), jpool.alloc(n)
            assert got == want
            held.extend(got)
        elif op == 1 and held:
            p = held[int(rng.integers(len(held)))]
            pool.ref(p)
            jpool.ref(p)
            held.append(p)
        elif op == 2 and held:
            p = held.pop(int(rng.integers(len(held))))
            pool.unref(p)
            jpool.unref(p)
        assert _stats(pool) == _stats(jpool)
    with pytest.raises(PagePoolError):
        pool.unref(0)
    with pytest.raises(PagePoolError):
        pool.alloc(pool.pages_free() + 1)


def test_prefix_tree_follows_the_reference_tree():
    jpool, pool = _pool_pair(cfg_kv="takum16")
    jtree, tree = JPrefixCache(jpool), PrefixCache(pool)
    rng = np.random.default_rng(1)
    base = list(rng.integers(0, 50, 64))
    for step in range(40):
        cut = int(rng.integers(1, 64))
        prompt = base[:cut] + list(rng.integers(0, 50, int(rng.integers(0, 20))))
        jplan, plan = jtree.plan(prompt), tree.plan(prompt)
        assert (plan.shared, plan.cow_src, plan.suffix_start) == \
            (jplan.shared, jplan.cow_src, jplan.suffix_start)
        need = -(-len(prompt) // 16) - len(plan.shared)
        jtree.evict_for(need)
        tree.evict_for(need)
        if pool.pages_free() >= need and len(prompt) <= 64:
            tree.acquire(prompt, plan)
            jtree.acquire(prompt, jplan)
            pages = plan.shared + pool.alloc(need)
            assert pages == jplan.shared + jpool.alloc(need)
            tree.insert(prompt, pages[:len(prompt) // 16])
            jtree.insert(prompt, pages[:len(prompt) // 16])
            for p in pages:
                pool.unref(p)
                jpool.unref(p)
        assert _stats(pool) == _stats(jpool)
        assert tree.stats() == jtree.stats()
    tree.clear()
    assert pool.pages_in_use() == 0
