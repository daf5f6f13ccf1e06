"""The port's MoE family and head dim 112 against the JAX package, on the
CPU.

* ``models/moe.py::moe_apply`` against the reference's, f32, within
  ``rtol=atol=1e-5`` (the same sums in another order), with the expert
  ids and the kept slots (and so the drops) identical and ``aux`` within
  ``AUX_RTOL`` (its f32 means sum in another order): per
  sequence groups (prefill, training) and one group of a decode step's
  batch; with a capacity factor small enough that assignments drop, with
  router logits that tie exactly (two router columns equal), and on a
  right-padded prefill chunk.
* ``quantize_weights(mode="wire")`` on the reduced granite-moe tree:
  the reference's audit counts, the attention projections' wire words
  and the router's and expert stacks' takum8 fake-quant values bit-exact;
  the stacks rounded a slice at a time and in place give the same bits;
  the ``convert`` round trip.
* The reduced granite-moe-3b-a800m and kimi-k2-1t-a32b configs, the
  reference's ``model.init`` weights (PRNGKey 0) with takum8 wire weights
  and a takum8 KV cache, through both ``ServeEngine``s: greedy tokens
  identical, prefix tree cold and warm; ``forward``, ``prefill_chunk``
  (right-padded) and ``decode_step`` logits within 1e-4; ``loss_fn``'s
  value and ``aux`` within 1e-5.
* Head dim 112 (kimi-k2's): the plain contiguous and paged attention
  against the reference's Pallas kernels in interpret mode, at the
  tolerance of tests/test_torch_paged_split.py (``atol=2e-5``), with the
  paged kernel's partition plan, an all-masked row and a NaR V word at a
  masked place.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro.kernels.ops import WireMatrix as JWireMatrix
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import quantize_weights as jquantize
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import takum_attention as kattn
from repro_torch.models import model
from repro_torch.models import moe
from repro_torch.serve.engine import ServeEngine, quantize_weights

ARCHS = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b")
PLENS = (16, 9, 4, 13)
TOL = 1e-5
AUX_RTOL = 1e-6   # measured: 1 ulp (1.2e-7)


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda leaf: ((np.asarray(leaf.words), leaf.spec.name)
                      if isinstance(leaf, JWireMatrix) else np.asarray(leaf)),
        tree, is_leaf=lambda leaf: isinstance(leaf, JWireMatrix))


# -- moe_apply -----------------------------------------------------------------


def _moe_params(rng, d, f, e, tie=False):
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) * d ** -0.5,
         "experts_wg": rng.normal(size=(e, d, f)).astype(np.float32) * 0.2,
         "experts_w1": rng.normal(size=(e, d, f)).astype(np.float32) * 0.2,
         "experts_w2": rng.normal(size=(e, f, d)).astype(np.float32) * 0.2}
    if tie:   # experts 1, 3 and 6 get exactly equal logits for every token
        p["router"][:, 3] = p["router"][:, 1]
        p["router"][:, 6] = p["router"][:, 1]
    return p


@contextlib.contextmanager
def _reference_routes():
    """The reference's top-k ids and dispatch metadata, kept from its
    ``jax.lax.top_k`` and ``jax.vmap(dispatch)`` calls (as traced values
    when it runs under ``jit``)."""
    seen = {}
    top_k, vmap = jax.lax.top_k, jax.vmap

    def rec_top_k(x, k):
        vals, idx = top_k(x, k)
        seen["idx"] = idx
        return vals, idx

    def rec_vmap(fn):
        mapped = vmap(fn)
        if fn.__name__ != "dispatch":
            return mapped

        def call(*a):
            buf, meta = mapped(*a)
            seen["keep"], seen["dest"] = meta[2], meta[3]
            return buf, meta
        return call

    jax.lax.top_k, jax.vmap = rec_top_k, rec_vmap
    try:
        yield seen
    finally:
        jax.lax.top_k, jax.vmap = top_k, vmap


@contextlib.contextmanager
def _port_routes():
    seen = {}
    route, dispatch = moe.route, moe._dispatch

    def rec_route(logits, k):
        vals, idx = route(logits, k)
        seen["idx"] = idx.numpy()
        return vals, idx

    def rec_dispatch(*a):
        buf, meta = dispatch(*a)
        seen["keep"], seen["dest"] = meta[1].numpy(), meta[2].numpy()
        return buf, meta

    moe.route, moe._dispatch = rec_route, rec_dispatch
    try:
        yield seen
    finally:
        moe.route, moe._dispatch = route, dispatch


MOE_CASES = {
    # name: (b, t, experts, top_k, capacity factor, tied logits, padded rows)
    "prefill_dropfree": (2, 16, 8, 2, 4.0, False, 0),
    "prefill_drops": (2, 24, 8, 2, 0.5, False, 0),
    "prefill_ties": (2, 16, 8, 2, 1.0, True, 0),
    "decode_batch": (6, 1, 16, 4, 1.0, False, 0),
    "decode_ties_drops": (24, 1, 8, 4, 0.25, True, 0),
    "prefill_right_padded": (1, 32, 16, 4, 0.5, False, 19),
}


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_apply_routes_as_the_reference(name):
    b, t, e, k, cf, tie, pad = MOE_CASES[name]
    d, f = 32, 16
    rng = np.random.default_rng(sum(map(ord, name)))
    p = _moe_params(rng, d, f, e, tie)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    if pad:   # a right-padded chunk: the tail rows all one scratch token
        x[:, t - pad:] = x[:, t - pad:t - pad + 1]
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf)

    def reference(p, x):
        with _reference_routes() as seen:
            out, aux = jmoe.moe_apply(p, x, **kw)
        return out, aux, seen

    jout, jaux, want = jax.jit(reference)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in want.items()}
    with _port_routes() as got:
        out, aux = moe.moe_apply({n: torch.from_numpy(v)
                                  for n, v in p.items()},
                                 torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_array_equal(got["keep"], want["keep"])
    np.testing.assert_array_equal(got["dest"], want["dest"])
    # the same formula; its f32 means sum in XLA's order here and in
    # torch's there, a few ulp apart
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL,
                               atol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    if "drops" in name:
        assert not want["keep"].all()
    if "ties" in name:      # equal logits among the chosen: lower id first
        assert (np.diff(np.sort(got["idx"], -1), axis=-1) > 0).all()


def test_route_breaks_ties_by_the_lower_index():
    logits = torch.tensor([[0.5, 2.0, 2.0, 1.0, 2.0, 0.5]])
    vals, idx = moe.route(logits, 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 4)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2, 4, 3]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_capacity_is_the_reference():
    for args in [(16, 8, 2, 4.0), (256, 40, 8, 1.25), (256, 384, 8, 1.0),
                 (4, 384, 8, 1.0), (1024, 16, 4, 0.25)]:
        assert moe.moe_capacity(*args) == jmoe.moe_capacity(*args)


# -- the reduced models --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    # traced once, a few times faster than the eager call; XLA fuses the
    # sampler's float ops, so a few draws differ from the eager ones in
    # the last bit (7e-9): the same init, handed to both packages
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jget_arch(arch).reduced)


@functools.lru_cache(maxsize=None)
def _wired(arch):
    """(reference takum8 wire params, port params, the reference's audit
    line) of the reduced config."""
    cfg = get_arch(arch).reduced
    # traced once (the audit line prints while tracing; the eager call
    # gives the same words, several times slower)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jp = jax.jit(lambda p: jquantize(p, "takum8", mode="wire"))(
            _ref_params(arch))
    return jp, params_from_numpy(_to_numpy(jp), cfg, "cpu"), out.getvalue()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)) and not (
            isinstance(tree, tuple) and len(tree) == 2
            and isinstance(tree[1], str)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_quantize_weights_wire_audit_and_words(capsys):
    arch = "granite-moe-3b-a800m"
    cfg = get_arch(arch).reduced
    jp, _, jline = _wired(arch)
    ref_np = _to_numpy(_ref_params(arch))
    tp = quantize_weights(params_from_numpy(ref_np, cfg, "cpu"), "takum8",
                          mode="wire")
    line = capsys.readouterr().out
    counts = re.compile(r"\]: (\d+) wired, (\d+) fake-quantised, (\d+) "
                        r"skipped, (\d+) non-matrix")
    assert counts.search(line).groups() == counts.search(jline).groups()
    assert counts.search(jline).groups() == ("4", "4", "5", "0")
    want = dict(_leaves(_to_numpy(jp)))
    got = dict(_leaves(params_to_numpy(tp, cfg)))
    assert want.keys() == got.keys()
    for path, w in want.items():
        g = got[path]
        if isinstance(w, tuple):        # wire words, bit for bit
            assert g[1] == w[1]
            np.testing.assert_array_equal(g[0], w[0])
        else:                           # fake-quant and untouched leaves
            np.testing.assert_array_equal(g.view(np.uint32),
                                          w.view(np.uint32), err_msg=path)
    moe_leaves = [p for p in want if "moe" in p]
    assert len(moe_leaves) == 4


@pytest.mark.parametrize("fmt", ["takum8", "posit8"])
def test_quantize_weights_slices_and_in_place(fmt, monkeypatch):
    """A stacked leaf rounded a slice of its expert axis at a time (here 3
    experts a slice), and written in place, gives the bits of the whole
    leaf rounded at once (linear takum: with the whole stack's exponent)."""
    from repro_torch.serve import engine
    cfg = get_arch("kimi-k2-1t-a32b").reduced
    tree = _to_numpy(_ref_params("kimi-k2-1t-a32b"))
    whole = quantize_weights(params_from_numpy(tree, cfg, "cpu"), fmt,
                             verbose=False)
    monkeypatch.setattr(engine, "_SLICE", 3 * 64 * 64)
    sliced = quantize_weights(params_from_numpy(tree, cfg, "cpu"), fmt,
                              verbose=False)
    mine = params_from_numpy(tree, cfg, "cpu")
    stacks = [layer["moe"]["experts_w2"] for layer in mine["layers"]]
    inplace = quantize_weights(mine, fmt, verbose=False, in_place=True)
    assert all(layer["moe"]["experts_w2"] is t
               for layer, t in zip(inplace["layers"], stacks))
    for tree_ in (sliced, inplace):
        a = dict(_leaves(params_to_numpy(whole, cfg)))
        b = dict(_leaves(params_to_numpy(tree_, cfg)))
        for path in a:
            np.testing.assert_array_equal(a[path].view(np.uint32),
                                          b[path].view(np.uint32))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    cfg = get_arch(arch).reduced
    want = _to_numpy(_wired(arch)[0])
    got = params_to_numpy(params_from_numpy(want, cfg, "cpu"), cfg)
    a, b = dict(_leaves(want)), dict(_leaves(got))
    assert a.keys() == b.keys()
    for path in a:
        x, y = a[path], b[path]
        if isinstance(x, tuple):
            assert x[1] == y[1]
            x, y = x[0], y[0]
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert set(got["groups"][0]["b0"]["moe"]) == {
        "router", "experts_wg", "experts_w1", "experts_w2"}


def _cfgs(arch, kv="takum8"):
    return (dataclasses.replace(jget_arch(arch).reduced, kv_quant=kv),
            dataclasses.replace(get_arch(arch).reduced, kv_quant=kv))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_and_step_logits(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp, _ = _wired(arch)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in PLENS]
    jeng = JServeEngine(jp, jcfg, max_len=48, page_size=16)
    teng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
    for label in ("cold", "warm"):
        want = jeng.generate(prompts, max_new=4)
        got = teng.generate(prompts, max_new=4)
        assert got == want, (arch, label)
    assert teng.scheduler().pool.stats().prefix_hit_tokens > 0

    # a right-padded prefill chunk (13 tokens of 16), through the
    # reference engine's own compiled chunk step
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

    # one packed decode step (one MoE group of all 8 slots, 7 of them idle
    # on the scratch page) over each engine's own pool
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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    cfg = get_arch(arch).reduced
    jcfg = jget_arch(arch).reduced
    jparams = _ref_params(arch)
    tp = params_from_numpy(_to_numpy(jparams), cfg, "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jlogits, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                   jcfg)
    logits, aux = model.forward(tp, {"tokens": torch.from_numpy(tokens)
                                     .long()}, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    batch = {"tokens": tokens, "labels": labels}
    jloss, jm = jmodel.loss_fn(jparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, jcfg)
    loss, m = model.loss_fn(tp, {k: torch.from_numpy(v).long()
                                 for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=TOL,
                               atol=TOL)


def test_scheduler_refuses_other_families():
    from repro.models import transformer as jtr
    from repro_torch.models import transformer
    for fam, ok, kw in (("dense", True, {}), ("moe", True, {}),
                        ("rwkv6", False, {}), ("hybrid_rglru", False, {}),
                        ("encdec", False, {}),
                        ("vlm", False, {"cross_attn_every": 3})):
        cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").reduced,
                                  family=fam, **kw)
        jcfg = dataclasses.replace(
            jget_arch("granite-moe-3b-a800m").reduced, family=fam, **kw)
        assert transformer.paged_supported(cfg) is ok
        assert jtr.paged_supported(jcfg) is ok
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").reduced,
                              family="rwkv6")
    with pytest.raises(ValueError, match="attention-only layer plan"):
        model.init_paged_cache(cfg, 2, 4, 16, 2, device="cpu")


# -- head dim 112 ----------------------------------------------------------------

HD = 112


def _words(rng, shape, n):
    x = rng.normal(size=shape).astype(np.float32)
    return np.array(jtakum.float_to_takum(jnp.asarray(x), n))


@pytest.mark.parametrize("n,pos,window", [(8, 21, 0), (16, 35, 12)])
def test_hd112_contiguous_attention_matches_reference_kernel(n, pos, window):
    rng = np.random.default_rng(40 + n)
    b, tq, hkv, g, tmax = 2, 5, 2, 2, 40
    q = rng.normal(size=(b, tq, hkv * g, HD)).astype(np.float32)
    kw = _words(rng, (b, tmax, hkv, HD), n)
    vw = _words(rng, (b, tmax, hkv, HD), n)
    start = np.array([0, 3], np.int32)
    kwargs = dict(pos=pos, start=start, window=window, block=16)
    want = np.asarray(jops.takum_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), n, f"takum{n}",
        use_kernel=True, interpret=True, **kwargs))
    got = ops.takum_attention(torch.from_numpy(q), torch.from_numpy(kw),
                              torch.from_numpy(vw), n, f"takum{n}",
                              **kwargs).numpy()
    valid = (pos + np.arange(tq))[None, :] >= start[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=2e-5)


NAR16 = 1 << 15
# name -> (pos, start, the NaR V words (table row, page column, offset,
# head, dim))
HD112_CASES = {
    "plain": ([63, 37, 20, 900], [0, 5, 3, 0], []),
    "all_masked": ([60, 37, 20, 0], [0, 40, 0, 0], []),
    "nar_v_masked": ([63, 37, 20, 0], [0, 0, 0, 0], [(1, 2, 10, 1, 3)]),
}


@functools.lru_cache(maxsize=None)
def _hd112_case(name):
    pos, start, nars = HD112_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    npool, ps, hkv, g, npg, b = 11, 16, 2, 2, 4, 4
    kw = _words(rng, (npool, ps, hkv, HD), 16)
    vw = _words(rng, (npool, ps, hkv, HD), 16)
    perm = rng.permutation(np.arange(1, npool))
    table = np.zeros((b, npg), np.int32)
    table[0], table[1] = perm[:npg], perm[npg:2 * npg]
    table[2, :2] = perm[8:10]
    for row, col, off, head, dim in nars:
        vw[table[row, col], off, head, dim] = NAR16
    q = rng.normal(size=(b, 1, hkv * g, HD)).astype(np.float32)
    pos, start = np.array(pos, np.int32), np.array(start, np.int32)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        "takum16", pos=jnp.asarray(pos), start=jnp.asarray(start),
        use_kernel=True, interpret=True))
    return q, kw, vw, table, pos, start, want


@pytest.mark.parametrize("pk", [None, 5, kattn.paged_partition_keys(HD, 16)])
@pytest.mark.parametrize("name", list(HD112_CASES))
def test_hd112_paged_attention_matches_reference_kernel(name, pk):
    q, kw, vw, table, pos, start, want = _hd112_case(name)
    got = ref.paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kw), torch.from_numpy(vw),
        torch.from_numpy(table), "takum16", pos=torch.from_numpy(pos),
        start=torch.from_numpy(start), partitions=pk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    if name == "nar_v_masked":       # p = 0 at the masked key, 0 x NaN
        assert np.isnan(got[1, 0, 2:, 3]).all()
        assert int(np.isnan(got).sum()) == 2
    if name == "all_masked":         # V averaged over the visited keys
        assert np.isfinite(got[1]).all()


def test_hd112_partition_plan_covers_the_band():
    pk = kattn.paged_partition_keys(HD, 8)
    assert pk == 64
    plans = kattn.paged_partitions([76, 520, 1023, 4000], 256, 5, 0, pk)
    assert [len(r) for r in plans] == [4, 12, 16, 20]
    for p, ranges in zip([76, 520, 1023, 4000], plans):
        keys = [k for k0, k1 in ranges for k in range(k0, k1)]
        assert keys == list(range((min(p // 256, 4) + 1) * 256))
