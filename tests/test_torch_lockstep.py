"""The port's lockstep generation and uncached forward against the JAX
package, on the CPU.

The reduced phi3-medium-14b config with the reference's ``model.init``
weights (PRNGKey 0), quantised by the reference's ``quantize_weights``
where the weights are wire words and carried over with
``convert.params_from_numpy``. Checked:

* ``generate_lockstep`` at temperature 0 gives the JAX engine's tokens
  for a left-padded batch of unequal prompts: takum8 wire weights with a
  takum8 KV cache; takum8 weights with the float cache; and lns-takum8
  weights with an lns-takum8 cache, the port's encodes replaying the
  reference's words (as tests/test_torch_lns_serve.py does, the
  reference's LNS matmul on its kernel in interpret mode);
* an equal-length batch of 2048-token prompts, whose prefill takes the
  fresh branch (``_sdpa_chunked`` over the current k/v), gives the JAX
  engine's tokens, and ``_sdpa_chunked`` itself agrees with the JAX
  function within ``CHUNKED_ATOL``, the causal skip on and off;
* ``model.prefill`` and the uncached ``model.forward`` (under the causal
  mask, and chunked from 2048 tokens) agree with the reference's logits
  within ``LOGITS_TOL``; ``causal_mask`` equals the reference's;
* the port's scheduler gives the port's solo lockstep tokens;
* ``generate`` runs lockstep at temperature > 0 (draws fixed by the
  engine's seed) and beside pending ``submit``ed requests;
* NaR V words in the left padding change no real row: the batch's
  logits and tokens equal those of clean padding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels.ops import WireMatrix as JWireMatrix
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import quantize_weights as jquantize
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import model
from repro_torch.serve.engine import CACHE_SLACK, ServeEngine
from test_torch_lns_serve import forced_to, reference_on_its_kernel

PLENS = (16, 9, 4, 13)
# logits of two f32 implementations summing in other orders, then takum
# rounding of the K/V words (as tests/test_torch_serve.py)
LOGITS_TOL = 1e-4
# _sdpa_chunked of both packages on N(0, 1) inputs: sums of 2048 terms
# in other orders (measured: at most 6e-7)
CHUNKED_ATOL = 1e-5


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda leaf: ((np.asarray(leaf.words), leaf.spec.name)
                      if isinstance(leaf, JWireMatrix) else np.asarray(leaf)),
        tree, is_leaf=lambda leaf: isinstance(leaf, JWireMatrix))


@pytest.fixture(scope="module")
def ref_params():
    return jmodel.init(jax.random.PRNGKey(0),
                       jget_arch("phi3-medium-14b").reduced)


_WIRED = {}


def wired(ref_params, fmt):
    """(reference params, port params); ``fmt`` None: float weights."""
    if fmt not in _WIRED:
        cfg = get_arch("phi3-medium-14b").reduced
        jp = ref_params if fmt is None else jax.jit(
            lambda p: jquantize(p, fmt, mode="wire", verbose=False))(
                ref_params)
        _WIRED[fmt] = (jp, params_from_numpy(_to_numpy(jp), cfg, "cpu"))
    return _WIRED[fmt]


def _cfgs(kv):
    return (dataclasses.replace(jget_arch("phi3-medium-14b").reduced,
                                kv_quant=kv),
            dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                                kv_quant=kv))


def _prompts(vocab, lens=PLENS, seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, n))) for n in lens]


def _ints(outs):
    return [[int(t) for t in o] for o in outs]


@pytest.mark.parametrize("wfmt,kv", [("takum8", "takum8"),
                                     ("takum8", "none"),
                                     ("takum16", "takum16")])
def test_lockstep_tokens_equal_the_reference(ref_params, wfmt, kv):
    """A left-padded batch of unequal prompts, 6 new tokens each."""
    jcfg, cfg = _cfgs(kv)
    jp, tp = wired(ref_params, wfmt)
    prompts = _prompts(cfg.vocab)
    want = JServeEngine(jp, jcfg, max_len=48).generate_lockstep(prompts, 6)
    eng = ServeEngine(tp, cfg, max_len=48, device="cpu")
    assert eng.generate_lockstep(prompts, 6) == _ints(want)
    assert eng._sched is None          # lockstep builds no scheduler


def test_lockstep_lns_takum8_replaying_the_reference_words(ref_params):
    """lns-takum8 weights and KV: the port's encodes replay the words the
    reference's lockstep encoded (its LNS matmul on its kernel), in call
    order, each within the tolerances of tests/test_torch_lns_serve.py;
    the tokens are the reference's. Equal lengths: the replay compares
    every encoded input, and the rows of left-padding queries are
    garbage on every path (they differ between the packages)."""
    jcfg, cfg = _cfgs("lns-takum8")
    jp, tp = wired(ref_params, "lns-takum8")
    prompts = _prompts(cfg.vocab, (9, 9))
    with reference_on_its_kernel() as calls:
        want = JServeEngine(jp, jcfg, max_len=32).generate_lockstep(
            prompts, 3)
    eng = ServeEngine(tp, cfg, max_len=32, device="cpu")
    with forced_to(calls):
        got = eng.generate_lockstep(prompts, 3)
    assert got == _ints(want)


def test_fresh_prefill_branch_at_2048_tokens(ref_params):
    """Two 2048-token prompts (no padding): the prefill attends through
    ``_sdpa_chunked`` over the current k/v while the words go to the
    cache; the tokens are the JAX engine's."""
    jcfg, cfg = _cfgs("takum8")
    jp, tp = wired(ref_params, "takum8")
    prompts = _prompts(cfg.vocab, (L.ATTN_CHUNK_T, L.ATTN_CHUNK_T), seed=5)
    calls = []
    orig = L._sdpa_chunked

    def counted(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    L._sdpa_chunked = counted
    try:
        eng = ServeEngine(tp, cfg, max_len=64, device="cpu")
        got = eng.generate_lockstep(prompts, 2)
    finally:
        L._sdpa_chunked = orig
    assert len(calls) == cfg.n_layers     # the prefill, one a layer
    want = JServeEngine(jp, jcfg, max_len=64).generate_lockstep(prompts, 2)
    assert got == _ints(want)


@pytest.mark.parametrize("causal_skip,window", [(False, 0), (True, 0),
                                                (True, 300)])
def test_sdpa_chunked_matches_the_reference(causal_skip, window):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 2 * L.QC, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2 * L.QC, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2 * L.QC, 2, 16)).astype(np.float32)
    kw = dict(window=window, causal_skip=causal_skip)
    want = np.asarray(JL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw))
    got = L._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHUNKED_ATOL)


def test_causal_mask_equals_the_reference():
    for args in ((5, 9, 4, 0), (7, 7, 0, 3), (3, 12, 9, 5)):
        np.testing.assert_array_equal(L.causal_mask(*args).numpy(),
                                      np.asarray(JL.causal_mask(*args)))


@pytest.mark.parametrize("t", [12, L.ATTN_CHUNK_T])
def test_uncached_forward_matches_the_reference(ref_params, t):
    """``model.forward`` without a cache: the masked attention below 2048
    tokens, the chunked one at 2048."""
    jcfg, cfg = _cfgs("none")
    jp, tp = wired(ref_params, None)
    tokens = np.asarray(_prompts(cfg.vocab, (t, t), seed=8), np.int32)
    want, _ = jax.jit(lambda p, x: jmodel.forward(p, {"tokens": x}, jcfg))(
        jp, jnp.asarray(tokens))
    got, aux = model.forward(tp, {"tokens": torch.from_numpy(tokens).long()},
                             cfg)
    assert got.shape == (2, t, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_prefill_logits_match_the_reference(ref_params):
    """``model.prefill`` of a left-padded batch: last-position logits."""
    jcfg, cfg = _cfgs("takum8")
    jp, tp = wired(ref_params, "takum8")
    prompts = _prompts(cfg.vocab)
    plen = max(PLENS)
    tokens = np.zeros((4, plen), np.int32)
    start = np.zeros(4, np.int32)
    for i, p in enumerate(prompts):
        tokens[i, plen - len(p):] = p
        start[i] = plen - len(p)
    jcache = jmodel.init_cache(jcfg, batch=4, max_len=32, start=start)
    want, _ = jax.jit(lambda p, x, c: jmodel.prefill(p, x, jcfg, c))(
        jp, jnp.asarray(tokens), jcache)
    cache = model.init_cache(cfg, 4, 32, device="cpu", start=start)
    eng = ServeEngine(tp, cfg, max_len=32, device="cpu")
    got, cache = model.prefill(eng.params, torch.from_numpy(tokens).long(),
                               cfg, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    assert cache[0]["pos"] == plen


def test_scheduler_equals_solo_lockstep(ref_params):
    """The port's continuous batching (greedy) gives the port's solo
    lockstep tokens for every request."""
    _, cfg = _cfgs("takum8")
    _, tp = wired(ref_params, "takum8")
    prompts = _prompts(cfg.vocab, (16, 9, 4, 13, 21), seed=6)
    eng = ServeEngine(tp, cfg, max_len=48, page_size=8, decode_batch=3,
                      device="cpu")
    got = eng.generate(prompts, 5)
    assert eng._sched is not None
    assert got == [eng.generate_lockstep([p], 5)[0] for p in prompts]


def test_generate_routes_to_lockstep(ref_params):
    """Temperature > 0: lockstep, the draws fixed by ``seed``; pending
    ``submit``ed requests: this call lockstep, theirs undisturbed."""
    _, cfg = _cfgs("takum8")
    _, tp = wired(ref_params, "takum8")
    prompts = _prompts(cfg.vocab)
    outs = [ServeEngine(tp, cfg, max_len=48, temperature=0.9, seed=s,
                        device="cpu").generate(prompts, 5) for s in (1, 1, 2)]
    assert outs[0] == outs[1] and outs[0] != outs[2]
    assert all(o[:len(p)] == p and len(o) == len(p) + 5
               and all(0 <= t < cfg.vocab for t in o[len(p):])
               for o, p in zip(outs[0], prompts))
    eng = ServeEngine(tp, cfg, max_len=48, page_size=8, device="cpu")
    rid = eng.submit(prompts[0], 4)
    got = eng.generate(prompts[1:], 4)
    assert eng.status(rid) == "queued"          # its stream is untouched
    assert got == eng.generate_lockstep(prompts[1:], 4)
    list(eng.run())
    assert eng.result(rid) == eng.generate_lockstep(prompts[:1], 4)[0]


@pytest.mark.parametrize("kv", ["takum8", "none"])
def test_nar_in_left_padding_reaches_no_real_row(ref_params, kv):
    """A left-padded batch whose padding positions hold NaR V words (NaN
    for the float cache) in every layer: the prefill's last logits, every
    decode step's logits and the tokens equal those of clean padding."""
    _, cfg = _cfgs(kv)
    _, tp = wired(ref_params, "takum8")
    eng = ServeEngine(tp, cfg, max_len=48, device="cpu")
    prompts = _prompts(cfg.vocab)
    plen = max(PLENS)
    tokens = torch.zeros((4, plen), dtype=torch.long)
    start = np.zeros(4, np.int32)
    for i, p in enumerate(prompts):
        tokens[i, plen - len(p):] = torch.tensor(p)
        start[i] = plen - len(p)
    runs = []
    for poison in (False, True):
        cache = model.init_cache(cfg, 4, plen + 4 + CACHE_SLACK,
                                 device="cpu", start=start)
        orig = L.ops.kv_append

        def append(k, v, kc, vc, spec, *, pos, table=None):
            orig(k, v, kc, vc, spec, pos=pos, table=table)
            if poison and table is None:
                for i, s in enumerate(start):
                    nar = (float("nan") if spec.is_identity
                           else spec.nar_word)
                    vc[i, :s] = nar
        L.ops.kv_append = append
        try:
            logits, cache = model.prefill(eng.params, tokens, cfg, cache)
            steps = [logits]
            tok = logits.argmax(-1)[:, None]
            for s in range(4):
                logits, cache = model.decode_step(eng.params, tok, cfg,
                                                  cache, pos=plen + s)
                steps.append(logits)
                tok = logits.argmax(-1)[:, None]
        finally:
            L.ops.kv_append = orig
        runs.append(torch.stack(steps))
    assert torch.isfinite(runs[1]).all()
    assert torch.equal(runs[0], runs[1])
