"""The port serving the posit baseline against the JAX package, on the CPU.

The reduced phi3-medium-14b config with the reference's ``model.init``
weights (PRNGKey 0), quantised by the reference's
``quantize_weights(mode="wire")`` to posit8 or posit16 words and carried
over with ``convert.params_from_numpy``, served by both ``ServeEngine``s
on the prompts of tests/test_torch_serve.py (lengths 16, 9, 4, 13; page
size 16), with {posit8 weights, posit8 KV}, {posit16, posit16} and
{posit16, takum8}:

* ``generate`` at temperature 0 gives token-identical streams, prefix
  tree cold and warm, with equal ``PageStats``;
* ``prefill_chunk`` and ``decode_step`` logits agree within
  ``rtol=1e-4, atol=1e-4``: posit weights are decoded, not re-quantised,
  so only f32 sums in another order and the K/V rounding separate them
  (the tolerance and reason of tests/test_torch_serve.py);
* layer 0's K/V words are the reference's or, for a value at a rounding
  boundary reached through another f32 sum order, its neighbour (posit
  words order like two's complement), at most 1% of them.
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
from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.bitops import carrier
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine

PLENS = (16, 9, 4, 13)
COMBOS = [("posit8", "posit8"), ("posit16", "posit16"), ("posit16", "takum8")]


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda leaf: ((np.asarray(leaf.words), leaf.spec.name)
                      if isinstance(leaf, JWireMatrix) else np.asarray(leaf)),
        tree, is_leaf=lambda leaf: isinstance(leaf, JWireMatrix))


@pytest.fixture(scope="module")
def wired():
    """weight format -> (reference wire params, port params)."""
    ref_params = jmodel.init(jax.random.PRNGKey(0),
                             jget_arch("phi3-medium-14b").reduced)
    cfg = get_arch("phi3-medium-14b").reduced
    out = {}
    for fmt in ("posit8", "posit16"):
        jp = jax.jit(lambda p, f=fmt: jquantize(p, f, mode="wire",
                                                 verbose=False))(ref_params)
        out[fmt] = (jp, params_from_numpy(_to_numpy(jp), cfg, "cpu"))
    return out


def _words(t, n):
    return carrier(t).numpy().astype(np.int64) & ((1 << n) - 1)


@pytest.mark.parametrize("wfmt,kv", COMBOS)
def test_generate_tokens_and_step_logits(wired, wfmt, kv):
    jcfg = dataclasses.replace(jget_arch("phi3-medium-14b").reduced,
                               kv_quant=kv)
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              kv_quant=kv)
    jp, tp = wired[wfmt]
    assert tp["layers"][0]["attn"]["wq"].spec.name == wfmt
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in PLENS]
    jeng = JServeEngine(jp, jcfg, max_len=48, page_size=16)
    teng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
    for label in ("cold", "warm"):
        want = jeng.generate(prompts, max_new=4)
        got = teng.generate(prompts, max_new=4)
        assert got == want, (wfmt, kv, label)
    assert (dataclasses.asdict(teng.scheduler().pool.stats())
            == dataclasses.asdict(jeng.scheduler().pool.stats()))
    assert teng.scheduler().pool.stats().prefix_hit_tokens > 0

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
    n = formats.get(kv).n
    for key in ("k", "v"):
        want = np.asarray(jcache[0]["b0"]["attn"][key][0, :, :13]
                          ).astype(np.int64)
        got = _words(cache[0][key][:, :13], n)
        step = (got - want) % (1 << n)
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
