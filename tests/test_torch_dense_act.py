"""The port's dense configs with relu2 and gelu MLPs against the JAX
package, on the CPU.

* ``layers.mlp`` for relu2 (relu(x @ w1)^2 @ w2) and gelu (gelu(x @ w1)
  @ w2, GELU's tanh approximation as ``jax.nn.gelu``'s default) within
  ``MLP_TOL`` of the reference's, f32.
* The reduced minitron-4b and nemotron-4-340b (relu2) and starcoder2-15b
  (gelu), the reference's ``model.init`` weights as takum8 wire words,
  through both engines' paged schedulers with a takum8 KV cache (the
  config's own float cache: tests/test_torch_dense_hd.py): greedy tokens
  identical, prefix tree cold and warm; a right-padded prefill chunk's
  logits (the reference engine's own compiled chunk) and, for the gelu
  and one relu2 config, one packed decode step's logits within 1e-4; the ``quantize_weights(mode="wire")``
  audit line equal to the reference's and every leaf bit for bit.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine, quantize_weights
from test_torch_rglru import COUNTS, _jquantize, _same_leaves, _to_numpy

ARCHS = ("minitron-4b", "starcoder2-15b", "nemotron-4-340b")
PLENS = (16, 9, 4, 13)
MLP_TOL = 1e-6
LOGITS_TOL = 1e-4


# -- the MLPs ------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu2", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(len(act))
    d, f = 48, 96
    p = {"w1": rng.normal(size=(d, f)).astype(np.float32) * d ** -0.5,
         "w2": rng.normal(size=(f, d)).astype(np.float32) * f ** -0.5}
    x = rng.normal(size=(2, 5, d)).astype(np.float32) * 2
    want = np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act))
    got = L.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=MLP_TOL, atol=MLP_TOL)
    gen = torch.Generator().manual_seed(0)
    assert set(L.mlp_init(gen, d, f, act, device="cpu")) == {"w1", "w2"}


# -- the reduced models ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jget_arch(arch).reduced)


@functools.lru_cache(maxsize=None)
def _wired(arch):
    """(reference takum8 wire params, port params, the reference's audit
    line) of the reduced config."""
    jp, line = _jquantize(_ref_params(arch), "takum8", "wire")
    return jp, params_from_numpy(_to_numpy(jp), get_arch(arch).reduced,
                                 "cpu"), line


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_weights_wire_audit_and_words(arch, capsys):
    cfg = get_arch(arch).reduced
    jp, _, jline = _wired(arch)
    tp = quantize_weights(params_from_numpy(_to_numpy(_ref_params(arch)),
                                            cfg, "cpu"), "takum8",
                          mode="wire")
    line = capsys.readouterr().out
    assert COUNTS.search(line).groups() == COUNTS.search(jline).groups()
    # wq wk wv wo w1 w2 wired: two MLP matrices, no wg
    assert COUNTS.search(jline).groups()[0] == "6"
    assert "wg" not in tp["layers"][0]["mlp"]
    _same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_tokens_and_logits(arch):
    check_scheduler(arch, "takum8")


def check_scheduler(arch, kv):
    """``arch``'s reduced config, takum8 wire weights and a ``kv`` cache,
    through both engines' schedulers: tokens, a chunk's logits and (for a
    wire cache) a packed decode step's logits."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced, kv_quant=kv)
    cfg = dataclasses.replace(get_arch(arch).reduced, kv_quant=kv)
    jp, tp, _ = _wired(arch)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in PLENS]
    jeng = JServeEngine(jp, jcfg, max_len=48, page_size=16)
    teng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
    for label in ("cold", "warm"):
        assert teng.generate(prompts, max_new=4) == \
            jeng.generate(prompts, max_new=4), (arch, kv, label)
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
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    if kv == "none" or arch == "minitron-4b":
        return       # minitron's relu2 step: nemotron's check covers it
    # one packed decode step over each engine's own pool (slot 0 live, the
    # other 7 idle on the scratch page)
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
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
