"""The port serving on logarithmic takums against the JAX package, on the
CPU: lns-takum8 weights here, lns-takum16 weights in
tests/test_torch_lns16_serve.py (the same checks, in a file of its own so
that each file stays well under 90 s).

The reduced phi3-medium-14b config with the reference's ``model.init``
weights (PRNGKey 0), quantised by the reference's
``quantize_weights(mode="wire")`` and carried over with
``convert.params_from_numpy``, served with an lns-takum8, lns-takum16 or
takum8 KV cache by both ``ServeEngine``s on the prompts of
tests/test_torch_serve.py (lengths 16, 9, 4, 13; page size 16).

Checked:

* ``generate`` at temperature 0 gives token-identical streams, prefix
  tree cold and warm (the reference on its CPU path, which is its oracle
  ``lns_qmatmul_ref``: decode x and w to f32, then a dot);
* ``prefill_chunk`` and ``decode_step`` logits agree within
  ``rtol=atol=1e-4`` against the reference on its kernel
  (``lns_matmul_kernel_call`` in interpret mode, the arithmetic the
  port's plain version follows: one ``exp`` of each product's ``ell``
  sum), with the reference's words forced in where they differ, and
  layer 0's K/V words in the cache are the reference's.

Why the words are forced. Every projection encodes its input to the LNS
grid and every layer encodes its K/V. Two implementations whose logs,
exps and sums differ by an ulp put an input that lies within an ulp of a
rounding boundary on either side of it, and the word moves to its
neighbour: one grid step, 6% of the value at lns-takum8 and 0.02% at
lns-takum16 near |x| = 1 (an input near zero, left by cancellation, can
move a few steps). At lns-takum16 that happens a few times per forward
pass of this model, and later layers spread it: free-running, the logits
differ by up to 4e-3, and with lns-takum8 weights and KV one such word in
the decode step moves them by 4e-2. So the port's encode replays the
reference's words, in call order: each call must have the reference's
format and shape and an input within ``INPUT_ATOL`` of the reference's
(the port's arithmetic, given the same words upstream), at most
``FLIP_SHARE`` of a pass's words may differ, and the reference's words
then replace the port's, so the logits are held at 1e-4.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.formats.registry import FormatSpec as JFormatSpec
from repro.kernels import ops as jops
from repro.kernels.ops import WireMatrix as JWireMatrix
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import quantize_weights as jquantize
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.bitops import carrier
from repro_torch.kernels import takum_codec
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine

PLENS = (16, 9, 4, 13)
KVS = ("lns-takum8", "lns-takum16", "takum8")
LOGITS_TOL = 1e-4
# every encoded input agrees with the reference's to this absolute
# tolerance (measured: at most 2.4e-6), and at most this share of a
# forward pass's words is the neighbour of the reference's (measured: at
# most 0.19%, in the decode step with lns-takum16 weights)
INPUT_ATOL = 1e-5
FLIP_SHARE = 0.01


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda leaf: ((np.asarray(leaf.words), leaf.spec.name)
                      if isinstance(leaf, JWireMatrix) else np.asarray(leaf)),
        tree, is_leaf=lambda leaf: isinstance(leaf, JWireMatrix))


def wired_for(fmt):
    """(reference wire params, port params) of the reduced config."""
    ref_params = jmodel.init(jax.random.PRNGKey(0),
                             jget_arch("phi3-medium-14b").reduced)
    cfg = get_arch("phi3-medium-14b").reduced
    jp = jax.jit(lambda p: jquantize(p, fmt, mode="wire",
                                     verbose=False))(ref_params)
    return jp, params_from_numpy(_to_numpy(jp), cfg, "cpu")


@pytest.fixture(scope="module")
def wired8():
    return wired_for("lns-takum8")


@contextlib.contextmanager
def reference_on_its_kernel():
    """The reference's ``WireMatrix`` on ``lns_matmul_kernel_call`` in
    interpret mode, and every ``FormatSpec.encode_tile`` call's input and
    words recorded in execution order. Yields the list of records
    ``(format, x, words)``. The jit caches are cleared on the way in and
    out, so no trace of either path leaks into the other."""
    orig_mm, orig_enc = jops.lns_matmul, JFormatSpec.encode_tile
    calls = []

    def on_kernel(x, w_words, fmt, accum="linear", use_kernel=True,
                  interpret=None, block=None):
        return orig_mm(x, w_words, fmt, accum, True, True, block)

    def recorded(self, x):
        words = orig_enc(self, x)
        if not self.is_identity:
            name = self.name
            jax.debug.callback(lambda a, w: calls.append(
                (name, np.array(a), np.array(w))), x, words, ordered=True)
        return words

    jax.clear_caches()
    jops.lns_matmul, JFormatSpec.encode_tile = on_kernel, recorded
    try:
        yield calls
        jax.effects_barrier()
    finally:
        jops.lns_matmul, JFormatSpec.encode_tile = orig_mm, orig_enc
        jax.clear_caches()


@contextlib.contextmanager
def forced_to(calls):
    """The port's encode replaying the reference's recorded ``calls`` (see
    the module docstring). Yields a dict: ``words`` encoded, ``differ``
    (the port's own word was another) and ``flips``, one ``(call, format,
    words that differ, largest input difference)`` per call with any."""
    orig = takum_codec.encode
    seen = {"words": 0, "differ": 0, "flips": []}
    it = enumerate(calls)

    def replay(x, spec):
        own = orig(x, spec)
        i, (name, ref_x, ref_words) = next(it)
        assert (name, tuple(ref_words.shape)) == (spec.name, tuple(own.shape))
        dx = float((x.reshape(own.shape) - torch.from_numpy(ref_x)
                    ).abs().max())
        assert dx <= INPUT_ATOL, (i, name, dx)
        ref_t = torch.from_numpy(ref_words.astype(np.int64)).to(own.dtype)
        differ = int((carrier(own) != carrier(ref_t)).sum())
        seen["words"] += own.numel()
        seen["differ"] += differ
        if differ:
            seen["flips"].append((i, name, differ, dx))
        return ref_t

    takum_codec.encode = replay
    try:
        yield seen
    finally:
        takum_codec.encode = orig
    assert next(it, None) is None, "the port encoded fewer times"
    assert seen["differ"] <= FLIP_SHARE * seen["words"], seen


def _words(t: torch.Tensor) -> np.ndarray:
    return carrier(t).numpy().astype(np.int64) & 0xFFFF


def check_combo(jp, tp, wfmt, kv):
    """Tokens, layer-0 K/V words and step logits of one (weights, KV)
    combination against the reference (see the module docstring)."""
    jcfg = dataclasses.replace(jget_arch("phi3-medium-14b").reduced,
                               kv_quant=kv)
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              kv_quant=kv)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in PLENS]
    jeng = JServeEngine(jp, jcfg, max_len=48, page_size=16)
    teng = ServeEngine(tp, cfg, max_len=48, page_size=16, device="cpu")
    for label in ("cold", "warm"):
        want = jeng.generate(prompts, max_new=4)
        got = teng.generate(prompts, max_new=4)
        assert got == want, (wfmt, kv, label)
    assert teng.scheduler().pool.stats().prefix_hit_tokens > 0

    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :13] = prompts[3]
    jcache = jmodel.init_cache(jcfg, batch=1, max_len=32)
    with reference_on_its_kernel() as calls:
        jrow, jcache = jeng._prefill_chunk(jp, jnp.asarray(tokens), jcache,
                                           jnp.asarray(0, jnp.int32),
                                           jnp.asarray(12, jnp.int32))
    cache = model.init_cache(cfg, 1, 32, device="cpu")
    with forced_to(calls):
        row, cache = model.prefill_chunk(teng.params,
                                         torch.from_numpy(tokens).long(),
                                         cfg, cache, pos=0, last_idx=12)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    n = int(kv.rsplit("takum", 1)[1])
    for key in ("k", "v"):
        want = np.asarray(jcache[0]["b0"]["attn"][key][0, :, :13]
                          ).astype(np.int64)
        np.testing.assert_array_equal(_words(cache[0][key][:, :13]), want)

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
    with reference_on_its_kernel() as calls:
        jlog, _ = jax.jit(lambda p, t, c, q: jmodel.decode_step(
            p, t, jcfg, c, pos=q))(jp, jnp.asarray(tok), jpool.cache,
                                   jnp.asarray(pos))
    with forced_to(calls):
        log, _ = model.decode_step(teng.params, torch.from_numpy(tok).long(),
                                   cfg, pool.cache, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(log[0].numpy(), np.asarray(jlog)[0],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


@pytest.mark.parametrize("kv", KVS)
def test_lns8_weights_generate_tokens_and_step_logits(wired8, kv):
    check_combo(*wired8, "lns-takum8", kv)
