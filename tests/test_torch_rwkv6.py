"""The port's rwkv6 family (rwkv6-1.6b) against the JAX package, on the
CPU.

* ``models/rwkv6.py``: ``_wkv_chunk`` (from a zero and from a carried
  state), ``rwkv_time_mix`` chunked (with and without a carried state)
  and at T = 1 (the exact recurrence), ``rwkv_channel_mix`` and
  ``_group_norm`` within ``MIX_TOL`` of the reference's, f32: the same
  dataflow, summed in another order.
* The reduced rwkv6-1.6b (3 layers, d 64 in 4 heads of 16), the
  reference's ``model.init`` weights: ``forward`` logits (T padded to
  the chunk and back), and ``prefill`` then ``decode_step`` logits,
  within ``LOGITS_TOL``; ``generate`` (lockstep: the family is not
  ``paged_supported``) with takum8 wire weights gives the JAX engine's
  greedy tokens for left-padded prompts whose lengths are no multiples
  of 64 (both round the batch up to 64; the pads enter the state).
* ``_can_schedule`` is False, and the scheduler and a paged cache are
  refused with the reference's ``ValueError``.
* ``quantize_weights`` (takum8 wire and fake): the reference's audit
  line (``8 wired, 6 fake-quantised, 6 skipped``) and every leaf's words
  or values bit for bit, ``ww`` scaled over its stack; the ``convert``
  round trip.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import model as jmodel
from repro.models import rwkv6 as jrk
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import model, rwkv6, transformer
from repro_torch.serve.engine import ServeEngine, quantize_weights
from test_torch_rglru import COUNTS, _jquantize, _same_leaves, _to_numpy

ARCH = "rwkv6-1.6b"
MIX_TOL = 1e-5      # f32 sums of the same terms in another order
LOGITS_TOL = 1e-4
MAX_NEW = 5


def _cfgs(**kw):
    return (dataclasses.replace(jget_arch(ARCH).reduced, **kw),
            dataclasses.replace(get_arch(ARCH).reduced, **kw))


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  _cfgs()[0])


def _close(got, want, tol=MIX_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# -- the blocks ----------------------------------------------------------------


def _block(rng, d=32, d_ff=48, hd=8):
    """One block's f32 parameters in the reference's layout (numpy)."""
    p = _to_numpy(jrk.rwkv_block_init(jax.random.PRNGKey(int(
        rng.integers(1 << 30))), d, d_ff, hd))
    p["tm"]["gn_scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
    return p


def _state(rng, b, d, hd):
    h = d // hd
    return {"S": rng.normal(size=(b, h, hd, hd)).astype(np.float32),
            "tm_prev": rng.normal(size=(b, d)).astype(np.float32)}


@pytest.mark.parametrize("carried", [False, True])
def test_wkv_chunk_matches_reference(carried):
    rng = np.random.default_rng(11 + carried)
    b, L, h, d = 2, 16, 3, 8
    r, k, v = (rng.normal(size=(b, L, h, d)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(size=(b, L, h, d))).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32) * 0.3
    S = (rng.normal(size=(b, h, d, d)) if carried
         else np.zeros((b, h, d, d))).astype(np.float32)
    jS, jo = jrk._wkv_chunk(jnp.asarray(S), tuple(map(jnp.asarray,
                                                      (r, k, v, logw))),
                            jnp.asarray(u))
    S2, o = rwkv6._wkv_chunk(*map(torch.from_numpy, (S, r, k, v, logw, u)))
    _close(o, jo)
    _close(S2, jS)


@pytest.mark.parametrize("t,carried", [(32, False), (32, True), (1, True)],
                         ids=["chunked", "chunked_carried", "recurrence"])
def test_time_mix_matches_reference(t, carried):
    rng = np.random.default_rng(20 + t + carried)
    d, hd = 32, 8
    p = _block(rng, d=d, hd=hd)
    x = rng.normal(size=(2, t, d)).astype(np.float32)
    st = _state(rng, 2, d, hd) if carried else None
    jout, jst = jax.jit(lambda p, x, st: jrk.rwkv_time_mix(
        p, x, hd, state=st, chunk=16))(_j(p), jnp.asarray(x),
                                       None if st is None else _j(st))
    out, new = rwkv6.rwkv_time_mix(_t(p), torch.from_numpy(x), hd,
                                   state=None if st is None else _t(st),
                                   chunk=16)
    _close(out, jout)
    assert (new is None) == (jst is None)
    if carried:
        _close(new["S"], jst["S"])
        np.testing.assert_array_equal(new["tm_prev"].numpy(),
                                      np.asarray(jst["tm_prev"]))


def test_chunked_requires_whole_chunks():
    rng = np.random.default_rng(3)
    p = _block(rng)
    with pytest.raises(ValueError, match="multiple of chunk"):
        rwkv6.rwkv_time_mix(_t(p), torch.zeros((1, 20, 32)), 8, chunk=16)


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_reference(carried):
    rng = np.random.default_rng(30 + carried)
    p = _block(rng)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    st = ({"cm_prev": rng.normal(size=(2, 32)).astype(np.float32)}
          if carried else None)
    jout, jst = jrk.rwkv_channel_mix(_j(p), jnp.asarray(x),
                                     state=None if st is None else _j(st))
    out, new = rwkv6.rwkv_channel_mix(_t(p), torch.from_numpy(x),
                                      state=None if st is None else _t(st))
    _close(out, jout)
    assert (new is None) == (jst is None)


def test_group_norm_matches_reference():
    rng = np.random.default_rng(4)
    o = rng.normal(size=(2, 5, 4, 16)).astype(np.float32) * 3 + 1
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(rwkv6._group_norm(torch.from_numpy(o), torch.from_numpy(scale),
                             16),
           jrk._group_norm(jnp.asarray(o), jnp.asarray(scale), 16))


# -- the reduced model ---------------------------------------------------------


def test_layer_plan_paging_and_refusals():
    from repro.models import transformer as jtr
    jcfg, cfg = _cfgs()
    assert transformer.layer_plan(cfg) == [
        (tuple(p), r) for p, r in jtr.layer_plan(jcfg)] == [(("rwkv",), 3)]
    assert transformer.paged_supported(cfg) is jtr.paged_supported(jcfg) \
        is False
    with pytest.raises(ValueError, match="attention-only layer plan"):
        model.init_paged_cache(cfg, 2, 4, 16, 2, device="cpu")
    jeng, teng = _engines()
    assert teng._can_schedule(None) is jeng._can_schedule(None) is False
    with pytest.raises(ValueError, match="rwkv6"):
        jeng.scheduler()
    with pytest.raises(ValueError, match="rwkv6"):
        teng.scheduler()
    with pytest.raises(ValueError, match="multiple of 64"):
        model.prefill(teng.params, torch.zeros((1, 40), dtype=torch.long),
                      cfg, model.init_cache(cfg, 1, 48, device="cpu"))


def test_forward_prefill_and_decode_logits():
    """f32 weights: the uncached forward over 70 tokens (padded to 128
    inside), a 64-token prefill and three decode steps."""
    jcfg, cfg = _cfgs()
    jp = _ref_params()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (2, 70)).astype(np.int32)
    jlogits, _ = jax.jit(jmodel.forward, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    logits, aux = model.forward(tp, {"tokens": torch.from_numpy(tokens)
                                     .long()}, cfg)
    assert logits.shape == (2, 70, cfg.vocab) and float(aux) == 0.0
    _close(logits, jlogits, LOGITS_TOL)
    jc = jmodel.init_cache(jcfg, batch=2, max_len=72)
    c = model.init_cache(cfg, 2, 72, device="cpu")
    jrow, jc = jax.jit(lambda p, t, c: jmodel.prefill(p, t, jcfg, c))(
        jp, jnp.asarray(tokens[:, :64]), jc)
    row, c = model.prefill(tp, torch.from_numpy(tokens[:, :64]).long(), cfg,
                           c)
    _close(row, jrow, LOGITS_TOL)
    jstep = jax.jit(lambda p, t, c, q: jmodel.decode_step(p, t, jcfg, c,
                                                          pos=q))
    for s in range(3):
        tok = tokens[:, 64 + s:65 + s]
        jrow, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(64 + s))
        row, c = model.decode_step(tp, torch.from_numpy(tok).long(), cfg, c,
                                   pos=64 + s)
        _close(row, jrow, LOGITS_TOL)
    _close(c[1]["tm"]["S"], jc[0]["b0"]["tm"]["S"][1], LOGITS_TOL)


@functools.lru_cache(maxsize=None)
def _wired(mode="wire"):
    return _jquantize(_ref_params(), "takum8", mode)


@functools.lru_cache(maxsize=None)
def _engines():
    """The two engines on the reduced model, takum8 wire weights."""
    jcfg, cfg = _cfgs()
    jp, _ = _wired()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    return (JServeEngine(jp, jcfg, max_len=64),
            ServeEngine(tp, cfg, max_len=64, device="cpu"))


def test_generate_lockstep_tokens_left_padded():
    """Prompts of 45, 38 and 7 tokens: both packages round the batch up to
    64 and left-pad it; the pads enter the recurrent state."""
    jeng, teng = _engines()
    rng = np.random.default_rng(45)
    prompts = [[int(t) for t in rng.integers(0, 512, n)]
               for n in (45, 38, 7)]
    want = jeng.generate(prompts, max_new=MAX_NEW)
    got = teng.generate(prompts, max_new=MAX_NEW)
    assert got == want
    assert [len(o) for o in got] == [50, 43, 12]
    assert teng._sched is None         # routed past the scheduler


@pytest.mark.parametrize("mode", ["wire", "fake"])
def test_quantize_weights_audit_and_words(mode, capsys):
    jcfg, cfg = _cfgs()
    jp, jline = _wired(mode)
    tp = quantize_weights(params_from_numpy(_to_numpy(_ref_params()), cfg,
                                            "cpu"), "takum8", mode=mode,
                          cfg=cfg)
    line = capsys.readouterr().out
    assert COUNTS.search(line).groups() == COUNTS.search(jline).groups()
    assert COUNTS.search(jline).groups() == (
        ("8", "6", "6", "0") if mode == "wire" else ("0", "14", "6", "0"))
    _same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg))
    raw = _to_numpy(_ref_params())["groups"][0]["b0"]["blk"]["tm"]["ww"]
    assert not np.array_equal(
        params_to_numpy(tp, cfg)["groups"][0]["b0"]["blk"]["tm"]["ww"], raw)


def test_convert_round_trip():
    cfg = _cfgs()[1]
    want = _to_numpy(_wired()[0])
    tp = params_from_numpy(want, cfg, "cpu")
    assert set(tp["layers"][0]) == {"ln1", "ln2", "blk"}
    np.testing.assert_array_equal(
        tp["layers"][2]["blk"]["tm"]["u"].numpy(),
        want["groups"][0]["b0"]["blk"]["tm"]["u"][2])
    _same_leaves(want, params_to_numpy(tp, cfg))
    with pytest.raises(ValueError, match="layer plan"):
        params_from_numpy(want, _cfgs(n_layers=4)[1], "cpu")


def test_port_init_serves_the_family():
    """The port's own ``model.init`` (torch's draws) builds the
    reference's tree shapes, and its engine serves it."""
    jcfg, cfg = _cfgs()
    tp = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.tree_util.tree_map(np.shape, _to_numpy(_ref_params()))
    assert jax.tree_util.tree_map(np.shape, params_to_numpy(tp, cfg)) \
        == shapes
    with contextlib.redirect_stdout(io.StringIO()):
        tp = quantize_weights(tp, "takum8", mode="wire", cfg=cfg)
    out = ServeEngine(tp, cfg, max_len=32, device="cpu").generate(
        [[1, 2, 3], [4]], 3)
    assert [len(o) for o in out] == [6, 4]
