"""The port's vlm family (llama-3.2-vision-11b) against the JAX package,
on the CPU, and the two faults of this family that the port had.

* Fault 1 (``paged_supported`` said True for a vlm config, which the
  port planned as dense): the port plans the reference's
  ``[(("cross", "self", "self", "self", "self"), 1)]``, answers False,
  and the scheduler and a paged cache refuse the family with the
  reference's ``ValueError``.
* Fault 2 (lockstep passed ``start`` only for ``paged_supported``
  families): left-padded prompts with media and a takum8 cache give the
  JAX engine's greedy tokens; a left-padded text-only prefill (the cross
  block attends the whole prompt, pads included, unmasked) and its decode
  steps give the reference's logits.
* ``layers.attention(xa=)`` (K/V from the media, no RoPE) and the
  ``cross`` block within ``BLOCK_TOL`` of the reference's, with media and
  without (the block then attends its own input, unmasked).
* The reduced llama-3.2-vision-11b, the reference's ``model.init``
  weights: ``forward``, ``prefill`` and ``decode_step`` logits with
  media within ``LOGITS_TOL``; ``generate`` with takum8 wire weights;
  the ``quantize_weights`` audit (``35 wired, 0 fake-quantised, 13
  skipped``) and every word bit for bit; the ``convert`` round trip;
  ``_can_schedule``.
* Text-only left-padded prompts through two cross blocks (a 10-layer
  variant, cross blocks at layers 0 and 5; takum8 and float caches): the
  rows before ``start`` mask every key and take the reference's uniform
  average of V, so the next cross block, which attends the whole prompt
  unmasked, carries the reference's values into every row: prefill
  logits of every row within ``LOGITS_TOL``, lockstep tokens equal. A NaR
  V word in the padding still reaches no row at or after ``start``.
* A variant whose ``d_media`` (48) differs from ``d_model`` (64), so the
  model projects the media through ``embed_media`` (skipped by
  ``quantize_weights``, whose ``"embed"`` entry matches its name, as the
  reference's): logits, the audit and every leaf.
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
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.models import transformer as jtr
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model, transformer
from repro_torch.serve.engine import ServeEngine, quantize_weights
from test_torch_rglru import COUNTS, _jquantize, _same_leaves, _to_numpy

ARCH = "llama-3.2-vision-11b"
BLOCK_TOL = 1e-5    # f32 sums of the same terms in another order
LOGITS_TOL = 1e-4
MAX_NEW = 5
PLENS = (13, 6, 10)


def _cfgs(**kw):
    return (dataclasses.replace(jget_arch(ARCH).reduced, **kw),
            dataclasses.replace(get_arch(ARCH).reduced, **kw))


@functools.lru_cache(maxsize=None)
def _ref_params(d_media=None):
    jcfg = _cfgs()[0] if d_media is None else _cfgs(d_media=d_media)[0]
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)


def _media(cfg, b, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_media_tokens, cfg.d_media or cfg.d_model)).astype(
        np.float32)


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 512, n)] for n in PLENS]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# -- fault 1: the plan and the paged refusals ---------------------------------


def test_plan_is_the_reference_and_paging_is_refused():
    jcfg, cfg = _cfgs(kv_quant="takum8")
    plan = [(tuple(p), r) for p, r in jtr.layer_plan(jcfg)]
    assert plan == [(("cross", "self", "self", "self", "self"), 1)]
    assert transformer.layer_plan(cfg) == plan
    assert transformer.layer_kinds(cfg) == list(plan[0][0])
    assert transformer.paged_supported(cfg) is False
    assert jtr.paged_supported(jcfg) is False
    for n in (10, 40):
        assert transformer.layer_plan(_cfgs(n_layers=n)[1]) == [
            (tuple(p), r) for p, r in jtr.layer_plan(_cfgs(n_layers=n)[0])]
    with pytest.raises(ValueError, match="attention-only layer plan"):
        model.init_paged_cache(cfg, 2, 4, 16, 2, device="cpu")
    jeng, teng = _engines()
    with pytest.raises(ValueError, match="vlm"):
        jeng.scheduler()
    with pytest.raises(ValueError, match="vlm"):
        teng.scheduler()
    with pytest.raises(ValueError, match="vlm"):
        teng.submit([1, 2, 3], 2)
    media = _media(cfg, 1)
    for m in (None, media):
        assert teng._can_schedule(m) is jeng._can_schedule(m) is False


# -- cross-attention ------------------------------------------------------------


def _attn_params(rng, d, h, hkv, hd):
    return {k: (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
            for k, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)),
                             ("wv", (d, hkv * hd)), ("wo", (h * hd, d)))}


def test_cross_attention_matches_reference():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(5)
    p = _attn_params(rng, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    xa = rng.normal(size=(2, 17, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) + 3, (2, 7))
    jout, _ = JL.attention(jax.tree_util.tree_map(jnp.asarray, p),
                           jnp.asarray(x), jcfg, jnp.asarray(pos),
                           xa=jnp.asarray(xa))
    out, cache = L.attention({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg, torch.from_numpy(
                                 pos.copy()), xa=torch.from_numpy(xa))
    assert cache is None
    _close(out, jout, BLOCK_TOL)
    # no RoPE on cross-attention: the positions change nothing
    out2, _ = L.attention({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), cfg,
                          torch.zeros((2, 7), dtype=torch.long),
                          xa=torch.from_numpy(xa))
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


@pytest.mark.parametrize("with_media", [True, False], ids=["media", "none"])
def test_cross_block_matches_reference(with_media):
    jcfg, cfg = _cfgs()
    tree = _to_numpy(_ref_params())["groups"][0]["b0"]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree)
    tp = params_from_numpy(_to_numpy(_ref_params()), cfg, "cpu")["layers"][0]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    media = _media(cfg, 2, seed=6) if with_media else None
    pos = np.broadcast_to(np.arange(9), (2, 9))
    jx, _, _ = jtr._block_apply(jp, jnp.asarray(x), jcfg, "cross",
                                jnp.asarray(pos), media=None if media is None
                                else jnp.asarray(media))
    tx, aux, cache = transformer._block(
        tp, torch.from_numpy(x), cfg, torch.from_numpy(pos.copy()), cache={},
        kind="cross", media=None if media is None
        else torch.from_numpy(media))
    assert aux is None and cache == {}
    _close(tx, jx, BLOCK_TOL)


# -- the reduced model ----------------------------------------------------------


def test_forward_prefill_and_decode_logits():
    """f32 weights, a float cache, media: the uncached forward, a 12-token
    prefill and three decode steps (no media, as lockstep's)."""
    jcfg, cfg = _cfgs()
    jp = _ref_params()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (2, 15)).astype(np.int32)
    media = _media(cfg, 2, seed=7)
    jlogits, _ = jax.jit(jmodel.forward, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens), "media": jnp.asarray(media)},
        jcfg)
    logits, _ = model.forward(tp, {"tokens": torch.from_numpy(tokens).long(),
                                   "media": torch.from_numpy(media)}, cfg)
    _close(logits, jlogits, LOGITS_TOL)
    jc = jmodel.init_cache(jcfg, batch=2, max_len=16)
    c = model.init_cache(cfg, 2, 16, device="cpu")
    assert c[0] == {} and "k" in c[1]
    jrow, jc = jax.jit(lambda p, t, c, m: jmodel.prefill(p, t, jcfg, c,
                                                         media=m))(
        jp, jnp.asarray(tokens[:, :12]), jc, jnp.asarray(media))
    row, c = model.prefill(tp, torch.from_numpy(tokens[:, :12]).long(), cfg,
                           c, media=torch.from_numpy(media))
    _close(row, jrow, LOGITS_TOL)
    jstep = jax.jit(lambda p, t, c, q: jmodel.decode_step(p, t, jcfg, c,
                                                          pos=q))
    for s in range(3):
        tok = tokens[:, 12 + s:13 + s]
        jrow, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(12 + s))
        row, c = model.decode_step(tp, torch.from_numpy(tok).long(), cfg, c,
                                   pos=12 + s)
        _close(row, jrow, LOGITS_TOL)


@functools.lru_cache(maxsize=None)
def _wired(mode="wire", d_media=None):
    return _jquantize(_ref_params(d_media), "takum8", mode)


@functools.lru_cache(maxsize=None)
def _engines():
    """The two engines on the reduced model: takum8 wire weights and a
    takum8 KV cache."""
    jcfg, cfg = _cfgs(kv_quant="takum8")
    jp, _ = _wired()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    return (JServeEngine(jp, jcfg, max_len=32),
            ServeEngine(tp, cfg, max_len=32, device="cpu"))


def test_generate_left_padded_tokens(monkeypatch):
    """Fault 2: prompts of 13, 6 and 10 tokens left-padded into one
    lockstep batch with media; the port passes their ``start`` as the
    reference does, and gives its tokens."""
    jeng, teng = _engines()
    media = _media(teng.cfg, len(PLENS), seed=8)
    starts = []
    init_cache = model.init_cache

    def spy(*args, **kwargs):
        starts.append(kwargs.get("start"))
        return init_cache(*args, **kwargs)

    monkeypatch.setattr(model, "init_cache", spy)
    want = jeng.generate(_prompts(), max_new=MAX_NEW, media=media)
    got = teng.generate(_prompts(), max_new=MAX_NEW, media=media)
    assert got == want
    assert teng._sched is None
    assert [int(s) for s in starts[0]] == [0, 7, 3]


def test_left_padded_text_prefill_and_steps():
    """Fault 2, text-only: f32 weights, a takum8 cache with the batch's
    ``start``; the prefill of the left-padded prompts and two decode
    steps give the reference's logits."""
    jcfg, cfg = _cfgs(kv_quant="takum8")
    jp = _ref_params()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    plen = max(PLENS)
    tokens = np.zeros((len(PLENS), plen + 2), np.int32)
    for i, p in enumerate(_prompts(3)):
        tokens[i, plen - len(p):plen] = p
    tokens[:, plen:] = [[5, 6], [7, 8], [9, 10]]
    start = np.array([plen - n for n in PLENS], np.int32)
    jc = jmodel.init_cache(jcfg, batch=3, max_len=16, start=start)
    c = model.init_cache(cfg, 3, 16, device="cpu", start=start)
    jrow, jc = jax.jit(lambda p, t, c: jmodel.prefill(p, t, jcfg, c))(
        jp, jnp.asarray(tokens[:, :plen]), jc)
    row, c = model.prefill(tp, torch.from_numpy(tokens[:, :plen]).long(),
                           cfg, c)
    _close(row, jrow, LOGITS_TOL)
    jstep = jax.jit(lambda p, t, c, q: jmodel.decode_step(p, t, jcfg, c,
                                                          pos=q))
    for s in range(2):
        tok = tokens[:, plen + s:plen + s + 1]
        jrow, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(plen + s))
        row, c = model.decode_step(tp, torch.from_numpy(tok).long(), cfg, c,
                                   pos=plen + s)
        _close(row, jrow, LOGITS_TOL)


def test_quantize_weights_audit_and_words(capsys):
    jcfg, cfg = _cfgs()
    jp, jline = _wired()
    tp = quantize_weights(params_from_numpy(_to_numpy(_ref_params()), cfg,
                                            "cpu"), "takum8", mode="wire",
                          cfg=cfg)
    line = capsys.readouterr().out
    assert COUNTS.search(line).groups() == COUNTS.search(jline).groups() \
        == ("35", "0", "13", "0")
    _same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg))


def test_convert_round_trip():
    cfg = _cfgs()[1]
    want = _to_numpy(_wired()[0])
    tp = params_from_numpy(want, cfg, "cpu")
    assert len(tp["layers"]) == 5 and "embed_media" not in tp
    _same_leaves(want, params_to_numpy(tp, cfg))


# -- embed_media ------------------------------------------------------------------

D_MEDIA = 48


def test_embed_media_logits_and_audit(capsys):
    jcfg, cfg = _cfgs(d_media=D_MEDIA)
    jp = _ref_params(D_MEDIA)
    tree = _to_numpy(jp)
    assert tree["embed_media"].shape == (D_MEDIA, cfg.d_model)
    tp = params_from_numpy(tree, cfg, "cpu")
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    media = _media(cfg, 2, seed=9)
    jlogits, _ = jax.jit(jmodel.forward, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens), "media": jnp.asarray(media)},
        jcfg)
    logits, _ = model.forward(tp, {"tokens": torch.from_numpy(tokens).long(),
                                   "media": torch.from_numpy(media)}, cfg)
    _close(logits, jlogits, LOGITS_TOL)
    _same_leaves(tree, params_to_numpy(tp, cfg))
    # the audit: embed_media is skipped ("embed"), as in the reference
    jwired, jline = _wired(d_media=D_MEDIA)
    tq = quantize_weights(tp, "takum8", mode="wire", cfg=cfg)
    assert COUNTS.search(capsys.readouterr().out).groups() == \
        COUNTS.search(jline).groups() == ("35", "0", "14", "0")
    _same_leaves(_to_numpy(jwired), params_to_numpy(tq, cfg))


def test_port_init_builds_the_reference_shapes():
    jcfg, cfg = _cfgs(d_media=D_MEDIA)
    tp = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree_util.tree_map(np.shape, params_to_numpy(tp, cfg)) == \
        jax.tree_util.tree_map(np.shape, _to_numpy(_ref_params(D_MEDIA)))


# -- text-only left-padded prompts through two cross blocks -------------------


@pytest.mark.parametrize("kv", ["takum8", "none"])
def test_text_only_left_padded_two_cross_blocks(kv):
    """The 10-layer variant (cross blocks at layers 0 and 5), f32 weights:
    the prefill logits of every row, the padded ones included, within
    ``LOGITS_TOL`` of the reference's, and the lockstep tokens equal."""
    jcfg, cfg = _cfgs(kv_quant=kv, n_layers=10)
    assert transformer.layer_kinds(cfg)[::5] == ["cross", "cross"]
    jp = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    plen = max(PLENS)
    prompts = _prompts(5)
    tokens = np.zeros((len(PLENS), plen), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, plen - len(p):] = p
    start = np.array([plen - n for n in PLENS], np.int32)
    jc = jmodel.init_cache(jcfg, batch=3, max_len=16, start=start)
    c = model.init_cache(cfg, 3, 16, device="cpu", start=start)
    jrow, _ = jax.jit(lambda p, t, c: jmodel.prefill(p, t, jcfg, c))(
        jp, jnp.asarray(tokens), jc)
    row, _ = model.prefill(tp, torch.from_numpy(tokens).long(), cfg, c)
    _close(row, jrow, LOGITS_TOL)
    want = JServeEngine(jp, jcfg, max_len=32).generate(prompts,
                                                       max_new=MAX_NEW)
    got = ServeEngine(tp, cfg, max_len=32, device="cpu").generate(
        prompts, max_new=MAX_NEW)
    assert got == want


def test_rows_before_start_average_the_cache_and_nar_stays_out():
    """Contiguous attention on a dense layout, a takum8 cache: rows at or
    after ``start`` equal the reference oracle's (keys before ``start``
    masked) and stay finite with a NaR V word in the padding; rows before
    ``start`` are the uniform average of V over the whole cache, as the
    reference oracle gives them."""
    rng = np.random.default_rng(11)
    b, tq, h, hkv, hd, tmax = 2, 6, 4, 2, 16, 12
    spec = formats.get("takum8")
    q = rng.normal(size=(b, tq, h, hd)).astype(np.float32)
    kv = [spec.encode_tile(torch.from_numpy(
        rng.normal(size=(b, tmax, hkv, hd)).astype(np.float32))).numpy()
        for _ in range(2)]
    start = np.array([3, 0], np.int32)
    want = np.asarray(jref.attention_ref(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]), 8,
        "takum8", pos=0, start=jnp.asarray(start)))

    def got(v):
        return ops.takum_attention(
            torch.from_numpy(q), torch.from_numpy(kv[0]),
            torch.from_numpy(v), 8, spec, pos=0,
            start=torch.from_numpy(start)).numpy()

    out = got(kv[1])
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    vbar = spec.decode_tile(torch.from_numpy(kv[1])).mean(dim=1).numpy()
    np.testing.assert_allclose(out[0, :3].reshape(3, hkv, h // hkv, hd),
                               np.broadcast_to(vbar[0][None, :, None],
                                               (3, hkv, h // hkv, hd)),
                               rtol=1e-5, atol=1e-6)
    v_nar = kv[1].copy()
    v_nar[0, 1] = spec.nar_word
    poisoned = got(v_nar)
    np.testing.assert_array_equal(poisoned[0, 3:], out[0, 3:])
    np.testing.assert_array_equal(poisoned[1], out[1])
    assert np.isnan(poisoned[0, :3]).all()
