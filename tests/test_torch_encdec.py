"""The port's encdec family (seamless-m4t-large-v2) against the JAX
package, on the CPU.

* ``models/encdec.py``: ``encode`` (bidirectional; from ``ATTN_CHUNK_T``
  frames the chunked attention, unmasked) and ``decode`` (uncached under
  the causal mask; a cached prefill and decode steps, its cross-attention
  to the encoder output recomputed at each call) within ``BLOCK_TOL`` of
  the reference's, f32.
* The reduced seamless-m4t-large-v2 (2 + 2 layers, d 64, 4 heads of 16),
  the reference's ``model.init`` weights: ``forward``, ``prefill`` and
  ``decode_step`` logits within ``LOGITS_TOL``; ``generate`` (lockstep:
  the family is not ``paged_supported``) with takum8 wire weights and the
  config's float cache gives the JAX engine's greedy tokens for
  left-padded prompts with audio media (neither package masks the pads:
  encdec's cache takes no ``start``).
* A wire ``kv_quant`` is refused by both packages: the reference's
  prefill fails on the dtypes (its cache holds floats), the port refuses
  it by name before it allocates anything.
* ``_can_schedule`` is False; the scheduler, a paged cache and
  ``prefill_chunk`` are refused as the reference refuses them.
* ``quantize_weights`` (takum8 wire): the reference's audit line (``16
  wired, 0 fake-quantised, 9 skipped``) and every word bit for bit; the
  ``convert`` round trip of the ``enc``/``dec`` stacks.
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
from repro.models import encdec as jencdec
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import encdec, model, transformer
from repro_torch.models.layers import ATTN_CHUNK_T
from repro_torch.serve.engine import ServeEngine, quantize_weights
from test_torch_rglru import COUNTS, _jquantize, _same_leaves, _to_numpy

ARCH = "seamless-m4t-large-v2"
BLOCK_TOL = 1e-5    # f32 sums of the same terms in another order
LOGITS_TOL = 1e-4
MAX_NEW = 5
PLENS = (9, 4, 12)
T_AUDIO = 10


def _cfgs(**kw):
    return (dataclasses.replace(jget_arch(ARCH).reduced, **kw),
            dataclasses.replace(get_arch(ARCH).reduced, **kw))


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  _cfgs()[0])


@functools.lru_cache(maxsize=None)
def _port_params():
    return params_from_numpy(_to_numpy(_ref_params()), _cfgs()[1], "cpu")


def _audio(b, t=T_AUDIO, seed=0, d=64):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# -- encode / decode -------------------------------------------------------------


@pytest.mark.parametrize("frames", [T_AUDIO, ATTN_CHUNK_T],
                         ids=["sdpa", "chunked"])
def test_encode_matches_reference(frames):
    jcfg, cfg = _cfgs()
    media = _audio(1 if frames == ATTN_CHUNK_T else 2, frames, seed=frames)
    want = jax.jit(lambda p, m: jencdec.encode(p, m, jcfg))(
        _ref_params(), jnp.asarray(media))
    got = encdec.encode(_port_params(), torch.from_numpy(media), cfg)
    _close(got, want, BLOCK_TOL)


def test_decode_uncached_and_cached_match_reference():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, T_AUDIO, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    jlog, _ = jax.jit(lambda p, t, e: jencdec.decode(p, t, e, jcfg))(
        _ref_params(), jnp.asarray(tokens), jnp.asarray(enc))
    log, caches = encdec.decode(_port_params(), torch.from_numpy(tokens)
                                .long(), torch.from_numpy(enc), cfg)
    assert caches is None
    _close(log, jlog, BLOCK_TOL)
    # a 6-token prefill into the cache, then two steps
    jc = jencdec.init_cache(jcfg, 2, 8)
    c = encdec.init_cache(cfg, 2, 8, device="cpu")
    jdec = jax.jit(lambda p, t, e, c, q: jencdec.decode(p, t, e, jcfg,
                                                        caches=c, pos=q))
    for lo, hi in ((0, 6), (6, 7), (7, 8)):
        jlog, jc = jdec(_ref_params(), jnp.asarray(tokens[:, lo:hi]),
                        jnp.asarray(enc), jc, lo)
        log, c = encdec.decode(_port_params(), torch.from_numpy(
            tokens[:, lo:hi]).long(), torch.from_numpy(enc), cfg, caches=c,
            pos=lo)
        _close(log, jlog, BLOCK_TOL)
    assert [x["pos"] for x in c] == [8, 8]


# -- the reduced model -------------------------------------------------------------


def test_forward_prefill_and_decode_logits():
    jcfg, cfg = _cfgs()
    jp, tp = _ref_params(), _port_params()
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    media = _audio(2, seed=7)
    jlogits, _ = jax.jit(jmodel.forward, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens), "media": jnp.asarray(media)},
        jcfg)
    logits, aux = model.forward(tp, {"tokens": torch.from_numpy(tokens)
                                     .long(), "media": torch.from_numpy(
                                         media)}, cfg)
    assert float(aux) == 0.0
    _close(logits, jlogits, LOGITS_TOL)
    jc = jmodel.init_cache(jcfg, batch=2, max_len=16)
    c = model.init_cache(cfg, 2, 16, device="cpu")
    assert c["enc_out"].shape == jc["enc_out"].shape == (2, 8, cfg.d_model)
    jrow, jc = jax.jit(lambda p, t, c, m: jmodel.prefill(p, t, jcfg, c,
                                                         media=m))(
        jp, jnp.asarray(tokens[:, :8]), jc, jnp.asarray(media))
    row, c = model.prefill(tp, torch.from_numpy(tokens[:, :8]).long(), cfg,
                           c, media=torch.from_numpy(media))
    _close(row, jrow, LOGITS_TOL)
    _close(c["enc_out"], jc["enc_out"], BLOCK_TOL)
    jstep = jax.jit(lambda p, t, c, q: jmodel.decode_step(p, t, jcfg, c,
                                                          pos=q))
    for s in range(3):
        tok = tokens[:, 8 + s:9 + s]
        jrow, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(8 + s))
        row, c = model.decode_step(tp, torch.from_numpy(tok).long(), cfg, c,
                                   pos=8 + s)
        _close(row, jrow, LOGITS_TOL)


@functools.lru_cache(maxsize=None)
def _wired():
    return _jquantize(_ref_params(), "takum8", "wire")


@functools.lru_cache(maxsize=None)
def _engines():
    """The two engines on the reduced model: takum8 wire weights, the
    config's float cache."""
    jcfg, cfg = _cfgs()
    jp, _ = _wired()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    return (JServeEngine(jp, jcfg, max_len=32),
            ServeEngine(tp, cfg, max_len=32, device="cpu"))


def test_generate_left_padded_tokens(monkeypatch):
    jeng, teng = _engines()
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(0, 512, n)] for n in PLENS]
    media = _audio(len(PLENS), seed=12)
    starts = []
    init_cache = model.init_cache

    def spy(*args, **kwargs):
        starts.append(kwargs.get("start"))
        return init_cache(*args, **kwargs)

    monkeypatch.setattr(model, "init_cache", spy)
    want = jeng.generate(prompts, max_new=MAX_NEW, media=media)
    got = teng.generate(prompts, max_new=MAX_NEW, media=media)
    assert got == want
    assert teng._sched is None
    # the family rule passes start; encdec's cache drops it
    assert [int(s) for s in starts[0]] == [3, 8, 0]


def test_wire_kv_quant_refused_by_both():
    jcfg, cfg = _cfgs(kv_quant="takum8")
    jp, _ = _wired()
    media = _audio(2)
    with pytest.raises(TypeError, match="same dtypes"):
        JServeEngine(jp, jcfg, max_len=32).generate([[1, 2, 3], [4, 5]], 2,
                                                    media=media)
    teng = ServeEngine(params_from_numpy(_to_numpy(jp), cfg, "cpu"), cfg,
                       max_len=32, device="cpu")
    with pytest.raises(ValueError, match="float KV cache only"):
        teng.generate([[1, 2, 3], [4, 5]], 2, media=media)
    with pytest.raises(ValueError, match="float KV cache only"):
        model.init_cache(cfg, 2, 16, device="cpu")


def test_refusals_as_the_reference():
    from repro.models import transformer as jtr
    jeng, teng = _engines()
    jcfg, cfg = jeng.cfg, teng.cfg
    assert transformer.paged_supported(cfg) is jtr.paged_supported(jcfg) \
        is False
    assert teng._can_schedule(None) is jeng._can_schedule(None) is False
    with pytest.raises(ValueError, match="encdec"):
        jeng.scheduler()
    with pytest.raises(ValueError, match="encdec"):
        teng.scheduler()
    with pytest.raises(ValueError, match="attention-only layer plan"):
        model.init_paged_cache(cfg, 2, 4, 16, 2, device="cpu")
    with pytest.raises(ValueError, match="encode/decode"):
        jmodel.prefill_chunk(jeng.params, jnp.zeros((1, 4), jnp.int32), jcfg,
                             None, pos=0, last_idx=3)
    with pytest.raises(ValueError, match="encode/decode"):
        model.prefill_chunk(teng.params, torch.zeros((1, 4), dtype=torch.long),
                            cfg, None, pos=0, last_idx=3)
    with pytest.raises(ValueError, match="models/encdec.py"):
        transformer.forward(teng.params, torch.zeros((1, 4), dtype=torch.long),
                            cfg)


def test_quantize_weights_audit_and_words(capsys):
    jcfg, cfg = _cfgs()
    jp, jline = _wired()
    tp = quantize_weights(_port_params(), "takum8", mode="wire", cfg=cfg)
    line = capsys.readouterr().out
    assert COUNTS.search(line).groups() == COUNTS.search(jline).groups() \
        == ("16", "0", "9", "0")
    _same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg))


def test_convert_round_trip_and_port_init():
    jcfg, cfg = _cfgs()
    want = _to_numpy(_wired()[0])
    tp = params_from_numpy(want, cfg, "cpu")
    assert [len(tp["enc"]), len(tp["dec"])] == [2, 2]
    assert set(tp["dec"][1]) == {"ln1", "ln_x", "ln2", "attn", "xattn", "mlp"}
    _same_leaves(want, params_to_numpy(tp, cfg))
    with pytest.raises(ValueError, match="encdec stacks"):
        params_from_numpy(want, _cfgs(n_enc_layers=3)[1], "cpu")
    own = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree_util.tree_map(np.shape, params_to_numpy(own, cfg)) == \
        jax.tree_util.tree_map(np.shape, _to_numpy(_ref_params()))
