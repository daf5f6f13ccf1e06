"""The port's hybrid RG-LRU family (recurrentgemma-2b) against the JAX
package, on the CPU.

* ``models/rglru.py``: ``_conv1d_causal`` (with and without its carried
  inputs) within ``CONV_TOL`` and ``rglru_block_apply`` (uncached, and
  with a carried state) within ``SCAN_TOL`` of the reference's, f32: the
  log-depth scan multiplies in another order than
  ``jax.lax.associative_scan``; softplus as ``jax.nn.softplus``
  computes it.
* The reduced recurrentgemma-2b (5 layers: one (rec, rec, attn)
  super-block and the (rec, rec) remainder; window 32), the reference's
  ``model.init`` weights: ``forward`` logits, and ``prefill`` then
  ``decode_step`` logits, within 1e-4; ``generate`` (which routes the
  family to ``generate_lockstep``) with takum8 wire weights and a takum8
  KV cache gives the JAX engine's greedy tokens for prompts of equal
  length and for left-padded ones (the pads enter the recurrent state in
  both packages), all longer than the window; ``submit`` is refused as
  the reference's scheduler refuses the family.
* ``quantize_weights`` (takum8 wire and fake) on the reduced model and
  on an 8-layer tree (two super-blocks, so group 0's stacked leaves span
  two layers, and the remainder group): the reference's audit line, and
  every leaf's words or values bit for bit, ``lam`` and the remainder
  group's own scale included; the ``convert`` round trip, interleaving
  the groups in layer order.
* The import scan of tests/test_torch_codec.py covers the new modules.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import contextlib
import dataclasses
import functools
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.configs import get_arch as jget_arch
from repro.kernels.ops import WireMatrix as JWireMatrix
from repro.models import model as jmodel
from repro.models import rglru as jrg
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import quantize_weights as jquantize
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import model, rglru, transformer
from repro_torch.serve.engine import ServeEngine, quantize_weights

ARCH = "recurrentgemma-2b"
CONV_TOL = 1e-6
SCAN_TOL = 1e-5    # f32 products of a and bx met in another order
LOGITS_TOL = 1e-4
MAX_NEW = 6
COUNTS = re.compile(r"\]: (\d+) wired, (\d+) fake-quantised, (\d+) skipped, "
                    r"(\d+) non-matrix")


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda leaf: ((np.asarray(leaf.words), leaf.spec.name)
                      if isinstance(leaf, JWireMatrix) else np.asarray(leaf)),
        tree, is_leaf=lambda leaf: isinstance(leaf, JWireMatrix))


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


def _same_leaves(want, got):
    a, b = dict(_leaves(want)), dict(_leaves(got))
    assert a.keys() == b.keys()
    for path, w in a.items():
        g = b[path]
        if isinstance(w, tuple):        # wire words
            assert g[1] == w[1], path
            w, g = w[0], g[0]
        assert w.dtype == g.dtype and w.shape == g.shape, path
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=str(path))


def _cfgs(n_layers=None, kv="none"):
    jcfg, cfg = jget_arch(ARCH).reduced, get_arch(ARCH).reduced
    kw = dict(kv_quant=kv)
    if n_layers:
        kw["n_layers"] = n_layers
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  _cfgs()[0])


# -- the RG-LRU block ----------------------------------------------------------


def _block_params(rng, d, c):
    return {"w_in_x": rng.normal(size=(d, c)).astype(np.float32) * d ** -0.5,
            "w_in_g": rng.normal(size=(d, c)).astype(np.float32) * d ** -0.5,
            "conv": rng.normal(size=(4, c)).astype(np.float32) * 0.1,
            "w_a": rng.normal(size=(c, c)).astype(np.float32) * c ** -0.5,
            "w_x": rng.normal(size=(c, c)).astype(np.float32) * c ** -0.5,
            "lam": rng.uniform(2.0, 6.0, size=(c,)).astype(np.float32),
            "w_out": rng.normal(size=(c, d)).astype(np.float32) * c ** -0.5}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("carried", [False, True])
def test_conv1d_causal_matches_reference(carried):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    kern = rng.normal(size=(4, 24)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if carried else None
    jout, jst = jrg._conv1d_causal(jnp.asarray(x), jnp.asarray(kern),
                                   None if st is None else jnp.asarray(st))
    out, new = rglru._conv1d_causal(torch.from_numpy(x),
                                    torch.from_numpy(kern),
                                    None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=CONV_TOL,
                               atol=CONV_TOL)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))


@pytest.mark.parametrize("t,carried", [(37, False), (37, True), (1, True)])
def test_rglru_block_apply_matches_reference(t, carried):
    d, c = 32, 48
    rng = np.random.default_rng(t + carried)
    p = _block_params(rng, d, c)
    x = rng.normal(size=(3, t, d)).astype(np.float32)
    state = None
    if carried:
        state = {"h": rng.normal(size=(3, c)).astype(np.float32),
                 "conv": rng.normal(size=(3, 3, c)).astype(np.float32)}
    jout, jst = jax.jit(lambda p, x, st: jrg.rglru_block_apply(
        p, x, state=st))(jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(x),
                         None if state is None else
                         jax.tree_util.tree_map(jnp.asarray, state))
    out, st = rglru.rglru_block_apply(_t(p), torch.from_numpy(x),
                                      state=None if state is None
                                      else _t(state))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    assert (st is None) == (jst is None)
    if carried:
        np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
        # the carried inputs are x @ w_in_x: an f32 matmul in another order
        np.testing.assert_allclose(st["conv"].numpy(),
                                   np.asarray(jst["conv"]), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


def test_softplus_is_the_reference_on_lam():
    """logaddexp(lam, 0) against jax.nn.softplus, and F.softplus (which
    switches to lam above its threshold of 20) agreeing on lam's [2, 6)."""
    lam = np.random.default_rng(5).uniform(2.0, 6.0, 4096).astype(np.float32)
    t = torch.from_numpy(lam)
    ours = torch.logaddexp(t, torch.zeros(())).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax.nn.softplus(lam)),
                               rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(torch.nn.functional.softplus(t).numpy(), ours,
                               rtol=2 ** -23, atol=0)


# -- the reduced model --------------------------------------------------------


def test_layer_plan_and_paging_are_the_reference():
    from repro.models import transformer as jtr
    for n in (5, 8, 26):
        jcfg, cfg = _cfgs(n)
        assert transformer.layer_plan(cfg) == [
            (tuple(p), r) for p, r in jtr.layer_plan(jcfg)]
        assert transformer.paged_supported(cfg) is False
        assert jtr.paged_supported(jcfg) is False
    assert transformer.layer_kinds(_cfgs()[1]) == [
        "rec", "rec", "self", "rec", "rec"]


def test_forward_prefill_and_decode_logits():
    """f32 weights, a float cache: prefill 40 tokens (past the window of
    32), then three decode steps."""
    jcfg, cfg = _cfgs()
    jp = _ref_params()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    assert "unembed" not in tp     # tied embeddings
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    jlogits, _ = jax.jit(jmodel.forward, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    logits, aux = model.forward(tp, {"tokens": torch.from_numpy(tokens)
                                     .long()}, cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    jc = jmodel.init_cache(jcfg, batch=2, max_len=48)
    c = model.init_cache(cfg, 2, 48, device="cpu")
    jrow, jc = jax.jit(lambda p, t, c: jmodel.prefill(p, t, jcfg, c))(
        jp, jnp.asarray(tokens[:, :40]), jc)
    row, c = model.prefill(tp, torch.from_numpy(tokens[:, :40]).long(), cfg,
                           c)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    jstep = jax.jit(lambda p, t, c, q: jmodel.decode_step(p, t, jcfg, c,
                                                          pos=q))
    for s in range(3):
        tok = tokens[:, 40 + s:41 + s]
        jrow, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(40 + s))
        row, c = model.decode_step(tp, torch.from_numpy(tok).long(), cfg, c,
                                   pos=40 + s)
        np.testing.assert_allclose(row.numpy(), np.asarray(jrow),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)


@contextlib.contextmanager
def _leafwise_jit():
    """The reference's ``quantize_weights`` as it is, with each leaf's
    rounding (``FormatSpec.fake_quant``, ``WireMatrix.encode``) compiled
    once a leaf shape: the programs a jit of the whole tree would hold,
    compiled a few times faster (the leaves share a handful of shapes)."""
    fq, enc = jformats.FormatSpec.fake_quant, JWireMatrix.encode.__func__
    jfq = jax.jit(fq, static_argnums=0, static_argnames=("dtype",))
    jenc = jax.jit(lambda w, fmt: enc(JWireMatrix, w, fmt=fmt),
                   static_argnames=("fmt",))
    jformats.FormatSpec.fake_quant = \
        lambda self, x, dtype=jnp.float32: jfq(self, x, dtype=dtype)
    JWireMatrix.encode = classmethod(
        lambda cls, w, n=None, *, block=None, fmt="linear": jenc(w, fmt=fmt))
    try:
        yield
    finally:
        jformats.FormatSpec.fake_quant = fq
        JWireMatrix.encode = classmethod(enc)


def _jquantize(tree, fmt, mode):
    """(the reference's quantize_weights of ``tree``, its audit line)."""
    with contextlib.redirect_stdout(io.StringIO()) as out, _leafwise_jit():
        jp = jquantize(tree, fmt, mode=mode)
    return jp, out.getvalue()


@functools.lru_cache(maxsize=None)
def _wired(mode="wire"):
    return _jquantize(_ref_params(), "takum8", mode)


@functools.lru_cache(maxsize=None)
def _engines():
    """The two engines on the reduced model, takum8 wire weights and KV."""
    jcfg, cfg = _cfgs(kv="takum8")
    jp, _ = _wired()
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    return (JServeEngine(jp, jcfg, max_len=64),
            ServeEngine(tp, cfg, max_len=64, device="cpu"))


# both batches 45 tokens long: one compiled prefill and step in the JAX
# engine serves both
@pytest.mark.parametrize("plens", [(45, 45, 45), (45, 38, 33)],
                         ids=["equal", "left_padded"])
def test_generate_lockstep_tokens(plens):
    jeng, teng = _engines()
    rng = np.random.default_rng(sum(plens))
    prompts = [[int(t) for t in rng.integers(0, 512, n)] for n in plens]
    want = jeng.generate(prompts, max_new=MAX_NEW)
    got = teng.generate(prompts, max_new=MAX_NEW)
    assert got == want
    assert teng._sched is None         # routed past the scheduler


def test_submit_refused_as_the_reference():
    jeng, teng = _engines()
    with pytest.raises(ValueError, match="hybrid_rglru"):
        jeng.submit([1, 2, 3], 2)
    with pytest.raises(ValueError, match="hybrid_rglru"):
        teng.submit([1, 2, 3], 2)
    with pytest.raises(ValueError, match="attention-only"):
        model.init_paged_cache(teng.cfg, 2, 4, 16, 2, device="cpu")


@pytest.mark.parametrize("mode", ["wire", "fake"])
def test_quantize_weights_audit_and_words(mode, capsys):
    """The reduced model: every stacked leaf of the reference is one layer
    here, lam and conv included; the remainder group's block 0 (layer 3)
    takes its own scale, not group 0's block 0's (layer 0)."""
    jcfg, cfg = _cfgs()
    jp, jline = _wired(mode)
    tp = quantize_weights(params_from_numpy(_to_numpy(_ref_params()), cfg,
                                            "cpu"), "takum8", mode=mode,
                          cfg=cfg)
    line = capsys.readouterr().out
    assert COUNTS.search(line).groups() == COUNTS.search(jline).groups()
    assert COUNTS.search(jline).groups() == (
        ("14", "28", "12", "0") if mode == "wire" else ("0", "42", "12", "0"))
    _same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg))
    raw = _to_numpy(_ref_params())["groups"]
    assert not np.array_equal(params_to_numpy(tp, cfg)["groups"][1]["b0"]
                              ["rec"]["lam"], raw[1]["b0"]["rec"]["lam"])


def _eight_layers():
    """An 8-layer tree in the reference's layout (two repeats of the
    (rec, rec, self) super-block, then the (rec, rec) remainder), from
    the reduced model's: group 0's second repeat is its first scaled by
    3, so a stacked leaf's scale differs from its first layer's."""
    five = _to_numpy(_ref_params())
    g0, g1 = five["groups"]
    tree = dict(five)
    tree["groups"] = [jax.tree_util.tree_map(
        lambda x: np.concatenate([x, 3 * x]), g0), g1]
    return tree


def test_quantize_weights_scales_a_stacked_leaf_over_its_repeats():
    """8 layers, fake-quantised: each stacked leaf of group 0 spans layers
    r * 3 + i and takes one scale over both repeats; the remainder group
    (layers 6 and 7) is stacked apart."""
    mode = "fake"
    cfg = _cfgs(8)[1]
    tree = _eight_layers()
    jp, jline = _jquantize(jax.tree_util.tree_map(jnp.asarray, tree),
                           "takum8", mode)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tp = quantize_weights(params_from_numpy(tree, cfg, "cpu"), "takum8",
                              mode=mode, cfg=cfg)
    assert COUNTS.search(out.getvalue()).groups() == \
        COUNTS.search(jline).groups()
    _same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg))


def test_quantize_weights_follows_the_plan_not_the_kinds():
    """A (rec, attn, rec, attn) super-block: the kinds repeat every 2
    layers, but the reference stacks 4 blocks, each its own scale (block
    2 scaled by 3 apart from block 0); and hybrid layers without ``cfg``
    are refused, since their kinds alone do not name the stacks."""
    pat = ("rec", "attn", "rec", "attn")
    jcfg, cfg = (dataclasses.replace(c, block_pattern=pat) for c in _cfgs(4))
    tree = _to_numpy(jax.jit(jmodel.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    tree["groups"][0]["b2"] = jax.tree_util.tree_map(
        lambda x: 3 * x, tree["groups"][0]["b2"])
    jp, jline = _jquantize(jax.tree_util.tree_map(jnp.asarray, tree),
                           "takum8", "fake")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tp = quantize_weights(params_from_numpy(tree, cfg, "cpu"), "takum8",
                              mode="fake", cfg=cfg)
    assert COUNTS.search(out.getvalue()).groups() == \
        COUNTS.search(jline).groups() == ("0", "30", "10", "0")
    _same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg))
    with pytest.raises(ValueError, match="need cfg"):
        quantize_weights(params_from_numpy(tree, cfg, "cpu"), "takum8",
                         verbose=False)
    with pytest.raises(ValueError, match="plan of 3"):
        quantize_weights(params_from_numpy(tree, cfg, "cpu"), "takum8",
                         verbose=False, cfg=_cfgs(3)[1])


def test_convert_round_trip():
    cfg = _cfgs()[1]
    want = _to_numpy(_wired()[0])
    _same_leaves(want, params_to_numpy(params_from_numpy(want, cfg, "cpu"),
                                       cfg))


def test_convert_interleaves_groups():
    cfg = _cfgs(8)[1]
    want = _eight_layers()
    tp = params_from_numpy(want, cfg, "cpu")
    assert [("rec" in layer) for layer in tp["layers"]] == [
        True, True, False, True, True, False, True, True]
    # layer 3 is group 0's second repeat of block 0, layer 7 the
    # remainder's block 1
    np.testing.assert_array_equal(tp["layers"][3]["rec"]["lam"].numpy(),
                                  want["groups"][0]["b0"]["rec"]["lam"][1])
    np.testing.assert_array_equal(tp["layers"][7]["rec"]["conv"].numpy(),
                                  want["groups"][1]["b1"]["rec"]["conv"][0])
    _same_leaves(want, params_to_numpy(tp, cfg))


def test_import_scan_covers_the_new_modules():
    """tests/test_torch_codec.py scans every module of the port; the
    modules of this family are among them and import neither jax nor the
    reference."""
    from test_torch_codec import _FORBIDDEN
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    new = [root / "models" / "rglru.py", root / "configs" / "minitron_4b.py",
           root / "configs" / "nemotron_4_340b.py",
           root / "configs" / "starcoder2_15b.py",
           root / "configs" / "recurrentgemma_2b.py"]
    scanned = set(root.rglob("*.py"))
    for f in new:
        assert f in scanned
        assert not _FORBIDDEN.search(f.read_text()), f
