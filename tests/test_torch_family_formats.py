"""lns-takum8 and posit8 weights on the families beyond dense, against the
JAX package, on the CPU: the moe family (granite-moe-3b-a800m) with
lns-takum8 weights here, the other cases in
tests/test_torch_family_formats_{moe,rglru,rwkv6,encdec,vlm}[_posit].py
(a file a family and format: the JAX engine compiles its generate and
prefill for each). The files of each family pin takum8 weights
(tests/test_torch_moe.py, test_torch_rglru.py, test_torch_rwkv6.py,
test_torch_encdec.py, test_torch_vlm.py); these are the same checks for
the two other 8-bit formats. The helpers below serve every such file.

Each reduced config with the reference's ``model.init`` weights
(PRNGKey 0), the KV cache the family's file serves (takum8; encdec its
float cache). Checked, for each format:

* ``quantize_weights`` in ``wire`` and ``fake`` mode: the reference's
  audit line, and every leaf's words or values bit for bit (the
  fake-quantised RG-LRU, expert and rwkv6 matrices among them), except
  that an lns-takum8 fake-quantised value is decoded by each package's
  f32 ``exp``: there the words must agree (or be neighbours, at a
  ``log`` rounding tie) and the values within ``LNS_VALUE_RTOL``;
* ``generate`` at temperature 0 with the reference's wire words carried
  over: the JAX engine's greedy tokens (left-padded lockstep batches,
  with the family's seeded media; moe through the scheduler, prefix tree
  cold and warm);
* one prefill's logits within ``LOGITS_TOL`` of the reference's
  (lockstep families: ``model.prefill``; moe: a right-padded
  ``prefill_chunk``).

LNS weights need the replay. The reference's CPU route for them is its
oracle ``lns_qmatmul_ref``, one more rounding a product than its kernel
(ROADMAP.md section 3), and each projection encodes its input to the LNS
grid with a ``log`` of its own: free-running, llama-3.2-vision's tokens
part from the reference's after 13 of 15 new tokens. So for lns-takum8
both ``generate`` and the prefill run the reference on its kernel
(``lns_matmul_kernel_call`` in interpret mode) and the port's encodes
replay the reference's words (tests/test_torch_lns_serve.py's
``reference_on_its_kernel`` and ``forced_to``: each input within its
``INPUT_ATOL``, rwkv6's within ``RWKV6_INPUT_ATOL``, at most
``FLIP_SHARE`` of the words the port's own encode would have moved to a
neighbour).
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine, quantize_weights
from repro_torch.core.bitops import carrier
from test_torch_fake_quant import NEIGHBOUR_SHARE
import test_torch_lns_serve
from test_torch_lns_serve import reference_on_its_kernel
from test_torch_rglru import COUNTS, _jquantize, _leaves, _to_numpy

LOGITS_TOL = 1e-4
# an lns-takum8 value decoded by the two packages' f32 exp, where the word
# is the same (tests/test_torch_fake_quant.py)
LNS_VALUE_RTOL = 2.4e-7
MAX_NEW = 5
# rwkv6's time mix takes its WKV decay from the difference of two
# cumulative sums of log w (tests/test_torch_train_families.py,
# RWKV6_GRAD_TOL), so its outputs in two sum orders part by more than
# INPUT_ATOL: the encodes after it see inputs up to 5.7e-5 from the
# reference's (measured), where the other families' stay within 2.4e-6
RWKV6_INPUT_ATOL = 2e-4
# arch: (KV cache, prompt lengths of one generate call, audio frames),
# each file's own
FAMILIES = {
    "granite-moe-3b-a800m": ("takum8", (16, 9, 4, 13), 0),
    "recurrentgemma-2b": ("takum8", (45, 38, 33), 0),
    "rwkv6-1.6b": ("takum8", (45, 38, 7), 0),
    "seamless-m4t-large-v2": ("none", (9, 4, 12), 10),
    "llama-3.2-vision-11b": ("takum8", (13, 6, 10), 0),
}


def cfgs(arch):
    kv = FAMILIES[arch][0]
    return (dataclasses.replace(jget_arch(arch).reduced, kv_quant=kv),
            dataclasses.replace(get_arch(arch).reduced, kv_quant=kv))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  cfgs(arch)[0])


@functools.lru_cache(maxsize=None)
def wired(arch, fmt, mode="wire"):
    """(the reference's quantize_weights of the reduced model, its audit
    line)."""
    return _jquantize(ref_params(arch), fmt, mode)


def media(arch, b, seed=0):
    """The family's seeded media for ``b`` rows (numpy), or None."""
    cfg = cfgs(arch)[1]
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return rng.normal(size=(b, FAMILIES[arch][2], cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "vision":
        return rng.normal(size=(b, cfg.n_media_tokens,
                                cfg.d_media or cfg.d_model)).astype(
            np.float32)
    return None


def same_leaves(want, got, fmt):
    """Every leaf bit for bit: wire words and fake-quantised or untouched
    floats. An lns-takum8 fake-quantised leaf pays the decode's ``exp``
    in each package: there the values' words (re-encoded, exact on the
    grid) must agree, or be neighbours within ``NEIGHBOUR_SHARE``, and
    the values where they agree within ``LNS_VALUE_RTOL``
    (tests/test_torch_fake_quant.py's rule)."""
    spec = formats.get(fmt)
    a, b = dict(_leaves(want)), dict(_leaves(got))
    assert a.keys() == b.keys()
    steps = []
    for path, w in a.items():
        g = b[path]
        if isinstance(w, tuple):        # wire words
            assert g[1] == w[1], path
            w, g = w[0], g[0]
        assert w.dtype == g.dtype and w.shape == g.shape, path
        if np.array_equal(g.view(np.uint8), w.view(np.uint8)):
            continue
        assert spec.kind == "lns" and g.dtype == np.float32, path
        gw, ww = (carrier(spec.encode_tile(torch.from_numpy(x.copy()))).numpy()
                  .astype(np.int64) & ((1 << spec.n) - 1) for x in (g, w))
        step = (gw - ww) % (1 << spec.n)
        steps.append(step.reshape(-1))
        same = step == 0
        np.testing.assert_allclose(g[same], w[same], rtol=LNS_VALUE_RTOL,
                                   atol=0, err_msg=str(path))
    if steps:
        step = np.concatenate(steps)
        assert np.isin(step, (0, 1, (1 << spec.n) - 1)).all()
        assert (step != 0).mean() <= max(NEIGHBOUR_SHARE, 1.0 / step.size)


def check_audit_and_words(arch, fmt, mode, capsys):
    _, cfg = cfgs(arch)
    jp, jline = wired(arch, fmt, mode)
    tp = quantize_weights(params_from_numpy(_to_numpy(ref_params(arch)), cfg,
                                            "cpu"), fmt, mode=mode, cfg=cfg)
    line = capsys.readouterr().out
    assert COUNTS.search(line).groups() == COUNTS.search(jline).groups()
    same_leaves(_to_numpy(jp), params_to_numpy(tp, cfg), fmt)


@contextlib.contextmanager
def forced_to(arch, calls):
    """tests/test_torch_lns_serve.py's ``forced_to``, rwkv6's encode inputs
    held to ``RWKV6_INPUT_ATOL``."""
    atol = test_torch_lns_serve.INPUT_ATOL
    if cfgs(arch)[1].family == "rwkv6":
        test_torch_lns_serve.INPUT_ATOL = RWKV6_INPUT_ATOL
    try:
        with test_torch_lns_serve.forced_to(calls) as seen:
            yield seen
    finally:
        test_torch_lns_serve.INPUT_ATOL = atol


def engines(arch, fmt):
    jcfg, cfg = cfgs(arch)
    jp, _ = wired(arch, fmt)
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    kw = dict(max_len=48, page_size=16) if cfg.family == "moe" \
        else dict(max_len=64)
    return (JServeEngine(jp, jcfg, **kw),
            ServeEngine(tp, cfg, device="cpu", **kw))


def check_generate(arch, fmt):
    jeng, teng = engines(arch, fmt)
    plens = FAMILIES[arch][1]
    rng = np.random.default_rng(sum(plens))
    prompts = [[int(t) for t in rng.integers(0, 512, n)] for n in plens]
    m = media(arch, len(plens), seed=len(plens))
    lns = formats.get(fmt).has_lns_parts
    for label in ("cold", "warm") if teng.cfg.family == "moe" else ("",):
        on_kernel = reference_on_its_kernel() if lns \
            else contextlib.nullcontext([])
        with on_kernel as calls:
            want = jeng.generate(prompts, max_new=MAX_NEW, media=m)
        with forced_to(arch, calls) if lns else contextlib.nullcontext():
            got = teng.generate(prompts, max_new=MAX_NEW, media=m)
        assert got == want, (arch, fmt, label)
    if teng.cfg.family == "moe":
        assert teng.scheduler().pool.stats().prefix_hit_tokens > 0
    else:
        assert teng._sched is None


def check_prefill_logits(arch, fmt):
    """One prefill's logits (see the module docstring); for LNS weights,
    the words the port's own encode moved are counted and replaced."""
    jcfg, cfg = cfgs(arch)
    jp, _ = wired(arch, fmt)
    tp = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    rng = np.random.default_rng(7)
    moe = cfg.family == "moe"
    t = {"moe": 16, "rwkv6": 64}.get(cfg.family, 24)   # rwkv6: its chunk
    tokens = np.zeros((1, t), np.int32)
    tokens[0, :13] = rng.integers(0, cfg.vocab, 13)
    if not moe:
        tokens[0, 13:] = rng.integers(0, cfg.vocab, t - 13)
    m = media(arch, 1, seed=7)
    lns = formats.get(fmt).has_lns_parts
    on_kernel = reference_on_its_kernel() if lns \
        else contextlib.nullcontext([])
    with on_kernel as calls:
        jcache = jmodel.init_cache(jcfg, batch=1, max_len=32)
        if moe:
            jrow, _ = JServeEngine(jp, jcfg, max_len=48, page_size=16
                                   )._prefill_chunk(
                jp, jnp.asarray(tokens), jcache, jnp.asarray(0, jnp.int32),
                jnp.asarray(12, jnp.int32))
        else:
            jrow, _ = jax.jit(lambda p, x, c, mm: jmodel.prefill(
                p, x, jcfg, c, media=mm))(
                    jp, jnp.asarray(tokens), jcache,
                    None if m is None else jnp.asarray(m))
    forced = forced_to(arch, calls) if lns else contextlib.nullcontext()
    with forced as seen:
        cache = model.init_cache(cfg, 1, 32, device="cpu")
        x = torch.from_numpy(tokens).long()
        if moe:
            row, _ = model.prefill_chunk(tp, x, cfg, cache, pos=0,
                                         last_idx=12)
        else:
            row, _ = model.prefill(tp, x, cfg, cache, media=None if m is None
                                   else torch.from_numpy(m))
    if lns:
        assert seen["words"] > 0
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


ARCH = "granite-moe-3b-a800m"
FMT = "lns-takum8"     # posit8: tests/test_torch_family_formats_moe_posit.py


@pytest.mark.parametrize("mode", ["wire", "fake"])
def test_quantize_weights_audit_and_words(mode, capsys):
    check_audit_and_words(ARCH, FMT, mode, capsys)


def test_generate_tokens():
    check_generate(ARCH, FMT)


def test_prefill_logits():
    check_prefill_logits(ARCH, FMT)
