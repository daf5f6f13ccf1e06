"""The fused KV append and the replayable decode step, on the CPU.

``takum_codec.kv_append`` (one launch a layer on the card, ``csrc/
codec.cu``) runs its plain version, ``ref.kv_append_ref``, on CPU tensors.
Held here against the JAX package on seeded numpy inputs:

* paged mode against the reference's ``_encode_kv`` and its
  ``.at[page, off].set`` (``src/repro/models/layers.py:259-269``), every
  page of the pool bit-exact, for the six wire formats and the bf16/f32
  float caches, with an idle slot on the scratch page and a stale ``pos``
  clamped to the table width;
* contiguous mode against ``jax.lax.dynamic_update_slice``
  (``:284-287``);

and the serving pieces a CUDA graph of the decode step relies on:
``PagePool.push_tables`` writes the same device tensors in place, and on
the CPU ``disable_graphs()`` and the default serve the same tokens.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.core.bitops import carrier
from repro_torch.kernels import ops, takum_codec
from repro_torch.models import model
from repro_torch.serve.engine import ServeEngine, disable_graphs
from repro_torch.serve.paged import PagePool

WIRE = ["takum8", "takum16", "lns-takum8", "lns-takum16", "posit8",
        "posit16"]
# (kv_quant, float cache dtype for the identity codec)
KV = [(name, None) for name in WIRE] + [("none", "bf16"), ("none", "f32")]
TORCH_DT = {"bf16": torch.bfloat16, "f32": torch.float32}
JAX_DT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
P, PS, HKV, HD = 7, 8, 2, 16


def _kv_id(kv):
    return kv[0] if kv[1] is None else f"{kv[0]}-{kv[1]}"


def _values(rng, shape, kv=("takum8", None)):
    """Gaussian values at many scales, with zeros, infinities, a NaN and
    an f32 subnormal among them. Not the subnormal for the LNS formats:
    XLA:CPU reads a subnormal input of the reference's LNS encode as zero
    (ROADMAP.md section 3), tests/test_torch_lns.py holds that band."""
    x = (rng.normal(size=shape) * 2.0 ** rng.integers(-30, 30, shape)
         ).astype(np.float32)
    flat = x.reshape(-1)
    flat[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    if not kv[0].startswith("lns"):
        flat[5] = 1e-40
    return x


def _cache_bits(rng, shape, kv):
    """A cache full of stale words (bits), as numpy unsigned integers."""
    name, fdt = kv
    if fdt is not None:
        x = rng.normal(size=shape).astype(np.float32)
        return (x.view(np.uint32) >> 16).astype(np.uint16) if fdt == "bf16" \
            else x.view(np.uint32)
    n = formats.get(name).n
    return rng.integers(0, 1 << n, shape).astype(np.uint8 if n == 8
                                                  else np.uint16)


def _torch_cache(bits, kv):
    t = torch.from_numpy(bits.view({1: np.uint8, 2: np.int16,
                                    4: np.int32}[bits.itemsize]).copy())
    if kv[1] is not None:
        return t.view(TORCH_DT[kv[1]])
    return t.view(formats.get(kv[0]).word_dtype)


def _jax_cache(bits, kv):
    a = jnp.asarray(bits)
    return a.view(JAX_DT[kv[1]]) if kv[1] is not None else a


def _bits(t):
    """A torch cache's bits as numpy unsigned integers."""
    t = carrier(t)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.dtype == torch.float32:
        t = t.view(torch.int32)
    return t.numpy().view({1: np.uint8, 2: np.uint16, 4: np.uint32}[
        t.element_size()])


def _jbits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _same(got, want, kv):
    """Bit-exact, NaN compared by place for a float cache (NaN payloads
    differ between casts)."""
    if kv[1] is None:
        np.testing.assert_array_equal(got, want)
        return
    f = (lambda b: (b.astype(np.uint32) << 16).view(np.float32)) \
        if kv[1] == "bf16" else (lambda b: b.view(np.float32))
    gf, wf = f(got), f(want)
    nan = np.isnan(wf)
    np.testing.assert_array_equal(np.isnan(gf), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])


def _jencode(k, v, jcache, kv):
    return jL._encode_kv(k, v, jcache, kv[0])[1:]


@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_paged_append_matches_reference(kv, in_dtype):
    """Rows 0-1 active, row 2 idle on the scratch page, row 3 idle with a
    stale pos far past its table (clamped to the last table entry)."""
    rng = np.random.default_rng(16)
    table = np.array([[1, 2], [3, 4], [0, 0], [5, 6]], np.int32)
    pos = np.array([11, 3, 0, 999], np.int32)
    k = _values(rng, (4, 1, HKV, HD), kv)
    v = _values(rng, (4, 1, HKV, HD), kv)
    kbits = _cache_bits(rng, (P, PS, HKV, HD), kv)
    vbits = _cache_bits(rng, (P, PS, HKV, HD), kv)
    # the reference, layers.py:259-269
    jk, jv = (jnp.asarray(x).astype(JAX_DT[in_dtype]) for x in (k, v))
    jcache = {"k": _jax_cache(kbits, kv), "v": _jax_cache(vbits, kv),
              "table": jnp.asarray(table), "pos": jnp.asarray(pos)}
    kw, vw = _jencode(jk, jv, jcache, kv)
    jpos = jcache["pos"]
    pidx = jnp.minimum(jpos // PS, jcache["table"].shape[1] - 1)
    page = jnp.take_along_axis(jcache["table"], pidx[:, None], 1)[:, 0]
    off = jpos % PS
    want_k = jcache["k"].at[page, off].set(kw[:, 0])
    want_v = jcache["v"].at[page, off].set(vw[:, 0])
    # the port, through the op and the wrapper's CPU path
    tk, tv = (torch.from_numpy(x).to(TORCH_DT[in_dtype]) for x in (k, v))
    kc, vc = _torch_cache(kbits, kv), _torch_cache(vbits, kv)
    n0 = takum_codec.kv_append.launches
    ops.kv_append(tk, tv, kc, vc, kv[0], pos=torch.from_numpy(pos),
                  table=torch.from_numpy(table))
    assert takum_codec.kv_append.launches == n0     # the plain version
    _same(_bits(kc), _jbits(want_k), kv)
    _same(_bits(vc), _jbits(want_v), kv)
    # every page but the four written is untouched
    written = {2, 3, 0, 6}
    for p in set(range(P)) - written:
        np.testing.assert_array_equal(_bits(kc)[p], kbits[p])


@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_contiguous_append_matches_reference(kv):
    rng = np.random.default_rng(17)
    b, t, tmax, pos = 2, 5, 24, 7
    k = _values(rng, (b, t, HKV, HD), kv)
    v = _values(rng, (b, t, HKV, HD), kv)
    kbits = _cache_bits(rng, (b, tmax, HKV, HD), kv)
    vbits = _cache_bits(rng, (b, tmax, HKV, HD), kv)
    jcache = {"k": _jax_cache(kbits, kv), "v": _jax_cache(vbits, kv)}
    kw, vw = _jencode(jnp.asarray(k), jnp.asarray(v), jcache, kv)
    want_k = jax.lax.dynamic_update_slice(jcache["k"], kw, (0, pos, 0, 0))
    want_v = jax.lax.dynamic_update_slice(jcache["v"], vw, (0, pos, 0, 0))
    kc, vc = _torch_cache(kbits, kv), _torch_cache(vbits, kv)
    takum_codec.kv_append(torch.from_numpy(k), torch.from_numpy(v), kc, vc,
                          formats.resolve(kv[0]), pos=pos)
    _same(_bits(kc), _jbits(want_k), kv)
    _same(_bits(vc), _jbits(want_v), kv)


def _reduced(kv="takum8"):
    return dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                               kv_quant=kv)


def test_push_tables_writes_the_same_tensors_in_place():
    pool = PagePool(_reduced(), batch=3, num_pages=6, page_size=8,
                    max_pages=2, device="cpu")
    first = {k: pool.cache[0][k] for k in ("table", "pos", "start")}
    for layer in pool.cache:
        for key, t in first.items():
            assert layer[key] is t
    pool.assign(1, [4, 5], pos=11, start=2)
    pool.assign(2, [3], pos=5)
    pool.push_tables()
    for layer in pool.cache:
        for key, t in first.items():
            assert layer[key] is t, key
    np.testing.assert_array_equal(first["table"].numpy(),
                                  [[0, 0], [4, 5], [3, 0]])
    np.testing.assert_array_equal(first["pos"].numpy(), [0, 11, 5])
    np.testing.assert_array_equal(first["start"].numpy(), [0, 2, 0])
    pool.clear(1)
    pool.push_tables()
    assert pool.cache[-1]["pos"] is first["pos"]
    np.testing.assert_array_equal(first["pos"].numpy(), [0, 0, 5])
    np.testing.assert_array_equal(first["table"].numpy()[1], [0, 0])


@pytest.mark.parametrize("kv", ["takum8", "none"])
def test_graphs_off_the_card_serve_the_same_tokens(kv):
    """On the CPU the step runs eagerly with or without ``disable_graphs``:
    the same tokens, no graph captured, and the step advances the pool's
    device ``pos`` in place for every slot (idle ones drift)."""
    cfg = _reduced(kv)
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (16, 9, 4, 13)]
    outs = []
    for ctx in (disable_graphs, None):
        eng = ServeEngine(params, cfg, max_len=48, page_size=16,
                          decode_batch=6, device="cpu")
        if ctx is None:
            outs.append(eng.generate(prompts, 6))
        else:
            with ctx():
                outs.append(eng.generate(prompts, 6))
        sched = eng.scheduler()
        assert sched.step.captures == 0 and sched.step.replays == 0
        pos = sched.pool.cache[0]["pos"]
        assert all(layer["pos"] is pos for layer in sched.pool.cache)
    assert outs[0] == outs[1]


def test_step_advances_device_pos_in_place():
    cfg = _reduced()
    params = model.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    eng = ServeEngine(params, cfg, max_len=32, page_size=8, decode_batch=3,
                      device="cpu")
    sched = eng.scheduler()
    pool = sched.pool
    pool.assign(0, pool.alloc(2), pos=5)
    pool.push_tables()
    pos = pool.cache[0]["pos"]
    tok = torch.tensor([[3], [0], [0]])
    logits, head = sched.step(tok, torch.from_numpy(pool.pos[:, None]).long())
    assert logits.shape == (3, cfg.vocab)
    # the step's greedy tokens and per-row NaN flags, in one tensor
    assert torch.equal(head, torch.stack([logits.argmax(-1),
                                          logits.isnan().any(-1).long()]))
    assert pool.cache[0]["pos"] is pos
    np.testing.assert_array_equal(pos.numpy(), [6, 1, 1])
