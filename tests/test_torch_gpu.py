"""The port's CUDA kernels against their plain versions, on the card.

Small shapes; the full-width checks live in ``chip_smoke.py``. Every
test here is marked ``gpu`` and skips, inside its fixture, on a host
with no CUDA device (the kernels build with nvcc on first use and have
no CPU mode). Run on a GPU host with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX: the card's host has none.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import contextlib
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.core import posit, quant, takum
from repro_torch.core.bitops import carrier
from repro_torch.kernels import autotune, build
from repro_torch.kernels import lns_matmul as klns
from repro_torch.kernels import (ops, quantize, ref, takum_attention,
                                 takum_codec, takum_matmul)
from repro_torch.models import transformer
from repro_torch.models import model
from repro_torch.serve import graphs
from repro_torch.serve.engine import ServeEngine, quantize_weights
from repro_torch.serve.faults import FaultInjector

pytestmark = pytest.mark.gpu

SPECS = [formats.get("takum8"), formats.get("takum16")]
LNS_SPECS = [formats.get("lns-takum8"), formats.get("lns-takum16")]
POSIT_SPECS = [formats.get("posit8"), formats.get("posit16")]
# REPRO_LUT_DECODE: posit8 through its shared-memory table ("1") or the
# computed decode ("0"); posit16 has no table and decodes computed in both
LUT = ["0", "1"]


@pytest.fixture(scope="module")
def dev(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the checked-in launch-plan table alone: a local autotune cache left
    # in the working directory by a sweep is not read
    saved = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(
        tmp_path_factory.mktemp("autotune") / "tune.json")
    autotune.clear()
    yield torch.device("cuda")
    if saved is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = saved
    autotune.clear()


def _words(spec):
    return torch.arange(2 ** spec.n, dtype=torch.int64).to(spec.word_dtype)


def _floats(rng, size):
    with np.errstate(over="ignore"):      # beyond f32 range -> +-inf
        x = (rng.normal(size=size) * 10.0 ** rng.integers(-45, 39, size)
             ).astype(np.float32)
    raw = rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1.1754942e-38, 3.4028235e38, -3.4028235e38],
                       np.float32)
    return np.concatenate([x, raw.view(np.float32), special])


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_decode_every_word_bit_exact(dev, spec):
    words = _words(spec)
    got = takum_codec.decode(words.to(dev), spec).cpu()
    want = takum.takum_to_float(words, spec.n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_encode_bit_exact(dev, spec):
    x = torch.from_numpy(_floats(np.random.default_rng(0), 100_000))
    got = takum_codec.encode(x.to(dev), spec).cpu()
    want = takum.float_to_takum(x, spec.n)
    assert torch.equal(got.to(torch.int64), want.to(torch.int64))


# M through both regimes of the wire matmul (streaming up to 16 rows, the
# tensor cores above), K and N ragged (not multiples of 16) and aligned
MKN = [(1, 100, 60), (4, 128, 64), (4, 250, 130), (16, 320, 192),
       (16, 333, 77), (17, 250, 130), (37, 256, 128), (256, 512, 64),
       (256, 333, 77), (3, 100, 60)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("mkn", MKN)
def test_qmatmul_matches_plain(dev, spec, mkn):
    """Within f32 summation-order tolerance of the plain version (the
    tensor-core kernel's split TF32 products carry about 21 bits of x),
    and the same bits from two calls (fixed-order sums, no atomics)."""
    m, k, n = mkn
    g = torch.Generator().manual_seed(5)
    x = torch.randn((m, k), generator=g)
    w = takum.float_to_takum(torch.randn((k, n), generator=g) / k ** 0.5,
                             spec.n)
    got = ops.quant_matmul(x.to(dev), w.to(dev), spec)
    again = ops.quant_matmul(x.to(dev), w.to(dev), spec)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = ref.qmatmul_ref(x.to(dev), w.to(dev), spec).cpu()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("spec", SPECS + POSIT_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("m", [4, 37])
def test_qmatmul_nonfinite_x_matches_plain(dev, spec, m):
    """x rows holding an inf, a NaN and a value that rounds to TF32
    infinity (3.4028e38), in both regimes: the split of tf32.cuh keeps
    f32's meaning (NaN and infinities in the plain version's places, the
    large value's row finite and within f32 tolerance)."""
    k, n = 320, 130
    g = torch.Generator().manual_seed(8)
    x = torch.randn((m, k), generator=g)
    w = spec.encode_tile(torch.randn((k, n), generator=g) / k ** 0.5)
    x[1, 40] = float("inf")
    x[2, 41] = float("nan")
    x[3, 100] = 3.4028e38
    got = ops.quant_matmul(x.to(dev), w.to(dev), spec).cpu()
    want = ref.qmatmul_ref(x, w, spec)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[2]).all()
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin & ~torch.isnan(want)],
                       want[~fin & ~torch.isnan(want)])
    assert bool(fin[3].all())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [1, 17])
@pytest.mark.parametrize("name,lut", [("takum8", "0"), ("takum8", "1"),
                                      ("posit8", "1"), ("posit8", "0")])
def test_8bit_tables_decode_every_word(dev, name, lut, m, monkeypatch):
    """The wire matmul's decode of every 8-bit word, read back through
    x = 1 and K = 1 (out = decode(w), in both regimes): the takum8 table
    (always on) and posit8's (under REPRO_LUT_DECODE) give the computed
    decode's values, infinities and NaN places; +0 and -0 count as one
    value (0 + 1 * -0 is +0 in the sum). The tensor cores (M > 16) read
    TF32 operands, which keep 10 fraction bits in the subnormal band too:
    there an f32-subnormal value loses its low 13 bits (the takum8 words
    of +-2^-143 read as 0); the streaming kernel's FMAs keep them."""
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    spec = formats.get(name)
    words = _words(spec).to(dev)[None, :]
    got = ops.quant_matmul(torch.ones((m, 1), device=dev), words, spec).cpu()
    want = ref.decode_ref(words.cpu(), spec)
    if m > takum_matmul.STREAM_M:
        sub = want.abs() < torch.finfo(torch.float32).tiny
        tf32 = (want.view(torch.int32) & -(1 << 13)).view(torch.float32)
        want = torch.where(sub, tf32, want)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan.expand_as(got))
    assert torch.equal(got[:, ~nan[0]], want[:, ~nan[0]].expand(m, -1))


def _cache(spec, shape, g, dtype=None):
    """Seeded K/V words of ``spec`` (floats of ``dtype`` for the identity
    codec)."""
    x = torch.randn(shape, generator=g)
    return x.to(dtype) if spec.is_identity else spec.encode_tile(x)


# every KV format the attention kernels read: the wire formats, and the
# identity codec's bf16 and f32 caches
KV = ([(s, None) for s in SPECS + LNS_SPECS + POSIT_SPECS]
      + [(formats.get("none"), torch.bfloat16),
         (formats.get("none"), torch.float32)])


def _kv_id(kv):
    spec, dtype = kv
    return spec.name if dtype is None else f"none-{str(dtype)[6:]}"


def _plain_f32(spec, q, kw, vw):
    """The plain version's inputs for the kernels' semantics: a float cache
    (and q) in f32, as the kernels cast the words and dot in f32."""
    if spec.is_identity:
        return q.float(), kw.float(), vw.float()
    return q, kw, vw


# a bf16 cache against the plain identity branch as it is (einsums in
# bf16: q.k, the probabilities and p.v each rounded to bf16, 2^-9
# relative, on outputs of magnitude up to about 3)
BF16_ATOL = 2e-2


def _f32_refused(dtype, hd):
    """An f32 cache at a head dim neither attention kernel takes."""
    return dtype == torch.float32 and hd in takum_attention.F32_REFUSED


@pytest.mark.parametrize("kv", KV, ids=_kv_id)
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 192, 256])
@pytest.mark.parametrize("window", [0, 24])
def test_contiguous_attention_matches_plain(dev, kv, hd, window):
    spec, dtype = kv
    g = torch.Generator().manual_seed(1)
    b, tq, hkv, grp, tmax = 2, 9, 2, 3, 72
    q = torch.randn((b, tq, hkv * grp, hd), generator=g)
    if dtype is not None:
        q = q.to(dtype)                 # served activations: the cache dtype
    kw = _cache(spec, (b, tmax, hkv, hd), g, dtype)
    vw = _cache(spec, (b, tmax, hkv, hd), g, dtype)
    start = torch.tensor([0, 5], dtype=torch.int32)
    if _f32_refused(dtype, hd):
        n0 = takum_attention.attention.launches
        with pytest.raises(ValueError, match=f"f32 cache .* head_dim {hd}"):
            ops.takum_attention(q.to(dev), kw.to(dev), vw.to(dev), 0, spec,
                                pos=40, start=start, window=window)
        assert takum_attention.attention.launches == n0
        return
    for pos, block in ((0, 32), (40, None), (50, 24)):
        kwargs = dict(pos=pos, start=start, window=window)
        got = ops.takum_attention(q.to(dev), kw.to(dev), vw.to(dev), 0, spec,
                                  block=block, **kwargs).cpu()
        want = ref.attention_ref(*_plain_f32(spec, q, kw, vw), 0, spec,
                                 **kwargs)
        # rows with qpos < start are garbage on every path: compare the rest
        valid = (pos + torch.arange(tq))[None, :] >= start[:, None].long()
        torch.testing.assert_close(got[valid], want[valid], rtol=0,
                                   atol=2e-5)
        if dtype == torch.bfloat16:
            plain = ref.attention_ref(q, kw, vw, 0, spec, **kwargs)
            torch.testing.assert_close(got[valid], plain[valid].float(),
                                       rtol=0, atol=BF16_ATOL)


def _pool(spec, g, p=11, ps=16, hkv=2, hd=16, dtype=None):
    return (_cache(spec, (p, ps, hkv, hd), g, dtype),
            _cache(spec, (p, ps, hkv, hd), g, dtype))


@pytest.mark.parametrize("kv", [(s, None) for s in SPECS] + KV[-2:],
                         ids=_kv_id)
@pytest.mark.parametrize("window", [0, 7])
def test_paged_attention_matches_plain(dev, kv, window):
    spec, dtype = kv
    g = torch.Generator().manual_seed(2)
    kw, vw = _pool(spec, g, dtype=dtype)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 0, 0],
                          [0, 0, 0, 0]], dtype=torch.int32)
    # seq 3 is an idle slot whose stale pos ran past its table
    pos = torch.tensor([63, 37, 20, 900], dtype=torch.int32)
    start = torch.tensor([0, 5, 3, 0], dtype=torch.int32)
    q = torch.randn((4, 1, 4, 16), generator=g)
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev),
                              start=start.to(dev), window=window).cpu()
    want = ref.paged_attention_ref(*_plain_f32(spec, q, kw, vw), table, spec,
                                   pos=pos, start=start, window=window)
    assert torch.isfinite(got).all()
    # every row, the idle slot's too (with a window no page is in range:
    # 0 on both paths)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_paged_nar_poisons_only_its_rows(dev):
    spec = formats.get("takum16")
    g = torch.Generator().manual_seed(3)
    kw, vw = _pool(spec, g)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    kw[5, 8, 0, 0] = takum.nar_word(16)     # seq 1, position 8, kv head 0
    pos = torch.tensor([63, 37], dtype=torch.int32)
    q = torch.randn((2, 1, 4, 16), generator=g)
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev)).cpu()
    assert torch.isnan(got[1, 0, :2]).all()
    assert torch.isfinite(got[1, 0, 2:]).all() and torch.isfinite(got[0]).all()


def test_wrappers_count_launches(dev):
    spec = formats.get("takum8")
    before = takum_codec.encode.launches
    takum_codec.encode(torch.zeros(8, device=dev), spec)
    assert takum_codec.encode.launches == before + 1
    takum_codec.encode(torch.zeros(8), spec)          # CPU: plain version
    assert takum_codec.encode.launches == before + 1
    n0 = takum_attention.paged_attention.launches
    g = torch.Generator().manual_seed(4)
    kw, vw = _pool(spec, g)
    ops.paged_attention(torch.randn((1, 1, 4, 16), device=dev), kw.to(dev),
                        vw.to(dev), torch.tensor([[1]], device=dev), spec,
                        pos=torch.tensor([3], device=dev))
    assert takum_attention.paged_attention.launches == n0 + 1


def _reduced(kv, wfmt=None, arch="phi3-medium-14b"):
    cfg = dataclasses.replace(get_arch(arch).reduced, kv_quant=kv)
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, quantize_weights(params, wfmt or kv, mode="wire", cfg=cfg,
                                 verbose=False)


@pytest.mark.parametrize("kv,wfmt", [("takum8", None), ("takum16", None),
                                     ("none", "takum8"),
                                     ("lns-takum8", "lns-takum16"),
                                     ("takum8", "lns-takum16"),
                                     ("posit8", "posit16"),
                                     ("posit8", None)])
def test_reduced_serving_card_matches_cpu(dev, kv, wfmt):
    cfg, params = _reduced(kv, wfmt)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (16, 9, 4, 13)]
    outs = {}
    for d in ("cpu", dev):
        eng = ServeEngine(params, cfg, max_len=48, page_size=16, device=d)
        outs[str(d)] = (eng.generate(prompts, 6), eng.generate(prompts, 6))
    assert outs["cpu"] == outs["cuda"]


# -- logarithmic takum -----------------------------------------------------------


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of float32 (+0 and -0 are one
    value, and a sign change counts the steps through zero)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
def test_lns_decode_every_word(dev, spec):
    """lns_parts bit-exact (the device function, read back as the integer
    state of the gauss LNS matmul by the word 1.0: one fold from the empty
    sum copies the product's parts); the value (one expf) within 2 ulp."""
    words = _words(spec)
    one = takum.float_to_lns_takum(torch.ones((1, 1)), spec.n)
    _, ell, flags = klns.lns_matmul(words[:, None].to(dev), one.to(dev),
                                    spec, "gauss", state=True)
    want_ell, want_flags = spec.lns_parts(words)
    assert torch.equal(ell[:, 0].cpu(), want_ell)
    assert torch.equal(flags[:, 0].cpu(), want_flags)
    got = takum_codec.decode(words.to(dev), spec).cpu()
    want = ref.decode_ref(words.to(dev), spec).cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert int(_ulps(got[fin], want[fin]).max()) <= 2


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
def test_lns_encode_equal_or_neighbour(dev, spec):
    """One logf per value: the word equals the plain version's or, where
    the log lands on a rounding tie, is its neighbour (rare)."""
    x = torch.from_numpy(_floats(np.random.default_rng(1), 100_000))
    got = takum_codec.encode(x.to(dev), spec).cpu()
    want = ref.encode_ref(x.to(dev), spec).cpu()
    mod = 1 << spec.n
    step = (carrier(got).long() - carrier(want).long()) % mod
    assert bool(torch.isin(step, torch.tensor([0, 1, mod - 1])).all())
    assert float((step != 0).double().mean()) < 1e-4


def _lns_operands(spec, m, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = takum.float_to_lns_takum(torch.randn((m, k), generator=g), spec.n)
    w = takum.float_to_lns_takum(torch.randn((k, n), generator=g) / k ** 0.5,
                                 spec.n)
    return x, w


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("mkn", [(4, 320, 192), (3, 100, 60), (37, 256, 130),
                                 (256, 512, 64)])
def test_lns_matmul_linear_matches_plain(dev, spec, mkn):
    x, w = _lns_operands(spec, *mkn, seed=7)
    got = klns.lns_matmul(x.to(dev), w.to(dev), spec).cpu()
    want = ref.lns_matmul_plain(x.to(dev), w.to(dev), spec).cpu()
    # f32 sums of the same products in another order, each product within
    # 2 ulp of expf: at worst 2 K u sum|p| + 4 u sum|p| elementwise
    # (u = 2^-24); statistically 16 sqrt(K) u ||p||_2, as chip_smoke.py
    # phase 8 holds it (where products rounded to TF32 break it)
    xd, wd = spec.decode_tile(x), spec.decode_tile(w)
    tol = (2 * mkn[1] + 4) * 2.0 ** -24 * (xd.abs() @ wd.abs())
    stat = 16 * mkn[1] ** 0.5 * 2.0 ** -24 * ((xd * xd) @ (wd * wd)).sqrt()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= tol).all()) and bool((err <= stat).all())


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
def test_lns_matmul_each_product_within_2_ulp(dev, spec):
    """K = 1: every output is one product, one expf, within 2 ulp of the
    plain version; exp2f of an argument rescaled by an f32 log2(e) (the
    fast-exp route) is not."""
    x = _words(spec)[:, None]
    g = torch.Generator().manual_seed(13)
    w = takum.float_to_lns_takum(torch.randn((1, 64), generator=g), spec.n)
    got = klns.lns_matmul(x.to(dev), w.to(dev), spec).cpu()
    want = ref.lns_matmul_plain(x, w, spec)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert int(_ulps(got[fin], want[fin]).max()) <= 2
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    fast = ref.lns_matmul_plain(x, w, spec,
                                exp=lambda a: torch.exp2(a * log2e))
    assert int(_ulps(fast[fin], want[fin]).max()) > 2


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("mkn", [(4, 300, 130), (9, 64, 70)])
def test_lns_matmul_gauss_state_bit_exact(dev, spec, mkn):
    x, w = _lns_operands(spec, *mkn, seed=8)
    out, ell, flags = klns.lns_matmul(x.to(dev), w.to(dev), spec, "gauss",
                                      state=True)
    pout, pell, pflags = ref.lns_matmul_plain(x.to(dev), w.to(dev), spec,
                                              "gauss", state=True)
    assert torch.equal(ell.cpu(), pell.cpu())
    assert torch.equal(flags.cpu(), pflags.cpu())
    assert int(_ulps(out.cpu(), pout.cpu()).max()) <= 2


@pytest.mark.parametrize("accum", ["linear", "gauss"])
def test_lns_matmul_nar_poisons_its_row_and_column(dev, accum):
    spec = formats.get("lns-takum16")
    x, w = _lns_operands(spec, 6, 96, 70, seed=9)
    x[2, 5] = takum.nar_word(16)
    w[40, 33] = takum.nar_word(16)
    got = klns.lns_matmul(x.to(dev), w.to(dev), spec, accum).cpu()
    nan = torch.isnan(got)
    assert nan[2].all() and nan[:, 33].all()
    assert int(nan.sum()) == got.shape[1] + got.shape[0] - 1


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 256])
def test_lns_matmul_regime_edges_match_plain(dev, spec, m):
    """Both regimes of the linear kernel at their edges (the streaming
    kernel up to M = 16, 4 rows a block; register tiles above), K
    ragged against both K tiles (16 and 128 rows) and N against every
    column strip and tile, under the limits of
    test_lns_matmul_linear_matches_plain."""
    k, n = 1000, 203
    variant = klns.launch_plan(m, k, n, bits=spec.n)[0]
    assert variant == (1 if m > 16 else 0)
    x, w = _lns_operands(spec, m, k, n, seed=m)
    got = klns.lns_matmul(x.to(dev), w.to(dev), spec).cpu()
    want = ref.lns_matmul_plain(x.to(dev), w.to(dev), spec).cpu()
    xd, wd = spec.decode_tile(x), spec.decode_tile(w)
    tol = (2 * k + 4) * 2.0 ** -24 * (xd.abs() @ wd.abs())
    stat = 16 * k ** 0.5 * 2.0 ** -24 * ((xd * xd) @ (wd * wd)).sqrt()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= tol).all()) and bool((err <= stat).all())
    # the same bits from a second call: fixed-order sums
    again = klns.lns_matmul(x.to(dev), w.to(dev), spec).cpu()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("m", [4, 9, 64])
def test_lns_matmul_nar_poisons_its_row_and_column_in_both_regimes(dev, spec,
                                                                   m):
    """A NaR word in x and one in w: NaN in exactly that row and that
    column, in the streaming kernel (M = 4, 9) and the register tiles
    (M = 64), zero words beside them adding nothing."""
    k, n = 300, 70
    x, w = _lns_operands(spec, m, k, n, seed=20 + m)
    x[2, 5] = takum.nar_word(spec.n)
    w[40, 33] = takum.nar_word(spec.n)
    x[3, :50] = 0
    w[:, 7] = 0
    got = klns.lns_matmul(x.to(dev), w.to(dev), spec).cpu()
    nan = torch.isnan(got)
    assert nan[2].all() and nan[:, 33].all()
    assert int(nan.sum()) == n + m - 1
    assert (got[:, 7][~nan[:, 7]] == 0).all()
    want = ref.lns_matmul_plain(x, w, spec)
    assert torch.equal(nan, torch.isnan(want))


# paged attention at the edges of its partitions (hd 128: 64 keys a
# partition for 8-bit words, 32 for 16-bit, 16 for f32): (page size, table
# width, pos, start, window)
PAGED_EDGES = {
    # pos on and beside page boundaries; an idle slot past its table
    "page_boundary": (16, 16, [16, 127, 191, 5000], [0, 3, 0, 0], 0),
    # a window whose floor falls inside a partition
    "window_crossing": (16, 16, [100, 127, 200, 5000], [0, 0, 90, 0], 40),
    # pages of one key: the last partition holds one key
    "one_key_partition": (1, 200, [64, 32, 150, 999], [0, 0, 0, 0], 0),
}


def _paged_edge_inputs(spec, dtype, case, seed, hd=128):
    ps, npg, pos, start, window = PAGED_EDGES[case]
    g = torch.Generator().manual_seed(seed)
    pages = 4 * npg + 1
    kw = _cache(spec, (pages, ps, 2, hd), g, dtype)
    vw = _cache(spec, (pages, ps, 2, hd), g, dtype)
    table = (torch.randperm(pages - 1, generator=g)[:4 * npg] + 1)
    table = table.reshape(4, npg).to(torch.int32)
    table[3] = 0                               # the idle slot's scratch page
    q = torch.randn((4, 1, 8, hd), generator=g)
    if dtype is not None:
        q = q.to(dtype)
    return (q, kw, vw, table, torch.tensor(pos, dtype=torch.int32),
            torch.tensor(start, dtype=torch.int32), window)


@pytest.mark.parametrize("case", list(PAGED_EDGES))
@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_paged_attention_partition_edges_match_plain(dev, kv, case):
    spec, dtype = kv
    q, kw, vw, table, pos, start, window = _paged_edge_inputs(spec, dtype,
                                                              case, 5)
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev),
                              start=start.to(dev), window=window).cpu()
    plain = _plain_f32(spec, q, kw, vw)
    want = ref.paged_attention_ref(*plain, table, spec, pos=pos, start=start,
                                   window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    bits = 32 if dtype == torch.float32 else 16 if dtype else spec.n
    split = ref.paged_attention_ref(
        *plain, table, spec, pos=pos, start=start, window=window,
        partitions=takum_attention.paged_partition_keys(128, bits))
    torch.testing.assert_close(got, split, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", list(PAGED_EDGES))
@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_paged_attention_hd112_matches_plain(dev, kv, case):
    """Head dim 112 (kimi-k2's): a key is 7, 14 or 28 lanes of 16 bytes,
    4, 2 or 1 whole keys a warp with the rest of the lanes idle, and 64
    keys a partition at every width; against the plain version and its
    split at the kernel's partitions."""
    spec, dtype = kv
    q, kw, vw, table, pos, start, window = _paged_edge_inputs(
        spec, dtype, case, 15, hd=112)
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev),
                              start=start.to(dev), window=window).cpu()
    plain = _plain_f32(spec, q, kw, vw)
    want = ref.paged_attention_ref(*plain, table, spec, pos=pos, start=start,
                                   window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    bits = 32 if dtype == torch.float32 else 16 if dtype else spec.n
    pk = takum_attention.paged_partition_keys(112, bits)
    assert pk == 64
    split = ref.paged_attention_ref(*plain, table, spec, pos=pos, start=start,
                                    window=window, partitions=pk)
    torch.testing.assert_close(got, split, rtol=0, atol=2e-5)


@pytest.mark.parametrize("hd", [192, 256])
@pytest.mark.parametrize("case", list(PAGED_EDGES))
@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_paged_attention_hd192_256_matches_plain(dev, kv, case, hd):
    """Head dims 192 (nemotron-4-340b's) and 256 (recurrentgemma-2b's): a
    key is 12 or 24 lanes of 16 bytes at hd 192 (2 or 1 keys a warp, 8
    lanes idle), 16 or 32 at hd 256, and 32 keys a partition; against the
    plain version and its split at the kernel's partitions. An f32 cache
    (48 or 64 lanes a key) is refused by name before any launch."""
    spec, dtype = kv
    q, kw, vw, table, pos, start, window = _paged_edge_inputs(
        spec, dtype, case, 16, hd=hd)
    args = (q.to(dev), kw.to(dev), vw.to(dev), table.to(dev), spec)
    kwargs = dict(pos=pos.to(dev), start=start.to(dev), window=window)
    if _f32_refused(dtype, hd):
        n0 = takum_attention.paged_attention.launches
        with pytest.raises(ValueError, match=f"f32 cache .* head_dim {hd}"):
            ops.paged_attention(*args, **kwargs)
        assert takum_attention.paged_attention.launches == n0
        return
    got = ops.paged_attention(*args, **kwargs).cpu()
    plain = _plain_f32(spec, q, kw, vw)
    want = ref.paged_attention_ref(*plain, table, spec, pos=pos, start=start,
                                   window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    bits = 16 if dtype else spec.n
    pk = takum_attention.paged_partition_keys(hd, bits)
    assert pk == 32
    split = ref.paged_attention_ref(*plain, table, spec, pos=pos, start=start,
                                    window=window, partitions=pk)
    torch.testing.assert_close(got, split, rtol=0, atol=2e-5)


def test_paged_attention_hd256_16bit_launches(dev):
    """hd 256 with 16-bit words: 21 KB of the kernel's static arrays beside
    32 KB of staged words, past the 48 KB a block gets without opting in
    (the launch counts the static bytes too); recurrentgemma-2b's heads
    (G 10 over one KV head) over 256-position pages at long positions, so
    the merge's workspace grows with the partitions."""
    spec = formats.get("takum16")
    g = torch.Generator().manual_seed(17)
    ps, npg = 256, 10
    kw, vw = _pool(spec, g, p=4 * npg + 1, ps=ps, hkv=1, hd=256)
    table = (torch.arange(4 * npg, dtype=torch.int32) + 1).reshape(4, npg)
    pos = torch.tensor([2300, 2047, 255, 2559], dtype=torch.int32)
    start = torch.zeros(4, dtype=torch.int32)
    q = torch.randn((4, 1, 10, 256), generator=g)
    n0 = takum_attention.paged_attention.launches
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev),
                              start=start.to(dev), window=2048).cpu()
    assert takum_attention.paged_attention.launches == n0 + 1
    want = ref.paged_attention_ref(q, kw, vw, table, spec, pos=pos,
                                   start=start, window=2048)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_paged_nar_places_across_partitions(dev, kv):
    """A NaR K word (NaN for a float cache) at a valid position of
    sequence 1, KV head 0, in its second partition, and a NaR V word at a
    masked position (past pos) of a visited page of sequence 0, KV head 1:
    NaN in exactly the plain version's places (every row of those heads,
    one column for the V word)."""
    spec, dtype = kv
    q, kw, vw, table, pos, start, window = _paged_edge_inputs(
        spec, dtype, "page_boundary", 6)
    nar = float("nan") if spec.is_identity else takum.nar_word(spec.n)
    kw[table[1, 5], 3, 0, 17] = nar          # position 83 <= pos 127
    vw[table[0, 1], 9, 1, 40] = nar          # position 25 > pos 16
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev),
                              start=start.to(dev)).cpu()
    want = ref.paged_attention_ref(*_plain_f32(spec, q, kw, vw), table, spec,
                                   pos=pos, start=start)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert nan[1, 0, :4].all() and nan[0, 0, 4:, 40].all()
    assert int(nan.sum()) == 4 * 128 + 4
    torch.testing.assert_close(got[~nan], want[~nan], rtol=0, atol=2e-5)


def test_paged_merge_is_one_launch_and_the_same_bits(dev):
    """The last block of each (sequence, KV head) merges in partition
    order: one launch a call, the same bits on every call whichever block
    finishes last, and every counter back at 0 after the call."""
    spec = formats.get("takum8")
    q, kw, vw, table, pos, start, _ = _paged_edge_inputs(spec, None,
                                                         "page_boundary", 7)
    args = (q.to(dev), kw.to(dev), vw.to(dev), table.to(dev), spec)
    n0 = takum_attention.paged_attention.launches
    first = ops.paged_attention(*args, pos=pos.to(dev))
    assert takum_attention.paged_attention.launches == n0 + 1
    for _ in range(5):
        again = ops.paged_attention(*args, pos=pos.to(dev))
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    torch.cuda.synchronize()
    for counter in takum_attention._COUNTERS.values():
        assert int(counter.abs().sum()) == 0


@pytest.mark.parametrize("spec", LNS_SPECS, ids=lambda s: s.name)
def test_attention_over_lns_kv_matches_plain(dev, spec):
    g = torch.Generator().manual_seed(10)
    b, tq, hkv, grp, hd, tmax = 2, 9, 2, 3, 128, 72
    q = torch.randn((b, tq, hkv * grp, hd), generator=g)
    kw = takum.float_to_lns_takum(torch.randn((b, tmax, hkv, hd), generator=g),
                                  spec.n)
    vw = takum.float_to_lns_takum(torch.randn((b, tmax, hkv, hd), generator=g),
                                  spec.n)
    start = torch.tensor([0, 5], dtype=torch.int32)
    got = ops.takum_attention(q.to(dev), kw.to(dev), vw.to(dev), 0, spec,
                              pos=40, start=start, block=32).cpu()
    want = ref.attention_ref(q.to(dev), kw.to(dev), vw.to(dev), 0, spec,
                             pos=40, start=start.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    kp = takum.float_to_lns_takum(torch.randn((11, 16, 2, 16), generator=g),
                                  spec.n)
    vp = takum.float_to_lns_takum(torch.randn((11, 16, 2, 16), generator=g),
                                  spec.n)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 0, 0],
                          [0, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([63, 37, 20, 900], dtype=torch.int32)
    qd = torch.randn((4, 1, 4, 16), generator=g)
    got = ops.paged_attention(qd.to(dev), kp.to(dev), vp.to(dev),
                              table.to(dev), spec, pos=pos.to(dev)).cpu()
    want = ref.paged_attention_ref(qd.to(dev), kp.to(dev), vp.to(dev),
                                   table.to(dev), spec, pos=pos.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_lns_wrappers_count_launches(dev):
    spec = formats.get("lns-takum8")
    x, w = _lns_operands(spec, 4, 64, 64, seed=11)
    n0, e0 = klns.lns_matmul.launches, takum_codec.encode.launches
    out = ops.lns_matmul(spec.decode_tile(x).to(dev), w.to(dev), spec)
    assert klns.lns_matmul.launches == n0 + 1
    assert takum_codec.encode.launches == e0 + 1    # x onto the LNS grid
    ops.lns_matmul(spec.decode_tile(x), w, spec)      # CPU: plain version
    assert klns.lns_matmul.launches == n0 + 1
    assert out.shape == (4, 64)


# -- posit ----------------------------------------------------------------------


@pytest.mark.parametrize("lut", LUT)
@pytest.mark.parametrize("spec", POSIT_SPECS, ids=lambda s: s.name)
def test_posit_decode_every_word_bit_exact(dev, spec, lut, monkeypatch):
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    assert build.format_code(spec, dev) == (
        build.POSIT8_LUT if spec.n == 8 and lut == "1" else 2)
    words = _words(spec)
    got = takum_codec.decode(words.to(dev), spec).cpu()
    want = posit.posit_to_float(words, spec.n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("spec", POSIT_SPECS, ids=lambda s: s.name)
def test_posit_encode_bit_exact(dev, spec):
    x = torch.from_numpy(_floats(np.random.default_rng(0), 100_000))
    got = takum_codec.encode(x.to(dev), spec).cpu()
    want = posit.float_to_posit(x, spec.n)
    assert torch.equal(carrier(got), carrier(want))


def test_posit8_table_equals_computed_decode(dev, monkeypatch):
    spec = formats.get("posit8")
    words = _words(spec).to(dev)
    outs = {}
    for lut in LUT:
        monkeypatch.setenv("REPRO_LUT_DECODE", lut)
        outs[lut] = takum_codec.decode(words, spec).cpu()
    bits = {k: v.view(torch.int32) for k, v in outs.items()}
    assert torch.equal(bits["0"], bits["1"])
    plain = formats.posit8_lut_decode(words.cpu()).view(torch.int32)
    assert torch.equal(bits["1"], plain)


@pytest.mark.parametrize("lut", LUT)
@pytest.mark.parametrize("spec", POSIT_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("mkn", [(4, 320, 192), (37, 256, 130), (3, 100, 60)])
def test_qmatmul_posit_matches_plain(dev, spec, lut, mkn, monkeypatch):
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    m, k, n = mkn
    g = torch.Generator().manual_seed(6)
    x = torch.randn((m, k), generator=g)
    w = posit.float_to_posit(torch.randn((k, n), generator=g) / k ** 0.5,
                             spec.n)
    w[7, 3] = spec.nar_word                   # NaR: NaN in column 3 only
    got = ops.quant_matmul(x.to(dev), w.to(dev), spec).cpu()
    want = ref.qmatmul_ref(x, w, spec)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[:, 3]).all() and int(torch.isnan(got).sum()) == m
    fin = ~torch.isnan(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lut", LUT)
@pytest.mark.parametrize("spec", POSIT_SPECS, ids=lambda s: s.name)
def test_attention_over_posit_kv_matches_plain(dev, spec, lut, monkeypatch):
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    g = torch.Generator().manual_seed(11)
    b, tq, hkv, grp, hd, tmax = 2, 9, 2, 3, 128, 72
    q = torch.randn((b, tq, hkv * grp, hd), generator=g)
    kw = posit.float_to_posit(torch.randn((b, tmax, hkv, hd), generator=g),
                              spec.n)
    vw = posit.float_to_posit(torch.randn((b, tmax, hkv, hd), generator=g),
                              spec.n)
    start = torch.tensor([0, 5], dtype=torch.int32)
    got = ops.takum_attention(q.to(dev), kw.to(dev), vw.to(dev), 0, spec,
                              pos=40, start=start, block=32).cpu()
    want = ref.attention_ref(q, kw, vw, 0, spec, pos=40, start=start)
    valid = (40 + torch.arange(tq))[None, :] >= start[:, None].long()
    torch.testing.assert_close(got[valid], want[valid], rtol=0, atol=2e-5)
    kp, vp = (posit.float_to_posit(torch.randn((11, 16, 2, 16), generator=g),
                                   spec.n) for _ in range(2))
    kp[5, 8, 0, 0] = spec.nar_word            # seq 1, position 8, kv head 0
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 0, 0],
                          [0, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([63, 37, 20, 900], dtype=torch.int32)
    qd = torch.randn((4, 1, 4, 16), generator=g)
    got = ops.paged_attention(qd.to(dev), kp.to(dev), vp.to(dev),
                              table.to(dev), spec, pos=pos.to(dev)).cpu()
    want = ref.paged_attention_ref(qd, kp, vp, table, spec, pos=pos)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[1, 0, :2]).all()
    assert int(torch.isnan(got).sum()) == 32
    fin = ~torch.isnan(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=2e-5)


# -- fused fake-quant ----------------------------------------------------------


def _same_floats(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal where not NaN, NaN in the same places (PyTorch's NaN
    bits differ between its CPU and CUDA arithmetic)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    bits = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
    bbits = b.view(bits.dtype)
    return torch.equal(na, nb) and torch.equal(bits[~na], bbits[~nb])


FQ_NAMES = ["takum8", "takum16", "posit8", "posit16", "lns-takum8",
            "lns-takum16"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lut", LUT)
@pytest.mark.parametrize("name", FQ_NAMES)
def test_fake_quant_matches_plain(dev, name, lut, dtype, monkeypatch):
    """The fused kernel is the codec kernels' encode then decode, bit for
    bit, in one pass; against the plain version it is bit-exact, the LNS
    formats up to neighbour words (logf at an ell_bar tie, as the codec)."""
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    spec = formats.get(name)
    x = torch.from_numpy(_floats(np.random.default_rng(9), 50_000))
    x = x[:x.numel() // 7 * 7].reshape(-1, 7)[:, :5]   # non-contiguous
    xd = x.to(dev)
    got = ops.fake_quant_fused(xd, fmt=spec, dtype=dtype)
    assert got.dtype == dtype and got.shape == x.shape
    composed = takum_codec.decode(takum_codec.encode(xd, spec), spec).to(dtype)
    assert _same_floats(got, composed)
    if spec.kind != "lns":
        want = ref.fake_quant_ref(x, spec, dtype=dtype)
        assert _same_floats(got.cpu(), want)
        return
    wk = takum_codec.encode(xd, spec).cpu()
    wp = ref.encode_ref(xd, spec).cpu()
    mod = 1 << spec.n
    step = (carrier(wk).long() - carrier(wp).long()) % mod
    assert bool(torch.isin(step, torch.tensor([0, 1, mod - 1])).all())
    assert float((step != 0).double().mean()) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["takum8", "takum16"])
def test_scaled_fake_quant_matches_quantize_dequantize(dev, name, dtype):
    spec = formats.get(name)
    g = torch.Generator().manual_seed(12)
    x = torch.randn((300, 70), generator=g) * 0.02
    x[3, 4:7] = torch.tensor([0.0, -0.0, 1e-40])   # a finite absmax: scaled
    got = spec.fake_quant(x.to(dev), dtype=dtype).cpu()
    qs = quant.QuantSpec(fmt="takum", n=spec.n)
    want = quant.dequantize(quant.quantize(x, qs)).to(dtype)
    assert _same_floats(got, want)


def test_quantize_weights_fake_card_matches_cpu(dev):
    cfg = get_arch("phi3-medium-14b").reduced
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    layer = params["layers"][0]
    for fmt in ("takum8", "posit16", "lns-takum8"):
        n0 = quantize.fake_quant.launches
        card = quantize_weights({k: {n: t.to(dev) for n, t in v.items()}
                                 for k, v in layer.items()}, fmt,
                                verbose=False)
        assert quantize.fake_quant.launches == n0 + 7
        cpu = quantize_weights(layer, fmt, verbose=False)
        spec = formats.get(fmt)
        steps = []
        for k in ("attn", "mlp"):
            for n, t in cpu[k].items():
                assert card[k][n].dtype == t.dtype
                if spec.kind != "lns":
                    assert _same_floats(card[k][n].cpu(), t), (fmt, k, n)
                    continue
                # one logf on each side: the same word or its neighbour
                wc = carrier(spec.encode_tile(card[k][n].cpu())).long()
                wt = carrier(spec.encode_tile(t)).long()
                steps.append((wc - wt).reshape(-1))
        if steps:
            step = torch.cat(steps) % (1 << spec.n)
            assert bool(torch.isin(step, torch.tensor(
                [0, 1, (1 << spec.n) - 1])).all())
            assert float((step != 0).double().mean()) < 1e-4


def _value_edges(kind, n):
    """Floats at the value path's edges for width n, both signs: at every
    biased exponent the fraction of all ones (the carry into the next
    exponent; at c = 127 to +inf where the word keeps a fraction bit) and,
    at that exponent's dropped bits d (``ref._value_drop``), the tie, the
    tie +- 1, the tie above an odd kept bit; exponents with p < 1 (d > 22)
    and p = 0 (d = 23) among them. Every fifth element then made rare (0,
    a subnormal, +-inf, NaN), so that vectors of 4 mix rare and common
    elements."""
    e = torch.arange(1, 255, dtype=torch.int64)
    d = ref._value_drop(e, n, kind).clamp(1, 23)
    tie = 1 << (d - 1)
    odd = torch.where(d <= 22, tie | (1 << d.clamp(max=22)), tie)
    fracs = [torch.full_like(e, 0x7FFFFF), torch.zeros_like(e), tie,
             tie + 1, tie - 1, odd, odd - 1]
    bits = torch.cat([(e << 23) | (f & 0x7FFFFF) for f in fracs])
    bits = torch.cat([bits, bits | (1 << 31)])
    x = bits.to(torch.int32).view(torch.float32).clone()
    rare = torch.tensor([0.0, 1e-40, float("inf"), -float("inf"),
                         float("nan"), -1e-45])
    x[::5] = rare.repeat(x[::5].numel() // rare.numel() + 1)[:x[::5].numel()]
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [6, 7, 8, 12, 16, 24, 29, 32])
@pytest.mark.parametrize("kind", ["linear", "posit"])
def test_fake_quant_value_path_edges(dev, kind, n, dtype):
    """The value path's edges against the plain version, bit for bit (NaN
    by place): the carry of an all-ones fraction into the next exponent
    and to +inf at c = 127, the ties at each exponent's cut, p = 0 and
    p < 1 exponents (at n = 6 and 8 most of them), vectors mixing rare
    and common elements, unaligned runs of them."""
    spec = formats.resolve(kind, n)
    x = _value_edges(kind, n)
    for off in (0, 1, 2):
        xs = x[off:]
        got = quantize.fake_quant(xs.to(dev), spec, dtype=dtype).cpu()
        assert _same_floats(got, ref.fake_quant_ref(xs, spec, dtype=dtype))
    top = torch.tensor([0x7F7FFFFF, 0xFF7FFFFF], dtype=torch.int64).to(
        torch.int32).view(torch.float32)
    assert _same_floats(quantize.fake_quant(top.to(dev), spec).cpu(),
                        ref.fake_quant_ref(top, spec))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [4, -4, 60, -60, 127, -127])
@pytest.mark.parametrize("n", [8, 12, 16, 32])
def test_scaled_fake_quant_overflow_and_subnormal(dev, n, k, dtype):
    """Linear takum scaled by 2^k where x * 2^k overflows to inf or
    becomes subnormal (the word path), and where 2^-k takes the result
    into the subnormal band, against the plain version bit for bit."""
    spec = formats.resolve("linear", n)
    rng = np.random.default_rng(abs(k) + n)
    x = torch.from_numpy(_floats(rng, 20_000))
    x = torch.cat([x, _value_edges("linear", n)])
    got = quantize.fake_quant(x.to(dev), spec, dtype=dtype,
                              scale_exp=k).cpu()
    assert _same_floats(got, ref.fake_quant_ref(x, spec, dtype=dtype,
                                                scale_exp=k))


@pytest.mark.parametrize("name", ["takum8", "takum12", "posit8", "posit16",
                                  "lns-takum8", "lns-takum16"])
def test_fake_quant_misaligned_leaf_slice(dev, name, monkeypatch):
    """A slice of a leaf whose data is not 16-byte aligned (as
    ``_fake_leaf`` may pass one: the wrapper copies only what is not
    contiguous) takes the kernel's scalar loop throughout, and the C
    entry point called on misaligned pointers and counts 1..33: the
    same floats as the aligned call and, but for LNS, as the plain
    version."""
    monkeypatch.setenv("REPRO_LUT_DECODE", "1")
    spec = formats.resolve(name)
    rng = np.random.default_rng(31)
    leaf = torch.from_numpy(_floats(rng, 7 * 1001)[:7 * 1001]).reshape(
        7, 1001).to(dev)
    sl = leaf[3:]
    assert sl.is_contiguous() and sl.data_ptr() % 16 != 0
    got = quantize.fake_quant(sl, spec)
    assert _same_floats(got, quantize.fake_quant(sl.clone(), spec))
    if spec.kind != "lns":
        assert _same_floats(got.cpu(), ref.fake_quant_ref(sl.cpu(), spec))
    lib, code = quantize._lib(), build.format_code(spec, dev,
                                                   widths=build.CODEC_WIDTHS)
    flat = leaf.reshape(-1)
    for off in range(4):
        for cnt in range(1, 34):
            out = torch.empty(cnt + 4, dtype=torch.float32, device=dev)
            build.check(lib.takum_fake_quant(
                spec.n, code, 0, flat[off:].data_ptr(), out[off:].data_ptr(),
                cnt, 0, 1.0, 1.0, build.stream_of(flat)), "takum_fake_quant")
            assert _same_floats(out[off:off + cnt],
                                quantize.fake_quant(flat[off:off + cnt].clone(),
                                                    spec))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [8, 12, 16, 32])
def test_lns_fake_quant_is_the_codec_round_trip(dev, n, dtype):
    """LNS fake-quant against the codec kernels' round trip (the same
    tables, one logf and one expf an element), bit for bit, NaN by place,
    f32 and bf16 out."""
    spec = formats.resolve("lns", n)
    x = torch.from_numpy(_floats(np.random.default_rng(40 + n),
                                 100_000)).to(dev)
    x = torch.cat([x, _value_edges("linear", 16).to(dev)])
    want = takum_codec.decode(takum_codec.encode(x, spec), spec).to(dtype)
    assert _same_floats(quantize.fake_quant(x, spec, dtype=dtype), want)


def test_posit_and_fake_quant_wrappers_count_launches(dev):
    spec = formats.get("posit8")
    n0, q0 = takum_matmul.qmatmul.launches, quantize.fake_quant.launches
    w = posit.float_to_posit(torch.randn((64, 32)) / 8, 8)
    ops.quant_matmul(torch.randn((4, 64), device=dev), w.to(dev), spec)
    ops.fake_quant_fused(torch.randn(10, device=dev), 8, fmt="posit")
    ops.fake_quant_fused(torch.randn(10), 8, fmt="posit")   # CPU: plain
    assert takum_matmul.qmatmul.launches == n0 + 1
    assert quantize.fake_quant.launches == q0 + 1


# -- the fused KV append and the decode step replayed from a CUDA graph ------


def _kv_bits(t: torch.Tensor) -> torch.Tensor:
    """A cache's bits as integers (float caches through their int view)."""
    t = carrier(t)
    return {torch.bfloat16: lambda: t.view(torch.int16),
            torch.float32: lambda: t.view(torch.int32)}.get(
        t.dtype, lambda: t)()


def _same_cache(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit-exact; NaN by place in a float cache (payloads differ)."""
    if got.dtype in (torch.bfloat16, torch.float32):
        nan = torch.isnan(want)
        return (torch.equal(torch.isnan(got), nan)
                and torch.equal(_kv_bits(got)[~nan], _kv_bits(want)[~nan]))
    return torch.equal(_kv_bits(got), _kv_bits(want))


def _append_inputs(kv, shape, cache_shape, seed, in_dtype):
    spec, dtype = kv
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randn(shape, generator=g)
            * 2.0 ** torch.randint(-20, 20, shape, generator=g)
            for _ in range(2))
    k.view(-1)[:5] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                   float("nan")])
    k, v = k.to(in_dtype), v.to(in_dtype)
    kc, vc = (_cache(spec, cache_shape, g, dtype) for _ in range(2))
    return k, v, kc, vc


def _plain_append(kv, k, v, kc, vc, **where):
    """The plain version on the card; LNS words through the encode kernel
    (one logf on each side: the plain codec's log may round an ell_bar tie
    the other way, which phase 7 of chip_smoke.py bounds)."""
    spec = kv[0]
    enc = takum_codec.encode if spec.kind == "lns" else ref.encode_ref
    ref.kv_append_ref(k, v, kc, vc, spec, encode=enc, **where)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_kv_append_paged_matches_plain(dev, kv, in_dtype):
    """An active row, an idle slot on the scratch page and one whose stale
    pos lies past its table, one launch for K and V."""
    k, v, kc, vc = _append_inputs(kv, (4, 1, 2, 16), (7, 8, 2, 16), 21,
                                  in_dtype)
    table = torch.tensor([[1, 2], [3, 4], [0, 0], [5, 6]], dtype=torch.int32)
    pos = torch.tensor([11, 3, 0, 999], dtype=torch.int32)
    wk, wv = kc.to(dev), vc.to(dev)
    _plain_append(kv, k.to(dev), v.to(dev), wk, wv, pos=pos.to(dev),
                  table=table.to(dev))
    gk, gv = kc.to(dev), vc.to(dev)
    n0 = takum_codec.kv_append.launches
    takum_codec.kv_append(k.to(dev), v.to(dev), gk, gv, kv[0],
                          pos=pos.to(dev), table=table.to(dev))
    assert takum_codec.kv_append.launches == n0 + 1
    assert _same_cache(gk, wk) and _same_cache(gv, wv)


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_kv_append_hd112_matches_plain(dev, kv, mode):
    """The append at head dim 112, bf16 K/V as served: a decode step into
    pages (an idle slot past its table) and a chunk into a contiguous
    cache."""
    if mode == "paged":
        k, v, kc, vc = _append_inputs(kv, (4, 1, 8, 112), (7, 8, 8, 112),
                                      23, torch.bfloat16)
        where = dict(pos=torch.tensor([11, 3, 0, 999], dtype=torch.int32,
                                      device=dev),
                     table=torch.tensor([[1, 2], [3, 4], [0, 0], [5, 6]],
                                        dtype=torch.int32, device=dev))
    else:
        k, v, kc, vc = _append_inputs(kv, (1, 16, 8, 112), (1, 48, 8, 112),
                                      24, torch.bfloat16)
        where = dict(pos=19)
    wk, wv = kc.to(dev), vc.to(dev)
    _plain_append(kv, k.to(dev), v.to(dev), wk, wv, **where)
    gk, gv = kc.to(dev), vc.to(dev)
    takum_codec.kv_append(k.to(dev), v.to(dev), gk, gv, kv[0], **where)
    assert _same_cache(gk, wk) and _same_cache(gv, wv)


@pytest.mark.parametrize("hd", [192, 256])
@pytest.mark.parametrize("mode", ["paged", "contiguous"])
@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_kv_append_hd192_256_matches_plain(dev, kv, mode, hd):
    """The append at head dims 192 (8 KV heads, nemotron-4-340b's) and 256
    (one KV head, recurrentgemma-2b's), bf16 K/V as served, bit for bit:
    the append takes any head dim that is a multiple of 4."""
    hkv = 8 if hd == 192 else 1
    if mode == "paged":
        k, v, kc, vc = _append_inputs(kv, (4, 1, hkv, hd), (7, 8, hkv, hd),
                                      25, torch.bfloat16)
        where = dict(pos=torch.tensor([11, 3, 0, 999], dtype=torch.int32,
                                      device=dev),
                     table=torch.tensor([[1, 2], [3, 4], [0, 0], [5, 6]],
                                        dtype=torch.int32, device=dev))
    else:
        k, v, kc, vc = _append_inputs(kv, (2, 16, hkv, hd), (2, 48, hkv, hd),
                                      26, torch.bfloat16)
        where = dict(pos=19)
    wk, wv = kc.to(dev), vc.to(dev)
    _plain_append(kv, k.to(dev), v.to(dev), wk, wv, **where)
    gk, gv = kc.to(dev), vc.to(dev)
    takum_codec.kv_append(k.to(dev), v.to(dev), gk, gv, kv[0], **where)
    assert _same_cache(gk, wk) and _same_cache(gv, wv)


@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_kv_append_contiguous_matches_plain(dev, kv):
    k, v, kc, vc = _append_inputs(kv, (2, 5, 2, 16), (2, 24, 2, 16), 22,
                                  torch.float32)
    wk, wv = kc.to(dev), vc.to(dev)
    _plain_append(kv, k.to(dev), v.to(dev), wk, wv, pos=7)
    gk, gv = kc.to(dev), vc.to(dev)
    takum_codec.kv_append(k.to(dev), v.to(dev), gk, gv, kv[0], pos=7)
    assert _same_cache(gk, wk) and _same_cache(gv, wv)


def _serve_twice(kv, wfmt=None, arch="phi3-medium-14b"):
    """The reduced config served on the card with the step replayed from
    a graph and under ``disable_graphs``: four requests, one finishing
    early, a fifth submitted mid-run and admitted when a slot frees (a
    push_tables between replays). Per mode: tokens, each step's (active
    slots, their logits), the pool, the launch counts, the step runner."""
    cfg, params = _reduced(kv, wfmt, arch)
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (16, 9, 4, 13, 7)]
    out = {}
    for mode in ("graph", "eager"):
        eng = ServeEngine(params, cfg, max_len=64, page_size=16,
                          decode_batch=4, device="cuda")
        sched = eng.scheduler()
        runner, rows = sched.step, []

        def rec(tok, pos, runner=runner, rows=rows, sched=sched):
            logits, head = runner(tok, pos)
            act = [i for i, s in enumerate(sched._slots)
                   if s is not None and s.state == "active"]
            rows.append((act, logits[act].clone()))
            return logits, head

        sched.step = rec
        c0 = graphs._read_counters()
        with (graphs.disable_graphs() if mode == "eager" else
              contextlib.nullcontext()):
            rids = [eng.submit(p, m) for p, m in zip(prompts, (24, 5, 24,
                                                               24))]
            for n, _ in enumerate(eng.run()):
                if n == 12:
                    rids.append(eng.submit(prompts[4], 10))
        torch.cuda.synchronize()
        out[mode] = dict(toks=[eng.result(r) for r in rids], rows=rows,
                         pool=sched.pool, runner=runner,
                         counts=[b - a for a, b in
                                 zip(c0, graphs._read_counters())])
    return out


@pytest.mark.parametrize("kv,wfmt", [("takum8", None),
                                     ("lns-takum8", "lns-takum16"),
                                     ("none", "takum8")])
def test_graph_replay_matches_eager(dev, kv, wfmt):
    out = _serve_twice(kv, wfmt)
    g, e = out["graph"], out["eager"]
    assert g["runner"].captures == 1 and g["runner"].replays >= 20
    assert e["runner"].captures == 0
    assert g["toks"] == e["toks"]
    assert len(g["rows"]) == len(e["rows"])
    for (ag, lg), (ae, le) in zip(g["rows"], e["rows"]):
        assert ag == ae
        assert torch.equal(lg.view(torch.int32), le.view(torch.int32))
    for lg, le in zip(g["pool"].cache, e["pool"].cache):
        for key in ("k", "v", "table", "pos", "start"):
            assert torch.equal(_kv_bits(lg[key]), _kv_bits(le[key])), key


MOE_ARCHS = ["granite-moe-3b-a800m", "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_graph_replay_matches_eager(dev, arch):
    """The moe decode step (routing, sort, dispatch and combine of one
    group of the 4 slots) captured and replayed: active-row logits and
    pools bit for bit against the eager step."""
    out = _serve_twice("takum8", arch=arch)
    g, e = out["graph"], out["eager"]
    assert g["runner"].captures == 1 and g["runner"].replays >= 20
    assert g["toks"] == e["toks"]
    assert len(g["rows"]) == len(e["rows"])
    for (ag, lg), (ae, le) in zip(g["rows"], e["rows"]):
        assert ag == ae
        assert torch.equal(lg.view(torch.int32), le.view(torch.int32))
    for lg, le in zip(g["pool"].cache, e["pool"].cache):
        for key in ("k", "v", "table", "pos", "start"):
            assert torch.equal(_kv_bits(lg[key]), _kv_bits(le[key])), key
    assert g["counts"] == e["counts"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_serving_card_matches_cpu(dev, arch):
    cfg, params = _reduced("takum8", None, arch)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (16, 9, 4, 13)]
    outs = {}
    for d in ("cpu", dev):
        eng = ServeEngine(params, cfg, max_len=48, page_size=16, device=d)
        outs[str(d)] = (eng.generate(prompts, 6), eng.generate(prompts, 6))
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.parametrize("arch", ["minitron-4b", "starcoder2-15b",
                                  "nemotron-4-340b", "recurrentgemma-2b"])
def test_reduced_new_families_card_matches_cpu(dev, arch):
    """The relu2/gelu dense configs through the scheduler and
    recurrentgemma-2b through lockstep, takum8 wire weights and KV: the
    card's greedy tokens are the CPU's (prompts longer than
    recurrentgemma's reduced window of 32, left-padded)."""
    cfg, params = _reduced("takum8", None, arch)
    rng = np.random.default_rng(3)
    plens = (45, 38, 33) if arch == "recurrentgemma-2b" else (16, 9, 4, 13)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in plens]
    outs = {}
    for d in ("cpu", dev):
        eng = ServeEngine(params, cfg, max_len=64, page_size=16, device=d)
        outs[str(d)] = eng.generate(prompts, 6)
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.parametrize("arch,kv", [("rwkv6-1.6b", "takum8"),
                                     ("seamless-m4t-large-v2", "none"),
                                     ("llama-3.2-vision-11b", "takum8")])
def test_reduced_lockstep_families_card_matches_cpu(dev, arch, kv):
    """rwkv6, encdec (its float cache) and vlm through lockstep with the
    frontend stub's media, takum8 wire weights: the card's greedy tokens
    are the CPU's (left-padded prompts, rwkv6's no multiple of 64)."""
    cfg, params = _reduced(kv, "takum8", arch)
    rng = np.random.default_rng(4)
    plens = (45, 38, 7)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in plens]
    media = None
    if cfg.frontend == "vision":
        media = rng.normal(size=(3, cfg.n_media_tokens,
                                 cfg.d_media or cfg.d_model))
    elif cfg.frontend == "audio":
        media = rng.normal(size=(3, 12, cfg.d_model))
    outs = {}
    for d in ("cpu", dev):
        eng = ServeEngine(params, cfg, max_len=64, device=d)
        outs[str(d)] = eng.generate(prompts, 6, media=media)
    assert outs["cpu"] == outs["cuda"]


def test_launch_counts_equal_under_replay(dev):
    out = _serve_twice("takum8")
    assert out["graph"]["counts"] == out["eager"]["counts"]
    names = [f"{m}.{f}.{a}" for m, f, a in graphs.COUNTERS]
    counts = dict(zip(names, out["graph"]["counts"]))
    assert counts["takum_codec.kv_append.launches"] > 0
    assert counts["takum_codec.encode.launches"] == 0


def test_a_step_that_cannot_be_captured_raises(dev, monkeypatch):
    from repro_torch.models import model
    cfg, params = _reduced("takum8")
    eng = ServeEngine(params, cfg, max_len=32, page_size=16,
                      decode_batch=2, device="cuda")
    orig = model.decode_step

    def syncing(*args, **kwargs):
        logits, cache = orig(*args, **kwargs)
        float(logits.sum())           # a host sync: refused in a capture
        return logits, cache

    monkeypatch.setattr(model, "decode_step", syncing)
    with pytest.raises(RuntimeError):
        eng.generate([[1, 2, 3]], 4)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    torch.cuda.synchronize()


# -- lockstep, NaR containment and the replayed step's NaN flags ------------


@pytest.mark.parametrize("kv", KV, ids=_kv_id)
def test_contiguous_attention_tq1_left_padded_matches_plain(dev, kv):
    """A lockstep decode step: tq = 1, rows = G per KV head, per-row
    left-pad ``start``; then NaR V words (NaN for a float cache) in every
    padding position change nothing, on the card and in the plain
    version."""
    spec, dtype = kv
    g = torch.Generator().manual_seed(11)
    b, hkv, grp, hd, tmax = 3, 2, 4, 128, 300
    q = torch.randn((b, 1, hkv * grp, hd), generator=g)
    if dtype is not None:
        q = q.to(dtype)
    kw = _cache(spec, (b, tmax, hkv, hd), g, dtype)
    vw = _cache(spec, (b, tmax, hkv, hd), g, dtype)
    start = torch.tensor([0, 37, 260], dtype=torch.int32)
    vp = vw.clone()
    for i, st in enumerate(start.tolist()):
        if spec.is_identity:
            vp[i, :st] = float("nan")
        else:
            nar = spec.nar_word - ((1 << 16) if spec.n == 16 else 0)
            carrier(vp)[i, :st] = nar
    for pos in (270, 299):
        kwargs = dict(pos=pos, start=start)
        got = ops.takum_attention(q.to(dev), kw.to(dev), vw.to(dev), 0,
                                  spec, **kwargs).cpu()
        want = ref.attention_ref(*_plain_f32(spec, q, kw, vw), 0, spec,
                                 **kwargs)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        padded = ops.takum_attention(q.to(dev), kw.to(dev), vp.to(dev), 0,
                                     spec, **kwargs).cpu()
        assert torch.equal(padded, got)
        plain = ref.attention_ref(*_plain_f32(spec, q, kw, vp), 0, spec,
                                  **kwargs)
        assert torch.equal(plain, want)


@pytest.mark.parametrize("kv", [(formats.get("none"), torch.bfloat16),
                                (formats.get("takum8"), None)], ids=_kv_id)
@pytest.mark.parametrize("tq,pos", [(1, 40), (1, 299), (24, 0)],
                         ids=["step", "step_last", "prefill"])
def test_contiguous_attention_hd64_mha_matches_plain(dev, kv, tq, pos):
    """encdec's decoder self-attention: hd 64, 16 query heads on 16 KV
    heads (G 1, MHA), no ``start`` (encdec's cache takes none), the
    config's bf16 cache and a takum8 one; a lockstep step (tq 1) and a
    prefill from position 0."""
    spec, dtype = kv
    g = torch.Generator().manual_seed(64 + tq)
    b, hkv, hd, tmax = 4, 16, 64, 320
    q = torch.randn((b, tq, hkv, hd), generator=g)
    if dtype is not None:
        q = q.to(dtype)
    kw = _cache(spec, (b, tmax, hkv, hd), g, dtype)
    vw = _cache(spec, (b, tmax, hkv, hd), g, dtype)
    n0 = takum_attention.attention.launches
    got = ops.takum_attention(q.to(dev), kw.to(dev), vw.to(dev), 0, spec,
                              pos=pos).cpu()
    assert takum_attention.attention.launches == n0 + 1
    want = ref.attention_ref(*_plain_f32(spec, q, kw, vw), 0, spec, pos=pos)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    if dtype == torch.bfloat16:
        plain = ref.attention_ref(q, kw, vw, 0, spec, pos=pos)
        torch.testing.assert_close(got, plain.float(), rtol=0,
                                   atol=BF16_ATOL)


@pytest.mark.parametrize("kv", [(formats.get("takum8"), None),
                                (formats.get("takum16"), None),
                                (formats.get("none"), torch.bfloat16)],
                         ids=_kv_id)
def test_paged_nar_in_band_and_masked_pages(dev, kv):
    """NaR K and NaR V words (NaN for a float cache) at valid positions
    of in-band pages, in a later partition than the first, and NaR K and
    V on a page past its sequence's pos (out of band): NaN in exactly the
    plain version's rows, through the partitions and their merge; the
    out-of-band words reach nothing."""
    _check_paged_nar_in_band(kv, 128)


@pytest.mark.parametrize("kv", [(formats.get("takum8"), None),
                                (formats.get("takum16"), None),
                                (formats.get("none"), torch.bfloat16)],
                         ids=_kv_id)
def test_paged_nar_in_band_and_masked_pages_hd112(dev, kv):
    """The check above at head dim 112 (idle lanes in every warp)."""
    _check_paged_nar_in_band(kv, 112)


def _check_paged_nar_in_band(kv, hd):
    dev = "cuda"
    spec, dtype = kv
    q, kw, vw, table, pos, start, window = _paged_edge_inputs(
        spec, dtype, "page_boundary", 21, hd=hd)
    clean = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                                table.to(dev), spec, pos=pos.to(dev),
                                start=start.to(dev)).cpu()
    nar = float("nan") if spec.is_identity else takum.nar_word(spec.n)
    kw[table[1, 6], 2, 0, 5] = nar       # seq 1, position 98 <= pos 127
    vw[table[2, 9], 4, 1, 9] = nar       # seq 2, position 148 <= pos 191
    kw[table[0, 3], 0, 1, 0] = nar       # seq 0, page 3: past pos 16
    vw[table[0, 3], 1, 0, 0] = nar
    got = ops.paged_attention(q.to(dev), kw.to(dev), vw.to(dev),
                              table.to(dev), spec, pos=pos.to(dev),
                              start=start.to(dev)).cpu()
    want = ref.paged_attention_ref(*_plain_f32(spec, q, kw, vw), table, spec,
                                   pos=pos, start=start)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert nan[1, 0, :4].all() and nan[2, 0, 4:, 9].all()
    assert int(nan.sum()) == 4 * hd + 4
    assert torch.equal(got[0], clean[0]) and torch.equal(got[3], clean[3])
    torch.testing.assert_close(got[~nan], want[~nan], rtol=0, atol=2e-5)


def _serve_faulted(mode, kv="takum8"):
    """The reduced config served with one NaR injected into a live page
    after the step has been captured: per step the active slots and the
    step's head rows (greedy tokens, NaN flags); statuses; the runner."""
    cfg, params = _reduced(kv)
    rng = np.random.default_rng(9)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (16, 9, 13)]
    eng = ServeEngine(params, cfg, max_len=64, page_size=16,
                      decode_batch=4, prefix_cache=False, device="cuda")
    sched = eng.scheduler()
    runner, heads = sched.step, []

    def rec(tok, pos):
        logits, head = runner(tok, pos)
        act = [i for i, s in enumerate(sched._slots)
               if s is not None and s.state == "active"]
        heads.append((act, head[:, act].cpu()))
        return logits, head

    sched.step = rec
    inj = FaultInjector(sched.pool, rate=1.0, seed=2, kind="nar",
                        target="live", max_faults=1)
    with (graphs.disable_graphs() if mode == "eager" else
          contextlib.nullcontext()):
        rids = [eng.submit(p, 12) for p in prompts]
        for n, _ in enumerate(eng.run()):
            if n == 9:                 # the step has been replayed by now
                sched.injector = inj
    torch.cuda.synchronize()
    return dict(heads=heads, status=[eng.status(r) for r in rids],
                runner=runner, injected=inj.injected)


def test_replayed_step_nan_flags_equal_the_eager_steps(dev):
    """The NaN flag computed inside the captured step: per step the
    replayed head (tokens and flags of the active rows) equals the eager
    step's; the injected word poisons one request, through a replay,
    and the graph is never captured again."""
    g, e = _serve_faulted("graph"), _serve_faulted("eager")
    assert g["injected"] == e["injected"] and len(g["injected"]) == 1
    assert g["status"] == e["status"]
    assert g["status"].count("poisoned") == 1
    assert g["runner"].captures == 1 and g["runner"].replays >= 10
    assert len(g["heads"]) == len(e["heads"])
    flagged = 0
    for (ag, hg), (ae, he) in zip(g["heads"], e["heads"]):
        assert ag == ae and torch.equal(hg, he)
        flagged += int(hg[1].sum())
    assert flagged == 1


def test_in_place_fault_write_is_seen_by_the_next_replay(dev):
    """A NaR word written into the pool between two replays, in place:
    the next replay reads it (that row's flag is set), the other rows
    stay clean, no capture happens."""
    cfg, params = _reduced("takum8")
    eng = ServeEngine(params, cfg, max_len=64, page_size=16,
                      decode_batch=2, prefix_cache=False, device="cuda")
    rids = [eng.submit([5] * 12, 30), eng.submit([7] * 9, 30)]
    sched = eng.scheduler()
    stream = sched.run()
    while sched.step.replays < 2:
        next(stream)
    pool = sched.pool
    inj = FaultInjector(pool, rate=1.0, seed=0, kind="nar")
    (rec,) = inj.step(sched._tick)
    tok = torch.tensor([[1], [1]])
    pos = torch.from_numpy(pool.pos[:, None].astype(np.int64))
    pos_dev = pool.cache[0]["pos"].clone()
    _, head = sched.step(tok, pos)
    flags = head[1].tolist()
    assert flags[rec.slot] == 1 and flags[1 - rec.slot] == 0
    assert sched.step.captures == 1
    pool.cache[0]["pos"].copy_(pos_dev)      # undo this probe's advance
    rest = list(stream)
    assert eng.status(rids[rec.slot]) == "poisoned"
    assert eng.status(rids[1 - rec.slot]) == "done"
    assert any(e.status == "poisoned" for e in rest)


def test_lockstep_card_matches_cpu(dev):
    """``generate_lockstep`` of a left-padded batch on the card (the
    cache rounded to the KV tile, contiguous attention at tq = 1 every
    step) gives the CPU run's tokens."""
    cfg, params = _reduced("takum8")
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, cfg.vocab, n)))
               for n in (16, 9, 4, 13)]
    outs = [ServeEngine(params, cfg, max_len=48, device=d)
            .generate_lockstep(prompts, 8) for d in ("cpu", dev)]
    assert outs[0] == outs[1]


def test_capture_reaches_the_compile_watcher(dev):
    from repro_torch.obs import ServeObs
    obs = ServeObs()
    cfg, params = _reduced("takum8")
    eng = ServeEngine(params, cfg, max_len=32, page_size=16,
                      decode_batch=2, device="cuda")
    eng.generate([[1, 2, 3]], 6)
    assert obs.compile_watcher.compiles == eng.scheduler().step.captures == 1
    obs.arm_steady()
    eng.generate([[4, 5, 6, 7]], 6)          # same shapes: no capture
    assert obs.steady_state_recompiles == 0
    obs.close()


# -- training: the wire matmuls' VJP and the train step -----------------


@pytest.mark.parametrize("fmt,lut", [("takum8", "0"), ("takum16", "0"),
                                     ("posit8", "0"), ("posit8", "1"),
                                     ("posit16", "0"), ("lns-takum8", "0"),
                                     ("lns-takum16", "0")])
def test_wire_matmul_gradient_card_matches_plain(dev, fmt, lut,
                                                 monkeypatch):
    """``x.grad = g @ decode(w)^T`` through the decode kernel on the card
    (one launch a backward) against the plain backward on the CPU, for
    the same upstream ``g``: f32 sums over N = 96 in another order."""
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    spec = formats.get(fmt)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(3, 7, 80)).astype(np.float32))
    w = ops.takum_encode(torch.from_numpy(
        (rng.normal(size=(80, 96)) / 80 ** 0.5).astype(np.float32)), spec)
    g = torch.from_numpy(rng.normal(size=(3, 7, 96)).astype(np.float32))
    fn = ops.lns_matmul if spec.has_lns_parts else ops.quant_matmul
    grads = []
    for d in ("cpu", dev):
        xt = x.to(d).detach().requires_grad_(True)
        out = fn(xt, w.to(d), spec)
        n0 = takum_codec.decode.launches
        out.backward(g.to(d))
        if d != "cpu":
            assert takum_codec.decode.launches == n0 + 1
        grads.append(xt.grad.cpu())
    wd = spec.decode_tile(w)
    tol = 2 * 96 * 2.0 ** -24 * (g.abs() @ wd.abs().T) + 1e-30
    assert bool(((grads[1] - grads[0]).abs() <= tol).all())


def test_train_step_card_matches_cpu(dev):
    """The reduced config (f32) from the same parameters on the card and
    on the CPU: the first step's gradients, leaf by leaf, within 1e-4 of
    the leaf's largest gradient (f32 sums over 128 tokens and K <= 192
    in other orders differ by about 1e-6 of it; TF32 products by about
    1e-3), and three steps' losses within 1e-5 relative."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_arch("phi3-medium-14b").reduced
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="const",
                           clip_norm=1e9)
    rt = RuntimeConfig(remat="block")
    step = trainer.make_train_step(cfg, ocfg, rt)
    grads_of = trainer._grads_fn(cfg, rt)
    ds = dp.SyntheticLM(cfg.vocab, 64, 2, seed=3)
    runs = []
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d), params)
        batch = {k: torch.from_numpy(v).long().to(d)
                 for k, v in ds.batch_at(0).items()}
        _, _, g = grads_of(p, batch)
        st = opt.init_state(p)
        losses = []
        for s in range(3):
            p, st, m = step(p, st, ds.batch_at(s))
            losses.append(float(m["loss"]))
        runs.append((losses, [x.cpu() for x in tree_leaves(g)]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for a, b in zip(runs[1][1], runs[0][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# -- the codec and fake-quant at other widths; rows before start -------------

WIDTH_SPECS = [formats.resolve(k, n) for n in (12, 24, 32)
               for k in ("linear", "lns", "posit")]


def _ulps_t(a, b):
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("spec", WIDTH_SPECS, ids=lambda s: s.name)
def test_codec_and_fake_quant_at_other_widths(dev, spec):
    """Decode of seeded words, encode and fake-quant of seeded floats at
    n = 12, 24 and 32 against the plain versions: bit for bit (NaN by
    place) for linear takum and posit; LNS decodes within 2 ulp, words
    equal to the plain version's on the card or, where its log lands on a
    rounding tie, the neighbour (rare), and the fused round trip equal to
    the codec kernels'."""
    from repro_torch.core.bitops import lanes, to_words
    rng = np.random.default_rng(spec.n)
    w = to_words(torch.from_numpy(rng.integers(0, 2 ** spec.n, 100_000)),
                 spec.word_dtype)
    got = takum_codec.decode(w.to(dev), spec).cpu()
    want = ref.decode_ref(w, spec)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    tol = 2 if spec.kind == "lns" else 0
    assert int(_ulps_t(got[~nan], want[~nan]).max()) <= tol
    x = torch.from_numpy(_floats(rng, 100_000))
    gw = lanes(takum_codec.encode(x.to(dev), spec).cpu())
    ww = lanes(ref.encode_ref(x, spec))
    fq = quantize.fake_quant(x.to(dev), spec)
    if spec.kind == "lns":
        ww = lanes(ref.encode_ref(x.to(dev), spec).cpu())
        step = (gw - ww) % (1 << spec.n)
        assert bool(torch.isin(step, torch.tensor([0, 1, (1 << spec.n) - 1])
                               ).all())
        assert float((step != 0).double().mean()) < 1e-4
        rt = takum_codec.decode(takum_codec.encode(x.to(dev), spec), spec)
    else:
        assert torch.equal(gw, ww)
        rt = ref.fake_quant_ref(x, spec).to(dev)
    na = torch.isnan(fq)
    assert torch.equal(na, torch.isnan(rt))
    assert torch.equal(fq[~na].view(torch.int32), rt[~na].view(torch.int32))


def test_served_kernels_refuse_other_widths_on_the_card(dev):
    """The wire matmul, contiguous and paged attention, ``kv_append`` and
    the LNS matmul refuse 12-bit words by name before any launch."""
    t12, l12 = formats.resolve("takum12"), formats.resolve("lns-takum12")
    x = torch.randn(4, 64, device=dev)
    w = takum_codec.encode(torch.randn(64, 32, device=dev), t12)
    lw = takum_codec.encode(torch.randn(64, 32, device=dev), l12)
    kc = takum_codec.encode(torch.randn(1, 16, 2, 64, device=dev), t12)
    q4 = torch.randn(1, 2, 2, 64, device=dev)
    before = (takum_matmul.qmatmul.launches,
              takum_attention.attention.launches,
              takum_attention.paged_attention.launches,
              takum_codec.kv_append.launches, klns.lns_matmul.launches)
    calls = [
        lambda: takum_matmul.qmatmul(x, w, t12),
        lambda: takum_attention.attention(q4, kc, kc, 0, spec=t12, tq=1),
        lambda: takum_attention.paged_attention(
            q4, kc, kc, torch.zeros(1, dtype=torch.int32, device=dev), None,
            torch.zeros(1, 1, dtype=torch.int32, device=dev), spec=t12),
        lambda: takum_codec.kv_append(x.reshape(1, 1, 2, 128)[..., :64],
                                      x.reshape(1, 1, 2, 128)[..., :64],
                                      kc, kc, t12, pos=0),
        lambda: klns.lns_matmul(takum_codec.encode(x, l12), lw, l12)]
    for call in calls:
        with pytest.raises((ValueError, TypeError), match="12"):
            call()
    assert before == (takum_matmul.qmatmul.launches,
                      takum_attention.attention.launches,
                      takum_attention.paged_attention.launches,
                      takum_codec.kv_append.launches,
                      klns.lns_matmul.launches)


@pytest.mark.parametrize("name", ["takum8", "lns-takum16"])
@pytest.mark.parametrize("hd,hkv,grp", [(64, 2, 2), (112, 4, 2), (128, 8, 4),
                                        (192, 2, 3), (256, 1, 10)])
def test_contiguous_attention_rows_before_start(dev, hd, hkv, grp, name):
    """Left-padded starts at pos 0: every row against the plain version
    (2e-5), those before ``start`` the uniform average of V over the
    whole cache; a NaR V word in the padding reaches no row at or after
    ``start``."""
    spec = formats.get(name)
    g = torch.Generator().manual_seed(hd)
    b, tq, tmax = 3, 40, 72
    q = torch.randn((b, tq, hkv * grp, hd), generator=g)
    kc, vc = (spec.encode_tile(torch.randn((b, tmax, hkv, hd), generator=g))
              for _ in range(2))
    st = torch.tensor([17, 5, 0], dtype=torch.int32)
    want = ref.attention_ref(q, kc, vc, spec.n, spec, pos=0, start=st)
    got = ops.takum_attention(q.to(dev), kc.to(dev), vc.to(dev), spec.n,
                              spec, pos=0, start=st.to(dev)).cpu()
    assert float((got - want).abs().max()) <= 2e-5
    vbar = spec.decode_tile(vc[0]).mean(0).repeat_interleave(grp, 0)
    assert float((got[0, :17] - vbar).abs().max()) <= 2e-5
    vn = vc.clone()
    vn[0, 3] = spec.nar_word
    nar = ops.takum_attention(q.to(dev), kc.to(dev), vn.to(dev), spec.n,
                              spec, pos=0, start=st.to(dev)).cpu()
    assert torch.isfinite(nar[0, 17:]).all() and torch.isfinite(nar[1:]).all()
    assert float((nar[0, 17:] - got[0, 17:]).abs().max()) <= 2e-5


# -- the codec kernels' vectors and tables (csrc/codec.cu, codec.cuh) -------

SWEEP_SPECS = [formats.resolve(k, n) for k in ("linear", "posit")
               for n in (8, 16)]
RAGGED_SPECS = [formats.resolve(k, n) for n in (8, 12, 16, 24, 32)
                for k in ("linear", "lns", "posit")]


@pytest.mark.parametrize("spec", SWEEP_SPECS, ids=lambda s: s.name)
def test_encode_every_float32_pattern(dev, spec):
    """All 2^32 float32 bit patterns through the encode kernel, equal to
    the plain version on the card, 2^26 patterns a chunk."""
    from repro_torch.core.bitops import lanes
    chunk = 1 << 26
    for i0 in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(i0, i0 + chunk, dtype=torch.int64, device=dev).to(
            torch.int32).view(torch.float32)
        got = lanes(takum_codec.encode(x, spec))
        want = lanes(ref.encode_ref(x, spec))
        assert torch.equal(got, want), (spec.name, i0)


def _same_or_lns(spec, x, got_w, want_w, got_f, want_f):
    """Linear and posit words bit for bit; LNS words the plain version's
    or, at a logf tie of ``x``, its neighbour (chip_smoke.py's
    ``lns_encode_ok``); floats NaN by place, LNS within 2 ulp."""
    from repro_torch.core.bitops import lanes
    gw, ww = lanes(got_w), lanes(want_w)
    if spec.kind == "lns":
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        from chip_smoke import lns_encode_bounds, lns_encode_ok
        lo, hi = lns_encode_bounds(torch, x, spec.n)
        assert bool(lns_encode_ok(gw, ww, lo, hi, spec.n).all())
    else:
        assert torch.equal(gw, ww)
    nan = torch.isnan(want_f)
    assert torch.equal(torch.isnan(got_f), nan)
    tol = 2 if spec.kind == "lns" else 0
    if bool((~nan).any()):
        assert int(_ulps_t(got_f[~nan], want_f[~nan]).max()) <= tol


@pytest.mark.parametrize("spec", RAGGED_SPECS, ids=lambda s: s.name)
def test_codec_ragged_and_misaligned(dev, spec):
    """Counts 1..33 at offsets 0..3 (views whose data is not 16-byte
    aligned; the wrappers realign them) through decode and encode, and
    the C entry points called directly on misaligned pointers (the
    kernels' scalar loop throughout), against the plain version on the
    card: linear and posit bit for bit, LNS words equal or the neighbour
    at a logf tie, LNS floats within 2 ulp."""
    from repro_torch.kernels import build
    rng = np.random.default_rng(spec.n)
    base = torch.from_numpy(_floats(rng, 200)).to(dev)
    words = takum_codec.encode(base, spec)
    for off in range(4):
        for cnt in range(1, 34):
            x, w = base[off:off + cnt], words[off:off + cnt]
            _same_or_lns(spec, x, takum_codec.encode(x, spec),
                         ref.encode_ref(x, spec), takum_codec.decode(w, spec),
                         ref.decode_ref(w, spec))
    lib = takum_codec._lib()
    code = build.format_code(spec, dev, widths=build.CODEC_WIDTHS)
    cnt = base.numel() - 1
    out = torch.empty(cnt + 1, dtype=torch.float32, device=dev)
    wout = torch.empty_like(words)
    build.check(lib.takum_decode(spec.n, code, 0, words[1:].data_ptr(),
                                 out[1:].data_ptr(), cnt,
                                 build.stream_of(words)), "takum_decode")
    build.check(lib.takum_encode(spec.n, code, base[1:].data_ptr(),
                                 wout[1:].data_ptr(), cnt,
                                 build.stream_of(base)), "takum_encode")
    torch.cuda.synchronize()
    _same_or_lns(spec, base[1:], wout[1:], ref.encode_ref(base[1:], spec),
                 out[1:], ref.decode_ref(words[1:], spec))


@pytest.mark.parametrize("n", list(range(6, 17)))
@pytest.mark.parametrize("kind", ["linear", "lns", "posit"])
def test_decode_every_word_against_plain_and_table8(dev, kind, n,
                                                    monkeypatch):
    """Every word at n <= 16 through the decode kernel against the plain
    version on the card (posit8 through its table and computed), and at
    n = 8 against the 256 floats of the plain decode (the Table8 every
    8-bit kernel reads): bit for bit, LNS within 2 ulp."""
    from repro_torch.core.bitops import to_words
    spec = formats.resolve(kind, n)
    words = to_words(torch.arange(2 ** n, device=dev), spec.word_dtype)
    want = ref.decode_ref(words, spec)
    tol = 2 if kind == "lns" else 0
    for lut in (LUT if spec.has_lut else [None]):
        if lut is not None:
            monkeypatch.setenv("REPRO_LUT_DECODE", lut)
        got = takum_codec.decode(words, spec)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert int(_ulps_t(got[~nan], want[~nan]).max()) <= tol
        if n == 8:
            table = ref.decode_ref(to_words(torch.arange(256), spec.word_dtype),
                                   spec).to(dev)
            tn = torch.isnan(table)
            assert torch.equal(torch.isnan(got), tn)
            assert int(_ulps_t(got[~tn], table[~tn]).max()) <= tol


# -- the codec at 33-64 bits and the float64 decode ----------------------------

WIDE_SPECS = [formats.resolve(k, n) for n in (33, 40, 48, 57, 58, 61, 64)
              for k in ("linear", "lns", "posit")]
F64_SPECS = [formats.resolve(k, n) for n in (8, 16, 24, 32)
             for k in ("linear", "lns", "posit")]


def _wide_words(spec, rng, size):
    from repro_torch.core.bitops import to_words
    n = spec.n
    w = rng.integers(0, 1 << 64, size, dtype=np.uint64) & np.uint64(
        (1 << n) - 1)
    w[: size // 2] |= np.uint64(1 << (n - 1))
    w[:4] = [0, 1 << (n - 1), 1, (1 << n) - 1]
    return to_words(torch.from_numpy(w.view(np.int64)), spec.word_dtype)


def _check_wide(spec, x, w, dev, dtypes_out):
    """Decode (float32, float64 where 64-bit), encode (64-bit) and
    fake-quant to ``dtypes_out`` through the wrappers on the card against
    the plain versions: linear and posit bit for bit (NaN by place); LNS
    decodes within 2 ulp, words in chip_smoke.py's logf window, fake-quant
    the codec kernels' round trip."""
    from repro_torch.core.bitops import lanes
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import (float_differ, lns_encode_bounds, lns_encode_ok,
                            same_floats)
    tol = 2 if spec.kind == "lns" else 0
    xd, wd = x.to(dev), w.to(dev)
    for dtype in ((torch.float32, torch.float64) if spec.n > 32
                  else (torch.float64,)):
        got = takum_codec.decode(wd, spec, dtype=dtype)
        assert got.dtype == dtype
        assert float_differ(torch, got, ref.decode_ref(wd, spec, dtype),
                            tol) == 0, (spec.name, dtype)
    gw = takum_codec.encode(xd, spec)
    if spec.n > 32:
        g, want = lanes(gw), lanes(ref.encode_ref(xd, spec))
        if spec.kind == "lns":
            lo, hi = lns_encode_bounds(torch, xd, spec.n)
            assert bool(lns_encode_ok(g, want, lo, hi, spec.n).all())
        else:
            assert torch.equal(g, want), spec.name
    for dtype in dtypes_out:
        got = quantize.fake_quant(xd, spec, dtype=dtype)
        want = (takum_codec.decode(gw, spec, dtype=dtype)
                if spec.kind == "lns" else ref.fake_quant_ref(xd, spec, dtype))
        assert got.dtype == dtype
        assert same_floats(torch, got, want), (spec.name, dtype)


@pytest.mark.parametrize("spec", WIDE_SPECS, ids=lambda s: s.name)
def test_codec_and_fake_quant_at_64_bits(dev, spec):
    """The decode (float32 and float64), encode and fake-quant (float32,
    bfloat16, float64) kernels at 33-64 bits on 100k seeded words (top
    bit set and clear) and floats against the plain versions on the
    card."""
    rng = np.random.default_rng(spec.n)
    _check_wide(spec, torch.from_numpy(_floats(rng, 100_000)),
                _wide_words(spec, rng, 100_000), dev,
                (torch.float32, torch.bfloat16, torch.float64))


@pytest.mark.parametrize("spec", F64_SPECS, ids=lambda s: s.name)
def test_float64_decode_from_narrow_words(dev, spec):
    """The float64 decode and fake-quant from 8-, 16- and 32-bit words
    (every word at 8 and 16 bits) against the plain versions."""
    rng = np.random.default_rng(64 + spec.n)
    w = (_words(spec) if spec.n <= 16 else
         _wide_words(spec, rng, 100_000))
    _check_wide(spec, torch.from_numpy(_floats(rng, 100_000)), w, dev,
                (torch.float64,))


@pytest.mark.parametrize("spec", [formats.resolve(k, n) for n in (40, 64, 8, 24)
                                  for k in ("linear", "lns", "posit")],
                         ids=lambda s: s.name)
def test_codec_64_ragged_and_misaligned(dev, spec):
    """Counts 1..33 at offsets 0 and 1 through the decode, encode and
    fake-quant wrappers at 64-bit words and float64 out (the vectors'
    scalar tail; a misaligned view: the codec wrappers realign it,
    fake-quant's kernel takes its scalar loop)."""
    rng = np.random.default_rng(spec.n + 1)
    base = torch.from_numpy(_floats(rng, 27)).to(dev)    # 64 floats
    words = ref.encode_ref(base, spec)
    out = ((torch.float32, torch.bfloat16, torch.float64) if spec.n > 32
           else (torch.float64,))
    for off in (0, 1):
        for cnt in range(1, 34):
            _check_wide(spec, base[off:off + cnt], words[off:off + cnt],
                        dev, out)


def test_manual_data_parallel_card_matches_cpu(dev, tmp_path):
    """The manual ZeRO-1 step in a 2-rank gloo job on the card (both ranks
    on this card, their hops staged through host memory) against the same
    job on the CPU, reduced phi3-medium-14b at 2 layers, three steps
    (``repro_torch.train.dp_selftest``): the ranks bit-equal and the bytes
    the census on the card, uncompressed data 2 against one rank; card
    against CPU the losses within 1e-5 and each leaf within 1e-5 relative
    L2, uncompressed and with takum16 rings."""
    from repro_torch.train import dp_selftest as dst
    params = dst.make_params()
    names = ["data2", "data2_takum16"]
    got = {}
    for d in ("cuda", "cpu"):
        (tmp_path / d).mkdir()
        got[d] = dst.run_job(2, {"params": params}, str(tmp_path / d),
                             device=d, names=names)
    dst.check(got["cuda"], dst.one_rank(params, "cuda"))
    dst.against(got["cuda"], got["cpu"])


def test_wrappers_launch_the_resolved_plan(dev, tmp_path, monkeypatch):
    """A wire matmul called without a plan launches the local cache's
    entry for its bucket, fitted to its shape (kernels/autotune.py)."""
    import json
    cache = tmp_path / "tune.json"
    be = autotune.backend()
    cache.write_text(json.dumps({"schema": 1, "entries": {
        f"qmatmul|takum8|m256k8192n32768|{be}": {"plan": [1, 4]}}}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    autotune.clear()
    spec = formats.get("takum8")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((256, 5120), generator=gen, device=dev)
    w = takum_codec.encode(torch.randn((5120, 17920), generator=gen,
                                       device=dev) / 72, spec)
    seen = []
    lib = takum_matmul._lib()
    real = lib.takum_qmatmul

    def spy(*args):
        seen.append(args[10:12])
        return real(*args)
    monkeypatch.setattr(lib, "takum_qmatmul", spy)
    try:
        out = takum_matmul.qmatmul(x, w, spec)
        mine = takum_matmul.qmatmul(x, w, spec, plan=(1, 4, 40))
    finally:
        autotune.clear()
    assert seen == [(4, 40), (4, 40)]
    assert torch.equal(out.view(torch.int32), mine.view(torch.int32))
    want = ref.qmatmul_ref(x, w, spec)
    err = (out - want).norm() / want.norm()
    assert bool(torch.isfinite(out).all()) and float(err) < 1e-3, err
