"""The port's fused fake-quantisation against the JAX package, on the CPU.

``ops.fake_quant_fused`` (on the CPU: the plain version of the kernel of
``csrc/fake_quant.cu``) against the reference's
``ops.fake_quant_fused(interpret=True)`` (its Pallas kernel in interpret
mode, with ``REPRO_LUT_DECODE`` on and off), on ragged shapes, and
``quantize_weights(mode="fake")`` against the reference's on the reduced
phi3 config. Tolerances, each with its reason:

* linear takum and posit are integer-only round trips: bit-exact, f32
  and bf16 outputs alike (bf16 is the f32 result rounded to nearest even
  on both sides);
* the LNS round trip pays one ``log`` and one ``exp``: the port's word
  equals the reference's or is its neighbour (``log`` at an ``ell_bar``
  rounding tie, the share bounded as in tests/test_torch_lns.py), and
  where the words agree the f32 values are within 2 ulp (two ``exp``
  implementations). The port computes the bf16 output in f32 and rounds
  once; the reference's bf16 path runs the ``exp`` and the ``ell_bar``
  scaling in bf16 (``takum.lns_takum_to_float`` with ``dtype=bf16``),
  which is up to 3 bf16 ulp off on lns-takum16, so the port's bf16 output
  is held to the reference's f32 output rounded to bf16, within one bf16
  ulp where the words agree (the two f32 values may straddle a bf16
  rounding boundary).
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.configs import get_arch as jget_arch
from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.serve.engine import quantize_weights as jquantize
from repro_torch import formats
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import takum
from repro_torch.core.bitops import carrier
from repro_torch.kernels import ops, quantize, ref
from repro_torch.models import transformer
from repro_torch.serve.engine import quantize_weights

NAMES = ["takum8", "takum16", "posit8", "posit16", "lns-takum8",
         "lns-takum16"]
SHAPES = [(37, 19), (1000,), (3, 5, 7, 11)]
# neighbour words where two f32 logs straddle an ell_bar rounding tie
# (tests/test_torch_lns.py: 1.0e-5 measured on lns-takum16)
NEIGHBOUR_SHARE = 1.5e-5


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-6, 6, shape)
         ).astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40][:flat.size]
    return x


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


def _jax_fq(x, name, dtype):
    y = jops.fake_quant_fused(jnp.asarray(x), fmt=name, dtype=dtype,
                              interpret=True)
    return np.array(y.astype(jnp.float32))


def _same(a, b):
    nan = np.isnan(b)
    return (np.array_equal(np.isnan(a), nan)
            and np.array_equal(_bits(a)[~nan], _bits(b)[~nan]))


def _lns_words(x, spec):
    """(port words, reference words) of x, as int64."""
    mask = (1 << spec.n) - 1
    got = carrier(takum.float_to_lns_takum(torch.from_numpy(x), spec.n))
    want = np.asarray(jtakum.float_to_lns_takum(jnp.asarray(x), spec.n))
    return got.numpy().astype(np.int64) & mask, want.astype(np.int64)


@pytest.mark.parametrize("lut", ["0", "1"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_fake_quant_fused_matches_reference(name, shape, lut, monkeypatch):
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    spec = formats.get(name)
    x = _x(shape, seed=len(name) + len(shape))
    f32 = ops.fake_quant_fused(torch.from_numpy(x), fmt=name).numpy()
    bf16 = ops.fake_quant_fused(torch.from_numpy(x), fmt=name,
                                dtype=torch.bfloat16)
    assert f32.shape == shape and bf16.shape == shape
    assert bf16.dtype == torch.bfloat16
    want32 = _jax_fq(x, name, jnp.float32)
    if spec.kind != "lns":
        assert _same(f32, want32)
        assert _same(bf16.float().numpy(), _jax_fq(x, name, jnp.bfloat16))
        return
    # XLA:CPU reads subnormal inputs of the LNS encode as zero (ROADMAP.md
    # section 3): that band is held to the float64 oracle in
    # tests/test_torch_lns.py, not to the reference
    normal = ~((x != 0) & (np.abs(x) < np.float32(1.1754944e-38)))
    got_w, want_w = _lns_words(x[normal], spec)
    step = (got_w - want_w) % (1 << spec.n)
    assert np.isin(step, (0, 1, (1 << spec.n) - 1)).all()
    assert (step != 0).mean() <= max(NEIGHBOUR_SHARE, 1.0 / step.size)
    same = np.zeros(shape, bool)
    same[normal] = step == 0
    same &= ~np.isnan(want32)
    assert np.array_equal(np.isnan(f32), np.isnan(want32))
    ulps = np.abs(f32.view(np.int32).astype(np.int64)
                  - want32.view(np.int32).astype(np.int64))
    assert ulps[same].max(initial=0) <= 2
    # bf16: the port's f32 result rounded once; against the reference's
    # f32 result rounded to bf16, within one bf16 ulp where words agree
    assert _same(bf16.float().numpy(),
                 torch.from_numpy(f32).to(torch.bfloat16).float().numpy())
    ref16 = torch.from_numpy(want32).to(torch.bfloat16)
    d16 = (bf16.view(torch.int16).long() - ref16.view(torch.int16).long()
           ).abs().numpy()
    assert d16[same].max(initial=0) <= 1


@pytest.mark.parametrize("kind,n", [("linear", 8), ("lns", 16), ("posit", 8)])
def test_fake_quant_fused_spellings(kind, n):
    """``(fmt kind, n)`` pairs resolve as in the reference; the identity
    codec is refused by both."""
    x = _x((40, 30), seed=n)
    got = ops.fake_quant_fused(torch.from_numpy(x), n, fmt=kind).numpy()
    spec = formats.resolve(kind, n)
    assert _same(got, ops.fake_quant_fused(torch.from_numpy(x),
                                           fmt=spec).numpy())
    assert spec.name == jformats.resolve(kind, n).name
    with pytest.raises(ValueError, match="identity"):
        ops.fake_quant_fused(torch.from_numpy(x), fmt="none")


def test_fake_quant_ref_and_wrapper_on_the_cpu():
    """The wrapper runs the plain version for CPU tensors (no launch), and
    the plain version is the round trip of the codec."""
    spec = formats.get("posit16")
    x = torch.from_numpy(_x((64, 33), seed=3))
    n0 = quantize.fake_quant.launches
    got = quantize.fake_quant(x, spec)
    assert quantize.fake_quant.launches == n0
    want = spec.decode_tile(spec.encode_tile(x))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    lns8 = ref.fake_quant_lns_ref(x, 8)
    assert torch.equal(lns8.nan_to_num(), ref.fake_quant_ref(
        x, formats.get("lns-takum8")).nan_to_num())
    with pytest.raises(TypeError, match="bfloat16"):
        quantize.fake_quant(x, spec, dtype=torch.float16)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_arch("phi3-medium-14b").reduced
    cfg = get_arch("phi3-medium-14b").reduced
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    numpy_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jparams, numpy_tree


@pytest.mark.parametrize("fmt", ["takum8", "posit16", "lns-takum8"])
def test_quantize_weights_fake_matches_reference(reduced, fmt):
    """Every matrix of the reduced model fake-quantised by both packages
    (linear takum: one power-of-two scale per leaf over the layer stack,
    as the reference's stacked leaf)."""
    cfg, jparams, numpy_tree = reduced
    # the reference's own quantize_weights, traced once (the eager call
    # gives the same floats, several times slower)
    jq = jax.jit(lambda p: jquantize(p, fmt, verbose=False))(jparams)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), cfg,
                             "cpu")
    got = quantize_weights(params_from_numpy(numpy_tree, cfg, "cpu"), fmt,
                           verbose=False)
    spec = formats.get(fmt)
    assert torch.equal(got["embed_tokens"], want["embed_tokens"])
    steps = []
    for lg, lw in zip(got["layers"], want["layers"]):
        for part in ("attn", "mlp"):
            for name, t in lw[part].items():
                g = lg[part][name]
                assert g.dtype == t.dtype and g.shape == t.shape
                if spec.kind != "lns":
                    assert torch.equal(g, t), (fmt, part, name)
                    continue
                gw = carrier(spec.encode_tile(g)).long()
                tw = carrier(spec.encode_tile(t)).long()
                steps.append(((gw - tw) % (1 << spec.n)).reshape(-1))
                same = gw == tw
                torch.testing.assert_close(g[same], t[same], rtol=2.4e-7,
                                           atol=0)
    if steps:
        step = torch.cat(steps)
        assert bool(torch.isin(step, torch.tensor(
            [0, 1, (1 << spec.n) - 1])).all())
        assert float((step != 0).double().mean()) <= max(
            NEIGHBOUR_SHARE, 1.0 / step.numel())


def test_quantize_weights_fake_keeps_dtype_and_counts(capsys):
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                              n_layers=1)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu", dtype=torch.bfloat16)
    out = quantize_weights(params, "posit8")
    assert "0 wired, 7 fake-quantised" in capsys.readouterr().out
    for part in ("attn", "mlp"):
        for name, t in out["layers"][0][part].items():
            assert t.dtype == torch.bfloat16
            want = formats.get("posit8").fake_quant(
                params["layers"][0][part][name], dtype=torch.bfloat16)
            assert torch.equal(t, want)
    assert out["embed_tokens"] is params["embed_tokens"]
    wired = quantize_weights(params, "takum8", mode="wire", verbose=False)
    assert wired["layers"][0]["attn"]["wq"].spec.name == "takum8"
    with pytest.raises(ValueError, match="mode"):
        quantize_weights(params, "takum8", mode="soft")
