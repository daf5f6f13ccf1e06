"""The port's gradients and stochastic rounding against the JAX package,
on the CPU.

* ``core.quant.fake_quant``: the reference's forward bit for bit and its
  straight-through gradient (the backward returns ``g``);
* stochastic rounding: ``float_to_takum(rounding="sr", rng_bits=...)``
  gives the reference's words bit for bit for the same uint32 bits
  (random, special and saturating floats, n = 12 and 16); the rounding is
  unbiased; the same refusals (n < 12, ``hw_path``, no bits; ``quantize``
  without a generator);
* the wire matmuls' VJP ``g @ decode(w)^T`` against ``jax.grad`` of the
  reference's ``quant_matmul`` (takum16, takum8, posit8, posit16) and
  ``lns_matmul`` (lns-takum16, lns-takum8, on its kernel in interpret
  mode), as tests/test_kernels.py and tests/test_lns_kernel.py check
  theirs; ``WireMatrix`` passes the gradient on; ``w`` gets none; the
  plain path refuses a gauss gradient.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import takum as jtakum
from repro.formats import registry as jformats
from repro.kernels import ops as jops
from repro_torch import formats
from repro_torch.core import quant, takum
from repro_torch.kernels import ops

# the VJP of both packages: g @ decode(w)^T, f32 sums in other orders
# (tests/test_kernels.py::test_qmatmul_batched_and_grad's tolerance)
GRAD_TOL = 1e-4


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def _words_np(t):
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.uint16 else t.numpy())


@pytest.mark.parametrize("spec", [quant.QuantSpec("takum", 16),
                                  quant.QuantSpec("takum", 8),
                                  quant.QuantSpec("posit", 16),
                                  quant.QuantSpec("takum_lns", 16)],
                         ids=lambda s: f"{s.fmt}{s.n}")
def test_fake_quant_forward_and_straight_through_gradient(spec):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 33)) * 3).astype(np.float32)
    jspec = jquant.QuantSpec(fmt=spec.fmt, n=spec.n)
    gw = rng.normal(size=x.shape).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda v: jnp.sum(jquant.fake_quant(v, jspec) * gw))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = quant.fake_quant(xt, spec)
    (out * torch.from_numpy(gw)).sum().backward()
    want_fq = np.asarray(jquant.fake_quant(jnp.asarray(x), jspec))
    if spec.fmt == "takum_lns":   # one exp/log: neighbouring words at most
        np.testing.assert_allclose(out.detach().numpy(), want_fq, rtol=2e-3)
    else:
        np.testing.assert_array_equal(out.detach().numpy(), want_fq)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(xt.grad.numpy(), gw)


def _sr_inputs(rng):
    x = (rng.normal(size=4096) * np.exp(rng.normal(size=4096) * 20)).astype(
        np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        3.4028235e38, -3.4028235e38, 1.0, -1.0, 0.75],
                       np.float32)
    return np.concatenate([x, special])


@pytest.mark.parametrize("n", [12, 16])
def test_sr_words_bit_exact_against_the_reference(n):
    rng = np.random.default_rng(n)
    x = _sr_inputs(rng)
    bits = rng.integers(0, 1 << 32, size=x.shape, dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jtakum.float_to_takum(jnp.asarray(x), n, rounding="sr",
                                            rng_bits=jnp.asarray(bits)))
    got = takum.float_to_takum(torch.from_numpy(x), n, rounding="sr",
                               rng_bits=torch.from_numpy(bits))
    np.testing.assert_array_equal(_words_np(got), want)
    # zero bits never round up unless the value saturates
    down = takum.float_to_takum(torch.from_numpy(x), n, rounding="sr",
                                rng_bits=torch.zeros(x.shape,
                                                     dtype=torch.int64))
    np.testing.assert_array_equal(
        _words_np(down), np.asarray(jtakum.float_to_takum(
            jnp.asarray(x), n, rounding="sr",
            rng_bits=jnp.zeros(x.shape, jnp.uint32))))


def test_sr_is_unbiased():
    """A value a third of the way between two takum16 neighbours rounds up
    a third of the time: the mean of the dequantised draws is the value
    (within 5 standard errors)."""
    w = takum.float_to_takum(torch.tensor([1.3]), 16)
    lo = takum.takum_to_float(w, 16)
    hi = takum.takum_to_float((w.view(torch.int16) + 1).view(torch.uint16),
                              16)
    x = float(lo + (hi - lo) / 3)
    spec = quant.QuantSpec("takum", 16, scale="none", rounding="sr")
    gen = torch.Generator().manual_seed(7)
    n = 200_000
    y = quant.dequantize(quant.quantize(torch.full((n,), x), spec,
                                        generator=gen))
    assert set(torch.unique(y).tolist()) == {float(lo), float(hi)}
    p = 1 / 3
    se = float(hi - lo) * (p * (1 - p) / n) ** 0.5
    assert abs(float(y.double().mean()) - x) < 5 * se
    # the same generator state gives the same words
    a = quant.quantize(torch.full((64,), x), spec,
                       generator=torch.Generator().manual_seed(3))
    b = quant.quantize(torch.full((64,), x), spec,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.words.view(torch.int16), b.words.view(torch.int16))


def test_sr_refuses_as_the_reference():
    x = torch.ones(4)
    bits = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="n >= 12"):
        takum.float_to_takum(x, 8, rounding="sr", rng_bits=bits)
    with pytest.raises(ValueError, match="rng_bits"):
        takum.float_to_takum(x, 16, rounding="sr")
    with pytest.raises(ValueError, match="direct path"):
        takum.encode(0, 0, 0, 16, wm=11, rounding="sr", rng_bits=bits,
                     hw_path=True)
    with pytest.raises(ValueError, match="unknown rounding"):
        takum.float_to_takum(x, 16, rounding="rtz")
    with pytest.raises(ValueError, match="Generator"):
        quant.quantize(x, quant.QuantSpec("takum", 16, rounding="sr"))
    with pytest.raises(ValueError, match="Generator"):
        quant.fake_quant(x, quant.QuantSpec("takum", 16, rounding="sr"))
    for ref_call in (lambda: jtakum.float_to_takum(jnp.ones(4), 8,
                                                   rounding="sr",
                                                   rng_bits=jnp.zeros(
                                                       4, jnp.uint32)),
                     lambda: jtakum.float_to_takum(jnp.ones(4), 16,
                                                   rounding="sr")):
        with pytest.raises(ValueError):
            ref_call()


def _gauss_weights(rng, k, n):
    return rng.normal(size=(k, n)).astype(np.float32) / k ** 0.5


@pytest.mark.parametrize("fmt", ["takum16", "takum8", "posit8", "posit16"])
def test_quant_matmul_gradient_matches_the_reference(fmt):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jspec = jformats.get(fmt)
    w_words = jspec.encode_tile(jnp.asarray(_gauss_weights(rng, 64, 32)))

    def jloss(v):
        return jnp.sum(jops.quant_matmul(v, w_words, fmt, False, None) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _t(np.asarray(w_words))
    out = ops.quant_matmul(xt, wt, fmt)
    assert out.shape == (2, 5, 32)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(float((out ** 2).sum().detach()), float(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    # the VJP itself: 2 out @ decode(w)^T
    w_dec = formats.get(fmt).decode_tile(wt)
    np.testing.assert_allclose(xt.grad.numpy(),
                               (2 * out.detach() @ w_dec.T).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", ["lns-takum16", "lns-takum8"])
def test_lns_matmul_gradient_matches_the_reference(fmt):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    n = 16 if fmt.endswith("16") else 8
    ww = jtakum.float_to_lns_takum(_gauss_weights(rng, 48, 24), n)
    jg = jax.grad(lambda v: jnp.sum(jops.lns_matmul(
        v, ww, fmt, "linear", True, True, (8, 8, 8)) ** 2))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _t(np.asarray(ww))
    out = ops.lns_matmul(xt, wt, fmt)
    (out ** 2).sum().backward()
    w_dec = formats.get(fmt).decode_tile(wt)
    np.testing.assert_allclose(xt.grad.numpy(),
                               (2 * out.detach() @ w_dec.T).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_wire_matrix_passes_the_gradient_and_w_gets_none():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    w = torch.from_numpy(_gauss_weights(rng, 40, 16))
    for fmt in ("takum16", "lns-takum16"):
        wm = ops.WireMatrix.encode(w, fmt=fmt)
        xt = x.clone().requires_grad_(True)
        (xt @ wm).sum().backward()
        want = torch.ones(3, 16) @ wm.decode().T
        np.testing.assert_allclose(xt.grad.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert not wm.words.requires_grad and wm.words.grad is None


def test_gauss_refuses_a_gradient_on_the_plain_path():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(np.abs(rng.normal(size=(1, 16))).astype(np.float32))
    ww = ops.takum_encode(torch.from_numpy(
        np.abs(rng.normal(size=(16, 8))).astype(np.float32)), "lns-takum16")
    ops.lns_matmul(x, ww, "lns-takum16", "gauss")     # forward: fine
    with pytest.raises(ValueError, match="gauss"):
        ops.lns_matmul(x.requires_grad_(True), ww, "lns-takum16", "gauss")
    with pytest.raises(ValueError, match="accum"):
        ops.lns_matmul(x, ww, "lns-takum16", "log")
