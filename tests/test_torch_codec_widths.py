"""The port's codec at every width 6 <= n <= 32 against the JAX package and
the golden model, on the CPU.

* The port's golden model (``repro_torch.core.golden``, its own copy)
  equal to the reference's for every word at n <= 12.
* Every word decoded and a float sample encoded at n = 6..16, for linear
  takum, logarithmic takum and posit: linear and posit bit for bit, LNS
  within the existing tolerances (the port within 1 ulp of the float64
  oracle, the reference within 2 ulp where its own ``exp`` is; encoded
  words apart by at most the f32 log's rounding).
* Samples at n = 20, 24, 28, 29 and 32. Two reference faults show there,
  and the port is held to the golden model instead: the reference's LNS
  decode wraps its int32 ``ell_bar`` lane from n = 29, and its posit
  encoder leaves a float32 fraction unshifted where the cut falls below
  it (n >= 29).
* ``ops.takum_decode``/``takum_encode``/``fake_quant_fused`` against the
  reference's Pallas kernels in interpret mode at n = 12 and 24, ragged.
* The registry's spellings and interning of unregistered widths; the
  8/16-bit kernels refusing n = 12 by name before any launch; n = 65 and
  n = 5 refused by name (tests/test_torch_codec64.py takes 33-64).
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.core import golden as jgolden
from repro.core import posit as jposit
from repro.core import quant as jquant
from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro_torch import formats
from repro_torch.core import golden, posit, quant, takum
from repro_torch.core.bitops import lanes, to_words
from repro_torch.kernels import build, ops

SMALL = list(range(6, 17))
WIDE = [20, 24, 28, 29, 32]
F32_TINY = np.float32(1.1754944e-38)


@functools.lru_cache(maxsize=None)
def _jit(fn, n, **kw):
    """The reference's codec function at width n, jitted once (its eager
    dispatch compiles every primitive for every new shape)."""
    return jax.jit(lambda a: fn(a, n, **kw))


def _ref(fn, a, n, **kw):
    return np.asarray(_jit(fn, n, **kw)(jnp.asarray(a)))


def _t(w, n):
    return to_words(torch.from_numpy(np.asarray(w, np.int64)),
                    takum.word_dtype(n))


def _np(t):
    return lanes(t).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _ulps(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


def _words(n, rng):
    if n <= 16:
        return np.arange(1 << n, dtype=np.int64)
    edge = [0, 1, (1 << (n - 1)) - 1, 1 << (n - 1), (1 << (n - 1)) + 1,
            (1 << n) - 1]
    return np.concatenate([rng.integers(0, 1 << n, 1 << 13), edge])


def _floats(rng, size=1 << 12):
    with np.errstate(over="ignore"):
        x = (rng.normal(size=size) * 10.0 ** rng.integers(-45, 39, size)
             ).astype(np.float32)
    sub = rng.integers(1, 1 << 23, 256).astype(np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                        1.5, -1.25, F32_TINY, -F32_TINY, 3.4028235e38,
                        -3.4028235e38, 1e-45, -1e-45], np.float32)
    return np.concatenate([x, sub, -sub, special])


def _same_floats(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _lns_oracle(w, n):
    """Correctly rounded f32 of (-1)^S sqrt(e)^ell from the golden
    model's exact ell_bar and float64 ``exp``."""
    d = takum.decode_lns(_t(w, n), n)
    ell = np.where(d.s.numpy() == 1, -d.ell_bar.numpy(),
                   d.ell_bar.numpy()).astype(np.float64)
    with np.errstate(over="ignore"):
        mag = np.exp(ell / 2.0 ** (takum.frac_width(n) + 1))
        val = np.where(d.s.numpy() == 1, -mag, mag).astype(np.float32)
    val = np.where(d.is_zero.numpy(), np.float32(0), val)
    return np.where(d.is_nar.numpy(), np.float32(np.nan), val)


def _check_lns_decode(w, n):
    """Within 1 ulp of the float64 oracle up to n = 28 (ell is exact in
    float32: its n - 4 significant bits fit); from n = 29 ell is rounded
    to float32 first, as the reference's and the kernel's, which moves
    the value by up to a quarter of ell's float32 spacing, relative."""
    got = takum.lns_takum_to_float(_t(w, n), n).numpy()
    oracle = _lns_oracle(w, n)
    fin = np.isfinite(oracle)
    assert np.array_equal(np.isnan(got), np.isnan(oracle))
    tol = 1
    if n >= 29:
        ell = takum.decode_lns(_t(w, n), n).ell_bar.numpy()[fin] / 2.0 ** (
            takum.frac_width(n))
        tol = 1 + np.spacing(np.abs(ell).astype(np.float32)) * 2.0 ** 23
    assert (_ulps(got[fin], oracle[fin]) <= tol).all()
    if n <= 28:      # the reference's int32 ell_bar lane holds it
        want = _ref(jtakum.lns_takum_to_float, w.astype(np.uint32), n)
        ok = fin & (np.abs(oracle) >= F32_TINY) & (_ulps(want, oracle) <= 1)
        assert _ulps(got[ok], want[ok]).max() <= 2


def _check_lns_encode(x, n):
    """The port's words and the reference's: equal, or apart by at most
    what the two f32 logs' rounding moves ``ell_bar`` (4 f32 ulps of
    2 ln|x|) plus one word, in under 1% of the inputs."""
    got = _np(takum.float_to_lns_takum(torch.from_numpy(x), n))
    want = _ref(jtakum.float_to_lns_takum, x, n).astype(np.int64)
    diff = got != want
    assert diff.mean() < 0.01
    if diff.any():
        ell = np.abs(2.0 * np.log(np.abs(x[diff].astype(np.float64))))
        tol = 4 * np.spacing(ell.astype(np.float32)) + 2.0 ** -(n - 12)
        wf = takum.frac_width(n)
        ea = takum.decode_lns(_t(got[diff], n), n).ell_bar.numpy()
        eb = takum.decode_lns(_t(want[diff], n), n).ell_bar.numpy()
        assert (np.abs(ea - eb) / 2.0 ** wf <= tol).all()


def _posit_key(w, n):
    x = (-w) & ((1 << n) - 1) if w >> (n - 1) else w
    return Fraction(x & ((1 << (n - 1)) - 1), 1 << (n - 1))


def _check_posit_golden(x, words, n):
    """Each word is the golden model's rounding of its float: nearest on
    the encoding bit string (ties to the even word, saturating) among
    the word and its two neighbours of the same sign."""
    for xi, w in zip(x, words):
        if not np.isfinite(xi) or xi == 0:
            continue
        s, key = golden.posit_internal_key(Fraction(float(xi)))
        cands = []
        for v in (int(w) - 1, int(w), int(w) + 1):
            v &= (1 << n) - 1
            if v in (0, 1 << (n - 1)) or v >> (n - 1) != s:
                continue
            cands.append((v, _posit_key(v, n)))
        cands.sort(key=lambda tv: tv[1])
        assert golden._nearest_even(cands, key) == w, (xi, w)


# -- the golden model --------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 5, 8, 11, 12])
def test_golden_copy_equals_reference(n):
    for w in range(1 << n):
        assert golden.takum_decode_fields(w, n).__dict__ == \
            jgolden.takum_decode_fields(w, n).__dict__
        assert golden.takum_linear_value(w, n) == \
            jgolden.takum_linear_value(w, n)
        assert golden.takum_ell_bar(w, n) == jgolden.takum_ell_bar(w, n)
        if n >= 3:
            assert golden.posit_decode_value(w, n) == \
                jgolden.posit_decode_value(w, n)
    rng = np.random.default_rng(n)
    for v in rng.normal(size=64) * 10.0 ** rng.integers(-6, 6, 64):
        x = Fraction(float(v))
        assert golden.takum_encode_nearest_linear(x, n) == \
            jgolden.takum_encode_nearest_linear(x, n)
        s = int(v < 0)
        assert golden.takum_encode_nearest_lns(s, x, n) == \
            jgolden.takum_encode_nearest_lns(s, x, n)
        if n >= 3:
            assert golden.posit_encode_nearest(x, n) == \
                jgolden.posit_encode_nearest(x, n)


# -- every word at n = 6..16, samples above ------------------------------------


@pytest.mark.parametrize("n", SMALL + WIDE)
def test_linear_takum_decode_encode_equal_reference(n):
    rng = np.random.default_rng(100 + n)
    w = _words(n, rng)
    _same_floats(takum.takum_to_float(_t(w, n), n).numpy(),
                 _ref(jtakum.takum_to_float, w.astype(np.uint32), n))
    x = np.concatenate([_floats(rng),
                        takum.takum_to_float(_t(w[:4096], n), n).numpy()])
    np.testing.assert_array_equal(
        _np(takum.float_to_takum(torch.from_numpy(x), n)),
        _ref(jtakum.float_to_takum, x, n).astype(np.int64))


@pytest.mark.parametrize("n", SMALL + WIDE)
def test_lns_takum_decode_encode(n):
    rng = np.random.default_rng(200 + n)
    w = _words(n, rng)
    _check_lns_decode(w, n)
    x = _floats(rng)
    x = x[~((np.abs(x) < F32_TINY) & (x != 0))]    # XLA:CPU reads 0
    _check_lns_encode(x, n)


@pytest.mark.parametrize("n", SMALL + WIDE)
def test_posit_decode_encode(n):
    rng = np.random.default_rng(300 + n)
    w = _words(n, rng)
    for variant in ("2c", "sm"):
        _same_floats(posit.posit_to_float(_t(w, n), n,
                                          variant=variant).numpy(),
                     _ref(jposit.posit_to_float, w.astype(np.uint32), n,
                          variant=variant))
    x = _floats(rng)
    got = _np(posit.float_to_posit(torch.from_numpy(x), n))
    want = _ref(jposit.float_to_posit, x, n).astype(np.int64)
    if n <= 28:
        np.testing.assert_array_equal(got, want)
    else:
        assert (got != want).any()          # the reference's fault
        _check_posit_golden(x[::16], got[::16], n)


@pytest.mark.parametrize("n", [29, 32])
def test_lns_decode_wraps_in_the_reference_not_in_the_port(n):
    """From n = 29 the reference's int32 ell_bar lane wraps; the port's
    int64 lane gives the golden model's ell_bar."""
    w = np.array([0x7 << (n - 4), (1 << (n - 1)) - 1, 5], np.int64)
    d = takum.decode_lns(_t(w, n), n)
    wf = takum.frac_width(n)
    for i, wi in enumerate(w):
        assert Fraction(int(d.ell_bar[i]), 1 << wf) == golden.takum_ell_bar(
            int(wi), n)
    want = _ref(jtakum.lns_takum_to_float, w.astype(np.uint32), n)
    assert (_ulps(want, _lns_oracle(w, n)) > 2).any()


# -- the ops against the reference's Pallas kernels ---------------------------


@pytest.mark.parametrize("n", [12, 24])
@pytest.mark.parametrize("kind", ["linear", "lns", "posit"])
def test_ops_match_reference_kernels(kind, n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(37, 19)) * 10.0 ** rng.integers(-9, 9, (37, 19))
         ).astype(np.float32)
    name = formats.resolve(kind, n).name
    want_w = np.asarray(jops.takum_encode(jnp.asarray(x), name,
                                          interpret=True)).astype(np.int64)
    got_w = ops.takum_encode(torch.from_numpy(x), name)
    assert got_w.dtype == takum.word_dtype(n) and got_w.shape == x.shape
    want = np.asarray(jops.takum_decode(jnp.asarray(want_w.astype(np.uint32)),
                                        name, interpret=True))
    got = ops.takum_decode(_t(want_w, n), name).numpy()
    fq = ops.fake_quant_fused(torch.from_numpy(x), n, fmt=kind).numpy()
    want_fq = np.asarray(jops.fake_quant_fused(jnp.asarray(x), n, fmt=kind,
                                               interpret=True))
    if kind == "lns":
        same = _np(got_w) == want_w
        assert (np.abs(_np(got_w) - want_w) <= 1).all() and same.mean() > .9
        assert _ulps(got, want).max() <= 2
        # the round trip is decode(encode(x)); where the two logs gave the
        # same word, the two values within 2 ulp
        _same_floats(fq, ops.takum_decode(got_w, name).numpy())
        assert _ulps(fq[same], want_fq[same]).max() <= 2
    else:
        np.testing.assert_array_equal(_np(got_w), want_w)
        _same_floats(got, want)
        _same_floats(fq, want_fq)


def test_quant_spec_bits_and_wire_bytes():
    # (posit32 would meet the reference's encoder fault at n >= 29)
    for fmt, n in (("takum", 12), ("posit", 24), ("takum_lns", 20),
                   ("none", 16)):
        spec = quant.QuantSpec(fmt=fmt, n=n)
        jspec = jquant.QuantSpec(fmt=fmt, n=n)
        assert (spec.bits, spec.compression) == (jspec.bits,
                                                  jspec.compression)
        x = np.random.default_rng(n).normal(size=(5, 7)).astype(np.float32)
        qt = quant.quantize(torch.from_numpy(x), spec)
        assert qt.nbytes_wire == jquant.QTensor(
            jnp.zeros(x.shape), 0, jspec).nbytes_wire
        want = jax.jit(lambda a, sp=jspec: jquant.dequantize(
            jquant.quantize(a, sp)))(jnp.asarray(x))
        np.testing.assert_allclose(         # exact but for LNS's exp
            quant.dequantize(qt).numpy(), np.asarray(want),
            rtol=1e-6 if fmt == "takum_lns" else 0, atol=0)


# -- the registry and the refusals --------------------------------------------


def test_registry_builds_and_interns_other_widths():
    assert formats.names() == jformats.names()
    for fmt, n in (("posit32", None), ("lns-takum24", None), (12, None),
                   ("linear", 20), ("lns", 28), ("posit", 6),
                   ("takum12", 12)):
        got = formats.resolve(fmt, n)
        want = jformats.resolve(fmt, n)
        assert (got.name, got.kind, got.n) == (want.name, want.kind, want.n)
        assert formats.resolve(got.name) is got
        assert formats.resolve(got.kind, got.n) is got
        assert got.word_dtype == takum.word_dtype(got.n)
        assert got.name not in formats.names()
    assert formats.resolve_lns(24) is formats.resolve("lns-takum24")
    assert formats.resolve("takum8") is formats.get("takum8")
    with pytest.raises(ValueError, match="mismatch"):
        formats.resolve("takum12", 16)


def test_served_kernels_refuse_other_widths_before_launch():
    """The wire matmul, both attention kernels, ``kv_append`` and the LNS
    matmul take 8- and 16-bit words only: their format check names the
    spec before anything is launched; the codec and fake-quant take
    every width 6..64."""
    dev = torch.device("cuda")
    served = [("linear", "posit"), ("linear", "lns", "posit", "none"),
              ("lns",)]
    for kinds in served:
        for kind in kinds:
            if kind == "none":
                continue
            spec = formats.resolve(kind, 12)
            with pytest.raises(ValueError, match=spec.name):
                build.format_code(spec, dev, kinds=kinds)
    for n in (6, 12, 24, 29, 32, 33, 64):
        for kind in ("linear", "lns", "posit"):
            spec = formats.resolve(kind, n)
            assert build.format_code(spec, dev, widths=build.CODEC_WIDTHS) \
                == build.KIND_CODES[kind]
    with pytest.raises(ValueError, match="takum65"):
        build.format_code(formats.resolve(65), dev,
                          widths=build.CODEC_WIDTHS)


def test_n65_and_n5_are_refused_by_name():
    """The codec takes 6 <= n <= 64, as the reference under x64: widths 65
    and 5 are refused by the same calls, naming the range."""
    for n in (65, 5):
        for call in (lambda: takum.decode(torch.zeros(2, dtype=torch.int64),
                                          n),
                     lambda: takum.float_to_takum(torch.ones(2), n),
                     lambda: posit.float_to_posit(torch.ones(2), n),
                     lambda: formats.resolve(f"takum{n}").word_dtype):
            with pytest.raises(ValueError, match="6 <= n <= 64"):
                call()
