"""The codec kernels' dataflow against the JAX package, on the CPU.

``kernels/ref.py``'s mirror of ``csrc/codec.cuh`` and the device functions
of ``csrc/takum.cuh`` / ``csrc/posit.cuh`` (``encode_dataflow``,
``decode_dataflow``, ``lns_tail_dataflow``: magnitudes negated by two's
complement, the encode from the header cut of the float's exponent with
the clamp as saturation, the takum decode from a table of the 11 bits
after the sign, the posit decode by a count of leading zeros) held
against the reference codec (``repro.core.takum`` / ``repro.core.posit``,
jitted once a width):

* every word at n = 6..16 decoded, and 2^14 seeded words at 20-32;
* at n = 6, 7, 8, 11, 12, 13, 16, 20, 24, 28, 29 and 32: every float32
  exponent with fractions 0, 1, all ones and, at each kind's cut, the tie,
  the tie +- 1 and the tie above an odd kept word, both signs, plus 2^16
  seeded raw patterns, subnormals and the specials, encoded. Bit for bit,
  but for the posit encoder's fault at n >= 29 (ROADMAP.md section 3: it
  leaves a float32 fraction unshifted): there the words are the port's
  plain encoder's and the golden model's (``core/golden.py``, sampled);
* the LNS encode's integer tail on fixed-point ``ell_bar`` values against
  the reference's ``encode_lns``;
* the negation symmetry the kernels rest on, directly.

The kernels themselves are held to the plain codec on the card
(``chip_smoke.py`` phase 33, ``tests/test_torch_gpu.py``).
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posit as jposit
from repro.core import takum as jtakum
from repro_torch import formats
from repro_torch.core import golden, posit
from repro_torch.core.bitops import lanes, to_words
from repro_torch.kernels import ref

WORD_WIDTHS = list(range(6, 17))
SAMPLED_WIDTHS = [20, 24, 28, 29, 32]
FLOAT_WIDTHS = [6, 7, 8, 11, 12, 13, 16, 20, 24, 28, 29, 32]
KINDS = ["linear", "posit"]
DECODE = {"linear": jtakum.takum_to_float, "posit": jposit.posit_to_float}
ENCODE = {"linear": jtakum.float_to_takum, "posit": jposit.float_to_posit}


@functools.lru_cache(maxsize=None)
def _jit(fn, n, **kw):
    """The reference's codec function at width n, jitted once."""
    return jax.jit(lambda *a: fn(*a, n, **kw))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same_floats(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _words_t(w, spec):
    return to_words(torch.from_numpy(np.asarray(w, np.int64)),
                    spec.word_dtype)


def _cuts(kind, n):
    """The cut (bits of the 23-bit fraction dropped) at each biased
    exponent 1..254, from the mirror's header tables: L + 24 - n."""
    e = torch.arange(-126, 128, dtype=torch.int64)
    _, length = (ref._takum_header(e) if kind == "linear"
                 else ref._posit_header(e, n))
    return (length + 24 - n).numpy()


def _floats(n, rng):
    """Every normal exponent x {0, 1, all ones, each kind's tie at its
    cut, the tie +- 1, the tie above an odd kept word}, both signs, plus
    2^16 raw patterns, 256 subnormals and the specials."""
    ex = np.arange(1, 255, dtype=np.int64)
    fracs = [np.zeros_like(ex), np.ones_like(ex),
             np.full_like(ex, 0x7FFFFF)]
    for kind in KINDS:
        cut = _cuts(kind, n)
        ok = (cut >= 1) & (cut <= 23)
        tie = np.where(ok, 1 << np.clip(cut - 1, 0, 22), 0)
        odd = np.where(ok & (cut <= 22), tie | (1 << np.clip(cut, 0, 22)), 0)
        fracs += [tie, tie + 1, np.maximum(tie - 1, 0), odd]
    bits = np.concatenate([(ex << 23) | f for f in fracs])
    bits = np.concatenate([bits, bits | (1 << 31)])
    raw = rng.integers(0, 1 << 32, 1 << 16, dtype=np.int64)
    sub = rng.integers(1, 1 << 23, 256, dtype=np.int64)
    pats = np.concatenate([bits, raw, sub, sub | (1 << 31)])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1.1754942e-38, 3.4028235e38, -3.4028235e38, 1.0,
                        -1.0], np.float32)
    return np.concatenate([pats.astype(np.uint32).view(np.float32), special])


def _posit_key(w, n):
    x = (-w) & ((1 << n) - 1) if w >> (n - 1) else w
    return Fraction(x & ((1 << (n - 1)) - 1), 1 << (n - 1))


def _check_posit_golden(x, words, n):
    """Each word is the golden model's rounding of its float: nearest on
    the encoding bit string (ties to the even word, saturating) among the
    word and its two neighbours of the same sign."""
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


@pytest.mark.parametrize("n", WORD_WIDTHS + SAMPLED_WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_decode_against_reference(kind, n):
    spec = formats.resolve(kind, n)
    if n <= 16:
        w = np.arange(1 << n, dtype=np.int64)
    else:
        rng = np.random.default_rng(n)
        w = np.concatenate([rng.integers(0, 1 << n, 1 << 14),
                            [0, 1, (1 << (n - 1)) - 1, 1 << (n - 1),
                             (1 << (n - 1)) + 1, (1 << n) - 1]])
    got = ref.decode_dataflow(_words_t(w, spec), spec).numpy()
    want = np.asarray(_jit(DECODE[kind], n)(jnp.asarray(w.astype(np.uint32))))
    _same_floats(got, want)


@pytest.mark.parametrize("n", FLOAT_WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_encode_against_reference(kind, n):
    spec = formats.resolve(kind, n)
    x = _floats(n, np.random.default_rng(100 + n))
    got = lanes(ref.encode_dataflow(torch.from_numpy(x), spec)).numpy()
    if kind == "posit" and n >= 29:
        plain = lanes(posit.float_to_posit(torch.from_numpy(x), n)).numpy()
        np.testing.assert_array_equal(got, plain)
        _check_posit_golden(x[::97], got[::97], n)
        return
    want = np.asarray(_jit(ENCODE[kind], n)(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", FLOAT_WIDTHS)
def test_lns_tail_against_reference(n):
    rng = np.random.default_rng(200 + n)
    one = 1 << 22
    edge = np.array([0, 1, -1, one - 1, one, -one, 254 * one,
                     255 * one - 1, 255 * one, 256 * one, -255 * one,
                     -255 * one - 1, -256 * one, 7 * one + one // 2,
                     -(7 * one + one // 2)], np.int64)
    fixed = np.concatenate([rng.integers(-256 * one, 256 * one + 1, 1 << 14),
                            edge])
    for s in (0, 1):
        got = lanes(ref.lns_tail_dataflow(
            torch.full(fixed.shape, s, dtype=torch.int64),
            torch.from_numpy(fixed), n)).numpy()
        ell = jnp.asarray((-fixed if s else fixed).astype(np.int32))
        want = _jit(jtakum.encode_lns, n, wf=22)(
            jnp.full(fixed.shape, s, jnp.int32), ell)
        np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("n", [6, 8, 12, 16, 24, 29, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_negation_is_twos_complement(kind, n):
    """encode(-x) = -encode(x) mod 2^n (NaN aside), decode(-w mod 2^n) =
    -decode(w) (the zero word and NaR aside), the LNS tail's S = 1 words
    the negated S = 0 words: the identities the kernels rest on."""
    spec = formats.resolve(kind, n)
    m = (1 << n) - 1
    x = _floats(n, np.random.default_rng(300 + n))
    x = x[~np.isnan(x)]
    pos = lanes(ref.encode_dataflow(torch.from_numpy(x), spec)).numpy()
    neg = lanes(ref.encode_dataflow(torch.from_numpy(-x), spec)).numpy()
    np.testing.assert_array_equal(neg, (-pos) & m)
    rng = np.random.default_rng(n)
    w = (np.arange(1 << n, dtype=np.int64) if n <= 16
         else rng.integers(0, 1 << n, 1 << 14))
    w = w[(w & (m >> 1)) != 0]
    a = ref.decode_dataflow(_words_t(w, spec), spec).numpy()
    b = ref.decode_dataflow(_words_t((-w) & m, spec), spec).numpy()
    np.testing.assert_array_equal(_bits(b), _bits(-a))
    fixed = torch.from_numpy(rng.integers(-(1 << 30), (1 << 30) + 1, 4096))
    t0 = lanes(ref.lns_tail_dataflow(torch.zeros_like(fixed), fixed, n))
    t1 = lanes(ref.lns_tail_dataflow(torch.ones_like(fixed), fixed, n))
    assert torch.equal(t1, (-t0) & m)
