"""The port's hardware-faithful codec path (the paper's section V dataflow)
against its direct path, the JAX package's ``hw_path=True`` and the golden
model, on the CPU.

* Proposition 1 (conditional characteristic negation), Proposition 2 (the
  characteristic precursor), Table I (bias patterns) and Table II (the
  under/overflow bounds for n = 2..11), checked on the port's own golden
  model (``repro_torch.core.golden``).
* The nibble-table leading-one detector ``bitops.lod8_lut`` against the
  compare chain ``floor_log2_u8``, and ``ashr``/``popcount`` against plain
  Python.
* hw decode equal to the direct path and to the reference's
  ``hw_path=True``, every word at n = 12, 13 and 16 (and the ghost-bit
  widths 8 and 10).
* hw encode equal to the direct path and to the reference's at n = 12,
  16 and 24 (random fields, sticky bits), and the round trip of every
  word at n = 12 and 16.
* At n = 28 and 32, where the reference's hw encoder needs x64 lanes and
  the port's int64 lanes hold the (n + 7)-bit extended takum: hw encode
  against the direct path and the golden model.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import takum as jtakum
from repro_torch.core import bitops, golden, takum
from repro_torch.core.bitops import lanes, to_words


def _words(n):
    return to_words(torch.arange(1 << n, dtype=torch.int64),
                    takum.word_dtype(n))


def _np(t):
    return lanes(t).numpy()


# -- Propositions 1-2, Tables I-II on the golden model -------------------------


def test_proposition_1_characteristic_negation():
    """Negating (D, R, C) bitwise negates c in two's complement, same r."""
    n = 12
    for t in range(1 << n):
        f = golden.takum_decode_fields(t, n)
        if f.is_zero or f.is_nar:
            continue
        flip = (((1 << (4 + f.r)) - 1) << f.p) & ((1 << (n - 1)) - 1)
        f2 = golden.takum_decode_fields(t ^ flip, n)
        if f2.is_zero or f2.is_nar:
            continue
        assert f2.r == f.r
        assert f2.c == -f.c - 1, (t, f.c, f2.c)


def test_proposition_2_characteristic_precursor():
    """(D == 0 ? ~c : c) + 1 == 2^r + (C bits, inverted iff D == 0), and
    the port's encoder finds r from it with either leading-one detector."""
    n = 14
    cs, rs = [], []
    for t in range(0, 1 << n, 7):
        f = golden.takum_decode_fields(t, n)
        if f.is_zero or f.is_nar:
            continue
        uc = (t >> f.p) & ((1 << f.r) - 1)
        if f.D == 0:
            lhs, rhs = (~f.c) + 1, (1 << f.r) + ((~uc) & ((1 << f.r) - 1))
        else:
            lhs, rhs = f.c + 1, (1 << f.r) + uc
        assert lhs == rhs, (t, f)
        cs.append(lhs)
        rs.append(f.r)
    cp = torch.tensor(cs)
    assert torch.equal(bitops.lod8_lut(cp), torch.tensor(rs))
    assert torch.equal(bitops.floor_log2_u8(cp), torch.tensor(rs))


def test_table_1_bias_patterns_and_the_arithmetic_shift():
    """-2^(r+1) as 9-bit two's complement has r zero LSBs; the hardware
    makes it by an arithmetic shift of ``10 0000000`` by the antiregime."""
    expected = {0: 0b111111110, 1: 0b111111100, 2: 0b111111000,
                3: 0b111110000, 4: 0b111100000, 5: 0b111000000,
                6: 0b110000000, 7: 0b100000000}
    for r, pat in expected.items():
        assert (-(1 << (r + 1))) & 0x1FF == pat
        assert pat & ((1 << r) - 1) == 0
        shifted = int(bitops.ashr(torch.tensor(0x100), 7 - r, 9))
        assert shifted == pat, r


TABLE_II = {2: (-1, 0), 3: (-16, 15), 4: (-64, 63), 5: (-128, 127),
            6: (-192, 191), 7: (-224, 223), 8: (-240, 239),
            9: (-248, 247), 10: (-252, 251), 11: (-254, 253)}


def _w12_by_c():
    out = {}
    for t in range(1 << 11):
        f = golden.takum_decode_fields(t, 12)
        if not f.is_zero and f.m_num == 0:
            out.setdefault(f.c, t)
    return out


def test_table_2_bounds():
    """Truncating the 12-bit word of characteristic c to n bits hits the
    0 pattern iff c <= lo and the all-ones body iff c >= hi."""
    w12 = _w12_by_c()
    for n, (lo, hi) in TABLE_II.items():
        for c in range(-254, 255):
            body = (w12[c] >> (12 - n)) & ((1 << (n - 1)) - 1)
            assert (body == 0) == (c <= lo), (n, c)
            assert (body == (1 << (n - 1)) - 1) == (c >= hi), (n, c)


# -- bit helpers -------------------------------------------------------------


def test_lod8_lut_equals_floor_log2_u8():
    x = torch.arange(1, 256)
    assert torch.equal(bitops.lod8_lut(x), bitops.floor_log2_u8(x))


def test_ashr_and_popcount():
    rng = np.random.default_rng(3)
    for width in (9, 16, 32, 40):
        x = rng.integers(0, 1 << width, 512)
        s = rng.integers(0, width + 3, 512)
        got = bitops.ashr(torch.from_numpy(x), torch.from_numpy(s), width)
        signed = [int(v) - (1 << width) if v >> (width - 1) else int(v)
                  for v in x]
        want = [(v >> min(int(k), 62)) & ((1 << width) - 1)
                for v, k in zip(signed, s)]
        assert got.tolist() == want, width
    x = rng.integers(0, 1 << 62, 1024)
    assert bitops.popcount(torch.from_numpy(x)).tolist() == [
        bin(int(v)).count("1") for v in x]
    assert bitops._smear(torch.tensor([0b100100])).item() == 0b111111


# -- hw decode ---------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 10, 12, 13, 16])
def test_hw_decode_equals_direct_and_reference(n):
    words = _words(n)
    jw = jnp.asarray(np.arange(1 << n, dtype=np.uint32))
    for oe in (False, True):
        direct = takum.decode(words, n, output_exponent=oe)
        hw = takum.decode(words, n, output_exponent=oe, hw_path=True)
        ref = jtakum.decode(jw, n, output_exponent=oe, hw_path=True)
        assert torch.equal(hw.val, direct.val)
        assert torch.equal(hw.mant, direct.mant)
        np.testing.assert_array_equal(hw.val.numpy(), np.asarray(ref.val))
        np.testing.assert_array_equal(hw.mant.numpy(),
                                      np.asarray(ref.mant).astype(np.int64))
    lin = takum.linear_to_float(takum.decode_linear(words, n, hw_path=True),
                                n)
    np.testing.assert_array_equal(lin.view(torch.int32).numpy(),
                                  takum.takum_to_float(words, n).view(
                                      torch.int32).numpy())


# -- hw encode ---------------------------------------------------------------


def _fields(rng, n, m):
    return (rng.integers(0, 2, m), rng.integers(-260, 260, m),
            rng.integers(0, 1 << (n - 5), m), rng.integers(0, 2, m) > 0)


@pytest.mark.parametrize("n", [12, 16, 24])
def test_hw_encode_equals_direct_and_reference(n):
    """Random (S, c, mant, sticky), out-of-range characteristics too: the
    extended takum and the section V-A predictor give the direct
    rounder's words, and the reference's hw words."""
    rng = np.random.default_rng(n)
    s, c, mant, sticky = _fields(rng, n, 1 << 14)
    args = [torch.from_numpy(a) for a in (s, c, mant)]
    kw = dict(wm=n - 5, sticky=torch.from_numpy(sticky))
    hw = _np(takum.encode(*args, n, hw_path=True, **kw))
    assert np.array_equal(hw, _np(takum.encode(*args, n, **kw)))
    ref = jtakum.encode(s.astype(np.int32), c.astype(np.int32),
                        mant.astype(np.uint32), n, wm=n - 5, sticky=sticky,
                        hw_path=True)
    np.testing.assert_array_equal(hw, np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("n", [12, 16])
def test_hw_encode_round_trip(n):
    words = _words(n)
    dec = takum.decode(words, n, hw_path=True)
    enc = takum.encode(dec.s, dec.val, dec.mant, n, wm=n - 5,
                       is_zero=dec.is_zero, is_nar=dec.is_nar, hw_path=True)
    assert torch.equal(lanes(enc), lanes(words))


def _key(w, n):
    """The golden model's rounding key of word w, ``c + m`` (``None`` for
    0 and NaR)."""
    f = golden.takum_decode_fields(w, n)
    if f.is_zero or f.is_nar:
        return None
    return f.S, Fraction(f.c) + Fraction(f.m_num, 1 << f.p)


def _golden_nearest(w, s, key, n):
    """The golden rounding of ``(s, key)`` among the words around ``w``:
    nearest on the encoding grid, ties to the even word, saturating.
    Words are monotone in ``c + m`` within a sign, so ``w`` is the
    golden word iff it is the nearest of ``w - 1, w, w + 1``."""
    cands = []
    for v in (w - 1, w, w + 1):
        k = _key(v & ((1 << n) - 1), n)
        if k is not None and k[0] == s:
            cands.append((v & ((1 << n) - 1), k[1]))
    return golden._nearest_even(sorted(cands, key=lambda tv: tv[1]), key)


@pytest.mark.parametrize("n", [28, 32])
def test_hw_encode_wide_against_direct_and_golden(n):
    """The reference refuses the hw encoder above n = 25 without x64;
    the port's lanes hold the extended takum: its words equal the direct
    path's on random fields, and the golden model's rounding on a sample
    (sticky bits and the saturating ends included)."""
    rng = np.random.default_rng(n)
    s, c, mant, sticky = _fields(rng, n, 1 << 14)
    args = [torch.from_numpy(a) for a in (s, c, mant)]
    kw = dict(wm=n - 5, sticky=torch.from_numpy(sticky))
    hw = _np(takum.encode(*args, n, hw_path=True, **kw))
    assert np.array_equal(hw, _np(takum.encode(*args, n, **kw)))
    for i in range(0, 1 << 14, 1 << 8):
        sat = not -255 <= c[i] <= 254
        ci = min(max(int(c[i]), -255), 254)
        mi = (int(mant[i]) if not sat else
              ((1 << (n - 5)) - 1 if c[i] > 254 else 0))
        # a sticky bit: a quarter of the input's last unit, which is never
        # a midpoint of the word grid
        key = Fraction(ci) + Fraction(4 * mi + int(sticky[i] or sat),
                                      1 << (n - 3))
        assert hw[i] == _golden_nearest(int(hw[i]), int(s[i]), key, n), i
