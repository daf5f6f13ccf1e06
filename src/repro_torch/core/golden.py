"""Scalar golden models, written directly from the paper's definitions.

Everything here is plain Python (ints / ``fractions.Fraction``) and exact.
The vectorized torch codecs in ``takum.py`` / ``posit.py`` are validated
against these models exhaustively for small ``n`` and on samples for
large ``n``. This is the port's own copy of the reference package's
golden model: the port imports nothing of that package.

References (paper section numbers refer to Hunhold, "Design and
Implementation of a Takum Arithmetic Hardware Codec in VHDL", 2024):

* Definition 1  — takum (logarithmic) encoding
* Definition 2  — linear takum encoding
* Section III   — internal representations, barred logarithmic value
* Posit golden  — Posit(TM) Standard 2022, es = 2
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache
from typing import Optional

__all__ = [
    "TakumFields",
    "takum_decode_fields",
    "takum_linear_value",
    "takum_ell_bar",
    "takum_encode_nearest_linear",
    "takum_encode_nearest_lns",
    "takum_all_values_linear",
    "posit_decode_value",
    "posit_encode_nearest",
]


# ---------------------------------------------------------------------------
# Takum — field extraction (Definition 1, including ghost bits)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TakumFields:
    n: int
    S: int
    D: int
    r: int
    c: int           # characteristic, in [-255, 254]
    p: int           # mantissa bit count at the 12-bit-expanded width
    m_num: int       # mantissa numerator: m = m_num / 2**p
    is_zero: bool
    is_nar: bool


def takum_decode_fields(T: int, n: int) -> TakumFields:
    """Decode an n-bit word (int in [0, 2**n)) into (S, D, r, c, m).

    Implements Definition 1 literally. Words shorter than 12 bits are
    zero-extended on the right ('ghost bits').
    """
    assert 2 <= n, "takums are defined for n >= 2"
    assert 0 <= T < (1 << n)
    # ghost-bit expansion to at least 12 bits
    n12 = max(n, 12)
    T12 = T << (n12 - n)

    S = (T12 >> (n12 - 1)) & 1
    body = T12 & ((1 << (n12 - 1)) - 1)
    if body == 0:
        # D = R = C = M = 0: the 0 (S=0) / NaR (S=1) special words.
        # Field values below follow Definition 1 mechanically (r=7, c=-255)
        # but are flagged non-semantic via is_zero / is_nar.
        return TakumFields(n, S, 0, 7, -255, n12 - 12, 0, S == 0, S == 1)

    D = (T12 >> (n12 - 2)) & 1
    R = (T12 >> (n12 - 5)) & 0b111
    r = (7 - R) if D == 0 else R
    p = n12 - r - 5
    C = (T12 >> p) & ((1 << r) - 1)
    M = T12 & ((1 << p) - 1)
    if D == 0:
        c = -(1 << (r + 1)) + 1 + C
    else:
        c = (1 << r) - 1 + C
    return TakumFields(n, S, D, r, c, p, M, False, False)


def takum_linear_value(T: int, n: int) -> Optional[Fraction]:
    """Exact linear takum value (Definition 2). None encodes NaR."""
    f = takum_decode_fields(T, n)
    if f.is_zero:
        return Fraction(0)
    if f.is_nar:
        return None
    frac = Fraction(f.m_num, 1 << f.p)
    e = f.c if f.S == 0 else -(f.c + 1)
    base = Fraction(1 - 3 * f.S) + frac
    return base * (Fraction(2) ** e)


def takum_ell_bar(T: int, n: int) -> Optional[Fraction]:
    """Exact barred logarithmic value  ell_bar = c + m  (Section III).

    The actual LNS value is (-1)^S * sqrt(e)^((-1)^S * ell_bar), which is
    irrational; all LNS golden comparisons therefore happen in ell_bar
    space, which is exact. None encodes NaR; zero returns None as well
    (ell_bar undefined), distinguished by takum_decode_fields.
    """
    f = takum_decode_fields(T, n)
    if f.is_zero or f.is_nar:
        return None
    return Fraction(f.c) + Fraction(f.m_num, 1 << f.p)


# ---------------------------------------------------------------------------
# Takum — brute-force nearest-even encoders (oracles for n <= 16)
# ---------------------------------------------------------------------------


def _signed(T: int, n: int) -> int:
    return T - (1 << n) if T >= (1 << (n - 1)) else T


def _unsigned(t: int, n: int) -> int:
    return t & ((1 << n) - 1)


@lru_cache(maxsize=8)
def takum_all_values_linear(n: int):
    """[(word, value)] for all non-NaR words, sorted ascending by value."""
    out = []
    for T in range(1 << n):
        v = takum_linear_value(T, n)
        if v is None:
            continue
        out.append((T, v))
    out.sort(key=lambda tv: tv[1])
    # sanity: monotone in signed word order <=> sorted by value
    return out


@lru_cache(maxsize=8)
def _takum_all_ell(n: int):
    out = []
    for T in range(1 << n):
        lb = takum_ell_bar(T, n)
        if lb is None:
            continue
        S = (T >> (n - 1)) & 1
        out.append((T, S, lb))
    return out


def _nearest_even(cands, x: Fraction):
    """cands: [(word, value)] sorted ascending by value; RNE with ties to
    even *word* (the rounder rounds up exactly when the round-down word is
    odd on a tie, Section V-E). Saturates at the ends."""
    import bisect

    values = [v for (_, v) in cands]
    i = bisect.bisect_left(values, x)
    if i == 0:
        return cands[0][0]
    if i == len(values):
        return cands[-1][0]
    below = cands[i - 1]
    above = cands[i]
    if above[1] == x:
        return above[0]
    d_lo = x - below[1]
    d_hi = above[1] - x
    if d_lo < d_hi:
        return below[0]
    if d_hi < d_lo:
        return above[0]
    # tie: to even word LSB
    return below[0] if below[0] % 2 == 0 else above[0]


def _floor_log2(x: Fraction) -> int:
    """floor(log2(x)) for x > 0, exact."""
    p, q = x.numerator, x.denominator
    k = p.bit_length() - q.bit_length()
    if x >= Fraction(2) ** (k + 1):
        k += 1
    elif x < Fraction(2) ** k:
        k -= 1
    return k


def linear_internal_key(x: Fraction):
    """(S, c + f) of the linear internal representation (8) for exact x != 0.

    ``c + f`` is the monotone per-sign rounding key: takum rounding (the
    §V-E bit-discard rounder) is round-to-nearest-even *on the encoding
    grid*, i.e. in (c + f) space. For n >= 12 the cut always falls inside
    the mantissa, where grid-nearest coincides with value-nearest; for
    n < 12 the two can differ (the cut may land inside the characteristic,
    whose steps are multiplicative) and the grid semantics is authoritative.
    """
    S = 1 if x < 0 else 0
    ax = abs(x)
    e = _floor_log2(ax)
    if S == 0:
        f = ax / Fraction(2) ** e - 1
        c = e
    else:
        # |x| in (2^e, 2^(e+1)]: value = (f - 2) * 2^e with f = 2 - |x|/2^e
        if ax == Fraction(2) ** e:
            e -= 1
        f = 2 - ax / Fraction(2) ** e
        c = -e - 1  # c = not(e) in two's complement
    assert 0 <= f < 1
    return S, Fraction(c) + f


def takum_encode_nearest_linear(x: Fraction, n: int) -> int:
    """Round an exact rational to the nearest n-bit linear takum.

    Nearest on the encoding grid (see ``linear_internal_key``), ties to
    even word; saturating (§V-A): never rounds a finite nonzero value to
    the 0 or NaR words.
    """
    if x == 0:
        return 0
    S, key = linear_internal_key(x)
    return _nearest_even(_takum_ell_by_sign(n, S), key)


@lru_cache(maxsize=16)
def _takum_ell_by_sign(n: int, S: int):
    cands = [(T, lb) for (T, Ts, lb) in _takum_all_ell(n) if Ts == S]
    cands.sort(key=lambda tv: tv[1])
    return cands


def takum_encode_nearest_lns(S: int, ell_bar: Fraction, n: int) -> int:
    """Round (S, ell_bar) to the nearest n-bit logarithmic takum.

    Rounding happens in ell_bar space, restricted to words with sign S
    (the LNS encoder's input sign is authoritative). Saturates at the
    dynamic-range ends.
    """
    return _nearest_even(_takum_ell_by_sign(n, S), ell_bar)


# ---------------------------------------------------------------------------
# Posit golden (Posit(TM) Standard 2022, es = 2)
# ---------------------------------------------------------------------------


def posit_decode_value(P: int, n: int, es: int = 2) -> Optional[Fraction]:
    """Exact posit value; None encodes NaR."""
    assert n >= 3
    assert 0 <= P < (1 << n)
    if P == 0:
        return Fraction(0)
    if P == 1 << (n - 1):
        return None  # NaR
    S = (P >> (n - 1)) & 1
    # sign-magnitude decode: negate (two's complement) if negative
    X = _unsigned(-P, n) if S else P
    # regime: run of identical bits after the sign bit
    bits = [(X >> i) & 1 for i in range(n - 2, -1, -1)]  # b_{n-2} .. b_0
    first = bits[0]
    run = 1
    while run < len(bits) and bits[run] == first:
        run += 1
    k = (run - 1) if first == 1 else -run
    rest = bits[run + 1:]  # skip the terminating bit (may be absent)
    e_bits = rest[:es]
    e_bits += [0] * (es - len(e_bits))  # ghost bits
    e = 0
    for b in e_bits:
        e = (e << 1) | b
    f_bits = rest[es:]
    f_num = 0
    for b in f_bits:
        f_num = (f_num << 1) | b
    f = Fraction(f_num, 1 << len(f_bits)) if f_bits else Fraction(0)
    mag = (Fraction(1) + f) * Fraction(2) ** (k * (1 << es) + e)
    return -mag if S else mag


def posit_internal_key(x: Fraction):
    """(S, key) where key is the infinite-precision posit *body* read as a
    binary fraction with its MSB at weight 1/2.

    The Posit Standard (and every hardware codec, FloPoCo included) rounds
    on the encoding bit string: truncate the infinite body at n-1 bits and
    apply RNE to the discarded tail. In the tapered regime region this is
    geometric rounding, not value-space rounding — the body-fraction key
    makes the golden oracle match that semantics exactly.
    """
    S = 1 if x < 0 else 0
    ax = abs(x)
    e = _floor_log2(ax)
    f = ax / Fraction(2) ** e - 1  # in [0, 1)
    k, e2 = divmod(e, 4)
    if k >= 0:
        rl = k + 2
        regime_val = (1 << (k + 2)) - 2
    else:
        rl = 1 - k
        regime_val = 1
    key = (Fraction(regime_val * 4 + e2) + f) / Fraction(2) ** (rl + 2)
    return S, key


@lru_cache(maxsize=8)
def _posit_keys_by_sign(n: int, S: int):
    out = []
    for P in range(1 << n):
        if P == 0 or P == 1 << (n - 1):
            continue
        if ((P >> (n - 1)) & 1) != S:
            continue
        X = (-P) & ((1 << n) - 1) if S else P
        body = X & ((1 << (n - 1)) - 1)
        out.append((P, Fraction(body, 1 << (n - 1))))
    out.sort(key=lambda tv: tv[1])
    return out


def posit_encode_nearest(x: Fraction, n: int, es: int = 2) -> int:
    """Nearest n-bit posit: RNE on the encoding bit string (ties to even
    word), saturating — never 0/NaR for finite nonzero x."""
    assert es == 2
    if x == 0:
        return 0
    S, key = posit_internal_key(x)
    return _nearest_even(_posit_keys_by_sign(n, S), key)
