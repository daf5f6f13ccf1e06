"""Posit<n, es=2> baseline codec on torch tensors: the plain version of the
posit codec.

The paper's comparison baseline (Posit Standard 2022, es = 2), as the
JAX package has it, on int64 tensor lanes that hold unsigned 32-bit
values to n = 32 and 64-bit ones above (see ``bitops``), so it runs the
same on the CPU and on the card and is the plain version that
``csrc/posit.cuh`` is held against, bit for bit:

* ``decode_sm`` (FloPoCo-SM): negate the word when S = 1, then decode the
  magnitude to representation (7), ``(S, e~, f~) -> (-1)^S (1 + f~) 2^e~``;
* ``decode_2c`` (FloPoCo-2C): decode the raw word to representation (8),
  ``(S, e, f) -> ((1 - 3S) + f) 2^e``: the regime rule flips with S, the
  exponent bits (ghost bits too) are XOR-ed with S;
* ``encode`` rounds (S, e, f) of representation (8) to n-bit words: round
  to nearest, ties to the even word, saturating (a finite nonzero value
  never rounds onto the 0 or NaR words);
* ``posit_to_float`` assembles the IEEE-754 float32 or float64 word
  directly (sign | biased exponent | fraction, explicit RNE; every posit
  of n <= 32 is an f32 normal, wider ones reach f32's gradual underflow
  and overflow; the fraction is rounded into float32 from n = 29 and into
  float64 from n = 58, as the reference does), either variant;
  ``posit_to_float_ref`` is the ldexp dataflow kept as its oracle;
* ``float_to_posit`` disassembles the float32 word with shifts and masks.

Both decodes need a full-width leading-run count and full-width variable
shifts (the cost the paper contrasts with takum's 12-bit header window);
the regime runs over up to n - 1 = 63 bits. Words travel in
``uint8``/``uint16``/``uint32``/``uint64`` storage; widths 6 <= n <= 64,
es = 2 only (the ``es`` argument is the reference's).

One departure from the reference: from n = 29 a float32 input's 23
fraction bits no longer fill the posit's fraction field next to a short
regime, so the encoder's cut can be negative; the reference's encoder
then leaves the fraction unshifted (its ``safe_shr`` clips the negative
shift to 0) and returns another value, the port shifts it up (the words
the golden model's rounding gives). The fault reaches every width from
29 to 64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bitops import (LANE, MAX_WIDTH, bit, clz, floor_log2,
                                     lane_width, lanes, mask, safe_shl,
                                     safe_shr, signed64, to_words)
from repro_torch.core.takum import _IEEE, assemble_float, word_dtype

__all__ = ["PositDecoded", "decode_sm", "decode_2c", "encode",
           "posit_to_float", "posit_to_float_ref", "float_to_posit",
           "frac_width"]

def frac_width(n: int) -> int:
    """Fraction field output width (left-aligned): n - 5."""
    return n - 5


def _validate_n(n: int, es: int = 2) -> None:
    if not 6 <= n <= MAX_WIDTH:
        raise ValueError(f"the torch posit codec supports 6 <= n <= "
                         f"{MAX_WIDTH}, got {n}")
    if es != 2:
        raise ValueError(f"the posit codec is es = 2 (Posit Standard "
                         f"2022), got es={es}")


class PositDecoded(NamedTuple):
    """Decoder output: sign, exponent (representation (7) for SM, (8) for
    2C), fraction field of width ``frac_width(n)`` (left-aligned), and the
    special-word flags."""
    s: torch.Tensor
    e: torch.Tensor
    frac: torch.Tensor
    is_zero: torch.Tensor
    is_nar: torch.Tensor


def _leading_run(body, n: int):
    """Length of the leading run of identical bits in the top n - 1 bits
    of ``body`` (left-aligned at the lane's top bit, 31 or 63), and the
    run's bit."""
    wl = lane_width(n)
    top = bit(body, wl - 1, wl)
    u = torch.where(top == 1, ~body, body) & mask(wl, wl)
    u = u & safe_shl(mask(n - 1, wl), wl - (n - 1), wl)
    m = clz(u, wl)
    return torch.clamp(m, max=n - 1), top


def _extract_after_regime(p, m, n: int):
    """The 2 exponent bits (ghost-padded) and the left-aligned fraction
    after a regime of length m plus its terminator."""
    wl = lane_width(n)
    remaining = n - 2 - m
    rem = torch.clamp(remaining, min=0)
    field = p & mask(rem, wl)
    zero = torch.zeros_like(field)
    e2 = torch.where(remaining >= 2, safe_shr(field, rem - 2, wl) & 3,
                     torch.where(remaining == 1, (field & 1) << 1, zero))
    fr_bits = torch.clamp(remaining - 2, min=0)
    frac = safe_shl(field & mask(fr_bits, wl), frac_width(n) - fr_bits, wl)
    return e2, frac


def _split(words, n: int):
    wl = lane_width(n)
    p = lanes(words) & mask(n, wl)
    s = bit(p, n - 1, wl)
    return p, s, p == 0, p == signed64(1 << (n - 1))


def decode_sm(words, n: int, es: int = 2) -> PositDecoded:
    """FloPoCo-SM: negate-first decode to representation (7)."""
    _validate_n(n, es)
    wl = lane_width(n)
    p, s, is_zero, is_nar = _split(words, n)
    x = torch.where(s == 1, (~p + 1) & mask(n, wl), p)
    body = safe_shl(x & mask(n - 1, wl), wl - (n - 1), wl)
    m, first = _leading_run(body, n)
    k = torch.where(first == 1, m - 1, -m)
    e2, frac = _extract_after_regime(x, m, n)
    return PositDecoded(s=s, e=4 * k + e2, frac=frac, is_zero=is_zero,
                        is_nar=is_nar)


def decode_2c(words, n: int, es: int = 2) -> PositDecoded:
    """FloPoCo-2C: direct decode of the raw word to representation (8)."""
    _validate_n(n, es)
    wl = lane_width(n)
    p, s, is_zero, is_nar = _split(words, n)
    body = safe_shl(p & mask(n - 1, wl), wl - (n - 1), wl)
    m, first = _leading_run(body, n)
    k = torch.where((first ^ s) == 1, m - 1, -m)
    e2, frac = _extract_after_regime(p, m, n)
    e2 = e2 ^ (3 * s)          # exponent bits inverted for negatives
    return PositDecoded(s=s, e=4 * k + e2, frac=frac, is_zero=is_zero,
                        is_nar=is_nar)


def encode(s, e, frac, n: int, *, wm: int, sticky=None, is_zero=None,
           is_nar=None, es: int = 2) -> torch.Tensor:
    """Round (S, e, f) of representation (8), ``f`` of ``wm`` bits, to
    n-bit posit words (RNE to the even word, saturating), negated when
    S = 1. Returns words in ``word_dtype(n)``; ``wm`` is at most the
    compute lane less 4 bits (28 to n = 32, 60 above)."""
    _validate_n(n, es)
    wl = lane_width(n)
    if not 1 <= wm <= wl - 4:
        raise ValueError(f"wm={wm} out of range")
    s = lanes(s)
    e = lanes(e)
    frac = lanes(frac)
    sticky = (torch.zeros(e.shape, dtype=torch.bool, device=e.device)
              if sticky is None else torch.as_tensor(sticky).to(torch.bool))
    zero = torch.zeros_like(frac)

    # magnitude form: |v| = (1 + mf) 2^me
    f_nz = frac != 0
    mf = torch.where((s == 1) & f_nz, ((1 << wm) - frac) & mask(wm, wl),
                     frac)
    me = e + ((s == 1) & ~f_nz).to(LANE)

    k = me >> 2
    e2 = me & 3
    k_hi = k > n - 2
    k_lo = k < -(n - 2)
    k = torch.clamp(k, -(n - 2), n - 2)
    e2 = torch.where(k_hi, torch.full_like(e2, 3),
                     torch.where(k_lo, zero, e2))
    mf = torch.where(k_hi, torch.full_like(mf, mask(wm, wl)),
                     torch.where(k_lo, zero, mf))
    sticky = sticky | k_hi | k_lo

    # regime: k >= 0: (k + 1) ones and a 0; k < 0: |k| zeros and a 1
    rl = torch.where(k >= 0, k + 2, 1 - k)
    regime_val = torch.where(k >= 0, (safe_shl(torch.ones_like(k), k + 2,
                                               wl) - 2) & mask(wl, wl),
                             torch.ones_like(k))

    low = safe_shl(e2, wm, wl) | mf             # 2 + wm bits
    cut = rl + 2 + wm - (n - 1)                 # bits to drop (< 0: pad)
    # case A: the cut lands inside `low` (the regime is kept whole)
    body_a = safe_shl(regime_val, 2 + wm - cut, wl) | torch.where(
        cut >= 0, safe_shr(low, cut, wl), safe_shl(low, -cut, wl))
    g_a = torch.where(cut >= 1, bit(low, cut - 1, wl), zero)
    rest_a_nz = (cut >= 2) & ((low & mask(cut - 1, wl)) != 0)
    # case B: the cut lands inside the regime
    c2 = cut - (2 + wm)
    body_b = safe_shr(regime_val, c2, wl)
    g_b = torch.where(c2 >= 1, bit(regime_val, c2 - 1, wl), zero)
    rest_b_nz = ((regime_val & mask(c2 - 1, wl)) != 0) | (low != 0)
    in_a = cut <= 2 + wm
    body = torch.where(in_a, body_a, body_b)
    g = torch.where(in_a, g_a, g_b)
    rest_nz = torch.where(in_a, rest_a_nz, rest_b_nz) | sticky

    rd = body & mask(n - 1, wl)                 # positive-magnitude word
    ru = rd + 1
    underflow_down = rd == 0
    overflow_up = rd == mask(n - 1, wl)         # RU would be the NaR word
    tie = (g == 1) & ~rest_nz
    round_up = underflow_down | (~overflow_up & (g == 1)
                                 & (rest_nz | (tie & ((rd & 1) == 1))))
    word = torch.where(round_up, ru, rd)
    word = torch.where(s == 1, (~word + 1) & mask(n, wl), word)
    if is_zero is not None:
        word = torch.where(torch.as_tensor(is_zero), zero, word)
    if is_nar is not None:
        word = torch.where(torch.as_tensor(is_nar),
                           torch.full_like(word, signed64(1 << (n - 1))),
                           word)
    return to_words(word, word_dtype(n))


def _unbar(dec: PositDecoded, n: int):
    """(mf, me) of a 2C decode with S = 1 un-barred: magnitude =
    (1 + mf / 2^wf) * 2^me."""
    wf = frac_width(n)
    s, e, f = dec.s, dec.e, dec.frac
    f_nz = f != 0
    mf = torch.where((s == 1) & f_nz, (1 << wf) - f, f)
    me = e + ((s == 1) & ~f_nz).to(LANE)
    return mf, me


def _magnitude(words, n: int, variant: str):
    if variant == "2c":
        dec = decode_2c(words, n)
        mf, me = _unbar(dec, n)
    elif variant == "sm":
        dec = decode_sm(words, n)
        mf, me = dec.frac, dec.e       # representation (7): magnitude form
    else:
        raise ValueError(f"unknown posit decode variant {variant!r}")
    return dec, mf, me


def posit_to_float(words, n: int, dtype=torch.float32, *,
                   variant: str = "2c") -> torch.Tensor:
    """Decode n-bit posits to float by integer IEEE assembly (``variant``
    "2c" or "sm"; both give the same floats): float32 and float64
    directly (``takum.assemble_float``), other float dtypes computed in
    f32 and cast. Zero -> 0.0, NaR -> the quiet NaN."""
    _validate_n(n)
    dec, mf, me = _magnitude(words, n, variant)
    cdt = dtype if dtype in _IEEE else torch.float32
    out = assemble_float(dec.s, mf, me, frac_width(n), cdt,
                         is_zero=dec.is_zero, is_nar=dec.is_nar, wide=n > 32)
    return out if cdt == dtype else out.to(dtype)


def posit_to_float_ref(words, n: int, dtype=torch.float32, *,
                       variant: str = "2c") -> torch.Tensor:
    """The ldexp reconstruction: the oracle of :func:`posit_to_float`."""
    _validate_n(n)
    dec, mf, me = _magnitude(words, n, variant)
    mant = 1.0 + mf.to(dtype) / float(1 << frac_width(n))
    mag = torch.ldexp(mant, me.to(dtype))
    out = torch.where(dec.s == 1, -mag, mag)
    out = torch.where(dec.is_zero, torch.zeros_like(out), out)
    out = torch.where(dec.is_nar, torch.full_like(out, float("nan")), out)
    return out.to(dtype)


def float_to_posit(x, n: int) -> torch.Tensor:
    """Round float32 values to n-bit posit words (RNE, saturating).

    NaN -> NaR, +-inf -> the largest magnitude of that sign, +-0 -> 0."""
    _validate_n(n)
    x = torch.as_tensor(x).to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(LANE) & mask(32)
    s = bits >> 31
    exp_f = (bits >> 23) & 0xFF
    fr = bits & 0x7FFFFF
    is_zero = (exp_f == 0) & (fr == 0)
    is_nan = (exp_f == 255) & (fr != 0)
    is_inf = (exp_f == 255) & (fr == 0)
    b = floor_log2(torch.clamp(fr, min=1))
    sub = exp_f == 0
    big_e = torch.where(sub, b - 149, exp_f - 127)
    mant23 = torch.where(sub, safe_shl(fr, 23 - b) & 0x7FFFFF, fr)
    # to representation (8): two's-complemented fraction, exponent borrow
    neg_borrow = (s == 1) & (mant23 == 0)
    e = torch.where(neg_borrow, big_e - 1, big_e)
    f_field = torch.where((s == 1) & (mant23 != 0),
                          ((1 << 23) - mant23) & 0x7FFFFF, mant23)
    e = torch.where(is_inf, torch.full_like(e, 100_000), e)
    e = torch.where(is_nan | is_zero, torch.zeros_like(e), e)
    return encode(s, e, f_field, n, wm=23, is_zero=is_zero, is_nar=is_nan)
