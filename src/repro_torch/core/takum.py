"""Linear takum codec on torch tensors: the plain version of the codec.

This is the integer dataflow of the takum decoder and encoder for the
linear internal representation (S, e, f), written on int64 tensor lanes
(see ``bitops``) so that it runs the same on the CPU and on the card. It
is the plain version that the CUDA device functions in
``csrc/takum.cuh`` are held against, bit for bit.

* ``decode``/``decode_linear`` split an n-bit word into sign, the
  characteristic (or exponent) and the mantissa field, left-aligned at
  ``frac_width(n) = max(n, 12) - 5`` bits, plus the zero/NaR flags.
* ``encode``/``encode_linear`` round (S, c, mant) to n-bit words:
  round-to-nearest, ties to the even word, saturating (a finite nonzero
  value never rounds onto the 0 or NaR words); or, for n >= 12,
  stochastically (``rounding="sr"``): up with probability discarded/ulp,
  from caller-given uniform ``rng_bits``, so the words are a function of
  those bits.
* ``takum_to_float`` assembles the IEEE-754 float32 or float64 word
  directly: sign | biased exponent | fraction, with RNE gradual
  underflow and overflow to inf; NaR decodes to the quiet NaN
  (0x7FC00000, 0x7FF8000000000000). Other float dtypes are computed in
  float32 and cast, as the reference's.
* ``float_to_takum`` disassembles the float32 word with shifts and masks.
* ``takum_to_float_ref`` is the ldexp dataflow kept as the oracle of
  ``takum_to_float``.

The logarithmic half (representation (10), the barred ``(S, ell_bar)``):

* ``decode_lns`` concatenates the characteristic and the mantissa field
  into the fixed-point ``ell_bar`` (``frac_width(n)`` fraction bits; an
  int64 lane up to n = 60, beyond it ``(c, mant)`` apart);
  ``decode_lns_parts`` gives the ``(ell, flags)`` lanes of the LNS matmul
  (un-barred ``ell``; flags bit 0 = S, bit 1 = zero, bit 2 = NaR);
* ``encode_lns`` rounds a fixed-point ``ell_bar`` to words (floor
  characteristic, fractional remainder as the mantissa);
* ``lns_takum_to_float`` pays one ``exp``; ``float_to_lns_takum`` one
  ``log``, then RNE in ``ell_bar`` space. These two are the only
  transcendental steps of the codec: they agree with other
  implementations to an ulp or two of ``exp``/``log``, not bit for bit.

The hardware-faithful path (``hw_path=True``, the paper's section V
dataflow, as the reference's) gives the same words and fields as the
direct path by another route: the decoder's characteristic by
conditional negation of the raw characteristic bits (Corollary 1), the
bias by a ``10`` prefix and an arithmetic shift by the antiregime (Table
I), an increment of the low 8 bits; the encoder's characteristic
precursor (Proposition 2) through the nibble-table leading-one detector,
the (n + 7)-bit extended takum and the section V-A under/overflow
predictor. It needs n >= 12 and ``wm == n - 5`` to encode, and refuses
``rounding="sr"``. The extended takum is carried in two lanes, its top n
bits (the round-down word) and its low 7 (guard and sticky bits), so it
holds at every width; the reference builds it in one uint64 lane, which
overflows from n = 58 (there the port gives the golden model's words).

Words travel in ``uint8``/``uint16``/``uint32``/``uint64`` storage;
widths 6 <= n <= 64 (``bitops.word_dtype``), computed in 32-bit lanes to
n = 32 and 64-bit lanes above (``bitops.lane_width``, int64 lanes
throughout). The mantissa field (``frac_width(n) = n - 5`` bits) is wider
than float32's fraction from n = 29 and than float64's from n = 58;
``takum_to_float`` rounds it as the reference does (twice, where it is
wider than the significand).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.bitops import (LANE, MAX_WIDTH, ashr, bit, floor_log2,
                                     floor_log2_u8, lane_width, lanes,
                                     lod8_lut, mask, safe_shl, safe_shr,
                                     signed64, to_words)
from repro_torch.core.bitops import word_dtype as _word_dtype

__all__ = ["TakumDecoded", "decode", "decode_linear", "encode",
           "encode_linear", "takum_to_float", "takum_to_float_ref",
           "float_to_takum", "frac_width", "word_dtype", "nar_word",
           "LnsDecoded", "decode_lns", "decode_lns_parts", "encode_lns",
           "lns_takum_to_float", "float_to_lns_takum"]

F32_NAN_BITS = 0x7FC0_0000
# fraction bits, exponent bias, all-ones exponent field, sign bit, NaN
_IEEE = {torch.float32: (23, 127, 255, 31, F32_NAN_BITS),
         torch.float64: (52, 1023, 2047, 63, 0x7FF8_0000_0000_0000)}


def frac_width(n: int) -> int:
    """Width of the decoded mantissa field (= max(n, 12) - 5)."""
    return max(n, 12) - 5


def word_dtype(n: int) -> torch.dtype:
    """Narrowest unsigned storage dtype for an n-bit word."""
    _validate_n(n)
    return _word_dtype(n)


def nar_word(n: int) -> int:
    """The NaR bit pattern of width n (as an int64 lane's value)."""
    return signed64(1 << (n - 1))


def _validate_n(n: int) -> None:
    if not 6 <= n <= MAX_WIDTH:
        raise ValueError(f"the torch takum codec supports 6 <= n <= "
                         f"{MAX_WIDTH}, got {n}")


class TakumDecoded(NamedTuple):
    """Decoder output: sign, characteristic c (or exponent e), mantissa
    field of width ``frac_width(n)``, and the special-word flags."""
    s: torch.Tensor
    val: torch.Tensor
    mant: torch.Tensor
    is_zero: torch.Tensor
    is_nar: torch.Tensor


def decode(words, n: int, *, output_exponent: bool = False,
           hw_path: bool = False) -> TakumDecoded:
    """Decode n-bit takum words to (S, c|e, mant) and the special flags.

    ``output_exponent`` folds the exponent ``e = (-1)^S (c + S)`` into
    the decoder (the linear representation). ``hw_path`` computes the
    characteristic as the paper's section IV-A hardware does
    (:func:`_characteristic_hw`); the fields are the same."""
    _validate_n(n)
    wl = lane_width(n)
    w = lanes(words)
    n12 = max(n, 12)
    t = w << (n12 - n)                      # ghost bits: pad to >= 12
    s = bit(t, n12 - 1, wl)
    d = bit(t, n12 - 2, wl)
    rbits = safe_shr(t, n12 - 5, wl) & 7
    r = torch.where(d == 0, 7 - rbits, rbits)
    body = t & mask(n12 - 1, wl)
    is_special = body == 0
    is_zero = is_special & (s == 0)
    is_nar = is_special & (s == 1)
    p12 = n12 - 5 - r                       # mantissa bits at 12+ width
    uint_c = safe_shr(t, p12, wl) & mask(r)
    mant = safe_shl(t & mask(p12, wl), r, wl)   # left-aligned: M << r
    if hw_path:
        c = _characteristic_hw(t, n12, s, d, r, output_exponent)
    else:
        one = torch.ones_like(r)
        c = torch.where(d == 0, -(one << (r + 1)) + 1 + uint_c,
                        (one << r) - 1 + uint_c)
        if output_exponent:
            c = torch.where(s == 1, -(c + 1), c)
    return TakumDecoded(s=s, val=c, mant=mant, is_zero=is_zero,
                        is_nar=is_nar)


def _characteristic_hw(t, n12: int, s, d, r, output_exponent: bool):
    """The characteristic (or exponent) determinator of section IV-A:
    the 7 raw characteristic bits negated when D = 1 (Corollary 1), a
    ``10`` prefix, an arithmetic right shift by the antiregime 7 - r (the
    bias of Table I), an increment of the low 8 bits (it never carries
    out), a ``1`` prefix, and a final negation when D (or D xor S, for
    the exponent). Returns the 9-bit two's-complement result
    sign-extended."""
    craw = safe_shr(t, n12 - 12, 64) & 0x7F
    craw = torch.where(d == 1, craw ^ 0x7F, craw)
    v = ashr(0x100 | craw, 7 - r, 9)
    c_tilde = 0x100 | ((v + 1) & 0xFF)
    cond = (d ^ s) if output_exponent else d
    c9 = torch.where(cond == 1, c_tilde ^ 0x1FF, c_tilde)
    return c9 - ((c9 >> 8) << 9)


def decode_linear(words, n: int, *, hw_path: bool = False) -> TakumDecoded:
    """Decode to the linear representation (S, e, f)."""
    return decode(words, n, output_exponent=True, hw_path=hw_path)


def encode(s, c, mant, n: int, *, wm: int, sticky=None, is_zero=None,
           is_nar=None, hw_path: bool = False, rounding: str = "rne",
           rng_bits=None) -> torch.Tensor:
    """Round (S, c, barred mantissa of ``wm`` bits) to n-bit takum words.

    Out-of-range characteristics saturate to the largest or smallest
    magnitude (never to 0 or NaR); ``sticky`` ORs in bits the caller
    discarded before. Returns words in ``word_dtype(n)``.

    ``rounding="sr"`` rounds up with probability discarded/2^cut: the
    carry out of (discarded bits + the low ``cut`` bits of ``rng_bits``,
    uniform uint32 lanes of the input's shape), still saturating. It
    needs ``rng_bits`` and n >= 12 (the cut then always lies in the
    mantissa). ``hw_path`` takes the paper's section V-B..E dataflow
    (:func:`_encode_hw`): the same words; it needs ``wm == n - 5`` and
    n >= 12. ``wm`` is at most the compute lane less 5 bits: 27 to
    n = 32, 59 above."""
    if rounding not in ("rne", "sr"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if rounding == "sr":
        if hw_path:
            raise ValueError("sr rounding is only on the direct path")
        if n < 12:
            raise ValueError("sr rounding requires n >= 12")
        if rng_bits is None:
            raise ValueError("sr rounding requires rng_bits")
    _validate_n(n)
    wl = lane_width(n)
    if not 1 <= wm <= wl - 5:
        raise ValueError(f"wm={wm} out of range for lane width {wl}")
    if hw_path and (wm != n - 5 or n < 12):
        raise ValueError("hw_path encoder requires wm == n-5 and n >= 12")
    s = lanes(s)
    c = lanes(c)
    mant = lanes(mant)
    over = c > 254
    under = c < -255
    c = torch.clamp(c, -255, 254)
    mant = torch.where(over, torch.full_like(mant, mask(wm, wl)),
                       torch.where(under, torch.zeros_like(mant), mant))
    sticky = over | under | (False if sticky is None else
                             torch.as_tensor(sticky).to(torch.bool))

    d = (c >= 0).to(LANE)
    cp = torch.where(d == 1, c, ~c) + 1      # in [1, 255] (Prop. 2)
    r = lod8_lut(cp) if hw_path else floor_log2_u8(cp)
    r3 = torch.where(d == 1, r, 7 - r)
    cbits = torch.where(d == 1, cp, ~cp) & mask(r)
    zero = torch.zeros_like(mant)
    if hw_path:
        word = _encode_hw(s, d, r, r3, cbits, mant, sticky, n)
    else:
        p = n - 5 - r                            # mantissa bits that fit
        header = (s << (n - 1)) | (d << (n - 2)) | (r3 << (n - 5))
        cut = wm - p
        # case A (p >= 0): the cut lands inside or below the mantissa
        m_top_a = torch.where(cut >= 0, safe_shr(mant, cut, wl),
                              safe_shl(mant, -cut, wl))
        body_a = safe_shl(cbits, p, wl) | m_top_a
        g_a = torch.where(cut >= 1, bit(mant, cut - 1, wl), zero)
        rest_a = torch.where(cut >= 2, mant & mask(cut - 1, wl), zero)
        # case B (p < 0, n < 12): the cut lands inside the characteristic
        cut_c = -p
        body_b = safe_shr(cbits, cut_c, wl)
        g_b = torch.where(cut_c >= 1, bit(cbits, cut_c - 1, wl), zero)
        rest_b_nz = (cbits & mask(cut_c - 1, wl)) != 0
        in_a = p >= 0
        body = torch.where(in_a, body_a, body_b)
        g = torch.where(in_a, g_a, g_b)
        rest_nz = (torch.where(in_a, rest_a != 0, rest_b_nz | (mant != 0))
                   | sticky)
        rd = header | body
        ru = (rd + 1) & mask(n, wl)
        low = mask(n - 1, wl)
        underflow_down = (rd & low) == 0     # RD would be the 0/NaR word
        overflow_up = (ru & low) == 0        # RU would wrap onto 0/NaR
        if rounding == "sr":
            # the carry out of (discarded + uniform); n >= 12: case A
            discarded = torch.where(cut >= 1, mant & mask(cut, wl), zero)
            u = lanes(rng_bits).to(mant.device) & mask(cut, wl)
            carry = (safe_shr(discarded + u, cut, wl) != 0) & (cut >= 1)
            round_up = underflow_down | (~overflow_up & carry)
        else:
            round_up = underflow_down | (~overflow_up & (g == 1)
                                         & (rest_nz | ((rd & 1) == 1)))
        word = torch.where(round_up, ru, rd)
    if is_zero is not None:
        word = torch.where(torch.as_tensor(is_zero), zero, word)
    if is_nar is not None:
        word = torch.where(torch.as_tensor(is_nar),
                           torch.full_like(word, nar_word(n)), word)
    return to_words(word, word_dtype(n))


def _encode_hw(s, d, r, r3, cbits, mant, sticky, n: int) -> torch.Tensor:
    """Sections V-D/E: the (n + 7)-bit extended takum ``S D RRR | C (r
    bits) M (n - 5 bits) 0 (7 - r bits)``, which holds the whole mantissa
    whatever r (the shifter's offset is at most 7, the paper's contrast
    with posit encoders), cut to n bits and rounded to nearest even; the
    section V-A predictor flags under/overflow when the 11 bits after
    the sign (D, R, C: r = 7) and the kept mantissa bits are all zeros /
    all ones.

    The extended takum is carried in two lanes: ``rd``, its top n bits
    (the word rounded down, ``S D RRR C`` and the mantissa's top n - 5 -
    r bits), and ``low7``, its low 7 bits (the mantissa's last r bits,
    shifted up by 7 - r: guard and sticky). (n + 7) bits fit no int64
    lane from n = 57; the reference's uint64 lane overflows from n = 58."""
    wl = 64
    rd = (((s << 4) | (d << 3) | r3) << (n - 5)) | (cbits << (n - 5 - r)) \
        | safe_shr(mant, r, wl)
    low7 = (mant << (7 - r)) & 0x7F
    ru = (rd + 1) & mask(n, wl)
    g = (low7 >> 6) & 1
    rest_nz = ((low7 & mask(6)) != 0) | sticky
    eleven = safe_shr(rd, n - 12, wl) & mask(11)
    kept_m = rd & mask(n - 12, wl)
    under_pred = (eleven == 0) & (kept_m == 0)
    over_pred = (eleven == mask(11)) & (kept_m == mask(n - 12, wl))
    round_up = under_pred | (~over_pred & (g == 1)
                             & (rest_nz | ((rd & 1) == 1)))
    return torch.where(round_up, ru, rd) & mask(n, wl)


def encode_linear(s, e, frac, n: int, *, wm: int, sticky=None,
                  is_zero=None, is_nar=None, hw_path: bool = False,
                  rounding: str = "rne", rng_bits=None) -> torch.Tensor:
    """Encode from (S, e, f): c is e conditionally negated on S."""
    s = lanes(s)
    e = lanes(e)
    c = torch.where(s == 1, ~e, e)
    return encode(s, c, frac, n, wm=wm, sticky=sticky, is_zero=is_zero,
                  is_nar=is_nar, hw_path=hw_path, rounding=rounding,
                  rng_bits=rng_bits)


def float_to_takum(x, n: int, *, rounding: str = "rne",
                   rng_bits=None) -> torch.Tensor:
    """Round float32 values to n-bit linear takum words (RNE, or
    stochastic from ``rng_bits`` with ``rounding="sr"``; saturating).

    NaN -> NaR, +-inf -> the largest magnitude of that sign, +-0 -> 0."""
    _validate_n(n)
    s, e, f_field, is_zero, is_nan = float_fields(x)
    return encode_linear(s, e, f_field, n, wm=23, is_zero=is_zero,
                         is_nar=is_nan, rounding=rounding, rng_bits=rng_bits)


def float_fields(x):
    """float32 -> the linear representation ``(S, e, f)`` of
    :func:`encode_linear` (``f`` the 23-bit barred fraction; +-inf as an
    out-of-range e that saturates) and the zero/NaN flags."""
    x = torch.as_tensor(x).to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(LANE) & mask(32)
    s = bits >> 31
    exp_f = (bits >> 23) & 0xFF
    frac = bits & 0x7FFFFF
    is_zero = (exp_f == 0) & (frac == 0)
    is_nan = (exp_f == 255) & (frac != 0)
    is_inf = (exp_f == 255) & (frac == 0)

    # normalise subnormals: value = frac * 2^-149 = (1 + f') * 2^(b - 149)
    b = floor_log2(torch.clamp(frac, min=1))
    sub = exp_f == 0
    big_e = torch.where(sub, b - 149, exp_f - 127)
    mant23 = torch.where(sub, safe_shl(frac, 23 - b) & 0x7FFFFF, frac)
    # negative values: the fraction field is two's-complemented and the
    # exponent borrows when it is zero (the barred representation)
    neg_borrow = (s == 1) & (mant23 == 0)
    e = torch.where(neg_borrow, big_e - 1, big_e)
    f_field = torch.where((s == 1) & (mant23 != 0),
                          ((1 << 23) - mant23) & 0x7FFFFF, mant23)
    e = torch.where(is_inf, torch.full_like(e, 10_000), e)
    e = torch.where(is_nan | is_zero, torch.zeros_like(e), e)
    return s, e, f_field, is_zero, is_nan


def _unbar(dec: TakumDecoded, n: int):
    """(mf, me) with magnitude = (1 + mf / 2^wf) * 2^me (S=1 un-barred)."""
    wf = frac_width(n)
    s, e, f = dec.s, dec.val, dec.mant
    f_nz = f != 0
    mf = torch.where((s == 1) & f_nz, (1 << wf) - f, f)
    me = e + ((s == 1) & ~f_nz).to(LANE)
    return mf, me


def _rne_shr(v, sh, width: int = 32):
    """RNE(v / 2^sh) on ``width``-bit unsigned lanes, ``sh >= 1`` of any
    size."""
    kept = safe_shr(v, sh, width)
    g = bit(v, sh - 1, width)
    rest_nz = (v & mask(sh - 1, width)) != 0
    up = (g == 1) & (rest_nz | ((kept & 1) != 0))
    return kept + up.to(LANE)


def float_fraction(mf, wf: int, fb: int, width: int = 32):
    """The ``fb``-bit fraction field of (1 + mf / 2^wf) and the carry into
    the exponent: a left shift for wf <= fb; beyond it the reference's
    two roundings (its ldexp oracle converts mf to the float first, which
    rounds it to fb + 1 significant bits where wf > fb + 1, then adds 1),
    each to nearest even, and a carry of 1 when the fraction rounds up to
    2. ``width`` is the assembly lane (64 for float64 or n > 32)."""
    if wf <= fb:
        return mf << (fb - wf), 0
    if wf > fb + 1:
        sh1 = torch.clamp(floor_log2(torch.clamp(mf, min=1), wf) - fb,
                          min=0)
        mf = torch.where(sh1 > 0,
                         safe_shl(_rne_shr(mf, sh1, width), sh1, width), mf)
    frac = _rne_shr(mf, wf - fb, width)
    return frac & mask(fb, width), frac >> fb


def assemble_float(s, mf, me, wf: int, dtype, *, is_zero, is_nar,
                   wide: bool = False) -> torch.Tensor:
    """The IEEE-754 float32 or float64 of (-1)^s (1 + mf / 2^wf) 2^me:
    sign | biased exponent | fraction assembled in an integer lane, RNE
    gradual underflow, overflow to inf, 0 for ``is_zero`` and the quiet
    NaN for ``is_nar``. Shared by the takum and posit decodes; ``wide``
    (n > 32) assembles float32 in a 64-bit lane too, as the reference."""
    fb, bias, emax, sbit, nan_bits = _IEEE[dtype]
    width = 64 if (fb == 52 or wide) else 32
    frac, carry = float_fraction(mf, wf, fb, width)
    be = me + bias + carry                     # biased exponent
    sign = s << sbit
    normal = sign | (torch.clamp(be, 0, emax) << fb) | frac
    inf = sign | (emax << fb)
    sub = sign | _rne_shr((1 << fb) | frac, 1 - be, width)
    word = torch.where(be >= emax, inf, torch.where(be <= 0, sub, normal))
    word = torch.where(is_zero, torch.zeros_like(word), word)
    word = torch.where(is_nar, torch.full_like(word, nan_bits), word)
    if dtype == torch.float64:
        return word.view(torch.float64)
    word = torch.where(word >= (1 << 31), word - (1 << 32), word)
    return word.to(torch.int32).view(torch.float32)


def takum_to_float(words, n: int, dtype=torch.float32) -> torch.Tensor:
    """Decode n-bit linear takum words to float by integer IEEE assembly.

    float32 and float64 are assembled directly (float64 holds every
    takum's exponent; from n = 59 its fraction is rounded twice, as the
    reference's); out-of-range float32 magnitudes become inf or (through
    RNE gradual underflow) subnormals and 0. Other float dtypes are
    computed in f32 and cast."""
    _validate_n(n)
    return linear_to_float(decode_linear(words, n), n, dtype)


def linear_to_float(dec: TakumDecoded, n: int,
                    dtype=torch.float32) -> torch.Tensor:
    """The float of a linear decode (:func:`decode_linear`, either path):
    the IEEE assembly of :func:`takum_to_float`."""
    cdt = dtype if dtype in _IEEE else torch.float32
    mf, me = _unbar(dec, n)
    out = assemble_float(dec.s, mf, me, frac_width(n), cdt,
                         is_zero=dec.is_zero, is_nar=dec.is_nar, wide=n > 32)
    return out if cdt == dtype else out.to(dtype)


_EXP_RANGE = {torch.float32: (-126, 128), torch.float64: (-1022, 1024)}


def takum_to_float_ref(words, n: int, dtype=torch.float32) -> torch.Tensor:
    """The ldexp reconstruction: the oracle of :func:`takum_to_float`.

    Subnormal magnitudes scale through a normal intermediate (one exact
    multiply, then one correctly rounded one)."""
    _validate_n(n)
    dec = decode_linear(words, n)
    wf = frac_width(n)
    mf, me = _unbar(dec, n)
    mant = 1.0 + mf.to(dtype) / float(1 << wf)
    minexp, maxexp = _EXP_RANGE[dtype]
    e1 = torch.clamp(me, minexp, maxexp)
    mag = torch.ldexp(torch.ldexp(mant, e1.to(dtype)), (me - e1).to(dtype))
    out = torch.where(dec.s == 1, -mag, mag)
    out = torch.where(dec.is_zero, torch.zeros_like(out), out)
    out = torch.where(dec.is_nar, torch.full_like(out, float("nan")), out)
    return out.to(dtype)


# -- logarithmic representation (S, ell_bar) ---------------------------------


class LnsDecoded(NamedTuple):
    """LNS decoder output: sign, fixed-point ``ell_bar`` (signed,
    ``frac_width(n)`` fraction bits; ``None`` from n = 61, where it does
    not fit an int64 lane), the special-word flags, and ``ell_bar``'s two
    parts, the characteristic ``c`` and the mantissa field ``mant``
    (``ell_bar = c * 2^wf + mant``, exact at every width)."""
    s: torch.Tensor
    ell_bar: Optional[torch.Tensor]
    is_zero: torch.Tensor
    is_nar: torch.Tensor
    c: torch.Tensor
    mant: torch.Tensor


ELL_BAR_MAX_N = 60     # |c| * 2^wf < 2^63 (|c| <= 255, wf <= 55)


def decode_lns(words, n: int, *, hw_path: bool = False) -> LnsDecoded:
    """Decode to ``(S, ell_bar)``: ``ell_bar = c + m`` is the characteristic
    and the mantissa field side by side, a fixed-point number with
    ``frac_width(n)`` fraction bits. Up to n = 60 it is exact in an int64
    lane (the reference's int32 lane wraps from n = 29 and its int64 lane
    from n = 61); from n = 61 it needs up to 68 bits, so ``ell_bar`` is
    ``None`` and the two parts ``(c, mant)``, returned at every width,
    carry it apart."""
    dec = decode(words, n, hw_path=hw_path)
    ell = (dec.val * (1 << frac_width(n)) + dec.mant   # (c << wf) | mant
           if n <= ELL_BAR_MAX_N else None)
    return LnsDecoded(s=dec.s, ell_bar=ell, is_zero=dec.is_zero,
                      is_nar=dec.is_nar, c=dec.val, mant=dec.mant)


def decode_lns_parts(words, n: int, *, hw_path: bool = False):
    """``(ell, flags)`` int32 lanes: the un-barred ``ell = (-1)^S ell_bar``
    and ``flags`` = S | is_zero << 1 | is_nar << 2.

    A product of two values is one int32 add of their ``ell`` lanes and
    one XOR of their sign bits; the zero and NaR words keep the ``ell``
    their bits decode to (the kernels and the reference compute it the
    same way). ``n <= 27``: the characteristic, ``frac_width(n)``
    fraction bits and a product's carry fit an int32 lane."""
    if n > 27:
        raise ValueError("decode_lns_parts needs ell + carry in int32 "
                         f"lanes: n <= 27, got {n}")
    dec = decode_lns(words, n, hw_path=hw_path)
    ell = torch.where(dec.s == 1, -dec.ell_bar, dec.ell_bar)
    flags = (dec.s | (dec.is_zero.to(LANE) << 1)
             | (dec.is_nar.to(LANE) << 2))
    return ell.to(torch.int32), flags.to(torch.int32)


def encode_lns(s, ell_bar, n: int, *, wf: int, sticky=None, is_zero=None,
               is_nar=None, hw_path: bool = False) -> torch.Tensor:
    """Round ``(S, ell_bar)`` (signed fixed point, ``wf`` fraction bits)
    to n-bit words: the characteristic is the floor of ``ell_bar`` and
    the mantissa its fractional remainder, both monotone in ``ell_bar``."""
    ell = lanes(ell_bar)
    return encode(s, ell >> wf, ell & mask(wf, 64), n, wm=wf, sticky=sticky,
                  is_zero=is_zero, is_nar=is_nar, hw_path=hw_path)


def ell_bar_float(c, mant, wf: int, dtype) -> torch.Tensor:
    """``ell_bar = c * 2^wf + mant`` rounded once (to nearest even) to
    ``dtype`` (float32 or float64). Where it fits an int64 lane (wf <= 55)
    that is the integer's conversion, the reference's; beyond, |ell_bar|
    (up to 2^67) is converted directly below 2^62, and above it is first
    cut by k = wf - 52 bits with the cut bits ORed into the last kept one
    (round to odd: at least 55 significant bits stay, so the one rounding
    of the conversion equals the rounding of the exact value), then
    scaled back by 2^k."""
    if wf <= 55:
        return (c * (1 << wf) + mant).to(dtype)
    neg = c < 0
    borrow = neg & (mant != 0)
    cm = torch.where(neg, -c - borrow.to(LANE), c)       # |ell_bar| =
    mm = torch.where(borrow, (1 << wf) - mant, mant)     # cm 2^wf + mm
    small = cm < (1 << (62 - wf))
    exact = (torch.where(small, cm, 0) << wf) | mm
    k = wf - 52
    odd = (cm << (wf - k)) | (mm >> k) | ((mm & mask(k)) != 0).to(LANE)
    mag = torch.where(small, exact.to(dtype), odd.to(dtype) * float(1 << k))
    return torch.where(neg, -mag, mag)


def lns_takum_to_float(words, n: int, dtype=torch.float32) -> torch.Tensor:
    """``(-1)^S sqrt(e)^((-1)^S ell_bar)``: ``ell_bar`` rounded once to
    f32 or f64 (:func:`ell_bar_float`), divided by 2^wf, one ``exp``;
    other float dtypes compute in f32 and cast. Zero -> 0.0, NaR -> NaN."""
    dec = decode_lns(words, n)
    cdt = dtype if dtype in _IEEE else torch.float32
    wf = frac_width(n)
    ell_bar = ell_bar_float(dec.c, dec.mant, wf, cdt) / float(1 << wf)
    ell = torch.where(dec.s == 1, -ell_bar, ell_bar)
    mag = torch.exp(ell * 0.5)
    out = torch.where(dec.s == 1, -mag, mag)
    out = torch.where(dec.is_zero, torch.zeros_like(out), out)
    out = torch.where(dec.is_nar, torch.full_like(out, float("nan")), out)
    return out.to(dtype)


def float_to_lns_takum(x, n: int, *, wf_fixed: int = 22) -> torch.Tensor:
    """Round float32 values to n-bit logarithmic takum words:
    ``ell = 2 ln|x|`` in f32, clipped to +-256, rounded (half to even) to
    ``wf_fixed`` fraction bits, then RNE in ``ell_bar`` space, saturating.

    NaN -> NaR, +-0 -> 0, +-inf -> the largest magnitude of that sign."""
    if wf_fixed > 22:
        raise ValueError("wf_fixed > 22 overflows the int32 ell_bar lane")
    x = torch.as_tensor(x).to(torch.float32)
    s = (x < 0).to(LANE)
    is_zero = x == 0
    is_nan = torch.isnan(x)
    safe = torch.where(is_zero | is_nan, torch.ones_like(x), x)
    ell = 2.0 * torch.log(torch.abs(safe))
    ell_bar = torch.clamp(torch.where(s == 1, -ell, ell), -256.0, 256.0)
    ell_fixed = torch.round(ell_bar * float(1 << wf_fixed)).to(LANE)
    return encode_lns(s, ell_fixed, n, wf=wf_fixed, is_zero=is_zero,
                      is_nar=is_nan)
