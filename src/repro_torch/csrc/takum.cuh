// The takum codec as CUDA device functions: the input stage of every
// kernel in this directory.
//
// Replaces the tile codec that src/repro/kernels/takum_codec.py traces into
// its Pallas bodies (spec.decode_tile / spec.encode_tile, that is
// core/takum.py::takum_to_float and ::float_to_takum for linear takum,
// ::lns_takum_to_float, ::float_to_lns_takum and ::decode_lns_parts for
// logarithmic takum). The matmul and the attention kernels include this
// header and decode their word tiles with decode<N> or lns_decode<N> (the
// LNS matmul with lns_parts<N>); the codec kernels (codec.cu) launch them
// elementwise.
//
// Linear decode and encode are integer-only and bit-exact against the plain
// torch codec (repro_torch/core/takum.py): decode assembles the IEEE-754
// float32 word as sign | biased exponent | fraction with round-to-nearest-even
// gradual underflow and overflow to inf (NaR -> 0x7FC00000); encode rounds
// to nearest, ties to the even word, and saturates (a finite nonzero input
// never lands on the 0 or NaR words; NaN -> NaR; +-inf -> largest
// magnitude). Build without --use_fast_math: the subnormal band is exact.
//
// The dataflow takes magnitudes and negates by two's complement: a word w
// with S = 1 decodes to minus the value of (-w) mod 2^n, and a negative
// float encodes to (-word of |x|) mod 2^n (both hold for every word and
// float, linear, LNS and posit; the zero word decodes to +0). So no barred
// mantissa is ever formed.
// * Encode: a positive float 2^e (1 + m / 2^23) is the word
//   clamp(RNE((P << 23 | m) >> cut), 1, 2^(n-1) - 1), where P is the
//   header of characteristic c = e (D, R and the r bits of c: L = 4 + r
//   bits) and cut = L + 24 - n (negative from n = 29 next to a short
//   header: a shift up). The word order is the value order, so a carry out
//   of the mantissa moves to the next characteristic by itself, and the
//   clamp is the saturation (never 0 or NaR). P and the cut depend on c
//   alone: `Cut` holds P << (wm + pre) in two 32-bit lanes with the cut in
//   the low five bits; one 64-bit add and two funnel shifts round it
//   (round_entry).
//   The codec kernels read a Cut per float exponent from a block table
//   (csrc/codec.cuh); the device functions here compute it (takum_cut).
// * Decode: the header of a positive word (D, R and at most 7 bits of c)
//   lies in the 11 bits after the sign (ghost bits appended below 12), so
//   c and the mantissa width follow from those bits alone: the float32
//   bits are (c + 127) << 23 | mant << (23 - p); outside float32's normal
//   range, or from n = 29 (the fraction rounds into float32), the word is
//   assembled by assemble_f32_n. The codec kernels read the header from a
//   2048-entry block table (decode_entry); the device functions decode it
//   in registers (header_of).
//
// Widths: 6 <= n <= 32, read from the unsigned storage of the word (8, 16
// or 32 bits), in the functions above the "wide" section; the wide section
// takes 6 <= n <= 64 (64-bit words from n = 33) and decodes to float32 or
// float64. Every function takes n at run time (the `_n` forms); the
// template forms decode<N>, encode<N>, lns_parts<N>, lns_decode<N> and
// lns_encode<N> that the served kernels instantiate at N = 8 and 16 call
// them with a constant n, which folds to straight-line code. The
// mantissa field is frac_width = max(n, 12) - 5 bits: up to n = 28 the
// float32 fraction is a left shift of it; from n = 29 (27 bits at n = 32)
// it is rounded into float32 as the plain version does (f32_fraction).
//
// The LNS side: lns_parts is integer-only and bit-exact (n <= 27: ell and a
// product's carry fit an int); lns_decode adds one expf and lns_encode one
// logf (full precision), so they agree with the plain torch codec to an ulp
// or two of exp and log: decode values within 2 ulp, encode words equal or,
// where the log lands at a rounding tie of the ell_bar grid, the
// neighbouring word. The LNS encode's integer tail rounds ell_bar's fixed
// point form through the same Cut (wm = 22, c in [-256, 256]). From n = 28
// the decode takes ell in a 64-bit lane.
#pragma once
#include <cstdint>
#include <math.h>

namespace takum {

template <int N> struct Word;
template <> struct Word<8> { using type = uint8_t; };
template <> struct Word<16> { using type = uint16_t; };
template <int N> using WordT = typename Word<N>::type;

// RNE(v / 2^sh) on a 32-bit lane, sh >= 1 of any size.
__device__ __forceinline__ uint32_t rne_shr(uint32_t v, int sh) {
    uint32_t kept = sh >= 32 ? 0u : v >> sh;
    uint32_t g = (sh - 1) >= 32 ? 0u : (v >> (sh - 1)) & 1u;
    uint32_t rest_mask = (sh - 1) >= 32 ? 0xFFFFFFFFu : (1u << (sh - 1)) - 1u;
    bool rest = (v & rest_mask) != 0u;
    return kept + ((g && (rest || (kept & 1u))) ? 1u : 0u);
}

// The low n bits set (n in 1..32).
__device__ __forceinline__ uint32_t low_bits(int n) {
    return 0xFFFFFFFFu >> (32 - n);
}

// The IEEE-754 float32 of (-1)^s (1 + mf / 2^wf) 2^me, mf < 2^wf, wf <= 27:
// sign | biased exponent | fraction, round-to-nearest-even gradual
// underflow, overflow to inf. Shared by the takum and the posit decode.
// For wf > 23 the fraction is rounded as the plain version's f32_fraction
// (core/takum.py): to 24 significant bits of mf first (the reference's
// oracle converts mf to float32), then to 23 fraction bits, both to
// nearest even, the carry of a fraction rounded up to 2 into the exponent.
__device__ __forceinline__ float assemble_f32_n(uint32_t s, uint32_t mf,
                                                int me, int wf) {
    uint32_t frac;
    int carry = 0;
    if (wf <= 23) {
        frac = mf << (23 - wf);
    } else {
        if (wf > 24) {
            const int sh1 = (31 - __clz(mf | 1u)) - 23;
            if (sh1 > 0) mf = rne_shr(mf, sh1) << sh1;
        }
        frac = rne_shr(mf, wf - 23);
        carry = (int)(frac >> 23);
        frac &= 0x7FFFFFu;
    }
    const int be = me + 127 + carry;
    const uint32_t sign = s << 31;
    uint32_t bits;
    if (be >= 255) bits = sign | 0x7F800000u;
    else if (be <= 0) bits = sign | rne_shr((1u << 23) | frac, 1 - be);
    else bits = sign | ((uint32_t)be << 23) | frac;
    return __uint_as_float(bits);
}

// (-w) mod 2^n for S = 1, else w: the magnitude word (its bit n - 1 is 0
// but for NaR).
__device__ __forceinline__ uint32_t magnitude(uint32_t w, uint32_t s, int n) {
    return s ? (0u - w) & low_bits(n) : w;
}

// ---- encode: a header P and its cut -----------------------------------

// The shift up applied to P << wm | m so that the cut is at least 1: the
// shortest header (L = 4) cuts at wm + 5 - n.
__device__ __forceinline__ int cut_pre(int n, int wm) {
    return n - wm - 4 > 1 ? n - wm - 4 : 1;
}

// A header P of L bits for mantissas of wm bits at width n: the 64-bit
// P << (wm + pre) in two lanes, lo's low five bits (zero in the shifted
// P, since wm + pre >= 23) holding the cut L + wm + 1 - n + pre, which is
// in [1, 31]: the kept word has at most n - 1 bits, and the bits below
// the cut are all in lo.
struct Cut {
    uint32_t lo, hi;
};

__device__ __forceinline__ Cut make_cut(uint64_t p, int len, int n, int wm) {
    const int pre = cut_pre(n, wm);
    const uint64_t x = p << (wm + pre);
    return {(uint32_t)x | (uint32_t)(len + wm + 1 - n + pre),
            (uint32_t)(x >> 32)};
}

// Cuts that saturate whatever the mantissa: to the largest magnitude (the
// kept word has bit 31 set and clamps) and to the smallest (it is 0 and
// clamps to 1).
__device__ __forceinline__ Cut cut_over() { return {1u, 1u}; }
__device__ __forceinline__ Cut cut_under() { return {31u, 0u}; }

// A cut as the codec kernels' encode tables hold it (16 bytes): the
// shifted P in x (low bits clear) and y, the cut z and the RNE bias
// 2^(z - 1) - 1 in w.
__device__ __forceinline__ uint4 cut_entry(Cut k) {
    const uint32_t sh = k.lo & 31u;
    return make_uint4(k.lo & ~31u, k.hi, sh, (1u << (sh - 1)) - 1u);
}

// RNE((P << wm | m) >> cut) clamped to [1, top = 2^(n-1) - 1] from a cut
// entry e and mp = m << cut_pre(n, wm): the magnitude word of a positive
// value. The rounding adds the bias and the kept word's last bit before
// the shift (ties to even), one 64-bit add and two funnel shifts.
__device__ __forceinline__ uint32_t round_entry(uint4 e, uint32_t mp,
                                                uint32_t top) {
    const uint32_t lo = e.x | mp;
    const uint32_t kept = __funnelshift_r(lo, e.y, e.z);
    const unsigned long long x =
        (((unsigned long long)e.y << 32) | lo) + (e.w + (kept & 1u));
    const uint32_t w = __funnelshift_r((uint32_t)x, (uint32_t)(x >> 32), e.z);
    return w < 1u ? 1u : (w > top ? top : w);
}

// round_entry of a cut computed in registers, m of wm bits.
__device__ __forceinline__ uint32_t round_cut(Cut k, uint32_t m, int n,
                                              int wm) {
    return round_entry(cut_entry(k), m << cut_pre(n, wm), low_bits(n - 1));
}

// The header of characteristic c in [-255, 254]: D, R (r or 7 - r) and
// the r low bits of c + 1 (D = 1) or of ~c (D = 0), len = L = 4 + r bits.
__device__ __forceinline__ uint32_t takum_header(int c, int& len) {
    const uint32_t d = c >= 0 ? 1u : 0u;
    const uint32_t t = (uint32_t)((d ? c : ~c) + 1);        // [1, 255]
    const int r = 31 - __clz(t);
    const uint32_t r3 = d ? (uint32_t)r : (uint32_t)(7 - r);
    const uint32_t cbits = (d ? t : ~t) & ((1u << r) - 1u);
    len = 4 + r;
    return (d << (3 + r)) | (r3 << r) | cbits;
}

// The cut of that header for mantissas of wm bits at width n <= 32.
__device__ __forceinline__ Cut takum_cut(int c, int n, int wm) {
    int len;
    const uint32_t p = takum_header(c, len);
    return make_cut(p, len, n, wm);
}

// A float32's magnitude bits (nonzero, finite) as 2^e (1 + m / 2^23):
// the index e + 150 of a per-exponent table (1..277: subnormals
// normalised to 1..23, normals 24..277) and the 23-bit fraction m.
__device__ __forceinline__ int exp_index(uint32_t mag, uint32_t& m) {
    const int lz = __clz(mag) - 8;              // > 0: a subnormal
    const int sh = lz > 0 ? lz : 0;
    m = (mag << sh) & 0x7FFFFFu;
    return lz > 0 ? 24 - lz : (int)(mag >> 23) + 23;
}

// The signed n-bit word of a float from the magnitude word w of |x|:
// +-0 -> 0, NaN -> NaR, +-inf -> the largest magnitude, then negated for
// S = 1.
__device__ __forceinline__ uint32_t signed_word(uint32_t bits, uint32_t w,
                                                int n) {
    const uint32_t mag = bits & 0x7FFFFFFFu;
    if (mag == 0x7F800000u) w = low_bits(n - 1);
    if (mag == 0u) w = 0u;
    if (mag > 0x7F800000u) return 1u << (n - 1);
    return magnitude(w, bits >> 31, n);
}

// float32 -> n-bit takum word (in the low n bits): c = e.
__device__ __forceinline__ uint32_t encode_n(float x, int n) {
    const uint32_t bits = __float_as_uint(x);
    uint32_t m;
    const int i = exp_index(bits & 0x7FFFFFFFu, m);
    return signed_word(bits, round_cut(takum_cut(i - 150, n, 23), m, n, 23),
                       n);
}

template <int N>
__device__ __forceinline__ uint32_t encode(float x) { return encode_n(x, N); }

// ---- decode: the header of a positive word ----------------------------

// The characteristic c, regime r and mantissa bits p12 of a positive word
// t (n12 = max(n, 12) bits, ghost bits appended), and its header value
// t >> p12 (D, R, C: 4 + r bits).
struct Header {
    int c, r, p12;
};

__device__ __forceinline__ Header header_of(uint32_t t, int n12) {
    const uint32_t d = (t >> (n12 - 2)) & 1u;
    const int rb = (int)((t >> (n12 - 5)) & 7u);
    const int r = d ? rb : 7 - rb;
    const int p12 = n12 - 5 - r;
    const int uc = (int)((t >> p12) & ((1u << r) - 1u));
    return {d ? (1 << r) - 1 + uc : -(1 << (r + 1)) + 1 + uc, r, p12};
}

// The float32 bits of a positive n-bit takum word a (not 0).
__device__ __forceinline__ uint32_t positive_bits(uint32_t a, int n) {
    const int n12 = n < 12 ? 12 : n;
    const uint32_t t = a << (n12 - n);           // ghost bits
    const Header h = header_of(t, n12);
    const uint32_t mant = t & ((1u << h.p12) - 1u);
    if (n <= 28 && h.c >= -126 && h.c <= 127)
        return ((uint32_t)(h.c + 127) << 23) | (mant << (23 - h.p12));
    return __float_as_uint(assemble_f32_n(0u, mant << h.r, h.c, n12 - 5));
}

// n-bit takum word -> float32.
__device__ __forceinline__ float decode_n(uint32_t w, int n) {
    w &= low_bits(n);
    const uint32_t s = w >> (n - 1);
    if ((w & low_bits(n - 1)) == 0u)
        return s ? __uint_as_float(0x7FC00000u) : 0.0f;
    return __uint_as_float(positive_bits(magnitude(w, s, n), n) | (s << 31));
}

template <int N>
__device__ __forceinline__ float decode(uint32_t w) { return decode_n(w, N); }

// The codec kernels' decode table: one 32-bit entry for each value of the
// 11 bits after the sign (the header and the mantissa's first bits of the
// 12-bit form, ghost bits appended), at width n. Linear takum: the float32
// bits of a positive word are (t << sh) + A, t its n12-bit form, with A =
// (c + 127 - header) << 23 in bits 23-31 and sh = 23 - p12 in bits 0-4;
// bit 5 marks a header whose value is not a float32 normal or a width
// whose fraction rounds (n >= 29), decoded in registers instead. Entry 0
// (the zero word, NaR, c = -255) is marked with A = 0 and sh = 0, so the
// zero word gives +0 without the mark.
__device__ __forceinline__ uint32_t decode_entry(uint32_t idx, int n) {
    if (idx == 0u) return 32u;      // marked, A = 0 and sh = 0: the zero word
    const Header h = header_of(idx, 12);
    const int n12 = n < 12 ? 12 : n;
    const uint32_t rare = (n > 28 || h.c < -126 || h.c > 127) ? 32u : 0u;
    return ((uint32_t)(h.c + 127 - (int)(idx >> h.p12)) << 23)
           | (uint32_t)((23 - (n12 - 5 - h.r)) & 31) | rare;
}

// The fields of an n-bit takum word (ghost bits appended below 12 bits):
// sign, characteristic c, the mantissa field left-aligned at
// frac_width(n) bits, and whether it is the 0 / NaR word. The raw word's
// fields (S = 1 barred), as the LNS matmul's integer lanes take them.
struct Fields {
    uint32_t s;
    int c;
    uint32_t mant;
    bool special;
};

__device__ __forceinline__ Fields fields(uint32_t w, int n) {
    const int n12 = n < 12 ? 12 : n;
    const uint32_t t = w << (n12 - n);          // ghost bits
    const Header h = header_of(t & low_bits(n12 - 1), n12);
    Fields f;
    f.s = (t >> (n12 - 1)) & 1u;
    f.special = (t & low_bits(n12 - 1)) == 0u;
    f.mant = (t & ((1u << h.p12) - 1u)) << h.r;
    f.c = h.c;
    return f;
}

// The logarithmic side of the codec (representation (10)):
// ell_bar = c * 2^wf + mant, the characteristic and the mantissa field side
// by side; ell = (-1)^S ell_bar. flags: bit 0 = S, bit 1 = zero, bit 2 =
// NaR. The zero and NaR words keep the ell their bits decode to, as in the
// plain version (repro_torch/core/takum.py::decode_lns_parts).
struct LnsParts {
    int ell;
    int flags;
};

__device__ __forceinline__ int lns_flags(const Fields& f) {
    return (int)f.s | ((f.special && !f.s) ? 2 : 0)
           | ((f.special && f.s) ? 4 : 0);
}

template <int N>
__device__ __forceinline__ LnsParts lns_parts(uint32_t w) {
    static_assert(N <= 27, "ell and a product's carry fit an int");
    constexpr int WF = (N < 12 ? 12 : N) - 5;
    const Fields f = fields(w, N);
    const int ell_bar = f.c * (1 << WF) + (int)f.mant;
    LnsParts p;
    p.ell = f.s ? -ell_bar : ell_bar;
    p.flags = lns_flags(f);
    return p;
}

// ell_bar = c * 2^wf + mant of a positive word's n12-bit form t, where
// t >> p12 is its header: (t << r) - (header << wf) + (c << wf). In a
// 32-bit lane (wrapping, exact up to n = 27), or in 64 bits from n = 28.
__device__ __forceinline__ float lns_ell(uint32_t t, int r, long long base,
                                         int n) {
    const int wf = (n < 12 ? 12 : n) - 5;
    if (n <= 27)
        return (float)(int)((t << r) + ((uint32_t)base << wf));
    return (float)(((long long)t << r) + base * (1ll << wf));
}

// n-bit logarithmic takum word -> float32: (-1)^S sqrt(e)^ell, one expf
// (full precision: no fast-math), ell = ell_bar of the magnitude word.
// Zero -> 0.0, NaR -> NaN. ell is exact in an int up to n = 27 and in a
// 64-bit lane above; its conversion to float32 rounds to nearest even, as
// the plain version's.
__device__ __forceinline__ float lns_decode_n(uint32_t w, int n) {
    w &= low_bits(n);
    const int n12 = n < 12 ? 12 : n;
    const int wf = n12 - 5;
    const uint32_t s = w >> (n - 1);
    if ((w & low_bits(n - 1)) == 0u)
        return s ? __uint_as_float(0x7FC00000u) : 0.0f;
    const uint32_t t = magnitude(w, s, n) << (n12 - n);
    const Header h = header_of(t, n12);
    const long long base = (long long)h.c - (long long)(t >> h.p12);
    const float mag = expf(lns_ell(t, h.r, base, n) *
                           (0.5f / (float)(1 << wf)));
    return s ? -mag : mag;
}

// The LNS decode table of the codec kernels: c - header in bits 8-31
// (signed) and r in bits 0-2, for the 11 bits after the sign.
__device__ __forceinline__ int lns_entry(uint32_t idx) {
    const Header h = header_of(idx, 12);
    return ((h.c - (int)(idx >> h.p12)) << 8) | h.r;
}

template <int N>
__device__ __forceinline__ float lns_decode(uint32_t w) {
    return lns_decode_n(w, N);
}

// The LNS encode's integer tail: the header cut of ell_bar's floor
// characteristic c in [-256, 256] (wm = 22), saturating outside
// [-255, 254].
__device__ __forceinline__ Cut lns_cut(int c, int n) {
    if (c > 254) return cut_over();
    if (c < -255) return cut_under();
    return takum_cut(c, n, 22);
}

// The fixed point ell_bar * 2^22 of a magnitude (ell_bar = 2 ln|x| rounded
// half to even, clipped to +-256).
__device__ __forceinline__ int lns_fixed(float x) {
    const float eb = fminf(fmaxf(2.0f * logf(fabsf(x)), -256.0f), 256.0f);
    return (int)rintf(eb * (float)(1 << 22));
}

// float32 -> n-bit logarithmic takum word: ell_bar = 2 ln|x| (one logf),
// clipped to +-256, rounded half to even to 22 fraction bits, then the
// cut of its floor characteristic rounds it to nearest even, saturating;
// negated for S = 1. NaN -> NaR, +-0 -> 0, +-inf -> the largest magnitude
// of that sign.
__device__ __forceinline__ uint32_t lns_encode_n(float x, int n) {
    const uint32_t bits = __float_as_uint(x);
    const int fixed = lns_fixed(x);
    const uint32_t w = round_cut(lns_cut(fixed >> 22, n),
                                 (uint32_t)fixed & 0x3FFFFFu, n, 22);
    return signed_word(bits, w, n);
}

template <int N>
__device__ __forceinline__ uint32_t lns_encode(float x) {
    return lns_encode_n(x, N);
}

// ---- wide: 64-bit words and float64 output ------------------------------
//
// Words of 6 <= n <= 64 bits in the low bits of a uint64_t (64-bit storage
// from n = 33), decoded to float32 or float64 (O), and float32 encoded to
// 64-bit words. The dataflow is the narrow one's: magnitudes negated by
// two's complement, the header of the 11 bits after the sign (the same
// 12-bit window at every width: only the mantissa grows, to n - 5 bits in
// a 64-bit register), the IEEE word assembled with the plain version's two
// roundings where the fraction is wider than the significand (float32 from
// wf > 24, float64 from wf > 53: n = 59). The encode shifts the header and
// the float's fraction into place: (P << wm | m) << (n - 1 - L - wm),
// rounded to nearest even only where that shift is negative (linear takum
// at n = 33 and 34, posit next to a long regime), then clamped to [1, top].

// The low n bits set (n in 1..64).
__device__ __forceinline__ uint64_t low_bits64(int n) {
    return ~0ull >> (64 - n);
}

// RNE(v / 2^sh) on a 64-bit lane, sh >= 1 of any size.
__device__ __forceinline__ uint64_t rne_shr64(uint64_t v, int sh) {
    const uint64_t kept = sh >= 64 ? 0ull : v >> sh;
    const uint64_t g = sh - 1 >= 64 ? 0ull : (v >> (sh - 1)) & 1ull;
    const uint64_t rest =
        v & (sh - 1 >= 64 ? ~0ull : (1ull << (sh - 1)) - 1ull);
    return kept + ((g && (rest || (kept & 1ull))) ? 1ull : 0ull);
}

// float32 and float64: fraction bits, bias, the all-ones exponent, the
// sign bit, the quiet NaN, and the float of a bit pattern.
template <typename O> struct Ieee;
template <> struct Ieee<float> {
    static constexpr int FB = 23, BIAS = 127, EMAX = 255, SBIT = 31;
    static constexpr uint64_t NAN_BITS = 0x7FC00000ull;
    __device__ static float of(uint64_t b) {
        return __uint_as_float((uint32_t)b);
    }
};
template <> struct Ieee<double> {
    static constexpr int FB = 52, BIAS = 1023, EMAX = 2047, SBIT = 63;
    static constexpr uint64_t NAN_BITS = 0x7FF8000000000000ull;
    __device__ static double of(uint64_t b) {
        return __longlong_as_double((long long)b);
    }
};

// The O of (-1)^s (1 + mf / 2^wf) 2^me, mf < 2^wf, wf <= 59: the plain
// version's assemble_float (core/takum.py). For wf > FB the fraction is
// rounded as the reference's oracle rounds it: to FB + 1 significant bits
// first (where wf > FB + 1: its int-to-float conversion), then to FB
// fraction bits, both to nearest even, a fraction rounded up to 2 carrying
// into the exponent; RNE gradual underflow, overflow to inf.
template <typename O>
__device__ __forceinline__ O assemble(uint32_t s, uint64_t mf, int me,
                                      int wf) {
    using T = Ieee<O>;
    uint64_t frac;
    int carry = 0;
    if (wf <= T::FB) {
        frac = mf << (T::FB - wf);
    } else {
        if (wf > T::FB + 1) {
            const int sh1 = (63 - __clzll((long long)(mf | 1ull))) - T::FB;
            if (sh1 > 0) mf = rne_shr64(mf, sh1) << sh1;
        }
        frac = rne_shr64(mf, wf - T::FB);
        carry = (int)(frac >> T::FB);
        frac &= (1ull << T::FB) - 1ull;
    }
    const int be = me + T::BIAS + carry;
    const uint64_t sign = (uint64_t)s << T::SBIT;
    uint64_t bits;
    if (be >= T::EMAX) bits = sign | ((uint64_t)T::EMAX << T::FB);
    else if (be <= 0) bits = sign | rne_shr64((1ull << T::FB) | frac, 1 - be);
    else bits = sign | ((uint64_t)be << T::FB) | frac;
    return T::of(bits);
}

// The 0 word and NaR.
template <typename O>
__device__ __forceinline__ O special_wide(uint32_t s) {
    return s ? Ieee<O>::of(Ieee<O>::NAN_BITS) : (O)0;
}

// A word's sign, its magnitude word ((-w) mod 2^n for S = 1) and whether
// it is 0 or NaR.
struct WideMag {
    uint32_t s;
    uint64_t a;
    bool special;
};

__device__ __forceinline__ WideMag wide_mag(uint64_t w, int n) {
    w &= low_bits64(n);
    const uint32_t s = (uint32_t)(w >> (n - 1));
    return {s, s ? (0ull - w) & low_bits64(n) : w,
            (w & low_bits64(n - 1)) == 0ull};
}

// The characteristic c of a takum magnitude's header and its mantissa
// field left-aligned at wf = n12 - 5 bits, from its n12-bit form t (ghost
// bits appended): mf = (t << r) cut to wf bits (the header's 4 + r bits
// shift out above); c and r from the header's 12-bit window in registers
// (header_of) or, in the codec kernels, from the lns_entry table of the 11
// bits after the sign: ((c - header) << 8) | r.
__device__ __forceinline__ int wide_fields(uint64_t t, int n12, uint64_t& mf) {
    const Header h = header_of((uint32_t)(t >> (n12 - 12)) & 0xFFFu, 12);
    mf = (t << h.r) & low_bits64(n12 - 5);
    return h.c;
}

__device__ __forceinline__ int wide_fields_tab(uint64_t t, int n12,
                                               const uint32_t* tab,
                                               uint64_t& mf) {
    const uint32_t idx = (uint32_t)(t >> (n12 - 12)) & 0x7FFu;
    const int e = (int)tab[idx];
    const int r = e & 7;
    mf = (t << r) & low_bits64(n12 - 5);
    return (e >> 8) + (int)(idx >> (7 - r));
}

// ell_bar = c * 2^wf + mf rounded once, to nearest even, to O: the integer's
// conversion where it fits 64 bits (wf <= 55); beyond, |ell_bar| (up to
// 2^67) converted directly below 2^62 and, above, first cut by wf - 52 bits
// with the cut bits ORed into the last kept one (round to odd: 55 or more
// significant bits stay, so the conversion's one rounding is the exact
// value's), then scaled back (core/takum.py::ell_bar_float).
template <typename O>
__device__ __forceinline__ O ell_to(int c, uint64_t mf, int wf) {
    if (wf <= 55) return (O)((long long)c * (1ll << wf) + (long long)mf);
    const bool neg = c < 0;
    const bool borrow = neg && mf != 0ull;
    const uint64_t cm = (uint64_t)(neg ? -c - (borrow ? 1 : 0) : c);
    const uint64_t mm = borrow ? (1ull << wf) - mf : mf;
    O mag;
    if (cm < (1ull << (62 - wf))) {
        mag = (O)(long long)((cm << wf) | mm);
    } else {
        const int k = wf - 52;
        const uint64_t odd = (cm << 52) | (mm >> k)
                             | ((mm & ((1ull << k) - 1ull)) ? 1ull : 0ull);
        mag = (O)(long long)odd * (O)(1ull << k);
    }
    return neg ? -mag : mag;
}

// (-1)^S sqrt(e)^ell of a magnitude's c and mf: one exp in O (expf for
// float32, exp for float64; full precision, no fast-math).
template <typename O>
__device__ __forceinline__ O lns_value_wide(uint32_t s, int c, uint64_t mf,
                                            int wf) {
    const O ell = ell_to<O>(c, mf, wf) * ((O)0.5 / (O)(1ull << wf));
    O mag;
    if constexpr (sizeof(O) == 4) mag = expf(ell);
    else mag = exp(ell);
    return s ? -mag : mag;
}

// n-bit linear takum word -> O (6 <= n <= 64).
template <typename O>
__device__ __forceinline__ O decode_wide(uint64_t w, int n) {
    const WideMag m = wide_mag(w, n);
    if (m.special) return special_wide<O>(m.s);
    const int n12 = n < 12 ? 12 : n;
    uint64_t mf;
    const int c = wide_fields(m.a << (n12 - n), n12, mf);
    return assemble<O>(m.s, mf, c, n12 - 5);
}

// n-bit logarithmic takum word -> O (6 <= n <= 64).
template <typename O>
__device__ __forceinline__ O lns_decode_wide(uint64_t w, int n) {
    const WideMag m = wide_mag(w, n);
    if (m.special) return special_wide<O>(m.s);
    const int n12 = n < 12 ? 12 : n;
    uint64_t mf;
    const int c = wide_fields(m.a << (n12 - n), n12, mf);
    return lns_value_wide<O>(m.s, c, mf, n12 - 5);
}

// RNE(v * 2^sh), v < 2^58, clamped to [1, top]: the header and the
// fraction shifted into place, rounded where sh < 0.
__device__ __forceinline__ uint64_t round_wide(uint64_t v, int sh,
                                               uint64_t top) {
    const uint64_t w = sh >= 0 ? v << sh : rne_shr64(v, -sh);
    return w < 1ull ? 1ull : (w > top ? top : w);
}

// The magnitude word of a saturated characteristic (+inf in linear takum,
// ell_bar >= 255 in LNS): the plain encoder's largest characteristic, 254
// (header 0x7FF, L = 11), with an all-ones wm-bit mantissa and a sticky
// bit: the largest word to n = 35 (LNS: 34), that mantissa shifted into
// place above. A negative one (S = 1) saturates through the smallest
// characteristic to the word after NaR: the largest magnitude.
__device__ __forceinline__ uint64_t saturated_wide(int n, int wm) {
    return round_wide((0x7FFull << wm) | ((1ull << wm) - 1ull),
                      n - 12 - wm, low_bits64(n - 1));
}

// float32 -> n-bit linear takum word (in the low n bits), 33 <= n <= 64.
__device__ __forceinline__ uint64_t encode_wide(float x, int n) {
    const uint32_t bits = __float_as_uint(x), mag = bits & 0x7FFFFFFFu;
    const uint32_t s = bits >> 31;
    const uint64_t top = low_bits64(n - 1);
    if (mag > 0x7F800000u) return 1ull << (n - 1);
    if (mag == 0u) return 0ull;
    uint64_t w;
    if (mag == 0x7F800000u) {
        w = s ? top : saturated_wide(n, 23);
    } else {
        uint32_t m;
        int len;
        const int i = exp_index(mag, m);
        const uint64_t p = takum_header(i - 150, len);
        w = round_wide((p << 23) | m, n - 24 - len, top);
    }
    return s ? (0ull - w) & low_bits64(n) : w;
}

// float32 -> n-bit logarithmic takum word, 33 <= n <= 64: lns_encode_n's
// ell_bar (one logf), shifted into place.
__device__ __forceinline__ uint64_t lns_encode_wide(float x, int n) {
    const uint32_t bits = __float_as_uint(x), mag = bits & 0x7FFFFFFFu;
    const uint32_t s = bits >> 31;
    const uint64_t top = low_bits64(n - 1);
    if (mag > 0x7F800000u) return 1ull << (n - 1);
    if (mag == 0u) return 0ull;
    const int fixed = lns_fixed(x);
    const int c = fixed >> 22;
    uint64_t w;
    if (c > 254) {
        w = s ? top : saturated_wide(n, 22);
    } else if (c < -255) {
        w = 1ull;
    } else {
        int len;
        const uint64_t p = takum_header(c, len);
        w = round_wide((p << 22) | ((uint32_t)fixed & 0x3FFFFFu),
                       n - 23 - len, top);
    }
    return s ? (0ull - w) & low_bits64(n) : w;
}

}  // namespace takum
