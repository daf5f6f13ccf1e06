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
// Widths: 6 <= n <= 32, read from the unsigned storage of the word (8, 16
// or 32 bits). Every function takes n at run time (the `_n` forms); the
// template forms decode<N>, encode<N>, lns_parts<N>, lns_decode<N> and
// lns_encode<N> that the served kernels instantiate at N = 8 and 16 call
// them with a constant n, which folds to the code they had before. The
// mantissa field is frac_width = max(n, 12) - 5 bits: up to n = 28 the
// float32 fraction is a left shift of it; from n = 29 (27 bits at n = 32)
// it is rounded into float32 as the plain version does (f32_fraction).
//
// The LNS side: lns_parts is integer-only and bit-exact (n <= 27: ell and a
// product's carry fit an int); lns_decode adds one expf and lns_encode one
// logf (full precision), so they agree with the plain torch codec to an ulp
// or two of exp and log: decode values within 2 ulp, encode words equal or,
// where the log lands at a rounding tie of the ell_bar grid, the
// neighbouring word. From n = 28 the decode takes ell in a 64-bit lane.
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

// The fields of an n-bit takum word (ghost bits appended below 12 bits):
// sign, characteristic c, the mantissa field left-aligned at
// frac_width(n) bits, and whether it is the 0 / NaR word.
struct Fields {
    uint32_t s;
    int c;
    uint32_t mant;
    bool special;
};

__device__ __forceinline__ Fields fields(uint32_t w, int n) {
    const int n12 = n < 12 ? 12 : n;
    const uint32_t t = w << (n12 - n);          // ghost bits
    const uint32_t d = (t >> (n12 - 2)) & 1u;
    const int rb = (int)((t >> (n12 - 5)) & 7u);
    const int r = d ? rb : 7 - rb;              // regime
    const int p12 = n12 - 5 - r;                // mantissa bits present
    const int uc = (int)((t >> p12) & ((1u << r) - 1u));
    Fields f;
    f.s = (t >> (n12 - 1)) & 1u;
    f.special = (t & low_bits(n12 - 1)) == 0u;
    f.mant = (t & ((1u << p12) - 1u)) << r;
    f.c = d ? (1 << r) - 1 + uc : -(1 << (r + 1)) + 1 + uc;
    return f;
}

// n-bit takum word -> float32.
__device__ __forceinline__ float decode_n(uint32_t w, int n) {
    const int wf = (n < 12 ? 12 : n) - 5;      // mantissa field width
    const Fields f = fields(w, n);
    if (f.special) return f.s ? __uint_as_float(0x7FC00000u) : 0.0f;
    // linear representation: e = (-1)^S (c + S); then un-bar S = 1 so that
    // magnitude = (1 + mf / 2^wf) * 2^me
    int me = f.s ? -(f.c + 1) : f.c;
    uint32_t mf = f.mant;
    if (f.s) {
        if (f.mant != 0u) mf = (1u << wf) - f.mant;
        else me += 1;
    }
    return assemble_f32_n(f.s, mf, me, wf);
}

template <int N>
__device__ __forceinline__ float decode(uint32_t w) { return decode_n(w, N); }

// (S, characteristic c, barred mantissa of wm bits) -> n-bit takum word
// (in the low n bits): round to nearest, ties to the even word, saturating.
// Out-of-range characteristics saturate to the largest or smallest
// magnitude (never to 0 or NaR). For wm < n - 4 (n >= 28 from a float32's
// 23 bits) the cut may lie below the mantissa: it is shifted up.
__device__ __forceinline__ uint32_t encode_fields_n(uint32_t s, int c,
                                                    uint32_t mant, int n,
                                                    int wm) {
    const bool over = c > 254, under = c < -255;
    const bool sticky = over || under;
    c = c > 254 ? 254 : (c < -255 ? -255 : c);
    if (over) mant = (1u << wm) - 1u;
    if (under) mant = 0u;
    const uint32_t d = c >= 0 ? 1u : 0u;
    const uint32_t cp = (uint32_t)((d ? c : ~c) + 1);        // [1, 255]
    const int r = 31 - __clz(cp);
    const uint32_t r3 = d ? (uint32_t)r : (uint32_t)(7 - r);
    const uint32_t cbits = (d ? cp : ~cp) & ((1u << r) - 1u);
    const int p = n - 5 - r;                     // mantissa bits that fit
    const uint32_t header = (s << (n - 1)) | (d << (n - 2)) | (r3 << (n - 5));
    const bool pad = wm < n - 4;                 // the cut may be below 1
    uint32_t body, g;
    bool rest;
    if (p >= 0) {                                // cut inside the mantissa
        const int cut = wm - p;
        body = (cbits << p) | (!pad || cut >= 0 ? mant >> cut : mant << -cut);
        const bool in = !pad || cut >= 1;
        g = in ? (mant >> (cut - 1)) & 1u : 0u;
        rest = in && (mant & ((1u << (cut - 1)) - 1u)) != 0u;
    } else {                                     // cut inside c (n < 12)
        const int cut_c = -p;
        body = cbits >> cut_c;
        g = (cbits >> (cut_c - 1)) & 1u;
        rest = (cbits & ((1u << (cut_c - 1)) - 1u)) != 0u || mant != 0u;
    }
    rest = rest || sticky;
    const uint32_t rd = header | body;
    const uint32_t low = low_bits(n - 1);
    const uint32_t ru = (rd + 1u) & low_bits(n);
    const bool underflow_down = (rd & low) == 0u;   // RD is the 0/NaR word
    const bool overflow_up = (ru & low) == 0u;      // RU wraps onto 0/NaR
    const bool up = underflow_down || (!overflow_up && g && (rest || (rd & 1u)));
    return up ? ru : rd;
}

// float32 -> n-bit takum word (in the low n bits).
__device__ __forceinline__ uint32_t encode_n(float x, int n) {
    const uint32_t bits = __float_as_uint(x);
    const uint32_t s = bits >> 31;
    const int exp_f = (int)((bits >> 23) & 0xFFu);
    const uint32_t frac = bits & 0x7FFFFFu;
    if (exp_f == 0 && frac == 0u) return 0u;                 // +-0
    if (exp_f == 255 && frac != 0u) return 1u << (n - 1);    // NaN -> NaR
    int big_e;
    uint32_t m23;
    if (exp_f == 0) {            // subnormal: (1 + f') * 2^(b - 149)
        const int b = 31 - __clz(frac);
        big_e = b - 149;
        m23 = (frac << (23 - b)) & 0x7FFFFFu;
    } else {
        big_e = exp_f - 127;
        m23 = frac;
    }
    // barred fraction: two's complement for S = 1, exponent borrow at 0
    int e = (s && m23 == 0u) ? big_e - 1 : big_e;
    uint32_t mant = (s && m23 != 0u) ? ((1u << 23) - m23) & 0x7FFFFFu : m23;
    if (exp_f == 255) e = 10000;                 // inf saturates
    return encode_fields_n(s, s ? ~e : e, mant, n, 23);    // c from e
}

template <int N>
__device__ __forceinline__ uint32_t encode(float x) { return encode_n(x, N); }

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

// n-bit logarithmic takum word -> float32: (-1)^S sqrt(e)^ell, one expf
// (full precision: no fast-math). Zero -> 0.0, NaR -> NaN. ell is exact in
// an int up to n = 27 and in a 64-bit lane above; its conversion to
// float32 rounds to nearest even, as the plain version's.
__device__ __forceinline__ float lns_decode_n(uint32_t w, int n) {
    const int wf = (n < 12 ? 12 : n) - 5;
    const Fields f = fields(w, n);
    if (f.special) return f.s ? __uint_as_float(0x7FC00000u) : 0.0f;
    float ell;
    if (n <= 27) {
        const int eb = f.c * (1 << wf) + (int)f.mant;
        ell = (float)(f.s ? -eb : eb);
    } else {
        const long long eb = (long long)f.c * (1ll << wf) + f.mant;
        ell = (float)(f.s ? -eb : eb);
    }
    const float mag = expf(ell * (0.5f / (float)(1 << wf)));
    return f.s ? -mag : mag;
}

template <int N>
__device__ __forceinline__ float lns_decode(uint32_t w) {
    return lns_decode_n(w, N);
}

// float32 -> n-bit logarithmic takum word: ell_bar = (-1)^S 2 ln|x| (one
// logf), clipped to +-256, rounded half to even to 22 fraction bits, then
// the integer RNE of encode_fields_n in ell_bar space (floor characteristic,
// fractional remainder as the mantissa), saturating. NaN -> NaR,
// +-0 -> 0, +-inf -> the largest magnitude of that sign.
__device__ __forceinline__ uint32_t lns_encode_n(float x, int n) {
    constexpr int WFIX = 22;
    if (x == 0.0f) return 0u;
    if (x != x) return 1u << (n - 1);
    const uint32_t s = x < 0.0f ? 1u : 0u;
    const float ell = 2.0f * logf(fabsf(x));
    float eb = s ? -ell : ell;
    eb = fminf(fmaxf(eb, -256.0f), 256.0f);
    const int fixed = (int)rintf(eb * (float)(1 << WFIX));
    const int c = fixed >> WFIX;                           // floor
    const uint32_t mant = (uint32_t)fixed & ((1u << WFIX) - 1u);
    return encode_fields_n(s, c, mant, n, WFIX);
}

template <int N>
__device__ __forceinline__ uint32_t lns_encode(float x) {
    return lns_encode_n(x, N);
}

}  // namespace takum
