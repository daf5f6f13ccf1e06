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
// Widths: N in {8, 16}. An N-bit word is read from its unsigned storage
// type (WordT<N>). The mantissa field is frac_width = max(N, 12) - 5 <= 11
// bits, so the float32 fraction is a left shift of it and never rounds.
//
// The LNS side: lns_parts is integer-only and bit-exact; lns_decode adds
// one expf and lns_encode one logf (full precision), so they agree with the
// plain torch codec to an ulp or two of exp and log: decode values within
// 2 ulp, encode words equal or, where the log lands at a rounding tie of
// the ell_bar grid, the neighbouring word.
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

// The IEEE-754 float32 of (-1)^s (1 + mf / 2^WF) 2^me, mf < 2^WF, WF <= 23:
// sign | biased exponent | fraction, round-to-nearest-even gradual
// underflow, overflow to inf. Shared by the takum and the posit decode.
template <int WF>
__device__ __forceinline__ float assemble_f32(uint32_t s, uint32_t mf,
                                              int me) {
    const uint32_t frac = mf << (23 - WF);
    const int be = me + 127;
    const uint32_t sign = s << 31;
    uint32_t bits;
    if (be >= 255) bits = sign | 0x7F800000u;
    else if (be <= 0) bits = sign | rne_shr((1u << 23) | frac, 1 - be);
    else bits = sign | ((uint32_t)be << 23) | frac;
    return __uint_as_float(bits);
}

// N-bit takum word -> float32.
template <int N>
__device__ __forceinline__ float decode(uint32_t w) {
    constexpr int N12 = N < 12 ? 12 : N;
    constexpr int WF = N12 - 5;                 // mantissa field width
    const uint32_t t = w << (N12 - N);          // ghost bits
    const uint32_t s = (t >> (N12 - 1)) & 1u;
    const uint32_t d = (t >> (N12 - 2)) & 1u;
    const int rb = (int)((t >> (N12 - 5)) & 7u);
    const int r = d ? rb : 7 - rb;              // regime
    if ((t & ((1u << (N12 - 1)) - 1u)) == 0u)   // zero or NaR
        return s ? __uint_as_float(0x7FC00000u) : 0.0f;
    const int p12 = N12 - 5 - r;                // mantissa bits present
    const int uc = (int)((t >> p12) & ((1u << r) - 1u));
    const uint32_t mant = (t & ((1u << p12) - 1u)) << r;   // WF bits
    const int c = d ? (1 << r) - 1 + uc : -(1 << (r + 1)) + 1 + uc;
    // linear representation: e = (-1)^S (c + S); then un-bar S = 1 so that
    // magnitude = (1 + mf / 2^WF) * 2^me
    int me = s ? -(c + 1) : c;
    uint32_t mf = mant;
    if (s) {
        if (mant != 0u) mf = (1u << WF) - mant;
        else me += 1;
    }
    return assemble_f32<WF>(s, mf, me);
}

// (S, characteristic c, barred mantissa of WM bits) -> N-bit takum word
// (in the low N bits): round to nearest, ties to the even word, saturating.
// Out-of-range characteristics saturate to the largest or smallest
// magnitude (never to 0 or NaR).
template <int N, int WM>
__device__ __forceinline__ uint32_t encode_fields(uint32_t s, int c,
                                                  uint32_t mant) {
    const bool over = c > 254, under = c < -255;
    const bool sticky = over || under;
    c = c > 254 ? 254 : (c < -255 ? -255 : c);
    if (over) mant = (1u << WM) - 1u;
    if (under) mant = 0u;
    const uint32_t d = c >= 0 ? 1u : 0u;
    const uint32_t cp = (uint32_t)((d ? c : ~c) + 1);        // [1, 255]
    const int r = 31 - __clz(cp);
    const uint32_t r3 = d ? (uint32_t)r : (uint32_t)(7 - r);
    const uint32_t cbits = (d ? cp : ~cp) & ((1u << r) - 1u);
    const int p = N - 5 - r;                     // mantissa bits that fit
    const uint32_t header = (s << (N - 1)) | (d << (N - 2)) | (r3 << (N - 5));
    uint32_t body, g;
    bool rest;
    if (p >= 0) {                                // cut inside the mantissa
        const int cut = WM - p;                  // >= WM - 11 >= 1
        body = (cbits << p) | (mant >> cut);
        g = (mant >> (cut - 1)) & 1u;
        rest = (mant & ((1u << (cut - 1)) - 1u)) != 0u;
    } else {                                     // cut inside c (N < 12)
        const int cut_c = -p;
        body = cbits >> cut_c;
        g = (cbits >> (cut_c - 1)) & 1u;
        rest = (cbits & ((1u << (cut_c - 1)) - 1u)) != 0u || mant != 0u;
    }
    rest = rest || sticky;
    const uint32_t rd = header | body;
    const uint32_t nmask = (1u << N) - 1u, low = (1u << (N - 1)) - 1u;
    const uint32_t ru = (rd + 1u) & nmask;
    const bool underflow_down = (rd & low) == 0u;   // RD is the 0/NaR word
    const bool overflow_up = (ru & low) == 0u;      // RU wraps onto 0/NaR
    const bool up = underflow_down || (!overflow_up && g && (rest || (rd & 1u)));
    return up ? ru : rd;
}

// float32 -> N-bit takum word (in the low N bits).
template <int N>
__device__ __forceinline__ uint32_t encode(float x) {
    const uint32_t bits = __float_as_uint(x);
    const uint32_t s = bits >> 31;
    const int exp_f = (int)((bits >> 23) & 0xFFu);
    const uint32_t frac = bits & 0x7FFFFFu;
    if (exp_f == 0 && frac == 0u) return 0u;                 // +-0
    if (exp_f == 255 && frac != 0u) return 1u << (N - 1);    // NaN -> NaR
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
    return encode_fields<N, 23>(s, s ? ~e : e, mant);   // c from e
}

// The logarithmic side of the codec (representation (10)):
// ell_bar = c * 2^WF + mant, the characteristic and the mantissa field side
// by side; ell = (-1)^S ell_bar. flags: bit 0 = S, bit 1 = zero, bit 2 =
// NaR. The zero and NaR words keep the ell their bits decode to, as in the
// plain version (repro_torch/core/takum.py::decode_lns_parts).
struct LnsParts {
    int ell;
    int flags;
};

template <int N>
__device__ __forceinline__ LnsParts lns_parts(uint32_t w) {
    constexpr int N12 = N < 12 ? 12 : N;
    constexpr int WF = N12 - 5;
    const uint32_t t = w << (N12 - N);
    const uint32_t s = (t >> (N12 - 1)) & 1u;
    const uint32_t d = (t >> (N12 - 2)) & 1u;
    const int rb = (int)((t >> (N12 - 5)) & 7u);
    const int r = d ? rb : 7 - rb;
    const bool special = (t & ((1u << (N12 - 1)) - 1u)) == 0u;
    const int p12 = N12 - 5 - r;
    const int uc = (int)((t >> p12) & ((1u << r) - 1u));
    const uint32_t mant = (t & ((1u << p12) - 1u)) << r;
    const int c = d ? (1 << r) - 1 + uc : -(1 << (r + 1)) + 1 + uc;
    const int ell_bar = c * (1 << WF) + (int)mant;
    LnsParts p;
    p.ell = s ? -ell_bar : ell_bar;
    p.flags = (int)s | ((special && !s) ? 2 : 0) | ((special && s) ? 4 : 0);
    return p;
}

// N-bit logarithmic takum word -> float32: (-1)^S sqrt(e)^ell, one expf
// (full precision: no fast-math). Zero -> 0.0, NaR -> NaN.
template <int N>
__device__ __forceinline__ float lns_decode(uint32_t w) {
    constexpr int WF = (N < 12 ? 12 : N) - 5;
    const LnsParts p = lns_parts<N>(w);
    if (p.flags & 4) return __uint_as_float(0x7FC00000u);
    if (p.flags & 2) return 0.0f;
    const float mag = expf((float)p.ell * (0.5f / (float)(1 << WF)));
    return (p.flags & 1) ? -mag : mag;
}

// float32 -> N-bit logarithmic takum word: ell_bar = (-1)^S 2 ln|x| (one
// logf), clipped to +-256, rounded half to even to 22 fraction bits, then
// the integer RNE of encode_fields in ell_bar space (floor characteristic,
// fractional remainder as the mantissa), saturating. NaN -> NaR,
// +-0 -> 0, +-inf -> the largest magnitude of that sign.
template <int N>
__device__ __forceinline__ uint32_t lns_encode(float x) {
    constexpr int WFIX = 22;
    if (x == 0.0f) return 0u;
    if (x != x) return 1u << (N - 1);
    const uint32_t s = x < 0.0f ? 1u : 0u;
    const float ell = 2.0f * logf(fabsf(x));
    float eb = s ? -ell : ell;
    eb = fminf(fmaxf(eb, -256.0f), 256.0f);
    const int fixed = (int)rintf(eb * (float)(1 << WFIX));
    const int c = fixed >> WFIX;                           // floor
    const uint32_t mant = (uint32_t)fixed & ((1u << WFIX) - 1u);
    return encode_fields<N, WFIX>(s, c, mant);
}

}  // namespace takum
