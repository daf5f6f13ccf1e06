// The posit<N, es = 2> codec as CUDA device functions: the posit baseline's
// input stage in every kernel of this directory.
//
// Replaces the posit tile codec that the Pallas kernels of src/repro/kernels/
// trace through FormatSpec.decode_tile / encode_tile for posit8 and posit16:
// core/posit.py::posit_to_float (variant "2c", the registry's) and
// ::float_to_posit. Integer-only and bit-exact against the plain torch codec
// (repro_torch/core/posit.py). Posits are ordered as two's complement
// integers, so both directions take magnitudes and negate by two's
// complement (as takum.cuh does):
// * decode: the magnitude word's regime is the leading run of the n - 1
//   bits after the sign, counted with one __clz; k = m - 1 for a run of
//   ones, else -m; then the two exponent bits (ghost bits read as 0) and
//   the fraction, and the float32 bits are (4k + e + 127) << 23 | fraction.
//   NaR -> 0x7FC00000. Every posit of n <= 32 is a float32 normal; from
//   n = 29 the fraction is rounded into float32 (takum::assemble_f32_n).
// * encode: a positive float 2^e (1 + m / 2^23) is the word
//   clamp(RNE((P << 23 | m) >> cut), 1, 2^(n-1) - 1) with P the regime of
//   k = floor(e / 4) and the two exponent bits e mod 4 (takum::round_cut:
//   ties to the even word, saturating: a finite nonzero input never lands
//   on 0 or NaR; +-inf -> the largest magnitude; NaN -> NaR), then negated
//   for S = 1. k is clamped to [-(n - 1), n - 2] first, which changes no
//   word (beyond it every value rounds to minpos or maxpos).
// Widths 6 <= n <= 32 at run time (the `_n` forms); decode<N> and
// encode<N> call them with a constant n. The wide forms (decode_wide,
// encode_wide) take 6 <= n <= 64 in 64-bit lanes, to float32 or float64:
// the regime over up to 63 bits is one __clzll. From n = 29 a float32's 23
// fraction bits may not reach the cut next to a short regime: the fraction
// is shifted up (the plain version's departure from the reference, whose
// encoder leaves it unshifted there).
// Build without --use_fast_math. posit8's 256-entry table decode is in
// wire.cuh (built from decode<8>).
#pragma once
#include <cstdint>
#include "takum.cuh"

namespace posit {

// The float32 bits of a positive n-bit posit word a (not 0).
__device__ __forceinline__ uint32_t positive_bits(uint32_t a, int n) {
    const uint32_t body = a << (33 - n);             // n - 1 bits at the top
    const uint32_t top = body >> 31;
    const int m = __clz(top ? ~body : body);         // regime run, <= n - 1
    const int k = top ? m - 1 : -m;
    const uint32_t rest = (body << m) << 1;          // after the regime
    const int me = 4 * k + (int)(rest >> 30);
    const uint32_t frac = rest << 2;                 // left-aligned fraction
    if (n <= 28) return ((uint32_t)(me + 127) << 23) | (frac >> 9);
    return __float_as_uint(
        takum::assemble_f32_n(0u, frac >> (37 - n), me, n - 5));
}

// n-bit posit word (es = 2) -> float32.
__device__ __forceinline__ float decode_n(uint32_t w, int n) {
    w &= takum::low_bits(n);
    const uint32_t s = w >> (n - 1);
    if ((w & takum::low_bits(n - 1)) == 0u)          // zero or NaR
        return s ? __uint_as_float(0x7FC00000u) : 0.0f;
    return __uint_as_float(positive_bits(takum::magnitude(w, s, n), n)
                           | (s << 31));
}

template <int N>
__device__ __forceinline__ float decode(uint32_t w) { return decode_n(w, N); }

// The header of float exponent e at width n: the regime of k = floor(e / 4)
// (k + 1 ones and a 0 for k >= 0, -k zeros and a 1 below), then e mod 4;
// k clamped to [-(n - 1), n - 2]; len = its length (the regime's and 2).
__device__ __forceinline__ uint64_t posit_header(int e, int n, int& len) {
    int k = e >> 2;
    k = k > n - 2 ? n - 2 : (k < 1 - n ? 1 - n : k);
    const uint64_t regime = k >= 0 ? ((2ull << k) - 1ull) << 1 : 1ull;
    len = (k >= 0 ? k + 2 : 1 - k) + 2;
    return (regime << 2) | (uint32_t)(e & 3);
}

// Its cut for the float's 23 fraction bits at width n <= 32.
__device__ __forceinline__ takum::Cut posit_cut(int e, int n) {
    int len;
    const uint64_t p = posit_header(e, n, len);
    return takum::make_cut(p, len, n, 23);
}

// float32 -> n-bit posit word (in the low n bits).
__device__ __forceinline__ uint32_t encode_n(float x, int n) {
    const uint32_t bits = __float_as_uint(x);
    uint32_t m;
    const int i = takum::exp_index(bits & 0x7FFFFFFFu, m);
    return takum::signed_word(
        bits, takum::round_cut(posit_cut(i - 150, n), m, n, 23), n);
}

template <int N>
__device__ __forceinline__ uint32_t encode(float x) { return encode_n(x, N); }

// The magnitude word a's regime, exponent and fraction (left-aligned at
// wf = n - 5 bits) in a 64-bit lane: the n - 1 bits after the sign at the
// top, the regime's run counted by one __clzll (at most n - 1: the bits
// below are zeros, or ones when inverted).
__device__ __forceinline__ int wide_fields(uint64_t a, int n, uint64_t& mf) {
    const uint64_t body = a << (65 - n);
    const uint64_t top = body >> 63;
    const int m = __clzll((long long)(top ? ~body : body));
    const int k = top ? m - 1 : -m;
    const uint64_t rest = (body << m) << 1;           // after the regime
    mf = (rest << 2) >> (69 - n);
    return 4 * k + (int)(rest >> 62);
}

// n-bit posit word (es = 2) -> O, 6 <= n <= 64.
template <typename O>
__device__ __forceinline__ O decode_wide(uint64_t w, int n) {
    const takum::WideMag m = takum::wide_mag(w, n);
    if (m.special) return takum::special_wide<O>(m.s);
    uint64_t mf;
    const int me = wide_fields(m.a, n, mf);
    return takum::assemble<O>(m.s, mf, me, n - 5);
}

// float32 -> n-bit posit word, 33 <= n <= 64: the header and the fraction
// shifted into place, rounded where the regime leaves too few bits; +-inf
// to the largest magnitude.
__device__ __forceinline__ uint64_t encode_wide(float x, int n) {
    const uint32_t bits = __float_as_uint(x), mag = bits & 0x7FFFFFFFu;
    const uint64_t top = takum::low_bits64(n - 1);
    if (mag > 0x7F800000u) return 1ull << (n - 1);
    if (mag == 0u) return 0ull;
    uint64_t w = top;
    if (mag != 0x7F800000u) {
        uint32_t m;
        int len;
        const int i = takum::exp_index(mag, m);
        const uint64_t p = posit_header(i - 150, n, len);
        w = takum::round_wide((p << 23) | m, n - 24 - len, top);
    }
    return bits >> 31 ? (0ull - w) & takum::low_bits64(n) : w;
}

}  // namespace posit
