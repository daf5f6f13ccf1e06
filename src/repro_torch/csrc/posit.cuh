// The posit<N, es = 2> codec as CUDA device functions: the posit baseline's
// input stage in every kernel of this directory.
//
// Replaces the posit tile codec that the Pallas kernels of src/repro/kernels/
// trace through FormatSpec.decode_tile / encode_tile for posit8 and posit16:
// core/posit.py::posit_to_float (variant "2c", the registry's) and
// ::float_to_posit. Integer-only and bit-exact against the plain torch codec
// (repro_torch/core/posit.py):
// * decode: the FloPoCo-2C dataflow on the raw word (no negation): the
//   regime is the leading run of the N - 1 bits after the sign, counted with
//   one __clz; k = m - 1 when the run's bit differs from S, else -m; the two
//   exponent bits (ghost bits read as 0) are XOR-ed with S; then S = 1 is
//   un-barred and the float32 word assembled as the takum decode does
//   (takum::assemble_f32_n). NaR -> 0x7FC00000. Every posit of n <= 32 is
//   a float32 normal; from n = 29 the fraction is rounded into float32.
// * encode: float32 -> representation (8), then the regime, exponent and
//   fraction laid out and rounded to nearest, ties to the even word,
//   saturating (a finite nonzero input never lands on 0 or NaR; +-inf -> the
//   largest magnitude; NaN -> NaR), then negated for S = 1.
// Widths 6 <= n <= 32 at run time (the `_n` forms); decode<N> and
// encode<N> call them with a constant n. From n = 29 a float32's 23
// fraction bits may not reach the cut next to a short regime: the fraction
// is shifted up (the plain version's departure from the reference, whose
// encoder leaves it unshifted there).
// Build without --use_fast_math. posit8's 256-entry table decode is in
// wire.cuh (built from decode<8>).
#pragma once
#include <cstdint>
#include "takum.cuh"

namespace posit {

// n-bit posit word (es = 2) -> float32.
__device__ __forceinline__ float decode_n(uint32_t w, int n) {
    const int wf = n - 5;                            // fraction field width
    const uint32_t LOW = takum::low_bits(n - 1);
    const uint32_t p = w & takum::low_bits(n);
    if ((p & LOW) == 0u)                             // zero or NaR
        return p ? __uint_as_float(0x7FC00000u) : 0.0f;
    const uint32_t s = p >> (n - 1);
    const uint32_t body = (p & LOW) << (33 - n);     // n - 1 bits at the top
    const uint32_t top = body >> 31;
    const uint32_t u = (top ? ~body : body) & (LOW << (33 - n));
    int m = __clz(u);                                // regime run length
    if (m > n - 1) m = n - 1;
    const int k = (top ^ s) ? m - 1 : -m;
    const int remaining = n - 2 - m;                 // bits after the regime
    const int rem = remaining > 0 ? remaining : 0;
    const uint32_t field = p & ((1u << rem) - 1u);
    uint32_t e2 = remaining >= 2 ? (field >> (rem - 2)) & 3u
                : (remaining == 1 ? (field & 1u) << 1 : 0u);
    const int fr_bits = remaining > 2 ? remaining - 2 : 0;
    const uint32_t frac = (field & ((1u << fr_bits) - 1u)) << (wf - fr_bits);
    e2 ^= 3u * s;                                    // barred exponent bits
    int me = 4 * k + (int)e2;
    uint32_t mf = frac;
    if (s) {                                         // un-bar S = 1
        if (frac != 0u) mf = (1u << wf) - frac;
        else me += 1;
    }
    return takum::assemble_f32_n(s, mf, me, wf);
}

template <int N>
__device__ __forceinline__ float decode(uint32_t w) { return decode_n(w, N); }

// (S, e, barred fraction of wm bits) of representation (8) -> n-bit posit
// word (in the low n bits): RNE to the even word, saturating, negated for
// S = 1.
__device__ __forceinline__ uint32_t encode_fields_n(uint32_t s, int e,
                                                    uint32_t frac, int n,
                                                    int wm) {
    const uint32_t LOW = takum::low_bits(n - 1);
    const uint32_t WMASK = (1u << wm) - 1u;
    const bool f_nz = frac != 0u;
    uint32_t mf = (s && f_nz) ? ((1u << wm) - frac) & WMASK : frac;
    const int me = e + ((s && !f_nz) ? 1 : 0);       // magnitude exponent
    int k = me >> 2;                                 // floor(me / 4)
    uint32_t e2 = (uint32_t)me & 3u;
    const bool k_hi = k > n - 2, k_lo = k < -(n - 2);
    if (k_hi) { k = n - 2; e2 = 3u; mf = WMASK; }
    if (k_lo) { k = -(n - 2); e2 = 0u; mf = 0u; }
    // regime: k >= 0: (k + 1) ones and a 0; k < 0: |k| zeros and a 1 (the
    // 32-bit lane wraps at k + 2 = 32, as the plain version's)
    const int rl = k >= 0 ? k + 2 : 1 - k;
    const uint32_t regime =
        k >= 0 ? (k + 2 >= 32 ? 0u : 1u << (k + 2)) - 2u : 1u;
    const uint32_t low = (e2 << wm) | mf;            // 2 + wm bits
    const int cut = rl + 2 + wm - (n - 1);           // bits to drop
    const bool pad = wm < n - 4;                     // the cut may be < 1
    uint32_t body, g;
    bool rest;
    if (cut <= 2 + wm) {                             // cut inside `low`
        body = (regime << (2 + wm - cut))
               | (!pad || cut >= 0 ? low >> cut : low << -cut);
        const bool in = !pad || cut >= 1;
        g = in ? (low >> (cut - 1)) & 1u : 0u;
        rest = in && cut >= 2 && (low & ((1u << (cut - 1)) - 1u)) != 0u;
    } else {                                         // cut inside the regime
        const int c2 = cut - (2 + wm);
        body = regime >> c2;
        g = (regime >> (c2 - 1)) & 1u;
        rest = (regime & ((1u << (c2 - 1)) - 1u)) != 0u || low != 0u;
    }
    rest = rest || k_hi || k_lo;                     // saturation is sticky
    const uint32_t rd = body & LOW;                  // magnitude word
    const uint32_t ru = rd + 1u;
    const bool underflow_down = rd == 0u;            // RD would be 0
    const bool overflow_up = ru > LOW;               // RU would be NaR
    const bool up =
        underflow_down || (!overflow_up && g && (rest || (rd & 1u)));
    const uint32_t word = up ? ru : rd;
    return s ? (~word + 1u) & takum::low_bits(n) : word;
}

// float32 -> n-bit posit word (in the low n bits).
__device__ __forceinline__ uint32_t encode_n(float x, int n) {
    const uint32_t bits = __float_as_uint(x);
    const uint32_t s = bits >> 31;
    const int exp_f = (int)((bits >> 23) & 0xFFu);
    const uint32_t fr = bits & 0x7FFFFFu;
    if (exp_f == 0 && fr == 0u) return 0u;                   // +-0
    if (exp_f == 255 && fr != 0u) return 1u << (n - 1);      // NaN -> NaR
    int big_e;
    uint32_t m23;
    if (exp_f == 0) {            // subnormal: (1 + f') * 2^(b - 149)
        const int b = 31 - __clz(fr);
        big_e = b - 149;
        m23 = (fr << (23 - b)) & 0x7FFFFFu;
    } else {
        big_e = exp_f - 127;
        m23 = fr;
    }
    // representation (8): two's-complemented fraction, exponent borrow
    int e = (s && m23 == 0u) ? big_e - 1 : big_e;
    const uint32_t f = (s && m23 != 0u) ? ((1u << 23) - m23) & 0x7FFFFFu : m23;
    if (exp_f == 255) e = 100000;                            // inf saturates
    return encode_fields_n(s, e, f, n, 23);
}

template <int N>
__device__ __forceinline__ uint32_t encode(float x) { return encode_n(x, N); }

}  // namespace posit
