// Fused fake-quantisation: out = decode(encode(x)) in one pass, float32 in,
// float32, bfloat16 or float64 out.
//
// Replaces src/repro/kernels/quantize.py::fake_quant_kernel_call
// (_fake_quant_tile): the round trip through a wire format's grid over
// (256, 128) VMEM tiles without the word tensor ever reaching HBM. Here,
// for linear takum (optionally scaled by a power of two), logarithmic
// takum and posit (posit8 through its table code too), at every width
// 6 <= n <= 64.
//
// What bounds it on the H100: bytes. One float32 read and one float32 (or
// bfloat16) write per element, 8 (or 6) bytes over 3.35 TB/s: 0.219 (or
// 0.164) ms at [5120, 17920]. The integer pipes issue about 64 operations
// an SM and clock, so an element may cost about 35 integer instructions
// before issue, not bytes, bounds the kernel; the first design (one
// element a thread and iteration through the register codec, 95-150
// instructions an element) ran at 1.7-2.5x the byte bound and no faster
// with bfloat16 output. This design spends about 18 (f32 out) or 25
// (bf16) instructions an element on linear takum and posit, which run at
// the card's copy rate or near it; LNS spends up to 77 on its full-
// precision logf and expf, and issue still bounds it. The design:
// * Memory: the codec kernels' skeleton (codec.cu). Vectors of 4
//   consecutive elements, one 16-byte float load and one 16-byte (f32) or
//   8-byte (bf16) store; two vectors a thread and iteration, both loads
//   issued first; a grid-stride loop over one wave of resident blocks
//   (codec::codec_grid); a scalar tail for the ragged end, and the scalar
//   loop throughout for pointers that are not 16-byte aligned (a slice of
//   a leaf may reach the kernel so).
// * Linear takum and posit: a round in value space. For a normal float
//   x = 2^c (1 + f), whose word keeps p = n - 1 - L(c) >= 1 fraction bits
//   (L the header's length: takum 4 + floor_log2((c >= 0 ? c : ~c) + 1),
//   posit the regime of c >> 2 and two exponent bits), decode(encode(x))
//   is x's own float32 bits rounded to nearest even with d = 23 - p bits
//   dropped (unchanged for d <= 0): the word's last kept bit is a fraction
//   bit with the float's parity, and a carry out of the fraction is the
//   word's carry into the next characteristic (at c = 127: +inf, as the
//   decode gives). So the common element costs a lookup of its exponent's
//   (d, mask) in a 256-entry block table, an add and a mask. Zeros,
//   subnormals, infinities, NaNs and exponents with p < 1 (at takum8
//   every |c| > 7) take the word path: the codec kernels' table encode
//   (codec::encode4) and table decode (codec::decode4: the header table,
//   registers for posit, the 256 floats at n = 8), the words kept in
//   registers. kernels/ref.py::fake_quant_dataflow is its plain mirror.
// * Logarithmic takum: the same round on ell_bar = 2 ln|x| (one logf, its
//   fixed point form of 22 fraction bits as the encode forms it), to
//   nearest even at the word's mantissa width p = n - 5 - r of its floor
//   characteristic where p >= 1, then the decode's conversion of that ell
//   and one expf: bit for bit the codec kernels' round trip, without the
//   word. At n = 8, and for vectors with a zero, an infinity, a NaN or
//   p < 1, the word path with both of the codec kernels' tables (the
//   encode's 513 characteristic cuts; the 256 decoded floats at n = 8, the
//   header table otherwise).
// Both paths give the same bits, so which of them a lane runs is a
// matter of time only, and the template parameters choose it: with
// bfloat16 output, linear takum and posit take one path a warp, by vote
// (the word path where any lane holds a float the value path does not
// take, the value path otherwise); with float32 output, and for LNS, each
// lane takes its own path and a warp whose lanes chose apart runs both.
// On the served traffic (takum8, per-tensor scale; device time of graph
// replays) the vote is 20% faster at bfloat16 out (kimi-k2's bf16 expert
// slices) and 5% slower at float32 out (granite-moe's f32 expert
// stacks); at 12-32 bits the two are within 1%, but LNS, whose value path
// is as long as its word path, loses 2-4% to the vote at float32 out (the
// readings are in PERF.md, section 6).
// One kernel per (kind, scaled, out dtype), n a kernel argument; only
// linear takum is ever scaled. With `scaled`, x is multiplied by s_in =
// 2^k before the round and the result by s_out = 2^-k after it (exact
// powers of two: core/quant.py's per-tensor centring, the serving
// fake-quant policy of linear takum; x * 2^k may overflow or become
// subnormal, and takes the word path then); a NaN result is left as it
// is, so its bits stay 0x7FC00000 (a multiply would make it 0x7FFFFFFF).
// The bfloat16 output is the float32 value rounded to nearest even, as
// PyTorch's .to(bfloat16); a NaN becomes the quiet NaN 0x7FC0 (PyTorch's
// NaN bits differ between its CPU and CUDA casts, so NaNs are compared by
// place). Build without --use_fast_math: the s_out multiply may give
// subnormals, which the plain version keeps.
// 64-bit widths (n = 33..64) and float64 output: the value path is the same
// round (float64 out: on the float64 bits of x with 29 more bits dropped,
// so that a carry out of float32's range stays finite, as the word's
// float64 decode is; LNS: the same rounded ell_bar, one exp in double),
// and the word path runs each element through the wide codec in registers
// (wire::Wide: 64-bit words, the float64 decode; out of line, since only
// zeros, subnormals, infinities, NaNs and posit's longest regimes reach
// it). From n = 35 linear takum keeps every float32 bit (p = n - 12 >= 23
// whatever the header) and from n = 59 posit does (a normal float's
// regime and exponent bits take at most 35): there a normal float is its
// own word's value, and the value path reads no table and rounds nothing.
// One bytes bound more: float64 out writes 8 bytes an element (12 bytes
// an element, 0.329 ms at [5120, 17920]).
#include <cuda_runtime.h>
#include "codec.cuh"

namespace {

__device__ __forceinline__ uint16_t f32_to_bf16_rne(float f) {
    if (f != f) return 0x7FC0u;
    const uint32_t b = __float_as_uint(f);
    return (uint16_t)((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16);
}

constexpr uint32_t RARE = 0x80000000u;

// The value path's entry for biased float32 exponent e at width n: the
// dropped bits d (clamped to 0) in bits 0-7 and the mask 2^d - 1 in bits
// 8-29, or RARE where the word path must round (e = 0 or 255, p < 1).
template <int K>
__device__ __forceinline__ uint32_t value_entry(uint32_t e, int n) {
    if (e == 0u || e == 255u) return RARE;
    const int c = (int)e - 127;
    int d;
    if constexpr (K == wire::LINEAR) {
        d = (31 - __clz((c ^ (c >> 31)) + 1)) + 28 - n;
    } else {
        const int k = c >> 2;
        d = (k ^ (k >> 31)) + 28 - n;
    }
    if (d > 22) return RARE;
    d = d < 0 ? 0 : d;
    return (((1u << d) - 1u) << 8) | (uint32_t)d;
}

// RNE of float bits b with the entry's d bits dropped: the bias 2^(d-1) -
// 1 and the kept word's last bit added, then the dropped bits cleared (d
// = 0: b as it is).
__device__ __forceinline__ uint32_t value_round(uint32_t b, uint32_t e) {
    const uint32_t m = e >> 8;
    return (b + (e >> 9) + (__funnelshift_r(b, 0u, e) & m & 1u)) & ~m;
}

// The LNS value path: ell_bar's fixed point form (22 fraction bits, one
// logf) rounded to nearest even at the word's mantissa width p = n - 5 - r
// of its floor characteristic c (d = 22 - p bits dropped): the word's
// last kept bit is a mantissa bit, and a carry out of the mantissa is the
// word's carry into c + 1. False (the word path) for p < 1 and outside
// -254 <= c <= 253, where the word saturates or its carry would (zeros,
// infinities and NaNs land there: ell_bar clipped to -256 or 256).
__device__ __forceinline__ bool lns_value(float v, int n, int& q) {
    q = takum::lns_fixed(v);
    const int c = q >> 22;
    const int d = (31 - __clz((c ^ (c >> 31)) + 1)) + 27 - n;
    if (d > 21 || c < -254 || c > 253) return false;
    if (d > 0) {
        const uint32_t m = (1u << d) - 1u, u = (uint32_t)q;
        q = (int)((u + (m >> 1) + ((u >> d) & 1u)) & ~m);
    }
    return true;
}

// The decode of a rounded ell_bar q (22 fraction bits, of x's magnitude):
// its value in units of 2^-wf, converted to O as the decode converts the
// word's (exact to n = 27, where q's low 22 - wf bits are 0; above, q
// itself, whose conversion rounds as that of q << (wf - 22)), one exp
// (expf for float32), x's sign.
template <typename O>
__device__ __forceinline__ O lns_value_out(int q, float v, int n,
                                           float scale) {
    const int wf = (n < 12 ? 12 : n) - 5;
    O mag;
    if constexpr (sizeof(O) == 4) {
        mag = expf(n <= 27 ? (float)(q >> (22 - wf)) * scale
                           : (float)q * 0x1p-23f);
    } else {
        mag = exp(n <= 27 ? (double)(q >> (22 - wf)) * (0.5 / (1 << wf))
                          : (double)q * 0x1p-23);
    }
    return __float_as_uint(v) >> 31 ? -mag : mag;
}

// The word path's decode mode by kind: the codec kernels' (t8: the 256
// floats at n = 8).
template <int K>
struct WordPath {
    static constexpr int mode =
        K == wire::POSIT ? codec::REGISTERS : codec::HEADER;
    static constexpr int dsize = K == wire::POSIT ? 256 : 2048;
};

// Four floats through the codec kernels' encode and decode, the words in
// registers (n <= 32, float32 out).
template <int K>
__device__ __forceinline__ void round_trip4(const float4 v, float y[4],
                                            int n, bool t8,
                                            const uint4* etab,
                                            const uint32_t* dtab) {
    const codec::Width ce(n, K == wire::LNS ? 22 : 23), cd(n, 23);
    uint32_t w[4];
    codec::encode4<K>(v, w, ce, etab);
    if (t8) codec::decode4<K, codec::TABLE8>(w, y, cd, dtab);
    else codec::decode4<K, WordPath<K>::mode>(w, y, cd, dtab);
}

// One float through the wide codec (64-bit words, or float64 out at any
// width): out of line, the path of rare elements.
template <int K, typename O>
__device__ __noinline__ O round_trip_wide(float x, int n) {
    return wire::Wide<K>::template decode<O>(wire::Wide<K>::encode(x, n), n);
}

// OUT: 0 float32, 1 bfloat16, 2 float64; O: the type the value is formed
// in (float32 for bfloat16).
template <int OUT>
using OutT = std::conditional_t<OUT == 2, double, float>;

// WIDE: n > 32 or float64 out, the word path through the wide codec (no
// shared tables); else the narrow codec kernels' word path, with the tables.
template <int K, bool SCALED, int OUT, bool WIDE>
struct Ctx {
    using O = OutT<OUT>;
    int n;
    bool t8;        // narrow only: the word path decodes through n = 8's
    bool exact;     // wide only: every normal float is its own word's value
    float s_in, s_out, scale;     // scale: 0.5 / 2^wf, ell_bar to ln
    const uint4* etab;
    const uint32_t* dtab;
    const uint32_t* vtab;

    __device__ uint32_t entry(uint32_t b) const {
        return vtab[(b >> 23) & 0xFFu];
    }

    // whether the value path takes x (LNS: where t8 is false): u its entry
    // (linear takum, posit) or rounded ell_bar (LNS). At the exact widths
    // no table: only zeros, subnormals, infinities and NaNs take the word
    // path.
    __device__ bool prep1(float x, uint32_t& u) const {
        if constexpr (K == wire::LNS) {
            int q;
            const bool ok = lns_value(x, n, q);
            u = (uint32_t)q;
            return ok;
        } else {
            if constexpr (WIDE) {
                if (exact) {
                    const uint32_t e = __float_as_uint(x) & 0x7F800000u;
                    return e != 0u && e != 0x7F800000u;
                }
            }
            u = entry(__float_as_uint(x));
            return !(u & RARE);
        }
    }

    // x = v * s_in, and whether the value path takes all four
    __device__ bool prep(float4 v, float x[4], uint32_t u[4]) const {
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
        if constexpr (SCALED) {
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j] *= s_in;
        }
        if constexpr (K != wire::LNS) {
            if (!(WIDE && exact)) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    u[j] = entry(__float_as_uint(x[j]));
                return !((u[0] | u[1] | u[2] | u[3]) & RARE);
            }
        } else if (t8) {
            return false;
        }
        bool ok = true;
#pragma unroll
        for (int j = 0; j < 4; ++j) ok &= prep1(x[j], u[j]);
        return ok;
    }

    // the value path of one float prepared by prep1, times s_out: float32
    // bits rounded to nearest even at the word's fraction width (nothing
    // to round at the exact widths), or for float64 out the float64 bits
    // with 29 more bits dropped (a carry out of float32's exponent range
    // stays finite, as the word's float64 decode)
    __device__ O value1(float x, uint32_t u) const {
        O y;
        if constexpr (K == wire::LNS) {
            return lns_value_out<O>((int)u, x, n, scale);
        } else if constexpr (OUT == 2) {
            y = (double)x;
            if (!exact) {
                const int d = (int)(u & 0xFFu) + 29;
                const uint64_t m = (1ull << d) - 1ull;
                const uint64_t b = (uint64_t)__double_as_longlong(y);
                y = __longlong_as_double((long long)(
                    (b + (m >> 1) + ((b >> d) & 1ull)) & ~m));
            }
        } else if constexpr (WIDE) {
            y = exact ? x : __uint_as_float(value_round(__float_as_uint(x),
                                                        u));
        } else {
            y = __uint_as_float(value_round(__float_as_uint(x), u));
        }
        if constexpr (SCALED) y *= (O)s_out;
        return y;
    }

    // the word path of one float, times s_out but for NaN
    __device__ O word1(float x) const {
        O y;
        if constexpr (WIDE) {
            y = round_trip_wide<K, O>(x, n);
        } else {
            const uint32_t w = codec::encode_rare<K>(x, n);
            y = t8 ? __uint_as_float(dtab[w & 0xFFu])
                   : codec::decode_rare<K>(w, n);
        }
        if constexpr (SCALED) {
            if (y == y) y *= (O)s_out;
        }
        return y;
    }

    __device__ void value(const float x[4], const uint32_t u[4],
                          O y[4]) const {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = value1(x[j], u[j]);
    }

    // the word path of four floats
    __device__ void words(const float x[4], O y[4]) const {
        if constexpr (WIDE) {
#pragma unroll
            for (int j = 0; j < 4; ++j) y[j] = word1(x[j]);
        } else {
            round_trip4<K>(make_float4(x[0], x[1], x[2], x[3]), y, n, t8,
                           etab, dtab);
            if constexpr (SCALED) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (y[j] == y[j]) y[j] *= s_out;
            }
        }
    }

    // one float (the scalar tail and misaligned pointers)
    __device__ O one(float v) const {
        if constexpr (SCALED) v *= s_in;
        uint32_t u;
        const bool t8_lns = K == wire::LNS && t8;
        return !t8_lns && prep1(v, u) ? value1(v, u) : word1(v);
    }
};

template <int OUT>
__device__ __forceinline__ void store4(void* out, long long i,
                                       const OutT<OUT> y[4]) {
    if constexpr (OUT == 1)
        reinterpret_cast<uint2*>(out)[i] = make_uint2(
            f32_to_bf16_rne(y[0]) | ((uint32_t)f32_to_bf16_rne(y[1]) << 16),
            f32_to_bf16_rne(y[2]) | ((uint32_t)f32_to_bf16_rne(y[3]) << 16));
    else if constexpr (OUT == 2) {
        reinterpret_cast<double2*>(out)[2 * i] = make_double2(y[0], y[1]);
        reinterpret_cast<double2*>(out)[2 * i + 1] = make_double2(y[2], y[3]);
    } else {
        reinterpret_cast<float4*>(out)[i] = make_float4(y[0], y[1], y[2],
                                                        y[3]);
    }
}

// count floats: nvec vectors of 4, two a thread and iteration (both loads
// issued first), then the scalar rest. t8: the word path decodes through
// the 256 floats of n = 8 (the codec kernels' takum8 / lns-takum8 / posit8
// table decode; float32 and bfloat16 out). Only the narrow instantiations
// (n <= 32, float32 or bfloat16 out) hold and fill the word path's tables.
template <int K, bool SCALED, int OUT, bool WIDE>
__global__ void __launch_bounds__(256)
fake_quant_kernel(const float* __restrict__ x, void* __restrict__ out,
                  long long count, long long nvec, int n, int t8,
                  float s_in, float s_out) {
    constexpr bool VALUE = K != wire::LNS;
    constexpr bool VOTE = OUT == 1 && VALUE;
    using O = OutT<OUT>;
    __shared__ uint4 etab[WIDE ? 1 : codec::EncodeSize<K>::value];
    __shared__ uint32_t dtab[WIDE ? 1 : WordPath<K>::dsize];
    __shared__ uint32_t vtab[VALUE ? 256 : 1];
    const int tid = threadIdx.x, nt = blockDim.x;
    if constexpr (!WIDE) {
        codec::fill_encode<K>(etab, n, tid, nt);
        if (t8) codec::fill_decode<K, codec::TABLE8>(dtab, n, tid, nt);
        else codec::fill_decode<K, WordPath<K>::mode>(dtab, n, tid, nt);
    }
    if constexpr (VALUE)
        for (int i = tid; i < 256; i += nt) vtab[i] = value_entry<K>(i, n);
    __syncthreads();
    // linear takum keeps every float32 bit from n = 35 (p = n - 12 >= 23
    // whatever the header), posit from n = 59 (a normal float's regime and
    // exponent bits take at most 35)
    const bool exact = WIDE && VALUE
                       && n >= (K == wire::LINEAR ? 35 : 59);
    const Ctx<K, SCALED, OUT, WIDE> c{n, t8 != 0 && !WIDE, exact, s_in,
                                      s_out, codec::Width(n, 23).scale,
                                      etab, dtab, vtab};
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long gid = (long long)blockIdx.x * blockDim.x + tid;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = gid; i < nvec; i += 2 * stride) {
        const long long j = i + stride;
        const bool two = j < nvec;
        const float4 a = x4[i];
        float4 b;
        if (two) b = x4[j];
        float xa[4], xb[4];
        uint32_t ua[4], ub[4];
        O y[4];
        bool value = c.prep(a, xa, ua);
        if (two) value &= c.prep(b, xb, ub);
        if (VOTE ? __all_sync(__activemask(), value) : value) {
            c.value(xa, ua, y);
            store4<OUT>(out, i, y);
            if (two) {
                c.value(xb, ub, y);
                store4<OUT>(out, j, y);
            }
        } else {
            c.words(xa, y);
            store4<OUT>(out, i, y);
            if (two) {
                c.words(xb, y);
                store4<OUT>(out, j, y);
            }
        }
    }
    for (long long i = 4 * nvec + gid; i < count; i += stride) {
        const O y = c.one(x[i]);
        if constexpr (OUT == 1) ((uint16_t*)out)[i] = f32_to_bf16_rne(y);
        else ((O*)out)[i] = y;
    }
}

template <int K, bool SCALED, int OUT, bool WIDE>
int launch(int n, int t8, const float* x, void* out, long long count,
           float s_in, float s_out, cudaStream_t st) {
    const long long nvec = codec::aligned16(x, out) ? count / 4 : 0;
    constexpr auto kernel = fake_quant_kernel<K, SCALED, OUT, WIDE>;
    kernel<<<codec::codec_grid<kernel>(nvec ? (nvec + 1) / 2 : count), 256,
             0, st>>>(x, out, count, nvec, n, t8, s_in, s_out);
    return (int)cudaGetLastError();
}

template <int K, bool SCALED, int OUT>
int launch_n(int n, int t8, const float* x, void* out, long long count,
             float s_in, float s_out, cudaStream_t st) {
    return n > 32 ? launch<K, SCALED, OUT, true>(n, t8, x, out, count, s_in,
                                                 s_out, st)
                  : launch<K, SCALED, OUT, false>(n, t8, x, out, count,
                                                  s_in, s_out, st);
}

template <int K, bool SCALED>
int launch_out(int out_code, int n, int t8, const float* x, void* out,
               long long count, float s_in, float s_out, cudaStream_t st) {
    switch (out_code) {
        case 0: return launch_n<K, SCALED, 0>(n, t8, x, out, count, s_in,
                                              s_out, st);
        case 1: return launch_n<K, SCALED, 1>(n, t8, x, out, count, s_in,
                                              s_out, st);
        case 2: return launch<K, SCALED, 2, true>(n, t8, x, out, count,
                                                  s_in, s_out, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// n: 6 <= n <= 64; kind: the format code of wire.cuh (0 linear takum, 1
// logarithmic takum, 2 posit, 3 posit8 through the table: the posit
// kernel, its word path decoding through the 256 floats). scaled (linear
// takum only): apply s_in before the round and s_out after it. out_code:
// 0 float32, 1 bfloat16, 2 float64 (the word decoded to float64: no
// table). x and out hold `count` elements.
extern "C" int takum_fake_quant(int n, int kind, int scaled, const float* x,
                                void* out, long long count, int out_code,
                                float s_in, float s_out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
    if (n < 6 || n > 64 || (kind == wire::POSIT_LUT && n != 8)
        || (scaled && kind != wire::LINEAR))
        return (int)cudaErrorInvalidValue;
    const int t8 = n == 8 && (kind == wire::POSIT_LUT
                              || (kind != wire::POSIT
                                  && !WIRE_TAKUM8_COMPUTED));
    switch (kind) {
        case wire::LINEAR:
            return scaled ? launch_out<wire::LINEAR, true>(
                                out_code, n, t8, x, out, count, s_in, s_out,
                                st)
                          : launch_out<wire::LINEAR, false>(
                                out_code, n, t8, x, out, count, s_in, s_out,
                                st);
        case wire::LNS:
            return launch_out<wire::LNS, false>(out_code, n, t8, x, out,
                                                count, s_in, s_out, st);
        case wire::POSIT:
        case wire::POSIT_LUT:
            return launch_out<wire::POSIT, false>(out_code, n, t8, x, out,
                                                  count, s_in, s_out, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
