// Elementwise codec kernels: words -> float32 or float64 and float32 ->
// words, for linear takum, logarithmic takum (lns-takum) and posit (es =
// 2), at every width 6 <= n <= 64 (words in 8-, 16-, 32- or 64-bit
// storage).
//
// Replaces src/repro/kernels/takum_codec.py::decode_kernel_call
// (_decode_tile) and ::encode_kernel_call (_encode_tile), the Pallas
// passes over (256, 128) VMEM tiles; their tile bodies call the format's
// decode_tile/encode_tile: the linear takum, LNS takum or posit codec, and
// for posit8 the 256-entry table of registry.py::_posit8_lut_decode.
//
// What bounds them on the H100. Bytes: 1, 2 or 4 bytes of words (8-, 16-
// or 32-bit storage) plus 4 bytes of float per element over 3.35 TB/s,
// 0.137 / 0.164 / 0.219 ms at [5120, 17920]. The integer pipes issue
// about 64 operations an SM and clock (16 lanes a sub-partition), about
// 15 T/s over 132 SMs, so an element may cost about 22 (8-bit words) to
// 35 (32-bit) integer instructions before issue, not bytes, bounds the
// kernel. The first design (one element a thread and iteration, the
// barred-mantissa codec) spent 95-150 SASS instructions in its loops, one
// element an iteration, and ran at 1.7-3.8x the byte bound. This design
// cuts both sides:
// * Memory: vectors of 4 consecutive elements, one 16-byte float access
//   and one 4-, 8- or 16-byte word access each, so that a warp covers 512
//   contiguous bytes of floats an access; two vectors a thread and
//   iteration, both loads issued first, in a grid-stride loop over one
//   wave of resident blocks (the kernel's occupancy, read once); a scalar
//   tail takes the count's ragged end, and misaligned pointers (the
//   wrappers pass 16-byte aligned ones) take the scalar loop throughout.
// * Arithmetic (codec.cuh, takum.cuh, posit.cuh): magnitudes, with the
//   sign applied by two's complement; the encode reads the cut of the
//   float's exponent (or LNS characteristic) from a 4-8 KB block table
//   and rounds with one 64-bit add and two funnel shifts, the clamp to
//   [1, maxpos] being the saturation; the takum decode reads c and the
//   mantissa's shift for the 11 bits after the sign from a 2048-entry
//   block table (8 KB), the posit decode counts its regime with one
//   __clz, and takum8 / lns-takum8 / posit8 read the 256 decoded floats.
//   LNS keeps one logf (encode) or expf (decode) an element.
// Each block fills its tables for the launch's n before its loop (2048
// entries at most, against tens of thousands of elements a block at the
// main path's sizes). Widths and kinds share one kernel per (storage,
// kind, mode): n is a kernel argument.
// What bounds them now (an H100 80GB HBM3 at 700 W, [5120, 17920]): bytes
// for the table decodes, the takum, LNS and posit decodes to 28 bits and
// the linear takum and posit encodes, which run at 76-87% of the byte
// bound, as fast as the 256-float table decode, which does about 13
// instructions an element (tools/torch_kernel_times.py --codec-widths
// reads the card's plain float32 stream rates beside them); issue for
// the takum and posit decodes from n = 29 (the fraction's rounding into
// float32 in registers: 61-67%) and the LNS encode at 8 bits (its logf:
// 64%).
//
// 64-bit words (n = 33..64) and float64 output (every width) take the wide
// kernels (decode_wide_kernel, encode_wide_kernel): the same skeleton
// (vectors of 4, two a thread and iteration, one wave, scalar tail and
// loop), 64-bit lanes, and codec.cuh's wide element functions: linear and
// LNS takum decode c and r from the 2048-entry table of the 11 bits after
// the sign (the header window is 12 bits at every width: only the
// mantissa grows, to n - 5 bits), posit counts its regime with one
// __clzll, and the IEEE word is assembled with the plain version's two
// roundings where the fraction is wider than the significand; the encode
// shifts the header of the float's exponent (a table) and its fraction
// into place, rounding only where they do not fit. Bound by bytes: 8
// bytes of words and 4 or 8 bytes of float an element (12 or 16 bytes:
// 0.329 / 0.438 ms at [5120, 17920]); making them fast was not their
// first aim (PERF.md, section 6, has their times).
//
// In serving, the encode kernel writes the wire weights (WireMatrix.encode)
// and, for LNS weights, the activations entering every LNS matmul; the
// standalone decode is the op ops.takum_decode (its device function is
// inlined into the matmul and attention kernels instead). The LNS matmul
// decodes its own tiles to (ell, flags) parts with takum::lns_parts.
//
// The KV append (kv_append_kernel) writes the K/V words of every layer
// call: the reference encodes K and V (layers.py _encode_kv, the Pallas
// encode above) and scatters them into the cache, at (table[b, min(pos //
// ps, NP - 1)], pos % ps) for a paged pool (layers.py:259-269) or at
// [:, pos:pos + T] for a contiguous cache (dynamic_update_slice,
// layers.py:284-287). On the H100 that sequence is two encode launches and
// two index_put launches plus the index arithmetic between them, a dozen
// host dispatches to move a few KB in a decode step. Here one launch covers
// K and V of a layer: each thread takes 4 consecutive elements of one head
// row (one 16-byte load of f32, 8 bytes of bf16), encodes them with
// Codec<N, K>::encode (the register-only device functions, or the identity
// codec's cast for a bf16 or f32 cache, round to nearest even as torch's
// cast), computes the destination row itself from the device pos / table
// (nothing about pos reaches the host, so the step can be replayed from a
// CUDA graph), and stores the 4 words at once (4, 8 or 16 bytes). Bound by
// bytes: K and V read once, the words written once, plus pos and the
// table, over 3.35 TB/s (a decode step's 2 x 4 x 10 x 128 bf16 values:
// 0.006 us; a prefill chunk's 2 x 256 x 10 x 128: 0.5 us; launch latency
// dominates both).
#include <cuda_runtime.h>
#include "codec.cuh"

namespace {

// The codec kernels' vectors: 4 consecutive elements, one 16-byte float
// access and one 4-, 8- or 16-byte word access (S-bit storage), so that a
// warp's access covers 512 contiguous bytes of floats.
template <int S>
__device__ __forceinline__ void load_words(const wire::WordT<S>* p,
                                           uint32_t w[4]) {
    if constexpr (S == 8) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
        w[0] = v & 0xFFu; w[1] = (v >> 8) & 0xFFu;
        w[2] = (v >> 16) & 0xFFu; w[3] = v >> 24;
    } else if constexpr (S == 16) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x & 0xFFFFu; w[1] = v.x >> 16;
        w[2] = v.y & 0xFFFFu; w[3] = v.y >> 16;
    } else {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    }
}

template <int S>
__device__ __forceinline__ void store_words(wire::WordT<S>* p,
                                            const uint32_t w[4]) {
    if constexpr (S == 8)
        *reinterpret_cast<uint32_t*>(p) =
            w[0] | (w[1] << 8) | (w[2] << 16) | (w[3] << 24);
    else if constexpr (S == 16)
        *reinterpret_cast<uint2*>(p) =
            make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
    else
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// count words -> floats: nvec vectors of 4, two a thread and iteration
// (both loads issued first), then the scalar rest.
template <int S, int K, int M>
__global__ void __launch_bounds__(256)
decode_kernel(const wire::WordT<S>* __restrict__ words,
              float* __restrict__ out, long long count, long long nvec,
              int n) {
    __shared__ uint32_t tab[codec::DecodeSize<M>::value];
    codec::fill_decode<K, M>(tab, n, threadIdx.x, blockDim.x);
    __syncthreads();
    const codec::Width c(n, 23);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long i = gid; i < nvec; i += 2 * stride) {
        const long long j = i + stride;
        uint32_t a[4], b[4];
        float y[4];
        load_words<S>(words + 4 * i, a);
        if (j < nvec) load_words<S>(words + 4 * j, b);
        codec::decode4<K, M>(a, y, c, tab);
        out4[i] = make_float4(y[0], y[1], y[2], y[3]);
        if (j < nvec) {
            codec::decode4<K, M>(b, y, c, tab);
            out4[j] = make_float4(y[0], y[1], y[2], y[3]);
        }
    }
    for (long long i = 4 * nvec + gid; i < count; i += stride)
        out[i] = codec::decode1<K, M>(words[i], c, tab);
}

// count floats -> words: nvec vectors of 4, two a thread and iteration,
// then the scalar rest.
template <int S, int K>
__global__ void __launch_bounds__(256)
encode_kernel(const float* __restrict__ x, wire::WordT<S>* __restrict__ words,
              long long count, long long nvec, int n) {
    __shared__ uint4 tab[codec::EncodeSize<K>::value];
    codec::fill_encode<K>(tab, n, threadIdx.x, blockDim.x);
    __syncthreads();
    const codec::Width c(n, K == wire::LNS ? 22 : 23);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = gid; i < nvec; i += 2 * stride) {
        const long long j = i + stride;
        const float4 a = x4[i];
        float4 b;
        if (j < nvec) b = x4[j];
        uint32_t w[4];
        codec::encode4<K>(a, w, c, tab);
        store_words<S>(words + 4 * i, w);
        if (j < nvec) {
            codec::encode4<K>(b, w, c, tab);
            store_words<S>(words + 4 * j, w);
        }
    }
    for (long long i = 4 * nvec + gid; i < count; i += stride)
        words[i] = (wire::WordT<S>)codec::encode_rare<K>(x[i], n);
}

// Identity words of a float cache: f32 as it is, bf16 rounded to nearest
// even (NaN -> 0x7FC0), as torch's cast of the plain version.
template <int N, int K>
__device__ __forceinline__ uint32_t kv_word(float x) {
    if constexpr (K == wire::IDENTITY) {
        const uint32_t u = __float_as_uint(x);
        if constexpr (N == 32) return u;
        else return x != x ? 0x7FC0u : (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
    } else {
        return wire::Codec<N, K>::encode(x) & ((1u << N) - 1u);
    }
}

__device__ __forceinline__ void load4(const float* p, float x[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// bf16 values as their 16-bit patterns: exact widening to f32
__device__ __forceinline__ void load4(const uint16_t* p, float x[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16); x[1] = __uint_as_float(v.x & 0xFFFF0000u);
    x[2] = __uint_as_float(v.y << 16); x[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

template <int N>
__device__ __forceinline__ void store4(wire::WordT<N>* p, const uint32_t w[4]) {
    if constexpr (N == 8)
        *reinterpret_cast<uint32_t*>(p) =
            w[0] | (w[1] << 8) | (w[2] << 16) | (w[3] << 24);
    else if constexpr (N == 16)
        *reinterpret_cast<uint2*>(p) =
            make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
    else
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// k, v [B, T, Hkv, hd] (In: float or bf16 bits); quads = B * T * Hkv * hd
// / 4 per tensor, thread i < quads takes K's quad i, the rest V's. Paged
// (table != nullptr, T == 1): row b lands at page table[b, min(pos[b] / ps,
// npg - 1)], offset pos[b] % ps of a [P, ps, Hkv, hd] pool. Contiguous:
// position cpos + t of a [B, tmax, Hkv, hd] cache.
template <int N, int K, typename In>
__global__ void kv_append_kernel(const In* __restrict__ k,
                                 const In* __restrict__ v,
                                 wire::WordT<N>* __restrict__ kc,
                                 wire::WordT<N>* __restrict__ vc,
                                 const int* __restrict__ pos,
                                 const int* __restrict__ table, int t,
                                 int hkv, int hd, int ps, int npg, int cpos,
                                 int tmax, long long quads) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < 2 * quads; i += stride) {
        const bool is_v = i >= quads;
        const long long e = 4 * (is_v ? i - quads : i);
        const long long row = e / hd;                 // (b * T + t) * Hkv + h
        const int d = (int)(e - row * hd);
        const int h = (int)(row % hkv);
        const long long bt = row / hkv;
        long long dst;
        if (table != nullptr) {                       // T == 1: bt == b
            const int p = pos[bt];
            const int slot = min(p / ps, npg - 1);
            dst = (long long)table[bt * npg + slot] * ps + p % ps;
        } else {
            dst = (bt / t) * tmax + cpos + bt % t;
        }
        float x[4];
        load4((is_v ? v : k) + e, x);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = kv_word<N, K>(x[j]);
        store4<N>((is_v ? vc : kc) + (dst * hkv + h) * hd + d, w);
    }
}

// The wide kernels' vectors: 4 consecutive words of S-bit storage widened
// to 64-bit lanes, and 4 floats of type O (one 16-byte float32 access, two
// of float64).
template <int S>
__device__ __forceinline__ void load_wide(const wire::WordT<S>* p,
                                          uint64_t w[4]) {
    if constexpr (S == 64) {
        const uint4 a = reinterpret_cast<const uint4*>(p)[0];
        const uint4 b = reinterpret_cast<const uint4*>(p)[1];
        w[0] = ((uint64_t)a.y << 32) | a.x; w[1] = ((uint64_t)a.w << 32) | a.z;
        w[2] = ((uint64_t)b.y << 32) | b.x; w[3] = ((uint64_t)b.w << 32) | b.z;
    } else {
        uint32_t v[4];
        load_words<S>(p, v);
        for (int j = 0; j < 4; ++j) w[j] = v[j];
    }
}

__device__ __forceinline__ void store_wide(uint64_t* p, const uint64_t w[4]) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(
        (uint32_t)w[0], (uint32_t)(w[0] >> 32), (uint32_t)w[1],
        (uint32_t)(w[1] >> 32));
    reinterpret_cast<uint4*>(p)[1] = make_uint4(
        (uint32_t)w[2], (uint32_t)(w[2] >> 32), (uint32_t)w[3],
        (uint32_t)(w[3] >> 32));
}

__device__ __forceinline__ void store4_out(float* p, const float y[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void store4_out(double* p, const double y[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(y[0], y[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(y[2], y[3]);
}

// count words of S-bit storage -> O (float32 for 64-bit words, float64 at
// every storage): nvec vectors of 4, two a thread and iteration, then the
// scalar rest.
template <int S, int K, typename O>
__global__ void __launch_bounds__(256)
decode_wide_kernel(const wire::WordT<S>* __restrict__ words,
                   O* __restrict__ out, long long count, long long nvec,
                   int n) {
    __shared__ uint32_t tab[K == wire::POSIT ? 1 : 2048];
    if constexpr (K != wire::POSIT)
        codec::fill_decode_wide(tab, threadIdx.x, blockDim.x);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = gid; i < nvec; i += 2 * stride) {
        const long long j = i + stride;
        uint64_t a[4], b[4];
        O y[4];
        load_wide<S>(words + 4 * i, a);
        if (j < nvec) load_wide<S>(words + 4 * j, b);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            y[e] = codec::decode_wide1<K, O>(a[e], n, tab);
        store4_out(out + 4 * i, y);
        if (j < nvec) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                y[e] = codec::decode_wide1<K, O>(b[e], n, tab);
            store4_out(out + 4 * j, y);
        }
    }
    for (long long i = 4 * nvec + gid; i < count; i += stride)
        out[i] = codec::decode_wide1<K, O>((uint64_t)words[i], n, tab);
}

// count floats -> 64-bit words (n = 33..64), as encode_kernel.
template <int K>
__global__ void __launch_bounds__(256)
encode_wide_kernel(const float* __restrict__ x, uint64_t* __restrict__ words,
                   long long count, long long nvec, int n) {
    __shared__ uint4 tab[codec::EncodeSize<K>::value];
    codec::fill_encode_wide<K>(tab, n, threadIdx.x, blockDim.x);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = gid; i < nvec; i += 2 * stride) {
        const long long j = i + stride;
        const float4 a = x4[i];
        float4 b;
        if (j < nvec) b = x4[j];
        uint64_t w[4];
        w[0] = codec::encode_wide1<K>(a.x, n, tab);
        w[1] = codec::encode_wide1<K>(a.y, n, tab);
        w[2] = codec::encode_wide1<K>(a.z, n, tab);
        w[3] = codec::encode_wide1<K>(a.w, n, tab);
        store_wide(words + 4 * i, w);
        if (j < nvec) {
            w[0] = codec::encode_wide1<K>(b.x, n, tab);
            w[1] = codec::encode_wide1<K>(b.y, n, tab);
            w[2] = codec::encode_wide1<K>(b.z, n, tab);
            w[3] = codec::encode_wide1<K>(b.w, n, tab);
            store_wide(words + 4 * j, w);
        }
    }
    for (long long i = 4 * nvec + gid; i < count; i += stride)
        words[i] = codec::encode_wide1<K>(x[i], n, tab);
}

int grid_for(long long count) {
    long long blocks = (count + 255) / 256;
    const long long cap = 132 * 16;   // a few waves over the SMs
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1 : (int)blocks;
}

template <int S, int K, int M>
int launch_decode(int n, const void* words, float* out, long long count,
                  cudaStream_t st) {
    const long long nvec = codec::aligned16(words, out) ? count / 4 : 0;
    constexpr auto kernel = decode_kernel<S, K, M>;
    kernel<<<codec::codec_grid<kernel>(nvec ? (nvec + 1) / 2 : count), 256, 0,
             st>>>((const wire::WordT<S>*)words, out, count, nvec, n);
    return (int)cudaGetLastError();
}

template <int S, int K>
int launch_encode(int n, const float* x, void* words, long long count,
                  cudaStream_t st) {
    const long long nvec = codec::aligned16(x, words) ? count / 4 : 0;
    constexpr auto kernel = encode_kernel<S, K>;
    kernel<<<codec::codec_grid<kernel>(nvec ? (nvec + 1) / 2 : count), 256, 0,
             st>>>(x, (wire::WordT<S>*)words, count, nvec, n);
    return (int)cudaGetLastError();
}

// The decode of (storage S, kind) at width n: the 256-float table for the
// 8-bit formats that have one (takum_decode), the header table for linear
// takum to 28 bits and LNS takum, the registers for posit and for linear
// takum from 29 bits (32-bit storage only).
template <int S>
int decode_storage(int n, int kind, const void* words, float* out,
                   long long count, cudaStream_t st) {
    using namespace wire;
    if constexpr (S == 32)
        if (kind == LINEAR && n > 28)
            return launch_decode<S, LINEAR, codec::REGISTERS>(n, words, out,
                                                               count, st);
    if (kind == LINEAR)
        return launch_decode<S, LINEAR, codec::HEADER>(n, words, out, count,
                                                        st);
    if (kind == LNS)
        return launch_decode<S, LNS, codec::HEADER>(n, words, out, count, st);
    if (kind == POSIT)
        return launch_decode<S, POSIT, codec::REGISTERS>(n, words, out,
                                                         count, st);
    return (int)cudaErrorInvalidValue;
}

template <int S, int K, typename O>
int launch_decode_wide(int n, const void* words, void* out, long long count,
                       cudaStream_t st) {
    const long long nvec = codec::aligned16(words, out) ? count / 4 : 0;
    constexpr auto kernel = decode_wide_kernel<S, K, O>;
    kernel<<<codec::codec_grid<kernel>(nvec ? (nvec + 1) / 2 : count), 256, 0,
             st>>>((const wire::WordT<S>*)words, (O*)out, count, nvec, n);
    return (int)cudaGetLastError();
}

// The wide decode of (storage S, kind) to O.
template <int S, typename O>
int decode_wide_storage(int n, int kind, const void* words, void* out,
                        long long count, cudaStream_t st) {
    using namespace wire;
    if (kind == LINEAR)
        return launch_decode_wide<S, LINEAR, O>(n, words, out, count, st);
    if (kind == LNS)
        return launch_decode_wide<S, LNS, O>(n, words, out, count, st);
    if (kind == POSIT)
        return launch_decode_wide<S, POSIT, O>(n, words, out, count, st);
    return (int)cudaErrorInvalidValue;
}

template <int K>
int launch_encode_wide(int n, const float* x, void* words, long long count,
                       cudaStream_t st) {
    const long long nvec = codec::aligned16(x, words) ? count / 4 : 0;
    constexpr auto kernel = encode_wide_kernel<K>;
    kernel<<<codec::codec_grid<kernel>(nvec ? (nvec + 1) / 2 : count), 256, 0,
             st>>>(x, (uint64_t*)words, count, nvec, n);
    return (int)cudaGetLastError();
}

template <int S>
int encode_storage(int n, int kind, const float* x, void* words,
                   long long count, cudaStream_t st) {
    using namespace wire;
    if constexpr (S == 64) {
        if (kind == LINEAR) return launch_encode_wide<LINEAR>(n, x, words,
                                                              count, st);
        if (kind == LNS) return launch_encode_wide<LNS>(n, x, words, count,
                                                        st);
        if (kind == POSIT) return launch_encode_wide<POSIT>(n, x, words,
                                                            count, st);
    } else {
        if (kind == LINEAR) return launch_encode<S, LINEAR>(n, x, words,
                                                            count, st);
        if (kind == LNS) return launch_encode<S, LNS>(n, x, words, count,
                                                      st);
        if (kind == POSIT) return launch_encode<S, POSIT>(n, x, words,
                                                          count, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// kind: the format code of wire.cuh (0 linear takum, 1 logarithmic takum,
// 2 posit, 3 posit8 through the table); n: 6 <= n <= 64, words in
// 8-, 16-, 32- or 64-bit storage; f64: out is float64 (the wide kernels,
// posit8's table code excluded: its table holds float32s), else float32.
extern "C" int takum_decode(int n, int kind, int f64, const void* words,
                            void* out, long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
    if (n < 6 || n > 64 || (kind == wire::POSIT_LUT && (n != 8 || f64)))
        return (int)cudaErrorInvalidValue;
    if (f64) {
        switch (wire::storage_bits(n)) {
            case 8: return decode_wide_storage<8, double>(n, kind, words, out,
                                                          count, st);
            case 16: return decode_wide_storage<16, double>(n, kind, words,
                                                            out, count, st);
            case 32: return decode_wide_storage<32, double>(n, kind, words,
                                                            out, count, st);
            default: return decode_wide_storage<64, double>(n, kind, words,
                                                            out, count, st);
        }
    }
    if (n > 32)
        return decode_wide_storage<64, float>(n, kind, words, out, count, st);
    if (n == 8) {
        const bool t8 = !WIRE_TAKUM8_COMPUTED;
        if (kind == wire::POSIT_LUT)
            return launch_decode<8, wire::POSIT_LUT, codec::TABLE8>(
                n, words, (float*)out, count, st);
        if (t8 && kind == wire::LINEAR)
            return launch_decode<8, wire::LINEAR, codec::TABLE8>(
                n, words, (float*)out, count, st);
        if (t8 && kind == wire::LNS)
            return launch_decode<8, wire::LNS, codec::TABLE8>(
                n, words, (float*)out, count, st);
    }
    switch (wire::storage_bits(n)) {
        case 8: return decode_storage<8>(n, kind, words, (float*)out, count,
                                         st);
        case 16: return decode_storage<16>(n, kind, words, (float*)out, count,
                                           st);
        default: return decode_storage<32>(n, kind, words, (float*)out, count,
                                           st);
    }
}

extern "C" int takum_encode(int n, int kind, const float* x, void* words,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
    if (n < 6 || n > 64) return (int)cudaErrorInvalidValue;
    if (kind == wire::POSIT_LUT) kind = wire::POSIT;   // a decode path only
    switch (wire::storage_bits(n)) {
        case 8: return encode_storage<8>(n, kind, x, words, count, st);
        case 16: return encode_storage<16>(n, kind, x, words, count, st);
        case 32: return encode_storage<32>(n, kind, x, words, count, st);
        default: return encode_storage<64>(n, kind, x, words, count, st);
    }
}

// The fused K/V append of one layer (see the header). n: word bits (8 or
// 16; 16 or 32 for the identity codec's bf16 or f32 cache); kind: the
// format code (the posit8 table code encodes as posit); in_bf16: k and v
// are bf16 (else f32). table == nullptr selects the contiguous mode.
extern "C" int takum_kv_append(int n, int kind, int in_bf16, const void* k,
                               const void* v, void* kc, void* vc,
                               const int* pos, const int* table, int b,
                               int t, int hkv, int hd, int ps, int npg,
                               int cpos, int tmax, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long quads = (long long)b * t * hkv * hd / 4;
    if (quads <= 0) return (int)cudaGetLastError();
    if (kind == wire::POSIT_LUT) kind = wire::POSIT;   // a decode path only
#define LAUNCH(NN, KK, IN)                                                  \
    kv_append_kernel<NN, KK, IN><<<grid_for(2 * quads), 256, 0, st>>>(      \
        (const IN*)k, (const IN*)v, (wire::WordT<NN>*)kc,                   \
        (wire::WordT<NN>*)vc, pos, table, t, hkv, hd, ps, npg, cpos, tmax,  \
        quads)
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK) {                                            \
        if (in_bf16) LAUNCH(NN, KK, uint16_t);                              \
        else LAUNCH(NN, KK, float);                                         \
        return (int)cudaGetLastError();                                     \
    }
    WIRE_ENCODE_FORMATS(CASE)
    CASE(16, 4) CASE(32, 4)
#undef CASE
#undef LAUNCH
    return (int)cudaErrorInvalidValue;
}
