// Elementwise codec kernels: words -> float32 and float32 -> words, for
// linear takum, logarithmic takum (lns-takum) and posit (es = 2), at every
// width 6 <= n <= 32 (words in 8-, 16- or 32-bit storage).
//
// Replaces src/repro/kernels/takum_codec.py::decode_kernel_call
// (_decode_tile) and ::encode_kernel_call (_encode_tile), the Pallas
// passes over (256, 128) VMEM tiles; their tile bodies call the format's
// decode_tile/encode_tile: the linear takum, LNS takum or posit codec, and
// for posit8 the 256-entry table of registry.py::_posit8_lut_decode. On the
// H100 all of them are bound by bytes: 1, 2 or 4 bytes of words (8-, 16-
// or 32-bit storage) plus 4 bytes of float per element over 3.35 TB/s,
// against a few dozen integer operations per element (plus one expf or
// logf for LNS). Widths 8 and 16 are compiled for their N (Codec<N, K>,
// as the served kernels); the others take n as a kernel argument
// (wire::AnyWidth<K>, one instantiation per storage width and kind).
// The design is a grid-stride loop of one element per thread and
// iteration, so neighbouring threads touch neighbouring addresses and the
// loads and stores coalesce; the arithmetic is the device functions of
// takum.cuh and posit.cuh through wire.cuh's Codec<N, K>, shared with the
// matmul, attention and fake-quant kernels. With the posit8 table
// (K = POSIT_LUT) each block first builds its 256 entries in shared memory
// (one computed decode per thread), then reads one entry per word.
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
// Codec<N, K>::encode (or the identity codec's cast for a bf16 or f32
// cache, round to nearest even as torch's cast), computes the destination
// row itself from the device pos / table (nothing about pos reaches the
// host, so the step can be replayed from a CUDA graph), and stores the 4
// words at once (4, 8 or 16 bytes). Bound by bytes: K and V read once, the
// words written once, plus pos and the table, over 3.35 TB/s (a decode
// step's 2 x 4 x 10 x 128 bf16 values: 0.006 us; a prefill chunk's 2 x 256
// x 10 x 128: 0.5 us; launch latency dominates both).
#include <cuda_runtime.h>
#include "wire.cuh"

namespace {

template <int N, int K>
__global__ void decode_kernel(const takum::WordT<N>* __restrict__ words,
                              float* __restrict__ out, long long count) {
    using C = wire::Codec<N, K>;
    __shared__ typename C::Tab tab;
    tab.fill(threadIdx.x, blockDim.x);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride)
        out[i] = C::decode(words[i], tab);
}

template <int N, int K>
__global__ void encode_kernel(const float* __restrict__ x,
                              takum::WordT<N>* __restrict__ words,
                              long long count) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride)
        words[i] = (takum::WordT<N>)wire::Codec<N, K>::encode(x[i]);
}

// The other widths (6 <= n <= 32 but for 8 and 16): n at run time, words
// in S-bit storage (wire::AnyWidth). The same grid-stride design.
template <int S, int K>
__global__ void decode_any_kernel(const wire::WordT<S>* __restrict__ words,
                                  float* __restrict__ out, long long count,
                                  int n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride)
        out[i] = wire::AnyWidth<K>::decode(words[i], n);
}

template <int S, int K>
__global__ void encode_any_kernel(const float* __restrict__ x,
                                  wire::WordT<S>* __restrict__ words,
                                  long long count, int n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride)
        words[i] = (wire::WordT<S>)wire::AnyWidth<K>::encode(x[i], n);
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

int grid_for(long long count) {
    long long blocks = (count + 255) / 256;
    const long long cap = 132 * 16;   // a few waves over the SMs
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// kind: the format code of wire.cuh (0 linear takum, 1 logarithmic takum,
// 2 posit, 3 posit8 through the table); n: 6 <= n <= 32 (8 and 16 through
// Codec<N, K>, the others through AnyWidth<K> in their storage).
extern "C" int takum_decode(int n, int kind, const void* words, float* out,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK                                               \
        && (!CODEC_ANY_WIDTH || KK == wire::POSIT_LUT)) {                   \
        decode_kernel<NN, KK><<<grid_for(count), 256, 0, st>>>(             \
            (const takum::WordT<NN>*)words, out, count);                    \
        return (int)cudaGetLastError();                                     \
    }
    WIRE_DECODE_FORMATS(CASE)
#undef CASE
    if (n < 6 || n > 32) return (int)cudaErrorInvalidValue;
#define CASE(SS, KK)                                                        \
    if (wire::storage_bits(n) == SS && kind == KK) {                        \
        decode_any_kernel<SS, KK><<<grid_for(count), 256, 0, st>>>(         \
            (const wire::WordT<SS>*)words, out, count, n);                  \
        return (int)cudaGetLastError();                                     \
    }
    WIRE_ANY_WIDTH_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" int takum_encode(int n, int kind, const float* x, void* words,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
    if (kind == wire::POSIT_LUT) kind = wire::POSIT;   // a decode path only
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK && !CODEC_ANY_WIDTH) {                        \
        encode_kernel<NN, KK><<<grid_for(count), 256, 0, st>>>(             \
            x, (takum::WordT<NN>*)words, count);                            \
        return (int)cudaGetLastError();                                     \
    }
    WIRE_ENCODE_FORMATS(CASE)
#undef CASE
    if (n < 6 || n > 32) return (int)cudaErrorInvalidValue;
#define CASE(SS, KK)                                                        \
    if (wire::storage_bits(n) == SS && kind == KK) {                        \
        encode_any_kernel<SS, KK><<<grid_for(count), 256, 0, st>>>(         \
            x, (wire::WordT<SS>*)words, count, n);                          \
        return (int)cudaGetLastError();                                     \
    }
    WIRE_ANY_WIDTH_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
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
