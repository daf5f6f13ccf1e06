// Elementwise codec kernels: words -> float32 and float32 -> words, for
// linear takum, logarithmic takum (lns-takum) and posit (es = 2).
//
// Replaces src/repro/kernels/takum_codec.py::decode_kernel_call
// (_decode_tile) and ::encode_kernel_call (_encode_tile), the Pallas
// passes over (256, 128) VMEM tiles; their tile bodies call the format's
// decode_tile/encode_tile: the linear takum, LNS takum or posit codec, and
// for posit8 the 256-entry table of registry.py::_posit8_lut_decode. On the
// H100 all of them are bound by bytes: 1 (8-bit) or 2 (16-bit) bytes of
// words plus 4 bytes of float per element over 3.35 TB/s, against a few
// dozen integer operations per element (plus one expf or logf for LNS).
// The design is a grid-stride loop of one element per thread and
// iteration, so neighbouring threads touch neighbouring addresses and the
// loads and stores coalesce; the arithmetic is the device functions of
// takum.cuh and posit.cuh through wire.cuh's Codec<N, K>, shared with the
// matmul, attention and fake-quant kernels. With the posit8 table
// (K = POSIT_LUT) each block first builds its 256 entries in shared memory
// (one computed decode per thread), then reads one entry per word.
//
// In serving, the encode kernel writes the KV-cache words of every step,
// the wire weights (WireMatrix.encode) and, for LNS weights, the
// activations entering every LNS matmul; the standalone decode is the op
// ops.takum_decode (its device function is inlined into the matmul and
// attention kernels instead). The LNS matmul decodes its own tiles to
// (ell, flags) parts with takum::lns_parts.
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

int grid_for(long long count) {
    long long blocks = (count + 255) / 256;
    const long long cap = 132 * 16;   // a few waves over the SMs
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// kind: the format code of wire.cuh (0 linear takum, 1 logarithmic takum,
// 2 posit, 3 posit8 through the table); n: 8 or 16.
extern "C" int takum_decode(int n, int kind, const void* words, float* out,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK) {                                            \
        decode_kernel<NN, KK><<<grid_for(count), 256, 0, st>>>(             \
            (const takum::WordT<NN>*)words, out, count);                    \
        return (int)cudaGetLastError();                                     \
    }
    WIRE_DECODE_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" int takum_encode(int n, int kind, const float* x, void* words,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
    if (kind == wire::POSIT_LUT) kind = wire::POSIT;   // a decode path only
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK) {                                            \
        encode_kernel<NN, KK><<<grid_for(count), 256, 0, st>>>(             \
            x, (takum::WordT<NN>*)words, count);                            \
        return (int)cudaGetLastError();                                     \
    }
    WIRE_ENCODE_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}
