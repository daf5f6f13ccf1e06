// Elementwise takum codec kernels: words -> float32 and float32 -> words,
// for linear takum and logarithmic takum (lns-takum).
//
// Replaces src/repro/kernels/takum_codec.py::decode_kernel_call
// (_decode_tile) and ::encode_kernel_call (_encode_tile), the Pallas
// passes over (256, 128) VMEM tiles; their tile bodies call the format's
// decode_tile/encode_tile, which is the linear or the LNS codec. On the
// H100 all of them are bound by bytes: 1 (8-bit) or 2 (16-bit) bytes of
// words plus 4 bytes of float per element over 3.35 TB/s, against a few
// dozen integer operations per element (plus one expf or logf for LNS).
// The design is a grid-stride loop of one element per thread and
// iteration, so neighbouring threads touch neighbouring addresses and the
// loads and stores coalesce; the arithmetic is the device functions of
// takum.cuh, shared with the matmul and attention kernels.
//
// In serving, the encode kernel writes the KV-cache words of every step,
// the wire weights (WireMatrix.encode) and, for LNS weights, the
// activations entering every LNS matmul; the standalone decode is the op
// ops.takum_decode (its device function is inlined into the matmul and
// attention kernels instead). The LNS matmul decodes its own tiles to
// (ell, flags) parts with takum::lns_parts.
#include <cuda_runtime.h>
#include "takum.cuh"

namespace {

template <int N, bool LNS>
__global__ void decode_kernel(const takum::WordT<N>* __restrict__ words,
                              float* __restrict__ out, long long count) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        if constexpr (LNS) out[i] = takum::lns_decode<N>(words[i]);
        else out[i] = takum::decode<N>(words[i]);
    }
}

template <int N, bool LNS>
__global__ void encode_kernel(const float* __restrict__ x,
                              takum::WordT<N>* __restrict__ words,
                              long long count) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        if constexpr (LNS)
            words[i] = (takum::WordT<N>)takum::lns_encode<N>(x[i]);
        else
            words[i] = (takum::WordT<N>)takum::encode<N>(x[i]);
    }
}

int grid_for(long long count) {
    long long blocks = (count + 255) / 256;
    const long long cap = 132 * 16;   // a few waves over the SMs
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1 : (int)blocks;
}

template <bool LNS>
int decode_n(int n, const void* words, float* out, long long count,
             cudaStream_t st) {
    if (n == 8)
        decode_kernel<8, LNS><<<grid_for(count), 256, 0, st>>>(
            (const uint8_t*)words, out, count);
    else if (n == 16)
        decode_kernel<16, LNS><<<grid_for(count), 256, 0, st>>>(
            (const uint16_t*)words, out, count);
    else
        return (int)cudaErrorInvalidValue;
    return 0;
}

template <bool LNS>
int encode_n(int n, const float* x, void* words, long long count,
             cudaStream_t st) {
    if (n == 8)
        encode_kernel<8, LNS><<<grid_for(count), 256, 0, st>>>(
            x, (uint8_t*)words, count);
    else if (n == 16)
        encode_kernel<16, LNS><<<grid_for(count), 256, 0, st>>>(
            x, (uint16_t*)words, count);
    else
        return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace

// lns = 0: linear takum words; lns = 1: logarithmic takum words.
extern "C" int takum_decode(int n, int lns, const void* words, float* out,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count > 0) {
        const int err = lns ? decode_n<true>(n, words, out, count, st)
                            : decode_n<false>(n, words, out, count, st);
        if (err) return err;
    }
    return (int)cudaGetLastError();
}

extern "C" int takum_encode(int n, int lns, const float* x, void* words,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count > 0) {
        const int err = lns ? encode_n<true>(n, x, words, count, st)
                            : encode_n<false>(n, x, words, count, st);
        if (err) return err;
    }
    return (int)cudaGetLastError();
}
