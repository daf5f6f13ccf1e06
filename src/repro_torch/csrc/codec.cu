// Elementwise takum codec kernels: words -> float32 and float32 -> words.
//
// Replaces src/repro/kernels/takum_codec.py::decode_kernel_call
// (_decode_tile) and ::encode_kernel_call (_encode_tile), the Pallas
// passes over (256, 128) VMEM tiles. On the H100 both are bound by
// bytes: 1 (takum8) or 2 (takum16) bytes of words plus 4 bytes of float
// per element over 3.35 TB/s, against a few dozen integer operations per
// element. The design is a grid-stride loop of one element per thread and
// iteration, so neighbouring threads touch neighbouring addresses and the
// loads and stores coalesce; the arithmetic is the device functions of
// takum.cuh, shared with the matmul and attention kernels.
//
// In serving, the encode kernel writes the KV-cache words of every step
// and the wire weights (WireMatrix.encode); the standalone decode is the
// op ops.takum_decode (its device function is inlined into the matmul and
// attention kernels instead).
#include <cuda_runtime.h>
#include "takum.cuh"

namespace {

template <int N>
__global__ void decode_kernel(const takum::WordT<N>* __restrict__ words,
                              float* __restrict__ out, long long count) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride)
        out[i] = takum::decode<N>(words[i]);
}

template <int N>
__global__ void encode_kernel(const float* __restrict__ x,
                              takum::WordT<N>* __restrict__ words,
                              long long count) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride)
        words[i] = (takum::WordT<N>)takum::encode<N>(x[i]);
}

int grid_for(long long count) {
    long long blocks = (count + 255) / 256;
    const long long cap = 132 * 16;   // a few waves over the SMs
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" int takum_decode(int n, const void* words, float* out,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count > 0) {
        if (n == 8)
            decode_kernel<8><<<grid_for(count), 256, 0, st>>>(
                (const uint8_t*)words, out, count);
        else if (n == 16)
            decode_kernel<16><<<grid_for(count), 256, 0, st>>>(
                (const uint16_t*)words, out, count);
        else
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int takum_encode(int n, const float* x, void* words,
                            long long count, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count > 0) {
        if (n == 8)
            encode_kernel<8><<<grid_for(count), 256, 0, st>>>(
                x, (uint8_t*)words, count);
        else if (n == 16)
            encode_kernel<16><<<grid_for(count), 256, 0, st>>>(
                x, (uint16_t*)words, count);
        else
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
