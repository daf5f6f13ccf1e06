// Fused fake-quantisation: out = decode(encode(x)) in one pass, float32 in,
// float32 or bfloat16 out.
//
// Replaces src/repro/kernels/quantize.py::fake_quant_kernel_call
// (_fake_quant_tile): the round trip through a wire format's grid over
// (256, 128) VMEM tiles without the word tensor ever reaching HBM. Here,
// for linear takum, logarithmic takum and posit (posit8 computed or through
// its 256-entry shared-memory table), at every width 6 <= n <= 32, through
// the register-only device functions of takum.cuh and posit.cuh, which
// the codec kernels (codec.cu) share for their rare elements
// (wire::Codec<N, K> at 8 and 16 bits, wire::AnyWidth<K> with n at run
// time otherwise).
//
// What bounds it on the H100: bytes. One float32 read and one float32 (or
// bfloat16) write per element, 8 (or 6) bytes over 3.35 TB/s, against a
// few dozen integer operations per element; the logarithmic round trip adds
// one logf and one expf, far below the SFU's rate.
//
// Design: a grid-stride loop of one element per thread and iteration
// (coalesced loads and stores); the word stays in a register between the
// encode and the decode. With `scaled`, x is multiplied by s_in = 2^k
// before the encode and the decoded value by s_out = 2^-k after it (exact
// powers of two: core/quant.py's per-tensor centring, the serving
// fake-quant policy of linear takum); a NaN result is left as it is, so
// its bits stay 0x7FC00000. The bfloat16 output is the float32 value
// rounded to nearest even, as PyTorch's .to(bfloat16); a NaN becomes the
// quiet NaN 0x7FC0 (PyTorch's NaN bits differ between its CPU and CUDA
// casts, so NaNs are compared by place).
#include <cuda_runtime.h>
#include "wire.cuh"

namespace {

__device__ __forceinline__ uint16_t f32_to_bf16_rne(float f) {
    if (f != f) return 0x7FC0u;
    const uint32_t b = __float_as_uint(f);
    return (uint16_t)((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16);
}

template <int N, int K, bool SCALED, bool BF16>
__global__ void fake_quant_kernel(const float* __restrict__ x,
                                  void* __restrict__ out, long long count,
                                  float s_in, float s_out) {
    using C = wire::Codec<N, K>;
    __shared__ typename C::Tab tab;
    tab.fill(threadIdx.x, blockDim.x);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        float v = x[i];
        if constexpr (SCALED) v *= s_in;
        float y = C::decode(C::encode(v), tab);
        if constexpr (SCALED) {
            if (y == y) y *= s_out;
        }
        if constexpr (BF16) ((uint16_t*)out)[i] = f32_to_bf16_rne(y);
        else ((float*)out)[i] = y;
    }
}

// The other widths: n at run time through wire::AnyWidth<K>.
template <int K, bool SCALED, bool BF16>
__global__ void fake_quant_any_kernel(const float* __restrict__ x,
                                      void* __restrict__ out,
                                      long long count, int n, float s_in,
                                      float s_out) {
    using C = wire::AnyWidth<K>;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        float v = x[i];
        if constexpr (SCALED) v *= s_in;
        float y = C::decode(C::encode(v, n), n);
        if constexpr (SCALED) {
            if (y == y) y *= s_out;
        }
        if constexpr (BF16) ((uint16_t*)out)[i] = f32_to_bf16_rne(y);
        else ((float*)out)[i] = y;
    }
}

// N > 0: the compiled width; N == 0: the width n at run time.
template <int N, int K>
int launch(int scaled, const float* x, void* out, long long count, int bf16,
           float s_in, float s_out, cudaStream_t st, int n = N) {
    long long blocks = (count + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;   // a few waves over the SMs
    const int grid = blocks < 1 ? 1 : (int)blocks;
#define GO(S, B)                                                            \
    if constexpr (N == 0)                                                   \
        fake_quant_any_kernel<K, S, B><<<grid, 256, 0, st>>>(               \
            x, out, count, n, s_in, s_out);                                 \
    else                                                                    \
        fake_quant_kernel<N, K, S, B><<<grid, 256, 0, st>>>(x, out, count,  \
                                                            s_in, s_out)
    if (scaled) {
        if (bf16) GO(true, true); else GO(true, false);
    } else {
        if (bf16) GO(false, true); else GO(false, false);
    }
#undef GO
    return (int)cudaGetLastError();
}

}  // namespace

// n: 6 <= n <= 32 (8 and 16 compiled for their N, the others at run time
// through wire::AnyWidth); kind: the format code of wire.cuh (0 linear
// takum, 1 logarithmic takum, 2 posit, 3 posit8 through the table). scaled: apply
// s_in before the encode and s_out after the decode. bf16: write bfloat16
// (else float32). x and out hold `count` elements.
extern "C" int takum_fake_quant(int n, int kind, int scaled, const float* x,
                                void* out, long long count, int bf16,
                                float s_in, float s_out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (count <= 0) return (int)cudaGetLastError();
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK                                               \
        && (!CODEC_ANY_WIDTH || KK == wire::POSIT_LUT))                     \
        return launch<NN, KK>(scaled, x, out, count, bf16, s_in, s_out, st);
    WIRE_DECODE_FORMATS(CASE)
#undef CASE
    if (n < 6 || n > 32) return (int)cudaErrorInvalidValue;
    if (kind == wire::LINEAR)
        return launch<0, wire::LINEAR>(scaled, x, out, count, bf16, s_in,
                                       s_out, st, n);
    if (kind == wire::LNS)
        return launch<0, wire::LNS>(scaled, x, out, count, bf16, s_in, s_out,
                                    st, n);
    if (kind == wire::POSIT)
        return launch<0, wire::POSIT>(scaled, x, out, count, bf16, s_in,
                                      s_out, st, n);
    return (int)cudaErrorInvalidValue;
}
