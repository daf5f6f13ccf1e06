// Wire-weight matmul: out[M, N] = x[M, K] (f32) @ decode(w[K, N] words).
//
// Replaces src/repro/kernels/takum_matmul.py::qmatmul_kernel_call
// (_qmm_ws_tile and its M-outer fallback _qmm_tile_moutermost).
//
// What bounds it on the H100: at decode batch sizes (M <= 16) the bytes of
// the weight words (K * N bytes at takum8, 3.35 TB/s); at prefill chunks
// (M = 256) the f32 FMAs (2 M K N operations at 67 TFLOP/s, no tensor
// cores: the reference is an f32 x f32 product with an f32 sum). The codec
// adds a few dozen integer operations per weight word on top of either.
//
// Design (simple first, as the first port of this kernel):
// * A block owns a (BM rows x BN columns) output tile and loops over its
//   range of K. Each (BK x BN) word tile is read once, decoded once into
//   shared memory as f32 (the decode-once rule of _qmm_ws_tile, held per
//   block), and feeds every row of the block: BM = 16 covers a whole
//   decode batch, so at decode each word is decoded exactly once.
// * f32 FMAs in registers, TM x TN outputs per thread; no TF32.
// * The grid is (N / BN, ceil(M / BM), split). When the (N, M) grid is too
//   small to fill 132 SMs, K is split across blocks; each split writes its
//   partial tile to a workspace and a second kernel sums the splits in a
//   fixed order, so the result does not depend on scheduling.
// The wrapper pads K and N with zero words to multiples of 64 (a zero word
// decodes to 0.0, so the padding is exact); M is guarded in the kernel.
#include <cuda_runtime.h>
#include "takum.cuh"

namespace {

template <int N, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qmm_kernel(const float* __restrict__ x, const takum::WordT<N>* __restrict__ w,
           float* __restrict__ out, int M, int K, int Ncols,
           int kt_per_split) {
    constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
    __shared__ float xs[BK][BM + 1];     // x tile, transposed
    __shared__ float ws[BK][BN];         // decoded weight tile
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int kt_total = K / BK;
    const int kt0 = blockIdx.z * kt_per_split;
    const int kt1 = min(kt0 + kt_per_split, kt_total);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int kt = kt0; kt < kt1; ++kt) {
        const int k0 = kt * BK;
        for (int i = tid; i < BK * BN; i += NT) {
            const int kr = i / BN, nc = i % BN;
            ws[kr][nc] = takum::decode<N>(w[(size_t)(k0 + kr) * Ncols + n0 + nc]);
        }
        for (int i = tid; i < BM * BK; i += NT) {
            const int mr = i / BK, kr = i % BK;
            const int m = m0 + mr;
            xs[kr][mr] = m < M ? x[(size_t)m * K + k0 + kr] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kr = 0; kr < BK; ++kr) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[kr][ty + i * TY];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = ws[kr][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    float* dst = out + (size_t)blockIdx.z * M * Ncols;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty + i * TY;
        if (m < M) {
#pragma unroll
            for (int j = 0; j < TN; ++j)
                dst[(size_t)m * Ncols + n0 + tx + j * TX] = acc[i][j];
        }
    }
}

// out[i] = sum over s of part[s][i], in the order s = 0, 1, ...
__global__ void split_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long long count,
                                 int split) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        float s = 0.0f;
        for (int k = 0; k < split; ++k) s += part[(size_t)k * count + i];
        out[i] = s;
    }
}

template <int N, int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const void* w, float* dst, int M, int K, int Ncols,
            int split, int kt_per_split, cudaStream_t st) {
    dim3 grid(Ncols / BN, (M + BM - 1) / BM, split);
    qmm_kernel<N, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, st>>>(
        x, (const takum::WordT<N>*)w, dst, M, K, Ncols, kt_per_split);
}

}  // namespace

// variant 0: BM = 16 (decode batches); variant 1: BM = 64 (prefill).
// K % 64 == 0 and Ncols % 64 == 0. With split > 1, `work` holds
// split * M * Ncols floats of partial sums.
extern "C" int takum_qmatmul(int n, int variant, const float* x,
                             const void* w, float* out, float* work, int M,
                             int K, int Ncols, int split, int kt_per_split,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M <= 0) return (int)cudaGetLastError();
    if ((n != 8 && n != 16) || K % 64 || Ncols % 64 || split < 1)
        return (int)cudaErrorInvalidValue;
    float* dst = split > 1 ? work : out;
    if (variant == 0) {
        if (n == 8) launch<8, 16, 64, 64, 1, 4>(x, w, dst, M, K, Ncols, split, kt_per_split, st);
        else launch<16, 16, 64, 64, 1, 4>(x, w, dst, M, K, Ncols, split, kt_per_split, st);
    } else {
        if (n == 8) launch<8, 64, 64, 16, 4, 4>(x, w, dst, M, K, Ncols, split, kt_per_split, st);
        else launch<16, 64, 64, 16, 4, 4>(x, w, dst, M, K, Ncols, split, kt_per_split, st);
    }
    if (split > 1) {
        const long long count = (long long)M * Ncols;
        long long blocks = (count + 255) / 256;
        if (blocks > 132 * 16) blocks = 132 * 16;
        split_sum_kernel<<<(int)blocks, 256, 0, st>>>(work, out, count, split);
    }
    return (int)cudaGetLastError();
}
