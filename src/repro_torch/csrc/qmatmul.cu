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
// Design: the tiled skeleton of tiled_matmul.cuh with the operand policy
// WireOp: x enters shared memory as it is, each weight word is decoded
// once to f32 (takum::decode), and a product is one f32 FMA (no TF32).
// Variant 0 holds BM = 16 rows, a whole decode batch, so at decode each
// weight word is decoded exactly once; variant 1 holds 64 rows (prefill).
#include <cuda_runtime.h>
#include "takum.cuh"
#include "tiled_matmul.cuh"

namespace {

template <int N>
struct WireOp {
    using X = float;
    using W = takum::WordT<N>;
    using S = float;
    static constexpr float PAD = 0.0f;
    __device__ static float load_x(float v) { return v; }
    __device__ static float load_w(W v) { return takum::decode<N>(v); }
    __device__ static void mac(float& acc, float a, float b) {
        acc = fmaf(a, b, acc);
    }
};

template <int N>
int launch_n(int variant, const float* x, const void* w, float* out,
             float* work, int M, int K, int Ncols, int split,
             int kt_per_split, cudaStream_t st) {
    if (variant == 0)
        return tiled::launch<WireOp<N>, 16, 64, 64, 1, 4>(
            x, w, out, work, M, K, Ncols, split, kt_per_split, st);
    return tiled::launch<WireOp<N>, 64, 64, 16, 4, 4>(
        x, w, out, work, M, K, Ncols, split, kt_per_split, st);
}

}  // namespace

// variant 0: BM = 16 (decode batches); variant 1: BM = 64 (prefill).
// K is split into `split` ranges of kt_per_split tiles (64 deep at variant
// 0, 16 at variant 1); with split > 1, `work` holds split * M * Ncols
// floats of partial sums.
extern "C" int takum_qmatmul(int n, int variant, const float* x,
                             const void* w, float* out, float* work, int M,
                             int K, int Ncols, int split, int kt_per_split,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M <= 0 || Ncols <= 0) return (int)cudaGetLastError();
    if ((n != 8 && n != 16) || (variant != 0 && variant != 1) || K < 0
        || split < 1 || kt_per_split < 1)
        return (int)cudaErrorInvalidValue;
    return n == 8
        ? launch_n<8>(variant, x, w, out, work, M, K, Ncols, split,
                      kt_per_split, st)
        : launch_n<16>(variant, x, w, out, work, M, K, Ncols, split,
                       kt_per_split, st);
}
