// Wire-weight matmul: out[M, N] = x[M, K] (f32) @ decode(w[K, N] words).
//
// Replaces src/repro/kernels/takum_matmul.py::qmatmul_kernel_call
// (_qmm_ws_tile and its M-outer fallback _qmm_tile_moutermost), for the
// float-decoding wire formats: linear takum and posit (the reference's
// posit baseline rides the same kernel through decode_tile).
//
// What bounds it on the H100: at decode batch sizes (M <= 16) the bytes of
// the weight words (K * N bytes at takum8, 3.35 TB/s); at prefill chunks
// (M = 256) the f32 FMAs (2 M K N operations at 67 TFLOP/s, no tensor
// cores: the reference is an f32 x f32 product with an f32 sum). The codec
// adds a few dozen integer operations per weight word on top of either.
//
// Design: the tiled skeleton of tiled_matmul.cuh with the operand policy
// WireOp<N, K>: x enters shared memory as it is, each weight word is decoded
// once to f32 (wire::Codec<N, K>: takum8/16, or posit8/16 computed, or
// posit8 through the 256-entry table that the skeleton's per-block init
// hook fills in shared memory), and a product is one f32 FMA (no TF32).
// Variant 0 holds BM = 16 rows, a whole decode batch, so at decode each
// weight word is decoded exactly once; variant 1 holds 64 rows (prefill).
// The table keeps that rule: a weight tile is still decoded once per block,
// each entry by one shared-memory load instead of the integer decode.
#include <cuda_runtime.h>
#include "tiled_matmul.cuh"
#include "wire.cuh"

namespace {

template <int N, int K>
struct WireOp {
    using C = wire::Codec<N, K>;
    using X = float;
    using W = takum::WordT<N>;
    using S = float;
    using Block = typename C::Tab;
    static constexpr float PAD = 0.0f;
    __device__ static void init(Block& blk, int tid, int nt) {
        blk.fill(tid, nt);
    }
    __device__ static float load_x(float v) { return v; }
    __device__ static float load_w(W v, const Block& blk) {
        return C::decode(v, blk);
    }
    __device__ static void mac(float& acc, float a, float b) {
        acc = fmaf(a, b, acc);
    }
};

template <int N, int K>
int launch_fmt(int variant, const float* x, const void* w, float* out,
               float* work, int M, int Kdim, int Ncols, int split,
               int kt_per_split, cudaStream_t st) {
    if (variant == 0)
        return tiled::launch<WireOp<N, K>, 16, 64, 64, 1, 4>(
            x, w, out, work, M, Kdim, Ncols, split, kt_per_split, st);
    return tiled::launch<WireOp<N, K>, 64, 64, 16, 4, 4>(
        x, w, out, work, M, Kdim, Ncols, split, kt_per_split, st);
}

}  // namespace

// n: 8 or 16; kind: the format code of wire.cuh (0 linear takum, 2 posit,
// 3 posit8 through the table). variant 0: BM = 16 (decode batches);
// variant 1: BM = 64 (prefill). K is split into `split` ranges of
// kt_per_split tiles (64 deep at variant 0, 16 at variant 1); with
// split > 1, `work` holds split * M * Ncols floats of partial sums.
extern "C" int takum_qmatmul(int n, int kind, int variant, const float* x,
                             const void* w, float* out, float* work, int M,
                             int K, int Ncols, int split, int kt_per_split,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M <= 0 || Ncols <= 0) return (int)cudaGetLastError();
    if ((variant != 0 && variant != 1) || K < 0 || split < 1
        || kt_per_split < 1)
        return (int)cudaErrorInvalidValue;
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK)                                              \
        return launch_fmt<NN, KK>(variant, x, w, out, work, M, K, Ncols,    \
                                  split, kt_per_split, st);
    WIRE_DENSE_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}
