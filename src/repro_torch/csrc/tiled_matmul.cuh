// Shared pieces of the matmul kernels (lns_matmul.cu, qmatmul.cu).
//
// * load_tiles: the tile loader of the gauss LNS matmul. A (BK x BN)
//   weight tile and a (BM x BK) activation tile (stored transposed) enter
//   shared memory once per K tile through the decode of an operand policy
//   `Op`:
//
//     using X, W;               // element types of x and w in global memory
//     using S;                  // element type of a decoded tile entry
//     using Block;              // per-block state the decode reads
//     static constexpr S PAD;   // an entry outside the matrix: adds nothing
//     static S load_x(X);                  // the decodes, once per entry
//     static S load_w(W, const Block&);
//
//   Ragged M, N and K are masked (no padding): an entry outside the matrix
//   is Op::PAD.
// * split_sum_kernel: where a kernel splits K across blocks (the grid's z)
//   to fill the SMs, each split writes its partial tile to a workspace and
//   this kernel adds the splits in a fixed order, so the result does not
//   depend on scheduling.
#pragma once
#include <cuda_runtime.h>

namespace tiled {

// Loads the (BK x BN) weight tile and the (BM x BK) activation tile (the
// latter transposed) through the policy's decode.
template <class Op, int BM, int BN, int BK, int NT>
__device__ __forceinline__ void load_tiles(
        const typename Op::X* __restrict__ x,
        const typename Op::W* __restrict__ w, typename Op::S (*xs)[BM + 1],
        typename Op::S (*ws)[BN], const typename Op::Block& blk, int m0,
        int n0, int k0, int M, int K, int Ncols, int tid) {
    for (int i = tid; i < BK * BN; i += NT) {
        const int kr = i / BN, nc = i % BN;
        const int k = k0 + kr, n = n0 + nc;
        ws[kr][nc] = (k < K && n < Ncols)
            ? Op::load_w(w[(size_t)k * Ncols + n], blk) : Op::PAD;
    }
    for (int i = tid; i < BM * BK; i += NT) {
        const int mr = i / BK, kr = i % BK;
        const int m = m0 + mr, k = k0 + kr;
        xs[kr][mr] = (m < M && k < K)
            ? Op::load_x(x[(size_t)m * K + k]) : Op::PAD;
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

}  // namespace tiled
