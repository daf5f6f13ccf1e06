// The tiled matmul skeleton of the wire-weight matmul (qmatmul.cu) and the
// linear LNS matmul (lns_matmul.cu): out[M, N] = x[M, K] (op) w[K, N], f32.
//
// The two kernels differ only in how an operand word enters shared memory
// and how one product joins the sum. That is the operand policy `Op`:
//
//   using X, W;               // element types of x and w in global memory
//   using S;                  // element type of a decoded tile entry
//   using Block;              // per-block state in shared memory (a decode
//                             // table; an empty struct where none is needed)
//   static void init(Block&, int tid, int nt);  // fills it at block start
//   static constexpr S PAD;   // an entry outside the matrix: adds nothing
//   static S load_x(X);                  // the decodes, once per entry
//   static S load_w(W, const Block&);
//   static void mac(float& acc, S a, S b);  // acc += a (op) b
//
// Design (simple first):
// * A block owns a (BM rows x BN columns) output tile and loops over its
//   range of K tiles. Each (BK x BN) weight tile and (BM x BK) activation
//   tile (stored transposed) is read once and decoded once into shared
//   memory; every row of the block reuses the weight tile (the decode-once
//   rule of the Pallas weight-stationary grid, held per block).
// * TM x TN outputs per thread, accumulated in f32 registers.
// * The grid is (ceil(N / BN), ceil(M / BM), split). When the (N, M) grid
//   is too small to fill the SMs, K is split across blocks: each split
//   writes its partial tile to a workspace and split_sum_kernel adds the
//   splits in a fixed order, so the result does not depend on scheduling.
// * Ragged M, N and K are masked in the loader (no padding): an entry
//   outside the matrix is Op::PAD.
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

template <class Op, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const typename Op::X* __restrict__ x,
              const typename Op::W* __restrict__ w, float* __restrict__ out,
              int M, int K, int Ncols, int kt_per_split) {
    constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
    using S = typename Op::S;
    __shared__ S xs[BK][BM + 1];
    __shared__ S ws[BK][BN];
    __shared__ typename Op::Block blk;
    const int tid = threadIdx.x;
    Op::init(blk, tid, NT);
    __syncthreads();            // blk is filled before the first load_w
    const int tx = tid % TX, ty = tid / TX;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int kt_total = (K + BK - 1) / BK;
    const int kt0 = blockIdx.z * kt_per_split;
    const int kt1 = min(kt0 + kt_per_split, kt_total);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int kt = kt0; kt < kt1; ++kt) {
        load_tiles<Op, BM, BN, BK, NT>(x, w, xs, ws, blk, m0, n0, kt * BK, M,
                                       K, Ncols, tid);
        __syncthreads();
#pragma unroll 4
        for (int kr = 0; kr < BK; ++kr) {
            S a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[kr][ty + i * TY];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = ws[kr][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) Op::mac(acc[i][j], a[i], b[j]);
        }
        __syncthreads();
    }
    float* dst = out + (size_t)blockIdx.z * M * Ncols;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty + i * TY;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx + j * TX;
            if (m < M && n < Ncols) dst[(size_t)m * Ncols + n] = acc[i][j];
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

// Launches the matmul over `split` K ranges of kt_per_split tiles each
// (with split > 1 into `work`, split * M * Ncols floats, then the fixed-
// order sum into `out`). Returns cudaGetLastError().
template <class Op, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* w, float* out, float* work, int M,
           int K, int Ncols, int split, int kt_per_split, cudaStream_t st) {
    float* dst = split > 1 ? work : out;
    dim3 grid((Ncols + BN - 1) / BN, (M + BM - 1) / BM, split);
    matmul_kernel<Op, BM, BN, BK, TM, TN>
        <<<grid, (BM / TM) * (BN / TN), 0, st>>>(
            (const typename Op::X*)x, (const typename Op::W*)w, dst, M, K,
            Ncols, kt_per_split);
    if (split > 1) {
        const long long count = (long long)M * Ncols;
        long long blocks = (count + 255) / 256;
        if (blocks > 132 * 16) blocks = 132 * 16;
        split_sum_kernel<<<(int)blocks, 256, 0, st>>>(work, out, count,
                                                      split);
    }
    return (int)cudaGetLastError();
}

}  // namespace tiled
