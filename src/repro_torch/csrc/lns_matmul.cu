// LNS matmul on the logarithmic-takum ell_bar datapath:
// out[M, N] = decode(x[M, K] words) (x) decode(w[K, N] words), f32.
//
// Replaces src/repro/kernels/lns_matmul.py::lns_matmul_kernel_call and its
// tile bodies _lns_ws_linear_tile, _lns_ws_gauss_tile, _lns_mo_linear_tile
// and _lns_mo_gauss_tile.
//
// What it computes. Both operands are lns-takum8 or lns-takum16 words,
// decoded to the (ell, flags) lanes of takum::lns_parts. A product
// (_prod_slab) is one int32 add of the ell lanes, an XOR of the sign bits
// and an OR of the zero and NaR flags: no float multiply touches it. Then
// * accum "linear" (_linear_fold, _lns_to_f32): every product is converted
//   once, expf(ell * 2^-(wf+1)) with its sign, zero and NaR (NaN) applied,
//   and summed in f32;
// * accum "gauss" (_gauss_fold): an int32 (s, ell, zero, nar) state, empty
//   sum = the zero flag, folds the products in the order k = 0..K-1
//   through the fixed-point Gauss-log addition of core/lns.py (the
//   (2, 1024) int32 table, linear interpolation, clip), NaR as a sticky
//   flag; one expf per output element at the end.
//
// What bounds it on the H100. Linear: one expf per product, so the SFU (16
// MUFU.EX2 per SM and clock over 132 SMs); the bytes (K N words, M K words,
// M N floats) are far below that at every serving shape. Gauss: the
// integer fold, at least 16 int32 operations per product (the steps of
// core/lns.py::gauss_add_parts) and two shared-memory table reads, with
// one thread per output element.
//
// Design (simple and right first; not the Pallas grid block by block):
// * Linear: the tiled skeleton of tiled_matmul.cuh (shared with
//   qmatmul.cu) with the operand policy LnsOp: both operands enter shared
//   memory once per K tile as packed parts, ell * 8 + flags (|ell| <
//   2^20), every row of the block reuses the weight tile (the decode-once
//   idea of the weight-stationary grid), and a product is an int add, an
//   XOR, an OR and one full-precision expf (no fast-math). BM = 4 rows
//   (decode batches: no idle rows at M = 4) or 64 rows (prefill chunks);
//   where the (N, M) grid would leave SMs idle, K is split across blocks
//   and the splits are summed in a fixed order.
// * Gauss: K is never split, because the fold is not associative: one
//   thread folds one output element sequentially over k = 0..K-1 with the
//   8 KB table in shared memory, so its integer state is bit-identical to
//   the Pallas kernel's and the plain version's. Its tiles go through the
//   same loader and policy.
// * No tensor cores: the product is not a multiply.
// Ragged M, N and K are masked in the loader (no padding): a word outside
// the matrix loads as a zero part, which adds nothing in linear mode, and
// the gauss fold stops at k = K - 1, so its state never sees padding.
#include <cuda_runtime.h>
#include <math.h>
#include "takum.cuh"
#include "tiled_matmul.cuh"

namespace {

constexpr int LUT_SIZE = 1024;     // core/lns.py GAUSS_LUT_SIZE
constexpr int STEP_LOG2 = -6;      // core/lns.py GAUSS_STEP_LOG2
constexpr int ELL_MAX_INT = 255;
constexpr int ZERO_PART = 2;       // ell 0 with the zero flag

template <int N> constexpr int FRAC_WIDTH = (N < 12 ? 12 : N) - 5;

// One word -> its packed parts, ell * 8 + flags.
template <int N>
__device__ __forceinline__ int packed_parts(uint32_t w) {
    const takum::LnsParts p = takum::lns_parts<N>(w);
    return (int)((uint32_t)p.ell << 3) | p.flags;
}

// The operand policy of tiled_matmul.cuh: packed parts in shared memory,
// each product (_prod_slab then _lns_to_f32) converted by one expf and
// added in f32 (_linear_fold).
template <int N>
struct LnsOp {
    using X = takum::WordT<N>;
    using W = takum::WordT<N>;
    using S = int;
    struct Block {};                       // no per-block state
    static constexpr int PAD = ZERO_PART;
    static constexpr int WF = FRAC_WIDTH<N>;
    __device__ static void init(Block&, int, int) {}
    __device__ static int load_x(X v) { return packed_parts<N>(v); }
    __device__ static int load_w(W v, const Block&) {
        return packed_parts<N>(v);
    }
    __device__ static void mac(float& acc, int pa, int pb) {
        const int ell = (pa >> 3) + (pb >> 3);
        const int f = pa | pb;
        const float mag = expf((float)ell * (0.5f / (float)(1 << WF)));
        const float v = (f & 2) ? 0.0f : (((pa ^ pb) & 1) ? -mag : mag);
        acc += (f & 4) ? __uint_as_float(0x7FC00000u) : v;
    }
};

// a <- a + b, the fixed-point Gauss-log addition of core/lns.py::
// gauss_add_parts on (s, ell, zero) int lanes.
template <int WF>
__device__ __forceinline__ void gauss_add(int& s_a, int& ell_a, int& zero_a,
                                          int s_b, int ell_b, int zero_b,
                                          const int* lut) {
    constexpr int SHIFT = WF + STEP_LOG2;
    constexpr int LIM = ELL_MAX_INT << WF;
    if (zero_a) {                      // empty or cancelled sum: a + b = b
        s_a = s_b;
        ell_a = ell_b;
        zero_a = zero_b;
        return;
    }
    if (zero_b) return;                // a + 0 = a
    const bool a_ge = ell_a >= ell_b;
    const int base_s = a_ge ? s_a : s_b;
    const int other_s = a_ge ? s_b : s_a;
    const int base = a_ge ? ell_a : ell_b;
    const int nd = base - (a_ge ? ell_b : ell_a);   // -d >= 0
    const bool same = base_s == other_s;
    int phi = 0;                       // beyond the table: below one ulp
    if (nd < ((LUT_SIZE - 1) << SHIFT)) {
        const int idx = nd >> SHIFT;   // <= LUT_SIZE - 2
        const int rem = nd - (idx << SHIFT);
        const int flat = (same ? 0 : LUT_SIZE) + idx;
        const int lo = lut[flat];
        // no interpolation across the saturated phi_sub(0) entry
        const int slope = (!same && idx == 0) ? 0 : lut[flat + 1] - lo;
        phi = lo + ((rem * slope) >> SHIFT);
    }
    int e = base + phi;
    e = e < -LIM ? -LIM : (e > LIM ? LIM : e);
    s_a = base_s;
    ell_a = e;
    zero_a = (!same && nd == 0) ? 1 : 0;   // exact cancellation
}

template <int N, int BM, int BN, int BK>
__global__ void __launch_bounds__(BM * BN)
lns_gauss_kernel(const takum::WordT<N>* __restrict__ x,
                 const takum::WordT<N>* __restrict__ w,
                 const int* __restrict__ lut_g, float* __restrict__ out,
                 int* __restrict__ ell_out, int* __restrict__ flg_out,
                 int M, int K, int Ncols) {
    constexpr int NT = BM * BN;
    constexpr int WF = FRAC_WIDTH<N>;
    __shared__ int lut[2 * LUT_SIZE];
    __shared__ int xs[BK][BM + 1];
    __shared__ int ws[BK][BN];
    const int tid = threadIdx.x;
    const int tx = tid % BN, ty = tid / BN;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    for (int i = tid; i < 2 * LUT_SIZE; i += NT) lut[i] = lut_g[i];
    int s = 0, ell = 0, zero = 1, nar = 0;    // the empty sum
    const typename LnsOp<N>::Block blk{};
    for (int k0 = 0; k0 < K; k0 += BK) {
        tiled::load_tiles<LnsOp<N>, BM, BN, BK, NT>(x, w, xs, ws, blk, m0, n0,
                                                    k0, M, K, Ncols, tid);
        __syncthreads();
        const int kn = min(BK, K - k0);
        for (int kr = 0; kr < kn; ++kr) {
            const int pa = xs[kr][ty], pb = ws[kr][tx];
            const int f = pa | pb;
            nar |= (f >> 2) & 1;
            gauss_add<WF>(s, ell, zero, (pa ^ pb) & 1, (pa >> 3) + (pb >> 3),
                          (f >> 1) & 1, lut);
        }
        __syncthreads();
    }
    const int m = m0 + ty, n = n0 + tx;
    if (m < M && n < Ncols) {
        const float mag = expf((float)ell * (0.5f / (float)(1 << WF)));
        const float v = zero ? 0.0f : (s ? -mag : mag);
        const size_t o = (size_t)m * Ncols + n;
        out[o] = nar ? __uint_as_float(0x7FC00000u) : v;
        if (ell_out != nullptr) {
            ell_out[o] = ell;
            flg_out[o] = s | (zero << 1) | (nar << 2);
        }
    }
}

template <int N>
void launch_gauss(const void* x, const void* w, const int* lut, float* out,
                  int* ell_out, int* flg_out, int M, int K, int Ncols,
                  cudaStream_t st) {
    constexpr int BM = 4, BN = 64, BK = 64;
    dim3 grid((Ncols + BN - 1) / BN, (M + BM - 1) / BM);
    lns_gauss_kernel<N, BM, BN, BK><<<grid, BM * BN, 0, st>>>(
        (const takum::WordT<N>*)x, (const takum::WordT<N>*)w, lut, out,
        ell_out, flg_out, M, K, Ncols);
}

}  // namespace

// n: 8 or 16 (lns-takum words). gauss = 0: linear accumulation, variant 0
// (4-row blocks, 128 columns, K tiles of 32) or 1 (64 x 64, K tiles of
// 16), K split into `split` ranges of kt_per_split tiles (with split > 1,
// `work` holds split * M * Ncols floats). gauss = 1: the (2, 1024) int32
// table `lut`, no split; ell_out/flg_out (M * Ncols int32 each, or null)
// receive the final integer state.
extern "C" int takum_lns_matmul(int n, int gauss, int variant, const void* x,
                                const void* w, const int* lut, float* out,
                                float* work, int* ell_out, int* flg_out,
                                int M, int K, int Ncols, int split,
                                int kt_per_split, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M <= 0 || Ncols <= 0) return (int)cudaGetLastError();
    if ((n != 8 && n != 16) || K < 0 || split < 1 || kt_per_split < 1)
        return (int)cudaErrorInvalidValue;
    if (gauss) {
        if (lut == nullptr || split != 1) return (int)cudaErrorInvalidValue;
        if (n == 8) launch_gauss<8>(x, w, lut, out, ell_out, flg_out, M, K, Ncols, st);
        else launch_gauss<16>(x, w, lut, out, ell_out, flg_out, M, K, Ncols, st);
        return (int)cudaGetLastError();
    }
    if (variant == 0) {
        if (n == 8) return tiled::launch<LnsOp<8>, 4, 128, 32, 1, 2>(x, w, out, work, M, K, Ncols, split, kt_per_split, st);
        return tiled::launch<LnsOp<16>, 4, 128, 32, 1, 2>(x, w, out, work, M, K, Ncols, split, kt_per_split, st);
    }
    if (variant == 1) {
        if (n == 8) return tiled::launch<LnsOp<8>, 64, 64, 16, 4, 4>(x, w, out, work, M, K, Ncols, split, kt_per_split, st);
        return tiled::launch<LnsOp<16>, 64, 64, 16, 4, 4>(x, w, out, work, M, K, Ncols, split, kt_per_split, st);
    }
    return (int)cudaErrorInvalidValue;
}
