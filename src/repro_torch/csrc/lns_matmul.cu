// LNS matmul on the logarithmic-takum ell_bar datapath:
// out[M, N] = decode(x[M, K] words) (x) decode(w[K, N] words), f32.
//
// Replaces src/repro/kernels/lns_matmul.py::lns_matmul_kernel_call and its
// tile bodies _lns_ws_linear_tile, _lns_ws_gauss_tile, _lns_mo_linear_tile
// and _lns_mo_gauss_tile (with _lns_to_f32).
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
// What bounds it on the H100. Linear: one full-precision expf per product
// (16 MUFU.EX2 per SM and clock over 132 SMs); the bytes (K N words, M K
// words, M N floats) are far below that at every serving shape. But expf
// is itself 7 instructions around its MUFU.EX2 (range reduction and
// scaling), so with the add of the arguments, the sign and the sum a
// product costs 11 issue slots: the 4 schedulers of an SM issue about 11.6
// products a clock against 16 for the MUFU pipe. Instruction issue, not
// the SFU, is the floor a linear kernel can reach (about 1.4x the SFU
// bound). Gauss: the integer fold, at least 16 int32 operations per product
// (the steps of core/lns.py::gauss_add_parts) and two shared-memory table
// reads, with one thread per output element.
//
// Design of the linear kernels: an operand word enters as its "lv" pair,
// the ell lane scaled by 2^-(wf+1) as an f32 (exact: |ell| < 2^19) and its
// sign as the f32 sign-bit mask. The sum of two lv is exact in f32 (at most
// 20 significant bits), so expf(lv_x + lv_w) is bit for bit
// expf((float)(ell_x + ell_w) * 2^-(wf+1)), the reference's conversion;
// the product's sign is one 3-input XOR into the result's sign bit. A zero
// word's lv is ZERO_LV = -2^20, whose expf is +0 whatever the other lv
// (the +0 and -0 terms leave an f32 sum that starts at +0 unchanged, as
// the reference's 0 terms do), and a NaR word's lv is NaN, which makes
// its products NaN, and so exactly the outputs of its row or column, as
// the reference's NaN conversion does. So a product is an FADD, expf, a
// LOP3 and the FADD of the sum, with no select, shift or int-to-float
// conversion (I2F runs at 16 a clock, as MUFU does). No fast exponential
// and no -use_fast_math: the K = 1 check holds every product to 2 ulp.
// lns-takum8 words become lv pairs through a 256-entry shared-memory table
// filled by the computed decode at block start; lns-takum16 words are
// decoded by computation (takum::lns_parts), once per block. Two regimes,
// chosen by repro_torch/kernels/lns_matmul.py::launch_plan:
// * variant 0, decode batches (M <= 16): stream_kernel. A block owns a
//   strip of 32 (8-bit) or 16 (16-bit) columns, 256 threads, two per weight
//   row: each thread loads the 16 bytes of its row's half of the strip (a
//   full 32-byte sector per pair) with the next row's load in flight, takes
//   the MC = 4 x words of that row (the grid's y covers the rows of x),
//   and keeps MC x 16 bytes of columns of f32 sums. The 128 row slots of
//   a block (disjoint K rows, warp w the rows k0 + 16 w + 128 i and
//   the pairs within) meet in a fixed tree: shuffles that halve each lane's
//   sums at each step, then the 8 warps in order through shared memory. No
//   atomics; where the column strips alone would leave the SMs idle, K is
//   split across blocks (the grid's z) and split_sum_kernel adds the splits
//   in a fixed order (a second launch; none at 4x5120x17920).
// * variant 1, prefill chunks (M > 16): tile_kernel, register-blocked 64 x
//   64 x 16 tiles, 64 threads of 8 x 8 outputs. The next K tile's words
//   arrive in registers (16-byte loads) while the current one is computed;
//   each word is decoded once per block into lv pairs in shared memory
//   (double-buffered, one barrier per tile), and a thread reads its 8 rows
//   and 8 columns of lv pairs as 16-byte vectors for 64 products. K is split
//   across blocks when the grid would leave the SMs idle.
// Ragged M, N and K are masked in the loaders (no padding): a word outside
// the matrix loads as the zero word.
// * Gauss: K is never split, because the fold is not associative: one
//   thread folds one output element sequentially over k = 0..K-1 with the
//   8 KB table in shared memory, so its integer state is bit-identical to
//   the Pallas kernel's and the plain version's (tiled_matmul.cuh's loader
//   with the packed-parts policy PartsOp).
// * No tensor cores: the product is not a multiply.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "takum.cuh"
#include "tiled_matmul.cuh"
#include "wire.cuh"

namespace {

constexpr int LUT_SIZE = 1024;     // core/lns.py GAUSS_LUT_SIZE
constexpr int STEP_LOG2 = -6;      // core/lns.py GAUSS_STEP_LOG2
constexpr int ELL_MAX_INT = 255;
constexpr int ZERO_PART = 2;       // ell 0 with the zero flag
constexpr float ZERO_LV = -1048576.0f;   // -2^20: expf(ZERO_LV + lv) = +0

template <int N> constexpr int FRAC_WIDTH = (N < 12 ? 12 : N) - 5;

// -- linear accumulation ------------------------------------------------------

// One operand word of the linear kernels: lv = ell * 2^-(wf+1) (ZERO_LV for
// zero, NaN for NaR) and the sign as the f32 sign-bit mask.
struct Lv {
    float lv;
    uint32_t sign;
};

template <int N>
__device__ __forceinline__ Lv lv_of(uint32_t w) {
    const takum::LnsParts p = takum::lns_parts<N>(w);
    Lv r;
    r.lv = (p.flags & 4) ? __uint_as_float(0x7FC00000u)
         : (p.flags & 2) ? ZERO_LV
         : (float)p.ell * (0.5f / (float)(1 << FRAC_WIDTH<N>));
    r.sign = (uint32_t)(p.flags & 1) << 31;
    return r;
}

// The lv pairs of the 256 lns-takum8 words (WIRE_TAKUM8_COMPUTED set to 1
// turns the table off: the timing builds of tools/torch_kernel_times.py).
template <int N>
struct LvTab {
    static constexpr bool ON = N == 8 && !WIRE_TAKUM8_COMPUTED;
    __device__ void fill(int, int) {}
};
template <>
struct LvTab<8> {
    static constexpr bool ON = !WIRE_TAKUM8_COMPUTED;
    uint2 e[ON ? 256 : 1];
    __device__ void fill(int tid, int nt) {
        if constexpr (ON)
            for (int i = tid; i < 256; i += nt) {
                const Lv v = lv_of<8>((uint32_t)i);
                e[i] = make_uint2(__float_as_uint(v.lv), v.sign);
            }
    }
};

template <int N>
__device__ __forceinline__ Lv decode_lv(uint32_t w, const LvTab<N>& tab) {
    if constexpr (LvTab<N>::ON) {
        const uint2 v = tab.e[w & 0xFFu];
        return Lv{__uint_as_float(v.x), v.y};
    } else {
        return lv_of<N>(w);
    }
}

// acc += the product of x and w: one expf, the sign by XOR.
__device__ __forceinline__ void lns_mac(float& acc, float xl, uint32_t xs,
                                       float wl, uint32_t ws) {
    acc += __uint_as_float(__float_as_uint(expf(xl + wl)) ^ xs ^ ws);
}

// -- variant 0: decode batches ------------------------------------------------

constexpr int ST_NT = 256;     // threads of a streaming block
constexpr int ST_LPR = 2;      // threads per weight row (32 bytes)
constexpr int ST_RPS = ST_NT / ST_LPR;   // row slots of a block

template <int N, int MC>
struct Stream {
    static constexpr int CW = 128 / N;          // columns of one 16-byte load
    static constexpr int BN = ST_LPR * CW;      // columns of a block
    static constexpr int V = MC * CW;           // sums per thread
    static_assert(V == 32 || V == 64, "32 or 64 sums per thread");
};

// The 16 bytes of row k at columns n0 .. n0 + CW - 1 (zero words past N).
template <int N, bool VEC>
__device__ __forceinline__ uint4 load_row(const takum::WordT<N>* w, int k,
                                          int n0, int Ncols) {
    constexpr int CW = 128 / N;
    const takum::WordT<N>* p = w + (size_t)k * Ncols + n0;
    if (VEC && n0 + CW <= Ncols)
        return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < CW; ++c)
        if (n0 + c < Ncols)
            v[c * N / 32] |= (uint32_t)p[c] << ((c * N) % 32);
    return make_uint4(v[0], v[1], v[2], v[3]);
}

// One step of the fixed reduction tree of a streaming block: lanes O apart
// pair up, each keeps H of its 2H live sums (the upper half where lane & O)
// and adds its partner's matching half; then the next step, down to lanes
// ST_LPR apart (the threads of one weight row keep their own columns).
template <int H, int O>
__device__ __forceinline__ void tree_step(float* acc, int lane, int& base) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int e = 0; e < H; ++e) {
        const float send = up ? acc[e] : acc[e + H];
        const float keep = up ? acc[e + H] : acc[e];
        acc[e] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    if (up) base += H;
    if constexpr (O > ST_LPR) tree_step<H / 2, O / 2>(acc, lane, base);
}

template <int N, int MC, bool VEC>
__global__ void __launch_bounds__(ST_NT)
stream_kernel(const takum::WordT<N>* __restrict__ x,
              const takum::WordT<N>* __restrict__ w, float* __restrict__ out,
              int M, int K, int Ncols, int krows) {
    using P = Stream<N, MC>;
    constexpr int CW = P::CW, V = P::V;
    __shared__ LvTab<N> tab;
    __shared__ float red[ST_NT / 32][ST_LPR][V];
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int half = tid % ST_LPR, slot = tid / ST_LPR;
    const int n0 = blockIdx.x * P::BN + half * CW;
    const int m0 = blockIdx.y * MC;
    const int k0 = blockIdx.z * krows;
    const int kend = min(K, k0 + krows);
    const int nrows = kend - k0 > slot ? (kend - k0 - slot + ST_RPS - 1) / ST_RPS
                                       : 0;
    const bool cols = n0 < Ncols;
    tab.fill(tid, ST_NT);

    // row i of this thread: k = k0 + slot + ST_RPS i; its weight vector and
    // the MC x words of that k (rows past M read the zero word)
    auto load = [&](uint4& wv, uint32_t (&xw)[MC], int i) {
        const int k = k0 + slot + ST_RPS * i;
        const bool ok = i < nrows;
        wv = (ok && cols) ? load_row<N, VEC>(w, k, n0, Ncols)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int m = 0; m < MC; ++m)
            xw[m] = (ok && m0 + m < M) ? (uint32_t)x[(size_t)(m0 + m) * K + k]
                                       : 0u;
    };
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    uint4 wcur, wnxt = make_uint4(0u, 0u, 0u, 0u);
    uint32_t xcur[MC], xnxt[MC];
    load(wcur, xcur, 0);
    __syncthreads();           // the table is filled
    for (int i = 0; i < nrows; ++i) {
        if (i + 1 < nrows) load(wnxt, xnxt, i + 1);
        Lv xv[MC];
#pragma unroll
        for (int m = 0; m < MC; ++m) xv[m] = decode_lv<N>(xcur[m], tab);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
            const Lv wl = decode_lv<N>(wire::word_of<N>(wcur, c), tab);
#pragma unroll
            for (int m = 0; m < MC; ++m)
                lns_mac(acc[m * CW + c], xv[m].lv, xv[m].sign, wl.lv, wl.sign);
        }
        wcur = wnxt;
#pragma unroll
        for (int m = 0; m < MC; ++m) xcur[m] = xnxt[m];
    }

    // The 16 row slots of a warp that share this thread's half meet in
    // tree_step; lane l then holds the V / 16 sums from index base.
    int base = 0;
    tree_step<V / 2, 16>(acc, lane, base);
#pragma unroll
    for (int e = 0; e < V / 16; ++e) red[warp][half][base + e] = acc[e];
    __syncthreads();
    // the 8 warps in order
    float* dst = out + (size_t)blockIdx.z * M * Ncols;
    for (int t = tid; t < ST_LPR * V; t += ST_NT) {
        const int hf = t / V, e = t % V;
        float s = red[0][hf][e];
#pragma unroll
        for (int wp = 1; wp < ST_NT / 32; ++wp) s += red[wp][hf][e];
        const int m = m0 + e / CW;
        const int n = blockIdx.x * P::BN + hf * CW + e % CW;
        if (m < M && n < Ncols) dst[(size_t)m * Ncols + n] = s;
    }
}

// -- variant 1: prefill chunks ------------------------------------------------

constexpr int TL_BM = 64, TL_BN = 64, TL_BK = 16, TL_T = 8;
constexpr int TL_NT = (TL_BM / TL_T) * (TL_BN / TL_T);   // 64

template <int N>
struct Tile {
    static constexpr int W = 128 / N;                    // words per vector
    static constexpr int XL = TL_BK / W;                 // vectors per x row
    static constexpr int WL = TL_BN / W;                 // vectors per w row
    static constexpr int XU = TL_BM * XL / TL_NT;        // x vectors per thread
    static constexpr int WU = TL_BK * WL / TL_NT;        // w vectors per thread
    static_assert(XU >= 1 && WU >= 1, "whole vectors per thread");
};

// words [e0, e0 + W) of a row of `len` words at p (zero words past len)
template <int N, bool VEC>
__device__ __forceinline__ uint4 load_vec(const takum::WordT<N>* p, int e0,
                                          int len, bool row_ok) {
    constexpr int W = 128 / N;
    if (!row_ok) return make_uint4(0u, 0u, 0u, 0u);
    if (VEC && e0 + W <= len)
        return __ldg(reinterpret_cast<const uint4*>(p + e0));
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < W; ++c)
        if (e0 + c < len) v[c * N / 32] |= (uint32_t)p[e0 + c] << ((c * N) % 32);
    return make_uint4(v[0], v[1], v[2], v[3]);
}

template <int N, bool VEC>
__global__ void __launch_bounds__(TL_NT)
tile_kernel(const takum::WordT<N>* __restrict__ x,
            const takum::WordT<N>* __restrict__ w, float* __restrict__ out,
            int M, int K, int Ncols, int kt_per_split) {
    using T = Tile<N>;
    constexpr int W = T::W;
    __shared__ LvTab<N> tab;
    __shared__ __align__(16) float xl[2][TL_BK][TL_BM];
    __shared__ __align__(16) uint32_t xs[2][TL_BK][TL_BM];
    __shared__ __align__(16) float wl[2][TL_BK][TL_BN];
    __shared__ __align__(16) uint32_t ws[2][TL_BK][TL_BN];
    const int tid = threadIdx.x;
    const int tx = tid % (TL_BN / TL_T), ty = tid / (TL_BN / TL_T);
    const int n0 = blockIdx.x * TL_BN, m0 = blockIdx.y * TL_BM;
    const int kt_total = (K + TL_BK - 1) / TL_BK;
    const int kt0 = blockIdx.z * kt_per_split;
    const int kt1 = min(kt0 + kt_per_split, kt_total);
    tab.fill(tid, TL_NT);

    uint4 xr[T::XU], wr[T::WU];
    auto load = [&](int kt) {
        const int k0 = kt * TL_BK;
#pragma unroll
        for (int u = 0; u < T::XU; ++u) {
            const int idx = tid + u * TL_NT, r = idx / T::XL, part = idx % T::XL;
            xr[u] = load_vec<N, VEC>(x + (size_t)(m0 + r) * K, k0 + part * W,
                                     K, m0 + r < M);
        }
#pragma unroll
        for (int u = 0; u < T::WU; ++u) {
            const int idx = tid + u * TL_NT, kr = idx / T::WL, part = idx % T::WL;
            wr[u] = load_vec<N, VEC>(w + (size_t)(k0 + kr) * Ncols,
                                     n0 + part * W, Ncols, k0 + kr < K);
        }
    };
    auto store = [&](int b) {
#pragma unroll
        for (int u = 0; u < T::XU; ++u) {
            const int idx = tid + u * TL_NT, r = idx / T::XL, part = idx % T::XL;
#pragma unroll
            for (int c = 0; c < W; ++c) {
                const Lv v = decode_lv<N>(wire::word_of<N>(xr[u], c), tab);
                xl[b][part * W + c][r] = v.lv;
                xs[b][part * W + c][r] = v.sign;
            }
        }
#pragma unroll
        for (int u = 0; u < T::WU; ++u) {
            const int idx = tid + u * TL_NT, kr = idx / T::WL, part = idx % T::WL;
#pragma unroll
            for (int c = 0; c < W; ++c) {
                const Lv v = decode_lv<N>(wire::word_of<N>(wr[u], c), tab);
                wl[b][kr][part * W + c] = v.lv;
                ws[b][kr][part * W + c] = v.sign;
            }
        }
    };

    float acc[TL_T][TL_T];
#pragma unroll
    for (int i = 0; i < TL_T; ++i)
#pragma unroll
        for (int j = 0; j < TL_T; ++j) acc[i][j] = 0.0f;
    if (kt0 < kt1) load(kt0);
    __syncthreads();           // the table is filled
    for (int kt = kt0; kt < kt1; ++kt) {
        const int b = (kt - kt0) & 1;
        store(b);
        __syncthreads();
        if (kt + 1 < kt1) load(kt + 1);
#pragma unroll 2
        for (int kr = 0; kr < TL_BK; ++kr) {
            float a[TL_T], bb[TL_T];
            uint32_t sa[TL_T], sb[TL_T];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float4 av = *reinterpret_cast<const float4*>(&xl[b][kr][32 * h + 4 * ty]);
                const uint4 as = *reinterpret_cast<const uint4*>(&xs[b][kr][32 * h + 4 * ty]);
                const float4 bv = *reinterpret_cast<const float4*>(&wl[b][kr][32 * h + 4 * tx]);
                const uint4 bs = *reinterpret_cast<const uint4*>(&ws[b][kr][32 * h + 4 * tx]);
                a[4 * h] = av.x; a[4 * h + 1] = av.y; a[4 * h + 2] = av.z; a[4 * h + 3] = av.w;
                sa[4 * h] = as.x; sa[4 * h + 1] = as.y; sa[4 * h + 2] = as.z; sa[4 * h + 3] = as.w;
                bb[4 * h] = bv.x; bb[4 * h + 1] = bv.y; bb[4 * h + 2] = bv.z; bb[4 * h + 3] = bv.w;
                sb[4 * h] = bs.x; sb[4 * h + 1] = bs.y; sb[4 * h + 2] = bs.z; sb[4 * h + 3] = bs.w;
            }
#pragma unroll
            for (int i = 0; i < TL_T; ++i)
#pragma unroll
                for (int j = 0; j < TL_T; ++j)
                    lns_mac(acc[i][j], a[i], sa[i], bb[j], sb[j]);
        }
    }
    float* dst = out + (size_t)blockIdx.z * M * Ncols;
#pragma unroll
    for (int i = 0; i < TL_T; ++i) {
        const int m = m0 + 32 * (i / 4) + 4 * ty + i % 4;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TL_T; ++j) {
            const int n = n0 + 32 * (j / 4) + 4 * tx + j % 4;
            if (n < Ncols) dst[(size_t)m * Ncols + n] = acc[i][j];
        }
    }
}

template <int N, int MC>
void launch_stream(const takum::WordT<N>* x, const takum::WordT<N>* w,
                   float* dst, int M, int K, int Ncols, int split, int krows,
                   bool wvec, cudaStream_t st) {
    using P = Stream<N, MC>;
    dim3 grid((Ncols + P::BN - 1) / P::BN, (M + MC - 1) / MC, split);
    if (wvec)
        stream_kernel<N, MC, true><<<grid, ST_NT, 0, st>>>(x, w, dst, M, K,
                                                           Ncols, krows);
    else
        stream_kernel<N, MC, false><<<grid, ST_NT, 0, st>>>(x, w, dst, M, K,
                                                            Ncols, krows);
}

template <int N>
int launch_linear(int variant, const void* xp, const void* wp, float* out,
                  float* work, int M, int K, int Ncols, int split,
                  int kt_per_split, cudaStream_t st) {
    using Word = takum::WordT<N>;
    const Word* x = (const Word*)xp;
    const Word* w = (const Word*)wp;
    float* dst = split > 1 ? work : out;
    const bool wvec = (size_t)Ncols * N / 8 % 16 == 0
        && (uintptr_t)w % 16 == 0;
    const int krows = kt_per_split * ST_RPS;
    if (variant == 1) {
        const bool vec = wvec && (size_t)K * N / 8 % 16 == 0
            && (uintptr_t)x % 16 == 0;
        dim3 grid((Ncols + TL_BN - 1) / TL_BN, (M + TL_BM - 1) / TL_BM, split);
        if (vec)
            tile_kernel<N, true><<<grid, TL_NT, 0, st>>>(x, w, dst, M, K,
                                                         Ncols, kt_per_split);
        else
            tile_kernel<N, false><<<grid, TL_NT, 0, st>>>(x, w, dst, M, K,
                                                          Ncols, kt_per_split);
    } else {
        launch_stream<N, 4>(x, w, dst, M, K, Ncols, split, krows, wvec, st);
    }
    if (split > 1) {
        const long long count = (long long)M * Ncols;
        long long blocks = (count + 255) / 256;
        if (blocks > 132 * 16) blocks = 132 * 16;
        tiled::split_sum_kernel<<<(int)blocks, 256, 0, st>>>(work, out, count,
                                                             split);
    }
    return (int)cudaGetLastError();
}

// -- gauss accumulation -------------------------------------------------------

// One word -> its packed parts, ell * 8 + flags.
template <int N>
__device__ __forceinline__ int packed_parts(uint32_t w) {
    const takum::LnsParts p = takum::lns_parts<N>(w);
    return (int)((uint32_t)p.ell << 3) | p.flags;
}

// The loader policy of tiled_matmul.cuh for the gauss kernel: packed parts
// in shared memory.
template <int N>
struct PartsOp {
    using X = takum::WordT<N>;
    using W = takum::WordT<N>;
    using S = int;
    struct Block {};                       // no per-block state
    static constexpr int PAD = ZERO_PART;
    __device__ static int load_x(X v) { return packed_parts<N>(v); }
    __device__ static int load_w(W v, const Block&) {
        return packed_parts<N>(v);
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
    const typename PartsOp<N>::Block blk{};
    for (int k0 = 0; k0 < K; k0 += BK) {
        tiled::load_tiles<PartsOp<N>, BM, BN, BK, NT>(x, w, xs, ws, blk, m0,
                                                      n0, k0, M, K, Ncols,
                                                      tid);
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
// (the streaming kernel, 4 rows of x a block; K tiles of 128 rows) or 1
// (64 x 64 register-blocked tiles; K tiles of 16), K split into `split` ranges of kt_per_split tiles (with
// split > 1, `work` holds split * M * Ncols floats). gauss = 1: the
// (2, 1024) int32 table `lut`, no split; ell_out/flg_out (M * Ncols int32
// each, or null) receive the final integer state.
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
    if (variant < 0 || variant > 1 || (variant == 0 && M > 16))
        return (int)cudaErrorInvalidValue;
    if (n == 8)
        return launch_linear<8>(variant, x, w, out, work, M, K, Ncols, split,
                                kt_per_split, st);
    return launch_linear<16>(variant, x, w, out, work, M, K, Ncols, split,
                             kt_per_split, st);
}
