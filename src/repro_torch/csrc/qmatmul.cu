// Wire-weight matmul: out[M, N] = x[M, K] (f32) @ decode(w[K, N] words).
//
// Replaces src/repro/kernels/takum_matmul.py::qmatmul_kernel_call
// (_qmm_ws_tile and its M-outer fallback _qmm_tile_moutermost), for the
// float-decoding wire formats: linear takum and posit (the reference's
// posit baseline rides the same kernel through decode_tile).
//
// Two kernels, one per regime; repro_torch/kernels/takum_matmul.py's
// launch_plan picks one per call (variant 0 or 1).
//
// Variant 0, decode batches (M <= 16): bound by the bytes of the weight
// words (K * N bytes at takum8 over 3.35 TB/s). stream_kernel streams them:
// * each lane loads 16 consecutive bytes of one weight row at a time (16
//   words at 8 bits, 8 at 16 bits) and keeps two batches of U = 4 such
//   loads in flight (the next batch is loaded while the current one is
//   decoded), 256 threads a block: tens of KB in flight per SM;
// * the 8 warps of a block share its columns (32 x 16 bytes) and take
//   disjoint rows of its K range (warp w: rows k0 + w + 8 i); x [MC rows,
//   K range] is staged once in shared memory and read by broadcast; each
//   lane keeps MC x (16 bytes of columns) f32 sums;
// * the warps' sums meet in shared memory in a fixed tree, and K ranges
//   of several blocks (the grid's z) are summed in a fixed order by
//   tiled_matmul.cuh's split_sum_kernel: no atomics, the same bits on
//   every call;
// * 8-bit takum and posit words decode through a 256-entry table in shared
//   memory (wire::Codec's Tab: one 1 KB Table8, filled by the computed
//   decode at block start: bit-identical). For takum8 the table is always
//   on; posit8 takes it under REPRO_LUT_DECODE as elsewhere (format code
//   3). 16-bit words keep the computed decode, about 30 integer operations
//   a word, which at 4x5120x17920 is about 0.17 ms of integer throughput
//   against a 0.055 ms byte bound: they are bound by the decode, not the
//   bytes.
// Rows past M (up to MC per block), columns past N and a ragged K are
// masked; a weight matrix whose rows are not 16-byte multiples (or not
// 16-byte aligned) takes the same kernel with one-word loads (VEC false).
//
// Variant 1, prefill chunks (M > 16): bound by the products (M K N
// multiply-adds, 2 or 3 TF32 products each). tc_kernel runs them on the
// tensor cores as split TF32 products (tf32.cuh): x is split into a TF32
// hi and lo part; an 8-bit weight word is exact in TF32 (takum8 and posit8
// carry at most 3 fraction bits), so 2 products per MAC carry about 21
// bits of x; 16-bit words are split too (3 products). Block tile BM x 128
// x 32 in warps of 32 x 64; the next K tile of x (f32) and of the words
// arrives by cp.async while the current one is computed; each word is
// decoded once per block into an f32 tile in shared memory (through the
// 8-bit table, or computed). BM is 64 for 8-bit words (a table lookup
// each: four warps) and 128 for 16-bit words, whose computed decode
// (about 30 integer operations a word, paid once per block) bounded a
// 64-row block: eight warps share each decoded tile, and its words are
// split into their TF32 hi and lo parts once, in the decode pass, where
// each of the four row warps would split them again. The tensor cores'
// own accumulation truncates, so each warp's partial sums start from zero
// and are added into an f32 register sum, rounding to nearest, every
// PROMOTE_K = 128 of K. A tile whose decoded weights are all finite (the
// decode pass says so through the barrier that follows it,
// __syncthreads_or) skips the small products' non-finite guard of
// tf32.cuh; a tile holding an inf or a NaR weight takes it (PERF.md holds
// the times of both, from tools/torch_kernel_times.py). Small grids split
// K across blocks as variant 0 does.
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32.cuh"
#include "tiled_matmul.cuh"
#include "wire.cuh"

namespace {

// -- variant 0: decode batches ---------------------------------------------

constexpr int ST_NT = 256, ST_U = 4;
constexpr int ST_RED = 4 * 64 * 32;       // tree-sum floats: 4 warps x 64 x 32 lanes

template <int N>
struct Stream {
    static constexpr int CW = 128 / N;      // columns of one 16-byte load
    static constexpr int MC = N == 8 ? 4 : 8;   // rows of x per block
    static constexpr int BN = 32 * CW;      // columns of a block
    static_assert(MC * CW == 64, "64 sums per lane");
};

// The 16 bytes of row k at columns n0 .. n0 + CW - 1 (zero words past N).
template <int N, bool VEC>
__device__ __forceinline__ uint4 load_row(const wire::WordT<N>* w, int k,
                                          int n0, int Ncols) {
    constexpr int CW = Stream<N>::CW;
    const wire::WordT<N>* p = w + (size_t)k * Ncols + n0;
    if constexpr (VEC) {
        return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int c = 0; c < CW; ++c)
            if (n0 + c < Ncols)
                v[c * N / 32] |= (uint32_t)p[c] << ((c * N) % 32);
        return make_uint4(v[0], v[1], v[2], v[3]);
    }
}

template <int N, int K, bool VEC>
__global__ void __launch_bounds__(ST_NT)
stream_kernel(const float* __restrict__ x, const wire::WordT<N>* __restrict__ w,
              float* __restrict__ out, int M, int Kd, int Ncols, int krows) {
    using P = Stream<N>;
    using C = wire::Codec<N, K>;
    constexpr int CW = P::CW, MC = P::MC;
    extern __shared__ float4 smem4[];
    float* red = reinterpret_cast<float*>(smem4);   // the warps' tree sum
    float* xs = red + ST_RED;                       // [MC][krows]
    __shared__ typename C::Tab tab;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int n0 = blockIdx.x * P::BN + lane * CW;
    const int m0 = blockIdx.y * MC;
    const int k0 = blockIdx.z * krows;
    const int kr = min(Kd - k0, krows);
    tab.fill(tid, ST_NT);
    for (int i = tid; i < MC * krows; i += ST_NT) {
        const int m = i / krows, kk = i % krows;
        xs[i] = (m0 + m < M && kk < kr) ? x[(size_t)(m0 + m) * Kd + k0 + kk]
                                        : 0.0f;
    }
    __syncthreads();

    float acc[MC][CW];
#pragma unroll
    for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[m][c] = 0.0f;
    const bool cols = n0 < Ncols;
    const int nrows = kr > warp ? (kr - warp + 7) / 8 : 0;   // this warp's
    auto load = [&](uint4 (&v)[ST_U], int i0) {
#pragma unroll
        for (int u = 0; u < ST_U; ++u)
            v[u] = (cols && i0 + u < nrows)
                ? load_row<N, VEC>(w, k0 + warp + 8 * (i0 + u), n0, Ncols)
                : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 cur[ST_U], nxt[ST_U] = {};
    load(cur, 0);
    for (int i0 = 0; i0 < nrows; i0 += ST_U) {
        if (i0 + ST_U < nrows) load(nxt, i0 + ST_U);
#pragma unroll
        for (int u = 0; u < ST_U; ++u) {
            if (i0 + u >= nrows) break;
            const int kk = warp + 8 * (i0 + u);
            float xv[MC];
#pragma unroll
            for (int m = 0; m < MC; ++m) xv[m] = xs[m * krows + kk];
            const uint32_t words[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
#pragma unroll
            for (int c = 0; c < CW; ++c) {
                const uint32_t wd = (words[c * N / 32] >> ((c * N) % 32))
                                    & ((1u << N) - 1u);
                const float wv = C::decode(wd, tab);
#pragma unroll
                for (int m = 0; m < MC; ++m)
                    acc[m][c] = fmaf(xv[m], wv, acc[m][c]);
            }
        }
#pragma unroll
        for (int u = 0; u < ST_U; ++u) cur[u] = nxt[u];
    }

    // the 8 warps' sums in a fixed tree: (w, w + 4), then (w, w + 2), then
    // (0, 1), through shared memory
#pragma unroll
    for (int half = 4; half >= 1; half /= 2) {
        __syncthreads();
        if (warp >= half && warp < 2 * half)
#pragma unroll
            for (int e = 0; e < MC * CW; ++e)
                red[((warp - half) * 64 + e) * 32 + lane] = acc[e / CW][e % CW];
        __syncthreads();
        if (warp < half)
#pragma unroll
            for (int e = 0; e < MC * CW; ++e)
                acc[e / CW][e % CW] += red[(warp * 64 + e) * 32 + lane];
    }
    if (warp != 0 || !cols) return;
    float* dst = out + (size_t)blockIdx.z * M * Ncols;
#pragma unroll
    for (int m = 0; m < MC; ++m) {
        if (m0 + m >= M) break;
        float* o = dst + (size_t)(m0 + m) * Ncols + n0;
        if (VEC) {
#pragma unroll
            for (int c = 0; c < CW; c += 4)
                *reinterpret_cast<float4*>(o + c) = make_float4(
                    acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
        } else {
#pragma unroll
            for (int c = 0; c < CW; ++c)
                if (n0 + c < Ncols) o[c] = acc[m][c];
        }
    }
}

// -- variant 1: prefill chunks ----------------------------------------------

constexpr int TB_N = 128, TB_K = 32, PROMOTE_K = 128;

template <int N, int K>
struct Tile {
    // words decoded once per block and shared by BM rows (see the header)
    static constexpr int BM = N == 16 ? 128 : 64;
    static constexpr int NT = 2 * BM;         // warps of 32 x 64: BM / 32 x 2
    // decoded weights exact in TF32 (8-bit words) are stored as they are;
    // the others as their TF32 hi and lo parts, split once per block
    static constexpr bool EXACT = wire::Codec<N, K>::TF32_EXACT;
    static constexpr int XS = TB_K + 4;       // x row stride: conflict-free A reads
    static constexpr int WS = TB_N + 8;       // decoded row stride: conflict-free B reads
    static constexpr int WB = TB_N * N / 8;   // bytes of one weight row of the tile
    static constexpr int X_FLOATS = BM * XS;              // one stage
    static constexpr int W_FLOATS = TB_K * WS;            // hi (or the value)
    static constexpr int RAW = TB_K * WB;                 // one stage, bytes
    static constexpr size_t bytes() {
        return sizeof(float) * (2 * X_FLOATS + (EXACT ? 1 : 2) * W_FLOATS)
            + 2 * RAW;
    }
};

// One K tile of a warp's 32 x 64 products: 2 x 8 m16n8 fragments, the
// x tile xt [BM][XS] split per use, the decoded words ws [TB_K][WS] (and,
// where they are not exact in TF32, ws holds their hi and wl their lo
// parts as TF32 bit patterns). GUARD: the tile holds a non-finite weight
// (the small products then read it as 0, tf32.cuh); without one, that
// guard is skipped. x takes the guarded split always: testing each x tile
// as well (as contiguous attention tests q and K/V) made three of the
// four prefill shapes slower on the H100 (PERF.md).
template <class T, bool GUARD>
__device__ __forceinline__ void tile_mma(float (&part)[2][8][4],
                                         const float* xt, const float* ws,
                                         const float* wl, int wm, int wn,
                                         int g, int t) {
#pragma unroll
    for (int k8 = 0; k8 < TB_K; k8 += 8) {
        tf32::Frag<4> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float* xr = xt + (32 * wm + 16 * i + g) * T::XS + k8 + t;
            tf32::set<false>(a[i], 0, xr[0]);
            tf32::set<false>(a[i], 1, xr[8 * T::XS]);
            tf32::set<false>(a[i], 2, xr[4]);
            tf32::set<false>(a[i], 3, xr[8 * T::XS + 4]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int o = (k8 + t) * T::WS + 64 * wn + 8 * j + g;
            tf32::Frag<2> bw;
            if constexpr (T::EXACT) {
                tf32::set<true, 2, GUARD>(bw, 0, ws[o]);
                tf32::set<true, 2, GUARD>(bw, 1, ws[o + 4 * T::WS]);
            } else {
                tf32::set_split<2, GUARD>(bw, 0, ws[o], wl[o]);
                tf32::set_split<2, GUARD>(bw, 1, ws[o + 4 * T::WS],
                                          wl[o + 4 * T::WS]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
                tf32::mma3<T::EXACT>(part[i][j], a[i], bw);
        }
    }
}

template <int N, int K, bool VEC>
__global__ void __launch_bounds__(Tile<N, K>::NT)
tc_kernel(const float* __restrict__ x, const wire::WordT<N>* __restrict__ w,
          float* __restrict__ out, int M, int Kd, int Ncols,
          int kt_per_split) {
    using T = Tile<N, K>;
    using C = wire::Codec<N, K>;
    constexpr int BM = T::BM, NT = T::NT;
    constexpr int CWB = 16 * 8 / N;          // words of a 16-byte chunk
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);                // [2][BM][XS]
    __shared__ typename C::Tab tab;
    float* ws = xs + 2 * T::X_FLOATS;                           // [TB_K][WS]
    float* wl = ws + T::W_FLOATS;          // [TB_K][WS], split words only
    uint8_t* raw = reinterpret_cast<uint8_t*>(
        ws + (T::EXACT ? 1 : 2) * T::W_FLOATS);                 // [2][TB_K][WB]
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = warp / 2, wn = warp % 2;     // warp tile: 32 rows x 64 columns
    const int n0 = blockIdx.x * TB_N, m0 = blockIdx.y * BM;
    const int kt_total = (Kd + TB_K - 1) / TB_K;
    const int kt0 = blockIdx.z * kt_per_split;
    const int kt1 = min(kt0 + kt_per_split, kt_total);
    tab.fill(tid, NT);
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);

    // K tile kt of x and of the words into stage kt % 2 (zeros outside)
    auto issue = [&](int kt) {
        const int kb = kt * TB_K;
        float* xd = xs + (kt % 2) * T::X_FLOATS;
        uint8_t* rd = raw + (kt % 2) * T::RAW;
        if constexpr (VEC) {
            for (int c = tid; c < BM * TB_K / 4; c += NT) {
                const int r = c / (TB_K / 4), q = c % (TB_K / 4);
                const int gm = m0 + r, gk = kb + 4 * q;
                const bool ok = gm < M && gk < Kd;
                tf32::cp_async16(xd + r * T::XS + 4 * q,
                                 ok ? x + (size_t)gm * Kd + gk : x, ok ? 16 : 0);
            }
            for (int c = tid; c < TB_K * T::WB / 16; c += NT) {
                const int r = c / (T::WB / 16), q = c % (T::WB / 16);
                const int gk = kb + r, gn = n0 + q * CWB;
                const bool ok = gk < Kd && gn < Ncols;
                tf32::cp_async16(rd + r * T::WB + 16 * q,
                                 ok ? wb + ((size_t)gk * Ncols + gn) * (N / 8)
                                    : wb, ok ? 16 : 0);
            }
            tf32::cp_commit();
        } else {
            for (int i = tid; i < BM * TB_K; i += NT) {
                const int r = i / TB_K, kk = i % TB_K;
                const int gm = m0 + r, gk = kb + kk;
                xd[r * T::XS + kk] = (gm < M && gk < Kd)
                    ? x[(size_t)gm * Kd + gk] : 0.0f;
            }
            wire::WordT<N>* rw = reinterpret_cast<wire::WordT<N>*>(rd);
            for (int i = tid; i < TB_K * TB_N; i += NT) {
                const int r = i / TB_N, nn = i % TB_N;
                const int gk = kb + r, gn = n0 + nn;
                rw[i] = (gk < Kd && gn < Ncols) ? w[(size_t)gk * Ncols + gn]
                                                : (wire::WordT<N>)0;
            }
        }
    };

    float total[2][8][4], part[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) total[i][j][e] = part[i][j][e] = 0.f;

    if (kt0 < kt1) issue(kt0);
    for (int kt = kt0; kt < kt1; ++kt) {
        if (VEC) tf32::cp_wait_all();
        __syncthreads();   // stage kt visible; the previous tile's reads done
        if (kt + 1 < kt1) issue(kt + 1);
        const uint8_t* rs = raw + (kt % 2) * T::RAW;
        float probe = 0.0f;
        for (int u = tid; u < TB_K * TB_N / 4; u += NT) {
            const int r = u / (TB_N / 4), n4 = u % (TB_N / 4);
            uint32_t wd[4];
            wire::unpack4<N>(rs + r * T::WB + n4 * N / 2, wd);
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                v[e] = C::decode(wd[e], tab);
                probe = tf32::nonfinite_probe(probe, v[e]);
            }
            const int o = r * T::WS + 4 * n4;
            if constexpr (T::EXACT) {
                *reinterpret_cast<float4*>(ws + o) =
                    make_float4(v[0], v[1], v[2], v[3]);
            } else {
                uint32_t h[4], l[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) tf32::split(v[e], h[e], l[e]);
                *reinterpret_cast<uint4*>(ws + o) =
                    make_uint4(h[0], h[1], h[2], h[3]);
                *reinterpret_cast<uint4*>(wl + o) =
                    make_uint4(l[0], l[1], l[2], l[3]);
            }
        }
        // decoded tile ready; whether it holds an inf or NaN (NaR) weight
        const bool special = __syncthreads_or(probe != 0.0f)
                             || TF32_GUARD_ALWAYS;
        const float* xt = xs + (kt % 2) * T::X_FLOATS;
        if (special) tile_mma<T, true>(part, xt, ws, wl, wm, wn, g, t);
        else tile_mma<T, false>(part, xt, ws, wl, wm, wn, g, t);
        if ((kt - kt0 + 1) % (PROMOTE_K / TB_K) == 0 || kt + 1 == kt1) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        total[i][j][e] += part[i][j][e];
                        part[i][j][e] = 0.f;
                    }
        }
    }

    float* dst = out + (size_t)blockIdx.z * M * Ncols;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
            const int m = m0 + 32 * wm + 16 * i + g + 8 * e2;
            if (m >= M) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int n = n0 + 64 * wn + 8 * j + 2 * t;
                if (n < Ncols) dst[(size_t)m * Ncols + n] = total[i][j][2 * e2];
                if (n + 1 < Ncols)
                    dst[(size_t)m * Ncols + n + 1] = total[i][j][2 * e2 + 1];
            }
        }
}

template <class Kern>
int prepare(Kern kern, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int N, int K>
int launch_fmt(int variant, const float* x, const void* w, float* out,
               float* work, int M, int Kd, int Ncols, int split,
               int kt_per_split, cudaStream_t st) {
    using Word = wire::WordT<N>;
    const bool wvec = (size_t)Ncols * N / 8 % 16 == 0
        && (uintptr_t)w % 16 == 0;
    float* dst = split > 1 ? work : out;
    int err;
    if (variant == 0) {
        using P = Stream<N>;
        const int krows = kt_per_split * 32;
        const size_t smem = sizeof(float) * (ST_RED + P::MC * krows);
        dim3 grid((Ncols + P::BN - 1) / P::BN, (M + P::MC - 1) / P::MC, split);
        auto kern = wvec ? stream_kernel<N, K, true> : stream_kernel<N, K, false>;
        if ((err = prepare(kern, smem))) return err;
        kern<<<grid, ST_NT, smem, st>>>(x, (const Word*)w, dst, M, Kd, Ncols,
                                        krows);
    } else {
        const bool vec = wvec && Kd % 4 == 0 && (uintptr_t)x % 16 == 0;
        using T = Tile<N, K>;
        const size_t smem = T::bytes();
        dim3 grid((Ncols + TB_N - 1) / TB_N, (M + T::BM - 1) / T::BM, split);
        auto kern = vec ? tc_kernel<N, K, true> : tc_kernel<N, K, false>;
        if ((err = prepare(kern, smem))) return err;
        kern<<<grid, T::NT, smem, st>>>(x, (const Word*)w, dst, M, Kd, Ncols,
                                        kt_per_split);
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

}  // namespace

// n: 8 or 16; kind: the format code of wire.cuh (0 linear takum, 2 posit,
// 3 posit8 through the table). variant 0: the streaming kernel (M <= 16);
// variant 1: the tensor-core kernel. K is split into `split` ranges of
// kt_per_split tiles of 32 rows; with split > 1, `work` holds
// split * M * Ncols floats of partial sums, added in a fixed order.
extern "C" int takum_qmatmul(int n, int kind, int variant, const float* x,
                             const void* w, float* out, float* work, int M,
                             int K, int Ncols, int split, int kt_per_split,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M <= 0 || Ncols <= 0) return (int)cudaGetLastError();
    if ((variant != 0 && variant != 1) || K < 0 || split < 1
        || kt_per_split < 1 || (variant == 0 && M > 16)
        || (variant == 0 && kt_per_split * 32 * (n == 8 ? 4 : 8) > 8192))
        return (int)cudaErrorInvalidValue;
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK)                                              \
        return launch_fmt<NN, KK>(variant, x, w, out, work, M, K, Ncols,    \
                                  split, kt_per_split, st);
    WIRE_DENSE_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}
