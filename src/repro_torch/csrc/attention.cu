// Flash attention over a paged wire KV pool: one decode step.
//
// Replaces src/repro/kernels/takum_attention.py::paged_attention_kernel_call
// (_paged_attn_tile, _paged_kv_index). The contiguous-cache kernel of a
// prefill chunk is flash_attention.cu.
//
// What bounds it on the H100: the decode step reads each in-band KV word
// once (1 or 2 bytes, 3.35 TB/s; 2 or 4 for a float cache) for a few FLOPs
// per word: bytes. The design keeps full-precision K/V out of device
// memory altogether: words are decoded page by page into shared memory
// inside the online-softmax loop, as on the TPU.
//
// Layout: q4 [B, Hkv, rows, hd] f32 with rows = G (the query heads of one
// KV head at the sequence's position); the pool [P, ps, Hkv, hd] words with
// a [B, NP] int32 block table; out [B, Hkv, rows, hd] f32.
//
// Grid (row tiles, Hkv, B). A block holds BQ query rows in shared memory
// and loops over the in-band pages only: pages past min(pos[b] / ps,
// NP - 1) are never read, and with a window the pages wholly before the
// window floor are skipped. Inside a page, keys run in sub-tiles of BKV;
// every key of an in-band page takes part, masked or not, exactly as in
// the Pallas kernel:
// * masked scores become the finite MASKED = -1e30 before the row max, so
//   all-masked rows stay finite and stale NaR words past pos never reach
//   the running max;
// * the running max propagates NaN (a NaR K word at a valid position
//   poisons its row), unlike fmaxf;
// * masked keys still enter p @ v with p = 0, so a NaR V word anywhere in
//   an in-band page poisons the rows of that page, as in the reference;
// * scale = hd^-0.5 multiplies after the dot; out = acc / max(l, 1e-30);
//   expf, not __expf.
//
// KV words are linear takum, logarithmic takum (one expf per word), posit
// (computed, or posit8 through the 256-entry table that each block builds in
// shared memory at its start) or the identity codec's bf16 / f32 floats
// (a cast), chosen by the format-kind template argument K of
// wire::Codec<N, K>, as the Pallas tile bodies call the format's
// decode_tile. An LNS decode step adds one expf per word it reads, which
// does not move the byte bound.
#include <cuda_runtime.h>
#include <math.h>
#include "wire.cuh"

namespace {

constexpr float MASKED = -1e30f;

__device__ __forceinline__ float nanmax(float a, float b) {
    return (a != a || b != b) ? __uint_as_float(0x7FC00000u) : fmaxf(a, b);
}

template <int N, int K, int HD, int BQ, int TPR, int BKV>
__global__ void __launch_bounds__(BQ * TPR)
attn_kernel(const float* __restrict__ q4, const wire::WordT<N>* __restrict__ kw,
            const wire::WordT<N>* __restrict__ vw, float* __restrict__ out,
            const int* __restrict__ pos_v, const int* __restrict__ start_v,
            const int* __restrict__ table, int Hkv, int rows, int ps, int npg,
            int window, float scale) {
    constexpr int NT = BQ * TPR;
    constexpr int KPT = BKV / TPR;       // keys per thread (scores)
    constexpr int CPT = HD / TPR;        // output columns per thread
    constexpr int QS = HD + 1;           // padded shared-memory row stride
    constexpr int PS = BKV + 1;
    extern __shared__ float smem[];
    float* qs = smem;                    // [BQ][QS]
    float* ks = qs + BQ * QS;            // [BKV][QS]
    float* vs = ks + BKV * QS;           // [BKV][HD]
    float* ps_ = vs + BKV * HD;          // [BQ][PS]
    using C = wire::Codec<N, K>;
    __shared__ typename C::Tab tab;      // read after the first barrier

    const int tid = threadIdx.x;
    tab.fill(tid, NT);
    const int rl = tid / TPR, cg = tid % TPR;
    const int row0 = blockIdx.x * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int row = row0 + rl;

    for (int i = tid; i < BQ * HD; i += NT) {
        const int r = i / HD, d = i % HD;
        const int gr = row0 + r;
        qs[r * QS + d] = gr < rows ? q4[(((size_t)b * Hkv + h) * rows + gr) * HD + d] : 0.0f;
    }

    const int pos = pos_v[b];            // every row's query position
    const int start = start_v[b];
    int last = pos / ps;
    if (last > npg - 1) last = npg - 1;

    float m = MASKED, l = 0.0f;
    float acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;

    for (int kk = 0; kk <= last; ++kk) {
        if (window && !((kk + 1) * ps - 1 > pos - window)) continue;
        const int page = table[(size_t)b * npg + kk];
        for (int s0 = 0; s0 < ps; s0 += BKV) {
            __syncthreads();   // the previous sub-tile's reads are done
            for (int i = tid; i < BKV * HD; i += NT) {
                const int j = i / HD, d = i % HD;
                const int off = s0 + j;
                float kv = 0.0f, vv = 0.0f;
                if (off < ps) {
                    const size_t idx = (((size_t)page * ps + off) * Hkv + h)
                                       * HD + d;
                    kv = C::decode(kw[idx], tab);
                    vv = C::decode(vw[idx], tab);
                }
                ks[j * QS + d] = kv;
                vs[j * HD + d] = vv;
            }
            __syncthreads();

            float sc[KPT];
#pragma unroll
            for (int jj = 0; jj < KPT; ++jj) sc[jj] = 0.0f;
            for (int d = 0; d < HD; ++d) {
                const float qd = qs[rl * QS + d];
#pragma unroll
                for (int jj = 0; jj < KPT; ++jj)
                    sc[jj] = fmaf(qd, ks[(jj * TPR + cg) * QS + d], sc[jj]);
            }
            float tmax = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < KPT; ++jj) {
                const int off = s0 + jj * TPR + cg;
                if (off >= ps) {
                    sc[jj] = -INFINITY;            // not a key of this page
                } else {
                    const int kpos = kk * ps + off;
                    bool msk = kpos <= pos && kpos >= start;
                    if (window) msk = msk && kpos > pos - window;
                    sc[jj] = msk ? sc[jj] * scale : MASKED;
                }
                tmax = nanmax(tmax, sc[jj]);
            }
#pragma unroll
            for (int o = TPR / 2; o > 0; o >>= 1)
                tmax = nanmax(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
            const float m_new = nanmax(m, tmax);
            const float corr = expf(m - m_new);
            float psum = 0.0f;
#pragma unroll
            for (int jj = 0; jj < KPT; ++jj) {
                const float p = expf(sc[jj] - m_new);
                ps_[rl * PS + jj * TPR + cg] = p;
                psum += p;
            }
#pragma unroll
            for (int o = TPR / 2; o > 0; o >>= 1)
                psum += __shfl_xor_sync(0xffffffffu, psum, o);
            l = l * corr + psum;
            m = m_new;
            __syncthreads();
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[c] *= corr;
            for (int j = 0; j < BKV; ++j) {
                const float p = ps_[rl * PS + j];
#pragma unroll
                for (int c = 0; c < CPT; ++c)
                    acc[c] = fmaf(p, vs[j * HD + c * TPR + cg], acc[c]);
            }
        }
    }
    if (row < rows) {
        const float denom = nanmax(l, 1e-30f);
        float* o = out + (((size_t)b * Hkv + h) * rows + row) * HD;
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[c * TPR + cg] = acc[c] / denom;
    }
}

template <int N, int K, int HD, int BQ, int TPR, int BKV>
int launch(const float* q4, const void* kw, const void* vw, float* out,
           const int* pos_v, const int* start_v, const int* table, int B,
           int Hkv, int rows, int ps, int npg, int window, float scale,
           cudaStream_t st) {
    constexpr int QS = HD + 1;
    const size_t smem = sizeof(float) *
        (BQ * QS + BKV * QS + BKV * HD + BQ * (BKV + 1));
    auto kern = attn_kernel<N, K, HD, BQ, TPR, BKV>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((rows + BQ - 1) / BQ, Hkv, B);
    kern<<<grid, BQ * TPR, smem, st>>>(
        q4, (const wire::WordT<N>*)kw, (const wire::WordT<N>*)vw, out,
        pos_v, start_v, table, Hkv, rows, ps, npg, window, scale);
    return (int)cudaGetLastError();
}

// Decode steps: 8 rows x min(32, hd) threads per row.
template <int N, int K>
int dispatch_hd(int hd, const float* q4, const void* kw, const void* vw,
                float* out, const int* pos_v, const int* start_v,
                const int* table, int B, int Hkv, int rows, int ps, int npg,
                int window, float scale, cudaStream_t st) {
#define ARGS q4, kw, vw, out, pos_v, start_v, table, B, Hkv, rows, ps, npg, \
             window, scale, st
    switch (hd) {
        case 16: return launch<N, K, 16, 8, 16, 32>(ARGS);
        case 32: return launch<N, K, 32, 8, 32, 32>(ARGS);
        case 64: return launch<N, K, 64, 8, 32, 32>(ARGS);
        case 128: return launch<N, K, 128, 8, 32, 32>(ARGS);
    }
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// n: word width in bits (8, 16, or 32 for f32 identity words); kind: the
// format code of wire.cuh (0 linear takum, 1 logarithmic takum, 2 posit,
// 3 posit8 through the table, 4 identity: bf16 at n = 16, f32 at n = 32).
// Pool kw/vw [P, ps, Hkv, hd]; pos/start [B]; table [B, npg].
extern "C" int takum_paged_attention(int n, int kind, int hd, const float* q4,
                                     const void* kw, const void* vw,
                                     float* out, const int* pos,
                                     const int* start, const int* table,
                                     int B, int Hkv, int rows, int ps,
                                     int npg, int window, float scale,
                                     void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (B <= 0 || rows <= 0) return (int)cudaGetLastError();
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK)                                              \
        return dispatch_hd<NN, KK>(hd, q4, kw, vw, out, pos, start, table,  \
                                   B, Hkv, rows, ps, npg, window, scale, st);
    WIRE_KV_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}
