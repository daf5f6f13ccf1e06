// Flash-decoding attention over a paged wire KV pool: one decode step.
//
// Replaces src/repro/kernels/takum_attention.py::paged_attention_kernel_call
// (_paged_attn_tile, _paged_kv_index). The contiguous-cache kernel of a
// prefill chunk is flash_attention.cu.
//
// What bounds it on the H100: the decode step reads each in-band KV word
// once (1 or 2 bytes, 3.35 TB/s; 2 or 4 for a float cache) for a few FLOPs
// per word: bytes. At serving sizes those bytes take a few microseconds, so
// what the design has to beat is latency: a decode step has only B x Hkv
// (sequence, KV head) pairs (40 at phi3-medium-14b's batch of 4), and one
// block walking a sequence's pages in turn leaves most SMs idle.
//
// Layout: q4 [B, Hkv, rows, hd] f32 with rows = G (the query heads of one
// KV head at the sequence's position); the pool [P, ps, Hkv, hd] words with
// a [B, NP] int32 block table; out [B, Hkv, rows, hd] f32.
//
// Design:
// * Partitions, as in flash-decoding. Sequence b's in-band keys are those
//   of its pages first..last: last = min(pos / ps, NP - 1) (pages past it
//   are never read), first = 0, or with a window the first page not wholly
//   before the window floor. They are cut into partitions of PK keys in
//   order (repro_torch/kernels/takum_attention.py::paged_partitions is the
//   same plan in Python). attn_kernel's grid is (partition, Hkv, B) with as
//   many partitions as the widest table could need; a block past its
//   sequence's last partition returns at once. A block computes its
//   partition's partial online-softmax state for every row of its KV head:
//   the max m, the sum l of exp(s - m) and acc = sum exp(s - m) v, into a
//   workspace, and counts itself done on an atomic counter of its (b, h).
//   The block that finds itself last merges the (b, h)'s partitions in
//   partition order: M = the NaN-propagating max of the m, and l and acc
//   summed with weights exp(m - M), out = acc / max(l, 1e-30), and resets
//   the counter for the next call. A sequence with no in-band page gets 0.
//   One launch; the result does not depend on which block is last.
// * All rows of the KV head in one block (rows = G = 4 at phi3's GQA:
//   every thread works on real rows; more rows run in chunks of 4).
// * Each key's hd words are read as 16-byte cp.async copies (LPK lanes a
//   key: 8 for takum8 at hd 128, 16 for 16-bit words, 32 for f32), every
//   copy of the block issued at its start into shared memory (8192 K
//   words and as many V words a partition at a power-of-two hd: PK =
//   8192 / hd keys; see Geo for the other head dims), each
//   lane reading back only what it copied, and decoded in registers
//   (wire::Codec, the 8-bit tables in shared memory). Staging the words
//   there rather than in registers keeps a block under 128 registers (4
//   blocks an SM). A dot product's partial sums meet across the key's
//   lanes by warp shuffles, and so do the p v sums of the keys a warp
//   holds; the 4 warps meet once in shared memory.
// Every key of an in-band page takes part, masked or not, exactly as in
// the Pallas kernel and in the unsplit online softmax:
// * masked scores become the finite MASKED = -1e30 before the max, so
//   all-masked rows stay finite, stale NaR words past pos never reach the
//   max, and a partition whose keys are all masked has m = MASKED: merged
//   with a partition of valid keys it weighs exp(MASKED - M) = 0, and in an
//   all-masked row every partition weighs exp(0) = 1, so the row averages V
//   over the visited keys as the unsplit kernel does;
// * the max propagates NaN, in the merge too (a NaR K word at a valid
//   position poisons its row), unlike fmaxf;
// * masked keys still enter p v (p = 0 in a row with a valid key), so a NaR
//   V word anywhere in an in-band page poisons the rows of that page, as in
//   the reference (0 x NaN, in the partition or in the merge's weight);
// * scale = hd^-0.5 multiplies after the dot; expf, not __expf.
//
// KV words are linear takum, logarithmic takum (one expf per word), posit
// (computed, or posit8 through the 256-entry table that each block builds in
// shared memory at its start) or the identity codec's bf16 / f32 floats
// (a cast), chosen by the format-kind template argument K of
// wire::Codec<N, K>, as the Pallas tile bodies call the format's
// decode_tile.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <algorithm>
#include "tf32.cuh"
#include "wire.cuh"

namespace {

constexpr float MASKED = -1e30f;
constexpr int NWARP = 4, NT = 32 * NWARP;
constexpr int RB = 4;        // rows of a chunk

__device__ __forceinline__ float nanmax(float a, float b) {
    return (a != a || b != b) ? __uint_as_float(0x7FC00000u) : fmaxf(a, b);
}

// The partition geometry of hd-wide keys of N-bit words. A key is LPK
// lanes of 16 bytes; a warp holds KPW = 32 / LPK whole keys (rounded
// down: at hd 112, 7 lanes a takum8 key and 4 keys a warp, lanes 28-31
// idle; a power-of-two hd leaves no lane idle). Each lane loads SLOTS
// 16-byte pieces of K and as many of V, so a partition is PK = SLOTS x
// NWARP x KPW keys: 8192 / hd at a power-of-two hd, 64 at hd 112 and 32
// at hd 192 for every word width (hd 192: 12 lanes a takum8 key, 2 keys a
// warp, 8 lanes idle; 24 lanes a 16-bit key, one a warp). Another hd that
// is a multiple of 16 needs only its case line in dispatch_hd (and shared
// memory within the card's limit) as long as a key fits one warp (LPK <=
// 32: hd * N <= 4096).
template <int N, int HD>
struct Geo {
    static constexpr int LPK = HD * N / 128;    // lanes a key (16 bytes each)
    static constexpr int WPL = HD / LPK;        // words a lane holds of a key
    static constexpr int KPW = 32 / LPK;        // keys a warp loads at once
    static constexpr int KB = NWARP * KPW;      // keys a block loads at once
    static constexpr int SLOTS = 4 * N / 8;     // loads a lane, of K and of V
    static constexpr int PK = SLOTS * KB;       // keys of a partition
    static constexpr int RAW = SLOTS * NT * 16; // bytes of K (and of V) words
    static constexpr bool POW2 = (LPK & (LPK - 1)) == 0;
    // the largest power of two below KPW: the first step of the tree sum
    // over a warp's keys
    static constexpr int KTOP = KPW > 16 ? 16 : KPW > 8 ? 8
                              : KPW > 4 ? 4 : KPW > 2 ? 2 : 1;
    static_assert(HD * N % 128 == 0 && LPK >= 1 && LPK <= 32
                  && WPL * N == 128 && WPL % 4 == 0, "geometry");
};

// Sum over the LPK lanes of each key (lanes kslot * LPK .. + LPK - 1):
// every lane gets it by butterflies when LPK is a power of two; otherwise
// a tree by shuffles down, whose total lands on the key's first lane.
template <int LPK, int R>
__device__ __forceinline__ void key_sum(float (&v)[R], int part) {
    if constexpr ((LPK & (LPK - 1)) == 0) {
#pragma unroll
        for (int o = LPK / 2; o > 0; o /= 2)
#pragma unroll
            for (int r = 0; r < R; ++r)
                v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
    } else {
#pragma unroll
        for (int o = 16; o > 0; o /= 2) {
            if (o >= LPK) continue;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float u = __shfl_down_sync(0xffffffffu, v[r], o);
                if (part + o < LPK) v[r] += u;
            }
        }
    }
}

// The in-band pages of a sequence at `pos`: first..last (first > last:
// none); returns its number of partitions of pk keys.
__device__ __forceinline__ int band(int pos, int ps, int npg, int window,
                                    int pk, int& first, int& last) {
    last = pos / ps;
    if (last > npg - 1) last = npg - 1;
    first = 0;
    if (window) {
        first = (pos - window + 1) / ps;
        if (first < 0) first = 0;
    }
    if (first > last) return 0;
    return ((last - first + 1) * ps + pk - 1) / pk;
}

template <int N, int K, int HD>
__global__ void __launch_bounds__(NT)
attn_kernel(const float* __restrict__ q4, const wire::WordT<N>* __restrict__ kw,
            const wire::WordT<N>* __restrict__ vw, float* __restrict__ part_acc,
            float* __restrict__ part_ml, float* __restrict__ out,
            int* __restrict__ counter, const int* __restrict__ pos_v,
            const int* __restrict__ start_v, const int* __restrict__ table,
            int Hkv, int rows, int ps, int npg, int window, float scale) {
    using G = Geo<N, HD>;
    using C = wire::Codec<N, K>;
    constexpr int LPK = G::LPK, WPL = G::WPL, KPW = G::KPW, PK = G::PK;
    __shared__ typename C::Tab tab;
    __shared__ __align__(16) float qs[RB][HD];
    __shared__ float sc[RB][PK];
    __shared__ float red[NWARP][RB][HD];
    extern __shared__ uint4 dyn[];
    uint4* kraw = dyn;                       // [SLOTS][NT]: this thread's
    uint4* vraw = dyn + G::SLOTS * NT;       // K and V words, 16 bytes a slot
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int nparts_all = gridDim.x;
    const int pos = pos_v[b], start = start_v[b];
    int first, last;
    const int nparts = band(pos, ps, npg, window, PK, first, last);
    const size_t bh = (size_t)b * Hkv + h;
    if (p >= nparts) {
        if (nparts == 0 && p == 0)         // no in-band page: 0
            for (int i = tid; i < rows * HD; i += NT) out[bh * rows * HD + i] = 0.0f;
        return;
    }
    const int k0 = first * ps + p * PK;
    const int k1 = min(k0 + PK, (last + 1) * ps);
    const int kslot = lane / LPK, part = lane % LPK;
    // key c of slot s of this thread (c >= k1: none; an idle lane, past
    // the warp's KPW keys, holds none)
    auto key = [&](int s) {
        return kslot < KPW ? k0 + s * G::KB + warp * KPW + kslot : k1;
    };

    // every K and V load of the block, at once, straight into shared memory
#pragma unroll
    for (int s = 0; s < G::SLOTS; ++s) {
        const int c = key(s);
        const wire::WordT<N>* kp = kw;
        const wire::WordT<N>* vp = vw;
        if (c < k1) {
            const int page = table[(size_t)b * npg + c / ps];
            const size_t idx = (((size_t)page * ps + c % ps) * Hkv + h) * HD
                               + part * WPL;
            kp += idx;
            vp += idx;
        }
        tf32::cp_async16(kraw + s * NT + tid, kp, c < k1 ? 16 : 0);
        tf32::cp_async16(vraw + s * NT + tid, vp, c < k1 ? 16 : 0);
    }
    tf32::cp_commit();
    tab.fill(tid, NT);

    for (int r0 = 0; r0 < rows; r0 += RB) {
        __syncthreads();     // the previous chunk's reads of qs, sc, red
        for (int i = tid; i < RB * HD; i += NT) {
            const int r = i / HD, d = i % HD;
            qs[r][d] = r0 + r < rows
                ? q4[((bh * rows) + r0 + r) * HD + d] : 0.0f;
        }
        tf32::cp_wait_all();
        __syncthreads();

        // scores: each lane dots its WPL words with the rows' q, the key's
        // LPK lanes add their partial dots by shuffles
#pragma unroll 1
        for (int s = 0; s < G::SLOTS; ++s) {
            const uint4 kv4 = kraw[s * NT + tid];
            float dot[RB];
#pragma unroll
            for (int r = 0; r < RB; ++r) dot[r] = 0.0f;
#pragma unroll
            for (int e = 0; e < WPL; e += 4) {
                float kv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    kv[j] = C::decode(wire::word_of<N>(kv4, e + j), tab);
#pragma unroll
                for (int r = 0; r < RB; ++r) {
                    const float4 qv = *reinterpret_cast<const float4*>(
                        &qs[r][part * WPL + e]);
                    dot[r] = fmaf(qv.x, kv[0], dot[r]);
                    dot[r] = fmaf(qv.y, kv[1], dot[r]);
                    dot[r] = fmaf(qv.z, kv[2], dot[r]);
                    dot[r] = fmaf(qv.w, kv[3], dot[r]);
                }
            }
            key_sum<LPK>(dot, part);
            const int c = key(s);
            if (part == 0 && c < k1) {
                bool msk = c <= pos && c >= start;
                if (window) msk = msk && c > pos - window;
#pragma unroll
                for (int r = 0; r < RB; ++r)
                    sc[r][c - k0] = msk ? dot[r] * scale : MASKED;
            }
        }
        __syncthreads();

        // the partition's max and sum, row r by warp r; p = exp(s - m)
        const int nk = k1 - k0;
        for (int r = warp; r < RB; r += NWARP) {
            float m = MASKED;
            for (int j = lane; j < nk; j += 32) m = nanmax(m, sc[r][j]);
#pragma unroll
            for (int o = 16; o > 0; o /= 2)
                m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
            float l = 0.0f;
            for (int j = lane; j < nk; j += 32) {
                const float pj = expf(sc[r][j] - m);
                sc[r][j] = pj;
                l += pj;
            }
#pragma unroll
            for (int o = 16; o > 0; o /= 2)
                l += __shfl_xor_sync(0xffffffffu, l, o);
            if (lane == 0 && r0 + r < rows) {
                float* ml = part_ml + ((bh * nparts_all + p) * rows + r0 + r)
                                     * 2;
                ml[0] = m;
                ml[1] = l;
            }
        }
        __syncthreads();

        // p v: each lane its keys' WPL columns, then the warp's keys by
        // shuffles, then the 4 warps in order
        float acc[RB][WPL];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int e = 0; e < WPL; ++e) acc[r][e] = 0.0f;
#pragma unroll 1
        for (int s = 0; s < G::SLOTS; ++s) {
            const int c = key(s);
            if (c >= k1) continue;
            const uint4 vv4 = vraw[s * NT + tid];
            float pr[RB];
#pragma unroll
            for (int r = 0; r < RB; ++r) pr[r] = sc[r][c - k0];
#pragma unroll
            for (int e = 0; e < WPL; ++e) {
                const float vv = C::decode(wire::word_of<N>(vv4, e), tab);
#pragma unroll
                for (int r = 0; r < RB; ++r)
                    acc[r][e] = fmaf(pr[r], vv, acc[r][e]);
            }
        }
        if constexpr (G::POW2) {
#pragma unroll
            for (int o = 16; o >= LPK; o /= 2)
#pragma unroll
                for (int r = 0; r < RB; ++r)
#pragma unroll
                    for (int e = 0; e < WPL; ++e)
                        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e],
                                                     o);
        } else {
            // the KPW keys' lanes of one column sit LPK apart: a tree by
            // shuffles down onto the first key's lanes (kslot 0)
#pragma unroll
            for (int o = G::KTOP; o > 0; o /= 2)
#pragma unroll
                for (int r = 0; r < RB; ++r)
#pragma unroll
                    for (int e = 0; e < WPL; ++e) {
                        const float u = __shfl_down_sync(
                            0xffffffffu, acc[r][e], o * LPK);
                        if (kslot + o < KPW) acc[r][e] += u;
                    }
        }
        if (kslot == 0)
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int e = 0; e < WPL; ++e)
                    red[warp][r][part * WPL + e] = acc[r][e];
        __syncthreads();
        for (int i = tid; i < RB * HD; i += NT) {
            const int r = i / HD, d = i % HD;
            if (r0 + r >= rows) continue;
            float a = red[0][r][d];
#pragma unroll
            for (int wp = 1; wp < NWARP; ++wp) a += red[wp][r][d];
            part_acc[((bh * nparts_all + p) * rows + r0 + r) * HD + d] = a;
        }
    }

    // The last block of (b, h) to finish merges its partitions, in order.
    __shared__ int is_last;
    __threadfence();           // this block's partial, visible to all
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counter[bh], 1) == nparts - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (tid == 0) counter[bh] = 0;           // ready for the next call
    // m, then the weights, and l of every partition: [nparts][RB] each, in
    // the K/V words' space (read by now)
    float* wq = reinterpret_cast<float*>(dyn);
    float* lq = wq + nparts_all * RB;
    __shared__ float den[RB];
    for (int r0 = 0; r0 < rows; r0 += RB) {
        __syncthreads();
        for (int i = tid; i < nparts * RB; i += NT) {
            const int q = i / RB, r = i % RB;
            float m = 0.0f, l = 0.0f;
            if (r0 + r < rows) {
                const float* ml = part_ml + ((bh * nparts_all + q) * rows + r0
                                             + r) * 2;
                m = __ldcg(ml);
                l = __ldcg(ml + 1);
            }
            wq[i] = m;
            lq[i] = l;
        }
        __syncthreads();
        if (tid < RB) {       // M, the weights exp(m - M) and their l sum
            float mx = wq[tid];
            for (int q = 1; q < nparts; ++q) mx = nanmax(mx, wq[q * RB + tid]);
            float l = 0.0f;
            for (int q = 0; q < nparts; ++q) {
                const float wgt = expf(wq[q * RB + tid] - mx);
                wq[q * RB + tid] = wgt;
                l += lq[q * RB + tid] * wgt;
            }
            den[tid] = nanmax(l, 1e-30f);
        }
        __syncthreads();
        for (int i = tid; i < RB * HD; i += NT) {
            const int r = i / HD, d = i % HD;
            if (r0 + r >= rows) continue;
            const float* pa = part_acc + (bh * nparts_all * rows + r0 + r) * HD
                              + d;
            float a = 0.0f;
#pragma unroll 16
            for (int q = 0; q < nparts; ++q)
                a += __ldcg(pa + (size_t)q * rows * HD) * wq[q * RB + r];
            out[(bh * rows + r0 + r) * HD + d] = a / den[r];
        }
    }
}

template <int N, int K, int HD>
int launch(const float* q4, const void* kw, const void* vw, float* out,
           float* part_acc, float* part_ml, int* counter, const int* pos_v,
           const int* start_v, const int* table, int B, int Hkv, int rows,
           int ps, int npg, int window, float scale, int nparts_all,
           cudaStream_t st) {
    constexpr int PK = Geo<N, HD>::PK;
    if (nparts_all < (npg * ps + PK - 1) / PK) return (int)cudaErrorInvalidValue;
    auto kern = attn_kernel<N, K, HD>;
    const size_t smem = std::max((size_t)2 * Geo<N, HD>::RAW,
                                 sizeof(float) * 2 * RB * (size_t)nparts_all);
    // the kernel's static arrays (qs, sc, red, the table) count against the
    // 48 KB a block gets without opting in, beside the dynamic words: at hd
    // 256 with 16-bit words they are 21 KB beside 32 KB
    static const size_t static_smem = [] {
        cudaFuncAttributes a;
        return cudaFuncGetAttributes(&a, attn_kernel<N, K, HD>) == cudaSuccess
            ? a.sharedSizeBytes : (size_t)48 * 1024;
    }();
    if (static_smem + smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kern<<<dim3(nparts_all, Hkv, B), NT, smem, st>>>(
        q4, (const wire::WordT<N>*)kw, (const wire::WordT<N>*)vw, part_acc,
        part_ml, out, counter, pos_v, start_v, table, Hkv, rows, ps, npg,
        window, scale);
    return (int)cudaGetLastError();
}

// A key must fit one warp's lanes (Geo: hd * N <= 4096): f32 words at hd
// 192 and 256 do not, and are refused (the Python wrapper names them first)
template <int N, int K, int HD>
int launch_fitting(const float* q4, const void* kw, const void* vw,
                   float* out, float* part_acc, float* part_ml, int* counter,
                   const int* pos_v, const int* start_v, const int* table,
                   int B, int Hkv, int rows, int ps, int npg, int window,
                   float scale, int nparts_all, cudaStream_t st) {
    if constexpr (HD * N <= 4096)
        return launch<N, K, HD>(q4, kw, vw, out, part_acc, part_ml, counter,
                                pos_v, start_v, table, B, Hkv, rows, ps, npg,
                                window, scale, nparts_all, st);
    else
        return (int)cudaErrorInvalidValue;
}

template <int N, int K>
int dispatch_hd(int hd, const float* q4, const void* kw, const void* vw,
                float* out, float* part_acc, float* part_ml, int* counter,
                const int* pos_v, const int* start_v, const int* table,
                int B, int Hkv, int rows, int ps, int npg, int window,
                float scale, int nparts_all, cudaStream_t st) {
#define ARGS q4, kw, vw, out, part_acc, part_ml, counter, pos_v, start_v, \
             table, B, Hkv, rows, ps, npg, window, scale, nparts_all, st
    switch (hd) {
        case 16: return launch<N, K, 16>(ARGS);
        case 32: return launch<N, K, 32>(ARGS);
        case 64: return launch<N, K, 64>(ARGS);
        case 112: return launch<N, K, 112>(ARGS);
        case 128: return launch<N, K, 128>(ARGS);
        case 192: return launch_fitting<N, K, 192>(ARGS);
        case 256: return launch_fitting<N, K, 256>(ARGS);
    }
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// n: word width in bits (8, 16, or 32 for f32 identity words); kind: the
// format code of wire.cuh (0 linear takum, 1 logarithmic takum, 2 posit,
// 3 posit8 through the table, 4 identity: bf16 at n = 16, f32 at n = 32).
// Pool kw/vw [P, ps, Hkv, hd] (16-byte aligned); pos/start [B]; table
// [B, npg]. nparts_all partitions a (b, h) at most (ceil(npg * ps / PK),
// PK = (n / 2) x 4 x (32 / (hd * n / 128)) keys: Geo), part_acc [B, Hkv,
// nparts_all, rows, hd] and part_ml [B, Hkv, nparts_all, rows, 2] f32 the
// workspace; counter [B * Hkv] int32, zero before the launch and zero
// again after it (the last block of each (b, h) resets its own).
extern "C" int takum_paged_attention(int n, int kind, int hd, const float* q4,
                                     const void* kw, const void* vw,
                                     float* out, float* part_acc,
                                     float* part_ml, int* counter,
                                     const int* pos,
                                     const int* start, const int* table,
                                     int B, int Hkv, int rows, int ps,
                                     int npg, int window, float scale,
                                     int nparts_all, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (B <= 0 || rows <= 0) return (int)cudaGetLastError();
    if (ps <= 0 || npg <= 0 || nparts_all <= 0)
        return (int)cudaErrorInvalidValue;
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK)                                              \
        return dispatch_hd<NN, KK>(hd, q4, kw, vw, out, part_acc, part_ml,  \
                                   counter, pos, start, table, B, Hkv, rows, \
                                   ps, npg, window, scale, nparts_all, st);
    WIRE_KV_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}
