// Flash attention over a contiguous wire KV cache, on the tensor cores.
//
// Replaces src/repro/kernels/takum_attention.py::attention_kernel_call
// (_attn_tile, _kv_index): a cached prefill chunk, whose G * tq query rows
// of one KV head attend over the in-band KV tiles of a [B, T, Hkv, hd]
// word cache. The paged decode kernel stays in attention.cu.
//
// What bounds it on the H100: a 256-token chunk of phi3-medium-14b has
// 1024 query rows per KV head, so each K/V word feeds 1024 rows: the
// products (4 * rows * keys * hd) bound it, not the bytes. The reference
// dots in f32 (preferred_element_type=f32); here Q.K^T and P.V run on the
// tensor cores as split TF32 products (tf32.cuh): the activations (q, p)
// are split into a TF32 hi and lo part; the K/V values are passed as they
// are where their decode is exact in TF32 (takum8, posit8, bf16) and split
// too otherwise (takum16, posit16, lns-takum, f32), so each product costs
// two or three TF32 products and carries about 21 bits, against the f32
// reference's 24 (held at the reference's 2e-5 tolerance on every row).
//
// Design:
// * Grid (row tiles of BQ = 64, Hkv, B): each block holds 64 query rows of
//   one KV head, 16 rows per warp. At the chunk shape (1024 rows x 10 KV
//   heads) that is 160 blocks; at about 84 KB of shared memory (takum8, hd
//   128) two fit on an SM, so every block is resident at once on the 132
//   SMs. Most formats run 4 warps; 16-bit words decoded by computation run
//   8, two groups of 4 that take alternate 16-key halves of every sub-tile
//   with a softmax state each, merged (one more online-softmax step) at
//   the end (see ksplit below).
// * Q is staged once in shared memory. Keys run in sub-tiles of BKV = 32:
//   the sub-tile's K and V words (hd * N / 8 bytes per key) arrive by
//   16-byte cp.async copies into a double buffer, the next sub-tile's while
//   the current one is computed; each word is decoded once per block into
//   an f32 row of shared memory (row stride hd + 4: the fragment reads are
//   conflict-free). takum8 words decode through a 256-entry table (as
//   posit8's do under POSIT_LUT): the computed decode of 16 copies of every
//   word (one per row tile) was the larger part of the kernel's time.
// * Per sub-tile a warp computes its 16 x 32 scores (16 x 16 with two key
//   groups) as m16n8 fragments, runs the online softmax on them in
//   registers (quad shuffles for the row max and sum), and uses the
//   probabilities as the A fragments of P.V directly: the score fragment's
//   columns (2t, 2t + 1) become the A columns (t, t + 4) and the V rows are
//   read in the same permuted order, so P never goes through shared
//   memory. P.V of the sub-tile starts from zero and is added into the f32
//   output once: acc = acc * corr + part.
// * Two barriers per sub-tile: the words have landed (and the previous
//   sub-tile's reads are done), and the decoded K/V rows are ready. The
//   second also says (__syncthreads_or) whether q or the sub-tile's K/V
//   hold a value that needs tf32.cuh's guards (an inf or NaR word, say);
//   a sub-tile without one splits its operands unguarded, which cut the
//   split formats' time most (they split every K/V value they read).
//
// Semantics kept from the Pallas kernel (and attention.cu's first port):
// the tiles visited (every tile up to (pos + tq - 1) / bk, minus those
// wholly before a window's floor), every key of a visited tile taking part
// (masked keys with p = 0, so a NaR V word anywhere in a visited tile
// poisons the rows of that tile; keys before a sequence's start are the
// exception: their K/V rows are zeros, so left padding poisons no row),
// masked scores = MASKED = -1e30 before the
// NaN-propagating row max, the scale after the dot, out = acc /
// max(l, 1e-30), expf. Keys past T are the zero words the Pallas wrapper
// pads with; keys of a sub-tile past the tile's end are not keys of it.
//
// KV words: every format the attention reads (takum8/16, lns-takum8/16,
// posit8 through the table or computed, posit16, and the identity codec's
// bf16 and f32 floats), through wire::Codec<N, K> or, for takum8, its
// table.
#include <cuda_runtime.h>
#include <math.h>
#include "tf32.cuh"
#include "wire.cuh"

namespace {

constexpr float MASKED = -1e30f;
constexpr int BQ = 64, BKV = 32;

// KSPLIT groups of 4 warps split the keys of every sub-tile, and each warp
// of a group owns 16 query rows: two groups for the 16-bit words that are
// decoded by computation (takum16, lns-takum16, posit16: twice the warps
// share the decode of every word and hide its latency), one for the
// others (8-bit words through a table, bf16 and f32 casts), which were
// faster with 4 warps on the H100 (PERF.md; FLASH_KSPLIT, 1 or 2, sets it
// for every format: the timing builds of tools/torch_kernel_times.py)
template <int N, int K>
constexpr int ksplit() {
#ifdef FLASH_KSPLIT
    return FLASH_KSPLIT;
#else
    return N == 16 && K != wire::IDENTITY ? 2 : 1;
#endif
}

__device__ __forceinline__ float nanmax(float a, float b) {
    return (a != a || b != b) ? __uint_as_float(0x7FC00000u) : fmaxf(a, b);
}

template <int N, int HD>
struct Layout {
    static constexpr int S = HD + 4;             // f32 row stride
    static constexpr int WB = HD * N / 8;        // bytes of one key's words
    static constexpr int CH = WB / 16;           // 16-byte chunks per key
    static constexpr int STAGE = 2 * BKV * WB;   // K and V words, one stage
    static constexpr size_t bytes() {
        return sizeof(float) * (BQ * S + 2 * BKV * S) + 2 * STAGE;
    }
};

template <int N, int K, int HD, int KSPLIT = ksplit<N, K>(),
          int NT = 128 * KSPLIT>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const float* __restrict__ q4,
             const wire::WordT<N>* __restrict__ kw,
             const wire::WordT<N>* __restrict__ vw, float* __restrict__ out,
             const int* __restrict__ start_v, int Hkv, int rows, int T,
             int pos0, int tq, int tile, int window, float scale) {
    using L = Layout<N, HD>;
    using C = wire::Codec<N, K>;
    constexpr bool EXACT = wire::Codec<N, K>::TF32_EXACT;
    constexpr int S = L::S, NSUB = BKV / 8 / KSPLIT, NOUT = HD / 8;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);   // [BQ][S]
    float* ks = qs + BQ * S;                       // [BKV][S]
    float* vs = ks + BKV * S;                      // [BKV][S]
    uint8_t* raw = reinterpret_cast<uint8_t*>(vs + BKV * S);  // [2][2][BKV][WB]
    __shared__ typename C::Tab tab;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rw = warp % 4, kg = warp / 4;   // row group, key group
    const int row0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    tab.fill(tid, NT);

    // the visited tiles: up to `last`, from the first one not wholly before
    // the window floor; sub-tile i is (tile kk0 + i / nsub, offset
    // (i % nsub) * BKV)
    const int ntiles = (T + tile - 1) / tile;
    int last = (pos0 + tq - 1) / tile;
    if (last > ntiles - 1) last = ntiles - 1;
    int kk0 = 0;
    if (window)
        while (kk0 <= last && !((kk0 + 1) * tile - 1 > pos0 - window)) ++kk0;
    const int nsub = (tile + BKV - 1) / BKV;
    const int nsteps = (last - kk0 + 1) * nsub;

    const uint8_t* kb = reinterpret_cast<const uint8_t*>(kw);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(vw);
    // the words of sub-tile i into stage i % 2: chunk c is (tensor, key j,
    // 16-byte part); keys outside the tile or past T read as zero words
    auto issue = [&](int i) {
        const int kk = kk0 + i / nsub, s0 = (i % nsub) * BKV;
        uint8_t* dst = raw + (i % 2) * L::STAGE;
        for (int c = tid; c < 2 * BKV * L::CH; c += NT) {
            const int tensor = c / (BKV * L::CH);
            const int j = (c / L::CH) % BKV, part = c % L::CH;
            const int off = s0 + j, kpos = kk * tile + off;
            const bool ok = off < tile && kpos < T;
            const uint8_t* src = tensor ? vb : kb;
            if (ok)
                src += (((size_t)b * T + kpos) * Hkv + h) * L::WB + part * 16;
            tf32::cp_async16(dst + (tensor * BKV + j) * L::WB + part * 16,
                             src, ok ? 16 : 0);
        }
        tf32::cp_commit();
    };
    if (nsteps > 0) issue(0);

    // q_bad: a q value of this thread's needs the guards of tf32.cuh
    bool q_bad = false;
    for (int i = tid; i < BQ * HD / 4; i += NT) {
        const int r = i / (HD / 4), c4 = i % (HD / 4);
        const int gr = row0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < rows)
            v = reinterpret_cast<const float4*>(
                q4 + (((size_t)b * Hkv + h) * rows + gr) * HD)[c4];
        q_bad |= tf32::needs_guard(v.x) || tf32::needs_guard(v.y)
                 || tf32::needs_guard(v.z) || tf32::needs_guard(v.w);
        *reinterpret_cast<float4*>(qs + r * S + 4 * c4) = v;
    }

    // this lane's two rows: r = 0 -> row g, r = 1 -> row g + 8 of the warp's
    // 16; its keys: the n8-tiles kg * NSUB .. of every sub-tile
    const int start = start_v[b];
    int qpos[2];
    for (int r = 0; r < 2; ++r)
        qpos[r] = pos0 + (row0 + 16 * rw + g + 8 * r) % tq;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
    float acc[NOUT][4];
#pragma unroll
    for (int n = 0; n < NOUT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const float* qw = qs + 16 * rw * S;

    // the products, softmax and P.V of sub-tile `step`, its K/V rows
    // decoded: G true takes the guards of tf32.cuh on q, K and V (an inf or
    // NaR value), G false the unguarded split. P is split unguarded in both:
    // p is in [0, 1] or NaN, and a NaN p gives NaN either way
    auto sub_tile = [&](int step, auto guard) {
        constexpr bool G = decltype(guard)::value;
        // scores: s[jj] is the m16n8 fragment of keys 8j .. 8j + 7 of the
        // sub-tile, j = kg * NSUB + jj
        float s[NSUB][4];
#pragma unroll
        for (int jj = 0; jj < NSUB; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
#pragma unroll 4
        for (int kd = 0; kd < HD; kd += 8) {
            tf32::Frag<4> a;
            tf32::set<false, 4, G>(a, 0, qw[g * S + kd + t]);
            tf32::set<false, 4, G>(a, 1, qw[(g + 8) * S + kd + t]);
            tf32::set<false, 4, G>(a, 2, qw[g * S + kd + t + 4]);
            tf32::set<false, 4, G>(a, 3, qw[(g + 8) * S + kd + t + 4]);
#pragma unroll
            for (int jj = 0; jj < NSUB; ++jj) {
                const float* kr = ks + (8 * (kg * NSUB + jj) + g) * S + kd + t;
                tf32::Frag<2> bk;
                tf32::set<EXACT, 2, G>(bk, 0, kr[0]);
                tf32::set<EXACT, 2, G>(bk, 1, kr[4]);
                tf32::mma3<EXACT>(s[jj], a, bk);
            }
        }

        // mask, scale, online softmax; element e of s[jj] is row g + 8 (e / 2),
        // key 8j + 2t + e % 2 of the sub-tile
        const int kk = kk0 + step / nsub, s0 = (step % nsub) * BKV;
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int jj = 0; jj < NSUB; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e / 2;
                const int off = s0 + 8 * (kg * NSUB + jj) + 2 * t + e % 2;
                float v;
                if (off >= tile) {
                    v = -INFINITY;                 // not a key of this tile
                } else {
                    const int kpos = kk * tile + off;
                    bool msk = kpos <= qpos[r] && kpos >= start;
                    if (window) msk = msk && kpos > qpos[r] - window;
                    v = msk ? s[jj][e] * scale : MASKED;
                }
                s[jj][e] = v;
                tmax[r] = nanmax(tmax[r], v);
            }
        float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            tmax[r] = nanmax(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
            tmax[r] = nanmax(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
            const float m_new = nanmax(m[r], tmax[r]);
            corr[r] = expf(m[r] - m_new);
            m[r] = m_new;
        }
        // P as A fragments: the score columns (2t, 2t + 1) of keys 8j..8j+7
        // are the A columns (t, t + 4); V rows are read as 8j + 2t and
        // 8j + 2t + 1 to match
        tf32::Frag<4> pa[NSUB];
#pragma unroll
        for (int jj = 0; jj < NSUB; ++jj) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                p[e] = expf(s[jj][e] - m[e / 2]);
                psum[e / 2] += p[e];
            }
            tf32::set<false, 4, false>(pa[jj], 0, p[0]);  // (g, 2t) -> a0
            tf32::set<false, 4, false>(pa[jj], 1, p[2]);  // (g + 8, 2t)
            tf32::set<false, 4, false>(pa[jj], 2, p[1]);  // (g, 2t + 1)
            tf32::set<false, 4, false>(pa[jj], 3, p[3]);  // (g + 8, 2t + 1)
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
            l[r] = l[r] * corr[r] + psum[r];
        }

        // P.V: per 8-column slice of the output, the sub-tile's sum from
        // zero, then added into the f32 accumulator once
#pragma unroll
        for (int n = 0; n < NOUT; ++n) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int jj = 0; jj < NSUB; ++jj) {
                const float* vr = vs + (8 * (kg * NSUB + jj) + 2 * t) * S
                                  + 8 * n + g;
                tf32::Frag<2> bv;
                tf32::set<EXACT, 2, G>(bv, 0, vr[0]);
                tf32::set<EXACT, 2, G>(bv, 1, vr[S]);
                tf32::mma3<EXACT>(part, pa[jj], bv);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[n][e] = fmaf(acc[n][e], corr[e / 2], part[e]);
        }
    };

    for (int step = 0; step < nsteps; ++step) {
        tf32::cp_wait_all();
        __syncthreads();   // words of `step` visible; K/V rows free
        if (step + 1 < nsteps) issue(step + 1);
        // decode 4 words at a time into the f32 rows (one float4 each)
        const uint8_t* src = raw + (step % 2) * L::STAGE;
        bool bad = q_bad;
        for (int u = tid; u < 2 * BKV * HD / 4; u += NT) {
            const int tensor = u / (BKV * HD / 4);
            const int j = (u / (HD / 4)) % BKV, d4 = u % (HD / 4);
            uint32_t w[4];
            wire::unpack4<N>(src + (tensor * BKV + j) * L::WB + d4 * N / 2, w);
            // keys before start (left padding) read as zeros: no NaR word
            // there can reach a row through p = 0 in P.V
            const int kpos = (kk0 + step / nsub) * tile + (step % nsub) * BKV
                             + j;
            const float4 v = kpos < start ? make_float4(0.f, 0.f, 0.f, 0.f)
                             : make_float4(
                C::decode(w[0], tab), C::decode(w[1], tab),
                C::decode(w[2], tab), C::decode(w[3], tab));
            bad |= tf32::needs_guard(v.x) || tf32::needs_guard(v.y)
                   || tf32::needs_guard(v.z) || tf32::needs_guard(v.w);
            *reinterpret_cast<float4*>((tensor ? vs : ks) + j * S + 4 * d4) = v;
        }
        // K/V rows ready; whether q or this sub-tile's K/V hold a value
        // that needs the guards (an inf or NaR word, say)
        if (__syncthreads_or(bad) || TF32_GUARD_ALWAYS)
            sub_tile(step, std::true_type{});
        else sub_tile(step, std::false_type{});
    }

    if constexpr (KSPLIT == 2) {
        // the two key groups' softmax states meet: group 1 leaves (m, l,
        // acc) in shared memory (Q and K rows are free now), group 0 merges
        // them as one more online-softmax step
        float* st = qs;   // [4 warps][NOUT * 4 + 4][32 lanes]
        constexpr int W = NOUT * 4 + 4;
        __syncthreads();
        if (kg == 1) {
            float* d = st + rw * W * 32 + lane;
#pragma unroll
            for (int n = 0; n < NOUT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) d[(4 * n + e) * 32] = acc[n][e];
            d[(W - 4) * 32] = m[0]; d[(W - 3) * 32] = m[1];
            d[(W - 2) * 32] = l[0]; d[(W - 1) * 32] = l[1];
        }
        __syncthreads();
        if (kg == 1) return;
        const float* d = st + rw * W * 32 + lane;
        float c0[2], c1[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m1 = d[(W - 4 + r) * 32], l1 = d[(W - 2 + r) * 32];
            const float m_new = nanmax(m[r], m1);
            c0[r] = expf(m[r] - m_new);
            c1[r] = expf(m1 - m_new);
            l[r] = l[r] * c0[r] + l1 * c1[r];
        }
#pragma unroll
        for (int n = 0; n < NOUT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[n][e] = fmaf(acc[n][e], c0[e / 2],
                                 d[(4 * n + e) * 32] * c1[e / 2]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * rw + g + 8 * r;
        if (row >= rows) continue;
        const float denom = nanmax(l[r], 1e-30f);
        float* o = out + (((size_t)b * Hkv + h) * rows + row) * HD;
#pragma unroll
        for (int n = 0; n < NOUT; ++n)
            *reinterpret_cast<float2*>(o + 8 * n + 2 * t) = make_float2(
                acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
}

template <int N, int K, int HD>
int launch(const float* q4, const void* kw, const void* vw, float* out,
           const int* start, int B, int Hkv, int rows, int T, int pos0,
           int tq, int tile, int window, float scale, cudaStream_t st) {
    const size_t smem = Layout<N, HD>::bytes();
    auto kern = flash_kernel<N, K, HD>;
    constexpr int NT = 128 * ksplit<N, K>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((rows + BQ - 1) / BQ, Hkv, B);
    kern<<<grid, NT, smem, st>>>(
        q4, (const wire::WordT<N>*)kw, (const wire::WordT<N>*)vw, out, start,
        Hkv, rows, T, pos0, tq, tile, window, scale);
    return (int)cudaGetLastError();
}

template <int N, int K>
int dispatch_hd(int hd, const float* q4, const void* kw, const void* vw,
                float* out, const int* start, int B, int Hkv, int rows,
                int T, int pos0, int tq, int tile, int window, float scale,
                cudaStream_t st) {
#define ARGS q4, kw, vw, out, start, B, Hkv, rows, T, pos0, tq, tile, \
             window, scale, st
    switch (hd) {
        case 16: return launch<N, K, 16>(ARGS);
        case 32: return launch<N, K, 32>(ARGS);
        case 64: return launch<N, K, 64>(ARGS);
        case 112: return launch<N, K, 112>(ARGS);
        case 128: return launch<N, K, 128>(ARGS);
    }
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// n: word width in bits (8, 16, or 32 for f32 identity words); kind: the
// format code of wire.cuh (0 linear takum, 1 logarithmic takum, 2 posit,
// 3 posit8 through the table, 4 identity: bf16 at n = 16, f32 at n = 32).
// Cache kw/vw [B, T, Hkv, hd], 16-byte aligned; q4/out [B, Hkv, rows, hd]
// f32, 16-byte aligned; pos0 = position of the first query; tile = bk;
// start [B].
extern "C" int takum_attention(int n, int kind, int hd, const float* q4,
                               const void* kw, const void* vw, float* out,
                               const int* start, int B, int Hkv, int rows,
                               int T, int pos0, int tq, int bk, int window,
                               float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (B <= 0 || rows <= 0) return (int)cudaGetLastError();
    if (T <= 0 || bk <= 0 || tq <= 0) return (int)cudaErrorInvalidValue;
#define CASE(NN, KK)                                                        \
    if (n == NN && kind == KK)                                              \
        return dispatch_hd<NN, KK>(hd, q4, kw, vw, out, start, B, Hkv,      \
                                   rows, T, pos0, tq, bk, window, scale, st);
    WIRE_KV_FORMATS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
}
