// One wire format as a template argument: the word codec every kernel of
// this directory reads and writes through.
//
// Replaces the FormatSpec.decode_tile / encode_tile indirection that the
// Pallas kernels of src/repro/kernels/ trace (src/repro/formats/
// registry.py:141-162): a kernel is templated on the word width N and the
// format kind K, and decodes a word with Codec<N, K>::decode and encodes a
// float with Codec<N, K>::encode. The kinds (the C entry points' `kind`
// argument, repro_torch/kernels/build.py KIND_CODES):
//   LINEAR     linear takum (takum.cuh)
//   LNS        logarithmic takum (takum.cuh; one expf / logf)
//   POSIT      posit, es = 2, computed decode (posit.cuh)
//   POSIT_LUT  posit8 through a 256-entry float table in shared memory:
//              replaces registry.py:270 _posit8_lut_decode. The table
//              (Table8, 1 KB) is built at block start by the computed
//              decode (fill, then a __syncthreads before the first read),
//              so both paths give the same floats bit for bit; a word then
//              costs one shared-memory load. Encode is posit's.
//   IDENTITY   a float KV cache (the registry's "none" codec): the words
//              are bf16 (N = 16) or f32 (N = 32) bit patterns and decode is
//              the exact cast to f32, as the reference's kv_words_to_f32
//              casts them (src/repro/kernels/takum_attention.py:72-81). A
//              decode path only: the identity encode is a cast in PyTorch.
// takum8 and lns-takum8 words (N = 8, LINEAR or LNS) always decode
// through their own Table8, built the same way, so it gives the same
// floats; in the kernels that read words at random (the wire matmul,
// attention) the lookup beats the computed decode on the H100
// (WIRE_TAKUM8_COMPUTED set to 1 turns both tables off, and the LNS
// matmul's table of lns-takum8 lv pairs: the timing builds of
// tools/torch_kernel_times.py). A kernel
// that decodes keeps one `__shared__ typename Codec<N, K>::Tab` (empty
// but for takum8 and POSIT_LUT), fills it at block start, and passes it
// to decode after a barrier.
#pragma once
#include <cstdint>
#include <type_traits>
#include "posit.cuh"
#include "takum.cuh"

#ifndef WIRE_TAKUM8_COMPUTED
#define WIRE_TAKUM8_COMPUTED 0
#endif

namespace wire {

enum Kind { LINEAR = 0, LNS = 1, POSIT = 2, POSIT_LUT = 3, IDENTITY = 4 };

// The storage type of an N-bit word: takum's for 8 and 16 bits, and the
// f32 bit pattern of the identity codec for 32.
template <int N> struct Word { using type = takum::WordT<N>; };
template <> struct Word<32> { using type = uint32_t; };
template <> struct Word<64> { using type = uint64_t; };   // n = 33..64
template <int N> using WordT = typename Word<N>::type;

struct NoTable {
    __device__ void fill(int, int) {}
};

// The 256 decoded floats of an 8-bit format (takum8: K = LINEAR,
// lns-takum8: K = LNS, posit8: K = POSIT), each entry by the computed
// decode.
template <int K>
struct Table8 {
    static_assert(K == LINEAR || K == LNS || K == POSIT, "an 8-bit format");
    float v[256];
    // threads tid, tid + nt, ... fill the entries
    __device__ void fill(int tid, int nt) {
        for (int i = tid; i < 256; i += nt) {
            if constexpr (K == LINEAR) v[i] = takum::decode<8>((uint32_t)i);
            else if constexpr (K == LNS)
                v[i] = takum::lns_decode<8>((uint32_t)i);
            else v[i] = posit::decode<8>((uint32_t)i);
        }
    }
    __device__ float operator()(uint32_t w) const { return v[w & 0xFFu]; }
};

template <int N, int K>
struct Codec {
    static_assert(N == 8 || N == 16 || (N == 32 && K == IDENTITY),
                  "8- and 16-bit words, and f32 identity words");
    static_assert(K != POSIT_LUT || N == 8, "the table is posit8's");
    static_assert(K != IDENTITY || N != 8, "bf16 or f32 identity words");
    // whether every decoded value is exact in TF32 (10 fraction bits): an
    // 8-bit takum or posit has at most 3 fraction bits, bf16 has 7
    static constexpr bool TF32_EXACT =
        (N == 8 && K != LNS) || (N == 16 && K == IDENTITY);
    static constexpr bool TAKUM8 =
        N == 8 && (K == LINEAR || K == LNS) && !WIRE_TAKUM8_COMPUTED;
    using Tab = std::conditional_t<
        K == POSIT_LUT, Table8<POSIT>,
        std::conditional_t<TAKUM8, Table8<K == LNS ? LNS : LINEAR>,
                           NoTable>>;

    __device__ static float decode(uint32_t w, const Tab& tab) {
        if constexpr (TAKUM8) return tab(w);
        else if constexpr (K == LINEAR) return takum::decode<N>(w);
        else if constexpr (K == LNS) return takum::lns_decode<N>(w);
        else if constexpr (K == POSIT) return posit::decode<N>(w);
        else if constexpr (K == IDENTITY)
            return __uint_as_float(N == 16 ? w << 16 : w);
        else return tab(w);
    }

    __device__ static uint32_t encode(float x) {
        if constexpr (K == LINEAR) return takum::encode<N>(x);
        else if constexpr (K == LNS) return takum::lns_encode<N>(x);
        else return posit::encode<N>(x);
    }
};

// The codec of kind K (LINEAR, LNS or POSIT) at a width n known only at
// run time, 6 <= n <= 32, its words in the 8-, 16- or 32-bit storage of
// WordT<8 | 16 | 32>, to float32: the codec and fake-quant kernels
// (codec.cuh) take their rare elements and the posit decode through it
// (the other kernels keep Codec<8 | 16, K>). Wide, below, takes 64-bit
// words and float64 output.
template <int K>
struct AnyWidth {
    static_assert(K == LINEAR || K == LNS || K == POSIT, "a computed codec");
    __device__ static float decode(uint32_t w, int n) {
        if constexpr (K == LINEAR) return takum::decode_n(w, n);
        else if constexpr (K == LNS) return takum::lns_decode_n(w, n);
        else return posit::decode_n(w, n);
    }
    __device__ static uint32_t encode(float x, int n) {
        if constexpr (K == LINEAR) return takum::encode_n(x, n);
        else if constexpr (K == LNS) return takum::lns_encode_n(x, n);
        else return posit::encode_n(x, n);
    }
};

// The codec of kind K at any width 6 <= n <= 64, words in the low bits of
// a uint64_t, decoded to float32 or float64 (O): takum.cuh's and
// posit.cuh's wide forms (64-bit words, float64 output, the rare elements
// of fake-quant's 64-bit widths). The encode is AnyWidth's to n = 32.
template <int K>
struct Wide {
    static_assert(K == LINEAR || K == LNS || K == POSIT, "a computed codec");
    template <typename O>
    __device__ static O decode(uint64_t w, int n) {
        if constexpr (K == LINEAR) return takum::decode_wide<O>(w, n);
        else if constexpr (K == LNS) return takum::lns_decode_wide<O>(w, n);
        else return posit::decode_wide<O>(w, n);
    }
    __device__ static uint64_t encode(float x, int n) {
        if (n <= 32) return AnyWidth<K>::encode(x, n);
        if constexpr (K == LINEAR) return takum::encode_wide(x, n);
        else if constexpr (K == LNS) return takum::lns_encode_wide(x, n);
        else return posit::encode_wide(x, n);
    }
};

// The storage bits of an n-bit word.
inline int storage_bits(int n) {
    return n <= 8 ? 8 : (n <= 16 ? 16 : (n <= 32 ? 32 : 64));
}

// Four consecutive N-bit words from (4 * N / 8)-byte aligned memory, in one
// load (little-endian lanes).
template <int N>
__device__ __forceinline__ void unpack4(const void* p, uint32_t w[4]) {
    if constexpr (N == 8) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
        for (int i = 0; i < 4; ++i) w[i] = (v >> (8 * i)) & 0xFFu;
    } else if constexpr (N == 16) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x & 0xFFFFu; w[1] = v.x >> 16;
        w[2] = v.y & 0xFFFFu; w[3] = v.y >> 16;
    } else {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    }
}

// Word e of a 16-byte vector of N-bit words (little-endian lanes).
template <int N>
__device__ __forceinline__ uint32_t word_of(const uint4& v, int e) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
    return (u[e * N / 32] >> ((e * N) % 32)) & (uint32_t)((1ull << N) - 1u);
}

}  // namespace wire

// The (N, K) pairs a kernel is instantiated for, as X(N, K) lists for the C
// entry points' dispatch: every decode, the float-decoding weights of the
// wire matmul (no LNS: those take lns_matmul.cu), and every encode (the
// table is a decode path only).
#define WIRE_DECODE_FORMATS(X) \
    X(8, 0) X(8, 1) X(8, 2) X(8, 3) X(16, 0) X(16, 1) X(16, 2)
#define WIRE_DENSE_FORMATS(X) X(8, 0) X(8, 2) X(8, 3) X(16, 0) X(16, 2)
// Attention also reads float caches: bf16 and f32 words (identity).
#define WIRE_KV_FORMATS(X) WIRE_DECODE_FORMATS(X) X(16, 4) X(32, 4)
#define WIRE_ENCODE_FORMATS(X) \
    X(8, 0) X(8, 1) X(8, 2) X(16, 0) X(16, 1) X(16, 2)
