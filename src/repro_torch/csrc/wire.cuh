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
//              (1 KB) is built at block start by the computed decode
//              (Table<true>::fill, then a __syncthreads before the first
//              read), so both paths give the same floats bit for bit; a
//              word then costs one shared-memory load. Encode is posit's.
// A kernel that decodes keeps one `__shared__ typename Codec<N, K>::Tab`
// (empty unless K is POSIT_LUT) and passes it to decode.
#pragma once
#include <cstdint>
#include "posit.cuh"
#include "takum.cuh"

namespace wire {

enum Kind { LINEAR = 0, LNS = 1, POSIT = 2, POSIT_LUT = 3 };

template <bool TABLE>
struct Table {
    __device__ void fill(int, int) {}
};

template <>
struct Table<true> {
    float v[256];
    // every entry by the computed posit8 decode, threads tid, tid + nt, ...
    __device__ void fill(int tid, int nt) {
        for (int i = tid; i < 256; i += nt)
            v[i] = posit::decode<8>((uint32_t)i);
    }
};

template <int N, int K>
struct Codec {
    static_assert(N == 8 || N == 16, "8- and 16-bit words");
    static_assert(K != POSIT_LUT || N == 8, "the table is posit8's");
    using Tab = Table<K == POSIT_LUT>;

    __device__ static float decode(uint32_t w, const Tab& tab) {
        if constexpr (K == LINEAR) return takum::decode<N>(w);
        else if constexpr (K == LNS) return takum::lns_decode<N>(w);
        else if constexpr (K == POSIT) return posit::decode<N>(w);
        else return tab.v[w & 0xFFu];
    }

    __device__ static uint32_t encode(float x) {
        if constexpr (K == LINEAR) return takum::encode<N>(x);
        else if constexpr (K == LNS) return takum::lns_encode<N>(x);
        else return posit::encode<N>(x);
    }
};

}  // namespace wire

// The (N, K) pairs a kernel is instantiated for, as X(N, K) lists for the C
// entry points' dispatch: every decode, the float-decoding weights of the
// wire matmul (no LNS: those take lns_matmul.cu), and every encode (the
// table is a decode path only).
#define WIRE_DECODE_FORMATS(X) \
    X(8, 0) X(8, 1) X(8, 2) X(8, 3) X(16, 0) X(16, 1) X(16, 2)
#define WIRE_DENSE_FORMATS(X) X(8, 0) X(8, 2) X(8, 3) X(16, 0) X(16, 2)
#define WIRE_ENCODE_FORMATS(X) \
    X(8, 0) X(8, 1) X(8, 2) X(16, 0) X(16, 1) X(16, 2)
