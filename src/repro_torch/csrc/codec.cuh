// The element functions and block tables of the codec kernels (codec.cu)
// and of fake-quant's word path (fake_quant.cu): one word decoded or one
// float encoded at a width n known at run time, through tables that each
// block fills for its n at start. The served kernels (the matmuls,
// attention, kv_append) keep the register-only device functions of
// takum.cuh and posit.cuh, which these fall back to for rare inputs, so
// both give the same words and floats.
//
// Decode, by mode (the host picks one per launch):
//   TABLE8     takum8, lns-takum8 and posit8 through the table: the 256
//              floats of the computed decode (wire.cuh's Table8), one
//              shared-memory load a word.
//   HEADER     linear and LNS takum: the 2048-entry table of the 11 bits
//              after the sign (takum::decode_entry / lns_entry, 8 KB).
//   REGISTERS  posit (the regime is one __clz), and linear takum from
//              n = 29 (the fraction rounds into float32).
// Encode (linear takum, LNS takum, posit): a table of the 16-byte cut of
// every float32 exponent (256 entries) or, for LNS, of every floor
// characteristic c in [-256, 256] of ell_bar's fixed point form; a normal
// float reads one entry and rounds with takum::round_entry, and zeros,
// subnormals, infinities and NaNs take the register forms.
// Wide (64-bit words from n = 33, and float64 output at every width): the
// decode reads c and r of linear and LNS takum from the 2048-entry table
// of the 11 bits after the sign (takum::lns_entry, the same at every
// width) and counts posit's regime with one __clzll; the encode reads the
// header P and the shift of the float's exponent (LNS: of its floor
// characteristic) from a table and shifts P << wm | m into place
// (takum::round_wide).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include "wire.cuh"

namespace codec {

enum Mode { TABLE8 = 0, HEADER = 1, REGISTERS = 2 };

template <int M>
struct DecodeSize {
    static constexpr int value = M == HEADER ? 2048 : (M == TABLE8 ? 256 : 1);
};

// Threads tid, tid + nt, ... fill the decode table of kind K, mode M.
template <int K, int M>
__device__ __forceinline__ void fill_decode(uint32_t* tab, int n, int tid,
                                            int nt) {
    for (int i = tid; i < DecodeSize<M>::value; i += nt) {
        if constexpr (M == TABLE8) {
            constexpr int k = K == wire::POSIT_LUT ? wire::POSIT : K;
            tab[i] = __float_as_uint(wire::AnyWidth<k>::decode(i, 8));
        } else if constexpr (M == HEADER) {
            if constexpr (K == wire::LINEAR)
                tab[i] = takum::decode_entry((uint32_t)i, n);
            else tab[i] = (uint32_t)takum::lns_entry((uint32_t)i);
        }
    }
}

// A launch's width and what follows from it, computed once a thread.
struct Width {
    int n, g, q, pre;      // ghost shift, header shift, cut shift up
    uint32_t top;          // 2^(n-1) - 1: the largest magnitude word
    float scale;           // 0.5 / 2^wf: ell_bar to ln
    // (top and pre serve the narrow paths, n <= 32; top is clipped to 32
    // bits above)
    __device__ explicit Width(int n_, int wm)
        : n(n_), g((n_ < 12 ? 12 : n_) - n_), q((n_ < 12 ? 12 : n_) - 12),
          pre(takum::cut_pre(n_, wm)),
          top(takum::low_bits(n_ <= 33 ? n_ - 1 : 32)),
          scale(0.5f / (float)(1ull << ((n_ < 12 ? 12 : n_) - 5))) {}
};

// The register paths, for vectors holding a rare element: out of line,
// so that the kernels' loops hold the common path alone.
template <int K>
__device__ __noinline__ float decode_rare(uint32_t w, int n) {
    return wire::AnyWidth<K>::decode(w, n);
}

template <int K>
__device__ __noinline__ uint32_t encode_rare(float x, int n) {
    return wire::AnyWidth<K>::encode(x, n);
}

// Four words of kind K in mode M. HEADER (linear takum): the float32 bits
// of a magnitude word's n12-bit form t are (t << sh) + A from the entry of
// takum::decode_entry, the sign ORed back; a vector with a marked entry
// (other than the zero word's) goes to the register path. HEADER (LNS):
// ell_bar = (t << r) + ((c - header) << wf), one expf; a vector with a zero
// or NaR word goes to the register path. REGISTERS: posit's regime by one
// __clz, linear takum from n = 29, the magnitude's value with the sign
// ORed back; a vector with a zero or NaR word goes to the register path.
template <int K, int M>
__device__ __forceinline__ void decode4_computed(const uint32_t w_in[4],
                                                 float y[4], const Width& c,
                                                 const uint32_t* tab) {
    static_assert(M == HEADER || K != wire::LNS, "LNS decodes by its table");
    uint32_t w[4], s[4], t[4], e[4];
    bool rare = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        w[j] = w_in[j] & (2u * c.top + 1u);
        s[j] = w[j] >> (c.n - 1);
        const uint32_t a = takum::magnitude(w[j], s[j], c.n);
        if constexpr (M == HEADER) {
            t[j] = a << c.g;
            e[j] = tab[(t[j] >> c.q) & 0x7FFu];
            if constexpr (K == wire::LINEAR)
                rare |= (e[j] & 32u) && w[j] != 0u;
            else rare |= (w[j] & c.top) == 0u;
        } else {
            t[j] = a;
            rare |= (w[j] & c.top) == 0u;
        }
    }
    if (rare) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = decode_rare<K>(w[j], c.n);
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if constexpr (M == HEADER && K == wire::LINEAR) {
            y[j] = __uint_as_float(((t[j] << (e[j] & 31u))
                                    + (e[j] & 0xFF800000u)) | (s[j] << 31));
        } else if constexpr (M == HEADER) {
            const int en = (int)e[j];
            const float mag = expf(
                takum::lns_ell(t[j], en & 7, en >> 8, c.n) * c.scale);
            y[j] = s[j] ? -mag : mag;
        } else if constexpr (K == wire::POSIT) {
            y[j] = __uint_as_float(posit::positive_bits(t[j], c.n)
                                   | (s[j] << 31));
        } else {
            y[j] = __uint_as_float(takum::positive_bits(t[j], c.n)
                                   | (s[j] << 31));
        }
    }
}

template <int K, int M>
__device__ __forceinline__ void decode4(const uint32_t w[4], float y[4],
                                        const Width& c, const uint32_t* tab) {
    if constexpr (M == TABLE8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = __uint_as_float(tab[w[j] & 0xFFu]);
    } else {
        decode4_computed<K, M>(w, y, c, tab);
    }
}

// One word (the scalar tail).
template <int K, int M>
__device__ __forceinline__ float decode1(uint32_t w, const Width& c,
                                         const uint32_t* tab) {
    if constexpr (M == TABLE8) return __uint_as_float(tab[w & 0xFFu]);
    else return decode_rare<K>(w, c.n);
}

template <int K>
struct EncodeSize {
    static constexpr int value = K == wire::LNS ? 513 : 256;
};

// Threads tid, tid + nt, ... fill the encode table of kind K: entry i is
// the cut of float exponent i - 127 (i = 1..254; 0 and 255 are never
// read), or of characteristic i - 256 for LNS.
template <int K>
__device__ __forceinline__ void fill_encode(uint4* tab, int n, int tid,
                                            int nt) {
    for (int i = tid; i < EncodeSize<K>::value; i += nt) {
        if constexpr (K == wire::LINEAR)
            tab[i] = takum::cut_entry(takum::takum_cut(i - 127, n, 23));
        else if constexpr (K == wire::POSIT)
            tab[i] = takum::cut_entry(posit::posit_cut(i - 127, n));
        else tab[i] = takum::cut_entry(takum::lns_cut(i - 256, n));
    }
}

// 0, subnormal, inf or NaN: the register path.
__device__ __forceinline__ bool rare_float(uint32_t bits) {
    return (bits & 0x7FFFFFFFu) - 0x800000u >= 0x7F000000u;
}

// Four floats of kind K through the encode table: the magnitude's word
// from the cut of its exponent (LNS: of ell_bar's floor characteristic),
// negated for S = 1; a vector with a rare float goes to the register
// path.
template <int K>
__device__ __forceinline__ void encode4(const float4 v, uint32_t w[4],
                                        const Width& c, const uint4* tab) {
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t b[4];
    bool rare = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        b[j] = __float_as_uint(x[j]);
        rare |= rare_float(b[j]);
    }
    if (rare) {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = encode_rare<K>(x[j], c.n);
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        uint32_t m;
        if constexpr (K == wire::LNS) {
            const int fixed = takum::lns_fixed(x[j]);
            m = takum::round_entry(tab[(fixed >> 22) + 256],
                                   ((uint32_t)fixed & 0x3FFFFFu) << c.pre,
                                   c.top);
        } else {
            m = takum::round_entry(tab[(b[j] >> 23) & 0xFFu],
                                   (b[j] & 0x7FFFFFu) << c.pre, c.top);
        }
        w[j] = b[j] >> 31 ? (0u - m) & (2u * c.top + 1u) : m;
    }
}

// ---- wide: 64-bit words and float64 output ------------------------------

// Threads tid, tid + nt, ... fill the wide decode table: ((c - header) << 8)
// | r for each value of the 11 bits after the sign (linear and LNS takum).
__device__ __forceinline__ void fill_decode_wide(uint32_t* tab, int tid,
                                                 int nt) {
    for (int i = tid; i < 2048; i += nt)
        tab[i] = (uint32_t)takum::lns_entry((uint32_t)i);
}

// Threads tid, tid + nt, ... fill the wide encode table of kind K at width
// n: the header P of float exponent i - 127 (LNS: characteristic i - 256,
// clamped into [-255, 254]) in x (low half) and y (high half), the shift
// n - 1 - L - wm of P << wm | m into place in z.
template <int K>
__device__ __forceinline__ void fill_encode_wide(uint4* tab, int n, int tid,
                                                 int nt) {
    for (int i = tid; i < EncodeSize<K>::value; i += nt) {
        int len;
        uint64_t p;
        if constexpr (K == wire::LINEAR) p = takum::takum_header(i - 127, len);
        else if constexpr (K == wire::POSIT)
            p = posit::posit_header(i - 127, n, len);
        else p = takum::takum_header(min(max(i - 256, -255), 254), len);
        const int wm = K == wire::LNS ? 22 : 23;
        tab[i] = make_uint4((uint32_t)p, (uint32_t)(p >> 32),
                            (uint32_t)(n - 1 - len - wm), 0u);
    }
}

// One word of kind K (in the low n bits, any storage) to O: linear and LNS
// takum through the wide decode table, posit by its regime's __clzll.
template <int K, typename O>
__device__ __forceinline__ O decode_wide1(uint64_t w, int n,
                                          const uint32_t* tab) {
    if constexpr (K == wire::POSIT) {
        return posit::decode_wide<O>(w, n);
    } else {
        const takum::WideMag m = takum::wide_mag(w, n);
        if (m.special) return takum::special_wide<O>(m.s);
        const int n12 = n < 12 ? 12 : n;
        uint64_t mf;
        const int c = takum::wide_fields_tab(m.a << (n12 - n), n12, tab, mf);
        if constexpr (K == wire::LINEAR)
            return takum::assemble<O>(m.s, mf, c, n12 - 5);
        else return takum::lns_value_wide<O>(m.s, c, mf, n12 - 5);
    }
}

// One float of kind K to an n-bit word, 33 <= n <= 64: a normal float (LNS:
// a nonzero finite one whose floor characteristic is in [-255, 254]) by
// the wide encode table, the others by the register forms.
template <int K>
__device__ __forceinline__ uint64_t encode_wide1(float x, int n,
                                                 const uint4* tab) {
    const uint32_t b = __float_as_uint(x);
    if (rare_float(b)) return wire::Wide<K>::encode(x, n);
    int i;
    uint32_t m;
    if constexpr (K == wire::LNS) {
        const int fixed = takum::lns_fixed(x);
        i = (fixed >> 22) + 256;
        if (i < 1 || i > 510) return wire::Wide<K>::encode(x, n);
        m = (uint32_t)fixed & 0x3FFFFFu;
    } else {
        i = (int)((b >> 23) & 0xFFu);
        m = b & 0x7FFFFFu;
    }
    const uint4 e = tab[i];
    const uint64_t p = ((uint64_t)e.y << 32) | e.x;
    const uint64_t w = takum::round_wide(
        (p << (K == wire::LNS ? 22 : 23)) | m, (int)e.z,
        takum::low_bits64(n - 1));
    return b >> 31 ? (0ull - w) & takum::low_bits64(n) : w;
}

// One wave of a kernel of 256-thread blocks: as many blocks as fit on
// every SM at once (the occupancy of that kernel, read once), each filling
// its tables once, or fewer for a short count of items (one a thread).
template <auto kernel>
int codec_grid(long long items) {
    static int wave = 0;
    if (wave == 0) {
        int dev = 0, sms = 0, per = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, 256, 0);
        wave = (sms > 0 ? sms : 132) * (per > 0 ? per : 1);
    }
    const long long blocks = (items + 255) / 256;
    return blocks < 1 ? 1 : (blocks < wave ? (int)blocks : wave);
}

// Both pointers 16-byte aligned: the vectors' accesses (else the kernels
// take their scalar loop throughout).
inline bool aligned16(const void* a, const void* b) {
    return ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
}

}  // namespace codec
