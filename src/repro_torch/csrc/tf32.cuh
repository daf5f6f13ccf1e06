// f32 products on the tensor cores, and asynchronous tile copies: the
// building blocks of the wire matmul's prefill kernel (qmatmul.cu) and the
// contiguous attention kernel (flash_attention.cu).
//
// Split operands. A TF32 product (mma.sync m16n8k8) reads 10 fraction bits
// of each operand. An f32 value x is split into hi = x rounded to TF32 and
// lo = x - hi rounded to TF32; hi*y + lo*y (+ hi*ylo for a split y) then
// carries about 21 bits of x, as CUTLASS's fast-f32 (3xTF32) products do.
// A value whose decode is exact in TF32 (an 8-bit takum or posit word, a
// bf16 cache) is passed as it is and needs no lo part.
//
// Non-finite values keep their f32 meaning: where hi is not finite (inf or
// NaN) lo is 0, and the small products (lo * y, x * ylo) take the other
// operand's hi as 0 where it is not finite, so an inf stays inf (through
// hi * yhi alone), a NaN (a NaR word) still poisons every sum it enters,
// and 0 * inf and 0 * NaN are NaN as in f32. A finite x that rounds to
// TF32 infinity (|x| within half a TF32 ulp of FLT_MAX) is truncated
// instead. These guards cost more than the split itself, so contiguous
// attention tests each sub-tile's operands once (needs_guard, then
// __syncthreads_or), and a sub-tile with no such value takes split_fast
// and the small products read every hi as it is: the same parts, the
// same sums. (The matmul tests only its decoded weights, for the small
// products' guard.)
// A TF32 operand keeps 10 fraction bits in the subnormal band too, so an
// f32 subnormal loses its low bits there and one below 2^-136 reads as 0
// (a takum8 weight of 2^-143, say: far under every tolerance; the wire
// matmul's streaming kernel, on FMAs, keeps it).
//
// Accumulation. The tensor cores sum the products of one mma with a
// truncating f32 adder, so the kernels start each partial sum from zero
// and add it into an f32 register sum, which rounds to nearest, once per
// K/V sub-tile (attention) or every PROMOTE_K of K (matmul).
#pragma once
#include <cstdint>
#include <math.h>

// 1: every tile takes the guards (the timing builds of
// tools/torch_kernel_times.py, held against the kernels' fork)
#ifndef TF32_GUARD_ALWAYS
#define TF32_GUARD_ALWAYS 0
#endif

namespace tf32 {

__device__ __forceinline__ uint32_t round_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ uint32_t round_rz(float x) {
    uint32_t r;
    asm("cvt.rz.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x -> (hi, lo) TF32 bit patterns with x ~ hi + lo (see above).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    uint32_t h = round_rna(x);
    float hf = __uint_as_float(h);
    if (isinf(hf) && !isinf(x)) {
        h = round_rz(x);
        hf = __uint_as_float(h);
    }
    hi = h;
    lo = round_rna(isfinite(hf) ? x - hf : 0.0f);
}

// d += a (16x8, row-major fragment) * b (8x8, column-major fragment), f32
// accumulator. Fragment layout (lane = 4 * g + t): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (k = t + 4, n = g);
// d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// split's hi and lo where x is finite and does not round to TF32 infinity
// (needs_guard false): the same two patterns without split's guards.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = round_rna(x);
    lo = round_rna(x - __uint_as_float(hi));
}

// whether x needs split's guards and the small products' one: x is not
// finite, or rounds to TF32 infinity (|x| >= the midpoint between the
// largest TF32 value and infinity)
__device__ __forceinline__ bool needs_guard(float x) {
    return (__float_as_uint(x) & 0x7FFFFFFFu) >= 0x7F7FF000u;
}

// h where it is a finite TF32 value, else 0 (the small products' operand).
__device__ __forceinline__ uint32_t finite_or_zero(uint32_t h) {
    return (h & 0x7F800000u) == 0x7F800000u ? 0u : h;
}

// One operand fragment of NR registers: hi, the small products' hi (hi
// where finite, else 0) and lo (unused where the operand is EXACT).
template <int NR>
struct Frag {
    uint32_t h[NR], f[NR], l[NR];
};

// Fragment register r of value v: split (or, EXACT, taken as it is).
// GUARD false: the caller knows needs_guard(v) is false, so split_fast
// gives split's parts and f is h.
template <bool EXACT, int NR, bool GUARD = true>
__device__ __forceinline__ void set(Frag<NR>& a, int r, float v) {
    if constexpr (EXACT) {
        a.h[r] = __float_as_uint(v);
        a.l[r] = 0u;
    } else if constexpr (GUARD) {
        split(v, a.h[r], a.l[r]);
    } else {
        split_fast(v, a.h[r], a.l[r]);
    }
    a.f[r] = GUARD ? finite_or_zero(a.h[r]) : a.h[r];
}

// Fragment register r from a value split beforehand (split's hi and lo
// TF32 bit patterns, stored as floats).
template <int NR, bool GUARD = true>
__device__ __forceinline__ void set_split(Frag<NR>& a, int r, float hi,
                                          float lo) {
    a.h[r] = __float_as_uint(hi);
    a.l[r] = __float_as_uint(lo);
    a.f[r] = GUARD ? finite_or_zero(a.h[r]) : a.h[r];
}

// d += a * b, a split and b exact (EXACT) or split: the small products
// first (al * bf, then af * bl), then ah * bh.
template <bool EXACT>
__device__ __forceinline__ void mma3(float d[4], const Frag<4>& a,
                                     const Frag<2>& b) {
    mma(d, a.l, b.f);
    if constexpr (!EXACT) mma(d, a.f, b.l);
    mma(d, a.h, b.h);
}

// chk + 0 * v: stays 0 while every v is finite, NaN from the first inf or
// NaN on (one FMA per value: the matmul's test of its decoded weights)
__device__ __forceinline__ float nonfinite_probe(float chk, float v) {
    return fmaf(0.0f, v, chk);
}

// 16-byte asynchronous copy global -> shared; the bytes past `bytes`
// (0 or 16) are zero-filled, so a chunk outside the matrix reads as zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

}  // namespace tf32
