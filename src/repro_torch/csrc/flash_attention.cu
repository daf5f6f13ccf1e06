// Contiguous-cache flash attention (flash_attention.cuh) at head dims 16,
// 32, 64, 112 and 128: the library ``takum_attention`` of
// repro_torch/kernels/takum_attention.py. Head dims 192 and 256 are
// flash_attention_wide.cu, a translation unit of their own so that nvcc
// builds the two sets in parallel.
#include "flash_attention.cuh"

// arguments: flash_attention.cuh, entry()
extern "C" int takum_attention(int n, int kind, int hd, const float* q4,
                               const void* kw, const void* vw, float* out,
                               const int* start, float* vmean, int B,
                               int Hkv, int rows, int T, int pos0, int tq,
                               int bk, int window, float scale,
                               void* stream) {
    return entry<16, 32, 64, 112, 128>(n, kind, hd, q4, kw, vw, out, start,
                                       vmean, B, Hkv, rows, T, pos0, tq, bk,
                                       window, scale, stream);
}
