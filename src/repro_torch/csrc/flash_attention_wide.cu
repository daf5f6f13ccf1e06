// Contiguous-cache flash attention (flash_attention.cuh) at head dims 192
// (nemotron-4-340b's) and 256 (recurrentgemma-2b's): one block an SM (122
// to 194 KB of shared memory) and up to 255 registers a thread for the 24
// or 32 output fragments a row. f32 words are refused at both (Layout::
// FITS). A translation unit of its own, built beside flash_attention.cu.
#include "flash_attention.cuh"

// arguments: flash_attention.cuh, entry()
extern "C" int takum_attention_wide(int n, int kind, int hd, const float* q4,
                                    const void* kw, const void* vw,
                                    float* out, const int* start,
                                    float* vmean, int B, int Hkv, int rows,
                                    int T, int pos0, int tq, int bk,
                                    int window, float scale, void* stream) {
    return entry<192, 256>(n, kind, hd, q4, kw, vw, out, start, vmean, B,
                           Hkv, rows, T, pos0, tq, bk, window, scale,
                           stream);
}
