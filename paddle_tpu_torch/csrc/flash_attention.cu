// The forward pass: an entry of the flash attention library (the kernels,
// their launchers and the argument conventions are in
// flash_attention.cuh, which describes the entries' arguments).
#include "flash_attention.cuh"

extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* seed,
                             const void* lens, const void* shift,
                             const void* cu_q, const void* cu_k,
                             const void* hstart, const void* tiles,
                             int ntiles, const void* units, int nunits,
                             const long long* strides, int B, int H, int Sq,
                             int Sk, int D, float scale, int threshold,
                             float inv_keep, int causal, int dtype,
                             void* stream, const int* hash) {
  return run<kFwd>(q, k, v, nullptr, out, nullptr, static_cast<float*>(lse),
             nullptr, seed, lens, shift, cu_q, cu_k, hstart, tiles, ntiles,
             units, nunits, strides, B, H, Sq, Sk, D, scale, threshold,
             inv_keep, causal, dtype, stream, hash);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
