// The backward pass's dk and dv: an entry of the flash attention library (the kernels,
// their launchers and the argument conventions are in
// flash_attention.cuh, which describes the entries' arguments).
#include "flash_attention.cuh"

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const void* seed, const void* lens,
                                 const void* shift, const void* cu_q,
                                 const void* cu_k, const void* hstart,
                                 const void* tiles, int ntiles,
                                 const void* units, int nunits,
                                 const long long* strides, int B, int H,
                                 int Sq, int Sk, int D, float scale,
                                 int threshold, float inv_keep, int causal,
                                 int dtype, void* stream, const int* hash) {
  return run<kDkv>(q, k, v, dout, dk, dv,
             const_cast<float*>(static_cast<const float*>(lse)),
             static_cast<const float*>(delta), seed, lens, shift, cu_q, cu_k,
             hstart, tiles, ntiles, units, nunits, strides, B, H, Sq, Sk, D,
             scale, threshold, inv_keep, causal, dtype, stream, hash);
}
