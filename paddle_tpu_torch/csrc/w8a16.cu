// Weight-only int8 matrix product, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_w8a16_kernel`
// (paddle_tpu/ops/quant_kernels.py, launched at the pallas_call site in
// `_w8a16_pallas`):
//
//   out[m, n] = (sum_k f32(x[m, k]) * f32(w[k, n])) * scale[n]
//
//   x      (M, K)  f32 or bf16 activations
//   w      (K, N)  int8, per-out-channel symmetric
//   scale  (N,)    f32, applied after the sum (the epilogue)
//   out    (M, N)  x's dtype
//
// What bounds it: at decode (M <= 16) reading the int8 weight and the
// f32 multiply-adds on it take about the same least time (a 1024 x 1024
// weight: 0.3 us of bytes, 0.5 us of f32 FMAs off the tensor cores); at
// prefill (M = 512) the multiply-adds.  The design:
//
//  - One block owns a BM x BN output tile (16 x 32) and all of K.  Its
//    256 threads cover the tile as 8 column groups of 4 columns times 32
//    k-slots: a warp reads 4 weight rows of 32 bytes, each as one 4-byte
//    load per thread, neighbouring threads on neighbouring bytes.  Each
//    weight byte is read once per M-tile.
//  - x for the tile is staged in shared memory as f32, KCH columns at a
//    time; all threads of a k-slot read the same word (a broadcast).
//  - Each thread accumulates BM x 4 outputs in f32 registers.  The 32
//    k-slots are summed by shuffles inside a warp and then over the 8
//    warps through shared memory, in a fixed order, and the scale is
//    applied to the sum.  A row's sum order never depends on M, so a
//    row's result does not depend on how many rows share the launch
//    (the serve engine's bit-identity contract across batch sizes).
//  - K is not split over the grid: one launch per product.  At decode a
//    1024-wide output gives only 32 blocks, which leaves most SMs idle.
//    A split whose sum order stays fixed (no atomics) adds a pass over
//    the parts; PERF.md's split-K A/B found no end-to-end gain from it
//    while the host's launches bound the decode step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // rows per tile
constexpr int BN = 32;        // columns per tile
constexpr int kThreads = 256; // 8 warps
constexpr int KSLOTS = 32;    // k rows one pass of the block covers
constexpr int KCH = 128;      // k columns of x staged at a time

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads) w8a16_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, XT* __restrict__ out, int M, int K,
    int N) {
  __shared__ float xs[BM][KCH];
  __shared__ float red[kThreads / 32][BM][BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int ln = tid % 32;
  const int c = ln & 7;                 // columns 4c .. 4c+3 of the tile
  const int r = warp * 4 + (ln >> 3);   // k-slot 0 .. 31
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KCH) {
    const int kn = min(KCH, K - k0);  // a multiple of KSLOTS
    __syncthreads();
    for (int i = tid; i < BM * kn; i += kThreads) {
      const int mm = i / kn, kk = i % kn;
      const int m = m0 + mm;
      xs[mm][kk] = m < M ? to_float(x[static_cast<size_t>(m) * K + k0 + kk])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = r; kk < kn; kk += KSLOTS) {
      const char4 wq = __ldg(reinterpret_cast<const char4*>(
          w + static_cast<size_t>(k0 + kk) * N + n0 + 4 * c));
      const float w0 = wq.x, w1 = wq.y, w2 = wq.z, w3 = wq.w;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float a = xs[m][kk];
        acc[m][0] = fmaf(a, w0, acc[m][0]);
        acc[m][1] = fmaf(a, w1, acc[m][1]);
        acc[m][2] = fmaf(a, w2, acc[m][2]);
        acc[m][3] = fmaf(a, w3, acc[m][3]);
      }
    }
  }

  // the 4 k-slots of a warp (lanes ln, ln^8, ln^16, ln^24), then the
  // 8 warps, always in the same order
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = acc[m][j];
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      acc[m][j] = s;
    }
  if ((ln >> 3) == 0) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][m][4 * c + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int mm = i / BN, nn = i % BN;
    const int m = m0 + mm, n = n0 + nn;
    if (m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) s += red[wp][mm][nn];
    store(out + static_cast<size_t>(m) * N + n, s * scale[n]);
  }
}

template <typename XT>
void launch(const void* x, const void* w, const void* scale, void* out, int M,
            int K, int N, cudaStream_t stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  w8a16_kernel<XT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<XT*>(out), M, K, N);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  The caller guarantees M > 0,
// N % 32 == 0, K % 32 == 0 and a 4-byte aligned weight.
extern "C" int ptt_w8a16_matmul(const void* x, const void* w,
                                const void* scale, void* out, int M, int K,
                                int N, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    launch<float>(x, w, scale, out, M, K, N, s);
  else if (x_dtype == 1)
    launch<__nv_bfloat16>(x, w, scale, out, M, K, N, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
