// Decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_paged_kernel` and `_paged_kernel_int8`
// (paddle_tpu/ops/paged_attention.py, launched at pallas_call sites
// `_paged_attention_pallas` and `_paged_attention_int8_pallas`).
//
//   q            (B, H, D)       one query token per row: f32 or bf16
//                                with pages of its own dtype, f32 with
//                                int8 pages
//   k/v pages    (P, ps, H, D)   f32, bf16 or int8
//   k/v scales   (P, ps, H)      f32, int8 pages only
//   page_tables  (B, max_pages)  int32; position t lives in page
//                                pt[b, t / ps], slot t % ps
//   lengths      (B,)            int32 live positions per row
//   out          (B, H, D)       q's dtype
//
// What bounds it: bytes.  Each live K/V element is read once and used
// for two flops (one multiply-add against q or p), far below the card's
// ~20 flops per byte at f32.  The design therefore aims at reading only
// live bytes, with wide loads and many of them in flight:
//
//  - The TPU kernel walks the page axis as a sequential grid dimension
//    carrying m/l/acc in scratch.  Here one block owns one (row, head)
//    and walks only the ceil(length/ps) live pages itself; dead pages
//    and dead slots are never loaded.
//  - A token's D values for one head are contiguous (stride H*D between
//    tokens).  A group of D*sizeof(T)/16 threads reads one token's row
//    with one 16-byte load per thread; the block's groups take tokens
//    g, g+NG, g+2NG, ... and each thread has U tokens' K and V loads in
//    flight before it computes.
//  - Each group keeps its own online softmax (m, l, acc) in f32
//    registers; the groups merge once through shared memory at the end.
//
// Semantics kept from the TPU kernel: positions >= length are masked
// (never loaded; their probability is exactly zero, as after the
// re-mask of the TPU kernel), scores and accumulation are f32, l == 0
// gives 1, the output is cast to q's dtype.  int8 values are widened
// and multiplied by their (token, head) scale before the dot.  Page ids
// are clamped into the pool, as an XLA gather clamps its indices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the masked-score value of the JAX model
constexpr int kThreads = 128;
constexpr int kUnroll = 4;         // tokens in flight per group

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One 16-byte load, widened to f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 u = __ldg(reinterpret_cast<const int4*>(p));
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_tables,
    const int* __restrict__ lengths, QT* __restrict__ out, int H, int D,
    int ps, int max_pages, int num_pages, float sm_scale) {
  constexpr int VEC = 16 / sizeof(KT);  // elements per 16-byte load
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  __shared__ float sm_m[kThreads];
  __shared__ float sm_l[kThreads];
  __shared__ float sm_acc[kThreads * VEC];  // NG * D == kThreads * VEC

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int G = D / VEC;         // threads per token (power of two <= 32)
  const int NG = kThreads / G;   // token groups in the block
  const int g = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int length = max(0, min(lengths[b], max_pages * ps));
  const int* pt = page_tables + static_cast<size_t>(b) * max_pages;
  const size_t tok_stride = static_cast<size_t>(H) * D;
  const size_t col = static_cast<size_t>(h) * D + lane * VEC;

  float qv[VEC];
  const QT* qp = q + (static_cast<size_t>(b) * H + h) * D + lane * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = to_float(qp[i]);

  float m = kNegInf, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // the trip count is uniform over the block, so every lane of a warp
  // reaches the shuffles below, live token or not
  for (int base = 0; base < length; base += NG * kUnroll) {
    float kf[kUnroll][VEC], vf[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * NG + g;
      live[u] = t < length;
      if (live[u]) {
        const int page = min(max(pt[t / ps], 0), num_pages - 1);
        const size_t row = static_cast<size_t>(page) * ps + t % ps;
        load16(k + row * tok_stride + col, kf[u]);
        load16(v + row * tok_stride + col, vf[u]);
        if (kQuant) {
          const float ks = k_scale[row * H + h];
          const float vs = v_scale[row * H + h];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            kf[u][i] *= ks;
            vf[u][i] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(qv[i], kf[u][i], s);
      for (int off = G / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= sm_scale;
      if (live[u]) {
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vf[u][i], acc[i] * alpha);
        m = m_new;
      }
    }
  }

  // merge the groups' partial softmaxes, in group order
  if (lane == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sm_acc[g * D + lane * VEC + i] = acc[i];
  __syncthreads();
  float mx = kNegInf;
  for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j]);
  float denom = 0.f;
  for (int j = 0; j < NG; ++j) denom += sm_l[j] * expf(sm_m[j] - mx);
  if (denom == 0.f) denom = 1.f;
  QT* op = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
    for (int j = 0; j < NG; ++j) o += sm_acc[j * D + d] * expf(sm_m[j] - mx);
    store(op + d, o / denom);
  }
}

template <typename QT, typename KT>
void launch(const void* q, const void* k, const void* v, const void* ks,
            const void* vs, const void* pt, const void* len, void* out, int B,
            int H, int D, int ps, int max_pages, int num_pages, float scale,
            cudaStream_t stream) {
  paged_attention_kernel<QT, KT><<<B * H, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(len), static_cast<QT*>(out), H, D, ps,
      max_pages, num_pages, scale);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).  The
// (q, pages) pairs built: (f32, f32), (bf16, bf16) and (f32, int8).
// The caller guarantees: D * sizeof(page element) is a multiple of 16,
// D / (16 / sizeof(page element)) is a power of two <= 32, the page
// pointers are 16-byte aligned, and B * H > 0.
extern "C" int ptt_paged_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* page_tables,
                                   const void* lengths, void* out, int B,
                                   int H, int D, int ps, int max_pages,
                                   int num_pages, float sm_scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    launch<float, float>(q, k, v, k_scale, v_scale, page_tables, lengths, out,
                         B, H, D, ps, max_pages, num_pages, sm_scale, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, k_scale, v_scale,
                                         page_tables, lengths, out, B, H, D,
                                         ps, max_pages, num_pages, sm_scale, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    launch<float, int8_t>(q, k, v, k_scale, v_scale, page_tables, lengths,
                          out, B, H, D, ps, max_pages, num_pages, sm_scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
