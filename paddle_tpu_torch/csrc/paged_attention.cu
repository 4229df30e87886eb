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
//   ws           f32 workspace   (B, H, n_splits, D + 2): each split's
//                                partial (m, l, acc)
//   out          (B, H, D)       q's dtype
//
// What bounds it: bytes.  Each live K/V element is read once and used
// for two flops (one multiply-add against q or p), far below the card's
// ~20 flops per byte at f32.  So the design reads only live bytes, keeps
// many of them in flight on every SM, and lets no long row set the time:
//
//  - Split-K over the context.  A row's positions are cut into splits of
//    kSplit = 128 tokens (8 pages at ps 16), a constant: it depends on
//    neither the batch nor the card, so a row's sums are the same bits in
//    any batch.  The grid runs over (row, head, split), split fastest; a
//    block whose split starts at or past its row's length exits at once.
//    The wrapper never reads the lengths on the host.
//  - Staging.  Each block loads its split's page ids into shared memory
//    (beside its row's length and q, all three in flight together), then
//    each of its 4 warps copies one 32-token chunk of K and V into shared
//    memory with 16-byte cp.async (and int8's scales with 4-byte ones),
//    so all of a split's copies are issued before its first score and a
//    warp scores its chunk while the other chunks are still landing.
//    Positions at or past the length are never loaded.
//  - Scores.  G = D * sizeof(page element) / 16 lanes hold one token's
//    row, 16 bytes each; a warp reads 32 consecutive 16-byte pieces of
//    shared memory at a time (no bank conflicts), reduces each token's
//    dot over its G lanes, and keeps its chunk's scores in registers.
//    sm_scale * log2(e) is folded into q once, so p = exp2(s - m).  On
//    int8 pages each (token, head) scale is read once: k_scale multiplies
//    the score, v_scale the probability, never the elements; the values
//    are widened by a byte permute and a subtraction, not by cvt.
//  - One max per chunk, then p and the weighted sum of V in f32; the 4
//    warps merge in warp order, and the split writes (m, l, acc) to the
//    workspace, or, for a row with one live split, the normalized output.
//  - `paged_combine_kernel` (one block a (row, head)) loads a row's
//    partials in one round beside its length and merges the live splits
//    in split order; a row of length 0 gets 0, as the Pallas kernel's
//    l == 0 -> 1 gives.  Every sum runs in a fixed order: two runs give
//    the same bits, and no atomics are used.
//
// Semantics kept from the TPU kernel: positions >= length are masked
// (never loaded; probability exactly zero), scores and accumulation are
// f32, a row of length 0 returns 0, the output is cast to q's dtype.
// Page ids are clamped into the pool, as an XLA gather clamps its
// indices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the masked-score value of the JAX model
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;                // tokens a warp stages and scores
constexpr int kSplit = kWarps * kChunk;   // SPLIT_TOKENS in the wrapper
constexpr int kCombineThreads = 128;
constexpr int kBatch = 16;                // splits the combine loads at once

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// 16 bytes of shared memory, widened to f32
__device__ __forceinline__ void widen16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// int8: each byte b, biased to b + 128, becomes the low mantissa byte of
// 2^23 (one byte permute and one exact subtraction, where cvt from s8
// runs at a quarter of the f32 rate)
__device__ __forceinline__ void widen16(const int8_t* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + j)) -
          8388736.f;
  }
}

// One block per (row, head, split); G lanes per token row.
template <typename QT, typename KT, int G>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_tables,
    const int* __restrict__ lengths, QT* __restrict__ out,
    float* __restrict__ ws, int BH, int H, int ps, int max_pages,
    int num_pages, int n_splits, float q_scale) {
  constexpr int VEC = 16 / sizeof(KT);  // elements per 16-byte piece
  constexpr int D = G * VEC;
  constexpr int TPW = 32 / G;           // tokens a warp scores at once
  constexpr int STEPS = kChunk / TPW;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* s_kv = reinterpret_cast<KT*>(smem);  // [kWarps][K, V][kChunk][D]
  float* s_acc = reinterpret_cast<float*>(
      smem + kWarps * 2 * kChunk * D * sizeof(KT));  // [kWarps][D]
  __shared__ int s_page[kSplit];
  __shared__ float s_ks[kQuant ? kSplit : 1], s_vs[kQuant ? kSplit : 1];
  __shared__ float s_m[kWarps], s_l[kWarps];

  const int split = blockIdx.x % n_splits;
  const int bh = blockIdx.x / n_splits;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / G, j = lane % G;
  const int width = max_pages * ps;
  const int t0 = split * kSplit;  // < width: n_splits = ceil(width / kSplit)
  const int p0 = t0 / ps;
  // the length, the split's page ids and q are loaded together
  const int np = min(max_pages - 1, (t0 + kSplit - 1) / ps) - p0 + 1;
  const int tid = threadIdx.x;
  if (tid < np)  // np <= kSplit == kThreads
    s_page[tid] = page_tables[static_cast<size_t>(b) * max_pages + p0 + tid];
  const int length = max(0, min(lengths[b], width));
  float qv[VEC];
  const QT* qp = q + static_cast<size_t>(bh) * D + j * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = to_float(qp[i]) * q_scale;
  __syncthreads();
  if (t0 >= length) return;  // uniform over the block

  // stage this warp's chunk: 32 tokens' K and V rows (and int8 scales)
  const int n_live = min(length - t0, kSplit);
  const int c0 = warp * kChunk;
  const int n_tok = max(0, min(n_live - c0, kChunk));
  KT* sk = s_kv + warp * 2 * kChunk * D;
  KT* sv = sk + kChunk * D;
  const size_t tok_stride = static_cast<size_t>(H) * D;
  const int first = t0 - p0 * ps;  // the split's first slot in page p0
  for (int i = lane; i < n_tok * G; i += 32) {
    const int t = i / G, piece = i % G;
    const int pos = first + c0 + t;
    const int page = min(max(s_page[pos / ps], 0), num_pages - 1);
    const size_t row = static_cast<size_t>(page) * ps + pos % ps;
    const size_t off = row * tok_stride + static_cast<size_t>(h) * D +
                       piece * VEC;
    cp_async16(sk + i * VEC, k + off);
    cp_async16(sv + i * VEC, v + off);
  }
  if constexpr (kQuant) {
    for (int t = lane; t < n_tok; t += 32) {
      const int pos = first + c0 + t;
      const int page = min(max(s_page[pos / ps], 0), num_pages - 1);
      const size_t row = static_cast<size_t>(page) * ps + pos % ps;
      cp_async4(s_ks + c0 + t, k_scale + row * H + h);
      cp_async4(s_vs + c0 + t, v_scale + row * H + h);
    }
  }
  cp_async_wait_all();
  __syncwarp();

  float m = kNegInf, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (n_tok > 0) {  // uniform over the warp
    // token i * TPW + g of the chunk: its score, reduced over G lanes
    float s[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      s[i] = kNegInf;
      if (i * TPW < n_tok) {  // uniform: every lane reaches the shuffles
        const int t = i * TPW + g;
        float kf[VEC];
        widen16(sk + t * D + j * VEC, kf);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qv[e], kf[e], d);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if constexpr (kQuant) d *= s_ks[c0 + t];
        if (t < n_tok) s[i] = d;
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) mx = fmaxf(mx, s[i]);
#pragma unroll
    for (int off = 16; off >= G; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    m = mx;  // the chunk's max, the same on every lane
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int t = i * TPW + g;
      if (t < n_tok) {
        const float p = exp2f(s[i] - m);
        l += p;
        float pv = p;
        if constexpr (kQuant) pv *= s_vs[c0 + t];
        float vf[VEC];
        widen16(sv + t * D + j * VEC, vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pv, vf[e], acc[e]);
      }
    }
    // the warp's TPW token groups, added in a fixed butterfly
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
  }
  if (lane < G) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_acc[warp * D + lane * VEC + e] = acc[e];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // merge the warps in warp order; warp 0 always holds a live token, and
  // a warp with none (m = -1e30, l = 0) weighs exp2(-1e30 - M) = 0
  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w]);
  float f[kWarps], L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = exp2f(s_m[w] - M);
    L = fmaf(s_l[w], f[w], L);
  }
  if (length <= kSplit) {  // the row's only split: normalize here
    QT* op = out + static_cast<size_t>(bh) * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o = fmaf(s_acc[w * D + d], f[w], o);
      store(op + d, o / L);
    }
  } else {
    float* wp = ws + (static_cast<size_t>(bh) * n_splits + split) * (D + 2);
    if (threadIdx.x == 0) {
      wp[0] = M;
      wp[1] = L;
    }
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o = fmaf(s_acc[w * D + d], f[w], o);
      wp[2 + d] = o;
    }
  }
}

// One block per (row, head): the row's live splits merged in split order.
// A row with one live split was written by its split; a row of length 0
// gets 0.  The first kBatch splits' partials are loaded in one round
// beside the row's length, before it says which of them are live (the
// others are never used): thread s takes split s's m and l, thread d
// column d of every split's acc.
template <typename QT>
__global__ void __launch_bounds__(kCombineThreads) paged_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ lengths,
    QT* __restrict__ out, int H, int D, int width, int n_splits) {
  __shared__ float s_m[kBatch], s_l[kBatch];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int stride = D + 2;
  const float* w = ws + static_cast<size_t>(bh) * n_splits * stride;
  const int batch = min(n_splits, kBatch);
  if (tid < batch) {
    s_m[tid] = w[tid * stride];
    s_l[tid] = w[tid * stride + 1];
  }
  float a[kBatch];
#pragma unroll
  for (int s = 0; s < kBatch; ++s)
    a[s] = s < batch && tid < D ? w[s * stride + 2 + tid] : 0.f;
  const int length = max(0, min(lengths[bh / H], width));
  const int n = (length + kSplit - 1) / kSplit;
  if (n == 1) return;
  QT* op = out + static_cast<size_t>(bh) * D;
  if (n == 0) {
    for (int d = tid; d < D; d += kCombineThreads) store(op + d, 0.f);
    return;
  }
  __syncthreads();
  auto m_of = [&](int s) { return s < kBatch ? s_m[s] : w[s * stride]; };
  float M = kNegInf;
  for (int s = 0; s < n; ++s) M = fmaxf(M, m_of(s));
  float L = 0.f;  // >= 1: the split holding M has l >= 1
  for (int s = 0; s < n; ++s)
    L = fmaf(s < kBatch ? s_l[s] : w[s * stride + 1], exp2f(m_of(s) - M), L);
  for (int d = tid; d < D; d += kCombineThreads) {
    float o = 0.f;
    if (d == tid) {  // the loaded batch, from registers
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
        if (s < n) o = fmaf(a[s], exp2f(s_m[s] - M), o);
    } else {
      for (int s = 0; s < min(n, kBatch); ++s)
        o = fmaf(w[s * stride + 2 + d], exp2f(s_m[s] - M), o);
    }
    for (int s = kBatch; s < n; ++s)
      o = fmaf(w[s * stride + 2 + d], exp2f(w[s * stride] - M), o);
    store(op + d, o / L);
  }
}

template <typename QT, typename KT, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* pt,
                   const void* len, void* out, void* ws, int BH, int H,
                   int ps, int max_pages, int num_pages, int n_splits,
                   float q_scale, cudaStream_t stream) {
  constexpr int D = G * (16 / sizeof(KT));
  const size_t smem = kWarps * 2 * kChunk * D * sizeof(KT) +
                      kWarps * D * sizeof(float);
  auto kern = paged_split_kernel<QT, KT, G>;
  if (smem > 48 * 1024) {  // once per device
    static std::atomic<unsigned long long> done{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(done.load() & bit)) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      done.fetch_or(bit);
    }
  }
  if (n_splits > 0)
    kern<<<n_splits * BH, kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt),
        static_cast<const int*>(len), static_cast<QT*>(out),
        static_cast<float*>(ws), BH, H, ps, max_pages, num_pages, n_splits,
        q_scale);
  paged_combine_kernel<QT><<<BH, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(len),
      static_cast<QT*>(out), H, D, max_pages * ps, n_splits);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch(int G, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* pt,
                     const void* len, void* out, void* ws, int BH, int H,
                     int ps, int max_pages, int num_pages, int n_splits,
                     float q_scale, cudaStream_t s) {
#define PTT_PAGED_CASE(g)                                                   \
  case g:                                                                   \
    return launch<QT, KT, g>(q, k, v, ks, vs, pt, len, out, ws, BH, H, ps, \
                             max_pages, num_pages, n_splits, q_scale, s);
  switch (G) {
    PTT_PAGED_CASE(1)
    PTT_PAGED_CASE(2)
    PTT_PAGED_CASE(4)
    PTT_PAGED_CASE(8)
    PTT_PAGED_CASE(16)
    PTT_PAGED_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef PTT_PAGED_CASE
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).  The
// (q, pages) pairs built: (f32, f32), (bf16, bf16) and (f32, int8).
// q_scale is sm_scale * log2(e).  The caller guarantees: D * sizeof(page
// element) is a multiple of 16, D / (16 / sizeof(page element)) is a
// power of two <= 32, the page pointers are 16-byte aligned, B * H > 0,
// n_splits == ceil(max_pages * ps / 128), B * H * n_splits < 2^31, and ws
// holds B * H * n_splits * (D + 2) floats.
extern "C" int ptt_paged_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* page_tables,
                                   const void* lengths, void* out, void* ws,
                                   int B, int H, int D, int ps, int max_pages,
                                   int num_pages, int n_splits, float q_scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  const int elem = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  if ((D * elem) % 16 != 0 || n_splits * kSplit < max_pages * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = D * elem / 16;
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0)
    e = dispatch<float, float>(G, q, k, v, k_scale, v_scale, page_tables,
                               lengths, out, ws, BH, H, ps, max_pages,
                               num_pages, n_splits, q_scale, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    e = dispatch<__nv_bfloat16, __nv_bfloat16>(
        G, q, k, v, k_scale, v_scale, page_tables, lengths, out, ws, BH, H,
        ps, max_pages, num_pages, n_splits, q_scale, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    e = dispatch<float, int8_t>(G, q, k, v, k_scale, v_scale, page_tables,
                                lengths, out, ws, BH, H, ps, max_pages,
                                num_pages, n_splits, q_scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
