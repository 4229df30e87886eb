// Softmax cross-entropy forward and backward over (rows, V) logits, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels `_xent_fwd_kernel` and `_xent_bwd_kernel`
// (paddle_tpu/ops/fused_kernels.py, launched at the pallas_call sites in
// `_xent_pallas_fwd` and `_xent_pallas_bwd`), logits f32 or bf16, int32
// labels:
//
//   forward   m = max_j x_j,  l = sum_j exp(x_j - m)  (l = 1 where it is 0)
//             lse  = m + log(l)                           (f32)
//             t    = x[clip(label, 0, V - 1)]
//             loss = lse - t, or lse - (1 - ls) t - ls mean(x) with
//                    smoothing ls > 0; 0 where label == ignore_index
//   backward  dx = g * (exp(x - lse) - (1 - ls) onehot - ls / V)
//                  (the last term only with ls > 0), 0 on ignored rows,
//                  in x's dtype
//
// What bounds it: bytes.  At the MLM head's (4096, 30528) bf16 the
// forward reads 250 MB of logits for a few operations per element, and
// the backward reads the logits of the rows it needs and writes dx.  The
// design:
//
//  - A row is taken by one block of 256 threads, at every V.  The NSP
//    head's V = 2 leaves most of them idle; its time, beside the step's,
//    is in PERF.md.  Each thread keeps a running (m, l), folding in 16
//    bytes at a time (8 bf16 or 4 f32 logits): the largest of the 8
//    first, one rescale of l when the maximum grows, then one exp2 per
//    logit.  The (rows, V) probabilities never exist in device memory,
//    as on the TPU.
//  - Rows need not start on a 16-byte boundary (V = 30522, V = 2): a row
//    is read as a scalar head up to the first boundary, whole 16-byte
//    vectors, then a scalar tail.  Four vectors are loaded before any is
//    used, so each thread keeps 64 bytes in flight.
//  - The threads' (m, l) pairs and logit sums merge in a fixed order: a
//    xor butterfly within each warp, then thread 0 merges the warps in
//    warp order.  The target logit is read by its index, the sum of the
//    logits is taken only with smoothing.  No atomics, so two runs give
//    the same bits.
//  - The backward is one elementwise pass from the saved lse, with the
//    same head/vector/tail walk.  A row whose label is ignore_index gets
//    dx = 0 without its logits being read: at the MLM head 84% of the
//    rows are such.  It takes exp(x - lse) with expf, not exp2f, and
//    1 - ls and ls / V rounded once from the caller's values, so that
//    it does the plain version's f32 arithmetic: with smoothing,
//    exp(x - lse) - ls / V cancels where p is near ls / V, and a last-bit
//    difference in p would become many bf16 steps of the result.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;              // vectors in flight per thread
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);   // logits per 16 bytes
};

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stores go through __stwb, one 16-byte st.global the compiler cannot
// split: a plain store through a cast pointer may be split into four
// 4-byte stores, and in the backward that made the MLM shape 1.4x slower
// (PERF.md).
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  __stwb(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                           v[2 * i + 1]);
  __stwb(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Fold n logits into the running (m, l).  While every logit seen is
// -inf, m stays -inf and l 0.
template <int N>
__device__ __forceinline__ void absorb(float& m, float& l,
                                       const float (&v)[N]) {
  float cm = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) cm = fmaxf(cm, v[i]);
  if (cm > m) {
    l *= exp2f((m - cm) * kLog2e);
    m = cm;
  }
  if (m != -INFINITY) {
#pragma unroll
    for (int i = 0; i < N; ++i) l += exp2f((v[i] - m) * kLog2e);
  }
}

// (m, l) <- (m, l) merged with (m2, l2).
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  l = l * exp2f((m - mx) * kLog2e) + l2 * exp2f((m2 - mx) * kLog2e);
  m = mx;
}

// A row's walk: `head` scalars up to the first 16-byte boundary, `nvec`
// whole vectors, then scalars from `tail` to V.
struct RowSplit {
  int head, nvec, tail;
};

template <typename T>
__device__ __forceinline__ RowSplit split_row(const T* row, int V) {
  constexpr int N = Vec<T>::N;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(static_cast<int>(((16 - mis) & 15) / sizeof(T)), V);
  const int nvec = (V - head) / N;
  return {head, nvec, head + nvec * N};
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(kThreads) xent_fwd_kernel(
    const T* __restrict__ x, const int* __restrict__ labels,
    float* __restrict__ loss, float* __restrict__ lse_out, int V,
    int ignore_index, float smoothing) {
  constexpr int N = Vec<T>::N;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * V;
  const RowSplit sp = split_row(xr, V);

  float m = -INFINITY, l = 0.f, s = 0.f;
  for (int j = tid; j < sp.head; j += kThreads) {
    const float v[1] = {to_f32(xr[j])};
    absorb<1>(m, l, v);
    if (SMOOTH) s += v[0];
  }
  const T* body = xr + sp.head;
  int i = tid;
  for (; i + (kUnroll - 1) * kThreads < sp.nvec; i += kUnroll * kThreads) {
    float v[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_vec(body + static_cast<size_t>(i + u * kThreads) * N, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      absorb<N>(m, l, v[u]);
      if (SMOOTH) {
#pragma unroll
        for (int k = 0; k < N; ++k) s += v[u][k];
      }
    }
  }
  for (; i < sp.nvec; i += kThreads) {
    float v[N];
    load_vec(body + static_cast<size_t>(i) * N, v);
    absorb<N>(m, l, v);
    if (SMOOTH) {
#pragma unroll
      for (int k = 0; k < N; ++k) s += v[k];
    }
  }
  for (int j = sp.tail + tid; j < V; j += kThreads) {
    const float v[1] = {to_f32(xr[j])};
    absorb<1>(m, l, v);
    if (SMOOTH) s += v[0];
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
    if (SMOOTH) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  constexpr int kWarps = kThreads / 32;
  __shared__ float part[3][kWarps];
  const int warp = tid / 32;
  if (tid % 32 == 0) {
    part[0][warp] = m;
    part[1][warp] = l;
    part[2][warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    m = part[0][0];
    l = part[1][0];
    s = part[2][0];
    for (int w = 1; w < kWarps; ++w) {
      merge(m, l, part[0][w], part[1][w]);
      s += part[2][w];
    }
    const int lab = labels[row];
    const float t = to_f32(xr[min(max(lab, 0), V - 1)]);
    const float lse = m + logf(l == 0.f ? 1.f : l);
    float out = lse - t;
    if (SMOOTH) out = lse - (1.f - smoothing) * t - smoothing * (s / V);
    loss[row] = lab != ignore_index ? out : 0.f;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) xent_bwd_kernel(
    const T* __restrict__ x, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g,
    T* __restrict__ dx, int V, int ignore_index, float on, float off) {
  constexpr int N = Vec<T>::N;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * V;
  const T* xr = x + base;
  T* dr = dx + base;              // dx rows share x's alignment
  const RowSplit sp = split_row(xr, V);
  const int lab = labels[row];
  T* dbody = dr + sp.head;

  if (lab == ignore_index) {      // dx = 0, the logits unread
    float z[N];
#pragma unroll
    for (int k = 0; k < N; ++k) z[k] = 0.f;
    for (int j = tid; j < sp.head; j += kThreads) store1(dr + j, 0.f);
    for (int i = tid; i < sp.nvec; i += kThreads)
      store_vec(dbody + static_cast<size_t>(i) * N, z);
    for (int j = sp.tail + tid; j < V; j += kThreads) store1(dr + j, 0.f);
    return;
  }

  const int target = min(max(lab, 0), V - 1);
  const float gr = g[row];
  const float ls = lse[row];
  // dx = g * (p - on * onehot - off), on = 1 - smoothing, off = smoothing
  // / V (0 without smoothing)
  auto grad = [&](float v, int col) {
    const float d = expf(v - ls) - (col == target ? on : 0.f) - off;
    return gr * d;
  };
  for (int j = tid; j < sp.head; j += kThreads)
    store1(dr + j, grad(to_f32(xr[j]), j));
  const T* body = xr + sp.head;
  int i = tid;
  for (; i + (kUnroll - 1) * kThreads < sp.nvec; i += kUnroll * kThreads) {
    float v[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_vec(body + static_cast<size_t>(i + u * kThreads) * N, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = sp.head + (i + u * kThreads) * N;
#pragma unroll
      for (int k = 0; k < N; ++k) v[u][k] = grad(v[u][k], col + k);
      store_vec(dbody + static_cast<size_t>(i + u * kThreads) * N, v[u]);
    }
  }
  for (; i < sp.nvec; i += kThreads) {
    float v[N];
    load_vec(body + static_cast<size_t>(i) * N, v);
    const int col = sp.head + i * N;
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = grad(v[k], col + k);
    store_vec(dbody + static_cast<size_t>(i) * N, v);
  }
  for (int j = sp.tail + tid; j < V; j += kThreads)
    store1(dr + j, grad(to_f32(xr[j]), j));
}

template <typename T>
int fwd(const void* x, const void* labels, void* loss, void* lse, int rows,
        int V, int ignore_index, float smoothing, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const int* lp = static_cast<const int*>(labels);
  float* out = static_cast<float*>(loss);
  float* lo = static_cast<float*>(lse);
  if (smoothing > 0.f)
    xent_fwd_kernel<T, true><<<rows, kThreads, 0, s>>>(
        xp, lp, out, lo, V, ignore_index, smoothing);
  else
    xent_fwd_kernel<T, false><<<rows, kThreads, 0, s>>>(
        xp, lp, out, lo, V, ignore_index, smoothing);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* labels, const void* lse, const void* g,
        void* dx, int rows, int V, int ignore_index, float on, float off,
        cudaStream_t s) {
  xent_bwd_kernel<T><<<rows, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dx), V, ignore_index, on, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees rows > 0,
// V > 0, contiguous logits at a 16-byte aligned base, int32 labels and f32
// loss and lse, each (rows,).
extern "C" int ptt_softmax_xent_fwd(const void* x, const void* labels,
                                    void* loss, void* lse, int rows, int V,
                                    int ignore_index, float smoothing,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return fwd<float>(x, labels, loss, lse, rows, V, ignore_index,
                               smoothing, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, labels, loss, lse, rows, V,
                                       ignore_index, smoothing, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx in x's dtype, like x contiguous at a 16-byte aligned base; lse and g
// f32 (rows,).  on = 1 - smoothing and off = smoothing / V, each rounded
// to f32 once by the caller.
extern "C" int ptt_softmax_xent_bwd(const void* x, const void* labels,
                                    const void* lse, const void* g, void* dx,
                                    int rows, int V, int ignore_index,
                                    float on, float off, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return bwd<float>(x, labels, lse, g, dx, rows, V, ignore_index,
                               on, off, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, labels, lse, g, dx, rows, V,
                                       ignore_index, on, off, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
