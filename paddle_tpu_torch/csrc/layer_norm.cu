// LayerNorm forward and backward over a (rows, d) view, for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_ln_fwd_kernel` and `_ln_bwd_kernel`
// (paddle_tpu/ops/fused_kernels.py, launched at the pallas_call sites in
// `_ln_pallas_fwd` and `_ln_pallas_bwd`): x, w and b all f32 or all
// bf16, affine or not (w and b may each be null: no scale, no shift, as
// the fusion pass's matches give them), without a residual (GPT's pre-LN
// blocks) or with one (BERT's post-LN blocks).
// With a residual r (x's dtype and shape) the kernels normalize x + r,
// summed in f32 as the TPU kernel does and never stored: the backward
// reads x and r again, and the residual's gradient is dx.
//
//   forward   mean = E[x], var = max(E[x^2] - mean^2, 0)   (one pass, f32)
//             rstd = rsqrt(var + eps)
//             y    = (x - mean) * rstd * w + b             (x's dtype)
//   backward  xhat = (x - mean) * rstd,  dy = g * w
//             dx   = (dy - mean(dy) - xhat * mean(dy * xhat)) * rstd
//             dw   = sum_rows g * xhat,  db = sum_rows g    (f32 sums,
//                                                  stored in w's dtype)
//
// What bounds it: bytes.  At (4096, 1024) bf16 the forward moves about
// 16.8 MB (x in, y out) and the backward about 25 MB (g and x in, dx
// out), against a few f32 operations per element.  The design:
//
//  - One warp per row.  A lane owns 8 consecutive columns of each
//    256-column chunk and reads them with one 16-byte load (bf16) or two
//    (f32); for d <= 1024 (d % 8 == 0) the row stays in registers between
//    the statistics and the output, so x is read once.  NC = ceil(d / 256)
//    chunks.
//  - Any other d (the JAX package takes every width: GPT-1.3B's 2048,
//    GPT-13B's 5120, a d that is not a multiple of 8) takes the `_any`
//    kernels: the same warp per row walks the row in chunks twice, once
//    for the sums and once for the output (the second read mostly hits
//    L1/L2).  A lane's sums run in the same order as the register
//    version's, chunk by chunk, so the statistics are the same f32
//    arithmetic.  d % 8 == 0 keeps the 16-byte loads (V = 8); any other d
//    loads one element at a time (V = 1, 32-column chunks).
//  - The `_any` backward cannot keep a row's column sums in registers:
//    one kernel writes dx (two passes over the row for its two sums), a
//    second adds g * xhat and g over a fixed slice of rows per column
//    into the same partial rows the register version writes, and the
//    reduce kernel below adds those in block order.
//  - Row sums go through a xor butterfly of shuffles, which leaves the
//    same bits in every lane.
//  - dw and db need a sum over all rows; the TPU kernel adds them tile by
//    tile on a sequential grid axis.  Here each backward block walks a
//    fixed set of rows (grid-stride, at most 256 blocks) and keeps its
//    warps' column sums in registers; the warps store them to shared
//    memory at once, and each thread adds the 8 warps of its columns in
//    warp order into one partial row per block.  A second kernel adds
//    the partial rows in block order.  No float atomics: dw and db are
//    the same bits on every run.  (Adding the warps one after another,
//    a barrier between each, took as long as the rest of the kernel.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // rows per block (one per warp)
constexpr int kThreads = kWarps * 32;
constexpr int VEC = 8;                  // columns per lane per chunk
constexpr int kChunk = 32 * VEC;        // columns per warp-wide chunk
constexpr int kMaxChunks = 4;
constexpr int kMaxD = kMaxChunks * kChunk;
constexpr int kSlices = 8;              // row slices of the reduce kernel

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// w[col .. col + 7], or `fill` for a null w (the no-affine variant)
template <typename T>
__device__ __forceinline__ void load_or(const T* w, int col, float fill,
                                        float (&v)[VEC]) {
  if (w) {
    load8(w + col, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = fill;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements at p (V = 8: one 16-byte access; V = 1: one element)
template <int V, typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[V]) {
  if constexpr (V == 8) {
    load8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}
template <int V, typename T>
__device__ __forceinline__ void loadv_or(const T* w, int col, float fill,
                                         float (&v)[V]) {
  if (w) {
    loadv<V>(w + col, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = fill;
  }
}
template <int V, typename T>
__device__ __forceinline__ void storev(T* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    store8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) store1(p + i, v[i]);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, int NC, bool RES>
__global__ void __launch_bounds__(kThreads) ln_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ b, T* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;

  float v[NC][VEC];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c * kChunk + lane * VEC;
    if (col < d) {
      load8(x + base + col, v[c]);
      if (RES) {
        float rv[VEC];
        load8(r + base + col, rv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[c][i] += rv[i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1 += v[c][i];
        s2 += v[c][i] * v[c][i];
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / d;
  const float var = fmaxf(s2 / d - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c * kChunk + lane * VEC;
    if (col < d) {
      float wv[VEC], bv[VEC], o[VEC];
      load_or(w, col, 1.f, wv);
      load_or(b, col, 0.f, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = (v[c][i] - mean) * rstd * wv[i] + bv[i];
      store8(y + base + col, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int NC, bool RES>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const T* __restrict__ r, const T* __restrict__ w,
    const float* __restrict__ mean,
    const float* __restrict__ rstd, T* __restrict__ dx,
    float* __restrict__ dw_part, float* __restrict__ db_part, int rows,
    int d) {
  __shared__ float red[kWarps][kMaxD];   // 32 KB
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float dwa[NC][VEC], dba[NC][VEC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) dwa[c][i] = dba[c][i] = 0.f;

  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += stride) {
    const size_t base = static_cast<size_t>(row) * d;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[NC][VEC], dy[NC][VEC];
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * kChunk + lane * VEC;
      if (col < d) {
        float xv[VEC], gv[VEC], wv[VEC];
        load8(x + base + col, xv);
        if (RES) {
          float rv[VEC];
          load8(r + base + col, rv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) xv[i] += rv[i];
        }
        load8(g + base + col, gv);
        load_or(w, col, 1.f, wv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          xh[c][i] = (xv[i] - mu) * rs;
          dy[c][i] = gv[i] * wv[i];
          c1 += dy[c][i];
          c2 += dy[c][i] * xh[c][i];
          dwa[c][i] += gv[i] * xh[c][i];
          dba[c][i] += gv[i];
        }
      }
    }
    c1 = warp_sum(c1) / d;
    c2 = warp_sum(c2) / d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * kChunk + lane * VEC;
      if (col < d) {
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          o[i] = (dy[c][i] - c1 - xh[c][i] * c2) * rs;
        store8(dx + base + col, o);
      }
    }
  }

  // the block's column sums: each warp stores its sums, then each
  // thread adds the 8 warps of its columns in warp order, dw first, then
  // db.  Column c * 256 + lane * 8 + i of a warp sits at
  // c * 256 + i * 32 + lane of its row, so a warp's stores hit 32 banks.
  float* part[2] = {dw_part + static_cast<size_t>(blockIdx.x) * d,
                    db_part + static_cast<size_t>(blockIdx.x) * d};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * kChunk + lane * VEC < d) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          red[warp][c * kChunk + i * 32 + lane] = k == 0 ? dwa[c][i]
                                                         : dba[c][i];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += kThreads) {
      const int r = j % kChunk;
      const int s = j - r + (r % VEC) * 32 + r / VEC;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) acc += red[wp][s];
      part[k][j] = acc;
    }
    __syncthreads();
  }
}

// any d: the row is read twice (sums, then output), V columns per lane per
// 32V-column chunk; a lane's sums run chunk by chunk as in ln_fwd_kernel
template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kThreads) ln_fwd_any_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ b, T* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int rows, int d, float eps) {
  constexpr int CH = 32 * V;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  auto input = [&](int col, float (&v)[V]) {
    loadv<V>(x + base + col, v);
    if (RES) {
      float rv[V];
      loadv<V>(r + base + col, rv);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += rv[i];
    }
  };
  float s1 = 0.f, s2 = 0.f;
  for (int col = lane * V; col < d; col += CH) {
    float v[V];
    input(col, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s1 += v[i];
      s2 += v[i] * v[i];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / d;
  const float var = fmaxf(s2 / d - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int col = lane * V; col < d; col += CH) {
    float v[V], wv[V], bv[V], o[V];
    input(col, v);
    loadv_or<V>(w, col, 1.f, wv);
    loadv_or<V>(b, col, 0.f, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = (v[i] - mean) * rstd * wv[i] + bv[i];
    storev<V>(y + base + col, o);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// any d, backward, dx: one warp per row, the row read twice (the two sums,
// then dx)
template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kThreads) ln_bwd_dx_any_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const T* __restrict__ r, const T* __restrict__ w,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    T* __restrict__ dx, int rows, int d) {
  constexpr int CH = 32 * V;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  const float mu = mean[row];
  const float rs = rstd[row];
  // xhat and dy of V columns
  auto terms = [&](int col, float (&xh)[V], float (&dy)[V]) {
    float xv[V], gv[V], wv[V];
    loadv<V>(x + base + col, xv);
    if (RES) {
      float rv[V];
      loadv<V>(r + base + col, rv);
#pragma unroll
      for (int i = 0; i < V; ++i) xv[i] += rv[i];
    }
    loadv<V>(g + base + col, gv);
    loadv_or<V>(w, col, 1.f, wv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xh[i] = (xv[i] - mu) * rs;
      dy[i] = gv[i] * wv[i];
    }
  };
  float c1 = 0.f, c2 = 0.f;
  for (int col = lane * V; col < d; col += CH) {
    float xh[V], dy[V];
    terms(col, xh, dy);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      c1 += dy[i];
      c2 += dy[i] * xh[i];
    }
  }
  c1 = warp_sum(c1) / d;
  c2 = warp_sum(c2) / d;
  for (int col = lane * V; col < d; col += CH) {
    float xh[V], dy[V], o[V];
    terms(col, xh, dy);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = (dy[i] - c1 - xh[i] * c2) * rs;
    storev<V>(dx + base + col, o);
  }
}

// any d, backward, dw and db: partial row p of dw_part / db_part sums rows
// [p * per, (p + 1) * per) of g * xhat and g.  A block covers 32 columns
// with 8 slices of those rows; slice s adds rows s, s + 8, ... in order,
// then slice 0 adds the 8 slices in order.
template <typename T, bool RES>
__global__ void __launch_bounds__(kThreads) ln_bwd_cols_any_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const T* __restrict__ r, const float* __restrict__ mean,
    const float* __restrict__ rstd, float* __restrict__ dw_part,
    float* __restrict__ db_part, int rows, int d, int per) {
  __shared__ float sw[kSlices][32];
  __shared__ float sb[kSlices][32];
  const int cx = threadIdx.x % 32;
  const int sl = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + cx;
  const int p = blockIdx.y;
  const int end = min(rows, (p + 1) * per);
  float aw = 0.f, ab = 0.f;
  if (col < d) {
    for (int row = p * per + sl; row < end; row += kSlices) {
      const size_t at = static_cast<size_t>(row) * d + col;
      float xv = to_f32(x[at]);
      if (RES) xv += to_f32(r[at]);
      const float gv = to_f32(g[at]);
      aw += gv * ((xv - mean[row]) * rstd[row]);
      ab += gv;
    }
  }
  sw[sl][cx] = aw;
  sb[sl][cx] = ab;
  __syncthreads();
  if (sl == 0 && col < d) {
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {
      s += sw[k][cx];
      t += sb[k][cx];
    }
    dw_part[static_cast<size_t>(p) * d + col] = s;
    db_part[static_cast<size_t>(p) * d + col] = t;
  }
}

// dw[j] = sum over the partial rows p of dw_part[p, j], likewise db.
// A block covers 32 columns with 8 slices of partial rows; slice s adds
// rows s, s + 8, ... in order, then slice 0 adds the 8 slices in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_bwd_reduce_kernel(
    const float* __restrict__ dw_part, const float* __restrict__ db_part,
    T* __restrict__ dw, T* __restrict__ db, int nparts, int d) {
  __shared__ float sw[kSlices][32];
  __shared__ float sb[kSlices][32];
  const int cx = threadIdx.x % 32;
  const int sl = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + cx;
  float aw = 0.f, ab = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int p = sl; p < nparts; p += kSlices) {
      aw += dw_part[static_cast<size_t>(p) * d + col];
      ab += db_part[static_cast<size_t>(p) * d + col];
    }
  }
  sw[sl][cx] = aw;
  sb[sl][cx] = ab;
  __syncthreads();
  if (sl == 0 && col < d) {
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {
      s += sw[k][cx];
      t += sb[k][cx];
    }
    if (dw) store1(dw + col, s);
    if (db) store1(db + col, t);
  }
}

template <typename T, int NC, bool RES>
void fwd(const void* x, const void* r, const void* w, const void* b, void* y,
         void* mean, void* rstd, int rows, int d, float eps, cudaStream_t s) {
  const int grid = (rows + kWarps - 1) / kWarps;
  ln_fwd_kernel<T, NC, RES><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, eps);
}

template <typename T, int NC, bool RES>
void bwd(const void* g, const void* x, const void* r, const void* w,
         const void* mean, const void* rstd, void* dx, void* dw, void* db,
         void* dw_part, void* db_part, int rows, int d, int nparts,
         cudaStream_t s) {
  ln_bwd_kernel<T, NC, RES><<<nparts, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(w),
      static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(dw_part), static_cast<float*>(db_part), rows, d);
  ln_bwd_reduce_kernel<T><<<(d + 31) / 32, kThreads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part),
      static_cast<T*>(dw), static_cast<T*>(db), nparts, d);
}

template <typename T, int V, bool RES>
int fwd_any(const void* x, const void* r, const void* w, const void* b,
            void* y, void* mean, void* rstd, int rows, int d, float eps,
            cudaStream_t s) {
  const int grid = (rows + kWarps - 1) / kWarps;
  ln_fwd_any_kernel<T, V, RES><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool RES>
int bwd_any(const void* g, const void* x, const void* r, const void* w,
            const void* mean, const void* rstd, void* dx, void* dw, void* db,
            void* dw_part, void* db_part, int rows, int d, int nparts,
            cudaStream_t s) {
  ln_bwd_dx_any_kernel<T, V, RES><<<(rows + kWarps - 1) / kWarps, kThreads,
                                    0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<T*>(dx), rows, d);
  const int per = (rows + nparts - 1) / nparts;
  ln_bwd_cols_any_kernel<T, RES><<<dim3((d + 31) / 32, nparts), kThreads, 0,
                                   s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<float*>(dw_part),
      static_cast<float*>(db_part), rows, d, per);
  ln_bwd_reduce_kernel<T><<<(d + 31) / 32, kThreads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part),
      static_cast<T*>(dw), static_cast<T*>(db), nparts, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RES>
int fwd_dispatch(const void* x, const void* r, const void* w, const void* b,
                 void* y, void* mean, void* rstd, int rows, int d, float eps,
                 cudaStream_t s) {
  if (d % VEC != 0)
    return fwd_any<T, 1, RES>(x, r, w, b, y, mean, rstd, rows, d, eps, s);
  if (d > kMaxD)
    return fwd_any<T, VEC, RES>(x, r, w, b, y, mean, rstd, rows, d, eps, s);
  switch ((d + kChunk - 1) / kChunk) {
    case 1: fwd<T, 1, RES>(x, r, w, b, y, mean, rstd, rows, d, eps, s); break;
    case 2: fwd<T, 2, RES>(x, r, w, b, y, mean, rstd, rows, d, eps, s); break;
    case 3: fwd<T, 3, RES>(x, r, w, b, y, mean, rstd, rows, d, eps, s); break;
    case 4: fwd<T, 4, RES>(x, r, w, b, y, mean, rstd, rows, d, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RES>
int bwd_dispatch(const void* g, const void* x, const void* r, const void* w,
                 const void* mean, const void* rstd, void* dx, void* dw,
                 void* db, void* dw_part, void* db_part, int rows, int d,
                 int nparts, cudaStream_t s) {
  if (d % VEC != 0)
    return bwd_any<T, 1, RES>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                              db_part, rows, d, nparts, s);
  if (d > kMaxD)
    return bwd_any<T, VEC, RES>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                                db_part, rows, d, nparts, s);
  switch ((d + kChunk - 1) / kChunk) {
    case 1: bwd<T, 1, RES>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                           db_part, rows, d, nparts, s); break;
    case 2: bwd<T, 2, RES>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                           db_part, rows, d, nparts, s); break;
    case 3: bwd<T, 3, RES>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                           db_part, rows, d, nparts, s); break;
    case 4: bwd<T, 4, RES>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                           db_part, rows, d, nparts, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_res(const void* x, const void* r, const void* w, const void* b,
            void* y, void* mean, void* rstd, int rows, int d, float eps,
            cudaStream_t s) {
  return r ? fwd_dispatch<T, true>(x, r, w, b, y, mean, rstd, rows, d, eps, s)
           : fwd_dispatch<T, false>(x, r, w, b, y, mean, rstd, rows, d, eps,
                                    s);
}

template <typename T>
int bwd_res(const void* g, const void* x, const void* r, const void* w,
            const void* mean, const void* rstd, void* dx, void* dw, void* db,
            void* dw_part, void* db_part, int rows, int d, int nparts,
            cudaStream_t s) {
  return r ? bwd_dispatch<T, true>(g, x, r, w, mean, rstd, dx, dw, db,
                                   dw_part, db_part, rows, d, nparts, s)
           : bwd_dispatch<T, false>(g, x, r, w, mean, rstd, dx, dw, db,
                                    dw_part, db_part, rows, d, nparts, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, w, b and y alike).  The caller
// guarantees rows > 0, d > 0 and 16-byte aligned tensors (rows are 16-byte
// aligned too when d % 8 == 0).  r is the residual, or null for none; w and b may be null (scale 1,
// shift 0).  mean and rstd are f32 (rows,).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* r,
                                  const void* w, const void* b, void* y,
                                  void* mean, void* rstd, int rows, int d,
                                  float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return fwd_res<float>(x, r, w, b, y, mean, rstd, rows, d, eps, s);
  if (dtype == 1)
    return fwd_res<__nv_bfloat16>(x, r, w, b, y, mean, rstd, rows, d, eps,
                                  s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx in x's dtype (also the residual's gradient); dw and db (d,) in w's
// dtype, summed in f32, each skipped when null.  r is the forward's
// residual, or null; w may be null (then dy = g).  dw_part
// and db_part are f32 scratch of nparts * d each; nparts is the grid of
// the row pass (1 <= nparts).
extern "C" int ptt_layer_norm_bwd(const void* g, const void* x,
                                  const void* r, const void* w,
                                  const void* mean, const void* rstd,
                                  void* dx, void* dw, void* db,
                                  void* dw_part, void* db_part, int rows,
                                  int d, int nparts, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || nparts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return bwd_res<float>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                          db_part, rows, d, nparts, s);
  if (dtype == 1)
    return bwd_res<__nv_bfloat16>(g, x, r, w, mean, rstd, dx, dw, db,
                                  dw_part, db_part, rows, d, nparts, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
