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
//  - Forward: one warp per row.  A lane owns 8 consecutive columns of each
//    256-column chunk and reads them with one 16-byte load (bf16) or two
//    (f32), chunk by chunk into its sums, so every forward kernel here
//    gives the same f32 arithmetic and the same bits.  For d <= 1024 (d %
//    8 == 0, `ln_fwd_kernel`) the row stays in registers between the
//    statistics and the output, so x is read once.  NC = ceil(d / 256)
//    chunks.  Any other d (the JAX package takes every width: GPT-1.3B's
//    2048, GPT-13B's 5120, a d that is not a multiple of 8; d % 8 != 0
//    loads one element at a time, V = 1, 32-column chunks) takes
//    `ln_fwd_staged_kernel`: persistent blocks over a row partition the
//    wrapper computes from the row count (`ln_fwd_plan`, at most 528
//    blocks), each warp's rows copied by TMA bulk copies into its own ring
//    of shared memory stages, its next rows in flight while it sums one,
//    so x and r are read from device memory once (the kernel before it,
//    `ln_fwd_any_kernel`, read each row twice, the second time mostly from
//    L1/L2, and at V = 1 waited on every element's load); w and b copied
//    into shared memory once a block, y written over x in the stage and
//    stored by a bulk copy.  A row too wide for two stages (f32 with a
//    residual past about 14000) is still read twice by ln_fwd_any_kernel.
//    What the card's times decided (PERF.md, PR 14): at d <= 1024 the
//    register kernel took less time (one row a warp, the whole problem
//    in flight at once: the staged copy and store only add latency,
//    (4096, 768) with a residual 0.0148 against 0.0127 ms), so it keeps
//    that range; past it the staged kernel took 0.62-0.96x the old one's
//    time with the L2 flushed (0.24x at (100, 16001) in bf16), up to 1.1x
//    with the L2 warm at rows of 4 KB or less, with up to four blocks an
//    SM, as many warps as a block has rows and as many stages as a warp
//    has rows (two blocks an SM of 8 warps, 2 rows each, took 10% longer
//    at (4096, 2048)).
//  - Row sums go through a xor butterfly of shuffles, which leaves the
//    same bits in every lane.
//  - dw and db need a sum over all rows; the TPU kernel adds them tile by
//    tile on a sequential grid axis.  Here each backward block sums a
//    fixed set of rows into one f32 partial row, and `ln_bwd_reduce_kernel`
//    adds the partial rows in block order.  No float atomics: dw and db
//    are the same bits on every run.
//  - Backward, d <= 1024 with d % 8 == 0 (`ln_bwd_kernel`): one warp per
//    row, rows grid-stride over at most 256 blocks, the row in registers
//    and each warp's column sums too; the warps store them to shared
//    memory at once, and each thread adds the 8 warps of its columns in
//    warp order.  (Adding the warps one after another, a barrier between
//    each, took as long as the rest of the kernel.)
//  - Backward, every other d (`ln_bwd_one_pass_kernel`): g, x and r read
//    from device memory once.  Block p owns a contiguous range of rows (a
//    function of the row count alone, from the wrapper) and stages them in
//    groups of up to 8 rows into a ring of 2 to 4 stages of shared memory
//    by TMA bulk copies, the next groups in flight while one is used.  From
//    that one copy each thread, owning fixed columns, adds g * xhat and g
//    over the group's rows into its columns' sums, and the rows' two sums
//    for dx; the block adds those, then dx is written from the same copy,
//    4 columns a store where d % 4 == 0.  A row too wide for two stages (d
//    past about 11500 in bf16 with a residual) is read in place twice,
//    its column sums kept in the block's partial row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

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

// four elements at p: one 16-byte (f32) or 8-byte (bf16) access
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// V consecutive elements at p (V = 8: one 16-byte access; V = 4: one 8- or
// 16-byte access; V = 1: one element)
template <int V, typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[V]) {
  if constexpr (V == 8) {
    load8(p, v);
  } else if constexpr (V == 4) {
    load4(p, v);
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
  } else if constexpr (V == 4) {
    store4(p, v);
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

// ---------------------------------------------------------------------------
// the one-pass backward, every d the register kernel does not take
// ---------------------------------------------------------------------------
constexpr int kMaxG = 8;                   // rows of a staged group
constexpr int kOneThreads = 512;           // a block's most threads
constexpr int kOneWarps = kOneThreads / 32;
constexpr int kMaxStages = 4;              // groups in flight, at most
constexpr int kStageTarget = 64 * 1024;    // a stage's bytes, at most
constexpr int kSmemMax = 232448;           // a block's most shared memory
// dynamic shared memory: the stages' mbarriers, the row sums' [warp][row][2]
// and their totals [2][row], then (staged) dw's and db's f32 column sums
// and the stages, each region 16-byte aligned
constexpr int kRedOffset = kMaxStages * 8;
constexpr int kSumOffset = kRedOffset + kOneWarps * kMaxG * 2 * 4;
constexpr int kAccOffset = kSumOffset + 2 * kMaxG * 4;

// the stages' offset: past the column sums, 16-byte aligned
__host__ __device__ __forceinline__ size_t stage_offset(int d) {
  return kAccOffset + ((8 * static_cast<size_t>(d) + 15) & ~size_t(15));
}

// Block p owns rows [p * per, min((p + 1) * per, rows)) and walks them in
// groups of G rows, in order.  STAGED: each group's rows of g, x (and r)
// come into one of `nst` stages of shared memory by TMA bulk copies, the
// next nst - 1 groups' in flight while this one is used, and g, x and r
// are read from device memory once; a row is copied as the 16-byte aligned
// span that holds it (its first element lies (row * d * sizeof(T)) % 16
// bytes into the copy: every 16-byte chunk of a span holds a byte of the
// tensor, so the copy reads nothing off its pages).  Otherwise (a row too
// wide for two stages beside the column sums) the rows are read in place,
// twice, and the column sums kept in the block's partial rows.
//
// Thread t owns column units t, t + blockDim.x, ... (V = 4 columns, or 1
// where d % 4 != 0).  Pass 1, for each unit and each row of the group in
// order: xhat = (x (+ r) - mean) * rstd and dy = g * w; the row's sums of dy
// and dy * xhat, and the unit's column sums of g * xhat and g (mean and
// rstd come from the forward, so the column sums need nothing of the row
// sums).  The row sums go through a butterfly in each warp, then over the
// warps in order (one thread a sum).  Pass 2 reads the group again and
// writes dx.  Each column's sums run over the block's rows in order, so
// the partial row the block writes, and dw and db after the block-order
// reduce, are the same bits on every run: the partition reads `rows`
// alone.  G, the rows of a group, is a template argument: a full group's
// rows run without a test each.
template <typename T, int V, bool RES, bool STAGED, int G>
__global__ void __launch_bounds__(kOneThreads) ln_bwd_one_pass_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const T* __restrict__ r, const T* __restrict__ w,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    T* __restrict__ dx, float* __restrict__ dw_part,
    float* __restrict__ db_part, int rows, int d, int per, int slot,
    int nst) {
  constexpr int NA = RES ? 3 : 2;   // staged arrays: g, x (, r)
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + kRedOffset);
  float* tot = reinterpret_cast<float*>(smem + kSumOffset);   // c1, c2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int p = blockIdx.x;
  const int r0 = p * per, r1 = min(rows, r0 + per);
  const int ngroups = (r1 - r0 + G - 1) / G;
  const int nunits = d / V;         // d % V == 0
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const T* src[3] = {g, x, r};
  float* accw;
  float* accb;
  unsigned char* stages = smem + stage_offset(d);
  if (STAGED) {
    accw = reinterpret_cast<float*>(smem + kAccOffset);
    accb = accw + d;
  } else {
    accw = dw_part + static_cast<size_t>(p) * d;
    accb = db_part + static_cast<size_t>(p) * d;
  }
  const float zero[V] = {};
  for (int u = tid; u < nunits; u += blockDim.x) {
    storev<V>(accw + u * V, zero);
    storev<V>(accb + u * V, zero);
  }

  // thread 0: group `grp`'s rows into stage grp % nst, one bulk copy a
  // row and array
  auto fetch = [&](int grp) {
    const int s = grp % nst, row0 = r0 + grp * G, n = min(G, r1 - row0);
    uint32_t total = 0;
    for (int i = 0; i < n; ++i) {
      const size_t a0 = static_cast<size_t>(row0 + i) * row_bytes;
      const size_t span =
          ((a0 + row_bytes + 15) & ~size_t(15)) - (a0 & ~size_t(15));
      total += NA * static_cast<uint32_t>(span);
    }
    hopper::mbar_arrive_expect(&full[s], total);
    for (int i = 0; i < n; ++i) {
      const size_t a0 = static_cast<size_t>(row0 + i) * row_bytes;
      const size_t lo = a0 & ~size_t(15);
      const size_t span = ((a0 + row_bytes + 15) & ~size_t(15)) - lo;
#pragma unroll
      for (int a = 0; a < NA; ++a)
        hopper::bulk_load(
            stages + (static_cast<size_t>(s * G + i) * NA + a) * slot,
            reinterpret_cast<const unsigned char*>(src[a]) + lo,
            static_cast<uint32_t>(span), &full[s]);
    }
  };
  if (STAGED) {
    if (tid == 0) {
      for (int i = 0; i < nst; ++i) hopper::mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int grp = 0; grp < min(nst, ngroups); ++grp) fetch(grp);
  }

  // one group of n rows from row0 (stage s): FULL (n == G, every group but
  // perhaps a block's last) runs without a test per row
  auto group = [&](auto full_tag, int grp, int s, int row0, int n) {
    constexpr bool FULL = decltype(full_tag)::value;
    // row i of array a: in the stage, or in place
    auto at = [&](int i, int a) -> const T* {
      const size_t a0 = static_cast<size_t>(row0 + i) * row_bytes;
      if (STAGED)
        return reinterpret_cast<const T*>(
                   stages + (static_cast<size_t>(s * G + i) * NA + a) * slot) +
               (a0 & 15) / sizeof(T);
      return src[a] + static_cast<size_t>(row0 + i) * d;
    };
    float mu[G], rs[G], s1[G], s2[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const bool in = FULL || i < n;
      mu[i] = in ? mean[row0 + i] : 0.f;
      rs[i] = in ? rstd[row0 + i] : 0.f;
      s1[i] = s2[i] = 0.f;
    }
    if (STAGED) hopper::mbar_wait(&full[s], (grp / nst) & 1);

    // pass 1: the row sums, and the column sums in the block's order
    for (int u = tid; u < nunits; u += blockDim.x) {
      const int col = u * V;
      float wv[V], aw[V], ab[V];
      loadv_or<V>(w, col, 1.f, wv);
      loadv<V>(accw + col, aw);
      loadv<V>(accb + col, ab);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (FULL || i < n) {
          float gv[V], xv[V];
          loadv<V>(at(i, 0) + col, gv);
          loadv<V>(at(i, 1) + col, xv);
          if (RES) {
            float rv[V];
            loadv<V>(at(i, 2) + col, rv);
#pragma unroll
            for (int e = 0; e < V; ++e) xv[e] += rv[e];
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xh = (xv[e] - mu[i]) * rs[i];
            const float dy = gv[e] * wv[e];
            s1[i] += dy;
            s2[i] += dy * xh;
            aw[e] += gv[e] * xh;
            ab[e] += gv[e];
          }
        }
      }
      storev<V>(accw + col, aw);
      storev<V>(accb + col, ab);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (FULL || i < n) {
        const float a = warp_sum(s1[i]), b = warp_sum(s2[i]);
        if (lane == 0) {
          red[(warp * kMaxG + i) * 2] = a;
          red[(warp * kMaxG + i) * 2 + 1] = b;
        }
      }
    }
    __syncthreads();
    if (tid < 2 * n) {   // thread (i, k): row i's sum k over the warps
      const int i = tid >> 1, k = tid & 1;
      float a = 0.f;
      for (int wp = 0; wp < nwarps; ++wp) a += red[(wp * kMaxG + i) * 2 + k];
      tot[k * kMaxG + i] = a / d;
    }
    __syncthreads();
    float c1[G], c2[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      c1[i] = tot[i];
      c2[i] = tot[kMaxG + i];
    }

    // pass 2: dx from the same copy
    for (int u = tid; u < nunits; u += blockDim.x) {
      const int col = u * V;
      float wv[V];
      loadv_or<V>(w, col, 1.f, wv);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (FULL || i < n) {
          float gv[V], xv[V], o[V];
          loadv<V>(at(i, 0) + col, gv);
          loadv<V>(at(i, 1) + col, xv);
          if (RES) {
            float rv[V];
            loadv<V>(at(i, 2) + col, rv);
#pragma unroll
            for (int e = 0; e < V; ++e) xv[e] += rv[e];
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xh = (xv[e] - mu[i]) * rs[i];
            o[e] = (gv[e] * wv[e] - c1[i] - xh * c2[i]) * rs[i];
          }
          storev<V>(dx + static_cast<size_t>(row0 + i) * d + col, o);
        }
      }
    }
  };

  for (int grp = 0; grp < ngroups; ++grp) {
    const int s = grp % nst, row0 = r0 + grp * G, n = min(G, r1 - row0);
    if (n == G)
      group(std::true_type{}, grp, s, row0, n);
    else
      group(std::false_type{}, grp, s, row0, n);
    __syncthreads();   // the stage and the row sums are free again
    if (STAGED && tid == 0 && grp + nst < ngroups) fetch(grp + nst);
  }

  if (STAGED) {
    float* pw = dw_part + static_cast<size_t>(p) * d;
    float* pb = db_part + static_cast<size_t>(p) * d;
    for (int u = tid; u < nunits; u += blockDim.x) {
      float v[V];
      loadv<V>(accw + u * V, v);
      storev<V>(pw + u * V, v);
      loadv<V>(accb + u * V, v);
      storev<V>(pb + u * V, v);
    }
  }
}

// ---------------------------------------------------------------------------
// the forward: persistent blocks, each warp's rows staged by TMA
// ---------------------------------------------------------------------------
constexpr int kFwdWarps = 8;                        // a block's most warps
// its mbarriers (one a stage of each warp, then the weights'), in bytes
// rounded up to 16: w and b follow them
constexpr int kFwdBars = ((kFwdWarps * kMaxStages + 1) * 8 + 15) / 16 * 16;
// a block's shared memory where four (two) blocks stay on an SM
constexpr int kQuadSmem = 56 * 1024, kPairSmem = 112 * 1024;

// the forward's stages: past the mbarriers and the `nwt` weight rows (w
// and b where not null, each rounded up to 16 bytes), 128-byte aligned
__host__ __device__ __forceinline__ size_t fwd_stage_offset(int d, int es,
                                                            int nwt) {
  const size_t wb = (static_cast<size_t>(d) * es + 15) & ~size_t(15);
  return (kFwdBars + nwt * wb + 127) & ~size_t(127);
}

// Block p owns rows [p * per, min((p + 1) * per, rows)) (`ln_fwd_plan`:
// the row count alone); warp w of its nw warps takes the rows r0 + w, r0 +
// w + nw, ..., one at a time, each as one warp per row in ln_fwd_any_kernel:
// lane l owns the columns l V + c 32 V + i and sums them chunk by chunk,
// the lanes' sums meet in the xor butterfly, and y takes the same f32
// arithmetic, so y, mean and rstd are that kernel's bits (and, at d <=
// 1024, ln_fwd_kernel's).  Each warp has a ring of `nst` stages of one row
// (x, and r), copied by its lane 0 as the 16-byte aligned span that holds
// the row (TMA bulk copies on the stage's mbarrier; the row lies (row * d
// * sizeof(T)) % 16 bytes into its copy), the warp's next rows in flight
// while one is used: x and r are read from device memory once.  `bulk`
// (d * sizeof(T) % 16 == 0, and a warp of more than one row): y is
// written over x in the stage and stored by a bulk copy, the stage
// refilled once that copy has read it; else y is stored from registers
// (a warp of one row refills nothing: on the card that was no slower, and
// 5% faster at (2048, 5120) and (300, 12288), PERF.md).  w and b are
// copied to shared memory once a block, by bulk copies in flight with the
// first rows'.
template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kFwdWarps * 32) ln_fwd_staged_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ w,
    const T* __restrict__ b, T* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int rows, int d, float eps, int per,
    int slot, int nst, int bulk) {
  constexpr int NA = RES ? 2 : 1;   // staged arrays: x (, r)
  constexpr int CH = 32 * V;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp * kMaxStages;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(smem) + kFwdWarps * kMaxStages;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  const int nrows = r1 - r0 > warp ? (r1 - r0 - warp + nw - 1) / nw : 0;
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  // w's and b's copies: each the 16-byte chunks that hold it
  const uint32_t wbytes =
      static_cast<uint32_t>((row_bytes + 15) & ~size_t(15));
  const int nwt = (w != nullptr) + (b != nullptr);
  const T* src[2] = {x, r};
  const T* ws = w ? reinterpret_cast<const T*>(smem + kFwdBars) : nullptr;
  const T* bs =
      b ? reinterpret_cast<const T*>(smem + kFwdBars + (w ? wbytes : 0))
        : nullptr;
  unsigned char* stages = smem + fwd_stage_offset(d, sizeof(T), nwt);
  auto stage = [&](int s, int a) {
    return stages + (static_cast<size_t>(warp * nst + s) * NA + a) * slot;
  };
  // lane 0: the warp's k-th row into stage k % nst
  auto fetch = [&](int k) {
    const int s = k % nst;
    const size_t a0 = static_cast<size_t>(r0 + warp + k * nw) * row_bytes;
    const size_t lo = a0 & ~size_t(15);
    const uint32_t span = static_cast<uint32_t>(
        ((a0 + row_bytes + 15) & ~size_t(15)) - lo);
    hopper::mbar_arrive_expect(&bar[s], NA * span);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      hopper::bulk_load(stage(s, a),
                        reinterpret_cast<const unsigned char*>(src[a]) + lo,
                        span, &bar[s]);
  };
  // each warp's lane 0 sets up its own ring and starts its first rows'
  // copies; thread 0 also copies w and b
  if (lane == 0) {
    for (int i = 0; i < nst; ++i) hopper::mbar_init(&bar[i], 1);
    if (tid == 0) hopper::mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(nst, nrows); ++k) fetch(k);
    if (tid == 0 && nwt) {
      hopper::mbar_arrive_expect(wfull, nwt * wbytes);
      if (w) hopper::bulk_load(const_cast<T*>(ws), w, wbytes, wfull);
      if (b) hopper::bulk_load(const_cast<T*>(bs), b, wbytes, wfull);
    }
  }
  __syncthreads();   // every warp's mbarriers are set up

  for (int k = 0; k < nrows; ++k) {
    const int row = r0 + warp + k * nw, s = k % nst;
    const size_t base = static_cast<size_t>(row) * d;
    const int off = static_cast<int>((base * sizeof(T)) & 15) / sizeof(T);
    const T* xr = reinterpret_cast<const T*>(stage(s, 0)) + off;
    const T* rr = reinterpret_cast<const T*>(stage(s, NA - 1)) + off;
    T* yr = bulk ? const_cast<T*>(xr) : y + base;
    hopper::mbar_wait(&bar[s], (k / nst) & 1);
    auto input = [&](int col, float (&v)[V]) {
      loadv<V>(xr + col, v);
      if (RES) {
        float rv[V];
        loadv<V>(rr + col, rv);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] += rv[i];
      }
    };
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
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
    if (k == 0 && nwt) hopper::mbar_wait(wfull, 0);
#pragma unroll 4
    for (int col = lane * V; col < d; col += CH) {
      float v[V], wv[V], bv[V], o[V];
      input(col, v);
      loadv_or<V>(ws, col, 1.f, wv);
      loadv_or<V>(bs, col, 0.f, bv);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = (v[i] - mean) * rstd * wv[i] + bv[i];
      storev<V>(yr + col, o);
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
    if (bulk) {
      hopper::fence_async_shared();   // y in the stage, seen by the copy
      __syncwarp();
      if (lane == 0) {
        hopper::bulk_store(y + base, xr, static_cast<uint32_t>(row_bytes));
        hopper::tma_store_commit();
        // a stage is free once its store has read it: with 3 or 4 stages
        // the row before's is refilled (its store has had a row's time),
        // with 2 this row's, at once
        const int j = nst > 2 ? k - 1 : k;
        if (j >= 0 && j + nst < nrows) {
          if (nst > 2)
            hopper::bulk_wait_read<1>();
          else
            hopper::bulk_wait_read<0>();
          fetch(j + nst);
        }
      }
    } else {
      __syncwarp();   // the stage is read
      if (lane == 0 && k + nst < nrows) fetch(k + nst);
    }
  }
  // the stores have read the stages before the block's shared memory goes
  if (bulk && lane == 0) hopper::tma_store_wait<true>();
}

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

// the staged forward's shape, the first that fits beside w and b: the
// shared memory of four blocks an SM, then two, then one; as many warps
// as the block has rows (up to 8), then fewer; each with a ring of as
// many stages as it has rows (2 to 4; one for a warp of one row).  Else
// the rows in place, read twice, by ln_fwd_any_kernel.
template <typename T, int V, bool RES>
int fwd_staged(const void* x, const void* r, const void* w, const void* b,
               void* y, void* mean, void* rstd, int rows, int d, float eps,
               int nblocks, int per, cudaStream_t s) {
  constexpr int NA = RES ? 2 : 1;
  const long long bytes = static_cast<long long>(d) * sizeof(T);
  // a row's copy: its bytes, and 16 more where rows are not 16-byte aligned
  const long long slot = (bytes + 15) / 16 * 16 + (bytes % 16 ? 16 : 0);
  const int nwt = (w != nullptr) + (b != nullptr);
  int top = 1;   // the block's most warps: its rows, to a power of 2
  while (top < kFwdWarps && top < per) top *= 2;
  const long long fixed =
      static_cast<long long>(fwd_stage_offset(d, sizeof(T), nwt));
  int warps = top;
  long long nst = 0;
  bool fits = false;
  for (const long long room : {kQuadSmem, kPairSmem, kSmemMax}) {
    for (warps = top; warps >= 1; warps /= 2) {
      const long long own = (per + warps - 1) / warps;   // a warp's rows
      nst = std::min<long long>(std::min<long long>(kMaxStages, own),
                                (room - fixed) / (warps * NA * slot));
      fits = nst >= std::min<long long>(2, own);
      if (fits) break;
    }
    if (fits) break;
  }
  if (!fits)
    return fwd_any<T, V, RES>(x, r, w, b, y, mean, rstd, rows, d, eps, s);
  const size_t smem = static_cast<size_t>(fixed + nst * warps * NA * slot);
  auto kern = ln_fwd_staged_kernel<T, V, RES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nblocks, warps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, eps, per,
      static_cast<int>(slot), static_cast<int>(nst),
      bytes % 16 == 0 && (per + warps - 1) / warps > 1);
  return static_cast<int>(cudaGetLastError());
}

// the one-pass backward: groups of G rows (a power of 2, up to 8) in
// stages of about kStageTarget bytes, as many stages (2 to 4) as fit beside
// the column sums, or the rows in place where two stages of one row each do
// not; then the reduce kernel over the partial rows
template <typename T, int V, bool RES, bool STAGED, int G>
int bwd_one_pass(const void* g, const void* x, const void* r, const void* w,
                 const void* mean, const void* rstd, void* dx, void* dw,
                 void* db, void* dw_part, void* db_part, int rows, int d,
                 int nparts, int per, int slot, int nst, size_t smem,
                 cudaStream_t s) {
  auto kern = ln_bwd_one_pass_kernel<T, V, RES, STAGED, G>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many threads as column units, at most 512, each taking as many
  // units as the next
  const int units = d / V;
  const int waves = (units + kOneThreads - 1) / kOneThreads;
  const int threads =
      std::max(32, ((units + waves - 1) / waves + 31) / 32 * 32);
  kern<<<nparts, threads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(dw_part),
      static_cast<float*>(db_part), rows, d, per, slot, nst);
  ln_bwd_reduce_kernel<T><<<(d + 31) / 32, kThreads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<const float*>(db_part),
      static_cast<T*>(dw), static_cast<T*>(db), nparts, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool RES>
int bwd_any(const void* g, const void* x, const void* r, const void* w,
            const void* mean, const void* rstd, void* dx, void* dw, void* db,
            void* dw_part, void* db_part, int rows, int d, int nparts,
            int per, cudaStream_t s) {
  constexpr int NA = RES ? 3 : 2;
  const long long bytes = static_cast<long long>(d) * sizeof(T);
  // a row's copy: its bytes, and 16 more where rows are not 16-byte aligned
  const long long slot = (bytes + 15) / 16 * 16 + (bytes % 16 ? 16 : 0);
  const long long row_stage = NA * slot;
  const long long fixed = static_cast<long long>(stage_offset(d));
  int G = kMaxG;
  while (G > 1 && G * row_stage > kStageTarget) G /= 2;
  long long nst = 0;
  for (; G >= 1; G /= 2) {
    nst = std::min<long long>(kMaxStages, (kSmemMax - fixed) / (G * row_stage));
    if (nst >= 2) break;
  }
#define PTT_ONE_PASS(STAGED, GN)                                            \
  bwd_one_pass<T, V, RES, STAGED, GN>(                                      \
      g, x, r, w, mean, rstd, dx, dw, db, dw_part, db_part, rows, d, nparts, \
      per, static_cast<int>(slot), STAGED ? static_cast<int>(nst) : 1,      \
      STAGED ? static_cast<size_t>(fixed + nst * GN * row_stage)            \
             : static_cast<size_t>(kAccOffset),                             \
      s)
  switch (nst >= 2 ? G : 0) {
    case 8: return PTT_ONE_PASS(true, 8);
    case 4: return PTT_ONE_PASS(true, 4);
    case 2: return PTT_ONE_PASS(true, 2);
    case 1: return PTT_ONE_PASS(true, 1);
    default: return PTT_ONE_PASS(false, kMaxG);
  }
#undef PTT_ONE_PASS
}

// d <= 1024 with d % 8 == 0: the register kernel, a row in registers
// (on the card it took less time than the staged kernel at every such
// shape timed, PERF.md); every other d the staged kernel, 8 columns a lane
// per 256-column chunk where d % 8 == 0 (16-byte loads), else 1 per 32
template <typename T, bool RES>
int fwd_dispatch(const void* x, const void* r, const void* w, const void* b,
                 void* y, void* mean, void* rstd, int rows, int d, float eps,
                 int nblocks, int per, cudaStream_t s) {
  if (d % VEC != 0)
    return fwd_staged<T, 1, RES>(x, r, w, b, y, mean, rstd, rows, d, eps,
                                 nblocks, per, s);
  if (d > kMaxD)
    return fwd_staged<T, VEC, RES>(x, r, w, b, y, mean, rstd, rows, d, eps,
                                   nblocks, per, s);
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
                 int nparts, int per, cudaStream_t s) {
  // the one-pass kernel: 4-column units where rows are 8-byte aligned (twice
  // the threads of 8-column ones: the kernel waits on its shared memory
  // loads more than on its copies), else 1
  if (d % VEC != 0 || d > kMaxD) {
    return d % 4 == 0
               ? bwd_any<T, 4, RES>(g, x, r, w, mean, rstd, dx, dw, db,
                                    dw_part, db_part, rows, d, nparts, per, s)
               : bwd_any<T, 1, RES>(g, x, r, w, mean, rstd, dx, dw, db,
                                    dw_part, db_part, rows, d, nparts, per,
                                    s);
  }
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
            int nblocks, int per, cudaStream_t s) {
  return r ? fwd_dispatch<T, true>(x, r, w, b, y, mean, rstd, rows, d, eps,
                                   nblocks, per, s)
           : fwd_dispatch<T, false>(x, r, w, b, y, mean, rstd, rows, d, eps,
                                    nblocks, per, s);
}

template <typename T>
int bwd_res(const void* g, const void* x, const void* r, const void* w,
            const void* mean, const void* rstd, void* dx, void* dw, void* db,
            void* dw_part, void* db_part, int rows, int d, int nparts,
            int per, cudaStream_t s) {
  return r ? bwd_dispatch<T, true>(g, x, r, w, mean, rstd, dx, dw, db,
                                   dw_part, db_part, rows, d, nparts, per, s)
           : bwd_dispatch<T, false>(g, x, r, w, mean, rstd, dx, dw, db,
                                    dw_part, db_part, rows, d, nparts, per,
                                    s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, w, b and y alike).  The caller
// guarantees rows > 0, d > 0 and 16-byte aligned tensors (rows are 16-byte
// aligned too when d % 8 == 0).  r is the residual, or null for none; w and
// b may be null (scale 1, shift 0).  mean and rstd are f32 (rows,).  Block
// p of nblocks takes rows [p * per, (p + 1) * per) (nblocks * per >= rows).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* r,
                                  const void* w, const void* b, void* y,
                                  void* mean, void* rstd, int rows, int d,
                                  float eps, int nblocks, int per, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || nblocks < 1 || per < 1 ||
      static_cast<long long>(nblocks) * per < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return fwd_res<float>(x, r, w, b, y, mean, rstd, rows, d, eps, nblocks,
                          per, s);
  if (dtype == 1)
    return fwd_res<__nv_bfloat16>(x, r, w, b, y, mean, rstd, rows, d, eps,
                                  nblocks, per, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx in x's dtype (also the residual's gradient); dw and db (d,) in w's
// dtype, summed in f32, each skipped when null.  r is the forward's
// residual, or null; w may be null (then dy = g).  dw_part and db_part are
// f32 scratch of nparts * d each, one partial row per block of the row
// pass: the register kernel's blocks take rows grid-stride; the one-pass
// kernel's block p takes rows [p * per, (p + 1) * per) (nparts * per >=
// rows).
extern "C" int ptt_layer_norm_bwd(const void* g, const void* x,
                                  const void* r, const void* w,
                                  const void* mean, const void* rstd,
                                  void* dx, void* dw, void* db,
                                  void* dw_part, void* db_part, int rows,
                                  int d, int nparts, int per, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || nparts < 1 || per < 1 ||
      static_cast<long long>(nparts) * per < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return bwd_res<float>(g, x, r, w, mean, rstd, dx, dw, db, dw_part,
                          db_part, rows, d, nparts, per, s);
  if (dtype == 1)
    return bwd_res<__nv_bfloat16>(g, x, r, w, mean, rstd, dx, dw, db,
                                  dw_part, db_part, rows, d, nparts, per, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
