// The fusion pass's block kernels for Hopper (sm_90a): (residual +)
// LayerNorm + matmul (+ bias), and matmul (+ bias) + gelu.
//
// Replaces the Pallas kernels `_lnmm_fwd_kernel` and `_mbg_fwd_kernel`
// (paddle_tpu/ops/fused_kernels.py, launched at the pallas_call sites in
// `_lnmm_pallas_fwd` and `_mbg_pallas_fwd`).  x is (M, K) row-major; W is
// (K, N) with any strides, one of them 1: a Linear weight is read with n
// contiguous, and the transposed view of a (N, K) embedding table (BERT's
// tied decoder) with k contiguous, in place.  x, r, the LayerNorm's w and
// b, W, the bias and the outputs are all f32 or all bf16.
//
//   ln_matmul   s = x (+ r) in f32; mean, var = max(E[s^2] - mean^2, 0),
//               rstd = rsqrt(var + eps) (one pass, f32, as the LayerNorm
//               kernel); h = (s - mean) * rstd (* w) (+ b), ROUNDED TO x's
//               DTYPE; y = h @ W (+ bias), f32 sums, stored in x's dtype
//   mm_gelu     z = x @ W (+ bias), f32 sums; y = gelu(z) from the f32 sum
//               (tanh or erf form, `_gelu_f32`); z stored in x's dtype for
//               the backward, y in x's dtype
//
// What bounds them: operations.  At GPT-345M's (8192, 1024) @ (1024, 3072)
// the LayerNorm + matmul does 51.5 GFLOP over about 23 MB; the others are
// alike (PERF.md).  The design is the simple one, a first version:
//
//  - Output tiles of BM x BN, warps of 64 x 32 (32 x 32 in f32).  bf16
//    products by `mma.sync` m16n8k16 with f32 accumulators and `ldmatrix`
//    fragment loads (`.trans` for a tile of W stored n-major); f32 by FMAs
//    in the same fragment layout (no TF32).  The tile shapes (`Cfg` below)
//    are the fastest of those measured at the paths' shapes (PERF.md):
//    64-deep k tiles in bf16; wider 64 x 64 warp tiles lost occupancy.
//  - W (and, for mm_gelu, x) streams through shared memory in k tiles,
//    ST in flight (cp.async) while the oldest is used.  Edge tiles (any M,
//    N a multiple of 16 bytes, K of 8) are zero-filled by the copies'
//    source size and masked at the store.
//  - ln_matmul: the block first loads its BM rows of x (and r) in full
//    (K <= 1024), computes the statistics per row with one warp per row
//    exactly as the LayerNorm kernel does, and writes h into shared memory
//    (64 x 1024 bf16 = 128 KB, or 32 rows in f32); the k loop then reads A
//    from there and streams only W.  Where the TPU grid (i, j) recomputes
//    a row block's statistics for every column tile, a block here walks a
//    run of column tiles on one h (as many blocks as fill the SMs), W
//    streaming on across the tiles so one tile's stores overlap the next
//    tile's first copies.  h leaves room for one block per SM, so its
//    tiles are 256 wide: 8 warps.
//  - mm_gelu: one block per output tile.
//  - No split-K and no atomics: each output is one thread's sum over k in
//    a fixed order, so two calls give the same bits.
//
// wgmma, TMA and a persistent schedule are for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int VEC = 8;           // LayerNorm columns per lane per chunk
constexpr int kChunk = 32 * VEC; // LayerNorm columns per warp-wide chunk
constexpr int kMaxK = 4 * kChunk;

struct Args {
  const void* x;
  const void* r;      // ln_matmul: the residual, or null
  const void* lw;     // ln_matmul: LayerNorm weight, or null
  const void* lb;     // ln_matmul: LayerNorm bias, or null
  const void* w;
  const void* bias;   // or null
  void* y;
  void* z;            // mm_gelu: the pre-activation
  long long sw_k, sw_n;
  int M, K, N;
  float eps;
  int approximate;    // mm_gelu: 1 tanh, 0 erf
  int tiles;          // ln_matmul: column tiles per block
};

// a tile shape: BM x BN outputs per tile, BK-deep k tiles, ST cp.async
// stages, warps of WTM x WTN; WT: W's tile stored [n][k] (k contiguous in
// memory), else [k][n].  Shared rows are padded by 16 bytes, so the
// fragment reads of 8 consecutive rows fall in different banks.
template <typename T_, int BM_, int BN_, int BK_, int WTM_, int WTN_,
          int ST_, bool WT_>
struct Cfg {
  using T = T_;
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WTM = WTM_,
                       WTN = WTN_, ST = ST_;
  static constexpr bool WT = WT_;
  static constexpr int MT = WTM / 16, NT = WTN / 8;   // m16 / n8 tiles
  static constexpr int WN = BN / WTN;                 // warps along n
  static constexpr int kThreads = BM / WTM * WN * 32;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int LDW = (WT ? BK : BN) + V;
  static constexpr int W_TILE = (WT ? BN : BK) * LDW;
  static constexpr int LDA = BK + V;
  static constexpr int A_TILE = BM * LDA;
};

template <bool WT>
using LnBf16 = Cfg<__nv_bfloat16, 64, 256, 64, 64, 32, 2, WT>;
template <bool WT>
using LnF32 = Cfg<float, 32, 128, 32, 32, 32, 4, WT>;
template <bool WT>
using MmBf16 = Cfg<__nv_bfloat16, 128, 128, 64, 64, 32, 3, WT>;
template <bool WT>
using MmF32 = Cfg<float, 64, 128, 32, 32, 32, 4, WT>;

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the (BK, BN) tile of W at (k0, n0); what lies past K or N becomes zero
template <class C>
__device__ __forceinline__ void load_w(typename C::T* dst, const Args& a,
                                       int k0, int n0) {
  using T = typename C::T;
  const T* w = static_cast<const T*>(a.w);
  if (!C::WT) {
    constexpr int per_row = C::BN / C::V;
    for (int i = threadIdx.x; i < C::BK * per_row; i += C::kThreads) {
      const int kr = i / per_row, c = (i % per_row) * C::V;
      const bool in = k0 + kr < a.K && n0 + c < a.N;
      cp_async16(dst + kr * C::LDW + c,
                 in ? w + (k0 + kr) * a.sw_k + (n0 + c) : w, in);
    }
  } else {
    constexpr int per_row = C::BK / C::V;
    for (int i = threadIdx.x; i < C::BN * per_row; i += C::kThreads) {
      const int nr = i / per_row, c = (i % per_row) * C::V;
      const bool in = n0 + nr < a.N && k0 + c < a.K;
      cp_async16(dst + nr * C::LDW + c,
                 in ? w + (n0 + nr) * a.sw_n + (k0 + c) : w, in);
    }
  }
}

// the (BM, BK) tile of x at (m0, k0), stored [m][k]
template <class C>
__device__ __forceinline__ void load_x(typename C::T* dst, const Args& a,
                                       int m0, int k0) {
  using T = typename C::T;
  const T* x = static_cast<const T*>(a.x);
  constexpr int per_row = C::BK / C::V;
  for (int i = threadIdx.x; i < C::BM * per_row; i += C::kThreads) {
    const int mr = i / per_row, c = (i % per_row) * C::V;
    const bool in = m0 + mr < a.M && k0 + c < a.K;
    cp_async16(dst + mr * C::LDA + c,
               in ? x + static_cast<long long>(m0 + mr) * a.K + k0 + c : x,
               in);
  }
}

// ---------------------------------------------------------------------------
// the products: acc[i][j] is the m16n8 tile (i, j) of the warp's tile,
// lane (g, t) = (lane / 4, lane % 4) holding rows g and g + 8 at columns
// 2t and 2t + 1: [0], [1] on row g, [2], [3] on row g + 8
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (kTrans: each matrix transposed on the way)
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

// acc += A[the warp's rows][one k tile] @ W tile; A is [m][k] with
// leading dimension la (its first row the warp's first), sW one W stage
template <class C>
__device__ __forceinline__ void tile_product(float (&acc)[C::MT][C::NT][4],
                                             const __nv_bfloat16* A, int la,
                                             const __nv_bfloat16* sW,
                                             int wn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    uint32_t af[C::MT][4];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
      ldsm_x4<false>(af[i], A + (i * 16 + (lane & 15)) * la + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < C::NT / 2; ++jp) {
      uint32_t b[4];   // n-tiles 2jp and 2jp + 1, k 0-7 and 8-15 each
      const int n = wn * C::WTN + jp * 16;
      if (C::WT)
        ldsm_x4<false>(b, sW + (n + (lane & 7) + (lane >> 4) * 8) * C::LDW +
                              kk * 16 + ((lane >> 3) & 1) * 8);
      else
        ldsm_x4<true>(b, sW + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  C::LDW + n + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        mma_bf16(acc[i][2 * jp], af[i], b[0], b[1]);
        mma_bf16(acc[i][2 * jp + 1], af[i], b[2], b[3]);
      }
    }
  }
}

template <class C>
__device__ __forceinline__ void tile_product(float (&acc)[C::MT][C::NT][4],
                                             const float* A, int la,
                                             const float* sW, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < C::BK; ++k) {
    float a0[C::MT], a1[C::MT];
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      a0[i] = A[(i * 16 + g) * la + k];
      a1[i] = A[(i * 16 + g + 8) * la + k];
    }
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int n = wn * C::WTN + j * 8 + 2 * t;
      const float b0 = C::WT ? sW[n * C::LDW + k] : sW[k * C::LDW + n];
      const float b1 = C::WT ? sW[(n + 1) * C::LDW + k]
                             : sW[k * C::LDW + n + 1];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        acc[i][j][0] = fmaf(a0[i], b0, acc[i][j][0]);
        acc[i][j][1] = fmaf(a0[i], b1, acc[i][j][1]);
        acc[i][j][2] = fmaf(a1[i], b0, acc[i][j][2]);
        acc[i][j][3] = fmaf(a1[i], b1, acc[i][j][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the epilogue
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// `_gelu_f32`: the tanh form or the erf form, on the f32 sum
__device__ __forceinline__ float gelu(float z, int approximate) {
  if (approximate) {
    const float inner = 0.7978845608028654f * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.f + tanhf(inner));
  }
  return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
}

// acc (+ bias) -> y (and z), masked to the (M, N) output
template <class C, bool GELU>
__device__ __forceinline__ void epilogue(const float (&acc)[C::MT][C::NT][4],
                                         const Args& a, int row0, int col0) {
  using T = typename C::T;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* bias = static_cast<const T*>(a.bias);
  T* y = static_cast<T*>(a.y);
  T* z = static_cast<T*>(a.z);
#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col >= a.N) continue;   // N is even: col + 1 < N too
    const float b0 = bias ? to_f32(bias[col]) : 0.f;
    const float b1 = bias ? to_f32(bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + i * 16 + g + 8 * half;
        if (row >= a.M) continue;
        const float v0 = acc[i][j][2 * half] + b0;
        const float v1 = acc[i][j][2 * half + 1] + b1;
        const long long at = static_cast<long long>(row) * a.N + col;
        if (GELU) {
          store2(y + at, gelu(v0, a.approximate), gelu(v1, a.approximate));
          store2(z + at, v0, v1);
        } else {
          store2(y + at, v0, v1);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// the LayerNorm rows, as csrc/layer_norm.cu computes them
// ---------------------------------------------------------------------------
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
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// h for rows [m0, m0 + BM) into sH ([BM][lh], x's dtype): one warp per
// row, a lane owning 8 consecutive columns of each 256-column chunk;
// columns K .. kpad and rows past M are zero
template <class C>
__device__ __forceinline__ void ln_rows(typename C::T* sH, int lh, int kpad,
                                        const Args& a, int m0) {
  using T = typename C::T;
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  const T* lw = static_cast<const T*>(a.lw);
  const T* lb = static_cast<const T*>(a.lb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < C::BM; rr += C::kThreads / 32) {
    T* dst = sH + rr * lh;
    const int row = m0 + rr;
    if (row >= a.M) {
      for (int c = lane; c < kpad; c += 32) dst[c] = T(0.f);
      continue;
    }
    const long long base = static_cast<long long>(row) * a.K;
    float v[4][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c * kChunk + lane * VEC;
      if (col < a.K) {
        load8(x + base + col, v[c]);
        if (r) {
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
    const float mean = s1 / a.K;
    const float var = fmaxf(s2 / a.K - mean * mean, 0.f);
    const float rstd = rsqrtf(var + a.eps);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c * kChunk + lane * VEC;
      if (col < a.K) {
        float wv[VEC], bv[VEC], o[VEC];
        load_or(lw, col, 1.f, wv);
        load_or(lb, col, 0.f, bv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          o[i] = (v[c][i] - mean) * rstd * wv[i] + bv[i];
        store8(dst + col, o);
      }
    }
    for (int c = a.K + lane; c < kpad; c += 32) dst[c] = T(0.f);
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------
template <class C>
__global__ void __launch_bounds__(C::kThreads) ln_matmul_kernel(const Args a) {
  using T = typename C::T;
  constexpr int ST = C::ST;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (a.K + C::BK - 1) / C::BK;
  const int lh = kt * C::BK + C::V;
  T* sW = reinterpret_cast<T*>(smem);   // ST stages of W
  T* sH = sW + ST * C::W_TILE;
  const int m0 = blockIdx.y * C::BM;
  const int first = blockIdx.x * a.tiles;
  const int last = min(first + a.tiles, (a.N + C::BN - 1) / C::BN);
  if (first >= last) return;
  const int warp = threadIdx.x >> 5, wm = warp / C::WN, wn = warp % C::WN;

  // W streams through the stages across all the block's column tiles:
  // step s is k tile s % kt of column tile first + s / kt
  const int total = (last - first) * kt;
  auto load = [&](int s) {
    if (s < total)
      load_w<C>(sW + (s % ST) * C::W_TILE, a, (s % kt) * C::BK,
                (first + s / kt) * C::BN);
    cp_async_commit();   // an empty group past the end keeps the count
  };
  for (int s = 0; s < ST - 1; ++s) load(s);   // in flight during h
  ln_rows<C>(sH, lh, kt * C::BK, a, m0);

  float acc[C::MT][C::NT][4];
  for (int s = 0; s < total; ++s) {
    const int t = s % kt;
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
          acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
    cp_async_wait<ST - 2>();   // step s has landed
    __syncthreads();           // ... for every thread; step s - 1 is done
    load(s + ST - 1);          // into the stage step s - 1 used
    tile_product<C>(acc, sH + wm * C::WTM * lh + t * C::BK, lh,
                    sW + (s % ST) * C::W_TILE, wn);
    if (t == kt - 1)
      epilogue<C, false>(acc, a, m0 + wm * C::WTM,
                         (first + s / kt) * C::BN + wn * C::WTN);
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads) mm_gelu_kernel(const Args a) {
  using T = typename C::T;
  constexpr int ST = C::ST;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (a.K + C::BK - 1) / C::BK;
  T* sW = reinterpret_cast<T*>(smem);   // ST stages of W
  T* sA = sW + ST * C::W_TILE;          // ST stages of x
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x >> 5, wm = warp / C::WN, wn = warp % C::WN;

  auto load = [&](int t) {
    if (t < kt) {
      load_w<C>(sW + (t % ST) * C::W_TILE, a, t * C::BK, n0);
      load_x<C>(sA + (t % ST) * C::A_TILE, a, m0, t * C::BK);
    }
    cp_async_commit();
  };
  for (int t = 0; t < ST - 1; ++t) load(t);
  float acc[C::MT][C::NT][4] = {};
  for (int t = 0; t < kt; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    load(t + ST - 1);
    tile_product<C>(acc, sA + (t % ST) * C::A_TILE + wm * C::WTM * C::LDA,
                    C::LDA, sW + (t % ST) * C::W_TILE, wn);
  }
  epilogue<C, true>(acc, a, m0 + wm * C::WTM, n0 + wn * C::WTN);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, int nthreads, size_t smem,
                   const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<grid, nthreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One block per SM (h fills most of its shared memory), so the column
// tiles of a row block are split over as many blocks as fill the SMs,
// each block computing its rows' h once
template <class C>
cudaError_t ln_matmul(Args a, cudaStream_t s) {
  const int kt = (a.K + C::BK - 1) / C::BK;
  const size_t smem = (C::ST * C::W_TILE +
                       static_cast<size_t>(C::BM) * (kt * C::BK + C::V)) *
                      sizeof(typename C::T);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int row_blocks = (a.M + C::BM - 1) / C::BM;
  const int ntiles = (a.N + C::BN - 1) / C::BN;
  const int groups = std::min(ntiles, std::max(1, sms / row_blocks));
  a.tiles = (ntiles + groups - 1) / groups;
  const dim3 grid((ntiles + a.tiles - 1) / a.tiles, row_blocks);
  return launch(ln_matmul_kernel<C>, grid, C::kThreads, smem, a, s);
}

template <class C>
cudaError_t mm_gelu(const Args& a, cudaStream_t s) {
  const size_t smem =
      C::ST * (C::W_TILE + C::A_TILE) * sizeof(typename C::T);
  const dim3 grid((a.N + C::BN - 1) / C::BN, (a.M + C::BM - 1) / C::BM);
  return launch(mm_gelu_kernel<C>, grid, C::kThreads, smem, a, s);
}

bool valid(const Args& a, int dtype) {
  const int v = dtype == 0 ? 4 : 8;
  return a.M > 0 && a.K > 0 && a.N > 0 && a.K % v == 0 && a.N % v == 0 &&
         (a.sw_n == 1 || a.sw_k == 1) && (dtype == 0 || dtype == 1) &&
         (a.M + 31) / 32 <= 65535;
}

}  // namespace

// x (M, K) and r (or null) row-major; lw, lb (K,) or null; W (K, N) with
// strides (sw_k, sw_n), one of them 1, the other a multiple of 16 bytes;
// bias (N,) or null; y (M, N) row-major.  K <= 1024, K a multiple of 8
// and N of 16 bytes.  dtype: 0 = float32, 1 = bfloat16, for every tensor.
extern "C" int ptt_ln_matmul(const void* x, const void* r, const void* lw,
                             const void* lb, const void* w, const void* bias,
                             void* y, int M, int K, int N, long long sw_k,
                             long long sw_n, float eps, int dtype,
                             void* stream) {
  Args a = {x, r, lw, lb, w, bias, y, nullptr, sw_k, sw_n, M, K, N, eps, 0,
            0};
  if (!valid(a, dtype) || K > kMaxK || K % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wt = sw_k == 1 && sw_n != 1;
  cudaError_t e;
  if (dtype == 0)
    e = wt ? ln_matmul<LnF32<true>>(a, s) : ln_matmul<LnF32<false>>(a, s);
  else
    e = wt ? ln_matmul<LnBf16<true>>(a, s) : ln_matmul<LnBf16<false>>(a, s);
  return static_cast<int>(e);
}

// x (M, K) row-major; W and bias as above; y = gelu(z) and z (M, N)
// row-major; approximate: 1 the tanh form, 0 the erf form.
extern "C" int ptt_matmul_bias_gelu(const void* x, const void* w,
                                    const void* bias, void* y, void* z, int M,
                                    int K, int N, long long sw_k,
                                    long long sw_n, int approximate,
                                    int dtype, void* stream) {
  Args a = {x, nullptr, nullptr, nullptr, w, bias, y, z, sw_k, sw_n, M, K, N,
            0.f, approximate, 0};
  if (!valid(a, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wt = sw_k == 1 && sw_n != 1;
  cudaError_t e;
  if (dtype == 0)
    e = wt ? mm_gelu<MmF32<true>>(a, s) : mm_gelu<MmF32<false>>(a, s);
  else
    e = wt ? mm_gelu<MmBf16<true>>(a, s) : mm_gelu<MmBf16<false>>(a, s);
  return static_cast<int>(e);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
