// The fusion pass's block kernels for Hopper (sm_90a): (residual +)
// LayerNorm + matmul (+ bias), and matmul (+ bias) + gelu.
//
// Replaces the Pallas kernels `_lnmm_fwd_kernel` and `_mbg_fwd_kernel`
// (paddle_tpu/ops/fused_kernels.py, launched at the pallas_call sites in
// `_lnmm_pallas_fwd` and `_mbg_pallas_fwd`).  x is (M, K) row-major; W is
// (K, N) with any strides, one of them 1: a Linear weight is read with n
// contiguous, and the transposed view of a (N, K) embedding table (BERT's
// tied decoder) with k contiguous, in place.  x, r, the LayerNorm's w and
// b, W, the bias and the outputs are all f32 or all bf16.  K is a multiple
// of 8; both take any width all the same, since their wrappers zero-pad x
// (and r, w and b) by columns and W by rows up to the next multiple, and
// ln_matmul passes the true width KD, by which the statistics divide: the
// zeros add nothing to the row sums, and W's zero rows nothing to the
// products.
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
// the LayerNorm + matmul does 51.5 GFLOP over about 23 MB, 0.052 ms at the
// bf16 tensor-core peak; BERT's tied decoder (4096, 768) @ (768, 30528)
// 192 GFLOP.  Only `wgmma` reaches that rate on this card, fed from shared
// memory faster than `cp.async` issued by the computing warps can fill it.
//
// ln_matmul, bf16: two kernels on one main loop.  Both run persistent
// blocks, at most one per SM, of three warpgroups; a work item is (a row
// block, a run of 256-column tiles), block b taking items b, b +
// gridDim.x, ... in that fixed order, the runs as long as leave every SM
// an item.  W comes by TMA (`cp.async.bulk.tensor`, 128-byte swizzle): one
// producer thread copies each 64 x 256 k tile into a ring of stages, each
// with a full and an empty mbarrier (transaction counts on the full ones).
// A Linear weight (n contiguous) loads as four 64 x 64 panels and is read
// by wgmma n-major; the tied decoder's transposed view (k contiguous) as
// one 256 x 64 box, read k-major; both in place, each through its own
// tensor map built on the host per call.  TMA fills what lies past K or N
// with zeros: the ragged N = 30528 and any K edge need no mask.  h is the
// LayerNorm kernel's (one warp per row, one pass, f32, each lane's sums in
// the same order), rounded to bf16.  Each output is one thread's sum over
// k in a fixed order: no split-K, no atomics, two calls give the same
// bits.
//
//  - K <= 1024 (`lnmm_whole_kernel`): items of 64 rows.  All 12 warps first
//    normalize the item's rows into shared memory, whole (64 x 1024 x 2 =
//    128 KB at most), in wgmma's A layout: 64-column k tiles of 128-byte
//    rows, each 16-byte chunk at chunk ^ (row % 8).  The W ring takes what
//    is left: 3 stages at K = 1024, 4 at BERT's 768, up to 6.  Warpgroups
//    1 and 2 consume columns 0-127 and 128-255 of each tile on the same h,
//    wgmma m64n128k16 (64 f32 accumulators a thread), one batch kept in
//    flight while the previous stage is released; two consumers keep the
//    tensor cores fed where one on m64n256k16 left them idle between its
//    batches (PERF.md).  The epilogue adds the bias in f32, rounds to bf16
//    and stores from the registers while the producer already fills the
//    ring with the next tile's W.  No setmaxnreg: every warp joins the
//    LayerNorm at each item, so the roles reconverge.
//  - K > 1024 (`lnmm_stats_kernel`, then `lnmm_stream_kernel`): h cannot
//    be held whole.  A first kernel writes each row's mean and rstd to f32
//    scratch from the caller; then items of 128 rows, where each of 4
//    stages holds x's 128 x 64 k tile (TMA) beside W's.  Consumer
//    warpgroups 1 and 2 each normalize their 64 rows of the landed x tile
//    into h in place, (x (+ r) - mean) * rstd (* w) (+ b) rounded to bf16,
//    while the other's products run, then issue wgmma m64n256k16 on them.
//    `setmaxnreg` gives the consumers 232 registers and the producer 40;
//    the roles never reconverge, and a consumer warpgroup meets itself by
//    named barrier 1 or 2.
//  - What bounds them (PERF.md): not the tensor cores.  At K <= 1024 each
//    64-row block reads all of W (805 MB at GPT-345M's shape) through a
//    ring only 3-4 stages deep beside h; W shared by a thread-block
//    cluster (multicast) moved half the bytes out of L2 and no faster.
//
// ln_matmul in f32 and mm_gelu (the earlier kernels, `mma.sync`):
//  - Output tiles of BM x BN, warps of 64 x 32 (32 x 32 in f32).  bf16
//    products by `mma.sync` m16n8k16 with f32 accumulators and `ldmatrix`
//    fragment loads (`.trans` for a tile of W stored n-major); f32 by FMAs
//    in the same fragment layout (no TF32).  W (and, for mm_gelu, x)
//    streams through shared memory in k tiles, ST in flight (cp.async);
//    edge tiles are zero-filled and masked at the store.
//  - ln_matmul f32: a block normalizes its 32 rows into shared memory for
//    K <= 1024 and walks a run of column tiles on that h; above 1024 it
//    keeps each row's mean and rstd and normalizes every k tile of h into
//    a stage beside W's.  mm_gelu: one block per output tile.  The next
//    version moves mm_gelu onto the wgmma main loop.
#include <cuda.h>
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
  int KD;             // ln_matmul: the LayerNorm's width (K less its zero
                      // padding), the divisor of the row statistics
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
    const float mean = s1 / a.KD;
    const float var = fmaxf(s2 / a.KD - mean * mean, 0.f);
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

// mean and rstd of rows [m0, m0 + BM) into st[0 .. BM) and st[BM .. 2 BM),
// one warp per row, each lane's sums chunk by chunk as the LayerNorm
// kernel's for any d (rows past M: 0 and 0)
template <typename T>
__device__ __forceinline__ void ln_stats(float* st, int bm, int nwarps,
                                         const Args& a, int m0) {
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < bm; rr += nwarps) {
    const int row = m0 + rr;
    float s1 = 0.f, s2 = 0.f;
    if (row < a.M) {
      const long long base = static_cast<long long>(row) * a.K;
      for (int col = lane * VEC; col < a.K; col += kChunk) {
        float v[VEC];
        load8(x + base + col, v);
        if (r) {
          float rv[VEC];
          load8(r + base + col, rv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] += rv[i];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s1 += v[i];
          s2 += v[i] * v[i];
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 / a.KD;
    const float var = fmaxf(s2 / a.KD - mean * mean, 0.f);
    if (lane == 0) {
      st[rr] = row < a.M ? mean : 0.f;
      st[bm + rr] = row < a.M ? rsqrtf(var + a.eps) : 0.f;
    }
  }
}

// h at row rr, columns [col, col + 8) of the item's rows, from the row's
// saved mean and rstd: the ln_rows arithmetic; zero past M or K
template <typename T>
__device__ __forceinline__ void h8(float (&o)[VEC], const Args& a,
                                   const float* st, int bm, int m0, int rr,
                                   int col) {
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  if (m0 + rr >= a.M || col >= a.K) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = 0.f;
    return;
  }
  const long long at = static_cast<long long>(m0 + rr) * a.K + col;
  float v[VEC], wv[VEC], bv[VEC];
  load8(x + at, v);
  if (r) {
    float rv[VEC];
    load8(r + at, rv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] += rv[i];
  }
  load_or(static_cast<const T*>(a.lw), col, 1.f, wv);
  load_or(static_cast<const T*>(a.lb), col, 0.f, bv);
  const float mean = st[rr], rstd = st[bm + rr];
#pragma unroll
  for (int i = 0; i < VEC; ++i) o[i] = (v[i] - mean) * rstd * wv[i] + bv[i];
}

// the (BM, BK) tile of h at k0 into dst ([m][k], row stride LDA)
template <class C>
__device__ __forceinline__ void ln_tile(typename C::T* dst, const Args& a,
                                        const float* st, int m0, int k0) {
  constexpr int per_row = C::BK / VEC;
  for (int i = threadIdx.x; i < C::BM * per_row; i += C::kThreads) {
    const int rr = i / per_row, c = (i % per_row) * VEC;
    float o[VEC];
    h8<typename C::T>(o, a, st, C::BM, m0, rr, k0 + c);
    store8(dst + rr * C::LDA + c, o);
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------
// STREAM (K > 1024): h is not held whole; each k tile of it is normalized
// into a stage beside W's from the rows' saved mean and rstd
template <class C, bool STREAM>
__global__ void __launch_bounds__(C::kThreads) ln_matmul_kernel(const Args a) {
  using T = typename C::T;
  constexpr int ST = C::ST;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (a.K + C::BK - 1) / C::BK;
  const int lh = kt * C::BK + C::V;
  T* sW = reinterpret_cast<T*>(smem);   // ST stages of W
  T* sH = sW + ST * C::W_TILE;          // h, or ST stages of its k tiles
  float* sStat = reinterpret_cast<float*>(sH + ST * C::A_TILE);
  const int m0 = blockIdx.y * C::BM;
  const int first = blockIdx.x * a.tiles;
  const int last = min(first + a.tiles, (a.N + C::BN - 1) / C::BN);
  if (first >= last) return;
  const int warp = threadIdx.x >> 5, wm = warp / C::WN, wn = warp % C::WN;

  // W streams through the stages across all the block's column tiles:
  // step s is k tile s % kt of column tile first + s / kt
  const int total = (last - first) * kt;
  auto load = [&](int s) {
    if (s < total) {
      load_w<C>(sW + (s % ST) * C::W_TILE, a, (s % kt) * C::BK,
                (first + s / kt) * C::BN);
      if (STREAM)
        ln_tile<C>(sH + (s % ST) * C::A_TILE, a, sStat, m0, (s % kt) * C::BK);
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };
  if (STREAM) {
    ln_stats<T>(sStat, C::BM, C::kThreads / 32, a, m0);
    __syncthreads();
  }
  for (int s = 0; s < ST - 1; ++s) load(s);   // in flight during h
  if (!STREAM) ln_rows<C>(sH, lh, kt * C::BK, a, m0);

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
    if (STREAM)
      tile_product<C>(acc, sH + (s % ST) * C::A_TILE + wm * C::WTM * C::LDA,
                      C::LDA, sW + (s % ST) * C::W_TILE, wn);
    else
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

int sm_count(cudaError_t* e) {
  int dev = 0, sms = 0;
  *e = cudaGetDevice(&dev);
  if (*e == cudaSuccess)
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// column tiles per run: the runs of a row block are as many as leave every
// SM a (row block, run) item
int run_tiles(int row_blocks, int ntiles, int sms) {
  const int groups = std::min(ntiles, std::max(1, sms / row_blocks));
  return (ntiles + groups - 1) / groups;
}

// f32: one block per (row block, run), h or its stages filling most of the
// shared memory; K > 1024 streams h's k tiles
template <class C>
cudaError_t ln_matmul(Args a, cudaStream_t s) {
  const int kt = (a.K + C::BK - 1) / C::BK;
  const bool stream = a.K > kMaxK;
  const size_t smem =
      (C::ST * C::W_TILE + (stream ? static_cast<size_t>(C::ST) * C::A_TILE
                                   : static_cast<size_t>(C::BM) *
                                         (kt * C::BK + C::V))) *
          sizeof(typename C::T) +
      2 * C::BM * sizeof(float);
  cudaError_t e;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return e;
  const int row_blocks = (a.M + C::BM - 1) / C::BM;
  const int ntiles = (a.N + C::BN - 1) / C::BN;
  a.tiles = run_tiles(row_blocks, ntiles, sms);
  const dim3 grid((ntiles + a.tiles - 1) / a.tiles, row_blocks);
  return stream ? launch(ln_matmul_kernel<C, true>, grid, C::kThreads, smem,
                         a, s)
                : launch(ln_matmul_kernel<C, false>, grid, C::kThreads, smem,
                         a, s);
}

// ---------------------------------------------------------------------------
// ln_matmul in bf16 on wgmma and TMA
// ---------------------------------------------------------------------------
namespace wg {

// both kernels: 256-column tiles, 64-deep k tiles, three warpgroups
constexpr int BN = 256, BK = 64;
constexpr int kThreads = 384;
constexpr int kTileW = BN * BK * 2;                // one W stage, 32 KB
// K <= 1024: 64-row items, h whole in shared memory, a ring of W stages
constexpr int kWholeBM = 64;
constexpr int kTileH = kWholeBM * BK * 2;          // one k tile of h, 8 KB
constexpr int kMaxWholeK = 1024;
constexpr int kSmem = 232448;                      // a block's most
constexpr int kMaxStages = 6;
// K > 1024: 128-row items, 4 stages of (x then h, W)
constexpr int kStreamBM = 128, kStreamStages = 4;
constexpr int kTileX = kStreamBM * BK * 2;         // 16 KB
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// the W stages that fit beside h and the block's barriers: 3 at K = 1024,
// 4 at BERT's 768, up to 6
__host__ __device__ constexpr int stages(int kt) {
  const int left = kSmem - 1024 - 2 * kMaxStages * 8;
  int st = kMaxStages;
  while (st > 2 && st * kTileW + kt * kTileH > left) --st;
  return st;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// arrive, and expect `bytes` more of the phase's copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// a 2-D box of the tensor map at (c0, c1), innermost first, into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// generic-proxy writes to shared memory, made visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a shared memory matrix descriptor, 128-byte swizzle: lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (the m64n128 f32 accumulator, 64 a thread) += A . B for one k16
// step: A (64 x 16) and B (16 x 128) read from shared memory through their
// descriptors; TB = 1 reads B n-major (transposed), 0 k-major; scale_d = 0
// overwrites d instead
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (the m64n256 f32 accumulator, 128 a thread) += A . B for one k16
// step: A (64 x 16) and B (16 x 256) read from shared memory through their
// descriptors; TB = 1 reads B n-major (transposed), 0 k-major; scale_d = 0
// overwrites d instead
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// byte offset of 16-byte chunk c (8 columns) of row r in a swizzled tile of
// 128-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// K <= 1024: h for rows [m0, m0 + 64) whole into sH (kt swizzled k tiles),
// one warp per row, the arithmetic of ln_rows; zero past M and past K
__device__ __forceinline__ void h_whole(unsigned char* sH, int kt,
                                        const Args& a, int m0) {
  using T = __nv_bfloat16;
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  const T* lw = static_cast<const T*>(a.lw);
  const T* lb = static_cast<const T*>(a.lb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float zero[VEC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto put = [&](int rr, int col, const float (&o)[VEC]) {
    store8(reinterpret_cast<T*>(sH + (col / BK) * kTileH +
                                swz(rr, (col % BK) / VEC)),
           o);
  };
  for (int rr = warp; rr < kWholeBM; rr += kThreads / 32) {
    const int row = m0 + rr;
    // chunks past K up to the last k tile's end are zero
    for (int col = a.K + lane * VEC; col < kt * BK; col += 32 * VEC)
      put(rr, col, zero);
    if (row >= a.M) {
      for (int col = lane * VEC; col < a.K; col += 32 * VEC) put(rr, col, zero);
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
    const float mean = s1 / a.KD;
    const float var = fmaxf(s2 / a.KD - mean * mean, 0.f);
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
        put(rr, col, o);
      }
    }
  }
}

// mean and rstd of every row, one warp per row, each lane's sums chunk by
// chunk as the LayerNorm kernel's (so h is that kernel's h)
__global__ void __launch_bounds__(256) lnmm_stats_kernel(const Args a,
                                                         float* mean,
                                                         float* rstd) {
  using T = __nv_bfloat16;
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= a.M) return;
  const long long base = static_cast<long long>(row) * a.K;
  float s1 = 0.f, s2 = 0.f;
  for (int col = lane * VEC; col < a.K; col += kChunk) {
    float v[VEC];
    load8(x + base + col, v);
    if (r) {
      float rv[VEC];
      load8(r + base + col, rv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] += rv[i];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1 += v[i];
      s2 += v[i] * v[i];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float mu = s1 / a.KD;
    const float var = fmaxf(s2 / a.KD - mu * mu, 0.f);
    mean[row] = mu;
    rstd[row] = rsqrtf(var + a.eps);
  }
}

// the block's walk over its ring steps: items (a 128-row block, a run of
// column tiles) b, b + gridDim.x, ...; each tile's k tiles in order
struct Walk {
  int item, j, t, m0, j1;
  int bm;
  int items, nruns, per, ntiles, kt;
  __device__ void start(int first) {
    item = first;
    enter();
  }
  __device__ void enter() {
    m0 = (item / nruns) * bm;
    j = (item % nruns) * per;
    j1 = min(ntiles, j + per);
    t = 0;
  }
  __device__ bool done() const { return item >= items; }
  __device__ void next() {
    if (++t < kt) return;
    t = 0;
    if (++j < j1) return;
    item += gridDim.x;
    if (item < items) enter();
  }
};

// K <= 1024, h whole: items of 64 rows.  WT: W k-contiguous (a 256 x 64
// box a stage, read k-major); else n contiguous (four 64 x 64 panels, read
// n-major).
template <bool WT>
__global__ void __launch_bounds__(kThreads, 1)
    lnmm_whole_kernel(const __grid_constant__ CUtensorMap wmap, const Args a,
                      int items, int nruns, int ST) {
  constexpr int BM = kWholeBM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kt = (a.K + BK - 1) / BK;
  unsigned char* sW = smem;                        // ST stages of W
  unsigned char* sH = sW + ST * kTileW;            // h, kt k tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sH + kt * kTileH);  // ST each
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const bool producer = tid < 128;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ntiles = (a.N + BN - 1) / BN;
  const int per = a.tiles;
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.bias);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  int it = 0;   // ring steps so far, the same count in both roles
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int m0 = (item / nruns) * BM;
    const int j0 = (item % nruns) * per;
    const int j1 = min(ntiles, j0 + per);
    __syncthreads();   // the last item's h and stages are no longer read
    h_whole(sH, kt, a, m0);
    fence_async_shared();
    __syncthreads();

    if (producer) {
      // one thread issues the copies, the other producer warps wait at the
      // next item's barrier
      if (tid >= 32) continue;
      for (int j = j0; j < j1; ++j)
        for (int t = 0; t < kt; ++t, ++it) {
          const int stg = it % ST, ph = (it / ST) & 1;
          mbar_wait(&empty[stg], ph ^ 1);
          if (tid == 0) {
            mbar_arrive_expect(&full[stg], kTileW);
            unsigned char* dst = sW + stg * kTileW;
            if (WT) {
              tma_load(dst, &wmap, &full[stg], t * BK, j * BN);
            } else {
#pragma unroll
              for (int p = 0; p < BN / 64; ++p)
                tma_load(dst + p * (kTileW / 4), &wmap, &full[stg],
                         j * BN + p * 64, t * BK);
            }
          }
        }
    } else {
      // a consumer warp is done with a stage: one arrival on its empty
      // barrier
      auto release = [&](int stg) {
        if ((tid & 31) == 0) mbar_arrive(&empty[stg]);
      };
      // two consumer warpgroups: columns 0-127 and 128-255 of each tile
      const int cw = (tid - 128) >> 7;           // 0 or 1
      const int ct = tid & 127;                  // thread in the warpgroup
      const int row = (ct >> 5) * 16 + ((ct & 31) >> 2);
      const int cq = (ct & 3) * 2;
      for (int j = j0; j < j1; ++j) {
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        int prev = -1;
        for (int t = 0; t < kt; ++t, ++it) {
          const int stg = it % ST, ph = (it / ST) & 1;
          mbar_wait(&full[stg], ph);
          const unsigned char* tA = sH + t * kTileH;
          // this warpgroup's 128 columns: n rows 128 cw.. (WT) or panels
          // 2 cw, 2 cw + 1, 16 KB on either way
          const unsigned char* tW = sW + stg * kTileW + cw * (kTileW / 2);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = desc(tA + kk * 32, 16, 1024);
            const uint64_t db =
                WT ? desc(tW + kk * 32, 16, 1024)
                   : desc(tW + kk * 16 * 128, kTileW / 4, 1024);
            wgmma_m64n128k16<WT ? 0 : 1>(acc, da, db, t > 0 || kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();   // the previous step's products are done
          if (prev >= 0) release(prev);
          prev = stg;
        }
        wgmma_wait<0>();
        if (prev >= 0) release(prev);
        // epilogue: accumulator element (j8, e) is row `row` (+ 8 for e >=
        // 2), column j8 * 8 + cq (+ 1 for odd e)
        const int n0 = j * BN + cw * (BN / 2);
#pragma unroll
        for (int j8 = 0; j8 < BN / 16; ++j8) {
          const int col = n0 + j8 * 8 + cq;
          if (col >= a.N) continue;   // N is even: col + 1 < N too
          const float b0 = bias ? __bfloat162float(bias[col]) : 0.f;
          const float b1 = bias ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + row + 8 * half;
            if (m >= a.M) continue;
            *reinterpret_cast<__nv_bfloat162*>(
                y + static_cast<long long>(m) * a.N + col) =
                __floats2bfloat162_rn(acc[j8 * 4 + 2 * half] + b0,
                                      acc[j8 * 4 + 2 * half + 1] + b1);
          }
        }
      }
    }
  }
}

// K > 1024, h made by k tile: items of 128 rows; WT as above
template <bool WT>
__global__ void __launch_bounds__(kThreads, 1)
    lnmm_stream_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const Args a,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, int items, int nruns) {
  constexpr int BM = kStreamBM, ST = kStreamStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sA = smem;                    // ST stages of x, then h
  unsigned char* sW = sA + ST * kTileX;        // ST stages of W
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + ST * kTileW);
  uint64_t* empty = full + ST;
  float* sStat = reinterpret_cast<float*>(empty + ST);   // mean, rstd

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Walk walk;
  walk.items = items;
  walk.nruns = nruns;
  walk.per = a.tiles;
  walk.ntiles = (a.N + BN - 1) / BN;
  walk.kt = (a.K + BK - 1) / BK;
  walk.bm = BM;
  walk.start(blockIdx.x);

  if (tid < 128) {
    // the producer: one thread copies each step's x and W tiles by TMA,
    // as soon as the consumers released the stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == 0) {
      for (int n = 0; !walk.done(); ++n, walk.next()) {
        const int s = n % ST, ph = (n / ST) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_expect(&full[s], kTileX + kTileW);
        tma_load(sA + s * kTileX, &xmap, &full[s], walk.t * BK, walk.m0);
        unsigned char* dst = sW + s * kTileW;
        if (WT) {
          tma_load(dst, &wmap, &full[s], walk.t * BK, walk.j * BN);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load(dst + p * (kTileW / 4), &wmap, &full[s],
                     walk.j * BN + p * 64, walk.t * BK);
        }
      }
    }
  } else {
    // two consumer warpgroups, rows 0-63 and 64-127 of each tile: each
    // normalizes its rows of the landed x tile into h in place, then runs
    // wgmma on them while the next tile is normalized
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    using T = __nv_bfloat16;
    const T* r = static_cast<const T*>(a.r);
    const T* lw = static_cast<const T*>(a.lw);
    const T* lb = static_cast<const T*>(a.lb);
    const int cw = (tid >> 7) - 1;             // 0 or 1
    const int ct = tid & 127;                  // thread in the warpgroup
    const int lane = tid & 31;
    const int row = cw * 64 + (ct >> 5) * 16 + (lane >> 2);
    const int cq = (lane & 3) * 2;
    const int c = ct & 7;                      // the chunk it normalizes
    float* stat = sStat + cw * 128;            // its rows' mean, rstd
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.bias);
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
    auto bar = [&]() {   // this warpgroup's 128 threads
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    };
    int n = 0, prev = -1, item = -1;
    while (!walk.done()) {
      if (walk.item != item) {   // a new item: its rows' mean and rstd
        item = walk.item;
        bar();   // the last item's statistics are no longer read
        if (ct < 64) {
          const int m = walk.m0 + cw * 64 + ct;
          stat[ct] = m < a.M ? mean[m] : 0.f;
          stat[64 + ct] = m < a.M ? rstd[m] : 0.f;
        }
        bar();
      }
      const int m0 = walk.m0, j = walk.j;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int t = 0; t < walk.kt; ++t, ++n, walk.next()) {
        const int s = n % ST, ph = (n / ST) & 1;
        mbar_wait(&full[s], ph);
        unsigned char* tA = sA + s * kTileX + cw * (kTileX / 2);
        // h = (x (+ r) - mean) * rstd (* w) (+ b), rounded to bf16; what
        // lies past M or K stays as the copy left it: zero
        const int col = t * BK + c * VEC;
        if (col < a.K) {
          float wv[VEC], bv[VEC];
          load_or(lw, col, 1.f, wv);
          load_or(lb, col, 0.f, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rr = (ct >> 3) + 16 * i;
            const int m = m0 + cw * 64 + rr;
            if (m < a.M) {
              T* p = reinterpret_cast<T*>(tA + swz(rr, c));
              float v[VEC], o[VEC];
              load8(p, v);
              if (r) {
                float rv[VEC];
                load8(r + static_cast<long long>(m) * a.K + col, rv);
#pragma unroll
                for (int e = 0; e < VEC; ++e) v[e] += rv[e];
              }
              const float mu = stat[rr], rs = stat[64 + rr];
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                o[e] = (v[e] - mu) * rs * wv[e] + bv[e];
              store8(p, o);
            }
          }
        }
        fence_async_shared();
        bar();   // the warpgroup's rows of h are in place
        const unsigned char* tW = sW + s * kTileW;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc(tA + kk * 32, 16, 1024);
          const uint64_t db =
              WT ? desc(tW + kk * 32, 16, 1024)
                 : desc(tW + kk * 16 * 128, kTileW / 4, 1024);
          wgmma_m64n256k16<WT ? 0 : 1>(acc, da, db, t > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous step's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
      prev = -1;
      // epilogue: accumulator element (j8, e) is row `row` (+ 8 for e >=
      // 2), column j8 * 8 + cq (+ 1 for odd e)
      const int n0 = j * BN;
#pragma unroll
      for (int j8 = 0; j8 < BN / 8; ++j8) {
        const int cn = n0 + j8 * 8 + cq;
        if (cn >= a.N) continue;   // N is even: cn + 1 < N too
        const float b0 = bias ? __bfloat162float(bias[cn]) : 0.f;
        const float b1 = bias ? __bfloat162float(bias[cn + 1]) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + row + 8 * half;
          if (m >= a.M) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              y + static_cast<long long>(m) * a.N + cn) =
              __floats2bfloat162_rn(acc[j8 * 4 + 2 * half] + b0,
                                    acc[j8 * 4 + 2 * half + 1] + b1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links nothing but cudart)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D bf16 tensor for TMA: dims (inner, outer), the outer stride in
// elements, boxes of (box0, box1); 128-byte swizzle; what a box reads past
// the tensor's edge is zero
cudaError_t tensor_map(CUtensorMap* map, const void* base, long long inner,
                       long long outer, long long stride, int box0,
                       int box1) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1)};
  const cuuint32_t estr[2] = {1u, 1u};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool WT>
cudaError_t w_map(CUtensorMap* map, const Args& a) {
  // W (K, N) n contiguous: 64 x 64 panels; k contiguous, as (N, K): 64 x
  // 256 boxes
  return WT ? tensor_map(map, a.w, a.K, a.N, a.sw_n, BK, BN)
            : tensor_map(map, a.w, a.N, a.K, a.sw_k, 64, BK);
}

template <bool WT>
cudaError_t launch_whole(Args a, cudaStream_t stream) {
  CUtensorMap wmap;
  cudaError_t e = w_map<WT>(&wmap, a);
  if (e != cudaSuccess) return e;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return e;
  const int kt = (a.K + BK - 1) / BK;
  const int row_blocks = (a.M + kWholeBM - 1) / kWholeBM;
  const int ntiles = (a.N + BN - 1) / BN;
  a.tiles = run_tiles(row_blocks, ntiles, sms);
  const int nruns = (ntiles + a.tiles - 1) / a.tiles;
  const int items = row_blocks * nruns;
  const int st = stages(kt);
  const size_t smem = 1024 + static_cast<size_t>(st) * kTileW +
                      static_cast<size_t>(kt) * kTileH +
                      2 * st * sizeof(uint64_t);
  auto kern = lnmm_whole_kernel<WT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<std::min(items, sms), kThreads, smem, stream>>>(wmap, a, items,
                                                        nruns, st);
  return cudaGetLastError();
}

// stats: f32 (2, M) scratch from the caller, mean then rstd
template <bool WT>
cudaError_t launch_stream(Args a, float* stats, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  // x (M, K): 64 x 128 boxes
  cudaError_t e = tensor_map(&xmap, a.x, a.K, a.M, a.K, BK, kStreamBM);
  if (e == cudaSuccess) e = w_map<WT>(&wmap, a);
  if (e != cudaSuccess) return e;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return e;
  const int row_blocks = (a.M + kStreamBM - 1) / kStreamBM;
  const int ntiles = (a.N + BN - 1) / BN;
  a.tiles = run_tiles(row_blocks, ntiles, sms);
  const int nruns = (ntiles + a.tiles - 1) / a.tiles;
  const int items = row_blocks * nruns;
  const size_t smem = 1024 + static_cast<size_t>(kStreamStages) *
                                 (kTileX + kTileW) +
                      2 * kStreamStages * sizeof(uint64_t) +
                      2 * kStreamBM * sizeof(float);
  auto kern = lnmm_stream_kernel<WT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lnmm_stats_kernel<<<(a.M + 7) / 8, 256, 0, stream>>>(a, stats,
                                                         stats + a.M);
  kern<<<std::min(items, sms), kThreads, smem, stream>>>(
      xmap, wmap, a, stats, stats + a.M, items, nruns);
  return cudaGetLastError();
}

cudaError_t ln_matmul_bf16(const Args& a, float* stats, cudaStream_t s) {
  const bool wt = a.sw_k == 1 && a.sw_n != 1;
  if (a.K <= kMaxWholeK)
    return wt ? launch_whole<true>(a, s) : launch_whole<false>(a, s);
  return wt ? launch_stream<true>(a, stats, s)
            : launch_stream<false>(a, stats, s);
}

}  // namespace wg

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
// bias (N,) or null; y (M, N) row-major; all 16-byte aligned.  K a
// multiple of 8 and N of 16 bytes.  KD: the LayerNorm's true width, K less
// at most 7 zero columns of x, r, lw and lb (and zero rows of W) that the
// caller padded; the statistics divide by KD.  dtype: 0 = float32, 1 =
// bfloat16, for every tensor.
extern "C" int ptt_ln_matmul(const void* x, const void* r, const void* lw,
                             const void* lb, const void* w, const void* bias,
                             void* y, int M, int K, int KD, int N,
                             long long sw_k, long long sw_n, float eps,
                             int dtype, void* stats, void* stream) {
  Args a = {x, r, lw, lb, w, bias, y, nullptr, sw_k, sw_n, M, K, N, eps, 0,
            0, KD};
  if (!valid(a, dtype) || K % VEC != 0 || KD <= K - VEC || KD > K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wt = sw_k == 1 && sw_n != 1;
  cudaError_t e;
  if (dtype == 0)
    e = wt ? ln_matmul<LnF32<true>>(a, s) : ln_matmul<LnF32<false>>(a, s);
  else
    e = wg::ln_matmul_bf16(a, static_cast<float*>(stats), s);
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
            0.f, approximate, 0, K};
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
