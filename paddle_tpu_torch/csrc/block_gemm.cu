// The fusion pass's block kernels for Hopper (sm_90a): (residual +)
// LayerNorm + matmul (+ bias), and matmul (+ bias) + gelu.
//
// Replaces the Pallas kernels `_lnmm_fwd_kernel` and `_mbg_fwd_kernel`
// (paddle_tpu/ops/fused_kernels.py, launched at the pallas_call sites in
// `_lnmm_pallas_fwd` and `_mbg_pallas_fwd`).  x is (M, K) row-major; W is
// (K, N) with any strides, one of them 1 and the other a multiple of 16
// bytes: a Linear weight is read with n contiguous, and the transposed view
// of a (N, K) embedding table (BERT's tied decoder) with k contiguous, in
// place.  x, r, the LayerNorm's w and b, W, the bias and the outputs are
// all f32 or all bf16.  K is a multiple of 8; both take any width all the
// same, since their wrappers zero-pad x (and r, w and b) by columns and W
// by rows up to the next multiple, and ln_matmul passes the true width KD,
// by which the statistics divide: the zeros add nothing to the row sums,
// and W's zero rows nothing to the products.  N is any width: W's loads
// read zeros past N (TMA's fill, or cp.async's), and the stores stop at N.
// The outputs' rows are `ldy` elements apart (N, or the wrapper's padded
// width, which the TMA store of mm_gelu needs: 16-byte aligned rows); an
// odd ldy takes one store per element.  M is any count below 2^31: the
// f32 kernels fold the row blocks into gridDim.x, the bf16 ones are
// persistent.
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
// 192 GFLOP; the matmul + gelu at (8192, 1024) @ (1024, 4096) 68.7 GFLOP
// and 159 MB (two outputs), 0.069 ms.  Only `wgmma` reaches that rate on
// this card, fed from shared memory faster than `cp.async` issued by the
// computing warps can fill it.
//
// bf16: three kernels on one main loop (`csrc/hopper.cuh` holds the PTX).
// Each runs persistent blocks, at most one per SM, of three warpgroups; a
// work item is (a row block, a run of column tiles), block b taking items
// b, b + gridDim.x, ... in that fixed order (`Walk`).  W comes by TMA
// (`cp.async.bulk.tensor`, 128-byte swizzle): one producer thread copies
// each 64-deep k tile into a ring of stages, each with a full and an empty
// mbarrier (transaction counts on the full ones).  A Linear weight (n
// contiguous) loads as 64 x 64 panels and is read by wgmma n-major; the
// tied decoder's transposed view (k contiguous) as one box, read k-major;
// both in place, each through its own tensor map built on the host per
// call (`w_map`).  TMA fills what lies past M, K or N with zeros: the
// ragged N = 30528 and any K edge need no mask.  Each output is one
// thread's sum over k in a fixed order: no split-K, no atomics, two calls
// give the same bits.
//
//  - ln_matmul, K <= 1024 (`lnmm_whole_kernel`): items of 64 rows and runs
//    of 256-column tiles.  All 12 warps first normalize the item's rows
//    into shared memory, whole (64 x 1024 x 2 = 128 KB at most), in
//    wgmma's A layout: 64-column k tiles of 128-byte rows, each 16-byte
//    chunk at chunk ^ (row % 8); h is the LayerNorm kernel's (one warp per
//    row, one pass, f32, each lane's sums in the same order), rounded to
//    bf16.  The W ring takes what is left: 3 stages at K = 1024, 4 at
//    BERT's 768, up to 6.  Warpgroups 1 and 2 consume columns 0-127 and
//    128-255 of each tile on the same h, wgmma m64n128k16, one batch kept
//    in flight while the previous stage is released.  No setmaxnreg: every
//    warp joins the LayerNorm at each item, so the roles reconverge.
//  - ln_matmul, K > 1024 (`lnmm_stats_kernel`, then `lnmm_stream_kernel`):
//    a first kernel writes each row's mean and rstd to f32 scratch from
//    the caller; then items of 128 rows, where each of 4 stages holds x's
//    128 x 64 k tile beside W's 64 x 256 (`produce_x_w`).  Consumer
//    warpgroups 1 and 2 each normalize their 64 rows of the landed x tile
//    into h in place while the other's products run, then issue wgmma
//    m64n256k16 on them.  `setmaxnreg` gives the consumers 232 registers
//    and the producer 40; a consumer warpgroup meets itself by named
//    barrier 1 or 2.  What bounds it (PERF.md): not the tensor cores; W
//    read out of L2 by every row block through a ring 3-4 stages deep.
//  - mm_gelu (`mbg_kernel`): items of one 128 x 128 tile, 5 stages of x's
//    and W's k tiles from the same producer loop; x goes straight from TMA
//    to wgmma.  The epilogue is the cost to hide: it adds the bias in f32
//    and writes z and y = gelu(z), two outputs, 64 KB a tile.  So the two
//    consumer warpgroups take alternate items (ping-pong), each over the
//    item's 128 rows as two m64n128k16 halves: one's epilogue runs while
//    the other's products hold the tensor cores.  Named barriers 1 and 2
//    give their main loops turns, so a warpgroup waits on the ring only
//    after the other has seen its last stage (an mbarrier tells its phases
//    apart by parity alone).  Measured (PERF.md), the epilogue first cost
//    more than the products: 4-byte stores from the registers, and tanhf
//    and erff, some twenty dependent instructions each.  So each
//    warpgroup writes z, then y, as bf16 into a 32 KB tile of shared
//    memory (the TMA store's 128-byte swizzle, conflict free) that one
//    thread stores by TMA, and gelu is taken from the f32 sum by one
//    ex2.approx and one fast division (`gelu_tanh_fast`, about 1e-6
//    relative to the tanh form; `gelu_erf_fast`, erf within 1.5e-7).  A W
//    past 16 MB (gpt_1p3b's) is walked 8 row blocks at a time (`place`),
//    so that it is read out of L2 and not streamed through it per row
//    block.
//
// f32 (the earlier kernels, on the CUDA cores; no TF32): output tiles of
// BM x BN, warps of 32 x 32, FMAs in mma.sync's m16n8 fragment layout; W
// (and, for mm_gelu, x) streams through shared memory in k tiles, ST in
// flight (cp.async); edge tiles are zero-filled and masked at the store.
// ln_matmul: a block normalizes its 32 rows into shared memory for K <=
// 1024 and walks a run of column tiles on that h; above 1024 it keeps each
// row's mean and rstd and normalizes every k tile of h into a stage beside
// W's.  mm_gelu: one block per output tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

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
  long long ldy;      // the row stride of y (and z), in elements, >= N
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
using MmF32 = Cfg<float, 64, 128, 32, 32, 32, 4, WT>;

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------
// 16 bytes to dst, of which the first `bytes` (0 to 16) come from src and
// the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the (BK, BN) tile of W at (k0, n0); what lies past K or N becomes zero
// (a copy that straddles N reads only the columns below it)
template <class C>
__device__ __forceinline__ void load_w(typename C::T* dst, const Args& a,
                                       int k0, int n0) {
  using T = typename C::T;
  const T* w = static_cast<const T*>(a.w);
  if (!C::WT) {
    constexpr int per_row = C::BN / C::V;
    for (int i = threadIdx.x; i < C::BK * per_row; i += C::kThreads) {
      const int kr = i / per_row, c = (i % per_row) * C::V;
      const int cols = k0 + kr < a.K ? min(C::V, a.N - n0 - c) : 0;
      cp_async16(dst + kr * C::LDW + c,
                 cols > 0 ? w + (k0 + kr) * a.sw_k + (n0 + c) : w,
                 cols > 0 ? cols * static_cast<int>(sizeof(T)) : 0);
    }
  } else {
    constexpr int per_row = C::BK / C::V;
    for (int i = threadIdx.x; i < C::BN * per_row; i += C::kThreads) {
      const int nr = i / per_row, c = (i % per_row) * C::V;
      const bool in = n0 + nr < a.N && k0 + c < a.K;
      cp_async16(dst + nr * C::LDW + c,
                 in ? w + (n0 + nr) * a.sw_n + (k0 + c) : w, in ? 16 : 0);
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
               in ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// the f32 products: acc[i][j] is the m16n8 tile (i, j) of the warp's tile,
// lane (g, t) = (lane / 4, lane % 4) holding rows g and g + 8 at columns
// 2t and 2t + 1: [0], [1] on row g, [2], [3] on row g + 8
// ---------------------------------------------------------------------------
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
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// columns col and col + 1 (col even, below N) of row m of an output with
// rows ld elements apart: one paired store when ld is even (col + 1 is then
// below N or in the row's padding), else one store each, below N
template <typename T>
__device__ __forceinline__ void store_cols(T* out, long long ld, int N, int m,
                                           int col, float a, float b) {
  T* p = out + static_cast<long long>(m) * ld + col;
  if ((ld & 1) == 0) {
    store2(p, a, b);
  } else {
    store1(p, a);
    if (col + 1 < N) store1(p + 1, b);
  }
}

// bias[col] and bias[col + 1], 0 past N or without a bias
template <typename T>
__device__ __forceinline__ void bias2(const T* bias, int N, int col,
                                      float& b0, float& b1) {
  b0 = bias && col < N ? to_f32(bias[col]) : 0.f;
  b1 = bias && col + 1 < N ? to_f32(bias[col + 1]) : 0.f;
}

// the tanh form as z * sigmoid(2 u) = z / (1 + 2^(-2 u log2 e)), u the
// tanh's argument: one ex2.approx and one fast division where tanhf takes
// some twenty dependent instructions; about 1e-6 relative to the exact
// form, and without 1 + tanh(u)'s cancellation at negative z
__device__ __forceinline__ float gelu_tanh_fast(float z) {
  const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
  return __fdividef(z, 1.f + hopper::ex2(-2.885390081777927f * u));
}

// the erf form with erf(x) = 1 - t (a1 + t (a2 + ... + t a5)) e^(-x^2), t =
// 1 / (1 + 0.3275911 |x|) (Abramowitz and Stegun 7.1.26, |error| <= 1.5e-7)
// where erff takes a branch per range: one fast division and one ex2.approx
__device__ __forceinline__ float gelu_erf_fast(float z) {
  const float x = fabsf(z) * 0.7071067811865476f;
  const float t = __fdividef(1.f, fmaf(0.3275911f, x, 1.f));
  const float poly =
      fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t, 1.421413741f),
                t, -0.284496736f),
           t, 0.254829592f) *
      t;
  const float e = hopper::ex2(-1.4426950408889634f * x * x);
  return 0.5f * z * (1.f + copysignf(1.f - poly * e, z));
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
    if (col >= a.N) continue;
    float b0, b1;
    bias2(bias, a.N, col, b0, b1);
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + i * 16 + g + 8 * half;
        if (row >= a.M) continue;
        const float v0 = acc[i][j][2 * half] + b0;
        const float v1 = acc[i][j][2 * half + 1] + b1;
        if (GELU) {
          store_cols(y, a.ldy, a.N, row, col, gelu(v0, a.approximate),
                     gelu(v1, a.approximate));
          store_cols(z, a.ldy, a.N, row, col, v0, v1);
        } else {
          store_cols(y, a.ldy, a.N, row, col, v0, v1);
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
  // blockIdx.x = row block * runs + run: the runs of a row block side by side
  const int ntiles = (a.N + C::BN - 1) / C::BN;
  const int nruns = (ntiles + a.tiles - 1) / a.tiles;
  const int m0 = static_cast<int>(blockIdx.x / nruns) * C::BM;
  const int first = static_cast<int>(blockIdx.x % nruns) * a.tiles;
  const int last = min(first + a.tiles, ntiles);
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
  // blockIdx.x = row block * column tiles + column tile
  const int ntiles = (a.N + C::BN - 1) / C::BN;
  const int n0 = static_cast<int>(blockIdx.x % ntiles) * C::BN;
  const int m0 = static_cast<int>(blockIdx.x / ntiles) * C::BM;
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
  const long long blocks =
      static_cast<long long>((ntiles + a.tiles - 1) / a.tiles) * row_blocks;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  return stream ? launch(ln_matmul_kernel<C, true>, grid, C::kThreads, smem,
                         a, s)
                : launch(ln_matmul_kernel<C, false>, grid, C::kThreads, smem,
                         a, s);
}

// ---------------------------------------------------------------------------
// ln_matmul in bf16 on wgmma and TMA
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

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
// matmul + bias + gelu: items of 128 x 128, 6 stages of (x, W) k tiles
// matmul + bias + gelu: items of 128 x 128, 5 stages of (x, W) k tiles,
// and an output tile's buffer for each consumer warpgroup
constexpr int kMbgBN = 128, kMbgStages = 5;
constexpr int kTileWn = kMbgBN * BK * 2;           // 16 KB
constexpr int kOutTile = kStreamBM * kMbgBN * 2;   // 32 KB

// the W stages that fit beside h and the block's barriers: 3 at K = 1024,
// 4 at BERT's 768, up to 6
__host__ __device__ constexpr int stages(int kt) {
  const int left = kSmem - 1024 - 2 * kMaxStages * 8;
  int st = kMaxStages;
  while (st > 2 && st * kTileW + kt * kTileH > left) --st;
  return st;
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

// item -> (row block, run of column tiles): `group` row blocks at a time,
// the group's items run by run, each run's row blocks in turn (group 1:
// row block by row block).  Items next to each other in time then share
// a run's W tiles out of L2.
__device__ __forceinline__ void place(int item, int items, int nruns,
                                      int group, int& rb, int& run) {
  const int g = item / (group * nruns), first = g * group;
  const int size = min(group, items / nruns - first);
  const int r = item - g * group * nruns;
  rb = first + r % size;
  run = r / size;
}

// the block's walk over its ring steps: items (a bm-row block, a run of
// `per` column tiles) b, b + gridDim.x, ... placed as `place` says; each
// tile's k tiles in order
struct Walk {
  int item, j, t, m0, j1;
  int bm;
  int items, nruns, per, ntiles, kt, group;
  __device__ Walk(int items_, int nruns_, int per_, int ntiles_, int kt_,
                  int bm_, int group_)
      : bm(bm_), items(items_), nruns(nruns_), per(per_), ntiles(ntiles_),
        kt(kt_), group(group_) {
    item = blockIdx.x;
    if (item < items) enter();
  }
  __device__ void enter() {
    int rb, run;
    place(item, items, nruns, group, rb, run);
    m0 = rb * bm;
    j = run * per;
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

// a ring of ST stages: one producer arrival fills a stage (with its copies'
// bytes), `consumers` warp arrivals empty it
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int ST, int consumers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the producer thread of the streaming kernels: each ring step's 128 x 64
// tile of x and 64 x TBN tile of W by TMA, as soon as its stage is
// released.  WT: W k-contiguous (a TBN x 64 box, read k-major); else n
// contiguous (TBN / 64 panels of 64 x 64, read n-major).
template <bool WT, int TBN>
__device__ __forceinline__ void produce_x_w(Walk walk,
                                            const CUtensorMap* xmap,
                                            const CUtensorMap* wmap,
                                            unsigned char* sA,
                                            unsigned char* sW, uint64_t* full,
                                            uint64_t* empty, int ST) {
  constexpr int kTile = TBN * BK * 2;
  for (int n = 0; !walk.done(); ++n, walk.next()) {
    const int s = n % ST, ph = (n / ST) & 1;
    mbar_wait(&empty[s], ph ^ 1);
    mbar_arrive_expect(&full[s], kTileX + kTile);
    tma_load(sA + s * kTileX, xmap, &full[s], walk.t * BK, walk.m0);
    unsigned char* dst = sW + s * kTile;
    if (WT) {
      tma_load(dst, wmap, &full[s], walk.t * BK, walk.j * TBN);
    } else {
#pragma unroll
      for (int p = 0; p < TBN / 64; ++p)
        tma_load(dst + p * (kTile / (TBN / 64)), wmap, &full[s],
                 walk.j * TBN + p * 64, walk.t * BK);
    }
  }
}

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
  ring_init(full, empty, ST, 8);   // each consumer warp

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
          if (col >= a.N) continue;
          float b0, b1;
          bias2(bias, a.N, col, b0, b1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + row + 8 * half;
            if (m >= a.M) continue;
            store_cols(y, a.ldy, a.N, m, col, acc[j8 * 4 + 2 * half] + b0,
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
  ring_init(full, empty, ST, 8);   // each consumer warp
  Walk walk(items, nruns, a.tiles, (a.N + BN - 1) / BN, (a.K + BK - 1) / BK,
            BM, 1);

  if (tid < 128) {
    // the producer: one thread copies each step's x and W tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == 0)
      produce_x_w<WT, BN>(walk, &xmap, &wmap, sA, sW, full, empty, ST);
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
        if (cn >= a.N) continue;
        float b0, b1;
        bias2(bias, a.N, cn, b0, b1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + row + 8 * half;
          if (m >= a.M) continue;
          store_cols(y, a.ldy, a.N, m, cn, acc[j8 * 4 + 2 * half] + b0,
                     acc[j8 * 4 + 2 * half + 1] + b1);
        }
      }
    }
  }
}


// matmul + bias + gelu, bf16: items of one 128 x 128 output tile, walked as
// the streaming kernel walks its runs (runs of one tile); the producer
// copies x's and W's k tiles into a ring of kMbgStages.  The two consumer
// warpgroups take alternate items (ping-pong): one's epilogue (gelu and two
// stores) runs while the other's products hold the tensor cores.  Each
// runs an item's 128 rows as two m64n128k16 halves (128 accumulators a
// thread).  Their main loops take turns by named barriers 1 and 2: a
// warpgroup waits for the ring's stages only after the other has seen its
// last, so no wait can match a phase of the other's item (an mbarrier
// tells phases apart by parity alone).  WT as in produce_x_w.
template <bool WT>
__global__ void __launch_bounds__(kThreads, 1)
    mbg_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap ymap,
               const __grid_constant__ CUtensorMap zmap, const Args a,
               int items, int ntiles, int group) {
  constexpr int BM = kStreamBM, TBN = kMbgBN, ST = kMbgStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sA = smem;                    // ST stages of x
  unsigned char* sW = sA + ST * kTileX;        // ST stages of W
  unsigned char* sOut = sW + ST * kTileWn;     // an output tile each
  uint64_t* full = reinterpret_cast<uint64_t*>(sOut + 2 * kOutTile);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  ring_init(full, empty, ST, 4);   // the consumer warpgroup's warps
  const int kt = (a.K + BK - 1) / BK;

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == 0)
      produce_x_w<WT, TBN>(Walk(items, ntiles, 1, ntiles, kt, BM, group),
                           &xmap, &wmap, sA, sW, full, empty, ST);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int cw = (tid >> 7) - 1;             // 0 or 1
  const int ct = tid & 127;                  // thread in the warpgroup
  const int lane = tid & 31;
  const int row = (ct >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.bias);
  unsigned char* out = sOut + cw * kOutTile;
  // this warpgroup's 128 threads
  auto wg_bar = [&]() { bar_sync(3 + cw, 128); };
  // acc into `out` in bf16, as two panels of 64 columns with the TMA
  // store's 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)):
  // conflict free, a warp's 8 rows of one chunk falling in 8 bank groups
  auto put = [&](const float (&v)[2][64]) {
#pragma unroll
    for (int j8 = 0; j8 < TBN / 8; ++j8)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = h * 64 + row + 8 * half;
          store2(reinterpret_cast<__nv_bfloat16*>(
                     out + (j8 / 8) * (kOutTile / 2) +
                     r * 128 + (((j8 % 8) ^ (r & 7)) << 4) + cq * 2),
                 v[h][j8 * 4 + 2 * half], v[h][j8 * 4 + 2 * half + 1]);
        }
    fence_async_shared();
    wg_bar();
  };
  // one thread stores the buffer's two panels to (m0, n0) by TMA
  auto send = [&](const CUtensorMap* map, int m0, int n0) {
    if (ct == 0) {
      tma_store(map, out, n0, m0);
      tma_store(map, out + kOutTile / 2, n0 + 64, m0);
      tma_store_commit();
    }
  };
  // ... and, before the buffer is written again, waits for them to read it
  auto drain = [&]() {
    if (ct == 0) tma_store_wait<true>();
    wg_bar();
  };
  // the block's items are blockIdx.x + i gridDim.x, i < nb; this
  // warpgroup takes i = cw, cw + 2, ..., whose k tiles are ring steps i kt
  // .. i kt + kt - 1.  Warpgroup 0 runs its main loop first; each lets the
  // other's start after its own, but for the block's last item (so every
  // arrival is waited for).
  const int nb = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (cw == 1) bar_arrive(1, 256);
  for (int i = cw; i < nb; i += 2) {
    const int item = blockIdx.x + i * gridDim.x;
    int rb, tile;
    place(item, items, ntiles, group, rb, tile);
    const int m0 = rb * BM, n0 = tile * TBN;
    float acc[2][64];   // rows 0-63 and 64-127 of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[h][e] = 0.f;
    int prev = -1;
    bar_sync(1 + cw, 256);   // this warpgroup's turn
    for (int t = 0; t < kt; ++t) {
      const int n = i * kt + t, s = n % ST, ph = (n / ST) & 1;
      mbar_wait(&full[s], ph);
      if (t == kt - 1 && i + 1 < nb) bar_arrive(2 - cw, 256);
      const unsigned char* tA = sA + s * kTileX;
      const unsigned char* tW = sW + s * kTileWn;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = WT ? desc(tW + kk * 32, 16, 1024)
                               : desc(tW + kk * 16 * 128, kTileWn / 2, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_m64n128k16<WT ? 0 : 1>(
              acc[h], desc(tA + h * (kTileX / 2) + kk * 32, 16, 1024), db,
              t > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous step's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    // epilogue: accumulator element (j8, e) of half h is row h 64 + `row`
    // (+ 8 for e >= 2), column j8 * 8 + cq (+ 1 for odd e).  z = acc +
    // bias goes out first; gelu is taken while TMA reads z's buffer.
#pragma unroll
    for (int j8 = 0; j8 < TBN / 8; ++j8) {
      const int col = n0 + j8 * 8 + cq;
      float b0, b1;
      bias2(bias, a.N, col, b0, b1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          acc[h][j8 * 4 + 2 * half] += b0;
          acc[h][j8 * 4 + 2 * half + 1] += b1;
        }
    }
    drain();   // this warpgroup's last item's y has been read
    put(acc);
    send(&zmap, m0, n0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 64; ++e)
        acc[h][e] = a.approximate ? gelu_tanh_fast(acc[h][e])
                                  : gelu_erf_fast(acc[h][e]);
    drain();
    put(acc);
    send(&ymap, m0, n0);
  }
  if (ct == 0) tma_store_wait<false>();
}

template <bool WT>
cudaError_t w_map(CUtensorMap* map, const Args& a, int bn) {
  return WT ? tensor_map(map, a.w, a.K, a.N, a.sw_n, BK, bn)
            : tensor_map(map, a.w, a.N, a.K, a.sw_k, 64, BK);
}

template <bool WT>
cudaError_t launch_whole(Args a, cudaStream_t stream) {
  CUtensorMap wmap;
  cudaError_t e = w_map<WT>(&wmap, a, BN);
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
  if (e == cudaSuccess) e = w_map<WT>(&wmap, a, BN);
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

template <bool WT>
cudaError_t launch_mbg(Args a, cudaStream_t stream) {
  CUtensorMap xmap, wmap, ymap, zmap;
  // x (M, K): 64 x 128 boxes; y and z (M, N): 64 x 128 boxes
  cudaError_t e = tensor_map(&xmap, a.x, a.K, a.M, a.K, BK, kStreamBM);
  if (e == cudaSuccess) e = w_map<WT>(&wmap, a, kMbgBN);
  if (e == cudaSuccess)
    e = tensor_map(&ymap, a.y, a.N, a.M, a.ldy, 64, kStreamBM);
  if (e == cudaSuccess)
    e = tensor_map(&zmap, a.z, a.N, a.M, a.ldy, 64, kStreamBM);
  if (e != cudaSuccess) return e;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return e;
  const int ntiles = (a.N + kMbgBN - 1) / kMbgBN;
  const int items = (a.M + kStreamBM - 1) / kStreamBM * ntiles;
  // W past 16 MB (gpt_1p3b's 2048 x 8192) is read out of L2 by groups of 8
  // row blocks: row by row, every row block would stream all of W through
  // L2 beside x; at GPT-345M's and BERT's 8 MB and less, row by row is as
  // fast or faster (PERF.md)
  const int group = 2ll * a.K * a.N > (16ll << 20) ? 8 : 1;
  const size_t smem = 1024 + static_cast<size_t>(kMbgStages) *
                                 (kTileX + kTileWn) +
                      2 * kOutTile + 2 * kMbgStages * sizeof(uint64_t);
  auto kern = mbg_kernel<WT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<std::min(items, sms), kThreads, smem, stream>>>(
      xmap, wmap, ymap, zmap, a, items, ntiles, group);
  return cudaGetLastError();
}

cudaError_t mm_gelu_bf16(const Args& a, cudaStream_t s) {
  return a.sw_k == 1 && a.sw_n != 1 ? launch_mbg<true>(a, s)
                                    : launch_mbg<false>(a, s);
}

}  // namespace wg

template <class C>
cudaError_t mm_gelu(const Args& a, cudaStream_t s) {
  const size_t smem =
      C::ST * (C::W_TILE + C::A_TILE) * sizeof(typename C::T);
  const long long blocks = static_cast<long long>((a.N + C::BN - 1) / C::BN) *
                           ((a.M + C::BM - 1) / C::BM);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  return launch(mm_gelu_kernel<C>, dim3(static_cast<unsigned>(blocks)),
                C::kThreads, smem, a, s);
}

// K a multiple of 8; W with unit stride along n or k and its other stride a
// multiple of 16 bytes (TMA's and cp.async's row alignment); ldy >= N, a
// multiple of 16 bytes where the TMA store writes the outputs
bool valid(const Args& a, int dtype, bool tma_out) {
  const int v = dtype == 0 ? 4 : 8;
  return a.M > 0 && a.K > 0 && a.N > 0 && a.K % 8 == 0 &&
         ((a.sw_n == 1 && a.sw_k % v == 0) ||
          (a.sw_k == 1 && a.sw_n % v == 0)) &&
         (dtype == 0 || dtype == 1) && a.ldy >= a.N &&
         (!tma_out || a.ldy % v == 0);
}

}  // namespace

// x (M, K) and r (or null) row-major; lw, lb (K,) or null; W (K, N) with
// strides (sw_k, sw_n), one of them 1, the other a multiple of 16 bytes;
// bias (N,) or null; y (M, N) row-major, contiguous; all 16-byte aligned.
// K a multiple of 8, N any width.  KD: the LayerNorm's true width, K less
// at most 7 zero columns of x, r, lw and lb (and zero rows of W) that the
// caller padded; the statistics divide by KD.  dtype: 0 = float32, 1 =
// bfloat16, for every tensor.
extern "C" int ptt_ln_matmul(const void* x, const void* r, const void* lw,
                             const void* lb, const void* w, const void* bias,
                             void* y, int M, int K, int KD, int N,
                             long long sw_k, long long sw_n, float eps,
                             int dtype, void* stats, void* stream) {
  Args a = {x, r, lw, lb, w, bias, y, nullptr, sw_k, sw_n, M, K, N, eps, 0,
            0, KD, N};
  if (!valid(a, dtype, false) || KD <= K - VEC || KD > K)
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
// row-major, their rows ldy elements apart (ldy >= N; bf16: a multiple of
// 8, for the TMA store); approximate: 1 the tanh form, 0 the erf form.
extern "C" int ptt_matmul_bias_gelu(const void* x, const void* w,
                                    const void* bias, void* y, void* z, int M,
                                    int K, int N, long long sw_k,
                                    long long sw_n, long long ldy,
                                    int approximate, int dtype,
                                    void* stream) {
  Args a = {x, nullptr, nullptr, nullptr, w, bias, y, z, sw_k, sw_n, M, K, N,
            0.f, approximate, 0, K, ldy};
  if (!valid(a, dtype, dtype == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wt = sw_k == 1 && sw_n != 1;
  cudaError_t e;
  if (dtype == 0)
    e = wt ? mm_gelu<MmF32<true>>(a, s) : mm_gelu<MmF32<false>>(a, s);
  else
    e = wg::mm_gelu_bf16(a, s);
  return static_cast<int>(e);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
