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
// Any M, K and N.  The wrapper zero-pads x's columns to KP, the next
// multiple of 32 (zero columns of x against the weight's rows past K, which
// the kernel reads as zeros, add nothing); a weight whose rows are not 16
// bytes apart (N off a multiple of 16) is read by plain loads instead of
// cp.async; rows and columns past M and N are masked at the store.  The
// row blocks and column tiles share gridDim.x, so M is not bounded by
// gridDim.y.
//
// What bounds it: at decode (M <= 16) the int8 weight's bytes and the f32
// multiply-adds on it take about the same least time (a 4096 x 1024 weight:
// 1.3 us of bytes, 2 us of f32 FMAs off the tensor cores at M = 16); at
// prefill (M = 512) the multiply-adds.  No TF32: the f32 sums are held to
// 2e-5 against the plain version.  The design:
//
//  - The sum order (the split plan) depends on K alone: KP is cut into
//    kGroups = 8 equal groups of KP / 8 (a multiple of 4), the last ones
//    past K summing nothing but zeros.
//    Each output's group partial is one f32 chain, fmaf in ascending k from
//    0; the 8 partials are added in group order, and the scale multiplies
//    the sum.  So a row's result never depends on M, on the tile shape or on
//    which rows share the launch (the serve engine's contract: a request
//    decoded alone or inside any batch gives the same bits), and two calls
//    give the same bits.  No atomics.
//  - At decode (M <= 16) K is split over the grid: the 8 groups of one
//    output tile are the 8 blocks of one thread-block cluster
//    (`__cluster_dims__(1, 1, 8)`), so a 1024-column layer launches 32 x 8
//    = 256 blocks of 256 threads.  Each block leaves its group's partial
//    tile in its shared memory; after a cluster barrier, block r adds the 8
//    partials, in group order, for its own eighth of the tile's rows,
//    reading the others' shared memory (DSMEM), and stores out.  One
//    launch, no workspace, no second pass.
//  - At prefill one block walks all of K for a 64 x 64 output tile and
//    folds each group's chain into a running total at the group's end, in
//    group order: the same sums as the cluster's, without its barriers,
//    and the weight is read once per 64 rows.
//  - A block streams its k range in 64-deep subtiles through a ring of 4
//    (decode) or 3 (prefill) cp.async stages (16-byte copies: the weight as 16 int8 columns, x as 4
//    f32 or 8 bf16).  The weight subtile is widened to f32 in shared memory
//    once per block; x is read from its stage as it landed (bf16 widened in
//    registers).
//  - Register tiling: a thread owns TM x TN outputs (rows tm + i * BM / TM;
//    columns side by side, or in 4-wide runs 16 threads apart, so a warp's
//    shared loads do not collide) and reads 4 k of x per load: decode 2 x
//    1, prefill 4 x 4.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroups = 8;   // k groups, one block of the cluster each

template <int BM_, int BN_, int TM_, int TN_, int BK_, int ST_, bool SPLIT_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_,
                       ST = ST_;
  static constexpr bool SPLIT = SPLIT_;     // one group per cluster block
  static constexpr int RM = BM / TM;        // thread rows
  static constexpr int CN = BN / TN;        // thread columns
  static constexpr int kThreads = RM * CN;
  static constexpr int LDW = BN + 4;        // widened weight row (f32)
};

// decode: 16 x 32 outputs per block, 8 x 32 threads of 2 x 1, the 8 groups
// over a cluster; prefill: 64 x 64 per block, 16 x 16 threads of 4 x 4, one
// block walking all 8 groups
using Decode = Cfg<16, 32, 2, 1, 64, 4, true>;
using Prefill = Cfg<64, 64, 4, 4, 64, 3, false>;

// x's stage row: BK elements and 16 bytes of padding
template <class C, typename XT>
__host__ __device__ constexpr int ldx() {
  return C::BK + 16 / static_cast<int>(sizeof(XT));
}

template <class C, typename XT>
__host__ __device__ constexpr size_t stage_bytes() {
  return static_cast<size_t>(C::BM) * ldx<C, XT>() * sizeof(XT) +
         static_cast<size_t>(C::BK) * C::BN;
}

template <class C, typename XT>
__host__ __device__ constexpr size_t smem_bytes() {
  const size_t main = C::ST * stage_bytes<C, XT>() +
                      static_cast<size_t>(C::BK) * C::LDW * sizeof(float);
  const size_t part =
      C::SPLIT ? static_cast<size_t>(C::BM) * C::BN * sizeof(float) : 0;
  return main > part ? main : part;
}

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

// four consecutive k of one x row, as f32
__device__ __forceinline__ void x4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void x4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// column of a thread's output j: with TN a multiple of 4, 4-wide runs, a
// thread's runs BN / (TN / 4) apart and neighbouring threads on
// neighbouring runs; else TN neighbouring columns
template <class C>
__device__ __forceinline__ int col_of(int tn, int j) {
  if constexpr (C::TN % 4 == 0)
    return (j / 4) * (C::BN / (C::TN / 4)) + tn * 4 + (j % 4);
  else
    return tn * C::TN + j;
}

// 16 int8 columns [c, c + 16) of weight row k into dst by plain loads,
// zero past N or past the weight's rows (a row of N bytes, N off a
// multiple of 16, is not 16-byte aligned for cp.async)
__device__ __forceinline__ void w_row16(int8_t* dst, const int8_t* row,
                                        bool in, int c, int N) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (in) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c + e < N)
        v[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[c + e]))
                    << (8 * (e % 4));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// K: x's row width, a multiple of 32 (the wrapper's zero padding); KW: the
// weight's rows (KW <= K), the true width
template <class C, typename XT>
__device__ __forceinline__ void w8a16_tile(const XT* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           const float* __restrict__ scale,
                                           XT* __restrict__ out, int M, int K,
                                           int KW, int N) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, ST = C::ST;
  constexpr int TM = C::TM, TN = C::TN, LDX = ldx<C, XT>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* sW = reinterpret_cast<float*>(smem + ST * stage_bytes<C, XT>());

  const int tid = threadIdx.x;
  const int tn = tid % C::CN, tm = tid / C::CN;
  // blockIdx.x = row block * column tiles + column tile
  const int ntn = (N + BN - 1) / BN;
  const int n0 = static_cast<int>(blockIdx.x % ntn) * BN;
  const int m0 = static_cast<int>(blockIdx.x / ntn) * BM;
  const int kg = K / kGroups;
  // the block's k range: its cluster rank's group, or all of K
  const int kbeg = C::SPLIT ? blockIdx.z * kg : 0;
  const int kend = C::SPLIT ? kbeg + kg : K;
  const int nt = (kend - kbeg + BK - 1) / BK;

  auto sx = [&](int s) {
    return reinterpret_cast<XT*>(smem + s * stage_bytes<C, XT>());
  };
  auto sq = [&](int s) {
    return reinterpret_cast<int8_t*>(smem + s * stage_bytes<C, XT>() +
                                     static_cast<size_t>(BM) * LDX *
                                         sizeof(XT));
  };
  // x rows past M are zero in every stage, written once here and never
  // copied over (at decode most of the tile's rows)
  const int mrows = min(BM, M - m0);
  for (int s = 0; s < ST; ++s)
    for (int i = mrows * LDX + tid; i < BM * LDX; i += C::kThreads)
      sx(s)[i] = XT(0.f);
  // subtile t into stage t % ST: weight rows past KW read as zero
  const bool wvec = N % 16 == 0;   // weight rows 16-byte aligned
  auto load = [&](int t) {
    if (t < nt) {
      const int k0 = kbeg + t * BK;
      constexpr int XV = 16 / sizeof(XT);   // x elements per copy
      XT* dx = sx(t % ST);
      for (int i = tid; i < mrows * (BK / XV); i += C::kThreads) {
        const int r = i / (BK / XV), c = (i % (BK / XV)) * XV;
        const bool in = k0 + c < K;
        cp_async16(dx + r * LDX + c,
                   in ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x, in);
      }
      int8_t* dq = sq(t % ST);
      for (int i = tid; i < BK * (BN / 16); i += C::kThreads) {
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        const bool in = k0 + r < KW && n0 + c < N;
        const int8_t* row = w + static_cast<size_t>(k0 + r) * N + n0;
        if (wvec)
          cp_async16(dq + r * BN + c, in ? row + c : w, in);
        else
          w_row16(dq + r * BN + c, row, in, c, N - n0);
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

  // acc: the current group's chain; tot: the groups so far, added in order
  float acc[TM][TN], tot[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = tot[i][j] = 0.f;

  for (int s = 0; s < ST - 1; ++s) load(s);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ST - 2>();   // subtile t has landed
    __syncthreads();           // ... for every thread; t - 1 is done
    load(t + ST - 1);          // into the stage t - 1 used
    // widen the weight subtile to f32, 4 columns a thread at a time
    const int8_t* q = sq(t % ST);
    for (int i = tid; i < BK * (BN / 4); i += C::kThreads) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const char4 b = *reinterpret_cast<const char4*>(q + r * BN + c);
      *reinterpret_cast<float4*>(sW + r * C::LDW + c) =
          make_float4(b.x, b.y, b.z, b.w);
    }
    __syncthreads();
    const XT* xs = sx(t % ST);
    const int k0 = kbeg + t * BK;
    // four k of the subtile from kk: each thread's outputs, then (prefill)
    // the fold of a group that ends there
    auto step4 = [&](int kk) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) x4(xs + (tm + i * C::RM) * LDX + kk, a[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float b[TN];
        const float* wr = sW + (kk + u) * C::LDW;
        if constexpr (TN % 4 == 0) {
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 f =
                *reinterpret_cast<const float4*>(wr + col_of<C>(tn, j));
            b[j] = f.x; b[j + 1] = f.y; b[j + 2] = f.z; b[j + 3] = f.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = wr[col_of<C>(tn, j)];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][u], b[j], acc[i][j]);
      }
      // a group ends every kg = K / 8 k (a multiple of 4): fold its chain
      // into the total, in group order
      if (!C::SPLIT && (k0 + kk + 4) % kg == 0) {
        const bool first = k0 + kk + 4 == kg;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            tot[i][j] = first ? acc[i][j] : tot[i][j] + acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    };
    // a thread whose rows all lie past M has nothing to add (at decode a
    // whole warp: its rows are tm and tm + 8)
    const int kn = min(BK, kend - k0);   // a multiple of 4
    if (m0 + tm < M)
      for (int kk = 0; kk < kn; kk += 4) step4(kk);
  }
  cp_async_wait<0>();

  if constexpr (!C::SPLIT) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + tm + i * C::RM;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + col_of<C>(tn, j);
        if (n < N)
          store(out + static_cast<size_t>(m) * N + n, tot[i][j] * scale[n]);
      }
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    float* sP = reinterpret_cast<float*>(smem);   // reuses the stages
    __syncthreads();   // every stage is idle
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        sP[(tm + i * C::RM) * BN + col_of<C>(tn, j)] = acc[i][j];
    cluster.sync();   // every group's partial tile is in place

    // block r adds the groups' partials in group order for rows
    // [r * BM / 8, (r + 1) * BM / 8) of the tile
    constexpr int kRowsEach = BM / kGroups;
    const int r0 = static_cast<int>(cluster.block_rank()) * kRowsEach;
    for (int i = tid; i < kRowsEach * BN; i += C::kThreads) {
      const int mm = r0 + i / BN, nn = i % BN;
      const int m = m0 + mm, n = n0 + nn;
      const int at = mm * BN + nn;
      float s = cluster.map_shared_rank(sP, 0)[at];   // group 0, then 1, ...
#pragma unroll
      for (int g = 1; g < kGroups; ++g)
        s += cluster.map_shared_rank(sP, g)[at];
      if (m < M && n < N)
        store(out + static_cast<size_t>(m) * N + n, s * scale[n]);
    }
    cluster.sync();   // the others' partials stay until every block has read
  }
}

template <class C, typename XT>
__global__ void __cluster_dims__(1, 1, kGroups) __launch_bounds__(C::kThreads)
    w8a16_split_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, XT* __restrict__ out,
                       int M, int K, int KW, int N) {
  w8a16_tile<C, XT>(x, w, scale, out, M, K, KW, N);
}

template <class C, typename XT>
__global__ void __launch_bounds__(C::kThreads)
    w8a16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, XT* __restrict__ out, int M,
                 int K, int KW, int N) {
  w8a16_tile<C, XT>(x, w, scale, out, M, K, KW, N);
}

template <class C, typename XT>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   void* out, int M, int K, int KW, int N,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C, XT>();
  void (*kern)(const XT*, const int8_t*, const float*, XT*, int, int, int,
               int);
  if constexpr (C::SPLIT)
    kern = w8a16_split_kernel<C, XT>;
  else
    kern = w8a16_kernel<C, XT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>((N + C::BN - 1) / C::BN) *
                           ((M + C::BM - 1) / C::BM);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), 1, C::SPLIT ? kGroups : 1);
  kern<<<grid, C::kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<XT*>(out), M, K, KW, N);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t run(const void* x, const void* w, const void* scale, void* out,
                int M, int K, int KW, int N, cudaStream_t stream) {
  return M <= Decode::BM
             ? launch<Decode, XT>(x, w, scale, out, M, K, KW, N, stream)
             : launch<Prefill, XT>(x, w, scale, out, M, K, KW, N, stream);
}

}  // namespace

// x (M, K) with K a multiple of 32 (x's zero-padded width), w (KW, N)
// with KW <= K the weight's true rows (the sum order reads K alone), any N;
// x_dtype: 0 = float32, 1 = bfloat16.  The caller guarantees 16-byte
// aligned x and w.
extern "C" int ptt_w8a16_matmul(const void* x, const void* w,
                                const void* scale, void* out, int M, int K,
                                int KW, int N, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % 32 != 0 || KW <= 0 || KW > K || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (x_dtype == 0)
    e = run<float>(x, w, scale, out, M, K, KW, N, s);
  else if (x_dtype == 1)
    e = run<__nv_bfloat16>(x, w, scale, out, M, K, KW, N, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* ptt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
