// Flash attention forward, dq and dk/dv for Hopper (sm_90a), on fixed
// lengths or on packed varlen sequences.
//
// Replaces the Pallas kernels `_fwd_kernel`, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (paddle_tpu/ops/pallas_ops.py, launched at the
// pallas_call sites in `_fwd` and `_bwd`) and, in packed mode, their varlen
// forms `_pk_fwd_kernel`, `_pk_bwd_dq_kernel` and `_pk_bwd_dkv_kernel`
// (launched in `_pk_fwd` and `_pk_bwd`).  Head sizes D in {32, 64, 128,
// 256}, and above 256 any multiple of 128: the wrapper pads other head
// sizes up to the next one, as the TPU wrapper pads to 128 lanes.  Each
// block works on one slice:
//
//  - fixed lengths: one (b, h) of q and do (B, Sq, H, D) and k and v (B,
//    Sk, H, D), with any strides of B, S and H and unit stride in D (the
//    slices of the QKV projection are read in place).  Query i keeps key j
//    when j < Sk and, if causal, j <= i + off, off = Sk - Sq (the diagonal
//    aligned to the end, as `_key_mask`).  `lens` (per b, `seq_lens`) keeps
//    keys j < lens[b] instead and makes off 0; `shift` (`causal_shift`, one
//    int32 read on the device, never by the host) overrides off.
//  - packed (varlen) mode: one (sequence, h) of q and do (total_q, H, D)
//    and k and v (total_k, H, D), read in place; sequence s owns rows
//    cu_q[s]..cu_q[s + 1] of q and cu_k[s]..cu_k[s + 1] of k, and within it
//    the fixed-length rule holds with Sq = len_q, Sk = len_k: the causal
//    diagonal is aligned bottom right (j <= i + len_k - len_q).  A tile
//    table built by the wrapper names each block's (sequence, first own
//    row), so a block only ever walks the tiles of its own sequence's band
//    and no off-band tile is launched or visited.
//
// out and dq are written contiguous in q's layout, dk and dv in k's; lse
// and delta are f32 (B * H, Sq) with fixed lengths and (H, total_q) packed.
// A query row with no key to keep gets out 0 and lse -1e30, as the plain
// version.
//
//   forward   s = q k^T * scale, masked; online softmax per row: m, l (the
//             UNdropped sum), acc += (p o keep / (1 - r)) v
//             out = acc / l (l == 0 -> 1), lse = m + log(l)
//   dq        p = exp(s - lse), dp = do v^T, dp o keep / (1 - r)
//             ds = p o (dp - delta), dq = scale * ds k
//   dk/dv     p~ = p o keep / (1 - r), dv = p~^T do
//             ds = p o (dp o keep / (1 - r) - delta), dk = scale * ds^T q
//
// delta is rowsum(out o do) less the lse's cotangent, as the JAX `_bwd`
// folds it; the kernels take it as given.
//
// The dropout keep mask is a hash of the element's (hb, row, col)
// coordinates (`_tile_keep_mask`), so the three kernels regenerate the
// same mask whatever their tiling.  With fixed lengths hb = b * Hh + h0 +
// h and (row, col) = (row0 + i, col0 + j), where the hash base (row0,
// col0, h0, Hh) is 0, 0, 0 and H unless the caller places the call inside
// a larger attention (a ring step: its rows and keys at their positions
// in the whole sequence; a head shard: its heads among all of them).
// Packed, the coordinates are those of the TPU
// kernel's block-aligned packed buffer: hb = h, row = start_q[s] + i, col =
// start_k[s] + j, where start_q (start_k) is the exclusive cumsum of the
// lengths rounded up to the TPU's block_q (block_k); the wrapper computes
// them from the same block sizes as the JAX `mha_packed` and passes them
// in `hstart`, whatever tile these kernels use.
//
// bf16 operands feed the products with f32 sums; p, p~ and ds are cast to
// the other operand's type before their products, as the TPU kernel does.
// f32 inputs take the CUDA cores (no TF32).  Where the TPU kernel computes
// exp(x) and divides by (1 - r), these take exp2 of x * log2(e) and
// multiply by 1 / (1 - r) in f32: the same values within a few units in the
// last place.
//
// What bounds it: at (B * H, S, D) = (256, 1024, 64) bf16 causal the
// forward does 34 GFLOP over 134 MB, the backward 120 GFLOP over 369 MB,
// so the tensor cores, not the memory, set the bound.  With dropout the
// forward also hashes every kept (query, key) pair, about 8 integer
// operations each (1.1 G at that shape): at the CUDA cores' integer rate,
// the same order of time as the products at the tensor cores' peak.
//
// The forward in bf16 at D 64 and 128, fixed lengths and packed (`wg::
// flash_fwd_wg_kernel`, FlashAttention-3's design): persistent blocks, one
// per SM, of three warpgroups, walking 128-row q tiles in pairs.  A
// producer thread copies each tile's Q into one of two buffers and its
// 128-key tiles of K and V into a ring of 2 stages by TMA (4-D tensor
// maps over q, k and v as they lie, the slices of the QKV projection read
// in place; rows past S come in as zeros), so the next tile's copies run
// under this one's last products and its epilogue.  Consumer warpgroups 0
// and 1 own 64 q rows each: S = Q K^T by wgmma m64n128k16 from shared
// memory, O += P V by wgmma with P from registers (rounded to bf16) and V
// read MN-major; the online softmax, the masks (on diagonal and ragged
// tiles only) and the dropout hash stay in registers while the other
// warpgroup's products run, the two issuing in turns by named barriers;
// each issues the next tile's S with the last tile's P V, so its own
// softmax overlaps them too.  `setmaxnreg` gives the consumers 232
// registers.  Two choices the card's times decided (PERF.md): a slice's q
// tiles go to neighbouring blocks, paired long with short (as much causal
// work a pair), so its K and V come from L2 and not once per q tile from
// memory; and dropout is a template argument, so each element's keep test
// is a select in one straight run of code, not a branch that splits the
// softmax into one block per element.
//
// dq and dk/dv in bf16 at D 64 and 128, on fixed lengths and packed (`wg::
// flash_bwd_dq_wg_kernel`, `wg::flash_bwd_dkv_wg_kernel`) take the same
// blocks: a producer copying tiles by TMA into a ring, two consumer
// warpgroups of 64 rows each (q rows for dq, keys for dk/dv) computing S
// and dP by wgmma from shared memory and dS in registers, which feeds dQ
// += dS K (or dV += P~^T dO and dK += dS^T Q) as wgmma's A operand.  Each
// keeps the rule below: one block sums a row tile's gradient over the
// other operand's tiles in order, so each recomputes S and dP (seven
// products where an atomic dq would need five).  Packed, a template
// argument (PK) so that the fixed-length kernels compile as before, the
// work units come from a table the wrapper builds on the host: each
// sequence's 128-row tiles paired long with short as `unit_tile` pairs
// them, the entries ordered by their work (the other operand's tiles they
// walk), largest first, each entry one unit per head, dealt to the
// persistent blocks back and forth.  The packed forward walks dq's key
// tiles, so it reads dq's table (PK in the forward too).  On bench_packed's
// 8 sequences the packed kernels stay 3.5-4.3x their byte bounds: the
// block with the most key-tile steps sets the time (PERF.md; the forward
// moved off the mma.sync kernel, 0.0529 -> 0.0363 ms at dropout 0).
//
// Every other case (f32, D 32 and 256, the wide heads) runs the mma.sync
// kernels, dropout a template argument there too: one block of 4
// warps per 64-row tile, each warp owning 16 rows; the other operand's
// tiles (64 rows; 16 in f32 at D = 256, where shared memory holds no
// more) staged in shared memory in two buffers, the next tile's copy
// (cp.async) in flight while the current one is used; the products by
// `mma.sync` m16n8k16 with ldmatrix fragment loads (bf16) or by FMAs in
// the same fragment layout (f32); the scores and the online softmax in
// registers, the masks applied only to tiles on the causal diagonal or at
// a ragged end.  At D = 256 one warp's f32 accumulators would take 128
// registers (256 for dk and dv), so the output columns are split over
// gridDim.z: two blocks each compute the scores (and dp) over the full D
// and accumulate 128 columns of out, dq, dk or dv; their lse is the same
// bits, and the first writes it.  Above 256 (`*_wide_kernel`) not even
// one operand's 64-row tile fits whole in shared memory beside the
// other's in f32: the scores (and dp) run over D in 128-column slabs, each
// slab of both operands staged in turn, and gridDim.z = D / 128 blocks
// each accumulate 128 output columns (no model in the repo has such heads,
// so this is the simple version: one copy in flight at a time, the
// operands re-read from L2 once per output block).  The dropout hash is
// over global coordinates, so the backward's 64-row tiles regenerate the
// forward's 128-row mask bit for bit.
//
// Deterministic sums: as the TPU grid, dq takes one block per (q tile, h)
// walking the k tiles, dk/dv one block per (k tile, h) walking the q tiles.
// No atomics, so dq, dk and dv are the same bits on every run.  Tiles
// wholly above the causal diagonal are skipped.
//
// This header holds the kernels and their launchers; each entry point
// is a translation unit of its own (flash_attention.cu: the forward
// and ptt_error_string, flash_attention_dq.cu, flash_attention_dkv.cu),
// which instantiates only its kernels, so that `ops/_build.py` compiles
// the three in parallel and links one library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;        // rows of a block's own tile
constexpr int kWarps = 4;        // 16 own rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;   // the running max before any key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// rows of the other operand's tile: 64, or 16 in f32 at D = 256, where two
// buffers of 64 rows do not fit in shared memory
template <typename T, int D>
__host__ __device__ constexpr int other_rows() {
  return sizeof(T) == 4 && D > 128 ? 16 : 64;
}

// output columns of one block: all of D up to 128; at D = 256 two blocks
// (blockIdx.z) take 128 each
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D > 128 ? 128 : D;
}

// blocks of the forward an SM should hold: 4 in bf16 up to D = 64, where
// shared memory allows 4 and 128 registers a thread suffice (a 140-register
// build held 3 and took 16% longer at (16, 1024, 16, 64)); else 1, no bound
template <typename T, int D>
__host__ __device__ constexpr int fwd_blocks() {
  return sizeof(T) == 2 && D <= 64 ? 4 : 1;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;      // forward: out; dq: dq; dk/dv: dk
  void* out2;     // dk/dv: dv
  float* lse;     // forward writes it, the backward reads it
  const float* delta;
  const int32_t* seed;
  const int32_t* lens;    // per b: keys < lens[b] are kept, or null
  const int32_t* shift;   // the causal offset, or null
  const int32_t* cu_q;    // packed: first q row of each sequence (B + 1)
  const int32_t* cu_k;    // packed: first k row of each sequence (B + 1)
  const int32_t* hstart;  // packed: hash bases start_q (B), start_k (B)
  const int32_t* tiles;   // packed: (sequence, first own row) per block
  int ntiles;
  // the packed kernels on wgmma: (sequence, first tile, second tile or
  // -1) per entry, 128-row tiles (q tiles for the forward and dq, k tiles
  // for dk/dv); unit u is entry u / H for head u % H
  const int32_t* units;
  int nunits;
  int ntx;     // mma.sync kernels: blocks per slice (row tiles, or ntiles);
               // blockIdx.x = slice * ntx + the block's tile
  // the dropout hash's base: row and column of q row 0 and key 0 (fixed
  // lengths), the first head and the heads a batch row spans (hb = b *
  // hheads + hhead0 + h; packed, hb = hhead0 + h)
  int hrow0, hcol0, hhead0, hheads;
  long long st[4][3];  // strides of b, s, h of q, k, v, do (elements)
  int B, H, Sq, Sk;    // packed: B sequences, Sq and Sk the totals
  float scale;
  uint32_t threshold;  // keep when (hash >> 8) >= threshold
  float inv_keep;      // 1 / (1 - p_drop), rounded to f32
  int dropout;
  int causal;
};

// what one block sees: its (b, h) slice of a fixed-length batch, or its
// (sequence, h) slice of the packed buffers
struct Slice {
  long long base[4];  // offsets (elements) of row 0 of q, k, v and do
  long long qrow;     // row 0 of q in out and dq (row stride H * D)
  long long krow;     // row 0 of k in dk and dv
  long long stat;     // index of q row 0's lse and delta
  int sq, sk;         // the slice's q and k rows
  int klen;           // keys < klen are kept
  int off;            // causal: query i keeps key j when j <= i + off
  int r0;             // the block's first own row (q, or k for dk/dv)
  int h;
  uint32_t hs;        // the hash's block part, seed ^ (hb * 0x9E3779B1)
  uint32_t hrow;      // hash row of q row 0
  uint32_t hcol;      // hash column of key 0
};

// the hash's block part and the causal offset's override, once the slice
// is known
__device__ __forceinline__ void finish_slice(Slice& v, const Args& a,
                                             int hb) {
  // clamped to +-2^30, so the sums below stay in int32; for any length
  // below 2^30 that keeps or drops the same keys as the shift itself
  if (a.shift != nullptr) v.off = max(-(1 << 30), min(*a.shift, 1 << 30));
  v.hs = a.dropout ? static_cast<uint32_t>(*a.seed) ^
                         (static_cast<uint32_t>(hb) * 0x9E3779B1u)
                   : 0u;
}

// fixed lengths: slice hb = b * H + h, the block's first own row r0
__device__ __forceinline__ Slice fixed_slice(const Args& a, int hb, int r0) {
  Slice v;
  const int b = hb / a.H;
  v.h = hb % a.H;
  v.r0 = r0;
  v.sq = a.Sq;
  v.sk = a.Sk;
  v.qrow = static_cast<long long>(b) * a.Sq;
  v.krow = static_cast<long long>(b) * a.Sk;
  v.stat = static_cast<long long>(hb) * a.Sq;
  v.klen = a.lens != nullptr ? max(0, min(a.lens[b], a.Sk)) : a.Sk;
  v.off = a.lens != nullptr ? 0 : a.Sk - a.Sq;
  v.hrow = static_cast<uint32_t>(a.hrow0);
  v.hcol = static_cast<uint32_t>(a.hcol0);
  for (int i = 0; i < 4; ++i) v.base[i] = b * a.st[i][0] + v.h * a.st[i][2];
  finish_slice(v, a, b * a.hheads + a.hhead0 + v.h);
  return v;
}

// packed: sequence s, head h, the block's first own row r0 (of the
// sequence's q rows, or its k rows for dk/dv)
__device__ __forceinline__ Slice packed_slice(const Args& a, int s, int h,
                                              int r0) {
  Slice v;
  v.r0 = r0;
  v.h = h;
  const int q0 = a.cu_q[s], k0 = a.cu_k[s];
  v.sq = a.cu_q[s + 1] - q0;
  v.sk = a.cu_k[s + 1] - k0;
  v.qrow = q0;
  v.krow = k0;
  v.stat = static_cast<long long>(v.h) * a.Sq + q0;
  v.klen = v.sk;
  v.off = v.sk - v.sq;
  v.hrow = static_cast<uint32_t>(a.hstart[s]);
  v.hcol = static_cast<uint32_t>(a.hstart[a.B + s]);
  for (int i = 0; i < 4; ++i)
    v.base[i] = static_cast<long long>(i == 1 || i == 2 ? k0 : q0) *
                    a.st[i][1] +
                v.h * a.st[i][2];
  finish_slice(v, a, a.hhead0 + v.h);
  return v;
}

// the mma.sync kernels' block: slice blockIdx.x / ntx (b * H + h, or the
// packed head h), tile blockIdx.x % ntx.  One grid axis holds both, so the
// slices are not bounded by gridDim.y's 65535; the hash reads the slice
// and the rows, not the block, so its bits do not depend on the grid.
__device__ __forceinline__ Slice slice_of(const Args& a) {
  const int sl = static_cast<int>(blockIdx.x / a.ntx);
  const int tx = static_cast<int>(blockIdx.x % a.ntx);
  if (a.tiles == nullptr) return fixed_slice(a, sl, tx * kRows);
  return packed_slice(a, a.tiles[2 * tx], sl, a.tiles[2 * tx + 1]);
}

// elements in a padded row of a shared tile: 16 bytes more than the data,
// so the fragment reads of 8 consecutive rows fall in different banks
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// the dropout hash; `hs` is the block's part, seed ^ (hb * 0x9E3779B1),
// and h the element's, row * 0x193E9 + col.  An element is kept when
// (hash >> 8) >= threshold.
__device__ __forceinline__ uint32_t drop_hash(uint32_t hs, uint32_t h) {
  h ^= hs;
  h *= 0x85EBCA6Bu;
  h ^= h >> 15;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 15);
}
__device__ __forceinline__ bool keep_elem(uint32_t hs, uint32_t row,
                                          uint32_t col, uint32_t threshold) {
  return (drop_hash(hs, row * 0x000193E9u + col) >> 8) >= threshold;
}

// ---------------------------------------------------------------------------
// tiles in shared memory, copied with cp.async
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

// starts the copy of rows [row0, row0 + R) and W columns of one slice into
// a padded shared tile; rows past S become zero.  16-byte copies: W *
// sizeof(T) and the strides are multiples of 16 bytes (the wrapper checks).
template <typename T, int W, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int LD = ld<T, W>();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool in = row0 + r < S;
    cp_async16(dst + r * LD + c,
               base + static_cast<long long>(in ? row0 + r : 0) * row_stride +
                   c,
               in);
  }
}

// ---------------------------------------------------------------------------
// the two products, in the m16n8 accumulator layout of mma.sync: lane
// (g, t) = (lane / 4, lane % 4) holds, of each 8-column n-tile, rows g and
// g + 8 at columns 2t and 2t + 1: c[0], c[1] on row g, c[2], c[3] on g + 8
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s[i][j] = sum_d A[i][d] * B[j][d]: A the warp's 16 rows, B 8 * NT rows,
// both padded shared tiles D wide.  Sums in f32; kAdd adds to s instead.
template <int D, int NT, bool kAdd = false>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                       const __nv_bfloat16* A,
                                       const __nv_bfloat16* B) {
  constexpr int LD = ld<__nv_bfloat16, D>();
  const int lane = threadIdx.x & 31;
  if (!kAdd)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];   // rows 0-7 / 8-15 by columns 0-7 / 8-15 of the k16 slab
    ldsm_x4<false>(a, A + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];   // n-tiles 2np and 2np + 1, k 0-7 and 8-15 each
      ldsm_x4<false>(b, B + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

template <int D, int NT, bool kAdd = false>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* A,
                                       const float* B) {
  constexpr int LD = ld<float, D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (!kAdd)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + g * LD + d);
    const float4 a1 = *reinterpret_cast<const float4*>(A + (g + 8) * LD + d);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = *reinterpret_cast<const float4*>(
            B + (n * 8 + 2 * t + e) * LD + d);
        s[n][e] = fmaf(a0.x, b.x, s[n][e]);
        s[n][e] = fmaf(a0.y, b.y, s[n][e]);
        s[n][e] = fmaf(a0.z, b.z, s[n][e]);
        s[n][e] = fmaf(a0.w, b.w, s[n][e]);
        s[n][2 + e] = fmaf(a1.x, b.x, s[n][2 + e]);
        s[n][2 + e] = fmaf(a1.y, b.y, s[n][2 + e]);
        s[n][2 + e] = fmaf(a1.z, b.z, s[n][2 + e]);
        s[n][2 + e] = fmaf(a1.w, b.w, s[n][2 + e]);
      }
    }
  }
}

// o[i][n] += sum_j p[i][j] * V[j][n] over 8 * NO columns: p the warp's
// (16, 8 * NT) scores in accumulator layout, cast to V's type first; V a
// padded shared tile of row stride LD, from its first column used.
template <int LD, int NO, int NT>
__device__ __forceinline__ void accumulate(float (&o)[NO][4],
                                           const float (&p)[NT][4],
                                           const __nv_bfloat16* V) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    // the accumulator layout of two n-tiles is the A layout of one k16
    const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t b[4];   // d-tiles 2dp and 2dp + 1, k 0-7 and 8-15 each
      ldsm_x4<true>(b, V + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

template <int LD, int NO, int NT>
__device__ __forceinline__ void accumulate(float (&o)[NO][4],
                                           const float (&p)[NT][4],
                                           const float* V) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8 * NT; ++j) {
    // p[g][j] and p[g + 8][j] live in lane (g, (j % 8) / 2)
    const int src = g * 4 + ((j & 7) >> 1);
    const float p0 = __shfl_sync(kFull, p[j >> 3][j & 1], src);
    const float p1 = __shfl_sync(kFull, p[j >> 3][2 + (j & 1)], src);
    const float* v = V + j * LD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const float2 w = *reinterpret_cast<const float2*>(v + dn * 8);
      o[dn][0] = fmaf(p0, w.x, o[dn][0]);
      o[dn][1] = fmaf(p0, w.y, o[dn][1]);
      o[dn][2] = fmaf(p1, w.x, o[dn][2]);
      o[dn][3] = fmaf(p1, w.y, o[dn][3]);
    }
  }
}

// (16, 8 * NO) accumulator rows -> rows < S of an output whose rows are
// `stride` elements apart
template <int NO>
__device__ __forceinline__ void store_rows(float* out, const float (&o)[NO][4],
                                           int row, int S, long long stride,
                                           float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row + 8 * half >= S) continue;
    float* dst = out + static_cast<long long>(row + 8 * half) * stride;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8 + 2 * t) =
          make_float2(o[dn][2 * half] * mul, o[dn][2 * half + 1] * mul);
  }
}

template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&o)[NO][4], int row,
                                           int S, long long stride,
                                           float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row + 8 * half >= S) continue;
    __nv_bfloat16* dst = out + static_cast<long long>(row + 8 * half) * stride;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dn][2 * half] * mul,
                                o[dn][2 * half + 1] * mul);
  }
}

// column (within the tile) and row offset (0 or 8) of accumulator element e
// of n-tile n
__device__ __forceinline__ int col_of(int n, int e) {
  return n * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}
__device__ __forceinline__ int row_of(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}

// -inf where the mask drops an element of the warp's score tile: element
// (r0 + row, c0 + col) is a (query, key) pair, or with kKeyRows a (key,
// query) pair; it stays when key < klen and query < sq and, if causal,
// key <= query + off
template <bool kKeyRows, int NT>
__device__ __forceinline__ void mask_tile(float (&s)[NT][4], int r0, int c0,
                                          const Slice& v, int causal) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + row_of(e), col = c0 + col_of(n, e);
      const int key = kKeyRows ? row : col, query = kKeyRows ? col : row;
      if (key >= v.klen || query >= v.sq || (causal && key > query + v.off))
        s[n][e] = -CUDART_INF_F;
    }
}

// the C-row k tiles a q tile starting at q0 walks: up to its last row's
// diagonal when causal (none when that lies before key 0)
template <int C>
__device__ __forceinline__ int kv_tiles(const Slice& v, int q0, int causal) {
  const int end = causal ? min(v.klen, q0 + kRows + v.off) : v.klen;
  return end > 0 ? (end + C - 1) / C : 0;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---------------------------------------------------------------------------
// forward: one block per (64-row q tile, slice, column half)
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads, (fwd_blocks<T, D>()))
    flash_fwd_kernel(const Args a) {
  constexpr int C = other_rows<T, D>(), NT = C / 8, DO = out_cols<D>();
  constexpr int LD = ld<T, D>(), LDO = ld<T, DO>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LD;   // two buffers of K
  T* sV = sK + 2 * C * LD;   // two buffers of V's DO columns from c0

  const Slice v = slice_of(a);
  const int c0 = blockIdx.z * DO;
  const int q0 = v.r0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16;
  const float sl2 = a.scale * kLog2e;

  const T* kb = static_cast<const T*>(a.k) + v.base[1];
  const T* vb = static_cast<const T*>(a.v) + v.base[2] + c0;
  const int tiles = kv_tiles<C>(v, q0, a.causal);
  load_tile<T, D, kRows>(sQ, static_cast<const T*>(a.q) + v.base[0],
                         a.st[0][1], q0, v.sq);
  if (tiles > 0) {
    load_tile<T, D, C>(sK, kb, a.st[1][1], 0, v.sk);
    load_tile<T, DO, C>(sV, vb, a.st[2][1], 0, v.sk);
  }
  cp_async_commit();

  // m in log2 units: the running max of s * scale * log2(e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * C;
    if (t + 1 < tiles) {
      const int nb = (t + 1) & 1;
      load_tile<T, D, C>(sK + nb * C * LD, kb, a.st[1][1], k0 + C, v.sk);
      load_tile<T, DO, C>(sV + nb * C * LDO, vb, a.st[2][1], k0 + C, v.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tK = sK + (t & 1) * C * LD;
    const T* tV = sV + (t & 1) * C * LDO;

    float s[NT][4];
    scores<D>(s, sQ + warp * 16 * LD, tK);
    if ((a.causal && k0 + C > q0 + v.off) || k0 + C > v.klen)
      mask_tile<false>(s, r0, k0, v, a.causal);
    float mcur[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mcur[e >> 1] = fmaxf(mcur[e >> 1], s[n][e]);
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mnew = fmaxf(m[i], quad_max(mcur[i]) * sl2);
      alpha[i] = exp2f(m[i] - mnew);
      m[i] = mnew;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], sl2, -m[e >> 1]));
        rsum[e >> 1] += p;
        if (DROP)
          p = keep_elem(v.hs, v.hrow + r0 + row_of(e),
                        v.hcol + k0 + col_of(n, e), a.threshold)
                  ? p * a.inv_keep
                  : 0.f;
        s[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rsum[i]);
#pragma unroll
    for (int dn = 0; dn < DO / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    accumulate<LDO>(o, s, tV);
    __syncthreads();   // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();   // no tile at all: the first copies are still out

  float lsafe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lsafe[i] = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) {
    o[dn][0] /= lsafe[0];
    o[dn][1] /= lsafe[0];
    o[dn][2] /= lsafe[1];
    o[dn][3] /= lsafe[1];
  }
  T* out = static_cast<T*>(a.out) + (v.qrow * a.H + v.h) * D + c0;
  store_rows(out, o, r0 + g, v.sq, static_cast<long long>(a.H) * D, 1.f);
  if (blockIdx.z == 0 && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < v.sq)
        a.lse[v.stat + row] = l[i] == 0.f ? kNegInf : m[i] * kLn2 + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (64-row q tile, slice, column half), walking the k tiles
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a) {
  constexpr int C = other_rows<T, D>(), NT = C / 8, DO = out_cols<D>();
  constexpr int LD = ld<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kRows * LD;
  T* sKV = sDO + kRows * LD;   // two buffers of (K, V)

  const Slice v = slice_of(a);
  const int c0 = blockIdx.z * DO;
  const int q0 = v.r0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16;
  const float sl2 = a.scale * kLog2e;

  const T* kb = static_cast<const T*>(a.k) + v.base[1];
  const T* vb = static_cast<const T*>(a.v) + v.base[2];
  const int tiles = kv_tiles<C>(v, q0, a.causal);
  load_tile<T, D, kRows>(sQ, static_cast<const T*>(a.q) + v.base[0],
                         a.st[0][1], q0, v.sq);
  load_tile<T, D, kRows>(sDO, static_cast<const T*>(a.dout) + v.base[3],
                         a.st[3][1], q0, v.sq);
  if (tiles > 0) {
    load_tile<T, D, C>(sKV, kb, a.st[1][1], 0, v.sk);
    load_tile<T, D, C>(sKV + C * LD, vb, a.st[2][1], 0, v.sk);
  }
  cp_async_commit();
  float lse2[2], delta[2];   // lse in log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse2[i] = row < v.sq ? a.lse[v.stat + row] * kLog2e : 0.f;
    delta[i] = row < v.sq ? a.delta[v.stat + row] : 0.f;
  }
  float dq[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * C;
    if (t + 1 < tiles) {
      T* next = sKV + ((t + 1) & 1) * 2 * C * LD;
      load_tile<T, D, C>(next, kb, a.st[1][1], k0 + C, v.sk);
      load_tile<T, D, C>(next + C * LD, vb, a.st[2][1], k0 + C, v.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tK = sKV + (t & 1) * 2 * C * LD;
    const T* tV = tK + C * LD;

    float p[NT][4], dp[NT][4];
    scores<D>(p, sQ + warp * 16 * LD, tK);
    scores<D>(dp, sDO + warp * 16 * LD, tV);
    if ((a.causal && k0 + C > q0 + v.off) || k0 + C > v.klen)
      mask_tile<false>(p, r0, k0, v, a.causal);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(fmaf(p[n][e], sl2, -lse2[e >> 1]));
        float dpe = dp[n][e];
        if (DROP)
          dpe = keep_elem(v.hs, v.hrow + r0 + row_of(e),
                          v.hcol + k0 + col_of(n, e), a.threshold)
                    ? dpe * a.inv_keep
                    : 0.f;
        p[n][e] = pe * (dpe - delta[e >> 1]);   // ds
      }
    accumulate<LD>(dq, p, tK + c0);
    __syncthreads();   // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();
  T* out = static_cast<T*>(a.out) + (v.qrow * a.H + v.h) * D + c0;
  store_rows(out, dq, r0 + g, v.sq, static_cast<long long>(a.H) * D,
             a.scale);
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (64-key tile, slice, column half), walking the q
// tiles; every score tile is transposed (rows are keys, columns queries)
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Args a) {
  constexpr int C = other_rows<T, D>(), NT = C / 8, DO = out_cols<D>();
  constexpr int LD = ld<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * LD;
  T* sQD = sV + kRows * LD;   // two buffers of (Q, dO)
  // two buffers of (lse in log2 units, delta), C each
  float* sStats = reinterpret_cast<float*>(sQD + 4 * C * LD);

  const Slice v = slice_of(a);
  const int c0 = blockIdx.z * DO;
  const int k0 = v.r0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = k0 + warp * 16;
  const float sl2 = a.scale * kLog2e;

  const T* qb = static_cast<const T*>(a.q) + v.base[0];
  const T* dob = static_cast<const T*>(a.dout) + v.base[3];
  // the q rows that reach this key tile: from its first key's diagonal on
  // when causal; none when all its keys are dropped
  const int first = a.causal ? max(0, k0 - v.off) : 0;
  const int tiles = k0 < v.klen && first < v.sq
                        ? (v.sq - first + C - 1) / C
                        : 0;
  auto stage = [&](int buf, int q0) {
    T* dst = sQD + buf * 2 * C * LD;
    load_tile<T, D, C>(dst, qb, a.st[0][1], q0, v.sq);
    load_tile<T, D, C>(dst + C * LD, dob, a.st[3][1], q0, v.sq);
    float* st = sStats + buf * 2 * C;
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const bool in = q0 + i < v.sq;
      st[i] = in ? a.lse[v.stat + q0 + i] * kLog2e : 0.f;
      st[C + i] = in ? a.delta[v.stat + q0 + i] : 0.f;
    }
  };
  load_tile<T, D, kRows>(sK, static_cast<const T*>(a.k) + v.base[1],
                         a.st[1][1], k0, v.sk);
  load_tile<T, D, kRows>(sV, static_cast<const T*>(a.v) + v.base[2],
                         a.st[2][1], k0, v.sk);
  if (tiles > 0) stage(0, first);
  cp_async_commit();
  float dk[DO / 8][4], dv[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int q0 = first + t * C;
    if (t + 1 < tiles) {
      stage((t + 1) & 1, q0 + C);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tQ = sQD + (t & 1) * 2 * C * LD;
    const T* tDO = tQ + C * LD;
    const float* sLse2 = sStats + (t & 1) * 2 * C;
    const float* sDelta = sLse2 + C;

    // p, then dv += p~^T do; then dp and ds, dk += ds^T q (p~ and dp are
    // never live together)
    float p[NT][4];
    uint32_t kept = 0xffffffffu;   // bit 4n + e: element (n, e) is kept
    scores<D>(p, sK + warp * 16 * LD, tQ);
    if ((a.causal && q0 + v.off < k0 + kRows) || q0 + C > v.sq ||
        k0 + kRows > v.klen)
      mask_tile<true>(p, r0, q0, v, a.causal);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col_of(n, e);
        p[n][e] = exp2f(fmaf(p[n][e], sl2, -sLse2[c]));
        if (DROP)
          kept &= keep_elem(v.hs, v.hrow + q0 + c, v.hcol + r0 + row_of(e),
                            a.threshold)
                      ? ~0u
                      : ~(1u << (4 * n + e));
      }
    {
      float pt[NT][4];   // p~, the dropped probabilities
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[n][e] = !DROP ? p[n][e]
                     : (kept >> (4 * n + e)) & 1u ? p[n][e] * a.inv_keep
                                                  : 0.f;
      accumulate<LD>(dv, pt, tDO + c0);
    }
    float dp[NT][4];
    scores<D>(dp, sV + warp * 16 * LD, tDO);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dpe = dp[n][e];
        if (DROP)
          dpe = (kept >> (4 * n + e)) & 1u ? dpe * a.inv_keep : 0.f;
        p[n][e] = p[n][e] * (dpe - sDelta[col_of(n, e)]);   // ds
      }
    accumulate<LD>(dk, p, tQ + c0);
    __syncthreads();   // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();
  const long long base = (v.krow * a.H + v.h) * D + c0;
  const long long stride = static_cast<long long>(a.H) * D;
  store_rows(static_cast<T*>(a.out) + base, dk, r0 + g, v.sk, stride,
             a.scale);
  store_rows(static_cast<T*>(a.out2) + base, dv, r0 + g, v.sk, stride, 1.f);
}


// ---------------------------------------------------------------------------
// wide heads: D > 256, a multiple of 128 (the wrapper pads, as the reference
// pads to 128 lanes).  Neither operand is held whole: every score tile is a
// contraction over D in 128-column slabs, each slab of both operands staged
// in shared memory in turn, and each block (gridDim.z = D / 128) accumulates
// 128 output columns.  One copy in flight at a time: the simple version.
// ---------------------------------------------------------------------------
constexpr int kSlab = 128;

// rows of the other operand's tile (shared memory holds three slab tiles)
template <typename T>
__host__ __device__ constexpr int wide_rows() {
  return sizeof(T) == 4 ? 32 : 64;
}

// s = A[a0 .. a0 + 64) . B[b0 .. b0 + C)^T over all D columns (the warp's
// 16 rows of A), through the slab tiles sA and sB; rows past aS or bS are
// zero.  Starts and ends with every thread past a barrier.
template <typename T, int C>
__device__ __forceinline__ void wide_scores(
    float (&s)[C / 8][4], T* sA, T* sB, const T* A, long long a_stride,
    int a0, int aS, const T* B, long long b_stride, int b0, int bS, int D) {
  constexpr int LD = ld<T, kSlab>();
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < C / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kSlab) {
    load_tile<T, kSlab, kRows>(sA, A + d0, a_stride, a0, aS);
    load_tile<T, kSlab, C>(sB, B + d0, b_stride, b0, bS);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scores<kSlab, C / 8, true>(s, sA + warp * 16 * LD, sB);
    __syncthreads();
  }
}

// rows [r0, r0 + C) of a 128-column slab into sB, waited for
template <typename T, int C>
__device__ __forceinline__ void wide_slab(T* sB, const T* base,
                                          long long stride, int r0, int S) {
  load_tile<T, kSlab, C>(sB, base, stride, r0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wide_kernel(const Args a, int D) {
  constexpr int C = wide_rows<T>(), NT = C / 8, LD = ld<T, kSlab>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kRows * LD;

  const Slice v = slice_of(a);
  const int c0 = blockIdx.z * kSlab;
  const int q0 = v.r0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16;
  const float sl2 = a.scale * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + v.base[0];
  const T* kb = static_cast<const T*>(a.k) + v.base[1];
  const T* vb = static_cast<const T*>(a.v) + v.base[2] + c0;
  const int tiles = kv_tiles<C>(v, q0, a.causal);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kSlab / 8][4];
#pragma unroll
  for (int dn = 0; dn < kSlab / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * C;
    float s[NT][4];
    wide_scores<T, C>(s, sA, sB, qb, a.st[0][1], q0, v.sq, kb, a.st[1][1], k0,
                      v.sk, D);
    if ((a.causal && k0 + C > q0 + v.off) || k0 + C > v.klen)
      mask_tile<false>(s, r0, k0, v, a.causal);
    float mcur[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mcur[e >> 1] = fmaxf(mcur[e >> 1], s[n][e]);
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mnew = fmaxf(m[i], quad_max(mcur[i]) * sl2);
      alpha[i] = exp2f(m[i] - mnew);
      m[i] = mnew;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], sl2, -m[e >> 1]));
        rsum[e >> 1] += p;
        if (DROP)
          p = keep_elem(v.hs, v.hrow + r0 + row_of(e),
                        v.hcol + k0 + col_of(n, e), a.threshold)
                  ? p * a.inv_keep
                  : 0.f;
        s[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rsum[i]);
#pragma unroll
    for (int dn = 0; dn < kSlab / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    wide_slab<T, C>(sB, vb, a.st[2][1], k0, v.sk);
    accumulate<LD>(o, s, sB);
    __syncthreads();
  }

  float lsafe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lsafe[i] = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
  for (int dn = 0; dn < kSlab / 8; ++dn) {
    o[dn][0] /= lsafe[0];
    o[dn][1] /= lsafe[0];
    o[dn][2] /= lsafe[1];
    o[dn][3] /= lsafe[1];
  }
  T* out = static_cast<T*>(a.out) + (v.qrow * a.H + v.h) * D + c0;
  store_rows(out, o, r0 + g, v.sq, static_cast<long long>(a.H) * D, 1.f);
  if (blockIdx.z == 0 && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < v.sq)
        a.lse[v.stat + row] = l[i] == 0.f ? kNegInf : m[i] * kLn2 + logf(l[i]);
    }
  }
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_wide_kernel(const Args a, int D) {
  constexpr int C = wide_rows<T>(), NT = C / 8, LD = ld<T, kSlab>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kRows * LD;

  const Slice v = slice_of(a);
  const int c0 = blockIdx.z * kSlab;
  const int q0 = v.r0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16;
  const float sl2 = a.scale * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + v.base[0];
  const T* kb = static_cast<const T*>(a.k) + v.base[1];
  const T* vb = static_cast<const T*>(a.v) + v.base[2];
  const T* dob = static_cast<const T*>(a.dout) + v.base[3];
  const int tiles = kv_tiles<C>(v, q0, a.causal);
  float lse2[2], delta[2];   // lse in log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse2[i] = row < v.sq ? a.lse[v.stat + row] * kLog2e : 0.f;
    delta[i] = row < v.sq ? a.delta[v.stat + row] : 0.f;
  }
  float dq[kSlab / 8][4];
#pragma unroll
  for (int dn = 0; dn < kSlab / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * C;
    float p[NT][4], dp[NT][4];
    wide_scores<T, C>(p, sA, sB, qb, a.st[0][1], q0, v.sq, kb, a.st[1][1], k0,
                      v.sk, D);
    wide_scores<T, C>(dp, sA, sB, dob, a.st[3][1], q0, v.sq, vb, a.st[2][1],
                      k0, v.sk, D);
    if ((a.causal && k0 + C > q0 + v.off) || k0 + C > v.klen)
      mask_tile<false>(p, r0, k0, v, a.causal);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(fmaf(p[n][e], sl2, -lse2[e >> 1]));
        float dpe = dp[n][e];
        if (DROP)
          dpe = keep_elem(v.hs, v.hrow + r0 + row_of(e),
                          v.hcol + k0 + col_of(n, e), a.threshold)
                    ? dpe * a.inv_keep
                    : 0.f;
        p[n][e] = pe * (dpe - delta[e >> 1]);   // ds
      }
    wide_slab<T, C>(sB, kb + c0, a.st[1][1], k0, v.sk);
    accumulate<LD>(dq, p, sB);
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + (v.qrow * a.H + v.h) * D + c0;
  store_rows(out, dq, r0 + g, v.sq, static_cast<long long>(a.H) * D,
             a.scale);
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_wide_kernel(const Args a, int D) {
  constexpr int C = wide_rows<T>(), NT = C / 8, LD = ld<T, kSlab>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kRows * LD;
  float* sLse2 = reinterpret_cast<float*>(sB + C * LD);   // C each
  float* sDelta = sLse2 + C;

  const Slice v = slice_of(a);
  const int c0 = blockIdx.z * kSlab;
  const int k0 = v.r0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = k0 + warp * 16;
  const float sl2 = a.scale * kLog2e;
  const T* qb = static_cast<const T*>(a.q) + v.base[0];
  const T* kb = static_cast<const T*>(a.k) + v.base[1];
  const T* vb = static_cast<const T*>(a.v) + v.base[2];
  const T* dob = static_cast<const T*>(a.dout) + v.base[3];
  const int first = a.causal ? max(0, k0 - v.off) : 0;
  const int tiles = k0 < v.klen && first < v.sq
                        ? (v.sq - first + C - 1) / C
                        : 0;
  float dk[kSlab / 8][4], dv[kSlab / 8][4];
#pragma unroll
  for (int dn = 0; dn < kSlab / 8; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int q0 = first + t * C;
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const bool in = q0 + i < v.sq;
      sLse2[i] = in ? a.lse[v.stat + q0 + i] * kLog2e : 0.f;
      sDelta[i] = in ? a.delta[v.stat + q0 + i] : 0.f;
    }
    float p[NT][4];
    uint32_t kept = 0xffffffffu;   // bit 4n + e: element (n, e) is kept
    wide_scores<T, C>(p, sA, sB, kb, a.st[1][1], k0, v.sk, qb, a.st[0][1],
                      q0, v.sq, D);
    if ((a.causal && q0 + v.off < k0 + kRows) || q0 + C > v.sq ||
        k0 + kRows > v.klen)
      mask_tile<true>(p, r0, q0, v, a.causal);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col_of(n, e);
        p[n][e] = exp2f(fmaf(p[n][e], sl2, -sLse2[c]));
        if (DROP)
          kept &= keep_elem(v.hs, v.hrow + q0 + c, v.hcol + r0 + row_of(e),
                            a.threshold)
                      ? ~0u
                      : ~(1u << (4 * n + e));
      }
    {
      float pt[NT][4];   // p~, the dropped probabilities
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[n][e] = !DROP ? p[n][e]
                     : (kept >> (4 * n + e)) & 1u ? p[n][e] * a.inv_keep
                                                  : 0.f;
      wide_slab<T, C>(sB, dob + c0, a.st[3][1], q0, v.sq);
      accumulate<LD>(dv, pt, sB);
      __syncthreads();
    }
    float dp[NT][4];
    wide_scores<T, C>(dp, sA, sB, vb, a.st[2][1], k0, v.sk, dob, a.st[3][1],
                      q0, v.sq, D);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dpe = dp[n][e];
        if (DROP)
          dpe = (kept >> (4 * n + e)) & 1u ? dpe * a.inv_keep : 0.f;
        p[n][e] = p[n][e] * (dpe - sDelta[col_of(n, e)]);   // ds
      }
    wide_slab<T, C>(sB, qb + c0, a.st[0][1], q0, v.sq);
    accumulate<LD>(dk, p, sB);
    __syncthreads();   // sB, sLse2 and sDelta are refilled next tile
  }
  const long long base = (v.krow * a.H + v.h) * D + c0;
  const long long stride = static_cast<long long>(a.H) * D;
  store_rows(static_cast<T*>(a.out) + base, dk, r0 + g, v.sk, stride,
             a.scale);
  store_rows(static_cast<T*>(a.out2) + base, dv, r0 + g, v.sk, stride, 1.f);
}

// ---------------------------------------------------------------------------
// forward on wgmma and TMA: bf16, fixed lengths or packed, D 64 or 128
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int kBM = 128;         // q rows of a block, 64 a consumer warpgroup
constexpr int kBN = 128;         // keys of a K or V tile
constexpr int kThreads = 384;    // a producer and two consumer warpgroups
constexpr int kPanel = 128 * 128;   // 128 rows of 64 bf16 columns, bytes
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// shared memory, bytes from a 1024-aligned base: two Q buffers, the K
// stages, the V stages (each a tile of 128 rows as D / 64 panels), then
// the barriers.  Stages of K and of V: 4 at D = 64, 2 at D = 128 (192 KB).
template <int D>
struct Layout {
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kTile = D / 64 * kPanel;
  static constexpr int Q = 0, K = 2 * kTile, V = K + kStages * kTile;
  static constexpr int BAR = V + kStages * kTile;
  static constexpr int kBytes = BAR + (4 + 4 * kStages) * 8;
};

// q, k, v or do as (B, S, H, D) with unit D stride, copied in boxes of 64
// columns x `rows` rows (128, or the backward's 64-row q tiles) of one (b,
// h): the TMA map's dims are D, then S, H and B in the order of their
// strides (a dim of extent 1 takes any stride); `perm` packs the
// positions (1-3) of S, H and B, 2 bits each
struct BshdMap {
  CUtensorMap map;
  int perm;
};

inline cudaError_t bshd_map(BshdMap* m, const void* base, int B, int S,
                            int H, int D, const long long* st /* b, s, h */,
                            int rows = kBM) {
  long long n[3] = {S, H, B}, stride[3] = {st[1], st[2], st[0]};
  long long top = D;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1) top = std::max(top, stride[i]);
  for (int i = 0; i < 3; ++i)
    if (n[i] == 1) stride[i] = top;
  int order[3] = {0, 1, 2};   // S, H, B by stride
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j)
      std::swap(order[j], order[j - 1]);
  long long dims[4] = {D}, strides[3];
  int box[4] = {64};
  m->perm = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = n[order[i]];
    strides[i] = stride[order[i]];
    box[i + 1] = order[i] == 0 ? rows : 1;
    m->perm |= (i + 1) << (2 * order[i]);
  }
  return tensor_map_nd(&m->map, base, 4, dims, strides, box);
}

// rows [s0, s0 + rows) and columns [d0, d0 + 64) of (b, h) into dst
__device__ __forceinline__ void tma_bshd(void* dst, const CUtensorMap* map,
                                         int perm, uint64_t* bar, int d0,
                                         int s0, int h, int b) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  auto at = [&](int pos) { return ps == pos ? s0 : ph == pos ? h : b; };
  tma_load_4d(dst, map, bar, d0, at(1), at(2), at(3));
}

// S = Q K^T over the N rows of K (m64nN, N / 2 a thread): Q's 64 rows
// and K k-major, each D / 64 panels of 128-byte rows, Q's panels kPanel
// bytes apart (a 128-row tile's), K's PK
template <int D, int N = kBN, int PK = kPanel>
__device__ __forceinline__ void qk_product(float (&s)[N / 2],
                                           const unsigned char* sQ,
                                           const unsigned char* tK) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = (kk / 4) * kPanel + (kk % 4) * 32;
    const int bt = (kk / 4) * PK + (kk % 4) * 32;
    if constexpr (N == 128)
      wgmma_m64n128k16<0>(s, desc(sQ + at, 16, 1024),
                          desc(tK + bt, 16, 1024), kk > 0);
    else
      wgmma_m64n64k16<0>(s, desc(sQ + at, 16, 1024), desc(tK + bt, 16, 1024),
                         kk > 0);
  }
  wgmma_commit();
}

// O += P V: P (64 x 16 KS keys) from registers, V (16 KS keys x D) in
// shared memory, D contiguous (MN-major, D / 64 panels PV bytes apart)
template <int PV = kPanel, int KS>
__device__ __forceinline__ void pv_product(float (&o)[32],
                                           const uint32_t (&p)[KS][4],
                                           const unsigned char* tV) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs_m64n64k16<1>(o, p[kk], desc(tV + kk * 16 * 128, PV, 1024), 1);
  wgmma_commit();
}
template <int PV = kPanel, int KS>
__device__ __forceinline__ void pv_product(float (&o)[64],
                                           const uint32_t (&p)[KS][4],
                                           const unsigned char* tV) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs_m64n128k16<1>(o, p[kk], desc(tV + kk * 16 * 128, PV, 1024), 1);
  wgmma_commit();
}

// The work units of the persistent kernels: unit u is slice u / np and two
// of its n 128-row tiles, n - 1 - p, then p (p = u % np, np = (n + 1) /
// 2): as much causal work in every unit, and a slice's units on
// neighbouring blocks, which share its other operand through L2; an odd
// n's middle tile is taken once.  Returns the tile, or -1 for the middle
// one's repeat.
__device__ __forceinline__ int unit_tile(int u, int which, int n) {
  const int np = (n + 1) / 2, pp = u % np;
  if (which == 1 && pp == n - 1 - pp) return -1;
  return which == 0 ? n - 1 - pp : pp;
}

// The packed kernels' unit u: entry u / H of the unit table, for head u
// % H, the table's entries largest work first, so that the persistent
// blocks (`next_unit`) take every head's longest units first.  Returns
// the entry's sequence; `tile` its tile `which` (-1: none).
__device__ __forceinline__ int packed_unit(const Args& a, int u, int which,
                                           int& tile) {
  const int32_t* e = a.units + 3 * (u / a.H);
  tile = e[1 + which];
  return e[0];
}

// A persistent block's unit in its round r, after unit u: with fixed
// lengths the stride b, b + gridDim.x, ... (every unit as much work);
// packed, the units (largest first) dealt back and forth, round r from the
// last block when r is odd, so that the blocks that took the longest
// units in one round take the shortest in the next (on bench_packed's
// sequences 10-12% faster than the stride, PERF.md)
template <bool PK>
__device__ __forceinline__ int next_unit(int u, int r) {
  if constexpr (PK)
    return r * gridDim.x + (r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  else
    return u + gridDim.x;
}

// item `which` of unit u over the nq q tiles (PK: of the packed unit
// table): the tile's first row q0, its slice v and the 128-key tiles it
// walks (up to its last row's diagonal when causal), or -1 when there is
// no item
template <bool PK>
__device__ __forceinline__ int q_item(const Args& a, int nq, int u, int which,
                                      int& q0, Slice& v) {
  if constexpr (PK) {
    int tile;
    const int s = packed_unit(a, u, which, tile);
    if (tile < 0) return -1;
    q0 = tile * kBM;
    v = packed_slice(a, s, u % a.H, q0);
  } else {
    const int tile = unit_tile(u, which, nq);
    if (tile < 0) return -1;
    q0 = tile * kBM;
    v = fixed_slice(a, u / ((nq + 1) / 2), q0);
  }
  const int end = a.causal ? min(v.klen, q0 + kBM + v.off) : v.klen;
  return end > 0 ? (end + kBN - 1) / kBN : 0;
}

// Persistent blocks, at most one per SM, of three warpgroups; the work
// units are pairs of 128-row q tiles of one b * h (`q_item`), block b taking
// units b, b + gridDim.x, ... (packed: `next_unit`).  A producer thread copies each
// item's Q into one of two buffers and its 128-key tiles of K and V into a
// ring of kStages that runs on across items, by TMA; consumer warpgroups 0
// and 1 own q rows 0-63 and 64-127 and walk the same key tiles.  Per tile
// a consumer issues S = Q K^T for it and O += P V for the tile before (P,
// rounded to bf16, from registers), then takes the softmax and the dropout
// of S while both run: the two warpgroups issue their products in turns
// (named barriers 1 and 2), so one's softmax overlaps the other's
// products.  The online softmax is flash_fwd_kernel's, element for element
// (exp2 by ex2.approx; the dropped p's 1 / (1 - r) applied to O once, at
// the end): wgmma's accumulator layout is mma.sync's per warp (warp w of a
// warpgroup holds its rows 16 w .. 16 w + 15).  DROP: dropout on, a
// template argument so that the per-element keep test is a select in one
// straight run of code, not a branch around each element's hash.  PK:
// packed sequences as dq's (`flash_bwd_dq_wg_kernel`): the units from the
// unit table, the maps over (1, total, H, D), a tile's rows absolute.  A
// 128-row tile that crosses its sequence's end reads the next sequence's
// rows, not zeros: keys past klen are masked on the tile that holds them
// (the ragged-tile test reads v.klen), and rows past sq are neither
// masked into another row nor stored.
template <int D, bool DROP, bool PK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const Args a, int perms, int units) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::BAR);   // 2 each
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* kempty = kfull + kStages;
  uint64_t* vfull = kempty + kStages;
  uint64_t* vempty = vfull + kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 8);   // each consumer warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&kfull[i], 1);
      mbar_init(&vfull[i], 1);
      mbar_init(&kempty[i], 8);
      mbar_init(&vempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // units of q tiles (q_item), the longer first
  const int nq = (a.Sq + kBM - 1) / kBM, np = (nq + 1) / 2;

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid != 0) return;
    const int qp = perms & 63, kp = (perms >> 6) & 63, vp = perms >> 12;
    int n = 0, qn = 0;   // ring steps and Q loads so far
    for (int r = 0, u = blockIdx.x; u < units; u = next_unit<PK>(u, ++r))
      for (int which = 0; which < 2; ++which) {
        int q0;
        Slice v;
        const int tiles = q_item<PK>(a, nq, u, which, q0, v);
        if (tiles <= 0) continue;
        // TMA coordinates: (row, h, b), rows absolute when packed
        const int b = PK ? 0 : u / np / a.H, qb = qn & 1;
        const int qs = PK ? static_cast<int>(v.qrow) + q0 : q0;
        const int ks = PK ? static_cast<int>(v.krow) : 0;
        mbar_wait(&qempty[qb], ((qn >> 1) & 1) ^ 1);
        mbar_arrive_expect(&qfull[qb], L::kTile);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_bshd(smem + L::Q + qb * L::kTile + p * kPanel, &qmap, qp,
                   &qfull[qb], p * 64, qs, v.h, b);
        ++qn;
        for (int t = 0; t < tiles; ++t, ++n) {
          const int stg = n % kStages, ph = ((n / kStages) & 1) ^ 1;
          mbar_wait(&kempty[stg], ph);
          mbar_arrive_expect(&kfull[stg], L::kTile);
#pragma unroll
          for (int p = 0; p < D / 64; ++p)
            tma_bshd(smem + L::K + stg * L::kTile + p * kPanel, &kmap, kp,
                     &kfull[stg], p * 64, ks + t * kBN, v.h, b);
          mbar_wait(&vempty[stg], ph);
          mbar_arrive_expect(&vfull[stg], L::kTile);
#pragma unroll
          for (int p = 0; p < D / 64; ++p)
            tma_bshd(smem + L::V + stg * L::kTile + p * kPanel, &vmap, vp,
                     &vfull[stg], p * 64, ks + t * kBN, v.h, b);
        }
      }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int cw = (tid >> 7) - 1;             // 0 or 1
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int wr = cw * 64 + ((tid & 127) >> 5) * 16;   // the warp's rows
  const float sl2 = a.scale * kLog2e;
  // (hash >> 8) >= threshold as hash >= 256 threshold: at p_drop = 1 that
  // wraps to 0 and keeps every element, but 1 / (1 - r) is then 0
  const uint32_t keep256 = a.threshold << 8;
  // the products are issued in turns: this warpgroup's, then the other's
  auto turn = [&]() { bar_sync(1 + cw, 256); };
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float o[D / 2];
  float s[kBN / 2];     // (8-column group j8, element e) at s[4 j8 + e]
  uint32_t p[kBN / 16][4];
  int n = 0, qn = 0;
  for (int r = 0, u = blockIdx.x; u < units; u = next_unit<PK>(u, ++r))
    for (int which = 0; which < 2; ++which) {
      int q0;
      Slice v;
      const int tiles = q_item<PK>(a, nq, u, which, q0, v);
      if (tiles < 0) continue;
      const int qw = q0 + cw * 64, r0 = q0 + wr;
      // m in log2 units: the running max of s * scale * log2(e)
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      // the hash's row part of this thread's two rows, and their first key's
      const uint32_t hrow[2] = {(v.hrow + r0 + g) * 0x000193E9u + v.hcol +
                                    2 * tq,
                                (v.hrow + r0 + g + 8) * 0x000193E9u + v.hcol +
                                    2 * tq};

      // s = the masked scores of the tile at key k0 -> p (kept, not yet
      // scaled by 1 / (1 - r)); m and l updated, alpha rescales O
      auto softmax = [&](int k0, float (&alpha)[2]) {
        if ((a.causal && k0 + kBN > qw + v.off) || k0 + kBN > v.klen)
#pragma unroll
          for (int j8 = 0; j8 < kBN / 8; ++j8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int query = r0 + g + 8 * (e >> 1);
              const int key = k0 + j8 * 8 + 2 * tq + (e & 1);
              if (key >= v.klen || query >= v.sq ||
                  (a.causal && key > query + v.off))
                s[4 * j8 + e] = -CUDART_INF_F;
            }
        float mcur[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          mcur[(i >> 1) & 1] = fmaxf(mcur[(i >> 1) & 1], s[i]);
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mnew = fmaxf(m[i], quad_max(mcur[i]) * sl2);
          alpha[i] = ex2(m[i] - mnew);
          m[i] = mnew;
        }
#pragma unroll
        for (int j8 = 0; j8 < kBN / 8; ++j8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = ex2(fmaf(s[4 * j8 + e], sl2, -m[e >> 1]));
            rsum[e >> 1] += pe;
            if (DROP)
              pe = drop_hash(v.hs, hrow[e >> 1] + k0 + j8 * 8 + (e & 1)) >=
                           keep256
                       ? pe
                       : 0.f;
            s[4 * j8 + e] = pe;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rsum[i]);
      };
      // s -> P: two 8-column groups of the accumulator are one k16 step of A
      auto to_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      };
      auto pass = [&](int t) {   // warpgroup 1 hands back all but its last
        if (cw == 0 || t + 1 < tiles) bar_arrive(2 - cw, 256);
      };

      if (tiles > 0) {
        const int qb = qn & 1;
        const unsigned char* sQ =
            smem + L::Q + qb * L::kTile + cw * (kPanel / 2);
        mbar_wait(&qfull[qb], (qn >> 1) & 1);
        if (cw == 1) bar_arrive(1, 256);   // warpgroup 0 goes first
        float alpha[2];
        int stg = n % kStages;
        mbar_wait(&kfull[stg], (n / kStages) & 1);
        turn();
        qk_product<D>(s, sQ, smem + L::K + stg * L::kTile);
        pass(0);
        wgmma_wait<0>();
        fence_regs(s);
        release(&kempty[stg]);
        softmax(0, alpha);
        to_p();
        for (int t = 1; t < tiles; ++t) {
          const int pn = n + t - 1, pst = pn % kStages;
          stg = (n + t) % kStages;
          mbar_wait(&kfull[stg], ((n + t) / kStages) & 1);
          turn();
          qk_product<D>(s, sQ, smem + L::K + stg * L::kTile);
          mbar_wait(&vfull[pst], (pn / kStages) & 1);
          pv_product(o, p, smem + L::V + pst * L::kTile);
          pass(t);
          wgmma_wait<1>();   // S is in
          fence_regs(s);
          release(&kempty[stg]);
          softmax(t * kBN, alpha);
          wgmma_wait<0>();   // so is O += P V of the tile before
          fence_regs(o);
          fence_regs(p);
          release(&vempty[pst]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
          to_p();
        }
        const int pn = n + tiles - 1, pst = pn % kStages;
        mbar_wait(&vfull[pst], (pn / kStages) & 1);
        pv_product(o, p, smem + L::V + pst * L::kTile);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        release(&vempty[pst]);
        release(&qempty[qb]);
        n += tiles;
        ++qn;
      }

      // out = O / l (times 1 / (1 - r) with dropout); a row with no key: 0
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        inv[i] = (DROP ? a.inv_keep : 1.f) / (l[i] == 0.f ? 1.f : l[i]);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                           (v.qrow * a.H + v.h) * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= v.sq) continue;
        __nv_bfloat16* dst = out + static_cast<long long>(row) * a.H * D;
#pragma unroll
        for (int j8 = 0; j8 < D / 8; ++j8)
          *reinterpret_cast<__nv_bfloat162*>(dst + j8 * 8 + 2 * tq) =
              __floats2bfloat162_rn(o[4 * j8 + 2 * half] * inv[half],
                                    o[4 * j8 + 2 * half + 1] * inv[half]);
        if (tq == 0)
          a.lse[v.stat + row] =
              l[half] == 0.f ? kNegInf : m[half] * kLn2 + logf(l[half]);
      }
    }
}

// fixed lengths: units of two q tiles of each (b, h); packed (a.units
// set): a.nunits entries of dq's unit table (the forward walks dq's key
// tiles) for each of the H heads, the maps over (1, total, H, D)
template <int D>
cudaError_t launch_fwd(const Args& a, cudaStream_t stream) {
  const bool pk = a.units != nullptr;
  BshdMap maps[3];
  const void* base[3] = {a.q, a.k, a.v};
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    e = bshd_map(&maps[i], base[i], pk ? 1 : a.B, i == 0 ? a.Sq : a.Sk, a.H,
                 D, a.st[i]);
  if (e != cudaSuccess) return e;
  const int perms = maps[0].perm | maps[1].perm << 6 | maps[2].perm << 12;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long nunits =
      pk ? static_cast<long long>(a.nunits) * a.H
         : static_cast<long long>(a.B) * a.H *
               (((a.Sq + kBM - 1) / kBM + 1) / 2);
  if (nunits >= (1ll << 31)) return cudaErrorInvalidValue;
  const int units = static_cast<int>(nunits);
  const size_t smem = 1024 + Layout<D>::kBytes;
  auto kern = pk ? (a.dropout ? flash_fwd_wg_kernel<D, true, true>
                              : flash_fwd_wg_kernel<D, false, true>)
                 : (a.dropout ? flash_fwd_wg_kernel<D, true, false>
                              : flash_fwd_wg_kernel<D, false, false>);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<std::min(units, sms), kThreads, smem, stream>>>(
      maps[0].map, maps[1].map, maps[2].map, a, perms, units);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward on wgmma and TMA: bf16, fixed lengths or packed, D 64 or 128
// ---------------------------------------------------------------------------

// dq's shared memory, bytes from a 1024-aligned base: the Q and dO
// buffers (two at D = 64, one at D = 128), the K stages, the V stages
// (128 rows each, D / 64 panels), then the barriers: 192 KB either way
template <int D>
struct DqLayout {
  static constexpr int kQBufs = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kTile = D / 64 * kPanel;
  static constexpr int Q = 0, DO = kQBufs * kTile, K = 2 * kQBufs * kTile;
  static constexpr int V = K + kStages * kTile, BAR = V + kStages * kTile;
  static constexpr int kBytes = BAR + (4 * kQBufs + 4 * kStages) * 8;
};

// dk/dv's: K and V of the key tile (two buffers at D = 64, one at 128),
// then a ring of kStages q tiles of kQT = 64 rows: Q, dO, and their rows'
// lse (log2 units) and delta in f32, then the barriers (197 KB at D = 64,
// 194 KB at 128).  64-row q tiles keep S^T and dP^T at 32 registers each:
// at D = 128 dK and dV take 64 each beside them, and at D = 64 there is
// room to hold a tile's products in flight (a first version of 128-row
// tiles, waiting on each product, took 1.2x this one's time; PERF.md).
template <int D>
struct DkvLayout {
  static constexpr int kQT = 64;
  static constexpr int kKBufs = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 8 : 4;
  static constexpr int kKTile = D / 64 * kPanel;        // 128 keys
  static constexpr int kQPanel = kQT * 128;             // kQT rows, 64 cols
  static constexpr int kQTile = D / 64 * kQPanel;
  static constexpr int K = 0, V = kKBufs * kKTile, Q = 2 * kKBufs * kKTile;
  static constexpr int DO = Q + kStages * kQTile;
  static constexpr int ST = DO + kStages * kQTile;      // 2 kQT floats each
  static constexpr int BAR = ST + kStages * 2 * kQT * 4;
  static constexpr int kBytes = BAR + (2 * kKBufs + 2 * kStages) * 8;
};

// Row 2 on Hopper.  Persistent blocks, at most one per SM, of three
// warpgroups walking units of two 128-row q tiles of one slice, paired
// long with short as the forward's.  A producer thread copies each q
// tile's Q and dO and the 128-key tiles of K and V into a ring (K and V
// with barriers of their own), by TMA over 4-D maps of q, k, v and do as
// they lie.  Consumer warpgroups 0 and 1 own q rows 0-63 and 64-127: per
// key tile S = Q K^T and dP = dO V^T by wgmma from shared memory, then, in
// registers, P = 2^(S scale log2 e - lse2) (masks on diagonal and ragged
// tiles only) while dP is still in flight, dS = P (select(keep, dP / (1 -
// r), 0) - delta) rounded to bf16 in the accumulator layout (which is
// wgmma's A layout), and dQ += dS K by wgmma with A from registers and K
// read MN-major, left in flight over the next tile's S and dP at D = 64.
// The key tiles are walked in order and dQ summed in f32 in registers: no
// atomics, the same bits every run.  DROP as the forward's.  PK: packed
// sequences, the units from the unit table (`packed_unit`) and the TMA
// maps over (1, total, H, D), a tile's rows absolute (the sequence's first
// row plus its own).  A 128-row tile that crosses its sequence's end reads
// the next sequence's rows, not zeros: the masks (query < sq, key < klen
// on ragged tiles) and the stores (row < sq) keep them out, and a dQ row
// depends on its own dS row only.
template <int D, bool DROP, bool PK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const Args a, int perms, int units) {
  using L = DqLayout<D>;
  constexpr int kStages = L::kStages, kQBufs = L::kQBufs;
  // dQ += dS K held in flight over the next key tile's S and dP: at D =
  // 64, where registers hold dS beside them (at 128 it is waited for)
  constexpr bool kHold = D == 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* qempty = qfull + kQBufs;
  uint64_t* kfull = qempty + kQBufs;
  uint64_t* kempty = kfull + kStages;
  uint64_t* vfull = kempty + kStages;
  uint64_t* vempty = vfull + kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 8);   // each consumer warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&kfull[i], 1);
      mbar_init(&vfull[i], 1);
      mbar_init(&kempty[i], 8);
      mbar_init(&vempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // units of q tiles (q_item), the longer first
  const int nq = (a.Sq + kBM - 1) / kBM, np = (nq + 1) / 2;

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid != 0) return;
    const int qp = perms & 63, kp = (perms >> 6) & 63;
    const int vp = (perms >> 12) & 63, dp = perms >> 18;
    int n = 0, qn = 0;   // ring steps and q tiles so far
    for (int r = 0, u = blockIdx.x; u < units; u = next_unit<PK>(u, ++r))
      for (int which = 0; which < 2; ++which) {
        int q0;
        Slice v;
        const int tiles = q_item<PK>(a, nq, u, which, q0, v);
        if (tiles <= 0) continue;
        // TMA coordinates: (row, h, b), rows absolute when packed
        const int b = PK ? 0 : u / np / a.H, qb = qn % kQBufs;
        const int qs = PK ? static_cast<int>(v.qrow) + q0 : q0;
        const int ks = PK ? static_cast<int>(v.krow) : 0;
        mbar_wait(&qempty[qb], ((qn / kQBufs) & 1) ^ 1);
        mbar_arrive_expect(&qfull[qb], 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          tma_bshd(smem + L::Q + qb * L::kTile + p * kPanel, &qmap, qp,
                   &qfull[qb], p * 64, qs, v.h, b);
          tma_bshd(smem + L::DO + qb * L::kTile + p * kPanel, &dmap, dp,
                   &qfull[qb], p * 64, qs, v.h, b);
        }
        ++qn;
        for (int t = 0; t < tiles; ++t, ++n) {
          const int stg = n % kStages, ph = ((n / kStages) & 1) ^ 1;
          mbar_wait(&kempty[stg], ph);
          mbar_arrive_expect(&kfull[stg], L::kTile);
#pragma unroll
          for (int p = 0; p < D / 64; ++p)
            tma_bshd(smem + L::K + stg * L::kTile + p * kPanel, &kmap, kp,
                     &kfull[stg], p * 64, ks + t * kBN, v.h, b);
          mbar_wait(&vempty[stg], ph);
          mbar_arrive_expect(&vfull[stg], L::kTile);
#pragma unroll
          for (int p = 0; p < D / 64; ++p)
            tma_bshd(smem + L::V + stg * L::kTile + p * kPanel, &vmap, vp,
                     &vfull[stg], p * 64, ks + t * kBN, v.h, b);
        }
      }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int cw = (tid >> 7) - 1;             // 0 or 1
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int wr = cw * 64 + ((tid & 127) >> 5) * 16;   // the warp's rows
  const float sl2 = a.scale * kLog2e;
  const uint32_t keep256 = a.threshold << 8;   // as the forward's
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float dq[D / 2];
  float s[kBN / 2], dp[kBN / 2];   // (8-column group j8, e) at [4 j8 + e]
  uint32_t ds[kBN / 16][4];
  int n = 0, qn = 0;
  for (int r = 0, u = blockIdx.x; u < units; u = next_unit<PK>(u, ++r))
    for (int which = 0; which < 2; ++which) {
      int q0;
      Slice v;
      const int tiles = q_item<PK>(a, nq, u, which, q0, v);
      if (tiles < 0) continue;
      const int qw = q0 + cw * 64, r0 = q0 + wr;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

      if (tiles > 0) {
        const int qb = qn % kQBufs;
        const unsigned char* sQ =
            smem + L::Q + qb * L::kTile + cw * (kPanel / 2);
        const unsigned char* sDO =
            smem + L::DO + qb * L::kTile + cw * (kPanel / 2);
        // this thread's two rows: lse in log2 units, delta, and the hash's
        // row part with its first key's column
        float lse2[2], delta[2];
        uint32_t hrow[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + g + 8 * i;
          lse2[i] = row < v.sq ? a.lse[v.stat + row] * kLog2e : 0.f;
          delta[i] = row < v.sq ? a.delta[v.stat + row] : 0.f;
          hrow[i] = (v.hrow + row) * 0x000193E9u + v.hcol + 2 * tq;
        }
        mbar_wait(&qfull[qb], (qn / kQBufs) & 1);
        for (int t = 0; t < tiles; ++t) {
          const int stg = (n + t) % kStages, ph = ((n + t) / kStages) & 1;
          const int k0 = t * kBN;
          const unsigned char* tK = smem + L::K + stg * L::kTile;
          mbar_wait(&kfull[stg], ph);
          qk_product<D>(s, sQ, tK);
          mbar_wait(&vfull[stg], ph);
          qk_product<D>(dp, sDO, smem + L::V + stg * L::kTile);
          wgmma_wait<1>();   // S is in (and a held dQ += dS K)
          fence_regs(s);
          if (kHold) {
            fence_regs(dq);
            fence_regs(ds);
            if (t > 0) release(&kempty[(n + t - 1) % kStages]);
          }
          if ((a.causal && k0 + kBN > qw + v.off) || k0 + kBN > v.klen)
#pragma unroll
            for (int j8 = 0; j8 < kBN / 8; ++j8)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int query = r0 + g + 8 * (e >> 1);
                const int key = k0 + j8 * 8 + 2 * tq + (e & 1);
                if (key >= v.klen || query >= v.sq ||
                    (a.causal && key > query + v.off))
                  s[4 * j8 + e] = -CUDART_INF_F;
              }
          // P in place while dP is in flight
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i)
            s[i] = ex2(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
          wgmma_wait<0>();   // dP is in
          fence_regs(dp);
          release(&vempty[stg]);
          // dS = P (select(keep, dP / (1 - r), 0) - delta), one k16 step
          // (two 8-column groups) at a time, rounded to bf16 at once
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
            for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
              const int e = i & 3, col = (i >> 2) * 8 + (e & 1);
              float dpe = dp[i];
              if (DROP)
                dpe = drop_hash(v.hs, hrow[e >> 1] + k0 + col) >= keep256
                          ? dpe * a.inv_keep
                          : 0.f;
              s[i] *= dpe - delta[e >> 1];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
              ds[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          }
          pv_product(dq, ds, tK);   // dQ += dS K, K read MN-major
          if (!kHold) {
            wgmma_wait<0>();
            fence_regs(dq);
            fence_regs(ds);
            release(&kempty[stg]);
          }
        }
        if (kHold) {
          wgmma_wait<0>();
          fence_regs(dq);
          fence_regs(ds);
          release(&kempty[(n + tiles - 1) % kStages]);
        }
        release(&qempty[qb]);
        n += tiles;
        ++qn;
      }

      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                           (v.qrow * a.H + v.h) * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= v.sq) continue;
        __nv_bfloat16* dst = out + static_cast<long long>(row) * a.H * D;
#pragma unroll
        for (int j8 = 0; j8 < D / 8; ++j8)
          *reinterpret_cast<__nv_bfloat162*>(dst + j8 * 8 + 2 * tq) =
              __floats2bfloat162_rn(dq[4 * j8 + 2 * half] * a.scale,
                                    dq[4 * j8 + 2 * half + 1] * a.scale);
      }
    }
}

// Row 3 on Hopper.  The same blocks walking units of two 128-key tiles of
// one slice (the longer first when causal: a key tile's q tiles start at
// its diagonal).  The producer warp copies each key tile's K and V once,
// and each kQT-row q tile of Q and dO into a ring by TMA, its lanes
// writing the tile's lse (log2 units) and delta beside them (loaded before
// the wait for a free stage: with the loads after it, the producer set the
// kernel's pace at D = 64).  Consumer
// warpgroups 0 and 1 own keys 0-63 and 64-127: per q tile S^T = K Q^T and
// dP^T = V dO^T by wgmma from shared memory; then in registers P^T (the
// lse by column), the keep bits from the hash over (query, key), P~^T =
// select(keep, P^T / (1 - r), 0) and dS^T = P^T (select(keep, dP^T / (1 -
// r), 0) - delta), both rounded to bf16, then dV += P~^T dO and dK += dS^T
// Q by wgmma with A from registers and dO and Q read MN-major.  At D = 64
// the products overlap the registers' work: P^T is made while dP^T runs,
// dS^T while dV runs, and dV and dK stay in flight over the next q tile's
// S^T and dP^T.  dK (times scale) and dV are stored at the end: the q
// tiles are walked in order, no atomics, the same bits every run.  PK as
// dq's, the units key tiles: queries past the sequence's end (the next
// sequence's rows, in a q tile that crosses it) are masked on that tile
// (query < sq), so their P^T and dS^T are 0 before dV += P~^T dO and dK +=
// dS^T Q, and their lse and delta are read as 0.
template <int D, bool DROP, bool PK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const Args a, int perms, int units) {
  using L = DkvLayout<D>;
  constexpr int kStages = L::kStages, kKBufs = L::kKBufs, QT = L::kQT;
  static_assert(QT / 2 <= 32, "a thread's keep bits fill one word");
  // at D = 64 products are held in flight: dP^T while P^T is made, dV
  // while dS^T is, a q tile's dV and dK over the next tile's S^T and dP^T;
  // at D = 128, where dK and dV take twice the registers, each product is
  // waited for (holding dV alone there measured 8% slower)
  constexpr bool kHold = D == 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kvempty = kvfull + kKBufs;
  uint64_t* qfull = kvempty + kKBufs;
  uint64_t* qempty = qfull + kStages;
  float* stats = reinterpret_cast<float*>(smem + L::ST);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kKBufs; ++i) {
      mbar_init(&kvfull[i], 1);
      mbar_init(&kvempty[i], 8);   // each consumer warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&qfull[i], 32);    // each producer lane
      mbar_init(&qempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // units of key tiles (unit_tile, or the packed unit table); item
  // `which` of unit u: its q tiles from `first`, or -1 when there is none
  const int nk = (a.Sk + kBN - 1) / kBN, np = (nk + 1) / 2;
  auto item = [&](int u, int which, int& k0, int& first, Slice& v) {
    if constexpr (PK) {
      int tile;
      const int s = packed_unit(a, u, which, tile);
      if (tile < 0) return -1;
      k0 = tile * kBN;
      v = packed_slice(a, s, u % a.H, k0);
    } else {
      const int tile = unit_tile(u, which, nk);
      if (tile < 0) return -1;
      k0 = (nk - 1 - tile) * kBN;   // the key tile with the most q tiles first
      v = fixed_slice(a, u / np, k0);
    }
    first = a.causal ? max(0, k0 - v.off) : 0;
    return k0 < v.klen && first < v.sq ? (v.sq - first + QT - 1) / QT : 0;
  };

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid >= 32) return;
    const int qp = perms & 63, kp = (perms >> 6) & 63;
    const int vp = (perms >> 12) & 63, dp = perms >> 18;
    int n = 0, kn = 0;   // ring steps and key tiles so far
    for (int r = 0, u = blockIdx.x; u < units; u = next_unit<PK>(u, ++r))
      for (int which = 0; which < 2; ++which) {
        int k0, first;
        Slice v;
        const int tiles = item(u, which, k0, first, v);
        if (tiles <= 0) continue;
        // TMA coordinates: (row, h, b), rows absolute when packed
        const int b = PK ? 0 : u / np / a.H, kb = kn % kKBufs;
        const int ks = PK ? static_cast<int>(v.krow) + k0 : k0;
        const int qs = PK ? static_cast<int>(v.qrow) : 0;
        mbar_wait(&kvempty[kb], ((kn / kKBufs) & 1) ^ 1);
        if (tid == 0) {
          mbar_arrive_expect(&kvfull[kb], 2 * L::kKTile);
#pragma unroll
          for (int p = 0; p < D / 64; ++p) {
            tma_bshd(smem + L::K + kb * L::kKTile + p * kPanel, &kmap, kp,
                     &kvfull[kb], p * 64, ks, v.h, b);
            tma_bshd(smem + L::V + kb * L::kKTile + p * kPanel, &vmap, vp,
                     &kvfull[kb], p * 64, ks, v.h, b);
          }
        }
        ++kn;
        for (int t = 0; t < tiles; ++t, ++n) {
          const int stg = n % kStages, q0 = first + t * QT;
          // the tile's rows' lse (log2 units) and delta, loaded before the
          // wait for a free stage
          float ls[QT / 32], dl[QT / 32];
#pragma unroll
          for (int j = 0; j < QT / 32; ++j) {
            const int row = q0 + tid + 32 * j;
            ls[j] = row < v.sq ? a.lse[v.stat + row] * kLog2e : 0.f;
            dl[j] = row < v.sq ? a.delta[v.stat + row] : 0.f;
          }
          mbar_wait(&qempty[stg], ((n / kStages) & 1) ^ 1);
          float* st = stats + stg * 2 * QT;
#pragma unroll
          for (int j = 0; j < QT / 32; ++j) {
            st[tid + 32 * j] = ls[j];
            st[QT + tid + 32 * j] = dl[j];
          }
          if (tid == 0) {
            mbar_arrive_expect(&qfull[stg], 2 * L::kQTile);
#pragma unroll
            for (int p = 0; p < D / 64; ++p) {
              tma_bshd(smem + L::Q + stg * L::kQTile + p * L::kQPanel, &qmap,
                       qp, &qfull[stg], p * 64, qs + q0, v.h, b);
              tma_bshd(smem + L::DO + stg * L::kQTile + p * L::kQPanel,
                       &dmap, dp, &qfull[stg], p * 64, qs + q0, v.h, b);
            }
          } else {
            mbar_arrive(&qfull[stg]);
          }
        }
      }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int cw = (tid >> 7) - 1;             // 0 or 1
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int wr = cw * 64 + ((tid & 127) >> 5) * 16;   // the warp's keys
  const float sl2 = a.scale * kLog2e;
  const uint32_t keep256 = a.threshold << 8;   // as the forward's
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float dk[D / 2], dv[D / 2];
  float s[QT / 2], dp[QT / 2];   // (8-column group j8, e) at [4 j8 + e]
  uint32_t pa[QT / 16][4], da[QT / 16][4];
  int n = 0, kn = 0;
  for (int r = 0, u = blockIdx.x; u < units; u = next_unit<PK>(u, ++r))
    for (int which = 0; which < 2; ++which) {
      int k0, first;
      Slice v;
      const int tiles = item(u, which, k0, first, v);
      if (tiles < 0) continue;
      const int kw = k0 + cw * 64, r0 = k0 + wr;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

      if (tiles > 0) {
        const int kb = kn % kKBufs;
        const unsigned char* sK =
            smem + L::K + kb * L::kKTile + cw * (kPanel / 2);
        const unsigned char* sV =
            smem + L::V + kb * L::kKTile + cw * (kPanel / 2);
        // the hash's column part of this thread's two keys
        const uint32_t hkey[2] = {v.hcol + r0 + g, v.hcol + r0 + g + 8};
        mbar_wait(&kvfull[kb], (kn / kKBufs) & 1);
        for (int t = 0; t < tiles; ++t) {
          const int stg = (n + t) % kStages, ph = ((n + t) / kStages) & 1;
          const int q0 = first + t * QT;
          const unsigned char* tQ = smem + L::Q + stg * L::kQTile;
          const unsigned char* tDO = smem + L::DO + stg * L::kQTile;
          const float* sLse2 = stats + stg * 2 * QT;
          const float* sDelta = sLse2 + QT;
          mbar_wait(&qfull[stg], ph);
          qk_product<D, QT, L::kQPanel>(s, sK, tQ);     // S^T = K Q^T
          qk_product<D, QT, L::kQPanel>(dp, sV, tDO);   // dP^T = V dO^T
          if (kHold) {
            wgmma_wait<1>();   // S^T is in, and the last tile's dV and dK
            fence_regs(dv);
            fence_regs(dk);
            fence_regs(pa);
            fence_regs(da);
            if (t > 0) release(&qempty[(n + t - 1) % kStages]);
          } else {
            wgmma_wait<0>();   // S^T and dP^T are in
            fence_regs(dp);
          }
          fence_regs(s);
          if ((a.causal && kw + 64 > q0 + v.off) || q0 + QT > v.sq ||
              kw + 64 > v.klen)
#pragma unroll
            for (int j8 = 0; j8 < QT / 8; ++j8)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = r0 + g + 8 * (e >> 1);
                const int query = q0 + j8 * 8 + 2 * tq + (e & 1);
                if (key >= v.klen || query >= v.sq ||
                    (a.causal && key > query + v.off))
                  s[4 * j8 + e] = -CUDART_INF_F;
              }
          // P^T in place, its keep bits (bit i: element i kept, the hash
          // over (query, key); this thread's first query's row part hq),
          // and P~^T rounded to bf16 for dV += P~^T dO
          const uint32_t hq = (v.hrow + q0 + 2 * tq) * 0x000193E9u;
          uint32_t kept = 0u;
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
            for (int j8 = 2 * kk; j8 < 2 * kk + 2; ++j8) {
              const float2 l2 =
                  *reinterpret_cast<const float2*>(sLse2 + j8 * 8 + 2 * tq);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * j8 + e;
                s[i] = ex2(fmaf(s[i], sl2, -(e & 1 ? l2.y : l2.x)));
                if (DROP)
                  kept |= (drop_hash(v.hs, hq + (j8 * 8 + (e & 1)) *
                                                    0x000193E9u +
                                               hkey[e >> 1]) >= keep256
                               ? 1u
                               : 0u)
                          << i;
              }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float pt[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int i = 8 * kk + 2 * r + c;
                pt[c] = !DROP ? s[i]
                        : (kept >> i) & 1u ? s[i] * a.inv_keep
                                           : 0.f;
              }
              pa[kk][r] = pack_bf16(pt[0], pt[1]);
            }
          }
          if (kHold) {
            pv_product<L::kQPanel>(dv, pa, tDO);   // dV += P~^T dO
            wgmma_wait<1>();   // dP^T is in; dV may still run
            fence_regs(dp);
          }
          // dS^T = P^T (select(keep, dP^T / (1 - r), 0) - delta) -> bf16
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
            for (int j8 = 2 * kk; j8 < 2 * kk + 2; ++j8) {
              const float2 dl =
                  *reinterpret_cast<const float2*>(sDelta + j8 * 8 + 2 * tq);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * j8 + e;
                float dpe = dp[i];
                if (DROP) dpe = (kept >> i) & 1u ? dpe * a.inv_keep : 0.f;
                dp[i] = s[i] * (dpe - (e & 1 ? dl.y : dl.x));
              }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
              da[kk][r] =
                  pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
          if (!kHold) pv_product<L::kQPanel>(dv, pa, tDO);
          pv_product<L::kQPanel>(dk, da, tQ);    // dK += dS^T Q
          if (!kHold) {
            wgmma_wait<0>();
            fence_regs(dv);
            fence_regs(dk);
            fence_regs(pa);
            fence_regs(da);
            release(&qempty[stg]);
          }
        }
        if (kHold) {
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
          release(&qempty[(n + tiles - 1) % kStages]);
        }
        release(&kvempty[kb]);
        n += tiles;
        ++kn;
      }

      const long long base = (v.krow * a.H + v.h) * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= v.sk) continue;
        const long long at = base + static_cast<long long>(row) * a.H * D;
        __nv_bfloat16* dst_k = static_cast<__nv_bfloat16*>(a.out) + at;
        __nv_bfloat16* dst_v = static_cast<__nv_bfloat16*>(a.out2) + at;
#pragma unroll
        for (int j8 = 0; j8 < D / 8; ++j8) {
          *reinterpret_cast<__nv_bfloat162*>(dst_k + j8 * 8 + 2 * tq) =
              __floats2bfloat162_rn(dk[4 * j8 + 2 * half] * a.scale,
                                    dk[4 * j8 + 2 * half + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(dst_v + j8 * 8 + 2 * tq) =
              __floats2bfloat162_rn(dv[4 * j8 + 2 * half],
                                    dv[4 * j8 + 2 * half + 1]);
        }
      }
    }
}

// the backward kernel of one case: dq or dk/dv, dropout or not, fixed
// lengths or packed
template <int D, bool PK, bool DKV>
auto bwd_kernel(bool drop) {
  if constexpr (DKV)
    return drop ? flash_bwd_dkv_wg_kernel<D, true, PK>
                : flash_bwd_dkv_wg_kernel<D, false, PK>;
  else
    return drop ? flash_bwd_dq_wg_kernel<D, true, PK>
                : flash_bwd_dq_wg_kernel<D, false, PK>;
}

// fixed lengths: units of two row tiles of each (b, h); packed (a.units
// set): a.nunits entries of the unit table for each of the H heads, the
// maps over (1, total, H, D)
template <int D, bool DKV>
cudaError_t launch_bwd(const Args& a, cudaStream_t stream) {
  constexpr bool dkv = DKV;
  const bool pk = a.units != nullptr;
  BshdMap maps[4];
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
    const bool kv = i == 1 || i == 2;
    e = bshd_map(&maps[i], base[i], pk ? 1 : a.B, kv ? a.Sk : a.Sq, a.H, D,
                 a.st[i], dkv && !kv ? DkvLayout<D>::kQT : kBM);
  }
  if (e != cudaSuccess) return e;
  const int perms = maps[0].perm | maps[1].perm << 6 | maps[2].perm << 12 |
                    maps[3].perm << 18;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = ((dkv ? a.Sk : a.Sq) + kBM - 1) / kBM;
  const long long nunits =
      pk ? static_cast<long long>(a.nunits) * a.H
         : static_cast<long long>(a.B) * a.H * ((tiles + 1) / 2);
  if (nunits >= (1ll << 31)) return cudaErrorInvalidValue;
  const int units = static_cast<int>(nunits);
  const size_t smem =
      1024 + (dkv ? DkvLayout<D>::kBytes : DqLayout<D>::kBytes);
  auto kern = pk ? bwd_kernel<D, true, DKV>(a.dropout)
                 : bwd_kernel<D, false, DKV>(a.dropout);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<std::min(units, sms), kThreads, smem, stream>>>(
      maps[0].map, maps[1].map, maps[2].map, maps[3].map, a, perms, units);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// the mma.sync kernels' grid: x = slices * ntx (each slice's row tiles, or
// the packed tile table, side by side), z the output column blocks
cudaError_t slice_grid(const Args& a, int zblocks, dim3* grid) {
  const long long blocks = static_cast<long long>(a.ntx) *
                           (a.tiles != nullptr ? a.H : a.B * a.H);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(blocks), 1, zblocks);
  return cudaSuccess;
}

template <int W, typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // bf16 at D 64 and 128: wgmma and TMA, fixed lengths and packed alike
  if constexpr (sizeof(T) == 2 && (D == 64 || D == 128)) {
    if constexpr (W == kFwd)
      return wg::launch_fwd<D>(a, stream);
    else
      return wg::launch_bwd<D, W == kDkv>(a, stream);
  }
  constexpr int C = other_rows<T, D>(), DO = out_cols<D>();
  constexpr size_t LD = ld<T, D>(), LDO = ld<T, DO>();
  const size_t own = kRows * LD * sizeof(T), other = C * LD * sizeof(T);
  const bool drop = a.dropout;
  void (*kern)(const Args);
  size_t smem;
  if constexpr (W == kFwd) {
    kern = drop ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
    smem = own + 2 * other + 2 * C * LDO * sizeof(T);   // Q, two (K, V)
  } else if constexpr (W == kDq) {
    kern = drop ? flash_bwd_dq_kernel<T, D, true>
                : flash_bwd_dq_kernel<T, D, false>;
    smem = 2 * own + 4 * other;   // Q, dO, two (K, V)
  } else {
    kern = drop ? flash_bwd_dkv_kernel<T, D, true>
                : flash_bwd_dkv_kernel<T, D, false>;
    smem = 2 * own + 4 * other + 4 * C * sizeof(float);   // K, V, two (Q, dO, stats)
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid;
  e = slice_grid(a, D / DO, &grid);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// D > 256, a multiple of 128: the slab kernels, D / 128 blocks along z
template <int W, typename T>
cudaError_t launch_wide(int d, const Args& a, cudaStream_t stream) {
  constexpr int C = wide_rows<T>();
  constexpr size_t LD = ld<T, kSlab>();
  size_t smem = (kRows + C) * LD * sizeof(T);   // sA, sB
  const bool drop = a.dropout;
  void (*kern)(const Args, int);
  if constexpr (W == kFwd) {
    kern = drop ? flash_fwd_wide_kernel<T, true>
                : flash_fwd_wide_kernel<T, false>;
  } else if constexpr (W == kDq) {
    kern = drop ? flash_bwd_dq_wide_kernel<T, true>
                : flash_bwd_dq_wide_kernel<T, false>;
  } else {
    kern = drop ? flash_bwd_dkv_wide_kernel<T, true>
                : flash_bwd_dkv_wide_kernel<T, false>;
    smem += 2 * C * sizeof(float);   // lse, delta
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid;
  e = slice_grid(a, d / kSlab, &grid);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, stream>>>(a, d);
  return cudaGetLastError();
}

template <int W, typename T>
cudaError_t launch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<W, T, 32>(a, stream);
    case 64: return launch<W, T, 64>(a, stream);
    case 128: return launch<W, T, 128>(a, stream);
    case 256: return launch<W, T, 256>(a, stream);
    default:
      return d > 256 && d % kSlab == 0 ? launch_wide<W, T>(d, a, stream)
                                       : cudaErrorInvalidValue;
  }
}

template <int W>
int run(const void* q, const void* k, const void* v,
        const void* dout, void* out, void* out2, float* lse,
        const float* delta, const void* seed, const void* lens,
        const void* shift, const void* cu_q, const void* cu_k,
        const void* hstart, const void* tiles, int ntiles,
        const void* units, int nunits, const long long* strides, int B,
        int H, int Sq, int Sk, int D, float scale, int threshold,
        float inv_keep, int causal, int dtype, void* stream,
        const int* hash) {
  const bool packed = tiles != nullptr;
  // lengths below 2^30 keep the masks' int32 sums from overflowing; every
  // packed kernel takes its unit table, fixed lengths none
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Sq >= (1 << 30) ||
      Sk >= (1 << 30) || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(B) * H >= (1ll << 31) ||
      (packed && (ntiles <= 0 || cu_q == nullptr || cu_k == nullptr ||
                  hstart == nullptr || lens != nullptr || shift != nullptr)) ||
      packed != (units != nullptr && nunits > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.out = out; a.out2 = out2; a.lse = lse; a.delta = delta;
  a.seed = static_cast<const int32_t*>(seed);
  a.lens = static_cast<const int32_t*>(lens);
  a.shift = static_cast<const int32_t*>(shift);
  a.cu_q = static_cast<const int32_t*>(cu_q);
  a.cu_k = static_cast<const int32_t*>(cu_k);
  a.hstart = static_cast<const int32_t*>(hstart);
  a.tiles = static_cast<const int32_t*>(tiles);
  a.ntiles = ntiles;
  a.units = static_cast<const int32_t*>(units);
  a.nunits = nunits;
  a.hrow0 = hash[0];
  a.hcol0 = hash[1];
  a.hhead0 = hash[2];
  a.hheads = hash[3] > 0 ? hash[3] : H;
  // the q tiles (forward, dq) or k tiles (dk/dv) of a slice
  a.ntx = packed ? ntiles : ((W == kDkv ? Sk : Sq) + kRows - 1) / kRows;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk;
  a.scale = scale;
  a.threshold = static_cast<uint32_t>(threshold);
  a.inv_keep = inv_keep;
  a.dropout = seed != nullptr;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch_d<W, float>(D, a, s)
                                   : launch_d<W, __nv_bfloat16>(D, a, s);
  return static_cast<int>(e);
}

}  // namespace

// The C entries (ptt_flash_fwd, ptt_flash_bwd_dq, ptt_flash_bwd_dkv, one a
// translation unit).  strides: (b, s, h) of q, k, v and do, 12 int64 values (do's unused by the
// forward).  Sq: q's (and do's) length, Sk: k's and v's.  seed: a device
// int32, or null for no dropout.  The masks, each a device pointer or null:
// lens (B int32: keys < lens[b] kept, the causal offset 0), shift (one
// int32: the causal offset).  Packed mode when tiles is not null: q, k, v
// and do are (total, H, D) (their b strides unused), B counts sequences, Sq
// and Sk are total_q and total_k, cu_q and cu_k (B + 1 int32) bound the
// sequences, hstart (2B int32) holds the hash bases start_q then start_k,
// and tiles (ntiles x 2 int32) names each block's (sequence, first own
// row): q tiles for the forward and dq, k tiles for dk/dv, 64 rows each.
// Packed, every entry also takes units (nunits x 3 int32), the wgmma
// kernels' unit table (Args::units: q tiles for the forward and dq, k
// tiles for dk/dv, 128 rows each; null and 0 with fixed lengths): bf16 at
// D 64 and 128 read it, every other case the tile table.  hash (after the
// stream): four host int32, the dropout hash's base (Args::hrow0, hcol0,
// hhead0, hheads; 0, 0, 0, 0 for the call's own coordinates, a heads count
// of 0 meaning H).
