// Blockwise (flash) attention for Hopper: forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of adapcc_tpu/ops/flash_attention.py:
//   forward  <- _fwd_kernel  (online-softmax forward, writes o and lse)
//   dq       <- _dq_kernel   (dq = sum_j ds_ij k_j)
//   dk/dv    <- _dkv_kernel  (dv = sum_i p_ij do_i, dk = sum_i ds_ij q_i)
// with p_ij = exp(s_ij - lse_i), s_ij = scale * q_i.k_j and
// ds_ij = p_ij * (do_i.v_j - delta_i) * scale, delta_i = rowsum(do_i * o_i) - dlse_i
// (delta is computed by the caller in plain torch, as _flash_bwd_core does).
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, T, D] contiguous, in float32 or
// bfloat16, D a multiple of 8 up to 128, any T; lse and delta are [BH, T]
// float32.  All sums are float32.
//
// Kernels, by the TPU kernel each replaces and the dtype:
//   _fwd_kernel  bf16: wg::flash_fwd_wgmma   float32: flash_fwd_kernel
//   _dq_kernel   bf16: wg::flash_dq_wgmma    float32: rb::flash_dq_kernel
//   _dkv_kernel  bf16: wg::flash_dkv_wgmma   float32: rb::flash_dkv_kernel
// bfloat16 (the DDP training path) runs on the tensor cores; float32
// (train_gpt2's path) on the CUDA cores, the exact float32 path: the tensor
// cores' float32 mode, TF32, keeps only 10 mantissa bits, so it is not used.
// Shared by all:
// * A block owns a tile of rows of its output (64 per (warp)group; query
//   rows for fwd/dq, key rows for dk/dv) and keeps their sums in registers
//   while the other operand streams through shared memory in tiles.  No
//   atomics: every block writes only its own rows, like the TPU grid
//   programs, so a result is the same bit for bit from run to run.
// * The TPU kernels loop over every key block and mask; under `causal` these
//   kernels skip the tiles that lie wholly above the diagonal.  That is exact:
//   a masked score is -1e30, so its p is exp(-1e30 - m) = 0 in float32, and
//   key 0 is never masked, so m is finite from the first tile on.
// * Blocks are ordered so that the longest causal rows start first (fwd, dq)
//   and the first key tiles, which see the most queries, first (dk/dv).
//
// Bound at the main path's shape (BH = 256, T = 512, D = 64, bf16, causal),
// on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//   fwd: reads q, k, v and writes o (4 x 16.8 MB) plus lse (0.5 MB) = 67.6 MB
//        -> 20 us; 4*D flops per unmasked (q, k) pair = 8.6 GFLOP -> 8.7 us
//        (13 us with p's bf16 remainder): bytes bound it.
//   dq:  q, k, v, do, dq (5 x 16.8 MB) + lse, delta = 85 MB -> 25 us;
//        6*D flops per pair = 12.9 GFLOP -> 13 us: bytes.
//   dkv: q, k, v, do, dk, dv (6 x 16.8 MB) + lse, delta = 102 MB -> 30 us;
//        8*D flops per pair = 17.2 GFLOP -> 17 us (26 us with the
//        remainders): bytes.
// What the bf16 kernels do about it (namespace wg): a producer warp keeps
// TMA loads of the next tiles in flight (2-stage ring, mbarriers) while
// consumer warpgroups run wgmma on the tiles that have landed, so no tile
// load sits exposed; the forward's blocks of 128 query rows (two
// warpgroups) re-read k and v from L2 half as often as 64-row blocks; the
// 128-byte-swizzled TMA tiles feed wgmma in both majors, so nothing is
// transposed in shared memory: dq reads one k tile K-major for q.k^T and
// MN-major for ds.k, and dk/dv loads two tiles a step (q, do) plus lse and
// delta; p comes from ex2 with the scale folded in.  None reaches its
// bound: each warpgroup waits on its own products (scores, then softmax or
// ds, then the row products) with only two to four warpgroups an SM to
// hide that.
//
// float32 at train_gpt2's shape (BH = 256, T = 512, D = 64, causal) is bound
// by operations at 67 TFLOP/s on the CUDA cores, and stays off TF32: dq's
// 12.9 GFLOP take 193 us against 50 us for its 169 MB, dk/dv's 17.2 GFLOP
// 257 us against 60 us.  What the backward pair (namespace rb) does about
// it: register-blocked 4 x 8 micro-tiles, so a thread reads each operand
// float4 once for 8 to 16 FMAs (the older row-per-lanes design read one
// float for one FMA and waited on a shuffle sum for every score), with
// tiles arriving by cp.async while the previous one is computed.  What
// remains against the bound: shared memory still delivers a float for
// every 2.7 FMAs (the FMA pipe waits about a third of the time), 12% of the
// work is on masked diagonal tiles at T = 512, and each tile's barriers
// (two in dq, four in dk/dv) stall the block.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the mask value of the TPU kernels
constexpr int kRows = 64;          // output rows owned by one block

// --------------------------------------------------------------------------
// float32 forward: CUDA cores
// --------------------------------------------------------------------------
//
// A group of TPR = DM/32 lanes of one warp shares an output row: each lane
// owns 8 interleaved float4 chunks of it (32 of the DM <= 128 padded head
// dims), and a dot product is reduced over the group with xor-shuffles.  The
// streamed operand goes through shared memory in tiles; every lane of a warp
// reads the same tile row, so the reads are broadcasts without bank
// conflicts.
constexpr int kTile = 32;          // rows of each streamed shared-memory tile
constexpr int kChunks = 8;         // float4 chunks of a row held by one lane

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Column of the i-th chunk owned by lane `part` of a TPR-lane row group.
template <int TPR>
__device__ __forceinline__ int chunk_col(int i, int part) {
  return 4 * (i * TPR + part);
}

// Loads one row of a [T, D] matrix into a lane's chunks; rows >= seq and
// columns >= dim read as zero (zero padding leaves every dot product exact).
template <int TPR>
__device__ __forceinline__ void load_row(float4 (&dst)[kChunks], const float* src,
                                         int row, int seq, int dim, int part) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = chunk_col<TPR>(i, part);
    dst[i] = (row < seq && c < dim) ? load4(src + (size_t)row * dim + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int TPR>
__device__ __forceinline__ void store_row(float* dst, const float4 (&src)[kChunks],
                                          float mul, int row, int seq, int dim,
                                          int part) {
  if (row >= seq) return;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = chunk_col<TPR>(i, part);
    if (c < dim) {
      const float4 v = src[i];
      store4(dst + (size_t)row * dim + c,
             make_float4(v.x * mul, v.y * mul, v.z * mul, v.w * mul));
    }
  }
}

// Copies rows [row0, row0 + kTile) of a [T, D] matrix into a shared tile.
template <int DM>
__device__ __forceinline__ void load_tile(float (*tile)[DM], const float* src,
                                          int row0, int seq, int dim) {
  constexpr int kPerRow = DM / 4;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += blockDim.x) {
    const int r = idx / kPerRow;
    const int c = 4 * (idx % kPerRow);
    const int g = row0 + r;
    store4(&tile[r][c], (g < seq && c < dim)
                            ? load4(src + (size_t)g * dim + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// Partial dot product of a lane's chunks with its chunks of a tile row.
template <int TPR>
__device__ __forceinline__ float dot_part(const float4 (&a)[kChunks],
                                          const float* row, int part) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 b = load4(row + chunk_col<TPR>(i, part));
    s0 = fmaf(a[i].x, b.x, s0);
    s1 = fmaf(a[i].y, b.y, s1);
    s0 = fmaf(a[i].z, b.z, s0);
    s1 = fmaf(a[i].w, b.w, s1);
  }
  return s0 + s1;
}

template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int TPR>
__device__ __forceinline__ void axpy(float4 (&acc)[kChunks], float a,
                                     const float* row, int part) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 b = load4(row + chunk_col<TPR>(i, part));
    acc[i].x = fmaf(a, b.x, acc[i].x);
    acc[i].y = fmaf(a, b.y, acc[i].y);
    acc[i].z = fmaf(a, b.z, acc[i].z);
    acc[i].w = fmaf(a, b.w, acc[i].w);
  }
}

template <int DM>
__global__ void __launch_bounds__(kRows * (DM / 32))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int bh_count, int seq, int dim,
                 float scale, int causal) {
  constexpr int TPR = DM / 32;
  __shared__ __align__(16) float ks[kTile][DM];
  __shared__ __align__(16) float vs[kTile][DM];

  const int n_tiles = (seq + kRows - 1) / kRows;
  const int tile = n_tiles - 1 - blockIdx.x / bh_count;  // longest rows first
  const int bh = blockIdx.x % bh_count;
  const int part = threadIdx.x % TPR;
  const int row = tile * kRows + threadIdx.x / TPR;
  const size_t base = (size_t)bh * seq * dim;

  float4 qr[kChunks], acc[kChunks];
  load_row<TPR>(qr, q + base, row, seq, dim, part);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.f;

  const int last_row = min(tile * kRows + kRows, seq) - 1;
  const int k_end = causal ? last_row + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    load_tile<DM>(ks, k + base, k0, seq, dim);
    load_tile<DM>(vs, v + base, k0, seq, dim);
    __syncthreads();

    float s[kTile];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float x = group_sum<TPR>(dot_part<TPR>(qr, ks[j], part)) * scale;
      const int key = k0 + j;
      if (key >= seq || (causal && key > row)) x = kNegInf;
      s[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) axpy<TPR>(acc, s[j], vs[j], part);
    m = m_new;
  }

  store_row<TPR>(o + base, acc, 1.f / l, row, seq, dim, part);
  if (part == 0 && row < seq) lse[(size_t)bh * seq + row] = m + logf(l);
}

// --------------------------------------------------------------------------
// float32 backward (dq, dk/dv): register-blocked tiles on the CUDA cores
// --------------------------------------------------------------------------
//
// A block owns ROWS rows of its output (query rows for dq, key rows for
// dk/dv) and stages their two operands once in shared memory (q and do for
// dq, k and v for dk/dv).  The other side streams in tiles of TILE rows
// filled by cp.async: a two-stage ring for one operand (k for dq; q, lse
// and delta for dk/dv), whose tile i + 1 is queued as the math on tile i
// starts, and one buffer for the other (v for dq, read by stage 1 only; do
// for dk/dv, read by stage 1 and dv's product), refilled as soon as its
// last reader is done, during the rest of the tile's math.  That keeps two
// blocks an SM.  Each tile is two register-blocked stages:
//   1. s and dp, [ROWS x TILE] over the head dim (q.k^T and do.v^T for
//      dq, k.q^T and v.do^T for dk/dv): each thread owns a 4 x TN1
//      micro-tile and per 4 head dims loads its 4 + TN1 operand rows as
//      float4 (LDS.128) for 16 TN1 FMAs; p and
//      ds are formed in registers (the mask only on diagonal and ragged
//      tiles) and written transposed ([TILE][ROWS + 8]) to shared memory
//      (dk/dv: p first, ds once dv's product has read p);
//   2. the [ROWS x DM] accumulators (dq += ds.k; dv += p^T.do, dk +=
//      ds^T.q): each thread owns a 4 x TN2 micro-tile and per tile row loads
//      one float4 of ds (or p) and TN2/4 of the tile's row for 4 TN2 FMAs.
// Operand rows are padded to DM + 4 floats, so the eight rows a quarter-warp
// reads at one head-dim offset fall in eight different bank groups; the
// transposed p/ds rows to ROWS + 8, so a warp's 4 x 8 scalar stores hit 32
// banks.  Thread (gr, gc) of the ROWS/4 x THREADS/(ROWS/4) grid owns rows
// gr + (ROWS/4) i in stage 1 and 4 gr + i in stage 2; each warp covers 8
// rows x 4 columns of the grid.  Every block writes only its own rows.
namespace rb {

template <int DM, int ROWS, int TILE, int THREADS>
struct Geometry {
  static constexpr int kLd = DM + 4;     // floats of a padded [rows][DM] row
  static constexpr int kLdT = ROWS + 8;  // floats of a transposed [TILE][ROWS] row
  static constexpr int kGR = ROWS / 4, kGC = THREADS / kGR;  // the thread grid
  static constexpr int kTN1 = TILE / kGC;  // stage-1 micro-tile columns
  static constexpr int kTN2 = DM / kGC;    // stage-2 micro-tile columns
  static constexpr int kOwnFloats = 2 * ROWS * kLd;  // the block's own two operands
  // dq: a two-stage ring of k tiles, one v tile (read by stage 1 only), ds
  static constexpr int kDqBytes = 4 * (kOwnFloats + 3 * TILE * kLd + TILE * kLdT);
  // dk/dv: a two-stage ring of q tiles, one do tile (refilled once dv's
  // product has read it), one p/ds tile, and two stages of lse and delta
  static constexpr int kDkvBytes = 4 * (kOwnFloats + 3 * TILE * kLd + TILE * kLdT + 4 * TILE);
  static_assert(kGR % 8 == 0 && kGC % 4 == 0 && kGR * kGC == THREADS, "thread grid");
  static_assert(kTN1 >= 4 && kTN1 * kGC == TILE, "stage-1 micro-tile");
  static_assert(kTN2 >= 4 && kTN2 % 4 == 0 && kTN2 * kGC == DM, "stage-2 micro-tile");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// This thread's cell (gr, gc) of the GR x (THREADS / GR) grid: a warp covers
// 8 consecutive gr and 4 consecutive gc.
template <int GR>
__device__ __forceinline__ void thread_cell(int& gr, int& gc) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  gr = lane % 8 + 8 * (warp % (GR / 8));
  gc = lane / 8 + 4 * (warp / (GR / 8));
}

// Queues the copy of rows [row0, row0 + R) of a [seq, dim] matrix into a
// padded [R][DM + 4] tile; rows past seq and columns past dim land as zeros.
template <int R, int DM, int THREADS>
__device__ __forceinline__ void load_rows(float* tile, const float* src, int row0, int seq,
                                          int dim) {
  constexpr int kPerRow = DM / 4, kChunkCount = R * kPerRow;
#pragma unroll
  for (int n = 0; n < (kChunkCount + THREADS - 1) / THREADS; ++n) {
    const int idx = threadIdx.x + n * THREADS;
    if (kChunkCount % THREADS == 0 || idx < kChunkCount) {
      const int r = idx / kPerRow, c = 4 * (idx % kPerRow), g = row0 + r;
      const bool valid = g < seq && c < dim;
      cp_async16(tile + r * (DM + 4) + c, valid ? src + (size_t)g * dim + c : src, valid);
    }
  }
}

// Queues the copy of entries [row0, row0 + R) of a [seq] row statistic.
template <int R, int THREADS>
__device__ __forceinline__ void load_stats(float* dst, const float* src, int row0, int seq) {
  for (int i = threadIdx.x; i < R; i += THREADS) {
    const int g = row0 + i;
    cp_async4(dst + i, g < seq ? src + g : src, g < seq);
  }
}

// acc[i][j] += a[gr + GR i] . b[gc + GC j] over the DM head dims of two
// padded [.][DM + 4] tiles (stage 1).
template <int DM, int GR, int GC, int TN>
__device__ __forceinline__ void nt_product(float (&acc)[4][TN], const float* a, const float* b,
                                           int gr, int gc) {
  constexpr int kLd = DM + 4;
  const float* ar = a + gr * kLd;
  const float* br = b + gc * kLd;
#pragma unroll 4
  for (int d = 0; d < DM; d += 4) {
    float4 x[4], y[TN];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = load4(ar + i * GR * kLd + d);
#pragma unroll
    for (int j = 0; j < TN; ++j) y[j] = load4(br + j * GC * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][4c + e] += sum over the R tile rows r of t[r][4 gr + i] *
// y[r][4 gc + 4 GC c + e], t a transposed [R][LDT] tile and y a padded
// [R][DM + 4] one (stage 2).
template <int DM, int LDT, int R, int GC, int TN>
__device__ __forceinline__ void tn_product(float (&acc)[4][TN], const float* t, const float* y,
                                           int gr, int gc) {
  constexpr int kLd = DM + 4;
  const float* tr = t + 4 * gr;
  const float* yr = y + 4 * gc;
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const float4 x4 = load4(tr + r * LDT);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const float4 z = load4(yr + r * kLd + 4 * GC * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * c + 0] = fmaf(x[i], z.x, acc[i][4 * c + 0]);
        acc[i][4 * c + 1] = fmaf(x[i], z.y, acc[i][4 * c + 1]);
        acc[i][4 * c + 2] = fmaf(x[i], z.z, acc[i][4 * c + 2]);
        acc[i][4 * c + 3] = fmaf(x[i], z.w, acc[i][4 * c + 3]);
      }
    }
  }
}

// Writes a stage-2 micro-tile: rows row0 + 4 gr + i (those below seq),
// columns 4 gc + 4 GC c .. + 3 (those below dim).
template <int GC, int TN>
__device__ __forceinline__ void store_tile(float* dst, const float (&acc)[4][TN], int row0,
                                           int gr, int gc, int seq, int dim) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * gr + i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const int col = 4 * gc + 4 * GC * c;
      if (col < dim)
        store4(dst + (size_t)row * dim + col,
               make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]));
    }
  }
}

template <int DM, int ROWS, int TILE, int THREADS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int bh_count, int seq, int dim, float scale,
                int causal) {
  using G = Geometry<DM, ROWS, TILE, THREADS>;
  constexpr int kLd = G::kLd, kLdT = G::kLdT, kGR = G::kGR, kGC = G::kGC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [ROWS][kLd]: this block's queries
  float* dos = qs + ROWS * kLd;        // [ROWS][kLd]
  float* ring = dos + ROWS * kLd;      // [2 stages][TILE][kLd]: k tiles
  float* vs = ring + 2 * TILE * kLd;   // [TILE][kLd]: the v tile, refilled during stage 2
  float* dst = vs + TILE * kLd;        // [TILE][kLdT]: ds, transposed

  const int n_tiles = (seq + ROWS - 1) / ROWS;
  const int tile = n_tiles - 1 - blockIdx.x / bh_count;  // longest rows first
  const int bh = blockIdx.x % bh_count;
  const int q0 = tile * ROWS;
  const size_t base = (size_t)bh * seq * dim;
  int gr, gc;
  thread_cell<kGR>(gr, gc);

  const int k_end = causal ? min(q0 + ROWS, seq) : seq;  // keys past it are all masked
  const int n = (k_end + TILE - 1) / TILE;
  load_rows<ROWS, DM, THREADS>(qs, q + base, q0, seq, dim);
  load_rows<ROWS, DM, THREADS>(dos, dout + base, q0, seq, dim);
  load_rows<TILE, DM, THREADS>(ring, k + base, 0, seq, dim);
  load_rows<TILE, DM, THREADS>(vs, v + base, 0, seq, dim);
  cp_async_commit();

  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + gr + kGR * i;
    lse_r[i] = row < seq ? lse[(size_t)bh * seq + row] : 0.f;
    delta_r[i] = row < seq ? delta[(size_t)bh * seq + row] : 0.f;
  }
  float acc[4][G::kTN2] = {};

  for (int it = 0; it < n; ++it) {
    const int k0 = it * TILE;
    const float* ks = ring + (it & 1) * TILE * kLd;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; tile it - 1 and its ds are consumed
    if (it + 1 < n) {
      load_rows<TILE, DM, THREADS>(ring + ((it + 1) & 1) * TILE * kLd, k + base, k0 + TILE, seq,
                                   dim);
      cp_async_commit();
    }
    float s[4][G::kTN1] = {}, dp[4][G::kTN1] = {};
    nt_product<DM, kGR, kGC, G::kTN1>(s, qs, ks, gr, gc);
    nt_product<DM, kGR, kGC, G::kTN1>(dp, dos, vs, gr, gc);
    const bool edge = (causal && k0 + TILE - 1 > q0) || k0 + TILE > seq;
#pragma unroll
    for (int j = 0; j < G::kTN1; ++j) {
      const int c = gc + kGC * j, key = k0 + c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gr + kGR * i;
        float p = expf(s[i][j] * scale - lse_r[i]);
        if (edge && (key >= seq || (causal && key > q0 + r))) p = 0.f;
        dst[c * kLdT + r] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();  // ds is whole; the v tile is consumed
    if (it + 1 < n) {
      load_rows<TILE, DM, THREADS>(vs, v + base, k0 + TILE, seq, dim);
      cp_async_commit();
    }
    tn_product<DM, kLdT, TILE, kGC, G::kTN2>(acc, dst, ks, gr, gc);
  }
  store_tile<kGC, G::kTN2>(dq + base, acc, q0, gr, gc, seq, dim);
}

template <int DM, int ROWS, int TILE, int THREADS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int bh_count, int seq,
                 int dim, float scale, int causal) {
  using G = Geometry<DM, ROWS, TILE, THREADS>;
  constexpr int kLd = G::kLd, kLdT = G::kLdT, kGR = G::kGR, kGC = G::kGC, kTN1 = G::kTN1;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [ROWS][kLd]: this block's keys
  float* vs = ks + ROWS * kLd;         // [ROWS][kLd]
  float* ring = vs + ROWS * kLd;       // [2 stages][TILE][kLd]: q tiles
  float* dos = ring + 2 * TILE * kLd;  // [TILE][kLd]: the do tile, refilled during dk's product
  float* pt = dos + TILE * kLd;        // [TILE][kLdT]: p, then ds, transposed
  float* stats = pt + TILE * kLdT;     // [2 stages][lse, delta][TILE]

  const int tile = blockIdx.x / bh_count;  // the first key tiles see the most queries
  const int bh = blockIdx.x % bh_count;
  const int k0 = tile * ROWS;
  const size_t base = (size_t)bh * seq * dim;
  const float* lse_bh = lse + (size_t)bh * seq;
  const float* delta_bh = delta + (size_t)bh * seq;
  int gr, gc;
  thread_cell<kGR>(gr, gc);

  const int q_begin = causal ? k0 : 0;  // no earlier query reaches these keys
  const int n = (seq - q_begin + TILE - 1) / TILE;
  load_rows<ROWS, DM, THREADS>(ks, k + base, k0, seq, dim);
  load_rows<ROWS, DM, THREADS>(vs, v + base, k0, seq, dim);
  load_rows<TILE, DM, THREADS>(ring, q + base, q_begin, seq, dim);
  load_rows<TILE, DM, THREADS>(dos, dout + base, q_begin, seq, dim);
  load_stats<TILE, THREADS>(stats, lse_bh, q_begin, seq);
  load_stats<TILE, THREADS>(stats + TILE, delta_bh, q_begin, seq);
  cp_async_commit();

  float dk_acc[4][G::kTN2] = {}, dv_acc[4][G::kTN2] = {};
  for (int it = 0; it < n; ++it) {
    const int q0 = q_begin + it * TILE;
    const float* qs = ring + (it & 1) * TILE * kLd;
    const float* lse_s = stats + (it & 1) * 2 * TILE;
    const float* delta_s = lse_s + TILE;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; tile it - 1 and its ds are consumed
    if (it + 1 < n) {
      float* next_stats = stats + ((it + 1) & 1) * 2 * TILE;
      load_rows<TILE, DM, THREADS>(ring + ((it + 1) & 1) * TILE * kLd, q + base, q0 + TILE, seq,
                                   dim);
      load_stats<TILE, THREADS>(next_stats, lse_bh, q0 + TILE, seq);
      load_stats<TILE, THREADS>(next_stats + TILE, delta_bh, q0 + TILE, seq);
      cp_async_commit();
    }
    float s[4][kTN1] = {}, dp[4][kTN1] = {};
    nt_product<DM, kGR, kGC, kTN1>(s, ks, qs, gr, gc);
    nt_product<DM, kGR, kGC, kTN1>(dp, vs, dos, gr, gc);
    // p goes to shared memory now; ds waits in dp until dv's product has read p
    const bool edge = (causal && k0 + ROWS - 1 > q0) || q0 + TILE > seq || k0 + ROWS > seq;
#pragma unroll
    for (int j = 0; j < kTN1; ++j) {
      const int c = gc + kGC * j, qi = q0 + c;
      const float l = lse_s[c], de = delta_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gr + kGR * i, key = k0 + r;
        float p = expf(s[i][j] * scale - l);
        if (edge && (qi >= seq || key >= seq || (causal && key > qi))) p = 0.f;
        dp[i][j] = p * (dp[i][j] - de) * scale;
        pt[c * kLdT + r] = p;
      }
    }
    __syncthreads();  // p is whole
    tn_product<DM, kLdT, TILE, kGC, G::kTN2>(dv_acc, pt, dos, gr, gc);
    __syncthreads();  // p and the do tile are consumed
    if (it + 1 < n) {
      load_rows<TILE, DM, THREADS>(dos, dout + base, q0 + TILE, seq, dim);
      cp_async_commit();
    }
#pragma unroll
    for (int j = 0; j < kTN1; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pt[(gc + kGC * j) * kLdT + gr + kGR * i] = dp[i][j];
    }
    __syncthreads();  // ds is whole
    tn_product<DM, kLdT, TILE, kGC, G::kTN2>(dk_acc, pt, qs, gr, gc);
  }
  store_tile<kGC, G::kTN2>(dk + base, dk_acc, k0, gr, gc, seq, dim);
  store_tile<kGC, G::kTN2>(dv + base, dv_acc, k0, gr, gc, seq, dim);
}

}  // namespace rb

// --------------------------------------------------------------------------
// bfloat16 on Hopper: TMA-fed stages, wgmma (float32 accumulate)
// --------------------------------------------------------------------------
//
// A block is one producer warp and NWG consumer warpgroups of 64 output rows
// each.  The producer loads the block's own rows once and then streams the
// other operand's tiles with TMA (cp.async.bulk.tensor) into a ring of ST
// shared-memory stages; each stage has a `full` mbarrier (the copy's bytes,
// and in dk/dv the lse/delta stores of the producer's 32 lanes) and an
// `empty` one (one arrival from each consumer warp).  The consumers run
// every product with wgmma straight from those tiles while the next tiles
// land.
//
// Tiles are [rows][64 columns] boxes, 128 bytes a row with TMA's 128-byte
// swizzle (a head dim over 64 is two boxes), which is the layout wgmma reads
// both ways: K-major when the product's depth is the head dim (q.k^T,
// do.v^T, k.q^T, v.do^T) and MN-major, through the descriptor's transpose
// bit, when the depth runs down the rows (p.v, ds.k, p^T.do, ds^T.q).  So no
// tile is ever transposed in shared memory.  p and ds come from the score
// accumulators as register A operands.  The tensor maps cover [BH, T, D]
// with T and D as their bounds: TMA fills rows past T and columns past D
// with zeros, which the masks then ignore.
//
// Exactness: q, k, v and do are bf16 already, so their products are exact.
// p and ds are float32 and the TPU kernels multiply them in float32; here
// each is split into a bf16 head and a bf16 remainder (x = hi + lo to about
// 2^-16 relative) and both halves go through the tensor cores, so the
// result keeps float32-level accuracy against the plain version.
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBoxCols = 64;       // head-dim columns of one box: 128 bytes a row
constexpr int kTileRows = 64;      // rows of a streamed tile: keys (fwd), queries (dk/dv)
constexpr int kRowBytes = 128;
constexpr int kGroupBytes = 8 * kRowBytes;  // one 8-row swizzle group
constexpr uint64_t kWaitLimitNs = 4000000000ull;  // a stuck pipeline traps
// p = exp2(s log2e - m log2e): ex2 with one multiply folded in, where expf
// would cost a range reduction per score
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as bf16 pairs: the rounded head and the remainder.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - f.x, b - f.y));
}

// The max and the sum over the four lanes (one quad) that share a row of a
// wgmma accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the barrier's phase of this parity to complete; traps (the launch
// fails) after kWaitLimitNs, so a broken pipeline raises instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(a, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

// One box of a [BH, T, D] tensor map: columns [col, col + 64) of rows
// [row, row + box rows) of head `bh`, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile: 8-row groups of 128-byte
// rows, kGroupBytes apart (the stride offset).  K-major (the depth along the
// rows) leaves the leading offset unused; MN-major (the depth down the rows)
// reads one 64-column swizzle atom across N, so its leading offset is unused
// too and is set to the group stride as well.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lead_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead_bytes >> 4) << 16 |
         static_cast<uint64_t>(kGroupBytes >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ uint64_t desc_k(const void* p) { return make_desc(p, 16); }
__device__ __forceinline__ uint64_t desc_mn(const void* p) { return make_desc(p, kGroupBytes); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins registers that an in-flight wgmma reads or writes in place: the
// compiler may not move their uses across this point.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[32] (+)= A . B^T over k = 16: A [64 x 16] and B [64 x 16] both K-major in
// shared memory (descriptors); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A . B over k = 16: A [64 x 16] from registers (the mma.sync A
// fragment of each warp's 16 rows), B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The A fragment (16 x 16, head and remainder) of accumulator columns
// [16 kk, 16 kk + 16): c points at element 8 kk of the accumulator.
__device__ __forceinline__ void split_frag(const float* c, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(c[0], c[1], hi[0], lo[0]);
  split(c[2], c[3], hi[1], lo[1]);
  split(c[4], c[5], hi[2], lo[2]);
  split(c[6], c[7], hi[3], lo[3]);
}

// Stores a warp's rows (row0, row0 + 8) of a [64 x 64 KB] accumulator (one
// 32-float wgmma accumulator per 64-column box) times (mul0, mul1).
template <int KB>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[KB][32], float mul0,
                                           float mul1, int row0, int seq, int dim, int t) {
#pragma unroll
  for (int h = 0; h < KB; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h * kBoxCols + 8 * j + 2 * t;
      if (col >= dim) continue;
      if (row0 < seq)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row0 * dim + col) =
            __floats2bfloat162_rn(acc[h][4 * j] * mul0, acc[h][4 * j + 1] * mul0);
      if (row0 + 8 < seq)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row0 + 8) * dim + col) =
            __floats2bfloat162_rn(acc[h][4 * j + 2] * mul1, acc[h][4 * j + 3] * mul1);
    }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Shared memory of the forward kernel: the block's q rows, then ST stages of
// (k tile, v tile), then the barriers.
template <int DP, int NWG, int ST>
struct FwdLayout {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kRows = 64 * NWG;  // query rows of a block
  static constexpr int kQBytes = kRows * kRowBytes * kBoxes;
  static constexpr int kTileBytes = kTileRows * kRowBytes * kBoxes;  // one k or v tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + ST * kStageBytes;
  static constexpr int kBytes = kBarOffset + (2 * ST + 1) * 8 + 1024;  // + alignment
};

// K2: o and lse of 64 NWG query rows, streaming 64-key tiles of k and v.
template <int DP, int NWG, int ST, int MINB>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                float* __restrict__ lse, int bh_count, int seq, int dim, float scale,
                int causal) {
  using L = FwdLayout<DP, NWG, ST>;
  constexpr int KB = L::kBoxes, BQ = L::kRows, BK = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* stages = smem + L::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + ST;
  uint64_t* q_ready = empty + ST;

  const int n_qt = (seq + BQ - 1) / BQ;
  const int tile = n_qt - 1 - blockIdx.x / bh_count;  // longest rows first
  const int bh = blockIdx.x % bh_count;
  const int q0 = tile * BQ;
  const int n_kt = ((causal ? min(q0 + BQ, seq) : seq) + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_init(q_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_ready, L::kQBytes);
      for (int b = 0; b < KB; ++b)
        tma_load(qs + b * BQ * kRowBytes, &map_q, q_ready, b * kBoxCols, q0, bh);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        uint8_t* kt = stages + s * L::kStageBytes;
        uint8_t* vt = kt + L::kTileBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        for (int b = 0; b < KB; ++b) {
          tma_load(kt + b * BK * kRowBytes, &map_k, &full[s], b * kBoxCols, i * BK, bh);
          tma_load(vt + b * BK * kRowBytes, &map_v, &full[s], b * kBoxCols, i * BK, bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows, 16 per warp
  const int w = warp / 4, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + w * 64;
  const int rb = r0 + (warp % 4) * 16;
  const int row[2] = {rb + g, rb + g + 8};
  // keys this warpgroup reads: under causal none past its last row
  const int k_need = r0 >= seq ? 0 : causal ? min(r0 + 64, seq) : seq;
  const uint8_t* qw = qs + w * 64 * kRowBytes;

  float acc[KB][32];
#pragma unroll
  for (int h = 0; h < KB; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units; l: this lane's part
  const float scale_log2 = scale * kLog2e;
  // the last key each of the lane's rows reads; later ones are masked
  const int last_key[2] = {causal ? min(row[0], seq - 1) : seq - 1,
                           causal ? min(row[1], seq - 1) : seq - 1};

  mbar_wait(q_ready, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % ST, k0 = i * BK;
    mbar_wait(&full[s], (i / ST) & 1);
    if (k0 < k_need) {
      const uint8_t* kt = stages + s * L::kStageBytes;
      const uint8_t* vt = kt + L::kTileBytes;

      // s = q k^T over the head dim, 16 columns a step
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int b = kk / 4, c = 32 * (kk % 4);
        wgmma_ss64(sc, desc_k(qw + b * BQ * kRowBytes + c),
                     desc_k(kt + b * BK * kRowBytes + c), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(sc);

      // scores in log2 units (exp2 of them is p)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (k0 + 8 * j + 2 * t + (e & 1) > last_key[e >> 1]) x = kNegInf;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = exp2f(sc[j] - m[(j >> 1) & 1]);
        l[(j >> 1) & 1] += sc[j];
      }
#pragma unroll
      for (int h = 0; h < KB; ++h)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[h][j] *= alpha[(j >> 1) & 1];

      // o += p v over the tile's keys, 16 a step; v is read MN-major
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) split_frag(&sc[8 * kk], hi[kk], lo[kk]);
#pragma unroll
      for (int h = 0; h < KB; ++h) keep(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < KB; ++h) {
          const uint64_t db = desc_mn(vt + h * BK * kRowBytes + kk * 2 * kGroupBytes);
          wgmma_rs64(acc[h], hi[kk], db);
          wgmma_rs64(acc[h], lo[kk], db);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < KB; ++h) keep(acc[h]);
      keep(hi);
      keep(lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  if (r0 >= seq) return;
  store_rows<KB>(o + (size_t)bh * seq * dim, acc, 1.f / l0, 1.f / l1, row[0], seq, dim, t);
  if (t == 0) {
    if (row[0] < seq) lse[(size_t)bh * seq + row[0]] = m[0] * kLn2 + logf(l0);
    if (row[1] < seq) lse[(size_t)bh * seq + row[1]] = m[1] * kLn2 + logf(l1);
  }
}

// Shared memory of the dk/dv kernel: the block's k and v rows, ST stages of
// (q tile, do tile), ST stages of (lse log2e, delta), then the barriers.
template <int DP, int NWG, int ST>
struct DkvLayout {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kRows = 64 * NWG;  // key rows of a block
  static constexpr int kKVBytes = kRows * kRowBytes * kBoxes;  // k or v
  static constexpr int kTileBytes = kTileRows * kRowBytes * kBoxes;  // one q or do tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStatOffset = 2 * kKVBytes + ST * kStageBytes;
  static constexpr int kBarOffset = kStatOffset + ST * 2 * kTileRows * 4;
  static constexpr int kBytes = kBarOffset + (2 * ST + 1) * 8 + 1024;  // + alignment
};

// K4: dk and dv of 64 NWG key rows, streaming 64-query tiles of q and do
// with their lse and delta.
template <int DP, int NWG, int ST, int MINB>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int bh_count, int seq, int dim, float scale,
                int causal) {
  using L = DkvLayout<DP, NWG, ST>;
  constexpr int KB = L::kBoxes, BKEY = L::kRows, BQ = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ks = smem;
  uint8_t* vs = smem + L::kKVBytes;
  uint8_t* stages = smem + 2 * L::kKVBytes;
  float* stats = reinterpret_cast<float*>(smem + L::kStatOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + ST;
  uint64_t* kv_ready = empty + ST;

  const int tile = blockIdx.x / bh_count;  // first key tiles see most queries
  const int bh = blockIdx.x % bh_count;
  const int key0 = tile * BKEY;
  // under `causal` no query before this block's first key reaches it
  const int q_begin = causal ? key0 : 0;
  const int n_qt = (seq - q_begin + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes; lane 0 brings the bytes
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_init(kv_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(kv_ready, 2 * L::kKVBytes);
      for (int b = 0; b < KB; ++b) {
        tma_load(ks + b * BKEY * kRowBytes, &map_k, kv_ready, b * kBoxCols, key0, bh);
        tma_load(vs + b * BKEY * kRowBytes, &map_v, kv_ready, b * kBoxCols, key0, bh);
      }
    }
    const size_t row_base = (size_t)bh * seq;
    for (int i = 0; i < n_qt; ++i) {
      const int s = i % ST, q0 = q_begin + i * BQ;
      mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      float* st = stats + s * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const int g = q0 + r;
        st[r] = g < seq ? lse[row_base + g] * kLog2e : 0.f;
        st[BQ + r] = g < seq ? delta[row_base + g] : 0.f;
      }
      if (lane == 0) {
        uint8_t* qt = stages + s * L::kStageBytes;
        uint8_t* dt = qt + L::kTileBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        for (int b = 0; b < KB; ++b) {
          tma_load(qt + b * BQ * kRowBytes, &map_q, &full[s], b * kBoxCols, q0, bh);
          tma_load(dt + b * BQ * kRowBytes, &map_do, &full[s], b * kBoxCols, q0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 key rows, 16 per warp
  const int w = warp / 4, g = lane >> 2, t = lane & 3;
  const int kw0 = key0 + w * 64;
  const int kb = kw0 + (warp % 4) * 16;
  const int key[2] = {kb + g, kb + g + 8};
  const uint8_t* kw = ks + w * 64 * kRowBytes;
  const uint8_t* vw = vs + w * 64 * kRowBytes;

  float dka[KB][32], dva[KB][32];
#pragma unroll
  for (int h = 0; h < KB; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[h][i] = dva[h][i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  // the queries each of the lane's keys meets: [first_q, first_q + q_span]
  // (for a key past seq the span wraps and nothing is masked: its row is
  // never stored)
  const int first_q[2] = {causal ? key[0] : 0, causal ? key[1] : 0};
  const unsigned q_span[2] = {static_cast<unsigned>(seq - 1 - first_q[0]),
                              static_cast<unsigned>(seq - 1 - first_q[1])};

  mbar_wait(kv_ready, 0);
  for (int i = 0; i < n_qt; ++i) {
    const int s = i % ST, q0 = q_begin + i * BQ;
    mbar_wait(&full[s], (i / ST) & 1);
    // skipped: a warpgroup past seq, and a tile wholly above its keys
    if (kw0 < seq && !(causal && q0 + BQ <= kw0)) {
      const uint8_t* qt = stages + s * L::kStageBytes;
      const uint8_t* dt = qt + L::kTileBytes;
      const float* lse_s = stats + s * 2 * BQ;  // lse in log2 units
      const float* delta_s = lse_s + BQ;

      // transposed scores and dp: rows are this warpgroup's keys, columns the
      // tile's queries; both products run over the head dim
      float st[BQ / 2], dp[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = dp[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {  // the two chains interleaved
        const int b = kk / 4, c = 32 * (kk % 4);
        wgmma_ss64(st, desc_k(kw + b * BKEY * kRowBytes + c),
                     desc_k(qt + b * BQ * kRowBytes + c), kk > 0);
        wgmma_ss64(dp, desc_k(vw + b * BKEY * kRowBytes + c),
                     desc_k(dt + b * BQ * kRowBytes + c), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(st);
      keep(dp);

      // p = exp2(s scale log2e - lse log2e)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          float p = exp2f(fmaf(st[4 * j + e], scale_log2, -lse_s[qi]));
          if (static_cast<unsigned>(q0 + qi - first_q[e >> 1]) > q_span[e >> 1]) p = 0.f;
          st[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - delta_s[qi]) * scale;  // ds
        }

      // dv += p^T do and dk += ds^T q over the tile's queries, the two chains
      // interleaved; do and q are read MN-major
      uint32_t phi[BQ / 16][4], plo[BQ / 16][4], dhi[BQ / 16][4], dlo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        split_frag(&st[8 * kk], phi[kk], plo[kk]);
        split_frag(&dp[8 * kk], dhi[kk], dlo[kk]);
      }
#pragma unroll
      for (int h = 0; h < KB; ++h) {
        keep(dva[h]);
        keep(dka[h]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int h = 0; h < KB; ++h) {
          const int off = h * BQ * kRowBytes + kk * 2 * kGroupBytes;
          wgmma_rs64(dva[h], phi[kk], desc_mn(dt + off));
          wgmma_rs64(dka[h], dhi[kk], desc_mn(qt + off));
          wgmma_rs64(dva[h], plo[kk], desc_mn(dt + off));
          wgmma_rs64(dka[h], dlo[kk], desc_mn(qt + off));
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < KB; ++h) {
        keep(dva[h]);
        keep(dka[h]);
      }
      keep(phi);
      keep(plo);
      keep(dhi);
      keep(dlo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (kw0 >= seq) return;
  const size_t base = (size_t)bh * seq * dim;
  store_rows<KB>(dk + base, dka, 1.f, 1.f, key[0], seq, dim, t);
  store_rows<KB>(dv + base, dva, 1.f, 1.f, key[0], seq, dim, t);
}

// Shared memory of the dq kernel: the block's q rows and do rows, then ST
// stages of (k tile, v tile), then the barriers.
template <int DP, int NWG, int ST>
struct DqLayout {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kRows = 64 * NWG;  // query rows of a block
  static constexpr int kQBytes = kRows * kRowBytes * kBoxes;  // q or do
  static constexpr int kTileBytes = kTileRows * kRowBytes * kBoxes;  // one k or v tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = 2 * kQBytes + ST * kStageBytes;
  static constexpr int kBytes = kBarOffset + (2 * ST + 1) * 8 + 1024;  // + alignment
};

// K3: dq of 64 NWG query rows, streaming 64-key tiles of k and v.  The
// forward's pipeline with dk/dv's products: s = q k^T and dp = do v^T over
// the head dim, ds from them, and dq += ds k with the same k tile read
// MN-major.
template <int DP, int NWG, int ST, int MINB>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
flash_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dq, int bh_count, int seq,
               int dim, float scale, int causal) {
  using L = DqLayout<DP, NWG, ST>;
  constexpr int KB = L::kBoxes, BQ = L::kRows, BK = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* dos = smem + L::kQBytes;
  uint8_t* stages = smem + 2 * L::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + ST;
  uint64_t* rows_ready = empty + ST;

  const int n_qt = (seq + BQ - 1) / BQ;
  const int tile = n_qt - 1 - blockIdx.x / bh_count;  // longest rows first
  const int bh = blockIdx.x % bh_count;
  const int q0 = tile * BQ;
  const int n_kt = ((causal ? min(q0 + BQ, seq) : seq) + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_init(rows_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(rows_ready, 2 * L::kQBytes);
      for (int b = 0; b < KB; ++b) {
        tma_load(qs + b * BQ * kRowBytes, &map_q, rows_ready, b * kBoxCols, q0, bh);
        tma_load(dos + b * BQ * kRowBytes, &map_do, rows_ready, b * kBoxCols, q0, bh);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        uint8_t* kt = stages + s * L::kStageBytes;
        uint8_t* vt = kt + L::kTileBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        for (int b = 0; b < KB; ++b) {
          tma_load(kt + b * BK * kRowBytes, &map_k, &full[s], b * kBoxCols, i * BK, bh);
          tma_load(vt + b * BK * kRowBytes, &map_v, &full[s], b * kBoxCols, i * BK, bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows, 16 per warp
  const int w = warp / 4, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + w * 64;
  const int rb = r0 + (warp % 4) * 16;
  const int row[2] = {rb + g, rb + g + 8};
  // keys this warpgroup reads: under causal none past its last row
  const int k_need = r0 >= seq ? 0 : causal ? min(r0 + 64, seq) : seq;
  const uint8_t* qw = qs + w * 64 * kRowBytes;
  const uint8_t* dw = dos + w * 64 * kRowBytes;

  float acc[KB][32];
#pragma unroll
  for (int h = 0; h < KB; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  // the constants of the lane's two rows: lse in log2 units, delta, and the
  // last key each reads (later ones are masked)
  float lse_r[2], delta_r[2];
  int last_key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < seq;
    lse_r[r] = in ? lse[(size_t)bh * seq + row[r]] * kLog2e : 0.f;
    delta_r[r] = in ? delta[(size_t)bh * seq + row[r]] : 0.f;
    last_key[r] = causal ? min(row[r], seq - 1) : seq - 1;
  }

  mbar_wait(rows_ready, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % ST, k0 = i * BK;
    mbar_wait(&full[s], (i / ST) & 1);
    if (k0 < k_need) {
      const uint8_t* kt = stages + s * L::kStageBytes;
      const uint8_t* vt = kt + L::kTileBytes;

      // s = q k^T and dp = do v^T over the head dim, the two chains
      // interleaved
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int b = kk / 4, c = 32 * (kk % 4);
        wgmma_ss64(sc, desc_k(qw + b * BQ * kRowBytes + c),
                     desc_k(kt + b * BK * kRowBytes + c), kk > 0);
        wgmma_ss64(dp, desc_k(dw + b * BQ * kRowBytes + c),
                     desc_k(vt + b * BK * kRowBytes + c), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(sc);
      keep(dp);

      // p = exp2(s scale log2e - lse log2e), ds = p (dp - delta) scale
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -lse_r[e >> 1]));
          if (k0 + 8 * j + 2 * t + (e & 1) > last_key[e >> 1]) p = 0.f;
          sc[4 * j + e] = p * (dp[4 * j + e] - delta_r[e >> 1]) * scale;
        }

      // dq += ds k over the tile's keys, 16 a step; k is read MN-major
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) split_frag(&sc[8 * kk], hi[kk], lo[kk]);
#pragma unroll
      for (int h = 0; h < KB; ++h) keep(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < KB; ++h) {
          const uint64_t db = desc_mn(kt + h * BK * kRowBytes + kk * 2 * kGroupBytes);
          wgmma_rs64(acc[h], hi[kk], db);
          wgmma_rs64(acc[h], lo[kk], db);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < KB; ++h) keep(acc[h]);
      keep(hi);
      keep(lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (r0 >= seq) return;
  store_rows<KB>(dq + (size_t)bh * seq * dim, acc, 1.f, 1.f, row[0], seq, dim, t);
}

}  // namespace wg

// Padded head width: the smallest supported DM >= dim, or 0.
int padded_dim(int dim) {
  if (dim <= 32) return 32;
  if (dim <= 64) return 64;
  if (dim <= 128) return 128;
  return 0;
}

int row_blocks(int bh, int seq) { return bh * ((seq + kRows - 1) / kRows); }

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so the library links no libcuda; null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a [bh, seq, dim] bfloat16 tensor read in boxes of `rows` x
// 64 columns with the 128-byte swizzle.  Rows past seq and columns past dim
// read as zeros.  Needs a 16-byte aligned base and a row pitch (dim x 2
// bytes) that is a multiple of 16, which the Python wrapper checks.
cudaError_t make_map(CUtensorMap* map, const void* base, int bh, int seq, int dim, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t extent[3] = {(cuuint64_t)dim, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t pitch[2] = {(cuuint64_t)dim * 2, (cuuint64_t)seq * dim * 2};
  const cuuint32_t box[3] = {wg::kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            extent, pitch, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch shapes of the wgmma kernels at a padded head dim DP (64 or 128):
// consumer warpgroups of 64 rows, pipeline stages, and the blocks an SM
// holds (the register budget ptxas gets).  dk/dv keeps dk and dv
// accumulators per row: at DP = 64 two one-warpgroup blocks an SM measured
// faster than one block of two; at DP = 128 two warpgroups share a block.
// dq keeps one accumulator but holds scores and dp at once: at DP = 64 three
// one-warpgroup blocks an SM (128 registers) measured faster than one block
// of two warpgroups, or two of one (more warpgroups hide the product
// chains better than 128-row blocks save k and v reads from L2); two blocks
// of two must fit 96 registers and spill.
template <int DP>
struct FwdConfig {
  static constexpr int kWG = 2, kST = 2, kMinBlocks = DP == 64 ? 2 : 1;
};
template <int DP>
struct DkvConfig {
  static constexpr int kWG = DP == 64 ? 1 : 2, kST = 2, kMinBlocks = DP == 64 ? 2 : 1;
};
template <int DP>
struct DqConfig {
  static constexpr int kWG = DP == 64 ? 1 : 2, kST = 2, kMinBlocks = DP == 64 ? 3 : 1;
};

template <int DP>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int seq, int dim, float scale, int causal,
                             cudaStream_t stream) {
  using C = FwdConfig<DP>;
  using L = wg::FwdLayout<DP, C::kWG, C::kST>;
  const auto kernel = wg::flash_fwd_wgmma<DP, C::kWG, C::kST, C::kMinBlocks>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, bh, seq, dim, L::kRows);
  if (err == cudaSuccess) err = make_map(&mk, k, bh, seq, dim, wg::kTileRows);
  if (err == cudaSuccess) err = make_map(&mv, v, bh, seq, dim, wg::kTileRows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((seq + L::kRows - 1) / L::kRows);
  kernel<<<blocks, C::kWG * 128 + 32, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<wg::bf16*>(o), static_cast<float*>(lse), bh, seq, dim, scale,
      causal);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int seq,
                            int dim, float scale, int causal, cudaStream_t stream) {
  using C = DqConfig<DP>;
  using L = wg::DqLayout<DP, C::kWG, C::kST>;
  const auto kernel = wg::flash_dq_wgmma<DP, C::kWG, C::kST, C::kMinBlocks>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = make_map(&mq, q, bh, seq, dim, L::kRows);
  if (err == cudaSuccess) err = make_map(&mdo, dout, bh, seq, dim, L::kRows);
  if (err == cudaSuccess) err = make_map(&mk, k, bh, seq, dim, wg::kTileRows);
  if (err == cudaSuccess) err = make_map(&mv, v, bh, seq, dim, wg::kTileRows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((seq + L::kRows - 1) / L::kRows);
  kernel<<<blocks, C::kWG * 128 + 32, L::kBytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<wg::bf16*>(dq), bh, seq, dim, scale, causal);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int seq, int dim, float scale, int causal, cudaStream_t stream) {
  using C = DkvConfig<DP>;
  using L = wg::DkvLayout<DP, C::kWG, C::kST>;
  const auto kernel = wg::flash_dkv_wgmma<DP, C::kWG, C::kST, C::kMinBlocks>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = make_map(&mq, q, bh, seq, dim, wg::kTileRows);
  if (err == cudaSuccess) err = make_map(&mdo, dout, bh, seq, dim, wg::kTileRows);
  if (err == cudaSuccess) err = make_map(&mk, k, bh, seq, dim, L::kRows);
  if (err == cudaSuccess) err = make_map(&mv, v, bh, seq, dim, L::kRows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((seq + L::kRows - 1) / L::kRows);
  kernel<<<blocks, C::kWG * 128 + 32, L::kBytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<wg::bf16*>(dk), static_cast<wg::bf16*>(dv), bh, seq, dim, scale, causal);
  return cudaSuccess;
}

// Launch shapes of the float32 backward at a padded head dim DM: the rows a
// block owns, the rows of a streamed tile, threads, and the blocks an SM
// holds (the register budget ptxas gets).  At DM = 64 (train_gpt2's path)
// and 32 a block of 128 threads owns 64 rows and streams tiles of 64, so
// both stages run 4 x 8 micro-tiles (stage 1: 12 float4 loads for 128
// FMAs; stage 2: 3 for 32) and two blocks share an SM (105 and 106 KB of
// shared memory at DM = 64; 254 registers, no spill).  A warp's float4 load
// delivers 512 bytes to registers whatever it broadcasts, at 128 bytes a
// clock an SM, so 4 x 4 micro-tiles (8 FMAs a load) leave the FMA pipe
// idle half the time; ops/flash_sweep.py measured 32-row tiles (4 x 4
// scores), one 256-thread block an SM (4 x 4 throughout), one 128-thread
// block an SM (too few warps to hide latency) and 128-row blocks (twice the
// masked diagonal work at T = 512) slower.  DM = 128 takes blocks of 32
// rows, so dk and dv stay 4 x 8 micro-tiles in registers without spilling.
template <int DM>
struct F32DqConfig {
  static constexpr int kRows = 64, kTile = 64, kThreads = 128, kMinBlocks = 2;
};
template <>
struct F32DqConfig<128> {
  static constexpr int kRows = 32, kTile = 64, kThreads = 128, kMinBlocks = 1;
};
template <int DM>
struct F32DkvConfig {
  static constexpr int kRows = 64, kTile = 64, kThreads = 128, kMinBlocks = 2;
};
template <>
struct F32DkvConfig<128> {
  static constexpr int kRows = 32, kTile = 64, kThreads = 128, kMinBlocks = 1;
};

// Lets a float32 backward kernel take `bytes` of dynamic shared memory (above
// the static 48 KB) and asks for the largest shared-memory carveout.
template <typename Kernel>
cudaError_t f32_smem(Kernel kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// bfloat16 runs on the tensor cores (a head dim of 32 or less as 64: its
// boxes' extra columns are TMA's zeros); float32 on the CUDA cores, the only
// exact float32 path (the tensor cores' float32 mode, TF32, keeps 10 bits).
template <int DM>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int seq, int dim, float scale, int causal, int is_bf16,
                       cudaStream_t stream) {
  if (is_bf16)
    return launch_fwd_wgmma<DM == 32 ? 64 : DM>(q, k, v, o, lse, bh, seq, dim, scale, causal,
                                                stream);
  flash_fwd_kernel<DM><<<row_blocks(bh, seq), kRows * (DM / 32), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), bh, seq, dim, scale, causal);
  return cudaSuccess;
}

template <int DM>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int seq,
                      int dim, float scale, int causal, int is_bf16,
                      cudaStream_t stream) {
  if (is_bf16)
    return launch_dq_wgmma<DM == 32 ? 64 : DM>(q, k, v, dout, lse, delta, dq, bh, seq, dim,
                                               scale, causal, stream);
  using C = F32DqConfig<DM>;
  using G = rb::Geometry<DM, C::kRows, C::kTile, C::kThreads>;
  const auto kernel = rb::flash_dq_kernel<DM, C::kRows, C::kTile, C::kThreads, C::kMinBlocks>;
  const cudaError_t err = f32_smem(kernel, G::kDqBytes);
  if (err != cudaSuccess) return err;
  kernel<<<bh * ((seq + C::kRows - 1) / C::kRows), C::kThreads, G::kDqBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), bh, seq, dim, scale, causal);
  return cudaSuccess;
}

template <int DM>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int seq, int dim, float scale, int causal, int is_bf16,
                       cudaStream_t stream) {
  if (is_bf16)
    return launch_dkv_wgmma<DM == 32 ? 64 : DM>(q, k, v, dout, lse, delta, dk, dv, bh, seq,
                                                dim, scale, causal, stream);
  using C = F32DkvConfig<DM>;
  using G = rb::Geometry<DM, C::kRows, C::kTile, C::kThreads>;
  const auto kernel = rb::flash_dkv_kernel<DM, C::kRows, C::kTile, C::kThreads, C::kMinBlocks>;
  const cudaError_t err = f32_smem(kernel, G::kDkvBytes);
  if (err != cudaSuccess) return err;
  kernel<<<bh * ((seq + C::kRows - 1) / C::kRows), C::kThreads, G::kDkvBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), bh, seq, dim, scale,
      causal);
  return cudaSuccess;
}

template <int DM>
int f32_smem_bytes(bool dq) {
  using Q = F32DqConfig<DM>;
  using K = F32DkvConfig<DM>;
  return dq ? rb::Geometry<DM, Q::kRows, Q::kTile, Q::kThreads>::kDqBytes
            : rb::Geometry<DM, K::kRows, K::kTile, K::kThreads>::kDkvBytes;
}

// `launch<DM>(args...)` for the padded head width.
#define ADAPCC_DISPATCH(launch, dm, ...)                       \
  (dm == 32   ? launch<32>(__VA_ARGS__)                       \
   : dm == 64 ? launch<64>(__VA_ARGS__)                       \
              : launch<128>(__VA_ARGS__))

// A launch's own error (a tensor map or an attribute it could not set),
// else cudaGetLastError(): a refused launch never runs, and only this
// reports it.  Both clear the runtime's last error.
int launch_result(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// C entry points, bound with ctypes.  Each launches on `stream` and returns
// 0 or the CUDA error of the launch.
extern "C" int adapcc_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int seq, int dim,
                                float scale, int causal, int is_bf16,
                                void* stream) {
  const int dm = padded_dim(dim);
  if (dm == 0 || dim % 8 != 0 || bh <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_result(ADAPCC_DISPATCH(launch_fwd, dm, q, k, v, o, lse, bh, seq, dim, scale,
                                       causal, is_bf16, static_cast<cudaStream_t>(stream)));
}

extern "C" int adapcc_flash_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int seq,
                               int dim, float scale, int causal, int is_bf16,
                               void* stream) {
  const int dm = padded_dim(dim);
  if (dm == 0 || dim % 8 != 0 || bh <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_result(ADAPCC_DISPATCH(launch_dq, dm, q, k, v, dout, lse, delta, dq, bh, seq,
                                       dim, scale, causal, is_bf16,
                                       static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory (bytes) of the bf16 forward (kernel 0), dk/dv
// (kernel 1) or dq (kernel 2) launch, or of the float32 dk/dv (3) or dq (4),
// at head dim `dim`: all of theirs is dynamic, so ptxas's report does not
// show it.
extern "C" int adapcc_flash_smem_bytes(int kernel, int dim) {
  if (kernel == 3 || kernel == 4)
    return ADAPCC_DISPATCH(f32_smem_bytes, padded_dim(dim), kernel == 4);
  const int dp = padded_dim(dim) == 128 ? 128 : 64;
  if (kernel == 0)
    return dp == 64 ? wg::FwdLayout<64, FwdConfig<64>::kWG, FwdConfig<64>::kST>::kBytes
                    : wg::FwdLayout<128, FwdConfig<128>::kWG, FwdConfig<128>::kST>::kBytes;
  if (kernel == 2)
    return dp == 64 ? wg::DqLayout<64, DqConfig<64>::kWG, DqConfig<64>::kST>::kBytes
                    : wg::DqLayout<128, DqConfig<128>::kWG, DqConfig<128>::kST>::kBytes;
  return dp == 64 ? wg::DkvLayout<64, DkvConfig<64>::kWG, DkvConfig<64>::kST>::kBytes
                  : wg::DkvLayout<128, DkvConfig<128>::kWG, DkvConfig<128>::kST>::kBytes;
}

extern "C" int adapcc_flash_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int seq, int dim, float scale, int causal,
                                int is_bf16, void* stream) {
  const int dm = padded_dim(dim);
  if (dm == 0 || dim % 8 != 0 || bh <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_result(ADAPCC_DISPATCH(launch_dkv, dm, q, k, v, dout, lse, delta, dk, dv, bh,
                                       seq, dim, scale, causal, is_bf16,
                                       static_cast<cudaStream_t>(stream)));
}
