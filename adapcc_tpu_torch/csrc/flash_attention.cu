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
// bfloat16; lse and delta are [BH, T] float32.  All sums are float32.
//
// Two implementations of each kernel, chosen by the dtype:
// * bfloat16 (the training path): tensor cores, namespace `tc` below.
// * float32: CUDA cores (flash_*_kernel), the exact float32 path; the
//   tensor cores' float32 mode (TF32) would keep only 10 mantissa bits.
// Shared by both:
// * One block owns 64 rows of its output (query rows for fwd/dq, key rows
//   for dk/dv) and keeps them in registers while the other operand streams
//   through shared memory in tiles.  No atomics: every block writes only its
//   own rows, like the TPU grid programs.
// * The TPU kernels loop over every key block and mask; under `causal` these
//   kernels skip the tiles that lie wholly above the diagonal.  That is exact:
//   a masked score is -1e30, so its p is exp(-1e30 - m) = 0 in float32, and
//   key 0 is never masked, so m is finite from the first tile on.
// * Blocks are ordered so that the longest causal rows start first.
//
// Bound at the main path's shape (BH = 256, T = 512, D = 64, bf16, causal),
// on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//   fwd: reads q, k, v and writes o (4 x 16.8 MB) plus lse (0.5 MB) = 67.6 MB
//        -> 20 us; 4*D flops per unmasked (q, k) pair = 8.6 GFLOP -> 8.7 us:
//        memory-bound at about 20 us.
//   dq:  q, k, v, do, dq (5 x 16.8 MB) + lse, delta = 85 MB -> 25 us;
//        6*D flops per pair = 12.9 GFLOP -> 13 us: memory-bound.
//   dkv: q, k, v, do, dk, dv (6 x 16.8 MB) + lse, delta = 102 MB -> 30 us;
//        8*D flops per pair = 17.2 GFLOP -> 17 us: memory-bound.
// Neither path reaches these bounds: each re-reads the streamed operand once
// per 64-row block (8x at T = 512) from L2, and mma.sync issues from
// registers without overlapping the tile loads; wgmma fed by TMA, with
// double-buffered tiles, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the mask value of the TPU kernels
constexpr int kRows = 64;          // output rows owned by one block

// --------------------------------------------------------------------------
// float32 path: CUDA cores
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

template <int DM>
__global__ void __launch_bounds__(kRows * (DM / 32))
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int bh_count, int seq, int dim, float scale,
                int causal) {
  constexpr int TPR = DM / 32;
  __shared__ __align__(16) float ks[kTile][DM];
  __shared__ __align__(16) float vs[kTile][DM];

  const int n_tiles = (seq + kRows - 1) / kRows;
  const int tile = n_tiles - 1 - blockIdx.x / bh_count;  // longest rows first
  const int bh = blockIdx.x % bh_count;
  const int part = threadIdx.x % TPR;
  const int row = tile * kRows + threadIdx.x / TPR;
  const size_t base = (size_t)bh * seq * dim;

  float4 qr[kChunks], dor[kChunks], acc[kChunks];
  load_row<TPR>(qr, q + base, row, seq, dim, part);
  load_row<TPR>(dor, dout + base, row, seq, dim, part);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse_r = row < seq ? lse[(size_t)bh * seq + row] : 0.f;
  const float delta_r = row < seq ? delta[(size_t)bh * seq + row] : 0.f;

  const int last_row = min(tile * kRows + kRows, seq) - 1;
  const int k_end = causal ? last_row + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<DM>(ks, k + base, k0, seq, dim);
    load_tile<DM>(vs, v + base, k0, seq, dim);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = group_sum<TPR>(dot_part<TPR>(qr, ks[j], part)) * scale;
      const float dp = group_sum<TPR>(dot_part<TPR>(dor, vs[j], part));
      const int key = k0 + j;
      const bool live = key < seq && !(causal && key > row);
      const float p = live ? expf(s - lse_r) : 0.f;
      axpy<TPR>(acc, p * (dp - delta_r) * scale, ks[j], part);
    }
  }
  store_row<TPR>(dq + base, acc, 1.f, row, seq, dim, part);
}

template <int DM>
__global__ void __launch_bounds__(kRows * (DM / 32))
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int bh_count, int seq,
                 int dim, float scale, int causal) {
  constexpr int TPR = DM / 32;
  __shared__ __align__(16) float qs[kTile][DM];
  __shared__ __align__(16) float dos[kTile][DM];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int tile = blockIdx.x / bh_count;  // first key tiles see most queries
  const int bh = blockIdx.x % bh_count;
  const int part = threadIdx.x % TPR;
  const int key = tile * kRows + threadIdx.x / TPR;
  const size_t base = (size_t)bh * seq * dim;
  const size_t row_base = (size_t)bh * seq;

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
  load_row<TPR>(kr, k + base, key, seq, dim, part);
  load_row<TPR>(vr, v + base, key, seq, dim, part);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    dk_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // under `causal` no query before this block's first key reaches it
  const int q_begin = causal ? tile * kRows : 0;
  for (int q0 = q_begin; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile<DM>(qs, q + base, q0, seq, dim);
    load_tile<DM>(dos, dout + base, q0, seq, dim);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const int g = q0 + i;
      lse_s[i] = g < seq ? lse[row_base + g] : 0.f;
      delta_s[i] = g < seq ? delta[row_base + g] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const float s = group_sum<TPR>(dot_part<TPR>(kr, qs[i], part)) * scale;
      const float dp = group_sum<TPR>(dot_part<TPR>(vr, dos[i], part));
      const int qi = q0 + i;
      const bool live = qi < seq && !(causal && key > qi);
      const float p = live ? expf(s - lse_s[i]) : 0.f;
      axpy<TPR>(dv_acc, p, dos[i], part);
      axpy<TPR>(dk_acc, p * (dp - delta_s[i]) * scale, qs[i], part);
    }
  }
  store_row<TPR>(dk + base, dk_acc, 1.f, key, seq, dim, part);
  store_row<TPR>(dv + base, dv_acc, 1.f, key, seq, dim, part);
}

// --------------------------------------------------------------------------
// bfloat16 path: tensor cores (mma.sync m16n8k16, float32 accumulate)
// --------------------------------------------------------------------------
//
// One block of 4 warps owns 64 output rows, 16 per warp.  A warp keeps its
// rows' operand fragments (q and do, or k and v) in registers and runs every
// product of its 16 rows with mma.sync against tiles streamed through shared
// memory: row-major tiles feed the products over the head dim, transposed
// tiles the products over keys (or queries).  Scores, p and ds stay in the
// accumulator registers; the accumulator layout of one product is the
// operand layout of the next, so p and ds never touch shared memory.
//
// Exactness: q, k, v and do are bf16 already, so their products are exact.
// p and ds are float32 and the TPU kernels multiply them in float32; here
// each is split into a bf16 head and a bf16 remainder (x = hi + lo to about
// 2^-16 relative) and both halves go through the tensor cores, so the
// result keeps float32-level accuracy against the plain version.
namespace tc {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // output rows owned by one block
using bf16 = __nv_bfloat16;

// Keys (or queries) per streamed tile: 64, or 32 at head dim 128 to stay
// within 48 KB of static shared memory.
template <int DP>
struct Tile {
  static constexpr int kLen = DP == 128 ? 32 : 64;
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as bf16 pairs: the rounded head and the remainder.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - f.x, b - f.y));
}

// The A fragments (16 x 16) of the accumulator tiles c[2kk], c[2kk + 1]
// (16 x 8 each), split into head and remainder.
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// Two bf16 at (row, col), (row, col + 1) of a [seq, dim] matrix; zero
// outside it (col is even and dim a multiple of 8, so both or neither).
__device__ __forceinline__ uint32_t ldg_pair(const bf16* src, int row, int col,
                                             int seq, int dim) {
  return (row < seq && col < dim)
             ? *reinterpret_cast<const uint32_t*>(src + (size_t)row * dim + col)
             : 0u;
}

// A fragment: rows [rb, rb + 16) and columns [kb, kb + 16) of a global
// [seq, dim] matrix.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* src,
                                       int rb, int kb, int seq, int dim,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  a[0] = ldg_pair(src, rb + g, kb + 2 * t, seq, dim);
  a[1] = ldg_pair(src, rb + g + 8, kb + 2 * t, seq, dim);
  a[2] = ldg_pair(src, rb + g, kb + 2 * t + 8, seq, dim);
  a[3] = ldg_pair(src, rb + g + 8, kb + 2 * t + 8, seq, dim);
}

// B fragment (16 x 8) with B[k][n] = tile[nb + n][kb + k] of a shared tile
// with row length LD.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* tile, int nb, int kb,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  b0 = *reinterpret_cast<const uint32_t*>(tile + (nb + g) * LD + kb + 2 * t);
  b1 = *reinterpret_cast<const uint32_t*>(tile + (nb + g) * LD + kb + 2 * t + 8);
}

// Rows [row0, row0 + R) of a global [seq, dim] matrix into a shared tile,
// row-major [R][DP + 8] (8 columns of padding keep fragment reads free of
// bank conflicts), zero-filled outside the matrix.
template <int R, int DP>
__device__ __forceinline__ void load_rows(bf16 (*dst)[DP + 8], const bf16* src,
                                          int row0, int seq, int dim) {
  constexpr int kVecs = DP / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < R * kVecs; idx += blockDim.x) {
    const int r = idx / kVecs, c = 8 * (idx % kVecs), g = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < seq && c < dim)
      v = *reinterpret_cast<const uint4*>(src + (size_t)g * dim + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// The same rows, transposed: [DP][R + 8].
template <int R, int DP>
__device__ __forceinline__ void load_rows_t(bf16 (*dst)[R + 8], const bf16* src,
                                            int row0, int seq, int dim) {
  constexpr int kVecs = DP / 8;
  for (int idx = threadIdx.x; idx < R * kVecs; idx += blockDim.x) {
    const int r = idx / kVecs, c = 8 * (idx % kVecs), g = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < seq && c < dim)
      v = *reinterpret_cast<const uint4*>(src + (size_t)g * dim + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[c + i][r] = e[i];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores rows (row0, row0 + 8) of a warp's accumulators times (mul0, mul1).
template <int DN>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[DN][4],
                                          float mul0, float mul1, int row0,
                                          int seq, int dim, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (col >= dim) continue;
    if (row0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row0 * dim + col) =
          __floats2bfloat162_rn(acc[dn][0] * mul0, acc[dn][1] * mul0);
    if (row0 + 8 < seq)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row0 + 8) * dim + col) =
          __floats2bfloat162_rn(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

template <int DP>
__global__ void __launch_bounds__(kRows * 2)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int bh_count, int seq, int dim,
           float scale, int causal) {
  constexpr int BK = Tile<DP>::kLen, NT = BK / 8, KS = DP / 16, DN = DP / 8;
  __shared__ __align__(16) bf16 ks[BK][DP + 8];
  __shared__ __align__(16) bf16 vt[DP][BK + 8];

  const int n_tiles = (seq + kRows - 1) / kRows;
  const int tile = n_tiles - 1 - blockIdx.x / bh_count;  // longest rows first
  const int bh = blockIdx.x % bh_count;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const size_t base = (size_t)bh * seq * dim;
  const int rb = tile * kRows + warp * 16;
  const int row[2] = {rb + (lane >> 2), rb + (lane >> 2) + 8};

  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) load_a(qf[s], q + base, rb, s * 16, seq, dim, lane);
  float acc[DN][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part

  const int last_row = min(tile * kRows + kRows, seq) - 1;
  const int k_end = causal ? last_row + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    load_rows<BK, DP>(ks, k + base, k0, seq, dim);
    load_rows_t<BK, DP>(vt, v + base, k0, seq, dim);
    __syncthreads();

    float sc[NT][4] = {};
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        load_b<DP + 8>(b0, b1, &ks[0][0], nt * 8, s * 16, lane);
        mma(sc[nt], qf[s], b0, b1);
      }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        float x = sc[nt][e] * scale;
        if (key >= seq || (causal && key > row[e >> 1])) x = kNegInf;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] - m[e >> 1]);
        l[e >> 1] += sc[nt][e];
      }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(sc[2 * kk], sc[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        load_b<BK + 8>(b0, b1, &vt[0][0], dn * 8, kk * 16, lane);
        mma(acc[dn], hi, b0, b1);
        mma(acc[dn], lo, b0, b1);
      }
    }
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  store_acc<DN>(o + base, acc, 1.f / l0, 1.f / l1, row[0], seq, dim, lane);
  if (t == 0) {
    if (row[0] < seq) lse[(size_t)bh * seq + row[0]] = m[0] + logf(l0);
    if (row[1] < seq) lse[(size_t)bh * seq + row[1]] = m[1] + logf(l1);
  }
}

template <int DP>
__global__ void __launch_bounds__(kRows * 2)
flash_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int bh_count, int seq, int dim, float scale,
          int causal) {
  constexpr int BK = Tile<DP>::kLen, NT = BK / 8, KS = DP / 16, DN = DP / 8;
  __shared__ __align__(16) bf16 ks[BK][DP + 8];
  __shared__ __align__(16) bf16 vs[BK][DP + 8];
  __shared__ __align__(16) bf16 kt[DP][BK + 8];

  const int n_tiles = (seq + kRows - 1) / kRows;
  const int tile = n_tiles - 1 - blockIdx.x / bh_count;  // longest rows first
  const int bh = blockIdx.x % bh_count;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const size_t base = (size_t)bh * seq * dim;
  const int rb = tile * kRows + warp * 16;
  const int row[2] = {rb + (lane >> 2), rb + (lane >> 2) + 8};

  uint32_t qf[KS][4], df[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    load_a(qf[s], q + base, rb, s * 16, seq, dim, lane);
    load_a(df[s], dout + base, rb, s * 16, seq, dim, lane);
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < seq ? lse[(size_t)bh * seq + row[r]] : 0.f;
    delta_r[r] = row[r] < seq ? delta[(size_t)bh * seq + row[r]] : 0.f;
  }
  float acc[DN][4] = {};

  const int last_row = min(tile * kRows + kRows, seq) - 1;
  const int k_end = causal ? last_row + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<BK, DP>(ks, k + base, k0, seq, dim);
    load_rows<BK, DP>(vs, v + base, k0, seq, dim);
    load_rows_t<BK, DP>(kt, k + base, k0, seq, dim);
    __syncthreads();

    float sc[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        load_b<DP + 8>(b0, b1, &ks[0][0], nt * 8, s * 16, lane);
        mma(sc[nt], qf[s], b0, b1);
        load_b<DP + 8>(b0, b1, &vs[0][0], nt * 8, s * 16, lane);
        mma(dp[nt], df[s], b0, b1);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const bool live = key < seq && !(causal && key > row[e >> 1]);
        const float p = live ? expf(sc[nt][e] * scale - lse_r[e >> 1]) : 0.f;
        sc[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]) * scale;  // ds
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(sc[2 * kk], sc[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        load_b<BK + 8>(b0, b1, &kt[0][0], dn * 8, kk * 16, lane);
        mma(acc[dn], hi, b0, b1);
        mma(acc[dn], lo, b0, b1);
      }
    }
  }
  store_acc<DN>(dq + base, acc, 1.f, 1.f, row[0], seq, dim, lane);
}

template <int DP>
__global__ void __launch_bounds__(kRows * 2)
flash_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int bh_count, int seq,
           int dim, float scale, int causal) {
  constexpr int BQ = Tile<DP>::kLen, NT = BQ / 8, KS = DP / 16, DN = DP / 8;
  __shared__ __align__(16) bf16 qs[BQ][DP + 8];
  __shared__ __align__(16) bf16 dos[BQ][DP + 8];
  __shared__ __align__(16) bf16 qt[DP][BQ + 8];
  __shared__ __align__(16) bf16 dot[DP][BQ + 8];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tile = blockIdx.x / bh_count;  // first key tiles see most queries
  const int bh = blockIdx.x % bh_count;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const size_t base = (size_t)bh * seq * dim;
  const size_t row_base = (size_t)bh * seq;
  const int kb = tile * kRows + warp * 16;
  const int key[2] = {kb + (lane >> 2), kb + (lane >> 2) + 8};

  uint32_t kf[KS][4], vf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    load_a(kf[s], k + base, kb, s * 16, seq, dim, lane);
    load_a(vf[s], v + base, kb, s * 16, seq, dim, lane);
  }
  float dk_acc[DN][4] = {}, dv_acc[DN][4] = {};

  // under `causal` no query before this block's first key reaches it
  const int q_begin = causal ? tile * kRows : 0;
  for (int q0 = q_begin; q0 < seq; q0 += BQ) {
    __syncthreads();
    load_rows<BQ, DP>(qs, q + base, q0, seq, dim);
    load_rows<BQ, DP>(dos, dout + base, q0, seq, dim);
    load_rows_t<BQ, DP>(qt, q + base, q0, seq, dim);
    load_rows_t<BQ, DP>(dot, dout + base, q0, seq, dim);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const int g = q0 + i;
      lse_s[i] = g < seq ? lse[row_base + g] : 0.f;
      delta_s[i] = g < seq ? delta[row_base + g] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this warp's keys, columns the tile's queries
    float st[NT][4] = {}, dpt[NT][4] = {};
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        load_b<DP + 8>(b0, b1, &qs[0][0], nt * 8, s * 16, lane);
        mma(st[nt], kf[s], b0, b1);
        load_b<DP + 8>(b0, b1, &dos[0][0], nt * 8, s * 16, lane);
        mma(dpt[nt], vf[s], b0, b1);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + 2 * t + (e & 1);
        const int qi = q0 + i;
        const bool live = qi < seq && !(causal && key[e >> 1] > qi);
        const float p = live ? expf(st[nt][e] * scale - lse_s[i]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[i]) * scale;  // ds
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(st[2 * kk], st[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        load_b<BQ + 8>(b0, b1, &dot[0][0], dn * 8, kk * 16, lane);
        mma(dv_acc[dn], hi, b0, b1);
        mma(dv_acc[dn], lo, b0, b1);
      }
      split_a(dpt[2 * kk], dpt[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        load_b<BQ + 8>(b0, b1, &qt[0][0], dn * 8, kk * 16, lane);
        mma(dk_acc[dn], hi, b0, b1);
        mma(dk_acc[dn], lo, b0, b1);
      }
    }
  }
  store_acc<DN>(dk + base, dk_acc, 1.f, 1.f, key[0], seq, dim, lane);
  store_acc<DN>(dv + base, dv_acc, 1.f, 1.f, key[0], seq, dim, lane);
}

}  // namespace tc

// Padded head width: the smallest supported DM >= dim, or 0.
int padded_dim(int dim) {
  if (dim <= 32) return 32;
  if (dim <= 64) return 64;
  if (dim <= 128) return 128;
  return 0;
}

int row_blocks(int bh, int seq) { return bh * ((seq + kRows - 1) / kRows); }

// bfloat16 runs on the tensor cores; float32 on the CUDA cores, the only
// exact float32 path (the tensor cores' float32 mode, TF32, keeps 10 bits).
template <int DM>
void launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                int bh, int seq, int dim, float scale, int causal, int is_bf16,
                cudaStream_t stream) {
  using tc::bf16;
  if (is_bf16) {
    tc::flash_fwd_tc<DM><<<row_blocks(bh, seq), tc::kRows * 2, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), bh, seq, dim, scale, causal);
  } else {
    flash_fwd_kernel<DM><<<row_blocks(bh, seq), kRows * (DM / 32), 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), bh, seq, dim, scale, causal);
  }
}

template <int DM>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, int bh, int seq,
               int dim, float scale, int causal, int is_bf16,
               cudaStream_t stream) {
  using tc::bf16;
  if (is_bf16) {
    tc::flash_dq_tc<DM><<<row_blocks(bh, seq), tc::kRows * 2, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), bh, seq, dim, scale, causal);
  } else {
    flash_dq_kernel<DM><<<row_blocks(bh, seq), kRows * (DM / 32), 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), bh, seq, dim, scale, causal);
  }
}

template <int DM>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int bh,
                int seq, int dim, float scale, int causal, int is_bf16,
                cudaStream_t stream) {
  using tc::bf16;
  if (is_bf16) {
    tc::flash_dkv_tc<DM><<<row_blocks(bh, seq), tc::kRows * 2, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), bh, seq, dim, scale,
        causal);
  } else {
    flash_dkv_kernel<DM><<<row_blocks(bh, seq), kRows * (DM / 32), 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), bh, seq, dim, scale,
        causal);
  }
}

// Calls `launch<DM>(args...)` for the padded head width.
#define ADAPCC_DISPATCH(launch, dm, ...)                  \
  do {                                                    \
    if (dm == 32) launch<32>(__VA_ARGS__);                \
    else if (dm == 64) launch<64>(__VA_ARGS__);           \
    else launch<128>(__VA_ARGS__);                        \
  } while (0)

}  // namespace

// C entry points, bound with ctypes.  Each launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this reports it.
extern "C" int adapcc_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int seq, int dim,
                                float scale, int causal, int is_bf16,
                                void* stream) {
  const int dm = padded_dim(dim);
  if (dm == 0 || dim % 8 != 0 || bh <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ADAPCC_DISPATCH(launch_fwd, dm, q, k, v, o, lse, bh, seq, dim, scale, causal,
                  is_bf16, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int adapcc_flash_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int seq,
                               int dim, float scale, int causal, int is_bf16,
                               void* stream) {
  const int dm = padded_dim(dim);
  if (dm == 0 || dim % 8 != 0 || bh <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ADAPCC_DISPATCH(launch_dq, dm, q, k, v, dout, lse, delta, dq, bh, seq, dim,
                  scale, causal, is_bf16, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int adapcc_flash_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int seq, int dim, float scale, int causal,
                                int is_bf16, void* stream) {
  const int dm = padded_dim(dim);
  if (dm == 0 || dim % 8 != 0 || bh <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ADAPCC_DISPATCH(launch_dkv, dm, q, k, v, dout, lse, delta, dk, dv, bh, seq,
                  dim, scale, causal, is_bf16,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
