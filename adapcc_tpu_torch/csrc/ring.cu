// Ring reduce-scatter / all-gather for Hopper (sm_90a): kernels K1a, K1b,
// and their fused wire-codec forms K5a, K5b.
//
// Replaces adapcc_tpu/comm/pallas_ring.py::_ring_kernel (K1a, each chunk in
// one stage: the planner's "vmem" path), ::_stream_ring_kernel (K1b, each
// chunk streamed through [stage_rows, 128] staging tiles: "hbm-stream"),
// ::_fused_ring_kernel (K5a) and ::_fused_stream_ring_kernel (K5b): the same
// two walks with a wire codec (int8 codes + a float32 scale per block, or
// bfloat16) in the staging tiles.
//
// What they compute is the Pallas kernels' function, not their block
// structure.  The payload of rank r is x[r] = [world chunks][chunk_elems],
// chunk-major; for an all-gather alone x[r] is only its own chunk r
// (`x_own`), the one chunk of x that walk reads.  The output is always every
// rank's [world][chunk_elems] work buffer.  Reduce-scatter takes world-1 steps: at step s rank r ships
// chunk r-s to its right neighbour and adds the chunk r-s-1 that lands from
// its left one to its own copy (local + landed, rounded to the payload type
// after every hop, as `work[recv_idx] + comm[slot]` does on the TPU).  Chunk
// c therefore starts at rank c and gains one rank's term per hop, and every
// element is summed in the same order as on the TPU: float32 and bfloat16
// results equal the JAX kernels' bit for bit.  The all-gather takes world-1
// steps of the same walk, adopting what lands (bits unchanged).
//
// The fused walks (K5, float32 payloads only) ship wire tiles instead:
//   - reduce-scatter: each hop encodes the moving float32 partial; the
//     receiver decodes and adds in float32 (local + q*s, two roundings:
//     __fadd_rn(local, __fmul_rn(q, s)), so nvcc cannot contract it into an
//     FMA and the plain torch version's multiply-then-add gives the same bits);
//   - all-gather: the owner encodes its reduced chunk once and adopts the
//     decoded values itself; every later hop forwards the bits it received.
//     Forwarding keeps the landed wire tiles (codes and scales, exactly as
//     they arrived) in a per-rank store [world chunks][n_tiles][slot] and
//     copies them on, so the bits are the owner's by construction, with no
//     re-encode;
//   - a reduce-scatter alone leaves the owned chunk as the float32 sum; an
//     all-gather alone encodes each rank's own chunk once.
// The int8 codec is quant/codec.py's: per block of `block_size` elements
// (128, 256, 512 or 1024), scale = absmax / 127 (1 for an all-zero block),
// q = clip(rint(x / scale), -127, 127), both divisions IEEE (__fdiv_rn),
// rint rounding half to even as torch.round and jnp.round do.  One warp
// encodes one codec block: its absmax is a __shfl_xor_sync max.  A block's
// stripe of a tile is whole codec blocks, so no reduction crosses thread
// blocks.  bfloat16 is __float2bfloat16_rn out and an exact widening back.
//
// Single-controller form: one launch walks the ring for every rank.  Rank r
// is a group of `nb` thread blocks; block b of rank r talks only to block b
// of ranks r-1 and r+1, over its stripe of every tile.  A rank's only view
// of its neighbours is RingPeers, a table of device pointers to each rank's
// two staging slots and flag words: what CUDA IPC handles give one process
// per card.  Flags carry data-ready (left -> right), credits (right -> left)
// and the entry barrier.  Every value is `epoch + k` for a per-call epoch
// above anything an earlier call wrote, so no reset pass runs between calls.
//
// Protocol of one iteration `it` (= step * n_tiles + tile, slot = it % 2),
// written once (ring_protocol) for both the plain and the fused walks:
//   1. it >= 2: wait for credit >= epoch + it - 1: the right neighbour has
//      consumed what this rank wrote into the slot at it - 2;
//   2. ship the outbound stripe into the right neighbour's slot (K1: the
//      payload; K5: codes, then the block scales, after them in the slot);
//      __syncthreads; thread 0: __threadfence, st.release ready[slot];
//   3. wait (ld.acquire) for own ready[slot] >= epoch + it + 1;
//   4. accumulate (RS) or adopt (AG) the landed stripe; __syncthreads;
//      thread 0: st.release the left neighbour's credit = epoch + it + 1.
// At the end each rank waits for credit >= epoch + total_iters (the drain:
// no signal outlives the call).  The flags use .gpu scope: every rank is on
// this card.  The per-process IPC form needs .sys scope on every flag access.
//
// Co-residency: blocks spin on other blocks' flags, so the whole grid must
// be resident at once.  The launch is cooperative and sized from the
// occupancy calculator; a grid that cannot fit is refused, never hung.
// Every spin is bounded by `timeout_ns` on %globaltimer: on overrun the
// kernel records (wait kind, rank, step, tile, block) in `err`, every other
// block sees the error word and leaves, and the host raises when it reads the
// word back (comm/ring.py check_errors, without stalling the stream).
//
// Bound: device-memory traffic.  The function reads every rank's input once
// and writes the result; the ring moves each chunk through a staging slot
// (write, then read) and reads the local operand, about 3x the bound's bytes
// for reduce-scatter (K5: the slot traffic shrinks to the wire's 1 + 4/block
// or 2 bytes an element).  This first version is plain 16-byte vector loads
// and stores, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWorld = 32;    // comm/ring.py _MAX_WORLD
constexpr int kMaxBlocks = 64;   // comm/ring.py _MAX_BLOCKS
constexpr int kFlagWords = 8;    // comm/ring.py _FLAG_WORDS (one 64-byte record)
// a block's stripe of a tile is at least this many 16-byte vectors of the
// payload (float32 on the fused walks)
constexpr long long kMinVecsPerBlock = 1024;
// the fused walks' unit of work: one int8 codec block, or 1024 elements of
// a bfloat16 tile; a lane holds at most kMaxVecs float4 of it
constexpr int kMaxVecs = 8;
constexpr int kBf16Unit = 1024;
// wire codecs (comm/ring.py _WIRE_CODES)
enum { kWireInt8 = 1, kWireBf16 = 2 };

// flag words of one (rank, block) record
enum { kReady0 = 0, kReady1 = 1, kCredit = 2, kBarFromLeft = 3, kBarFromRight = 4 };
// what a spin waited for (comm/ring.py _WAITS)
enum { kWaitBarrier = 1, kWaitCredit = 2, kWaitData = 3, kWaitDrain = 4 };

typedef unsigned long long u64;

struct RingPeers {
  char* slots[kMaxWorld];  // rank r: [2][slot_bytes] staging slots
  u64* flags[kMaxWorld];   // rank r: [kMaxBlocks][kFlagWords]
};

struct RingArgs {
  const void* x;           // [world][world][chunk_elems]
  void* out;               // the same layout: every rank's work buffer
  int* err;                // [kind, rank, step, tile, block, ...]
  long long chunk_elems;
  long long stage_elems;
  long long slot_bytes;    // one staging slot (K1: stage_elems payload elements)
  int world;
  int n_tiles;
  int rs;
  int ag;
  int x_own;               // all-gather alone: x is [world][chunk_elems], rank r's own chunk r
  u64 epoch;
  u64 timeout_ns;
  int fault_rank;          // that rank stops after the barrier (tests); -1: none
  // fused walks only
  char* store;             // [world][world][n_tiles][slot_bytes]: landed AG wire tiles
  int block_size;          // elements per int8 scale
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 spins until *flag >= target; false on overrun (recorded in err)
// or when another block has already failed.
__device__ bool spin_until(const u64* flag, u64 target, const RingArgs& a, int rank, int block,
                           int step, int tile, int kind) {
  const u64 start = global_ns();
  for (unsigned polls = 1;; ++polls) {
    if (ld_acquire(flag) >= target) return true;
    if ((polls & 255) == 0) {
      if (*(volatile int*)a.err != 0) return false;
      if (global_ns() - start > a.timeout_ns) {
        if (atomicCAS(a.err, 0, kind) == 0) {
          a.err[1] = rank;
          a.err[2] = step;
          a.err[3] = tile;
          a.err[4] = block;
        }
        return false;
      }
    }
  }
}

// The whole block waits for thread 0's spin; every thread gets its outcome.
__device__ bool block_wait(const u64* flag, u64 target, const RingArgs& a, int rank, int block,
                           int step, int tile, int kind) {
  __shared__ int ok;
  __syncthreads();  // earlier readers of `ok` are done
  if (threadIdx.x == 0) ok = spin_until(flag, target, a, rank, block, step, tile, kind);
  __syncthreads();
  return ok;
}

// One step of the walk, as every body sees it.
struct Hop {
  int step;
  int tile;
  int chunk;    // send_idx in ship, recv_idx in land
  bool in_rs;
};

// The ring protocol, once for every walk: barrier, then per (step, tile)
// credit wait, body.ship into the right neighbour's slot, ready flag, data
// wait, body.land from this rank's slot, credit; then the drain.  The body
// moves this block's stripe of the tile and nothing else.
template <class Body>
__device__ void ring_protocol(const RingPeers& peers, const RingArgs& a, int nb, Body& body) {
  const int W = a.world;
  const int rank = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int right = (rank + 1) % W, left = (rank + W - 1) % W;
  u64* mine = peers.flags[rank] + blk * kFlagWords;
  u64* right_flags = peers.flags[right] + blk * kFlagWords;
  u64* left_flags = peers.flags[left] + blk * kFlagWords;
  const u64 e = a.epoch;

  // entry barrier with both neighbours (at world 2 both are one rank, which
  // gets both words)
  if (threadIdx.x == 0) {
    st_release(right_flags + kBarFromLeft, e + 1);
    st_release(left_flags + kBarFromRight, e + 1);
  }
  if (!block_wait(mine + kBarFromLeft, e + 1, a, rank, blk, 0, 0, kWaitBarrier)) return;
  if (!block_wait(mine + kBarFromRight, e + 1, a, rank, blk, 0, 0, kWaitBarrier)) return;
  if (rank == a.fault_rank) return;

  const int n_rs = a.rs ? W - 1 : 0;
  const int n_ag = a.ag ? W - 1 : 0;
  const int total_steps = n_rs + n_ag;
  // after RS each rank owns the reduced chunk r + 1; a pure AG starts at r
  const int own = a.rs ? 1 : 0;

  for (int step = 0; step < total_steps; ++step) {
    const bool in_rs = step < n_rs;
    const int send_idx = in_rs ? (rank + W - step) % W : (rank + 2 * W + own - (step - n_rs)) % W;
    const int recv_idx = (send_idx + W - 1) % W;
    for (int tile = 0; tile < a.n_tiles; ++tile) {
      const long long it = (long long)step * a.n_tiles + tile;
      const int slot = (int)(it & 1);

      // 1. the slot at the right neighbour is free again
      if (it >= 2 && !block_wait(mine + kCredit, e + it - 1, a, rank, blk, step, tile, kWaitCredit))
        return;

      // 2. ship
      body.ship(Hop{step, tile, send_idx, in_rs}, peers.slots[right] + slot * a.slot_bytes);
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(right_flags + slot, e + it + 1);
      }

      // 3. what the left neighbour shipped has landed
      if (!block_wait(mine + slot, e + it + 1, a, rank, blk, step, tile, kWaitData)) return;

      // 4. accumulate or adopt
      body.land(Hop{step, tile, recv_idx, in_rs}, peers.slots[rank] + slot * a.slot_bytes);
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(left_flags + kCredit, e + it + 1);
      }
    }
  }

  // drain: the right neighbour has consumed everything this rank shipped
  const long long total_iters = (long long)total_steps * a.n_tiles;
  block_wait(mine + kCredit, e + total_iters, a, rank, blk, total_steps, 0, kWaitDrain);
}

// What every body knows of its rank and stripe.
struct Walk {
  int rank;
  int n_rs;
  int total_steps;
  long long rank_base;  // this rank's [world][chunk_elems] in x and out
  long long own_base;   // the own chunk r in x (x_own: [world][chunk_elems])

  __device__ Walk(const RingArgs& a, int nb) {
    const int W = a.world;
    rank = blockIdx.x / nb;
    n_rs = a.rs ? W - 1 : 0;
    total_steps = n_rs + (a.ag ? W - 1 : 0);
    rank_base = (long long)rank * W * a.chunk_elems;
    own_base = a.x_own ? (long long)rank * a.chunk_elems : rank_base + rank * a.chunk_elems;
  }
  // element offset of (chunk, tile) in this rank's work buffer
  __device__ long long at(const RingArgs& a, int chunk, int tile) const {
    return rank_base + chunk * a.chunk_elems + tile * a.stage_elems;
  }
};

// ----------------------------------------------------------------------------
// K1: the payload moves as it is
// ----------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 add16<float>(uint4 a, uint4 b) {
  uint4 r;
  r.x = __float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x));
  r.y = __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y));
  r.z = __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z));
  r.w = __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w));
  return r;
}

// bfloat16: widen, add in float32, round to nearest even (what torch and XLA
// do for a bfloat16 add)
template <>
__device__ __forceinline__ uint4 add16<__nv_bfloat16>(uint4 a, uint4 b) {
  uint4 r;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    pr[i] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  }
  return r;
}

template <typename T>
struct PlainBody {
  const RingArgs& a;
  Walk w;
  long long v0, v1;  // this block's stripe of every tile, in 16-byte vectors
  // the own chunk r is never landed on in RS-only or AG-only walks: step 0
  // copies it from the input into the work buffer as it ships it
  bool keep_own;

  __device__ PlainBody(const RingArgs& args, int nb) : a(args), w(args, nb) {
    const int blk = blockIdx.x % nb;
    const long long tile_vecs = a.stage_elems * (long long)sizeof(T) / 16;
    const long long per = (tile_vecs + nb - 1) / nb;
    v0 = blk * per;
    v1 = v0 + per < tile_vecs ? v0 + per : tile_vecs;
    keep_own = !(a.rs && a.ag);
  }

  // step 0 sends the own input chunk (send_idx == rank), later steps the
  // chunk this rank finished at the step before
  __device__ void ship(const Hop& h, char* slot) {
    const T* x = static_cast<const T*>(a.x);
    T* out = static_cast<T*>(a.out);
    const long long send_off = w.at(a, h.chunk, h.tile);
    const uint4* src = reinterpret_cast<const uint4*>(
        h.step == 0 ? x + w.own_base + h.tile * a.stage_elems : out + send_off);
    uint4* dst = reinterpret_cast<uint4*>(slot);
    uint4* keep = (h.step == 0 && keep_own) ? reinterpret_cast<uint4*>(out + send_off) : nullptr;
    for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
      const uint4 d = src[v];
      __stcg(dst + v, d);
      if (keep) keep[v] = d;
    }
  }

  // local + landed, or adopt; the slot is read past L1
  __device__ void land(const Hop& h, const char* slot) {
    const long long recv_off = w.at(a, h.chunk, h.tile);
    const uint4* landed = reinterpret_cast<const uint4*>(slot);
    uint4* work = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + recv_off);
    if (h.in_rs) {
      // chunk recv_idx is landed on once in RS: its local term is the input
      const uint4* local = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + recv_off);
      for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x)
        work[v] = add16<T>(local[v], __ldcg(landed + v));
    } else {
      for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) work[v] = __ldcg(landed + v);
    }
  }
};

// ----------------------------------------------------------------------------
// K5: wire codecs.  Each works on one unit (an int8 codec block, or 1024
// bfloat16 elements) held by one warp: lane l owns float4 l + 32 j of it.
// ----------------------------------------------------------------------------

struct Int8Wire {
  static constexpr int kBytes = 1;
  typedef uint32_t Word;  // the codes of one float4

  __device__ static float absmax4(float4 v) {
    return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
  }
  __device__ static int code(float x, float s) {
    return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
  }
  __device__ static float value(Word w, int k, float s) {
    return __fmul_rn((float)(signed char)((w >> (8 * k)) & 0xff), s);
  }

  // Encode src (nv float4 per lane) into codes and *scale; where `back` is
  // given, also write the decoded values (`decoded`) or the input there.
  __device__ static void encode(const float4* src, Word* codes, float* scale, float4* back, bool decoded,
                                int nv, int lane) {
    float4 v[kMaxVecs];
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j)
      if (j < nv) {
        v[j] = src[lane + 32 * j];
        m = fmaxf(m, absmax4(v[j]));
      }
#pragma unroll
    for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j)
      if (j < nv) {
        const int q0 = code(v[j].x, s), q1 = code(v[j].y, s), q2 = code(v[j].z, s), q3 = code(v[j].w, s);
        const Word wd = (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
                        ((uint32_t)(q3 & 0xff) << 24);
        __stcg(codes + lane + 32 * j, wd);
        if (back)
          back[lane + 32 * j] = decoded ? make_float4(value(wd, 0, s), value(wd, 1, s), value(wd, 2, s),
                                                      value(wd, 3, s))
                                        : v[j];
      }
    if (lane == 0) __stcg(scale, s);
  }

  // dst = local + decoded (local == nullptr: dst = decoded)
  __device__ static void decode(const Word* codes, const float* scale, const float4* local, float4* dst,
                                int nv, int lane) {
    const float s = __ldcg(scale);
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j)
      if (j < nv) {
        const Word wd = __ldcg(codes + lane + 32 * j);
        float4 d = make_float4(value(wd, 0, s), value(wd, 1, s), value(wd, 2, s), value(wd, 3, s));
        if (local) {
          const float4 l = local[lane + 32 * j];
          d = make_float4(__fadd_rn(l.x, d.x), __fadd_rn(l.y, d.y), __fadd_rn(l.z, d.z), __fadd_rn(l.w, d.w));
        }
        dst[lane + 32 * j] = d;
      }
  }
};

struct Bf16Wire {
  static constexpr int kBytes = 2;
  typedef uint2 Word;  // the bfloat16 values of one float4

  __device__ static Word pack(float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
  __device__ static float4 unpack(Word w) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }

  __device__ static void encode(const float4* src, Word* codes, float*, float4* back, bool decoded, int nv,
                                int lane) {
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j)
      if (j < nv) {
        const float4 v = src[lane + 32 * j];
        const Word wd = pack(v);
        __stcg(codes + lane + 32 * j, wd);
        if (back) back[lane + 32 * j] = decoded ? unpack(wd) : v;
      }
  }

  __device__ static void decode(const Word* codes, const float*, const float4* local, float4* dst, int nv,
                                int lane) {
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j)
      if (j < nv) {
        float4 d = unpack(__ldcg(codes + lane + 32 * j));
        if (local) {
          const float4 l = local[lane + 32 * j];
          d = make_float4(__fadd_rn(l.x, d.x), __fadd_rn(l.y, d.y), __fadd_rn(l.z, d.z), __fadd_rn(l.w, d.w));
        }
        dst[lane + 32 * j] = d;
      }
  }
};

// Byte layout of one staging slot (and one stored tile): the codes of the
// tile's stage_elems elements, then (int8) one float32 scale per block.
template <class C>
struct FusedBody {
  const RingArgs& a;
  Walk w;
  int unit;      // elements per unit (int8: block_size)
  int nv;        // float4 per lane per unit
  int u0, u1;    // this block's stripe of every tile, in units
  int warp, lane;

  __device__ FusedBody(const RingArgs& args, int nb) : a(args), w(args, nb) {
    unit = C::kBytes == 1 ? a.block_size : kBf16Unit;
    nv = unit / 128;
    const int blk = blockIdx.x % nb;
    const int n_units = (int)(a.stage_elems / unit);
    const int per = (n_units + nb - 1) / nb;
    u0 = blk * per;
    u1 = u0 + per < n_units ? u0 + per : n_units;
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
  }

  __device__ typename C::Word* codes(char* tile, int u) const {
    return reinterpret_cast<typename C::Word*>(tile + (long long)u * unit * C::kBytes);
  }
  __device__ float* scale(char* tile, int u) const {
    return reinterpret_cast<float*>(tile + a.stage_elems * C::kBytes) + u;
  }
  // the stored wire tile of (chunk, tile) of this rank
  __device__ char* stored(int chunk, int tile) const {
    return a.store + (((long long)w.rank * a.world + chunk) * a.n_tiles + tile) * a.slot_bytes;
  }

  __device__ void ship(const Hop& h, char* slot) {
    const float* x = static_cast<const float*>(a.x);
    float* out = static_cast<float*>(a.out);
    const bool first_ag = !h.in_rs && h.step == w.n_rs;
    if (h.in_rs || first_ag) {
      // RS hops encode the moving partial; the first AG hop is the one
      // encode of each reduced chunk, whose owner adopts the decoded values.
      // Step 0 reads the own input chunk; a reduce-scatter alone keeps it.
      const float* src = h.step == 0 ? x + w.own_base + h.tile * a.stage_elems : out + w.at(a, h.chunk, h.tile);
      float* back = (first_ag || (h.step == 0 && !a.ag)) ? out + w.at(a, h.chunk, h.tile) : nullptr;
      for (int u = u0 + warp; u < u1; u += kWarps)
        C::encode(reinterpret_cast<const float4*>(src + (long long)u * unit), codes(slot, u), scale(slot, u),
                  back ? reinterpret_cast<float4*>(back + (long long)u * unit) : nullptr, first_ag, nv, lane);
    } else {
      // later AG hops forward the bits that landed at the hop before
      char* tile = stored(h.chunk, h.tile);
      for (int u = u0 + warp; u < u1; u += kWarps) {
        const typename C::Word* from = codes(tile, u);
        typename C::Word* to = codes(slot, u);
#pragma unroll
        for (int j = 0; j < kMaxVecs; ++j)
          if (j < nv) __stcg(to + lane + 32 * j, from[lane + 32 * j]);
        if (C::kBytes == 1 && lane == 0) __stcg(scale(slot, u), *scale(tile, u));
      }
    }
  }

  __device__ void land(const Hop& h, char* slot) {
    float* dst = static_cast<float*>(a.out) + w.at(a, h.chunk, h.tile);
    // RS: chunk recv_idx is landed on once, so its local term is the input
    const float* local = h.in_rs ? static_cast<const float*>(a.x) + w.at(a, h.chunk, h.tile) : nullptr;
    // AG: keep the landed bits for the next hop, which forwards them
    char* keep = (!h.in_rs && h.step < w.total_steps - 1) ? stored(h.chunk, h.tile) : nullptr;
    for (int u = u0 + warp; u < u1; u += kWarps) {
      C::decode(codes(slot, u), scale(slot, u), local ? reinterpret_cast<const float4*>(local + (long long)u * unit)
                                                      : nullptr,
                reinterpret_cast<float4*>(dst + (long long)u * unit), nv, lane);
      if (keep) {
        const typename C::Word* from = codes(slot, u);
        typename C::Word* to = codes(keep, u);
#pragma unroll
        for (int j = 0; j < kMaxVecs; ++j)
          if (j < nv) to[lane + 32 * j] = __ldcg(from + lane + 32 * j);
        if (C::kBytes == 1 && lane == 0) *scale(keep, u) = __ldcg(scale(slot, u));
      }
    }
  }
};

// K1a: each chunk is one stage (stage = chunk, one tile per step); K1b: each
// chunk streams through n_tiles staging tiles per step.  K5a/K5b: the same
// with the codec C on the wire.  The pairs differ only in the arguments the
// host gives them; they are separate kernels so profiles name each.
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1a_kernel(RingPeers peers, RingArgs a, int nb) {
  PlainBody<T> body(a, nb);
  ring_protocol(peers, a, nb, body);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1b_kernel(RingPeers peers, RingArgs a, int nb) {
  PlainBody<T> body(a, nb);
  ring_protocol(peers, a, nb, body);
}

template <class C>
__global__ void __launch_bounds__(kThreads) ring_k5a_kernel(RingPeers peers, RingArgs a, int nb) {
  FusedBody<C> body(a, nb);
  ring_protocol(peers, a, nb, body);
}

template <class C>
__global__ void __launch_bounds__(kThreads) ring_k5b_kernel(RingPeers peers, RingArgs a, int nb) {
  FusedBody<C> body(a, nb);
  ring_protocol(peers, a, nb, body);
}

// Bytes of one fused staging slot: the wire codes, then (int8) one float32
// scale per block, rounded up to 16 bytes (comm/ring.py _fused_slot_bytes).
long long fused_slot_bytes(long long stage_elems, int wire, int block_size) {
  long long b = stage_elems * (wire == kWireInt8 ? 1 : 2);
  if (wire == kWireInt8) b += stage_elems / block_size * 4;
  return (b + 15) / 16 * 16;
}

// Fill the pointer table (single controller: every rank's slots and flags
// are slices of one buffer) and launch cooperatively with `want` blocks per
// rank, or as many as can be co-resident.
int launch(const void* kernel, RingArgs a, void* slots, void* flags, long long want, void* stream) {
  const int world = a.world;
  if (world < 2 || world > kMaxWorld) return (int)cudaErrorInvalidValue;
  if (a.x_own && (a.rs || !a.ag)) return (int)cudaErrorInvalidValue;
  if (a.slot_bytes % 16 || a.chunk_elems != a.stage_elems * a.n_tiles) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const long long fit = (long long)per_sm * sms / world;  // co-resident blocks per rank
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (want < 1) want = 1;
  int nb = (int)(want < fit ? want : fit);
  if (nb > kMaxBlocks) nb = kMaxBlocks;

  RingPeers peers;
  for (int r = 0; r < kMaxWorld; ++r) {
    const bool in = r < world;
    peers.slots[r] = in ? static_cast<char*>(slots) + (long long)r * 2 * a.slot_bytes : nullptr;
    peers.flags[r] = in ? static_cast<u64*>(flags) + (long long)r * kMaxBlocks * kFlagWords : nullptr;
  }
  void* args[] = {&peers, &a, &nb};
  e = cudaLaunchCooperativeKernel(kernel, dim3(world * nb), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

RingArgs ring_args(const void* x, void* out, void* err, int world, long long chunk_elems,
                   long long stage_elems, int n_tiles, int rs, int ag, int x_own, u64 epoch,
                   u64 timeout_ns, int fault_rank) {
  RingArgs a;
  a.x = x;
  a.out = out;
  a.err = static_cast<int*>(err);
  a.chunk_elems = chunk_elems;
  a.stage_elems = stage_elems;
  a.slot_bytes = 0;
  a.world = world;
  a.n_tiles = n_tiles;
  a.rs = rs;
  a.ag = ag;
  a.x_own = x_own;
  a.epoch = epoch;
  a.timeout_ns = timeout_ns;
  a.fault_rank = fault_rank;
  a.store = nullptr;
  a.block_size = 0;
  return a;
}

int launch_k1(bool streamed, const void* x, void* out, void* slots, void* flags, void* err, int world,
              long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag, int x_own,
              int is_bf16, u64 epoch, u64 timeout_ns, int fault_rank, void* stream) {
  const void* kernel = streamed ? (is_bf16 ? (const void*)ring_k1b_kernel<__nv_bfloat16>
                                           : (const void*)ring_k1b_kernel<float>)
                                : (is_bf16 ? (const void*)ring_k1a_kernel<__nv_bfloat16>
                                           : (const void*)ring_k1a_kernel<float>);
  const int elem_bytes = is_bf16 ? 2 : 4;
  RingArgs a = ring_args(x, out, err, world, chunk_elems, stage_elems, n_tiles, rs, ag, x_own, epoch,
                         timeout_ns, fault_rank);
  a.slot_bytes = stage_elems * elem_bytes;
  return launch(kernel, a, slots, flags, a.slot_bytes / 16 / kMinVecsPerBlock, stream);
}

int launch_k5(bool streamed, const void* x, void* out, void* slots, void* store, void* flags, void* err,
              int world, long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag,
              int x_own, int wire, int block_size, long long slot_bytes, u64 epoch, u64 timeout_ns,
              int fault_rank, void* stream) {
  const bool int8 = wire == kWireInt8;
  if (!int8 && wire != kWireBf16) return (int)cudaErrorInvalidValue;
  const int unit = int8 ? block_size : kBf16Unit;
  if (unit != 128 && unit != 256 && unit != 512 && unit != 1024) return (int)cudaErrorInvalidValue;
  if (stage_elems % unit || slot_bytes != fused_slot_bytes(stage_elems, wire, block_size))
    return (int)cudaErrorInvalidValue;
  const bool forwards = ag && world > 2;  // some AG hop forwards stored bits
  if (forwards && store == nullptr) return (int)cudaErrorInvalidValue;
  const void* kernel = streamed ? (int8 ? (const void*)ring_k5b_kernel<Int8Wire>
                                        : (const void*)ring_k5b_kernel<Bf16Wire>)
                                : (int8 ? (const void*)ring_k5a_kernel<Int8Wire>
                                        : (const void*)ring_k5a_kernel<Bf16Wire>);
  RingArgs a = ring_args(x, out, err, world, chunk_elems, stage_elems, n_tiles, rs, ag, x_own, epoch,
                         timeout_ns, fault_rank);
  a.slot_bytes = slot_bytes;
  a.store = static_cast<char*>(store);
  a.block_size = block_size;
  // stripes of at least kMinVecsPerBlock float32 vectors, of whole units
  const long long want = stage_elems * 4 / 16 / kMinVecsPerBlock;
  return launch(kernel, a, slots, flags, want < stage_elems / unit ? want : stage_elems / unit, stream);
}

}  // namespace

extern "C" {

int adapcc_ring_k1a(const void* x, void* out, void* slots, void* flags, void* err, int world,
                    long long chunk_elems, int rs, int ag, int x_own, int is_bf16, u64 epoch,
                    u64 timeout_ns, int fault_rank, void* stream) {
  return launch_k1(false, x, out, slots, flags, err, world, chunk_elems, chunk_elems, 1, rs, ag, x_own,
                   is_bf16, epoch, timeout_ns, fault_rank, stream);
}

int adapcc_ring_k1b(const void* x, void* out, void* slots, void* flags, void* err, int world,
                    long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag,
                    int x_own, int is_bf16, u64 epoch, u64 timeout_ns, int fault_rank, void* stream) {
  return launch_k1(true, x, out, slots, flags, err, world, chunk_elems, stage_elems, n_tiles, rs, ag,
                   x_own, is_bf16, epoch, timeout_ns, fault_rank, stream);
}

int adapcc_ring_k5a(const void* x, void* out, void* slots, void* store, void* flags, void* err, int world,
                    long long chunk_elems, int rs, int ag, int x_own, int wire, int block_size,
                    long long slot_bytes, u64 epoch, u64 timeout_ns, int fault_rank, void* stream) {
  return launch_k5(false, x, out, slots, store, flags, err, world, chunk_elems, chunk_elems, 1, rs, ag,
                   x_own, wire, block_size, slot_bytes, epoch, timeout_ns, fault_rank, stream);
}

int adapcc_ring_k5b(const void* x, void* out, void* slots, void* store, void* flags, void* err, int world,
                    long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag,
                    int x_own, int wire, int block_size, long long slot_bytes, u64 epoch,
                    u64 timeout_ns, int fault_rank, void* stream) {
  return launch_k5(true, x, out, slots, store, flags, err, world, chunk_elems, stage_elems, n_tiles, rs,
                   ag, x_own, wire, block_size, slot_bytes, epoch, timeout_ns, fault_rank, stream);
}

const char* adapcc_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
