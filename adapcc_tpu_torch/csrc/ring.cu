// Ring reduce-scatter / all-gather for Hopper (sm_90a): kernels K1a, K1b,
// and their fused wire-codec forms K5a, K5b.
//
// Replaces adapcc_tpu/comm/pallas_ring.py::_ring_kernel (K1a, each chunk in
// one stage: the planner's "vmem" path), ::_stream_ring_kernel (K1b, each
// chunk streamed in [stage_rows, 128] tiles: "hbm-stream"),
// ::_fused_ring_kernel (K5a) and ::_fused_stream_ring_kernel (K5b): the same
// two walks with a wire codec (int8 codes + a float32 scale per block, or
// bfloat16) in staging tiles.
//
// What they compute is the Pallas kernels' function, not their block
// structure.  The payload of rank r is x[r] = [world chunks][chunk_elems],
// chunk-major; for an all-gather alone x[r] is only its own chunk r
// (`x_own`), the one chunk of x that walk reads.  The output is always every
// rank's [world][chunk_elems] work buffer.  Reduce-scatter takes world-1
// steps: at step s rank r adds the partial of chunk r-s-1 that its left
// neighbour finished at step s-1 (at step 0: the left's own input chunk) to
// its own input term (local + landed, rounded to the payload type after every
// hop, as `work[recv_idx] + comm[slot]` does on the TPU).  Chunk c therefore
// starts at rank c and gains one rank's term per hop, rank r ends owning
// chunk r+1, and every element is summed in the same order as on the TPU:
// float32 and bfloat16 results equal the JAX kernels' bit for bit.  The
// all-gather takes world-1 steps of the same walk, adopting what lands (bits
// unchanged).
//
// K1: the direct walk.  A hop's partial is written once, into the work
// buffer of the rank that computed it, where the right neighbour reads it
// ("pull"): rank r reads the landed partial from out[r-1] (step 0: the left's
// input chunk, straight from x) and its own input term, and writes out[r]
// once.  A walk with one phase never lands on a rank's own chunk, so the
// right neighbour writes out[r][r] as it reads x[r][r] at step 0: no own-chunk
// copy re-reads the input.  The only signal is one ready counter per (rank,
// block), released after the block's stores of each (step, tile).  A rank
// walks its (step, tile) iterations tile-major, every step of tile t before
// tile t+1, so hop s+1 of tile t runs one iteration after hop s wrote it and
// reads it from L2; each block's stripe is bounded by the chunk's real
// length, so the last tile of a chunk may be ragged.
//   - No staging slot: the slot walk before it shipped each hop into the
//     neighbour's slot and read it back, 5 chunk-sized transfers a
//     reduce-scatter hop where the function needs 3 (read the landed
//     partial, read the local term, write the sum).
//   - No credit: nothing is written twice except, in a reduce-scatter +
//     all-gather walk, chunk c of out[r], whose reduce-scatter partial the
//     right neighbour reads (hop k, k = r-c) before the all-gather's copy
//     overwrites it (hop W-1+k).  That read is ordered before the overwrite
//     by the chain of ready counters of block b on that tile: r+1 reads its
//     stripe before it releases its counter; the reduce-scatter of chunk c
//     carries on through r+2, ..., the owner r-k-1, and the all-gather of
//     chunk c back through r-k, ..., r-1, whose release rank r acquires
//     before it overwrites.  Release and acquire at .gpu scope are
//     transitive, and a counter covers every earlier iteration of its rank,
//     so that chain suffices in either iteration order.
// Bytes (world W, chunk C, RS = reduce-scatter alone): the function reads
// each input once and writes each result once (the bound's (W+1) C per rank
// for RS or AG alone).  The walk moves 3 C a reduce-scatter hop and 2 C an
// all-gather hop, plus the folded own chunk (1 C): RS (3 (W-1) + 1) C and AG
// (2 (W-1) + 1) C per rank, 40 C and 28 C at world 4 (the slot walk: about 64
// C and 52 C), of which the partials read back (W-2 C a rank) mostly hit L2.
// Each thread keeps kUnroll 16-byte loads of each operand in flight
// (L2-cached, past L1: the landed data was written by another SM); stores no
// rank reads again in the walk are marked evict-first.  comm/ring_sweep.py
// times each choice undone (step-major order, 2 or 4 loads in flight, plain
// stores) and TMA bulk copies into shared memory in place of the vector
// loads.
//
// The fused walks (K5, float32 payloads only) keep the slot protocol
// (ring_protocol below): their wire tiles need a home, in the neighbour's
// staging slot.  They ship wire tiles instead of the payload:
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
// K5's protocol, per iteration `it` (= step * n_tiles + tile, slot = it % 2):
// wait for the right neighbour's credit for the slot it wrote at it - 2, ship
// into the right neighbour's slot, release ready[slot]; acquire its own
// ready[slot]; decode the landed tile; release the left neighbour's credit.
// A drain waits for the last credits.
//
// Single-controller form: one launch walks the ring for every rank.  Rank r
// is a group of `nb` thread blocks; block b of rank r talks only to block b
// of ranks r-1 and r+1, over its stripe of every tile.  A rank's only view
// of its neighbours is a table of device pointers (RingBuffers for K1: each
// rank's input, work buffer and flag words; RingPeers for K5: staging slots
// and flags), what one CUDA IPC registration of persistent buffers gives one
// process per card.  Every flag value is `epoch + k` for a per-call epoch
// above anything an earlier call wrote, so no reset pass runs between calls.
// An entry barrier with both neighbours opens every walk.  The flags use .gpu
// scope: every rank is on this card.  The per-process IPC form needs .sys
// scope on every flag access.
//
// Co-residency: blocks spin on other blocks' flags, so the whole grid must
// be resident at once.  The launch is cooperative and sized from the
// occupancy calculator (queried once per kernel and device); a grid that
// cannot fit is refused, never hung.  Every spin is bounded by `timeout_ns`
// on %globaltimer.  On overrun the first block to fail raises the stream's
// failure word (a u64 on the card) to the call's epoch, which every other
// block polls and leaves on, and writes (wait kind, rank, step, tile, block),
// tagged with the epoch, into the call's report: a record of pinned host
// memory that the kernel writes through its mapped address, so no copy
// follows the kernel.  The host reuses a ring of reports without clearing
// them (an older call's tag is a smaller epoch) and raises when it reads one
// with its call's tag (comm/ring.py check_errors, without stalling the
// stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWorld = 32;    // comm/ring.py _MAX_WORLD
constexpr int kMaxBlocks = 1024; // comm/ring.py _MAX_BLOCKS: flag records per rank
constexpr int kFlagWords = 8;    // comm/ring.py _FLAG_WORDS (one 64-byte record)
// K1: 16-byte loads of each operand a thread keeps in flight
constexpr int kUnroll = 8;
// K1: the order of a rank's (step, tile) iterations.  Tile-major walks every
// step of tile t before tile t + 1, so the right neighbour reads a partial
// one iteration after it was written, while it is still in L2; step-major
// walks every tile of a step first.
constexpr bool kTileMajor = true;
// K1: a store no rank reads again in the walk (the last step's, the folded
// own chunk) is marked evict-first in L2, leaving L2 to the partials
constexpr bool kStreamLast = true;
// K5: at most this many blocks per rank, each stripe of a tile at least
// kMinVecsPerBlock 16-byte vectors of the float32 payload
constexpr int kFusedMaxBlocks = 64;
constexpr long long kMinVecsPerBlock = 1024;
// the fused walks' unit of work: one int8 codec block, or 1024 elements of
// a bfloat16 tile; a lane holds at most kMaxVecs float4 of it
constexpr int kMaxVecs = 8;
constexpr int kBf16Unit = 1024;
// wire codecs (comm/ring.py _WIRE_CODES)
enum { kWireInt8 = 1, kWireBf16 = 2 };

// flag words of one (rank, block) record; K1 counts its (step, tile)
// iterations in kReady0
enum { kReady0 = 0, kReady1 = 1, kCredit = 2, kBarFromLeft = 3, kBarFromRight = 4 };
// what a spin waited for (comm/ring.py _WAITS)
enum { kWaitBarrier = 1, kWaitCredit = 2, kWaitData = 3, kWaitDrain = 4 };
// a report (comm/ring.py _REPORT_WORDS int32): a u64 tag (the epoch of the
// call that failed), then kind, rank, step, tile, block
enum { kRepKind = 2, kRepRank = 3, kRepStep = 4, kRepTile = 5, kRepBlock = 6 };

typedef unsigned long long u64;

struct RingPeers {
  char* slots[kMaxWorld];  // rank r: [2][slot_bytes] staging slots
  u64* flags[kMaxWorld];   // rank r: [kMaxBlocks][kFlagWords]
};

struct RingArgs {
  const void* x;           // [world][world][chunk_elems]
  void* out;               // the same layout: every rank's work buffer
  u64* fail;               // the stream's failure word (the epoch of its last failed call)
  int* report;             // this call's report, in pinned host memory
  long long chunk_elems;
  long long stage_elems;
  long long slot_bytes;    // one staging slot
  int world;
  int n_tiles;
  int rs;
  int ag;
  int x_own;               // all-gather alone: x is [world][chunk_elems], rank r's own chunk r
  u64 epoch;
  u64 timeout_ns;
  int fault_rank;          // that rank stops after the barrier (tests); -1: none
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

// Thread 0 spins until *flag >= target; false on overrun (reported) or when
// another block of this call has already failed.  `A` is a walk's
// arguments: its fail, report, epoch and timeout_ns.
template <class A>
__device__ bool spin_until(const u64* flag, u64 target, const A& a, int rank, int block, int step, int tile,
                           int kind) {
  const u64 start = global_ns();
  for (unsigned polls = 1;; ++polls) {
    if (ld_acquire(flag) >= target) return true;
    if ((polls & 255) == 0) {
      if (*(volatile u64*)a.fail == a.epoch) return false;
      if (global_ns() - start > a.timeout_ns) {
        // the first overrun of this call raises the failure word (an
        // earlier call's is a smaller epoch) and reports where it happened
        if (atomicMax(a.fail, a.epoch) < a.epoch) {
          volatile int* rep = a.report;
          rep[kRepKind] = kind;
          rep[kRepRank] = rank;
          rep[kRepStep] = step;
          rep[kRepTile] = tile;
          rep[kRepBlock] = block;
          __threadfence_system();
          *reinterpret_cast<volatile u64*>(a.report) = a.epoch;
          __threadfence_system();
        }
        return false;
      }
    }
  }
}

// The whole block waits for thread 0's spin; every thread gets its outcome.
template <class A>
__device__ bool block_wait(const u64* flag, u64 target, const A& a, int rank, int block, int step, int tile,
                           int kind) {
  __shared__ int ok;
  __syncthreads();  // earlier readers of `ok` are done
  if (threadIdx.x == 0) ok = spin_until(flag, target, a, rank, block, step, tile, kind);
  __syncthreads();
  return ok;
}

// The entry barrier of block b of `rank` with both neighbours (at world 2
// both are one rank, which gets both words); false if a spin ran out.
template <class A>
__device__ bool entry_barrier(u64* const* flags, const A& a, int rank, int blk) {
  const int W = a.world;
  const int right = (rank + 1) % W, left = (rank + W - 1) % W;
  u64* mine = flags[rank] + blk * kFlagWords;
  if (threadIdx.x == 0) {
    st_release(flags[right] + blk * kFlagWords + kBarFromLeft, a.epoch + 1);
    st_release(flags[left] + blk * kFlagWords + kBarFromRight, a.epoch + 1);
  }
  return block_wait(mine + kBarFromLeft, a.epoch + 1, a, rank, blk, 0, 0, kWaitBarrier) &&
         block_wait(mine + kBarFromRight, a.epoch + 1, a, rank, blk, 0, 0, kWaitBarrier);
}

// ----------------------------------------------------------------------------
// K1: the payload moves as it is, hop by hop, with no staging
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

struct RingBuffers {
  const char* x[kMaxWorld];  // rank r's input: [world][chunk_elems] (x_own: [chunk_elems])
  char* out[kMaxWorld];      // rank r's work buffer: [world][chunk_elems]
  u64* flags[kMaxWorld];     // rank r: [kMaxBlocks][kFlagWords]
};

struct DirectArgs {
  u64* fail;               // the stream's failure word
  int* report;             // this call's report, in pinned host memory
  long long chunk_elems;
  long long stage_elems;   // elements of a whole tile (the last may be shorter)
  int world;
  int n_tiles;
  int rs;
  int ag;
  int x_own;
  u64 epoch;
  u64 timeout_ns;
  int fault_rank;          // that rank stops after the barrier (tests); -1: none
};

// One hop over vectors [v0, v1) of a stripe: dst = local + landed (kAdd) or
// dst = landed; `keep`, where given, also receives what landed.  `last`: no
// rank reads dst again in this walk.
template <typename T, bool kAdd>
__device__ __forceinline__ void hop(const uint4* landed, const uint4* local, uint4* dst, uint4* keep, long long v0,
                                    long long v1, bool last) {
  for (long long v = v0 + threadIdx.x; v < v1; v += (long long)kThreads * kUnroll) {
    uint4 l[kUnroll], m[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = v + (long long)k * kThreads;
      if (i < v1) {
        l[k] = __ldcg(landed + i);
        if (kAdd) m[k] = __ldcs(local + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = v + (long long)k * kThreads;
      if (i < v1) {
        const uint4 d = kAdd ? add16<T>(m[k], l[k]) : l[k];
        if (kStreamLast && last)
          __stcs(dst + i, d);
        else
          __stcg(dst + i, d);
        if (keep) {
          if (kStreamLast)
            __stcs(keep + i, l[k]);
          else
            __stcg(keep + i, l[k]);
        }
      }
    }
  }
}

template <typename T>
__device__ void direct_walk(const RingBuffers& p, const DirectArgs& a, int nb) {
  const int W = a.world;
  const int rank = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int left = (rank + W - 1) % W;
  if (!entry_barrier(p.flags, a, rank, blk)) return;
  if (rank == a.fault_rank) return;

  const long long C = a.chunk_elems;
  const int n_rs = a.rs ? W - 1 : 0;
  const int total_steps = n_rs + (a.ag ? W - 1 : 0);
  // after RS each rank owns the reduced chunk r + 1; a pure AG starts at r
  const int own = a.rs ? 1 : 0;
  u64* ready = p.flags[rank] + blk * kFlagWords + kReady0;
  const u64* left_ready = p.flags[left] + blk * kFlagWords + kReady0;
  const T* x = reinterpret_cast<const T*>(p.x[rank]);
  T* out = reinterpret_cast<T*>(p.out[rank]);
  const T* left_out = reinterpret_cast<const T*>(p.out[left]);
  // step 0 reads the left neighbour's own input chunk; a walk with one phase
  // also writes it into the left's work buffer, which nothing lands on
  const T* left_own = reinterpret_cast<const T*>(p.x[left]) + (a.x_own ? 0 : left * C);
  T* left_keep = (a.rs && a.ag) ? nullptr : reinterpret_cast<T*>(p.out[left]) + left * C;

  const long long total_iters = (long long)total_steps * a.n_tiles;
  for (long long it = 0; it < total_iters; ++it) {
    const int step = (int)(kTileMajor ? it % total_steps : it / a.n_tiles);
    const int tile = (int)(kTileMajor ? it / total_steps : it % a.n_tiles);
    // the left neighbour's stripe of this tile at the step before, which it
    // wrote at its iteration `it - stride`
    const long long stride = kTileMajor ? 1 : a.n_tiles;
    if (step > 0 && !block_wait(left_ready, a.epoch + it - stride + 1, a, rank, blk, step, tile, kWaitData)) return;
    const bool in_rs = step < n_rs;
    const int chunk = in_rs ? (rank + 2 * W - step - 1) % W : (rank + 2 * W - 1 + own - (step - n_rs)) % W;
    const long long t0 = tile * a.stage_elems;
    const long long len = (C - t0 < a.stage_elems ? C - t0 : a.stage_elems);
    const long long vecs = len * (long long)sizeof(T) / 16;
    const long long per = (vecs + nb - 1) / nb;
    const long long v0 = blk * per < vecs ? blk * per : vecs;
    const long long v1 = v0 + per < vecs ? v0 + per : vecs;
    const uint4* src = reinterpret_cast<const uint4*>((step == 0 ? left_own : left_out + chunk * C) + t0);
    uint4* dst = reinterpret_cast<uint4*>(out + chunk * C + t0);
    uint4* keep = (step == 0 && left_keep) ? reinterpret_cast<uint4*>(left_keep + t0) : nullptr;
    const bool last = step == total_steps - 1;
    if (in_rs)
      hop<T, true>(src, reinterpret_cast<const uint4*>(x + chunk * C + t0), dst, keep, v0, v1, last);
    else
      hop<T, false>(src, nullptr, dst, keep, v0, v1, last);
    __syncthreads();
    if (threadIdx.x == 0) st_release(ready, a.epoch + it + 1);
  }
}

// ----------------------------------------------------------------------------
// K5: the slot protocol and the wire codecs
// ----------------------------------------------------------------------------

// One step of the walk, as every body sees it.
struct Hop {
  int step;
  int tile;
  int chunk;    // send_idx in ship, recv_idx in land
  bool in_rs;
};

// The fused walks' protocol: barrier, then per (step, tile) credit wait,
// body.ship into the right neighbour's slot, ready flag, data wait, body.land
// from this rank's slot, credit; then the drain.  The body moves this block's
// stripe of the tile and nothing else.
template <class Body>
__device__ void ring_protocol(const RingPeers& peers, const RingArgs& a, int nb, Body& body) {
  const int W = a.world;
  const int rank = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int right = (rank + 1) % W, left = (rank + W - 1) % W;
  u64* mine = peers.flags[rank] + blk * kFlagWords;
  u64* right_flags = peers.flags[right] + blk * kFlagWords;
  u64* left_flags = peers.flags[left] + blk * kFlagWords;
  const u64 e = a.epoch;

  if (!entry_barrier(peers.flags, a, rank, blk)) return;
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

// What every fused body knows of its rank and stripe.
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

// The wire codecs.  Each works on one unit (an int8 codec block, or 1024
// bfloat16 elements) held by one warp: lane l owns float4 l + 32 j of it.

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

// K1a: each chunk is one tile (one ready flag per step); K1b: each chunk
// streams through n_tiles tiles per step.  K5a/K5b: the slot walk with the
// codec C on the wire.  The pairs differ only in the arguments the host gives
// them; they are separate kernels so profiles name each.
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1a_kernel(RingBuffers bufs, DirectArgs a, int nb) {
  direct_walk<T>(bufs, a, nb);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1b_kernel(RingBuffers bufs, DirectArgs a, int nb) {
  direct_walk<T>(bufs, a, nb);
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

// What a cooperative launch of `kernel` on the current device may use: the
// SMs times the blocks of kThreads that fit on one.  Queried once per
// (kernel, device) and kept.
cudaError_t resident_blocks(const void* kernel, int* out) {
  struct Entry {
    const void* kernel;
    int dev;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, coop = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (n < 64) cache[n++] = Entry{kernel, dev, per_sm * sms};
  *out = per_sm * sms;
  return cudaSuccess;
}

// Launch `kernel` cooperatively on `device` with `want` blocks per rank, or
// as many as can be co-resident, at most `cap`; then record `done` (a
// cudaEvent_t, or null) behind it on the stream.  The caller's current
// device is restored.
int launch(const void* kernel, void** args, int* nb, int world, long long want, int cap, int device, void* done,
           void* stream) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = resident_blocks(kernel, &resident);
  const long long fit = resident / world;  // co-resident blocks per rank
  if (e == cudaSuccess && fit < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) {
    if (want < 1) want = 1;
    *nb = (int)(want < fit ? want : fit);
    if (*nb > cap) *nb = cap;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    e = cudaLaunchCooperativeKernel(kernel, dim3(world * *nb), dim3(kThreads), args, 0, s);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e == cudaSuccess && done) e = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}

int launch_k1(bool streamed, const void* x, void* out, void* flags, void* fail, void* report, int world,
              long long chunk_elems, long long stage_elems, int rs, int ag, int x_own, int is_bf16, u64 epoch,
              u64 timeout_ns, int fault_rank, int device, void* done, void* stream) {
  const long long elem_bytes = is_bf16 ? 2 : 4;
  if (world < 2 || world > kMaxWorld || !(rs || ag) || (x_own && (rs || !ag))) return (int)cudaErrorInvalidValue;
  if (chunk_elems < 1 || stage_elems < 1 || stage_elems > chunk_elems || (chunk_elems * elem_bytes) % 16 ||
      (stage_elems * elem_bytes) % 16)
    return (int)cudaErrorInvalidValue;
  const void* kernel = streamed ? (is_bf16 ? (const void*)ring_k1b_kernel<__nv_bfloat16>
                                           : (const void*)ring_k1b_kernel<float>)
                                : (is_bf16 ? (const void*)ring_k1a_kernel<__nv_bfloat16>
                                           : (const void*)ring_k1a_kernel<float>);
  DirectArgs a;
  a.fail = static_cast<u64*>(fail);
  a.report = static_cast<int*>(report);
  a.chunk_elems = chunk_elems;
  a.stage_elems = stage_elems;
  a.world = world;
  a.n_tiles = (int)((chunk_elems + stage_elems - 1) / stage_elems);
  a.rs = rs;
  a.ag = ag;
  a.x_own = x_own;
  a.epoch = epoch;
  a.timeout_ns = timeout_ns;
  a.fault_rank = fault_rank;
  // single controller: every rank's buffers are slices of one allocation
  RingBuffers bufs;
  const long long rank_bytes = world * chunk_elems * elem_bytes;
  const long long x_bytes = x_own ? chunk_elems * elem_bytes : rank_bytes;
  for (int r = 0; r < kMaxWorld; ++r) {
    const bool in = r < world;
    bufs.x[r] = in ? static_cast<const char*>(x) + r * x_bytes : nullptr;
    bufs.out[r] = in ? static_cast<char*>(out) + r * rank_bytes : nullptr;
    bufs.flags[r] = in ? static_cast<u64*>(flags) + (long long)r * kMaxBlocks * kFlagWords : nullptr;
  }
  // at least one vector a thread in each block's stripe of a tile
  const long long want = (stage_elems * elem_bytes / 16 + kThreads - 1) / kThreads;
  int nb = 0;
  void* args[] = {&bufs, &a, &nb};
  return launch(kernel, args, &nb, world, want, kMaxBlocks, device, done, stream);
}

int launch_k5(bool streamed, const void* x, void* out, void* slots, void* store, void* flags, void* fail,
              void* report, int world, long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag,
              int x_own, int wire, int block_size, long long slot_bytes, u64 epoch, u64 timeout_ns,
              int fault_rank, int device, void* done, void* stream) {
  if (world < 2 || world > kMaxWorld) return (int)cudaErrorInvalidValue;
  if (x_own && (rs || !ag)) return (int)cudaErrorInvalidValue;
  if (slot_bytes % 16 || chunk_elems != stage_elems * n_tiles) return (int)cudaErrorInvalidValue;
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
  RingArgs a;
  a.x = x;
  a.out = out;
  a.fail = static_cast<u64*>(fail);
  a.report = static_cast<int*>(report);
  a.chunk_elems = chunk_elems;
  a.stage_elems = stage_elems;
  a.slot_bytes = slot_bytes;
  a.world = world;
  a.n_tiles = n_tiles;
  a.rs = rs;
  a.ag = ag;
  a.x_own = x_own;
  a.epoch = epoch;
  a.timeout_ns = timeout_ns;
  a.fault_rank = fault_rank;
  a.store = static_cast<char*>(store);
  a.block_size = block_size;
  // single controller: every rank's slots and flags are slices of one buffer
  RingPeers peers;
  for (int r = 0; r < kMaxWorld; ++r) {
    const bool in = r < world;
    peers.slots[r] = in ? static_cast<char*>(slots) + (long long)r * 2 * slot_bytes : nullptr;
    peers.flags[r] = in ? static_cast<u64*>(flags) + (long long)r * kMaxBlocks * kFlagWords : nullptr;
  }
  // stripes of at least kMinVecsPerBlock float32 vectors, of whole units
  long long want = stage_elems * 4 / 16 / kMinVecsPerBlock;
  if (want > stage_elems / unit) want = stage_elems / unit;
  int nb = 0;
  void* args[] = {&peers, &a, &nb};
  return launch(kernel, args, &nb, world, want, kFusedMaxBlocks, device, done, stream);
}

}  // namespace

extern "C" {

int adapcc_ring_k1a(const void* x, void* out, void* flags, void* fail, void* report, int world,
                    long long chunk_elems, int rs, int ag, int x_own, int is_bf16, u64 epoch, u64 timeout_ns,
                    int fault_rank, int device, void* done, void* stream) {
  return launch_k1(false, x, out, flags, fail, report, world, chunk_elems, chunk_elems, rs, ag, x_own, is_bf16,
                   epoch, timeout_ns, fault_rank, device, done, stream);
}

int adapcc_ring_k1b(const void* x, void* out, void* flags, void* fail, void* report, int world,
                    long long chunk_elems, long long stage_elems, int rs, int ag, int x_own, int is_bf16,
                    u64 epoch, u64 timeout_ns, int fault_rank, int device, void* done, void* stream) {
  return launch_k1(true, x, out, flags, fail, report, world, chunk_elems, stage_elems, rs, ag, x_own, is_bf16,
                   epoch, timeout_ns, fault_rank, device, done, stream);
}

int adapcc_ring_k5a(const void* x, void* out, void* slots, void* store, void* flags, void* fail, void* report,
                    int world, long long chunk_elems, int rs, int ag, int x_own, int wire, int block_size,
                    long long slot_bytes, u64 epoch, u64 timeout_ns, int fault_rank, int device, void* done,
                    void* stream) {
  return launch_k5(false, x, out, slots, store, flags, fail, report, world, chunk_elems, chunk_elems, 1, rs, ag,
                   x_own, wire, block_size, slot_bytes, epoch, timeout_ns, fault_rank, device, done, stream);
}

int adapcc_ring_k5b(const void* x, void* out, void* slots, void* store, void* flags, void* fail, void* report,
                    int world, long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag,
                    int x_own, int wire, int block_size, long long slot_bytes, u64 epoch, u64 timeout_ns,
                    int fault_rank, int device, void* done, void* stream) {
  return launch_k5(true, x, out, slots, store, flags, fail, report, world, chunk_elems, stage_elems, n_tiles, rs,
                   ag, x_own, wire, block_size, slot_bytes, epoch, timeout_ns, fault_rank, device, done, stream);
}

const char* adapcc_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
