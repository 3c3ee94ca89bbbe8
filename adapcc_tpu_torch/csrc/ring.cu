// Ring reduce-scatter / all-gather for Hopper (sm_90a): kernels K1a, K1b,
// and their fused wire-codec forms K5a, K5b.
//
// Replaces adapcc_tpu/comm/pallas_ring.py::_ring_kernel (K1a, each chunk in
// one stage: the planner's "vmem" path), ::_stream_ring_kernel (K1b, each
// chunk streamed in [stage_rows, 128] tiles: "hbm-stream"),
// ::_fused_ring_kernel (K5a) and ::_fused_stream_ring_kernel (K5b): the same
// two walks with a wire codec (int8 codes + a float32 scale per block, or
// bfloat16) on every hop.
//
// What they compute is the Pallas kernels' function, not their block
// structure.  The payload of rank r is x[r] = [world chunks][chunk_elems],
// chunk-major; for an all-gather alone x[r] may be only its own chunk r
// (`x_own`), the one chunk of x that walk reads.  Reduce-scatter takes world-1
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
// Both families run one walk (`walk` below).  A hop's result is written once,
// into a buffer of the rank that computed it, where the right neighbour reads
// it ("pull").  The only signal is one ready counter per (rank, block),
// released after the block's stores of each (phase, tile).  A rank walks its
// (phase, tile) iterations tile-major, every phase of tile t before tile t+1,
// so the right neighbour reads what was written one iteration before, from
// L2; each block's stripe of a tile is recomputed from the tile's real length
// on every rank alike, so block b of two neighbours covers the same elements
// and the last tile of a chunk may be ragged.  No staging slot, no credit, no
// drain: the right neighbour reads in place.
//
// K1 (the payload as it is).  Rank r reads the landed partial from out[r-1]
// (step 0: the left's input chunk, straight from x) and its own input term,
// and writes out[r] once.  A walk with one phase never lands on a rank's own
// chunk, so the right neighbour writes out[r][r] as it reads x[r][r] at step
// 0: no own-chunk copy re-reads the input.
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
//   - Bytes (world W, chunk C, RS = reduce-scatter alone): the function reads
//     each input once and writes each result once (the bound's (W+1) C per
//     rank for RS or AG alone).  The walk moves 3 C a reduce-scatter hop and
//     2 C an all-gather hop, plus the folded own chunk (1 C): RS (3 (W-1) + 1)
//     C and AG (2 (W-1) + 1) C per rank, 40 C and 28 C at world 4, of which
//     the partials read back (W-2 C a rank) mostly hit L2.  Each thread keeps
//     kUnroll 16-byte loads of each operand in flight (L2-cached, past L1: the
//     landed data was written by another SM); stores no rank reads again in
//     the walk are marked evict-first.
//
// K5 (float32 payloads, a codec on the wire).  Only wire bytes (codes and
// scales) cross from one rank to another: a rank reads no float32 data of
// another rank.  Each rank r has a wire buffer wire[r] = [world chunks], each
// chunk its codes (chunk_elems int8 or bfloat16 values) then, for int8, one
// float32 scale per block.  The walk has one phase more than K1's, a
// prologue, and then per tile:
//   phase 0, the prologue: encode the chunk r sends first (its own input
//     chunk r) into wire[r][r]; an all-gather alone also writes the decoded
//     values to out[r][r] (the owner adopts its own encode);
//   reduce-scatter step s (phase 1+s), chunk c = r-s-1: read wire[r-1][c]
//     and x[r][c], sum = local + q*s in registers (two roundings:
//     __fadd_rn(local, __fmul_rn(q, s)), so nvcc cannot contract an FMA and
//     the plain torch version's multiply-then-add gives the same bits); then
//     encode sum into wire[r][c] for the right neighbour, except at the last
//     step, where a reduce-scatter alone writes the float32 sum (its owned
//     chunk r+1, the launch's only output) and a reduce-scatter + all-gather
//     encodes sum once, into wire[r][c], and adopts the decoded values in
//     out[r][c];
//   all-gather step k (phase 1+n_rs+k), chunk c = r+own-k-1 (own: 1 after a
//     reduce-scatter, else 0): read wire[r-1][c], write the decoded values to
//     out[r][c] and, unless k is the last step, the same bits unchanged into
//     wire[r][c]: every rank ends with the owner's bits by construction.
//   - Counters: phase p of tile t reads what the left neighbour wrote at
//     phase p-1 of tile t (its prologue for p = 1), so the wait target is
//     K1's, epoch + it - stride + 1, with the prologue counted as a phase.
//   - No credit: only wire[r][c] in a reduce-scatter + all-gather walk is
//     written twice, for every chunk c that r forwards (c = r, r-1, ...,
//     r-W+3: r's prologue or reduce-scatter encode, then its all-gather
//     forward).  The right neighbour reads the first value at its next
//     phase, before it releases its counter; chunk c's reduce-scatter goes
//     on from there through r+2, ..., the owner c-1 (each acquires the
//     counter of the rank before it), and its all-gather back through c,
//     ..., r-1, whose counter rank r acquires before its forward overwrites
//     wire[r][c].  The owner's chunk is never forwarded by the owner, and at
//     world 2 nothing is forwarded.  Every other wire and out location is
//     written once a call.
//   - The codec is quant/codec.py's: per block of `block_size` elements
//     (128, 256, 512 or 1024), scale = absmax / 127 (1 for an all-zero
//     block), q = clip(rint(x / scale), -127, 127), both divisions IEEE
//     (__fdiv_rn), rint rounding half to even as torch.round and jnp.round
//     do; bfloat16 is __float2bfloat16_rn out and an exact widening back.
//     A warp codes a batch of 1024 elements (kUnroll float4 a lane: whole
//     codec units), so each thread keeps 8 16-byte loads of the float32
//     operand in flight; a unit's absmax is a max over its slots, then a
//     __shfl_xor_sync max over the warp.  A block's stripe of a tile is
//     whole batches (a chunk is whole 1024-element tiles), so no reduction
//     crosses thread blocks.
//   - Bytes per rank (C one float32 chunk, w its wire: (1/4 + 1/block) C on
//     int8, C/2 on bfloat16): prologue C + w; a reduce-scatter step C + 2w
//     (the last, with an all-gather after it, 2C + 2w; alone 2C + w); an
//     all-gather step C + 2w (the last C + w).  Int8 at block 256, world 4:
//     RS + AG 8 C + 12 w = 11.05 C a rank, RS or AG alone 3 C + 2 w + 2 (C +
//     2 w) = 6.5 C, against the bound's 8 C and 5 C.
//
// comm/ring_sweep.py times each choice undone (K1: step-major order, 2 or 4
// loads in flight, plain stores, TMA bulk copies into shared memory; K5:
// step-major order, one codec unit a warp in flight, at most 64 blocks a
// rank).
//
// Single-controller form: one launch walks the ring for every rank.  Rank r
// is a group of `nb` thread blocks; block b of rank r talks only to block b
// of ranks r-1 and r+1, over its stripe of every tile.  A rank's only view
// of its neighbours is a table of device pointers (RingBuffers: each rank's
// input, output, wire buffer and flag words), what one CUDA IPC registration
// of persistent buffers gives one process per card.  Every flag value is
// `epoch + k` for a per-call epoch above anything an earlier call wrote, so
// no reset pass runs between calls.  An entry barrier with both neighbours
// opens every walk.  The flags use .gpu scope: every rank is on this card.
// The per-process IPC form needs .sys scope on every flag access.
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
// 16-byte loads of each operand a thread keeps in flight (K5: of the float32
// operand; a warp's batch is kUnroll float4 a lane, 1024 elements)
constexpr int kUnroll = 8;
// the order of a rank's (phase, tile) iterations.  Tile-major walks every
// phase of tile t before tile t + 1, so the right neighbour reads what was
// written one iteration before, while it is still in L2; step-major walks
// every tile of a phase first.
constexpr bool kTileMajor = true;
// K1: a store no rank reads again in the walk (the last step's, the folded
// own chunk) is marked evict-first in L2, leaving L2 to the partials
constexpr bool kStreamLast = true;
// K5: a warp codes one unit at a time instead of a batch of 1024 elements
// (ring_sweep's "one_unit")
constexpr bool kOneUnit = false;
// K5: elements of a warp's batch, and of a unit of a bfloat16 wire
constexpr int kBatchElems = kUnroll * 32 * 4;
constexpr int kBf16Unit = 1024;
// wire codecs (comm/ring.py _WIRE_CODES)
enum { kWireInt8 = 1, kWireBf16 = 2 };

// flag words of one (rank, block) record: the ready counter (its completed
// iterations), and the entry barrier's word from each neighbour
enum { kReady = 0, kBarFromLeft = 1, kBarFromRight = 2 };
// what a spin waited for (comm/ring.py _WAITS)
enum { kWaitBarrier = 1, kWaitData = 2 };
// a report (comm/ring.py _REPORT_WORDS int32): a u64 tag (the epoch of the
// call that failed), then kind, rank, step, tile, block
enum { kRepKind = 2, kRepRank = 3, kRepStep = 4, kRepTile = 5, kRepBlock = 6 };

typedef unsigned long long u64;

struct RingBuffers {
  const char* x[kMaxWorld];  // rank r's input: [world][chunk_elems] (x_own: [chunk_elems])
  char* out[kMaxWorld];      // rank r's output: [world][chunk_elems] (K5, RS alone: its owned chunk)
  char* wire[kMaxWorld];     // K5: rank r's wire buffer, [world][chunk_wire_bytes]
  u64* flags[kMaxWorld];     // rank r: [kMaxBlocks][kFlagWords]
};

struct RingArgs {
  u64* fail;                 // the stream's failure word
  int* report;               // this call's report, in pinned host memory
  long long chunk_elems;
  long long stage_elems;     // elements of a whole tile (the last may be shorter)
  long long chunk_wire_bytes;  // K5: one chunk's codes, then (int8) its scales
  int world;
  int n_tiles;
  int rs;
  int ag;
  int x_own;
  int block_size;            // K5, int8: elements per scale
  u64 epoch;
  u64 timeout_ns;
  int fault_rank;            // that rank stops after the barrier (tests); -1: none
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
// another block of this call has already failed.
__device__ bool spin_until(const u64* flag, u64 target, const RingArgs& a, int rank, int block, int step,
                           int tile, int kind) {
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
__device__ bool block_wait(const u64* flag, u64 target, const RingArgs& a, int rank, int block, int step, int tile,
                           int kind) {
  __shared__ int ok;
  __syncthreads();  // earlier readers of `ok` are done
  if (threadIdx.x == 0) ok = spin_until(flag, target, a, rank, block, step, tile, kind);
  __syncthreads();
  return ok;
}

// The walk of block `blk` of `rank`: the entry barrier with both neighbours
// (at world 2 both are one rank, which gets both words), then the rank's
// `phases` x n_tiles iterations, in order.  Iteration `it` of a phase after
// the first waits for the left neighbour's counter to cover its iteration on
// the same tile at the phase before (its iteration `it - stride`), runs
// body(phase, tile) over this block's stripe, and releases this block's
// counter.  `prologue` phases come before the ring's first step (reports
// count steps).
template <class Body>
__device__ void walk(u64* const* flags, const RingArgs& a, int rank, int blk, int prologue, int phases,
                     const Body& body) {
  const int W = a.world;
  const int right = (rank + 1) % W, left = (rank + W - 1) % W;
  u64* mine = flags[rank] + blk * kFlagWords;
  if (threadIdx.x == 0) {
    st_release(flags[right] + blk * kFlagWords + kBarFromLeft, a.epoch + 1);
    st_release(flags[left] + blk * kFlagWords + kBarFromRight, a.epoch + 1);
  }
  if (!block_wait(mine + kBarFromLeft, a.epoch + 1, a, rank, blk, 0, 0, kWaitBarrier) ||
      !block_wait(mine + kBarFromRight, a.epoch + 1, a, rank, blk, 0, 0, kWaitBarrier))
    return;
  if (rank == a.fault_rank) return;

  const u64* left_ready = flags[left] + blk * kFlagWords + kReady;
  const long long total = (long long)phases * a.n_tiles;
  const long long stride = kTileMajor ? 1 : a.n_tiles;
  for (long long it = 0; it < total; ++it) {
    const int phase = (int)(kTileMajor ? it % phases : it / a.n_tiles);
    const int tile = (int)(kTileMajor ? it / phases : it % a.n_tiles);
    if (phase > 0 && !block_wait(left_ready, a.epoch + it - stride + 1, a, rank, blk, phase - prologue, tile,
                                 kWaitData))
      return;
    body(phase, tile);
    __syncthreads();
    if (threadIdx.x == 0) st_release(mine + kReady, a.epoch + it + 1);
  }
}

// ----------------------------------------------------------------------------
// K1: the payload moves as it is, hop by hop
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
__device__ void direct_walk(const RingBuffers& p, const RingArgs& a, int nb) {
  const int W = a.world;
  const int rank = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int left = (rank + W - 1) % W;
  const long long C = a.chunk_elems;
  const int n_rs = a.rs ? W - 1 : 0;
  const int total_steps = n_rs + (a.ag ? W - 1 : 0);
  // after RS each rank owns the reduced chunk r + 1; a pure AG starts at r
  const int own = a.rs ? 1 : 0;
  const T* x = reinterpret_cast<const T*>(p.x[rank]);
  T* out = reinterpret_cast<T*>(p.out[rank]);
  const T* left_out = reinterpret_cast<const T*>(p.out[left]);
  // step 0 reads the left neighbour's own input chunk; a walk with one phase
  // also writes it into the left's work buffer, which nothing lands on
  const T* left_own = reinterpret_cast<const T*>(p.x[left]) + (a.x_own ? 0 : left * C);
  T* left_keep = (a.rs && a.ag) ? nullptr : reinterpret_cast<T*>(p.out[left]) + left * C;

  walk(p.flags, a, rank, blk, 0, total_steps, [&](int step, int tile) {
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
  });
}

// ----------------------------------------------------------------------------
// K5: the same walk with a wire codec
// ----------------------------------------------------------------------------

// The wire codecs.  A warp works on a batch of `vpl` float4 a lane: slot j of
// lane l is float4 32 j + l of the batch, a Word of codes per float4, and a
// codec unit (an int8 block, or 1024 bfloat16 elements) is `nv` consecutive
// slots.  `s[j]` is the scale of slot j's unit.

struct Int8Wire {
  static constexpr bool kScaled = true;
  static constexpr int kBytes = 1;
  typedef uint32_t Word;  // the codes of one float4

  __device__ static float value(Word w, int k, float s) {
    return __fmul_rn((float)(signed char)((w >> (8 * k)) & 0xff), s);
  }
  __device__ static float4 decode(Word w, float s) {
    return make_float4(value(w, 0, s), value(w, 1, s), value(w, 2, s), value(w, 3, s));
  }
  __device__ static int code(float x, float s) {
    return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
  }

  // codes w and per-slot scales s of v: each unit's absmax is a max over its
  // nv slots (a butterfly over slot indices known at compile time), then over
  // the warp, for the first slot of each unit only; its scale is then copied
  // to the unit's other slots
  __device__ static void encode(const float4 (&v)[kUnroll], Word (&w)[kUnroll], float (&s)[kUnroll], int vpl,
                                int nv) {
    float m[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      m[j] = j < vpl ? fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)), fmaxf(fabsf(v[j].z), fabsf(v[j].w))) : 0.0f;
#pragma unroll
    for (int d = 1; d < kUnroll; d <<= 1)
      if (d < nv) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          if (!(j & d)) m[j] = fmaxf(m[j], m[j | d]);
      }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (j < vpl && !(j & (nv - 1))) {
#pragma unroll
        for (int off = 16; off; off >>= 1) m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
        s[j] = m[j] > 0.0f ? __fdiv_rn(m[j], 127.0f) : 1.0f;
      }
#pragma unroll
    for (int d = kUnroll / 2; d; d >>= 1)
      if (d < nv) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          if (j & d) s[j] = s[j ^ d];
      }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (j < vpl) {
        const int q0 = code(v[j].x, s[j]), q1 = code(v[j].y, s[j]), q2 = code(v[j].z, s[j]),
                  q3 = code(v[j].w, s[j]);
        w[j] = (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
               ((uint32_t)(q3 & 0xff) << 24);
      }
  }
};

struct Bf16Wire {
  static constexpr bool kScaled = false;
  static constexpr int kBytes = 2;
  typedef uint2 Word;  // the bfloat16 values of one float4

  __device__ static float4 decode(Word w, float) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  __device__ static void encode(const float4 (&v)[kUnroll], Word (&w)[kUnroll], float (&)[kUnroll], int vpl,
                                int) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (j < vpl) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[j].x, v[j].y),
                             hi = __floats2bfloat162_rn(v[j].z, v[j].w);
        w[j] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      }
  }
};

// What one K5 hop reads and writes, each at the tile's start: float4 (the
// payload), Word (codes, one per float4) and float (int8 scales, one per
// unit).  Null where the hop does not touch it.
template <class C>
struct FusedTile {
  const float4* local;               // this rank's input term
  const typename C::Word* landed;    // the left neighbour's wire
  const float* landed_scales;
  typename C::Word* mine;            // this rank's wire, for the right neighbour
  float* mine_scales;
  float4* out;
};

// One K5 hop over batches [b0, b1) of a tile, each warp a batch at a time:
// v = local (kLocal), + decoded landed wire (kLanded); the landed bits
// forwarded unchanged (kFwd); v encoded into this rank's wire and, where it
// is also stored, replaced by its decoded value (kEncode); v stored (kOut).
template <class C, bool kLocal, bool kLanded, bool kEncode, bool kFwd, bool kOut>
__device__ __forceinline__ void fused_hop(const FusedTile<C>& t, long long b0, long long b1, int vpl, int nv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = vpl / nv;  // codec units a batch
  [[maybe_unused]] const int lg = __ffs(nv) - 1;  // slot j is in the batch's unit j >> lg
  for (long long b = b0 + warp; b < b1; b += kWarps) {
    const long long f0 = b * vpl * 32 + lane;  // slot 0 of this lane
    const long long u0 = b * units;            // the batch's first unit
    float4 v[kUnroll];
    typename C::Word w[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) s[j] = 1.0f;
    float lane_scale = 1.0f;  // lane u < units: the scale of unit u
    if (kLanded) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < vpl) w[j] = __ldcg(t.landed + f0 + 32 * j);
      if constexpr (C::kScaled) {
        if (lane < units) lane_scale = __ldcg(t.landed_scales + u0 + lane);
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) s[j] = __shfl_sync(0xffffffffu, lane_scale, j >> lg);
      }
    }
    if (kLocal) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < vpl) v[j] = __ldcs(t.local + f0 + 32 * j);
    }
    if (kLanded) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < vpl) {
          const float4 d = C::decode(w[j], s[j]);
          v[j] = kLocal ? make_float4(__fadd_rn(v[j].x, d.x), __fadd_rn(v[j].y, d.y), __fadd_rn(v[j].z, d.z),
                                      __fadd_rn(v[j].w, d.w))
                        : d;
        }
    }
    if (kFwd) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < vpl) __stcg(t.mine + f0 + 32 * j, w[j]);
      if constexpr (C::kScaled)
        if (lane < units) __stcg(t.mine_scales + u0 + lane, lane_scale);
    }
    if (kEncode) {
      C::encode(v, w, s, vpl, nv);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < vpl) __stcg(t.mine + f0 + 32 * j, w[j]);
      if constexpr (C::kScaled) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          if ((j >> lg) == lane) lane_scale = s[j];
        if (lane < units) __stcg(t.mine_scales + u0 + lane, lane_scale);
      }
      if (kOut) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          if (j < vpl) v[j] = C::decode(w[j], s[j]);
      }
    }
    if (kOut) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (j < vpl) __stcs(t.out + f0 + 32 * j, v[j]);
    }
  }
}

template <class C>
__device__ void fused_walk(const RingBuffers& p, const RingArgs& a, int nb) {
  typedef typename C::Word Word;
  const int W = a.world;
  const int rank = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int left = (rank + W - 1) % W;
  const long long Cn = a.chunk_elems;
  const int unit = C::kScaled ? a.block_size : kBf16Unit;
  const int nv = unit / 128;                  // slots of a unit
  const int vpl = kOneUnit ? nv : kUnroll;    // slots of a batch
  const long long batch = (long long)vpl * 128;
  const int n_rs = a.rs ? W - 1 : 0, n_ag = a.ag ? W - 1 : 0;
  // after RS each rank owns the reduced chunk r + 1; a pure AG starts at r
  const int own = a.rs ? 1 : 0;
  const float* x = reinterpret_cast<const float*>(p.x[rank]);
  float* out = reinterpret_cast<float*>(p.out[rank]);
  char* mine = p.wire[rank];
  const char* landed = p.wire[left];

  walk(p.flags, a, rank, blk, 1, 1 + n_rs + n_ag, [&](int phase, int tile) {
    const long long t0 = tile * a.stage_elems;
    const long long len = (Cn - t0 < a.stage_elems ? Cn - t0 : a.stage_elems);
    const long long n_batches = len / batch;
    const long long per = (n_batches + nb - 1) / nb;
    const long long b0 = blk * per < n_batches ? blk * per : n_batches;
    const long long b1 = b0 + per < n_batches ? b0 + per : n_batches;
    // chunk c's codes and scales of this tile in a wire buffer
    auto codes = [&](const char* wire, int c) {
      return reinterpret_cast<Word*>(const_cast<char*>(wire) + c * a.chunk_wire_bytes) + t0 / 4;
    };
    auto scales = [&](const char* wire, int c) {
      return C::kScaled ? reinterpret_cast<float*>(const_cast<char*>(wire) + c * a.chunk_wire_bytes +
                                                   Cn * C::kBytes) + t0 / unit
                        : nullptr;
    };
    auto payload = [&](const float* base, int c) { return reinterpret_cast<const float4*>(base + c * Cn + t0); };
    auto dst = [&](int c) { return reinterpret_cast<float4*>(out + c * Cn + t0); };
    if (phase == 0) {  // the prologue: encode the chunk this rank sends first
      const float4* local = reinterpret_cast<const float4*>(x + (a.x_own ? 0 : rank * Cn) + t0);
      const FusedTile<C> t{local, nullptr, nullptr, codes(mine, rank), scales(mine, rank), dst(rank)};
      if (a.rs)
        fused_hop<C, true, false, true, false, false>(t, b0, b1, vpl, nv);
      else  // an all-gather alone: the owner adopts its own encode
        fused_hop<C, true, false, true, false, true>(t, b0, b1, vpl, nv);
    } else if (phase <= n_rs) {
      const int step = phase - 1;
      const int c = (rank + 2 * W - step - 1) % W;
      const FusedTile<C> t{payload(x, c), codes(landed, c), scales(landed, c), codes(mine, c), scales(mine, c),
                           dst(c)};
      if (step < n_rs - 1)
        fused_hop<C, true, true, true, false, false>(t, b0, b1, vpl, nv);
      else if (!a.ag)  // the float32 sum of the owned chunk, out[r]'s one chunk
        fused_hop<C, true, true, false, false, true>(FusedTile<C>{t.local, t.landed, t.landed_scales, nullptr,
                                                                  nullptr, dst(0)},
                                                     b0, b1, vpl, nv);
      else  // the one encode of the owned chunk, which its owner adopts
        fused_hop<C, true, true, true, false, true>(t, b0, b1, vpl, nv);
    } else {
      const int step = phase - 1 - n_rs;
      const int c = (rank + 2 * W + own - step - 1) % W;
      const FusedTile<C> t{nullptr, codes(landed, c), scales(landed, c), codes(mine, c), scales(mine, c), dst(c)};
      if (step < n_ag - 1)
        fused_hop<C, false, true, false, true, true>(t, b0, b1, vpl, nv);
      else
        fused_hop<C, false, true, false, false, true>(t, b0, b1, vpl, nv);
    }
  });
}

// K1a: each chunk is one tile; K1b: each chunk streams through n_tiles tiles
// per step.  K5a/K5b: the same with the codec C on the wire.  The pairs
// differ only in the arguments the host gives them; they are separate
// kernels so profiles name each.
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1a_kernel(RingBuffers bufs, RingArgs a, int nb) {
  direct_walk<T>(bufs, a, nb);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1b_kernel(RingBuffers bufs, RingArgs a, int nb) {
  direct_walk<T>(bufs, a, nb);
}

template <class C>
__global__ void __launch_bounds__(kThreads) ring_k5a_kernel(RingBuffers bufs, RingArgs a, int nb) {
  fused_walk<C>(bufs, a, nb);
}

template <class C>
__global__ void __launch_bounds__(kThreads) ring_k5b_kernel(RingBuffers bufs, RingArgs a, int nb) {
  fused_walk<C>(bufs, a, nb);
}

// Bytes of one chunk of a K5 wire buffer: the codes, then (int8) one float32
// scale per block, rounded up to 16 bytes (comm/ring.py _fused_slot_bytes).
long long fused_chunk_bytes(long long chunk_elems, int wire, int block_size) {
  long long b = chunk_elems * (wire == kWireInt8 ? 1 : 2);
  if (wire == kWireInt8) b += chunk_elems / block_size * 4;
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
// as many as can be co-resident, at most kMaxBlocks; then record `done` (a
// cudaEvent_t, or null) behind it on the stream.  The caller's current
// device is restored.
int launch(const void* kernel, void** args, int* nb, int world, long long want, int device, void* done,
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
    if (want > kMaxBlocks) want = kMaxBlocks;
    *nb = (int)(want < fit ? want : fit);
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

// The arguments every walk shares, and each rank's buffers as slices of one
// allocation per kind (single controller); wire may be null (K1).
void fill(RingArgs* a, RingBuffers* bufs, const void* x, void* out, void* wire, void* flags, void* fail,
          void* report, int world, long long chunk_elems, long long stage_elems, int rs, int ag, int x_own,
          long long elem_bytes, long long out_rank_bytes, long long wire_rank_bytes, u64 epoch, u64 timeout_ns,
          int fault_rank) {
  a->fail = static_cast<u64*>(fail);
  a->report = static_cast<int*>(report);
  a->chunk_elems = chunk_elems;
  a->stage_elems = stage_elems;
  a->chunk_wire_bytes = 0;
  a->world = world;
  a->n_tiles = (int)((chunk_elems + stage_elems - 1) / stage_elems);
  a->rs = rs;
  a->ag = ag;
  a->x_own = x_own;
  a->block_size = 0;
  a->epoch = epoch;
  a->timeout_ns = timeout_ns;
  a->fault_rank = fault_rank;
  const long long x_bytes = (x_own ? 1 : world) * chunk_elems * elem_bytes;
  for (int r = 0; r < kMaxWorld; ++r) {
    const bool in = r < world;
    bufs->x[r] = in ? static_cast<const char*>(x) + r * x_bytes : nullptr;
    bufs->out[r] = in ? static_cast<char*>(out) + r * out_rank_bytes : nullptr;
    bufs->wire[r] = in && wire ? static_cast<char*>(wire) + r * wire_rank_bytes : nullptr;
    bufs->flags[r] = in ? static_cast<u64*>(flags) + (long long)r * kMaxBlocks * kFlagWords : nullptr;
  }
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
  RingArgs a;
  RingBuffers bufs;
  fill(&a, &bufs, x, out, nullptr, flags, fail, report, world, chunk_elems, stage_elems, rs, ag, x_own, elem_bytes,
       world * chunk_elems * elem_bytes, 0, epoch, timeout_ns, fault_rank);
  // at least one vector a thread in each block's stripe of a tile
  const long long want = (stage_elems * elem_bytes / 16 + kThreads - 1) / kThreads;
  int nb = 0;
  void* args[] = {&bufs, &a, &nb};
  return launch(kernel, args, &nb, world, want, device, done, stream);
}

int launch_k5(bool streamed, const void* x, void* out, void* wire, void* flags, void* fail, void* report, int world,
              long long chunk_elems, long long stage_elems, int rs, int ag, int x_own, int wire_code,
              int block_size, long long chunk_wire_bytes, u64 epoch, u64 timeout_ns, int fault_rank, int device,
              void* done, void* stream) {
  if (world < 2 || world > kMaxWorld || !(rs || ag) || (x_own && (rs || !ag))) return (int)cudaErrorInvalidValue;
  const bool int8 = wire_code == kWireInt8;
  if (!int8 && wire_code != kWireBf16) return (int)cudaErrorInvalidValue;
  const int unit = int8 ? block_size : kBf16Unit;
  if (unit != 128 && unit != 256 && unit != 512 && unit != 1024) return (int)cudaErrorInvalidValue;
  // every tile, the ragged last one too, is whole warp batches (whole units)
  if (chunk_elems < 1 || stage_elems < 1 || stage_elems > chunk_elems || chunk_elems % kBatchElems ||
      stage_elems % kBatchElems || wire == nullptr ||
      chunk_wire_bytes != fused_chunk_bytes(chunk_elems, wire_code, block_size))
    return (int)cudaErrorInvalidValue;
  const void* kernel = streamed ? (int8 ? (const void*)ring_k5b_kernel<Int8Wire>
                                        : (const void*)ring_k5b_kernel<Bf16Wire>)
                                : (int8 ? (const void*)ring_k5a_kernel<Int8Wire>
                                        : (const void*)ring_k5a_kernel<Bf16Wire>);
  RingArgs a;
  RingBuffers bufs;
  // a reduce-scatter alone returns each rank's owned chunk only
  const long long out_rank_bytes = (rs && !ag ? 1 : world) * chunk_elems * 4;
  fill(&a, &bufs, x, out, wire, flags, fail, report, world, chunk_elems, stage_elems, rs, ag, x_own, 4,
       out_rank_bytes, world * chunk_wire_bytes, epoch, timeout_ns, fault_rank);
  a.chunk_wire_bytes = chunk_wire_bytes;
  a.block_size = block_size;
  // at least one batch a warp in each block's stripe of a tile
  long long want = (stage_elems / kBatchElems + kWarps - 1) / kWarps;
  int nb = 0;
  void* args[] = {&bufs, &a, &nb};
  return launch(kernel, args, &nb, world, want, device, done, stream);
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

int adapcc_ring_k5a(const void* x, void* out, void* wire, void* flags, void* fail, void* report, int world,
                    long long chunk_elems, int rs, int ag, int x_own, int wire_code, int block_size,
                    long long chunk_wire_bytes, u64 epoch, u64 timeout_ns, int fault_rank, int device, void* done,
                    void* stream) {
  return launch_k5(false, x, out, wire, flags, fail, report, world, chunk_elems, chunk_elems, rs, ag, x_own,
                   wire_code, block_size, chunk_wire_bytes, epoch, timeout_ns, fault_rank, device, done, stream);
}

int adapcc_ring_k5b(const void* x, void* out, void* wire, void* flags, void* fail, void* report, int world,
                    long long chunk_elems, long long stage_elems, int rs, int ag, int x_own, int wire_code,
                    int block_size, long long chunk_wire_bytes, u64 epoch, u64 timeout_ns, int fault_rank,
                    int device, void* done, void* stream) {
  return launch_k5(true, x, out, wire, flags, fail, report, world, chunk_elems, stage_elems, rs, ag, x_own,
                   wire_code, block_size, chunk_wire_bytes, epoch, timeout_ns, fault_rank, device, done, stream);
}

const char* adapcc_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
