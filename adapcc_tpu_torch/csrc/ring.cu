// Ring reduce-scatter / all-gather for Hopper (sm_90a): kernels K1a and K1b.
//
// Replaces adapcc_tpu/comm/pallas_ring.py::_ring_kernel (K1a, each chunk in
// one stage: the planner's "vmem" path) and ::_stream_ring_kernel (K1b, each
// chunk streamed through [stage_rows, 128] staging tiles: "hbm-stream").
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
// Single-controller form: one launch walks the ring for every rank.  Rank r
// is a group of `nb` thread blocks; block b of rank r talks only to block b
// of ranks r-1 and r+1, over its stripe of every tile.  A rank's only view
// of its neighbours is RingPeers, a table of device pointers to each rank's
// two staging slots and flag words: what CUDA IPC handles give one process
// per card.  Flags carry data-ready (left -> right), credits (right -> left)
// and the entry barrier.  Every value is `epoch + k` for a per-call epoch
// above anything an earlier call wrote, so no reset pass runs between calls.
//
// Protocol of one iteration `it` (= step * n_tiles + tile, slot = it % 2):
//   1. it >= 2: wait for credit >= epoch + it - 1: the right neighbour has
//      consumed what this rank wrote into the slot at it - 2;
//   2. copy the outbound stripe into the right neighbour's slot;
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
// for reduce-scatter.  This first version is plain 16-byte vector loads and
// stores, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWorld = 32;    // comm/ring.py _MAX_WORLD
constexpr int kMaxBlocks = 64;   // comm/ring.py _MAX_BLOCKS
constexpr int kFlagWords = 8;    // comm/ring.py _FLAG_WORDS (one 64-byte record)
// a block's stripe of a tile is at least this many 16-byte vectors
constexpr long long kMinVecsPerBlock = 1024;

// flag words of one (rank, block) record
enum { kReady0 = 0, kReady1 = 1, kCredit = 2, kBarFromLeft = 3, kBarFromRight = 4 };
// what a spin waited for (comm/ring.py _WAITS)
enum { kWaitBarrier = 1, kWaitCredit = 2, kWaitData = 3, kWaitDrain = 4 };

typedef unsigned long long u64;

struct RingPeers {
  void* slots[kMaxWorld];  // rank r: [2][stage_elems] staging slots
  u64* flags[kMaxWorld];   // rank r: [kMaxBlocks][kFlagWords]
};

struct RingArgs {
  const void* x;           // [world][world][chunk_elems]
  void* out;               // the same layout: every rank's work buffer
  int* err;                // [kind, rank, step, tile, block, ...]
  long long chunk_elems;
  long long stage_elems;
  int world;
  int n_tiles;
  int rs;
  int ag;
  int x_own;               // all-gather alone: x is [world][chunk_elems], rank r's own chunk r
  u64 epoch;
  u64 timeout_ns;
  int fault_rank;          // that rank stops after the barrier (tests); -1: none
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

// The ring walk of one block: rank blockIdx.x / nb, stripe blockIdx.x % nb.
template <typename T>
__device__ void ring_walk(const RingPeers& peers, const RingArgs& a, int nb, int n_tiles,
                          long long stage_elems) {
  const int W = a.world;
  const int rank = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int right = (rank + 1) % W, left = (rank + W - 1) % W;
  u64* mine = peers.flags[rank] + blk * kFlagWords;
  u64* right_flags = peers.flags[right] + blk * kFlagWords;
  u64* left_flags = peers.flags[left] + blk * kFlagWords;
  const T* my_slots = static_cast<const T*>(peers.slots[rank]);
  T* right_slots = static_cast<T*>(peers.slots[right]);
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const u64 e = a.epoch;

  // this block's stripe of every tile, in 16-byte vectors
  const long long tile_vecs = stage_elems * (long long)sizeof(T) / 16;
  const long long per = (tile_vecs + nb - 1) / nb;
  const long long v0 = blk * per;
  const long long v1 = v0 + per < tile_vecs ? v0 + per : tile_vecs;

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
  // the own chunk r is never landed on in RS-only or AG-only walks: step 0
  // copies it from the input into the work buffer as it ships it
  const bool keep_own = !(a.rs && a.ag);
  const long long rank_base = (long long)rank * W * a.chunk_elems;
  // step 0 ships the own chunk r from x; an all-gather alone reads nothing
  // else of x, so x may hold only that chunk of every rank: [world][chunk_elems]
  const long long own_base = a.x_own ? (long long)rank * a.chunk_elems : rank_base + rank * a.chunk_elems;

  for (int step = 0; step < total_steps; ++step) {
    const bool in_rs = step < n_rs;
    const int send_idx = in_rs ? (rank + W - step) % W : (rank + 2 * W + own - (step - n_rs)) % W;
    const int recv_idx = (send_idx + W - 1) % W;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const long long it = (long long)step * n_tiles + tile;
      const int slot = (int)(it & 1);

      // 1. the slot at the right neighbour is free again
      if (it >= 2 && !block_wait(mine + kCredit, e + it - 1, a, rank, blk, step, tile, kWaitCredit))
        return;

      // 2. ship: step 0 sends the own input chunk (send_idx == rank), later
      // steps the chunk this rank finished at the step before
      const long long send_off = rank_base + send_idx * a.chunk_elems + tile * stage_elems;
      const uint4* src = reinterpret_cast<const uint4*>(
          step == 0 ? x + own_base + tile * stage_elems : out + send_off);
      uint4* dst = reinterpret_cast<uint4*>(right_slots + slot * stage_elems);
      uint4* keep = (step == 0 && keep_own) ? reinterpret_cast<uint4*>(out + send_off) : nullptr;
      for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
        const uint4 d = src[v];
        __stcg(dst + v, d);
        if (keep) keep[v] = d;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(right_flags + slot, e + it + 1);
      }

      // 3. what the left neighbour shipped has landed
      if (!block_wait(mine + slot, e + it + 1, a, rank, blk, step, tile, kWaitData)) return;

      // 4. accumulate (local + landed) or adopt; the slot is read past L1
      const long long recv_off = rank_base + recv_idx * a.chunk_elems + tile * stage_elems;
      const uint4* landed = reinterpret_cast<const uint4*>(my_slots + slot * stage_elems);
      uint4* work = reinterpret_cast<uint4*>(out + recv_off);
      if (in_rs) {
        // chunk recv_idx is landed on once in RS: its local term is the input
        const uint4* local = reinterpret_cast<const uint4*>(x + recv_off);
        for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x)
          work[v] = add16<T>(local[v], __ldcg(landed + v));
      } else {
        for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) work[v] = __ldcg(landed + v);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(left_flags + kCredit, e + it + 1);
      }
    }
  }

  // drain: the right neighbour has consumed everything this rank shipped
  const long long total_iters = (long long)total_steps * n_tiles;
  block_wait(mine + kCredit, e + total_iters, a, rank, blk, total_steps, 0, kWaitDrain);
}

// K1a: each chunk is one stage (stage = chunk, one tile per step).
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1a_kernel(RingPeers peers, RingArgs a, int nb) {
  ring_walk<T>(peers, a, nb, 1, a.chunk_elems);
}

// K1b: each chunk streams through n_tiles staging tiles per step.
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_k1b_kernel(RingPeers peers, RingArgs a, int nb) {
  ring_walk<T>(peers, a, nb, a.n_tiles, a.stage_elems);
}

// Fill the pointer table (single controller: every rank's slots and flags
// are slices of one buffer) and launch cooperatively.
int launch(const void* kernel, const void* x, void* out, void* slots, void* flags, void* err,
           int world, long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag,
           int x_own, int elem_bytes, u64 epoch, u64 timeout_ns, int fault_rank, void* stream) {
  if (world < 2 || world > kMaxWorld) return (int)cudaErrorInvalidValue;
  if (x_own && (rs || !ag)) return (int)cudaErrorInvalidValue;
  if ((stage_elems * elem_bytes) % 16 || chunk_elems != stage_elems * n_tiles)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const long long fit = (long long)per_sm * sms / world;  // co-resident blocks per rank
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long want = stage_elems * elem_bytes / 16 / kMinVecsPerBlock;
  if (want < 1) want = 1;
  int nb = (int)(want < fit ? want : fit);
  if (nb > kMaxBlocks) nb = kMaxBlocks;

  RingPeers peers;
  for (int r = 0; r < kMaxWorld; ++r) {
    const bool in = r < world;
    peers.slots[r] = in ? static_cast<char*>(slots) + (long long)r * 2 * stage_elems * elem_bytes : nullptr;
    peers.flags[r] = in ? static_cast<u64*>(flags) + (long long)r * kMaxBlocks * kFlagWords : nullptr;
  }
  RingArgs a;
  a.x = x;
  a.out = out;
  a.err = static_cast<int*>(err);
  a.chunk_elems = chunk_elems;
  a.stage_elems = stage_elems;
  a.world = world;
  a.n_tiles = n_tiles;
  a.rs = rs;
  a.ag = ag;
  a.x_own = x_own;
  a.epoch = epoch;
  a.timeout_ns = timeout_ns;
  a.fault_rank = fault_rank;
  void* args[] = {&peers, &a, &nb};
  e = cudaLaunchCooperativeKernel(kernel, dim3(world * nb), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

}  // namespace

extern "C" {

int adapcc_ring_k1a(const void* x, void* out, void* slots, void* flags, void* err, int world,
                    long long chunk_elems, int rs, int ag, int x_own, int is_bf16, u64 epoch,
                    u64 timeout_ns, int fault_rank, void* stream) {
  const void* kernel = is_bf16 ? (const void*)ring_k1a_kernel<__nv_bfloat16>
                               : (const void*)ring_k1a_kernel<float>;
  return launch(kernel, x, out, slots, flags, err, world, chunk_elems, chunk_elems, 1, rs, ag, x_own,
                is_bf16 ? 2 : 4, epoch, timeout_ns, fault_rank, stream);
}

int adapcc_ring_k1b(const void* x, void* out, void* slots, void* flags, void* err, int world,
                    long long chunk_elems, long long stage_elems, int n_tiles, int rs, int ag,
                    int x_own, int is_bf16, u64 epoch, u64 timeout_ns, int fault_rank, void* stream) {
  const void* kernel = is_bf16 ? (const void*)ring_k1b_kernel<__nv_bfloat16>
                               : (const void*)ring_k1b_kernel<float>;
  return launch(kernel, x, out, slots, flags, err, world, chunk_elems, stage_elems, n_tiles, rs,
                ag, x_own, is_bf16 ? 2 : 4, epoch, timeout_ns, fault_rank, stream);
}

const char* adapcc_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
