"""Measure the design choices of the ring kernels (K1a, K1b, K5a, K5b) on the card.

Each variant is ``csrc/ring.cu`` with a few literal substitutions
(``VARIANTS``: the committed source, and each choice undone or swapped in
turn).  All variants build at once, one ``nvcc`` each with the package's
flags, into ``build/ring_sweep/`` (git-ignored); then each runs in a process
of its own (a kernel that traps cannot spoil the next).  A variant of the
plain walk (``K1_VARIANTS``) holds K1a and K1b against ``_ring_plain`` bit
for bit at world 2, 4 and 8 in float32 and bfloat16, then times each with
CUDA events and by device time (the profiler's kernel records) at the
ZeRO-1 payload (world 4, 168,460,288 float32 a rank: K1b's reduce-scatter
and all-gather) and at 4 MiB a rank (K1a).  A variant of the fused walk
(``K5_VARIANTS``) holds K5a and K5b against ``_fused_ring_plain`` bit for
bit at world 2, 4 and 8, int8 at block 256 and bf16, then times K5b's int8
reduce-scatter + all-gather, reduce-scatter alone and all-gather alone at
the ZeRO-1 payload and K5a's at 4 MiB a rank the same way.  Run from the
repository root on an H100::

    python3 -m adapcc_tpu_torch.comm.ring_sweep [variant ...]
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from adapcc_tpu_torch.comm import ring
from adapcc_tpu_torch.ops import _build

_HOP_HEAD = "template <typename T, bool kAdd>\n__device__ __forceinline__ void hop("
_HOP_END = "\ntemplate <typename T>\n__device__ void direct_walk("
_K5_WANT = "  long long want = (stage_elems / kBatchElems + kWarps - 1) / kWarps;"

#: the hop with its operands brought into shared memory by cp.async.bulk
#: (TMA's 1-D copy, completing on an mbarrier), two stages of 8 KB pieces
#: per operand, instead of 16-byte vector loads into registers
_BULK_HOP = r'''// (ring_sweep "bulk") shared memory of the bulk-copy hop: two stages of a
// piece of each operand, and a barrier per stage
constexpr int kPiece = 512;
__device__ __forceinline__ uint4* bulk_stage(int stage, int operand) {
  __shared__ __align__(128) uint4 buf[2][2][kPiece];
  return buf[stage][operand];
}
__device__ __forceinline__ unsigned bulk_bar(int stage) {
  __shared__ __align__(8) u64 bar[2];
  return (unsigned)__cvta_generic_to_shared(&bar[stage]);
}

template <typename T, bool kAdd>
__device__ __forceinline__ void hop(const uint4* landed, const uint4* local, uint4* dst, uint4* keep, long long v0,
                                    long long v1, bool) {
  const long long n = v1 - v0;
  const int pieces = (int)((n + kPiece - 1) / kPiece);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bulk_bar(b)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // what landed was written by other SMs through the generic proxy
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int i) {
    const long long off = (long long)i * kPiece;
    const unsigned bytes = (unsigned)((n - off < kPiece ? n - off : kPiece) * 16);
    const unsigned b = bulk_bar(i & 1);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(kAdd ? 2 * bytes : bytes)
                 : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     (unsigned)__cvta_generic_to_shared(bulk_stage(i & 1, 0))),
                 "l"(landed + v0 + off), "r"(bytes), "r"(b)
                 : "memory");
    if (kAdd)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                       (unsigned)__cvta_generic_to_shared(bulk_stage(i & 1, 1))),
                   "l"(local + v0 + off), "r"(bytes), "r"(b)
                   : "memory");
  };
  if (threadIdx.x == 0 && pieces > 0) fetch(0);
  for (int i = 0; i < pieces; ++i) {
    if (threadIdx.x == 0 && i + 1 < pieces) fetch(i + 1);
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(bulk_bar(i & 1)), "r"((unsigned)(i >> 1) & 1u)
          : "memory");
    const long long off = v0 + (long long)i * kPiece;
    const long long cnt = v1 - off < kPiece ? v1 - off : kPiece;
    const uint4* l = bulk_stage(i & 1, 0);
    const uint4* m = bulk_stage(i & 1, 1);
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      __stcg(dst + off + j, kAdd ? add16<T>(m[j], l[j]) : l[j]);
      if (keep) __stcg(keep + off + j, l[j]);
    }
    __syncthreads();  // the stage is free for piece i + 2
  }
}
'''

#: name -> substitutions (old, new) on the committed source; ``None`` as
#: ``old`` replaces the hop function
VARIANTS = {
    "committed": [],
    # every tile of a step before the next step (the partial is read back
    # from device memory, a whole step after it was written)
    "step_major": [("constexpr bool kTileMajor = true;", "constexpr bool kTileMajor = false;")],
    # two or four 16-byte loads of each operand in flight a thread
    "unroll2": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 2;")],
    "unroll4": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")],
    # the operands by TMA 1-D bulk copies into shared memory
    "bulk": [(None, _BULK_HOP)],
    # every store through L2 as usual, also those no rank reads again
    "keep_last": [("constexpr bool kStreamLast = true;", "constexpr bool kStreamLast = false;")],
    # K5: each warp codes one codec unit at a time (at block 256, 2 float4
    # a lane in flight) instead of a batch of 1024 elements (8 float4)
    "one_unit": [("constexpr bool kOneUnit = false;", "constexpr bool kOneUnit = true;")],
    # K5: at most 64 blocks a rank, as the slot walk launched
    "cap64": [(_K5_WANT, _K5_WANT + " if (want > 64) want = 64;")],
}
#: the variants that change each walk (step-major changes both)
K1_VARIANTS = ("committed", "step_major", "unroll2", "unroll4", "bulk", "keep_last")
K5_VARIANTS = ("committed", "step_major", "one_unit", "cap64")
#: the ZeRO-1 ring path's per-rank payload at world 4 (the bench GPT-2's
#: flat master, tile-aligned) and the engine path's 4 MiB a rank
ZERO1_ELEMS = 168_460_288
ENGINE_ELEMS = (4 << 20) // 4
WORLD = 4
SWEEP_DIR = _build.BUILD_DIR / "ring_sweep"


def _events_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 10) -> float:
    """Mean device time of a call from the profiler's kernel records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != DeviceType.CUDA}
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and e.key not in host) / 1e3 / iters


def _variant_source(name: str) -> str:
    text = (_build.CSRC_DIR / "ring.cu").read_text()
    for old, new in VARIANTS[name]:
        if old is None:
            start, end = text.index(_HOP_HEAD), text.index(_HOP_END)
            text = text[:start] + new + text[end:]
            continue
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def _load(library: str) -> None:
    """Make ``ring`` launch from ``library``, a built variant."""
    lib = ctypes.CDLL(library)
    for name, argtypes in ring._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.adapcc_ring_error_string.argtypes = [ctypes.c_int]
    lib.adapcc_ring_error_string.restype = ctypes.c_char_p
    ring._library = lambda: lib


def _time(times: dict, key: str, call) -> None:
    times[key] = _events_ms(call)
    times[f"{key}_device"] = _device_ms(call)


def run_k1(dev: torch.device) -> int:
    """K1's checks and times; returns the number of failed checks."""
    failed = 0
    for world in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            tile = ring._tile_elems(dtype)
            for n, chunk_bytes in ((world * 3 * tile - 77, None), (world * 37 * tile - 123, 8 * tile * dtype.itemsize)):
                gen = torch.Generator(device=dev).manual_seed(0)
                chunks, _ = ring._pad_chunks(torch.randn(world, n, device=dev, generator=gen).to(dtype), world)
                ranks = torch.arange(world, device=dev)
                for buf, rs, ag in ((chunks, True, False), (chunks[ranks, ranks], False, True), (chunks, True, True)):
                    got = ring._run_ring_chunks(buf, rs=rs, ag=ag, chunk_bytes=chunk_bytes)
                    ring.check_errors()
                    failed += not torch.equal(got, ring._ring_plain(chunks, rs, ag))
    print(f"  K1 checks: {failed} of 36 failed", flush=True)
    times = {}
    for label, per_rank in (("k1b", ZERO1_ELEMS), ("k1a", ENGINE_ELEMS)):
        gen = torch.Generator(device=dev).manual_seed(0)
        chunks, chunk = ring._pad_chunks(torch.randn(WORLD, per_rank, device=dev, generator=gen), WORLD)
        own = chunks[:, 0].contiguous()
        plan = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, WORLD)
        stage_rows = plan.stage_bytes // 512
        for phase, buf, rs, ag in (("rs", chunks, True, False), ("ag", own, False, True)):
            def call():
                if plan.path == "vmem":
                    return ring.ring_k1a(buf, rs, ag)
                return ring.ring_k1b(buf, rs, ag, stage_rows)

            exact = torch.equal(call(), ring._ring_plain(buf, rs, ag))
            ring.check_errors()
            failed += not exact
            _time(times, f"{label}_{phase}", call)
        del chunks, own
        torch.cuda.empty_cache()
    ring.check_errors()
    print("  K1 ms " + json.dumps(times), flush=True)
    return failed


def run_k5(dev: torch.device) -> int:
    """K5's checks and times; returns the number of failed checks."""
    failed = checks = 0
    for world in (2, 4, 8):
        for wire, block in (("int8", 256), ("bf16", None)):
            for n, chunk_bytes in ((world * 3 * 1024 - 77, None), (world * 37 * 1024 - 123, 8 * 1024 * 4)):
                gen = torch.Generator(device=dev).manual_seed(0)
                chunks, _ = ring._pad_chunks(torch.randn(world, n, device=dev, generator=gen), world)
                ranks = torch.arange(world, device=dev)
                for buf, rs, ag in ((chunks, True, False), (chunks[ranks, ranks], False, True), (chunks, True, True)):
                    got = ring._run_ring_chunks(buf, rs=rs, ag=ag, chunk_bytes=chunk_bytes, wire_dtype=wire,
                                                block_size=block)
                    ring.check_errors()
                    want = ring._fused_ring_plain(chunks, rs, ag, wire, block or 0)
                    failed += not torch.equal(got, want if ag else want[ranks, (ranks + 1) % world])
                    checks += 1
    print(f"  K5 checks: {failed} of {checks} failed", flush=True)
    times = {}
    for label, per_rank in (("k5b", ZERO1_ELEMS), ("k5a", ENGINE_ELEMS)):
        gen = torch.Generator(device=dev).manual_seed(0)
        chunks, chunk = ring._pad_chunks(torch.randn(WORLD, per_rank, device=dev, generator=gen), WORLD)
        own = chunks[:, 0].contiguous()
        plan = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, WORLD, wire_dtype="int8")
        stage_rows = plan.stage_bytes // 512
        ranks = torch.arange(WORLD, device=dev)
        phases = (("rs+ag", chunks, True, True), ("rs", chunks, True, False), ("ag", own, False, True))
        for phase, buf, rs, ag in phases if plan.path == "hbm-stream" else phases[:1]:
            def call():
                if plan.path == "vmem":
                    return ring.ring_k5a(buf, rs, ag, "int8")
                return ring.ring_k5b(buf, rs, ag, stage_rows, "int8")

            want = ring._fused_ring_plain(buf, rs, ag, "int8")
            exact = torch.equal(call(), want if ag else want[ranks, (ranks + 1) % WORLD])
            ring.check_errors()
            failed += not exact
            del want
            _time(times, f"{label}_{phase}", call)
        del chunks, own
        torch.cuda.empty_cache()
    ring.check_errors()
    print("  K5 ms " + json.dumps(times), flush=True)
    return failed


def run_variant(library: str, walks: str) -> int:
    """Checks and times one built variant's ``walks`` ("k1", "k5" or
    both, comma-separated); returns the number of failed checks."""
    _load(library)
    dev = torch.device("cuda", 0)
    return sum({"k1": run_k1, "k5": run_k5}[w](dev) for w in walks.split(","))


def main(names) -> int:
    """Builds, checks and times ``names``; returns the number that failed."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    builds, t0 = {}, time.perf_counter()
    for name in names:
        cu = SWEEP_DIR / f"{name}.cu"
        cu.write_text(_variant_source(name))
        builds[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in builds.items():
        log = proc.communicate()[0]
        print(f"== {name}: nvcc exit {proc.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "ring_k" in line:
                print(f"  ptxas {line.split('ring_')[1][:24]}: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
        if proc.returncode != 0:
            print(log[-3000:])
    failed = 0
    for name, proc in builds.items():
        if proc.returncode != 0:
            print(f"== {name}: not built")
            failed += 1
            continue
        print(f"== {name}", flush=True)
        walks = ",".join(w for w, members in (("k1", K1_VARIANTS), ("k5", K5_VARIANTS)) if name in members)
        out = subprocess.run([sys.executable, "-m", "adapcc_tpu_torch.comm.ring_sweep", "--run",
                              str(SWEEP_DIR / f"{name}.so"), walks], timeout=300)
        print(f"== {name}: {'ok' if out.returncode == 0 else 'FAILED'}", flush=True)
        failed += out.returncode != 0
    return failed


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        sys.exit(1 if run_variant(sys.argv[2], sys.argv[3]) else 0)
    sys.exit(1 if main(sys.argv[1:] or list(VARIANTS)) else 0)
