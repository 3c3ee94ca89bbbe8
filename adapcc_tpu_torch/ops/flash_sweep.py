"""Measure the design choices of the flash kernels (K2, K3, K4) on the card.

Each variant is ``csrc/flash_attention.cu`` with a few literal substitutions
(``VARIANTS``: the committed source, and each choice undone in turn), in
bf16 (the wgmma kernels) or float32 (the CUDA-core kernels: names starting
``f32_``).  ``--f32-source FILE`` adds a float32 variant built from another
source, say the parent commit's, to compare two versions in one call.  All
variants build at once, one ``nvcc`` each with the package's flags, into
``build/sweep/`` (git-ignored); then each runs in a process of its own (a
kernel that traps cannot spoil the next): the forward, dq and dk/dv against
their plain versions on a few shapes under chip_smoke's tolerance for the
variant's dtype, the backward pair twice for bit identity (float32), then
each timed with CUDA events at the main path's shape (B·H = 256, T = 512,
D = 64), causal and not (``chip_smoke.py`` times the library yardsticks).
Run from the repository root on an H100::

    python3 -m adapcc_tpu_torch.ops.flash_sweep [--f32-source FILE] [variant ...]
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time

import torch

from adapcc_tpu_torch.ops import _build
from adapcc_tpu_torch.ops import flash_attention as fa

_FWD = "static constexpr int kWG = 2, kST = 2, kMinBlocks = DP == 64 ? 2 : 1;"
_DKV = "static constexpr int kWG = DP == 64 ? 1 : 2, kST = 2, kMinBlocks = DP == 64 ? 2 : 1;"
_DQ = "static constexpr int kWG = DP == 64 ? 1 : 2, kST = 2, kMinBlocks = DP == 64 ? 3 : 1;"
#: the committed block shapes of the float32 dq and dk/dv at D = 64: rows,
#: tile rows, threads, blocks an SM
_F32_SHAPES = {"Dq": (64, 64, 128, 2), "Dkv": (64, 64, 128, 2)}
_F32_CONFIG = """struct F32{kernel}Config {{
  static constexpr int kRows = {}, kTile = {}, kThreads = {}, kMinBlocks = {};"""


def _f32(kernel: str, rows: int, tile: int, threads: int, min_blocks: int) -> tuple:
    """The substitution that gives the float32 ``kernel`` ("Dq" or "Dkv") at
    D = 64 another block shape."""
    return (_F32_CONFIG.format(*_F32_SHAPES[kernel], kernel=kernel),
            _F32_CONFIG.format(rows, tile, threads, min_blocks, kernel=kernel))


_F32_NT_LOOP = "#pragma unroll 4\n  for (int d = 0; d < DM; d += 4)"
#: a tile's copy queued inside the loop (K3's k and v, K4's q and do)
_F32_PREFETCH = """      cp_async_commit();
    }
"""
#: name -> substitutions (old, new) on the committed source
VARIANTS = {
    "committed": [],
    # p from expf, as the mma.sync kernels did, instead of ex2 with the scale folded in
    "expf": [("kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f", "kLog2e = 1.0f, kLn2 = 1.0f"),
             ("exp2f(", "expf(")],
    # K4 as one block of two warpgroups (128 keys) an SM at D = 64
    "dkv_2wg": [(_DKV, "static constexpr int kWG = 2, kST = 2, kMinBlocks = 1;")],
    # K2 as three one-warpgroup blocks (64 queries) an SM at D = 64
    "fwd_1wg": [(_FWD, "static constexpr int kWG = DP == 64 ? 1 : 2, kST = 2, kMinBlocks = DP == 64 ? 3 : 1;")],
    # K3 at D = 64 as one block of two warpgroups (128 queries) an SM
    "dq_2wg": [(_DQ, "static constexpr int kWG = 2, kST = 2, kMinBlocks = 1;")],
    # K3 at D = 64 as two one-warpgroup blocks an SM, or four (a 96-register budget)
    "dq_1wg2": [(_DQ, _DQ.replace("DP == 64 ? 3 : 1", "DP == 64 ? 2 : 1"))],
    "dq_1wg4": [(_DQ, _DQ.replace("DP == 64 ? 3 : 1", "DP == 64 ? 4 : 1"))],
    # three pipeline stages in all three
    "stages3": [(c, c.replace("kST = 2", "kST = 3")) for c in (_FWD, _DKV, _DQ)],
    # float32: the committed register-blocked K3 and K4 at D = 64: 128-thread blocks of 64 rows
    # streaming 64-row tiles, 4 x 8 micro-tiles in both stages, two blocks an SM
    "f32_committed": [],
    # both streaming 32-row tiles (4 x 4 scores, 4 x 8 accumulators)
    "f32_t32": [_f32("Dq", 64, 32, 128, 2), _f32("Dkv", 64, 32, 128, 2)],
    # both as 256-thread blocks, one an SM (4 x 4 in both stages)
    "f32_w256": [_f32("Dq", 64, 64, 256, 1), _f32("Dkv", 64, 64, 256, 1)],
    # both as 256-thread blocks of 128 rows, one an SM (4 x 8 in both stages; masked diagonal
    # tiles are 25% of the work at T = 512 instead of 12%)
    "f32_r128": [_f32("Dq", 128, 64, 256, 1), _f32("Dkv", 128, 64, 256, 1)],
    # each tile's copy waited for as soon as it is queued: the overlap with the math undone
    "f32_syncload": [(_F32_PREFETCH, _F32_PREFETCH.replace("cp_async_commit();", "cp_async_commit();\n      cp_async_wait_all();"))],
    # the stage-1 head-dim loop fully unrolled, or by 2
    "f32_unroll": [(_F32_NT_LOOP, _F32_NT_LOOP.replace("unroll 4", "unroll"))],
    "f32_unroll2": [(_F32_NT_LOOP, _F32_NT_LOOP.replace("unroll 4", "unroll 2"))],
}
#: (B·H, T, D) checked before timing: the main shape, a ragged T, two boxes
#: (bf16); float32 adds a padded head dim of 32 and one row past a tile
SHAPES = ((256, 512, 64), (1, 200, 40), (6, 200, 128))
F32_SHAPES = SHAPES + ((8, 128, 32), (1, 65, 64))
MAIN = SHAPES[0]
#: chip_smoke's TOLERANCE, (rtol, atol) by dtype
TOLERANCE = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-5, 1e-5)}
SWEEP_DIR = _build.BUILD_DIR / "sweep"


def _events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(bh: int, t: int, d: int, causal: bool, dtype: torch.dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = ((torch.randn(bh, t, d, device="cuda", generator=gen) * 0.5).to(dtype) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa._fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, scale, causal), (q, k, v, do, lse, delta, scale, causal), (o, lse)


def run_variant(library: str, dtype: torch.dtype) -> int:
    """Checks and times one built variant in ``dtype``; returns the number of failed checks."""
    lib = ctypes.CDLL(library)
    for name, argtypes in fa._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    fa._library = lambda: lib
    rtol, atol = TOLERANCE[dtype]
    failed = 0
    for bh, t, d in F32_SHAPES if dtype == torch.float32 else SHAPES:
        for causal in (True, False):
            fwd_args, bwd_args, fwd_want = _inputs(bh, t, d, causal, dtype)
            for name, got, want in (("fwd", fa.flash_fwd(*fwd_args), fwd_want),
                                    ("dq", (fa.flash_dq(*bwd_args),), (fa._dq_plain(*bwd_args),)),
                                    ("dkv", fa.flash_dkv(*bwd_args), fa._dkv_plain(*bwd_args))):
                excess = max((g.float() - w.float()).abs().sub(atol + rtol * w.float().abs()).max().item()
                             for g, w in zip(got, want))
                failed += not excess <= 0
                print(f"  check {name} BH={bh} T={t} D={d} causal={causal}: {'ok' if excess <= 0 else 'FAIL'}")
            if dtype == torch.float32:
                same = (torch.equal(fa.flash_dq(*bwd_args), fa.flash_dq(*bwd_args))
                        and all(torch.equal(a, b) for a, b in zip(fa.flash_dkv(*bwd_args), fa.flash_dkv(*bwd_args))))
                failed += not same
                print(f"  bits dq, dkv twice BH={bh} T={t} D={d} causal={causal}: {'ok' if same else 'FAIL'}")
    times = {}
    for causal in (True, False):
        fwd_args, bwd_args, _ = _inputs(*MAIN, causal, dtype)
        suffix = "" if causal else "_noncausal"
        times["fwd" + suffix] = _events_ms(lambda: fa.flash_fwd(*fwd_args))
        times["dq" + suffix] = _events_ms(lambda: fa.flash_dq(*bwd_args))
        times["dkv" + suffix] = _events_ms(lambda: fa.flash_dkv(*bwd_args))
    print(f"  ms ({str(dtype)[6:]}) " + json.dumps(times), flush=True)
    return failed


def main(names, f32_source=None) -> int:
    """Builds, checks and times ``names`` (and ``f32_source`` as the float32
    variant ``f32_source``); returns the number that failed."""
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    builds, t0 = {}, time.perf_counter()
    for name in names + (["f32_source"] if f32_source else []):
        text = open(f32_source).read() if name == "f32_source" else src
        for old, new in VARIANTS.get(name, ()):
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = SWEEP_DIR / f"{name}.cu"
        cu.write_text(text)
        builds[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in builds.items():
        log = proc.communicate()[0]
        print(f"== {name}: nvcc exit {proc.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
        lines = log.splitlines()
        for i, line in enumerate(lines):
            found = re.search(r"wg\d+(flash_\w+?)EEEv|rb\d+(flash_\w+?_kernel)ILi(\d+)E", line)
            if "Compiling entry" in line and found:
                kernel = found.group(1) or f"float32 {found.group(2)}<{found.group(3)}>"
                print(f"  ptxas {kernel}: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
    failed = 0
    for name, proc in builds.items():
        if proc.returncode != 0:
            print(f"== {name}: not built")
            failed += 1
            continue
        print(f"== {name}", flush=True)
        dtype = "float32" if name.startswith("f32_") else "bfloat16"
        out = subprocess.run([sys.executable, "-m", "adapcc_tpu_torch.ops.flash_sweep", "--run",
                              str(SWEEP_DIR / f"{name}.so"), dtype], timeout=300)
        print(f"== {name}: {'ok' if out.returncode == 0 else 'FAILED'}", flush=True)
        failed += out.returncode != 0
    return failed


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        sys.exit(1 if run_variant(sys.argv[2], getattr(torch, sys.argv[3])) else 0)
    args = sys.argv[1:]
    source = None
    if args[:1] == ["--f32-source"]:
        source, args = args[1], args[2:]
    sys.exit(1 if main(args or ([] if source else list(VARIANTS)), source) else 0)
