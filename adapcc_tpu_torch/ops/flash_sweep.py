"""Measure the design choices of the bf16 wgmma flash kernels (K2, K3, K4) on the card.

Each variant is ``csrc/flash_attention.cu`` with a few literal substitutions
(``VARIANTS``: the committed source, and each choice undone in turn).  All
variants build at once, one ``nvcc`` each with the package's flags, into
``build/sweep/`` (git-ignored); then each runs in a process of its own (a
kernel that traps cannot spoil the next): the forward, dq and dk/dv against
their plain versions on a few shapes under chip_smoke's bf16 tolerance, then
each timed with CUDA events at the main path's shape (B·H = 256, T = 512,
D = 64, bf16), causal and not.  Run from the repository root on an H100::

    python3 -m adapcc_tpu_torch.ops.flash_sweep [variant ...]
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
}
#: (B·H, T, D) checked before timing: the main shape, a ragged T, two boxes
SHAPES = ((256, 512, 64), (1, 200, 40), (6, 200, 128))
MAIN = SHAPES[0]
RTOL, ATOL = 2.0 ** -7, 1e-5
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


def _inputs(bh: int, t: int, d: int, causal: bool):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = ((torch.randn(bh, t, d, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa._fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, scale, causal), (q, k, v, do, lse, delta, scale, causal), (o, lse)


def run_variant(library: str) -> int:
    """Checks and times one built variant; returns the number of failed checks."""
    lib = ctypes.CDLL(library)
    for name, argtypes in fa._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    fa._library = lambda: lib
    failed = 0
    for bh, t, d in SHAPES:
        for causal in (True, False):
            fwd_args, bwd_args, fwd_want = _inputs(bh, t, d, causal)
            for name, got, want in (("fwd", fa.flash_fwd(*fwd_args), fwd_want),
                                    ("dq", (fa.flash_dq(*bwd_args),), (fa._dq_plain(*bwd_args),)),
                                    ("dkv", fa.flash_dkv(*bwd_args), fa._dkv_plain(*bwd_args))):
                excess = max((g.float() - w.float()).abs().sub(ATOL + RTOL * w.float().abs()).max().item()
                             for g, w in zip(got, want))
                failed += not excess <= 0
                print(f"  check {name} BH={bh} T={t} D={d} causal={causal}: {'ok' if excess <= 0 else 'FAIL'}")
    times = {}
    for causal in (True, False):
        fwd_args, bwd_args, _ = _inputs(*MAIN, causal)
        suffix = "" if causal else "_noncausal"
        times["fwd" + suffix] = _events_ms(lambda: fa.flash_fwd(*fwd_args))
        times["dq" + suffix] = _events_ms(lambda: fa.flash_dq(*bwd_args))
        times["dkv" + suffix] = _events_ms(lambda: fa.flash_dkv(*bwd_args))
    print("  ms " + json.dumps(times), flush=True)
    return failed


def main(names) -> int:
    """Builds, checks and times ``names``; returns the number that failed."""
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    builds, t0 = {}, time.perf_counter()
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
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
            if "Compiling entry" in line and "wgmma" in line:
                found = re.search(r"wg\d+(flash_\w+?)EEEv", line)
                kernel = found.group(1) if found else line
                print(f"  ptxas {kernel}: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
    failed = 0
    for name, proc in builds.items():
        if proc.returncode != 0:
            print(f"== {name}: not built")
            failed += 1
            continue
        print(f"== {name}", flush=True)
        out = subprocess.run([sys.executable, "-m", "adapcc_tpu_torch.ops.flash_sweep", "--run",
                              str(SWEEP_DIR / f"{name}.so")], timeout=300)
        print(f"== {name}: {'ok' if out.returncode == 0 else 'FAILED'}", flush=True)
        failed += out.returncode != 0
    return failed


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        sys.exit(1 if run_variant(sys.argv[2]) else 0)
    sys.exit(1 if main(sys.argv[1:] or list(VARIANTS)) else 0)
