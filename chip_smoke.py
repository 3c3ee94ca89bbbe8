#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``adapcc_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card: ``nvidia-smi`` name and power limit, device name, compute
   capability (Hopper, 9.0, is required);
2. build the CUDA kernels from ``adapcc_tpu_torch/csrc`` (seconds printed);
3. hold each kernel (flash forward, dq, dk/dv) against its plain torch
   version on the card, causal and not, in bfloat16 and float32, at the main
   path's shape and a smaller one; time kernel, plain version and, as a
   yardstick only, ``torch.nn.functional.scaled_dot_product_attention``;
4. the main path: ``bench.py``'s GPT-2 (12 layers, d_model 1024, 16 heads,
   vocab 16384, T=512, per-rank batch 16, bf16 parameters, flash attention)
   trained 5 steps by ``DDPTrainer`` under ``Strategy.ring(1)`` with
   AdamW(3e-4, weight decay 1e-4), world 1 over NCCL, weights from seed 0;
5. check the losses are finite and fall, that each kernel launched
   ``n_layer × steps`` times in that run, and that the losses agree with the
   same 5 steps under plain ``attention="xla"`` from the same weights;
6. step time and tokens/s of both runs, and a profile of one more flash step
   (device time by kernel and by layer).

The last lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.ops import _build
from adapcc_tpu_torch.ops import flash_attention as fa
from adapcc_tpu_torch.strategy.ir import Strategy

# the main path: bench.py's configuration (bench.py:366-385, per-rank batch 16)
MAIN = GPT2Config(
    vocab_size=16384, max_seq=512, n_layer=12, n_head=16, d_model=1024,
    dtype=torch.bfloat16, attention="flash", flash_block=256,
)
BATCH = 16
STEPS = 5
SEED = 0

# kernel vs plain: float32 differs only in summation order; a bf16 output is
# one float32 result rounded once by each side, so two bf16 ulps (2**-7
# relative) bound the gap, plus an absolute floor for values near zero
TOLERANCE = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
# flash vs xla attention on the main path, per step: the two paths round
# attention to bf16 at different points (xla rounds scores and
# probabilities, flash keeps float32 inside the kernel), about 2**-8 relative
# on each attention output; through 12 layers and 5 AdamW steps that moves
# the float32 loss by far less than 0.5% of its starting value ln(16384)
LOSS_ATOL = 0.05

# H100 SXM peaks (data sheet, dense): HBM bytes/s and FLOP/s by input type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNEL_SOURCE = "adapcc_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "adapcc_tpu/ops/flash_attention.py:60",
    "flash_dq": "adapcc_tpu/ops/flash_attention.py:92",
    "flash_dkv": "adapcc_tpu/ops/flash_attention.py:124",
}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(name: str, bh: int, t: int, d: int, dtype: torch.dtype, causal: bool):
    """``(bound_ms, bound_by)``: the larger of bytes over HBM rate (each
    input read once, each output written once) and flops over peak, counting
    only the unmasked (q, k) pairs these inputs need."""
    n = bh * t * d * torch.finfo(dtype).bits // 8
    stats = bh * t * 4  # one float32 per row: lse or delta
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    moved, flops = {
        "flash_fwd": (4 * n + stats, 4 * d * pairs),        # q k v -> o, lse
        "flash_dq": (5 * n + 2 * stats, 6 * d * pairs),     # q k v do lse delta -> dq
        "flash_dkv": (6 * n + 2 * stats, 8 * d * pairs),    # q k v do lse delta -> dk dv
    }[name]
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version; returns the main-shape (bf16,
    causal) record of each kernel: error, times, bound."""
    shapes = [(BATCH, MAIN.max_seq, MAIN.n_head, MAIN.d_model // MAIN.n_head), (2, 128, 4, 32)]
    records = {}
    for B, T, H, D in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                gen = torch.Generator(device=dev).manual_seed(SEED)
                q, k, v, do = ((torch.randn(B * H, T, D, device=dev, generator=gen) * 0.5).to(dtype)
                               for _ in range(4))
                scale = D ** -0.5
                o_ref, lse_ref = fa._fwd_plain(q, k, v, scale, causal)
                delta = (do.float() * o_ref.float()).sum(-1)
                res = (q, k, v, do, lse_ref, delta, scale, causal)
                runs = {
                    "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, causal),
                                  lambda: fa._fwd_plain(q, k, v, scale, causal)),
                    "flash_dq": (lambda: fa.flash_dq(*res), lambda: fa._dq_plain(*res)),
                    "flash_dkv": (lambda: fa.flash_dkv(*res), lambda: fa._dkv_plain(*res)),
                }
                rtol, atol = TOLERANCE[dtype]
                for name, (kernel, plain) in runs.items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    err, excess = 0.0, 0.0
                    for g, w in zip(got if isinstance(got, tuple) else (got,),
                                    want if isinstance(want, tuple) else (want,)):
                        if g.shape != w.shape or g.dtype != w.dtype:
                            raise RuntimeError(f"{name}: {g.shape} {g.dtype} vs plain {w.shape} {w.dtype}")
                        diff = (g.float() - w.float()).abs()
                        if not torch.isfinite(g).all():
                            raise RuntimeError(f"{name}: non-finite output")
                        err = max(err, diff.max().item())
                        excess = max(excess, (diff - atol - rtol * w.float().abs()).max().item())
                    ok = excess <= 0
                    print(f"check {name:9s} B={B} T={T} H={H} D={D} {str(dtype)[6:]:8s} "
                          f"causal={causal!s:5s} max_abs_err={err:.3e} (rtol {rtol:.1e}, atol {atol:.0e}) "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise RuntimeError(f"{name} disagrees with its plain version")
                    if (B, T, H, D) == shapes[0] and dtype == MAIN.dtype and causal:
                        b_ms, b_by = bound(name, B * H, T, D, dtype, causal)
                        records[name] = {
                            "max_abs_err": err,
                            "ms": cuda_ms(kernel),
                            "plain_ms": cuda_ms(plain, iters=5),
                            "bound_ms": b_ms,
                            "bound_by": b_by,
                            "library_ms": None,
                        }
                if (B, T, H, D) == shapes[0] and dtype == MAIN.dtype and causal:
                    # yardstick only: the port never calls library attention
                    ql, kl, vl = (x.view(B, H, T, D) for x in (q, k, v))
                    records["flash_fwd"]["library_ms"] = cuda_ms(
                        lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale))
                    ql, kl, vl = (x.detach().requires_grad_() for x in (ql, kl, vl))
                    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)
                    dol = do.view(B, H, T, D)
                    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True))
                    print(f"yardstick: scaled_dot_product_attention backward (dq, dk, dv in one call) "
                          f"{bwd_ms:.4f} ms", flush=True)
    return records


def train(cfg: GPT2Config, world, init_state, tokens):
    """``STEPS`` DDPTrainer steps from ``init_state``; returns (losses, step
    seconds, a function that runs one more step)."""
    model = GPT2(cfg, device=world.device, seed=None).to(torch.bfloat16)
    model.load_state_dict(init_state)
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(3e-4), world, Strategy.ring(world.world_size))
    state = TrainState.create(model, trainer.tx)
    losses, seconds = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.step(state, tokens)
        losses.append(loss.item())  # waits for the step
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, lambda: trainer.step(state, tokens)


# kernel name fragments -> the layer of the step they belong to
_LAYERS = (
    ("flash kernels", ("flash_fwd", "flash_dq", "flash_dkv")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("allreduce", ("nccl",)),
    ("optimizer", ("multi_tensor", "adam")),
)


def profile_step(step, step_ms: float) -> None:
    """Device time of one more training step, by kernel and by layer; the
    device's busy share is that time over ``step_ms``, the unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # kernels only: a record_function range on the device (the optimizer's
    # "Optimizer.step#AdamW.step") spans kernels already counted
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    by_layer = {}
    for e in kernels:
        layer = next((n for n, keys in _LAYERS if any(k in e.key.lower() for k in keys)), "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + e.self_device_time_total / 1e3
    print(f"profile: one flash step, {total_ms:.3f} ms of kernels; device busy "
          f"{100 * total_ms / step_ms:.1f}% of the unprofiled {step_ms:.2f} ms step")
    for layer, ms in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"profile: layer {layer:13s} {ms:9.3f} ms  {100 * ms / total_ms:5.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile: kernel {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    # the host side, which issues the kernels (times inflated by the profiler)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"profile: host op {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:80]}")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    name, cap = torch.cuda.get_device_name(0), torch.cuda.get_device_capability(0)
    print(f"card: {smi}", flush=True)
    print(f"device: {name}, compute capability {cap[0]}.{cap[1]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("flash_attention")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions
    records = check_kernels(dev)

    # 4. the main path
    world = build_world_mesh(1)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, MAIN.vocab_size, size=(BATCH, MAIN.max_seq))).to(dev)
    init_state = GPT2(MAIN, device=dev, seed=SEED).to(torch.bfloat16).state_dict()
    for w in fa.KERNELS:
        w.launches = 0
    losses, seconds, one_more_step = train(MAIN, world, init_state, tokens)
    launches = {w.__name__: w.launches for w in fa.KERNELS}
    print(f"main path (flash): losses {losses}", flush=True)
    print(f"main path launches: {launches}", flush=True)

    # 5. check
    want = MAIN.n_layer * STEPS
    if any(n != want for n in launches.values()):
        raise RuntimeError(f"expected {want} launches of each kernel, got {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite and falling: {losses}")
    # where the time goes: one more step, after the launch counts were read
    step_s = float(np.mean(seconds[1:]))  # steps after the first, which warms the libraries up
    profile_step(one_more_step, step_s * 1e3)
    del one_more_step
    torch.cuda.empty_cache()
    xla_losses, xla_seconds, _ = train(dataclasses.replace(MAIN, attention="xla"), world, init_state, tokens)
    gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    print(f"reference (xla attention): losses {xla_losses}; max gap {gap:.3e} (tolerance {LOSS_ATOL})",
          flush=True)
    if not gap <= LOSS_ATOL:
        raise RuntimeError("flash and xla attention disagree on the main path")
    destroy_world()

    # 6. speed
    print(f"main path: step {step_s * 1e3:.2f} ms, {BATCH * MAIN.max_seq / step_s:.1f} tokens/s "
          f"(mean of steps 2-{STEPS}; every step time {[round(s * 1e3, 2) for s in seconds]} ms)",
          flush=True)
    xla_step_s = float(np.mean(xla_seconds[1:]))
    print(f"reference (xla attention): step {xla_step_s * 1e3:.2f} ms, "
          f"{BATCH * MAIN.max_seq / xla_step_s:.1f} tokens/s", flush=True)

    kernels = [
        {"name": n, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[n],
         "launches": launches[n], **records[n]}
        for n in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
