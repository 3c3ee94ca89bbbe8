"""Expert-parallel MoE workload, the port of
:mod:`adapcc_tpu.workloads.train_moe` (reference models/moe/train_moe.py).

The reference wraps fastmoe's ``FMoETransformerMLP`` in DDP and times an
inference loop; its all-to-all is fastmoe's.  Here the all-to-all is the
framework's (:mod:`adapcc_tpu_torch.parallel.expert` over the ``experts``
axis) and the workload also trains: gradients flow through the dispatch
and return exchanges, with the load-balancing auxiliary loss (and the
router z-loss) in the objective.

JAX takes the expert world from its device count; the port takes
``--world`` ranks whose rows are stacked on one device (``--device``, the
card by default).  With a tuner active (``ADAPCC_TUNER=record|choose``)
the exchanges run through the engine (traced) and every ``--tune-every``
steps one engine ``all_to_all`` at the exchange's geometry is timed into
the tuning database under the ``all_to_all`` primitive.

Usage::

    python -m adapcc_tpu_torch.workloads.train_moe --steps 30            # train
    python -m adapcc_tpu_torch.workloads.train_moe --mode inference      # reference loop
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=("train", "inference"), default="train")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--dmodel", type=int, default=64)
    p.add_argument("--dhidden", type=int, default=128)
    p.add_argument("--top-k", type=int, default=2)
    p.add_argument("--batch", type=int, default=256, help="tokens per step")
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--aux-weight", type=float, default=0.01)
    p.add_argument("--world", type=int, default=4, help="expert-parallel ranks, stacked on the one device")
    p.add_argument("--device", default=None, help="the device the ranks' rows live on (default: the card)")
    p.add_argument(
        "--tune-every", type=int, default=10,
        help="steps between all-to-all tuner probes when a tuner is active "
        "(ADAPCC_TUNER=record|choose): the engine times real all_to_all "
        "dispatches at the MoE exchange geometry into the tuning database",
    )
    return p


def _cluster_data(n: int, d: int, classes: int, seed: int = 0):
    """Gaussian clusters: learnable by an expert MLP, and the clusters give
    the router something real to specialize on."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 2.0
    labels = rng.integers(0, classes, size=(n,))
    x = centers[labels] + rng.normal(size=(n, d)) * 0.5
    return x.astype(np.float32), labels.astype(np.int32)


def _readout(d: int, classes: int, device, seed: int = 1):
    """The classification head (flax ``Dense``: a lecun-normal kernel,
    untruncated, and a zero bias), drawn from ``seed``."""
    import torch
    from torch import nn

    head = nn.Linear(d, classes, device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=gen) / math.sqrt(d))
        head.bias.zero_()
    return head


def run(args) -> Tuple[float, float]:
    """Train (or time inference); returns (first_loss, last_loss), in
    inference mode both the mean step milliseconds."""
    import torch
    import torch.nn.functional as F

    from adapcc_tpu_torch.comm.mesh import resolve_device
    from adapcc_tpu_torch.models.moe import MoEConfig, MoEMLP
    from adapcc_tpu_torch.parallel import Mesh, expert_parallel_moe
    from adapcc_tpu_torch.tuner import tuner_mode
    from adapcc_tpu_torch.tuner.measure import sync_device

    world = args.world
    if world < 1:
        raise ValueError(f"--world must be >= 1, got {world}")
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} must divide by world {world}")
    dev = resolve_device(args.device)
    mesh = Mesh.stacked_mesh({"experts": world})

    cfg = MoEConfig(
        num_experts=args.experts, d_model=args.dmodel, d_hidden=args.dhidden,
        top_k=args.top_k, capacity_factor=2.0, dtype=torch.float32,
        router_z_coef=0.1,
    )
    model = MoEMLP(cfg, device=dev, seed=0)
    x_np, y_np = _cluster_data(args.batch, cfg.d_model, args.classes)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).long().to(dev)

    # expert traffic rides the engine when a tuner is active: the exchanges
    # go through engine.expert_a2a (traced) and periodic engine.all_to_all
    # probes at the same payload geometry feed the tuning database
    engine = None
    a2a_probe = None
    if tuner_mode() != "off":
        from adapcc_tpu_torch.comm.engine import CollectiveEngine
        from adapcc_tpu_torch.parallel.expert import moe_capacity
        from adapcc_tpu_torch.strategy.ir import Strategy
        from adapcc_tpu_torch.utils.observability import CollectiveTrace

        engine = CollectiveEngine(world, Strategy.ring(world), trace=CollectiveTrace())
        e_loc = cfg.num_experts // world
        cap = moe_capacity(cfg, args.batch // world)
        probe = torch.zeros((world, world, e_loc * cap * cfg.d_model), dtype=torch.float32, device=dev)

        def a2a_probe():
            engine.all_to_all(probe)

    head = _readout(cfg.d_model, args.classes, dev)

    if args.mode == "inference":
        def fwd():
            with torch.no_grad():
                return expert_parallel_moe(model, x, cfg, mesh, engine=engine)[0]

        fwd()  # warm up (JAX's compile)
        sync_device(dev)
        times = []
        for i in range(args.steps):
            if a2a_probe is not None and i % max(1, args.tune_every) == 0:
                a2a_probe()
            t0 = time.perf_counter()
            fwd()
            sync_device(dev)
            times.append(time.perf_counter() - t0)
        ms = float(np.mean(times) * 1e3)
        _report_tuner(engine)
        # the reference prints its per-iteration computation time
        print(f"computation time: {ms:.3f} ms/step ({args.batch} tokens, world={world})")
        return ms, ms

    params = list(model.parameters()) + list(head.parameters())
    opt = torch.optim.Adam(params, lr=args.lr)

    def loss_fn():
        h, aux = expert_parallel_moe(model, x, cfg, mesh, engine=engine)
        logits = head(h.float())
        ce = F.cross_entropy(logits, y)
        return ce + args.aux_weight * aux, ce, aux

    first = last = None
    for i in range(args.steps):
        if a2a_probe is not None and i % max(1, args.tune_every) == 0:
            a2a_probe()
        opt.zero_grad(set_to_none=True)
        loss, ce, aux = loss_fn()
        loss.backward()
        opt.step()
        if i == 0 or i == args.steps - 1 or (i + 1) % 10 == 0:
            loss_v = loss.item()
            print(f"step {i:4d}  loss {loss_v:.4f}  ce {ce.item():.4f}  aux {aux.item():.4f}")
            if first is None:
                first = loss_v
            last = loss_v
    _report_tuner(engine)
    return first, last


def _report_tuner(engine) -> None:
    """One line per tuned all_to_all cell: the run's evidence that expert
    traffic landed in the tuning database."""
    if engine is None or engine.tuner is None:
        return
    rows = [r for r in engine.tuner.db.snapshot() if r["primitive"] == "all_to_all"]
    for r in rows:
        print(
            f"[tuner] all_to_all bucket={r['size_bucket']}B path={r['path']} "
            f"n={r['count']} median={r['median_s'] * 1e6:.1f}us"
        )


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
