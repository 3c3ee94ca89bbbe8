"""DDP training driver — the reference ``train_ddp.py``, the port of
:mod:`adapcc_tpu.workloads.train_ddp`.

The reference flow (train_ddp.py:30-58): init AdapCC with the launcher flag
contract, register the allreduce bucket hook on a torch DDP model, call
``update_relay(step)`` every iteration, and ``reconstruct_topology`` every
``profile_freq`` steps.  This driver keeps that flow — same flags, same
lifecycle, the JAX package's refusals word for word — with
:class:`~adapcc_tpu_torch.ddp.trainer.DDPTrainer` as the data plane and
synthetic data (the reference benchmarks run synthetic batches too).

The world is the process group: one process a rank (joined from the
launcher's environment; one process alone is world 1), each on its rank's
slice of every global batch.  ``--dp-mode fsdp`` runs the per-rank FSDP
step (:mod:`adapcc_tpu_torch.parallel.fsdp_rank`); ``--dp-mode zero1`` the
trainer's ZeRO-1 (``DDPTrainer(zero1=True)``), whose ring form
(``--zero1-ring``) waits for the per-process ring.

Run::

    python -m adapcc_tpu_torch.workloads.train_ddp --model mlp --steps 20              # on the card
    python -m adapcc_tpu_torch.workloads.train_ddp --device cpu --model mlp --steps 20
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adapcc_tpu_torch.api import AdapCC
from adapcc_tpu_torch.config import CommArgs
from adapcc_tpu_torch.primitives import ALLREDUCE, DETECT

MODELS = ["mlp", "vgg", "resnet18", "resnet50", "vit", "gpt2"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # reference launcher flag contract (launcher.py:19-32)
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--strategy_file", type=str, default="topology/strategy.xml")
    p.add_argument("--logical_graph", type=str, default="topology/logical_graph.xml")
    p.add_argument("--entry_point", type=int, default=DETECT)
    p.add_argument("--parallel_degree", type=int, default=2)
    p.add_argument("--profile_freq", type=int, default=0)
    # workload knobs
    p.add_argument("--model", choices=MODELS, default="mlp")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--world", type=int, default=None,
                   help="the process group's size (default: the launcher's, else 1)")
    p.add_argument("--device", default=None, help="the device to train on (default: the card)")
    p.add_argument("--coordinator", action="store_true", help="enable the relay/fault coordinator")
    p.add_argument(
        "--dp-mode", choices=["ddp", "fsdp", "zero1"], default="ddp",
        help="data-parallel state layout: ddp replicates (adaptive bucket "
        "hook); fsdp shards params+optimizer per rank; zero1 shards the "
        "optimizer on a flat fp32 master (both beyond the reference)",
    )
    p.add_argument(
        "--zero1-ring", action="store_true",
        help="zero1: ride the ring kernels for the reduce-scatter/all-gather "
        "pair (waits for the per-process ring)",
    )
    p.add_argument(
        "--ring-chunk-bytes", type=int, default=0,
        help="zero1-ring staging granularity in bytes (0 = the synthesized "
        "default). ADAPCC_RING_CHUNK_BYTES overrides for sweeps",
    )
    p.add_argument(
        "--min-shard-elems", type=int, default=2**14,
        help="fsdp: leaves smaller than this stay replicated",
    )
    p.add_argument(
        "--no-bsp", dest="is_bsp", action="store_false", default=True,
        help="async relay mode: straggler gradients are buffered and folded "
        "into their next active step instead of dropped (reference is_bsp)",
    )
    p.add_argument(
        "--grad-compress", choices=["off", "bf16", "int8"], default="off",
        help="gradient-sync wire codec (quant registry): bf16 halves the "
        "bytes; int8 quantizes block-wise with per-block fp32 scales",
    )
    p.add_argument(
        "--wire-dtype", choices=["off", "bf16", "int8", "strategy"],
        default=None,
        help="wire codec for the data plane, overriding --grad-compress "
        "when given ('strategy' adopts the synthesized Strategy.wire_dtype). "
        "ADAPCC_WIRE_DTYPE overrides for sweeps (malformed value -> loud error)",
    )
    p.add_argument(
        "--error-feedback", action="store_true",
        help="carry the per-rank quantization residual into the next step's "
        "gradient (closes the int8 accuracy gap; requires --dp-mode ddp)",
    )
    p.add_argument(
        "--tune", action="store_true",
        help="measurement-driven autotuning: record each step's walltime into "
        "the tuning database (ADAPCC_TUNER_DB) and adopt the policy's "
        "choices.  ADAPCC_TUNER=off disables globally",
    )
    p.add_argument(
        "--overlap", choices=["off", "microbatch", "bucket"], default="off",
        help="overlapped gradient sync: bucket = per-bucket rolling "
        "collectives; microbatch = pipeline each microbatch delta's "
        "allreduce behind the next microbatch's compute (needs --accum >= 2, "
        "--dp-mode ddp).  ADAPCC_OVERLAP overrides for sweeps",
    )
    p.add_argument(
        "--accum", type=int, default=1,
        help="gradient accumulation microbatches per step (ddp mode)",
    )
    p.add_argument(
        "--sync-mode", choices=["auto", "psum", "schedule"], default="auto",
        help="gradient-sync data plane: psum = masked collective per "
        "leaf; schedule = bucketed strategy-tree allreduce; auto picks by topology",
    )
    p.add_argument(
        "--adapt", choices=["off", "detect", "swap"], default="off",
        help="closed-loop online adaptation (requires --dp-mode ddp): feed "
        "each step's walltime to the passive drift detector and run detect "
        "-> recalibrate -> re-rank every --adapt-every steps; 'swap' "
        "additionally adopts the re-ranked strategy.  ADAPCC_ADAPT overrides",
    )
    p.add_argument("--adapt-every", type=int, default=8,
                   help="steps between adaptation passes (--adapt detect|swap)")
    p.add_argument(
        "--supervisor", action="store_true",
        help="autonomous supervisor daemon (requires --dp-mode ddp): an "
        "out-of-band thread owns detect -> decide -> swap.  "
        "ADAPCC_SUPERVISOR=on|off overrides",
    )
    p.add_argument("--supervisor-period", type=float, default=0.25,
                   help="supervisor poll cadence in seconds (--supervisor)")
    return p


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels(...).mean()``."""
    return F.cross_entropy(logits.float(), labels.long())


def make_workload(name: str, batch: int, device: Any, rank: int = 0, world: int = 1
                  ) -> Tuple[Callable, torch.nn.Module, Callable[[], Any]]:
    """Returns ``(loss_fn, model, batch_fn)`` at the JAX package's shapes:
    ``batch_fn()`` gives this rank's rows of the fixed global batch (numpy
    seeds 0 and 1, as JAX draws it)."""
    if batch % world:
        raise ValueError(f"batch {batch} not divisible by the world ({world})")
    rows = slice(rank * batch // world, (rank + 1) * batch // world)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a[rows], device=device)

    if name == "gpt2":
        from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss

        cfg = GPT2Config(vocab_size=8192, max_seq=256, n_layer=4, n_head=4, d_model=256)
        model = GPT2(cfg, device=device)
        tokens = put(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(batch, cfg.max_seq)))

        def lm(m, b):
            return lm_loss(m(b), b)

        return lm, model, lambda: tokens

    labels_of = {"vit": 100}.get(name, 10)
    y = put(np.random.default_rng(1).integers(0, labels_of, size=(batch,)))
    if name == "mlp":
        from adapcc_tpu_torch.models.mlp import MLP

        model = MLP(32, features=(64, 64, 10), device=device)
        x = put(np.random.default_rng(0).normal(size=(batch, 32)).astype(np.float32))
    elif name in ("vgg", "resnet18", "resnet50"):
        if name == "vgg":
            from adapcc_tpu_torch.models.vgg import VGG16

            model = VGG16(num_classes=10, classifier_width=512, image_size=32, device=device)
        else:
            # stateless GroupNorm variant: drops into the same loss_fn
            # contract as every other workload (SyncBN runs in main_elastic)
            from adapcc_tpu_torch.models.resnet import ResNet18, ResNet50

            ctor = ResNet18 if name == "resnet18" else ResNet50
            model = ctor(num_classes=10, small_inputs=True, dtype=torch.float32, device=device)
        x = put(np.random.default_rng(0).normal(size=(batch, 32, 32, 3)).astype(np.float32))
    elif name == "vit":
        from adapcc_tpu_torch.models.vit import ViT, ViTConfig

        cfg = ViTConfig(image_size=64, patch_size=8, num_classes=100, d_model=192, n_layer=6, n_head=3)
        model = ViT(cfg, device=device)
        x = put(np.random.default_rng(0).normal(size=(batch, 64, 64, 3)).astype(np.float32))
    else:
        raise ValueError(name)

    def loss_fn(m, b):
        bx, by = b
        return _xent(m(bx), by)

    return loss_fn, model, lambda: (x, y)


def check_args(args) -> Tuple[str, bool, str, str]:
    """The JAX driver's refusals, word for word, before any engine side
    effect; returns ``(adapt, supervised, wire_dtype, overlap)`` in force."""
    # the adaptation mode actually in force (ADAPCC_ADAPT wins over the
    # flag; malformed env/flag -> loud error before any engine side effects)
    from adapcc_tpu_torch.adapt import adapt_mode

    adapt = adapt_mode(args.adapt)
    if args.adapt_every < 1:
        raise ValueError(f"--adapt-every must be >= 1, got {args.adapt_every}")
    if adapt != "off" and args.dp_mode != "ddp":
        raise ValueError(
            "--adapt/ADAPCC_ADAPT requires --dp-mode ddp: the closed loop "
            "re-ranks and hot-swaps the DDP gradient hook's strategy "
            "(zero1/fsdp sync via GSPMD and carry no strategy to swap)"
        )
    # the supervisor mode actually in force (ADAPCC_SUPERVISOR wins over
    # the flag; malformed env -> loud error before any engine side effects)
    from adapcc_tpu_torch.supervisor import supervisor_enabled

    supervised = supervisor_enabled(args.supervisor)
    if args.supervisor_period <= 0:
        raise ValueError(
            f"--supervisor-period must be > 0, got {args.supervisor_period}"
        )
    if supervised and args.dp_mode != "ddp":
        raise ValueError(
            "--supervisor/ADAPCC_SUPERVISOR requires --dp-mode ddp: the "
            "daemon actuates the DDP gradient hook's strategy through the "
            "standby cache (zero1/fsdp carry no strategy to swap)"
        )
    if args.dp_mode != "ddp":
        # sharded-state modes sync without the adaptive hook — the
        # relay/straggler machinery rides the hook, so reject the combo up
        # front instead of silently ignoring the flags
        if args.coordinator or not args.is_bsp or args.profile_freq:
            raise ValueError(
                "--coordinator/--no-bsp/--profile_freq require --dp-mode ddp "
                "(relay and re-adaptation ride the DDP gradient hook)"
            )
        from adapcc_tpu_torch.elastic import FAULT_PLAN_ENV

        if os.environ.get(FAULT_PLAN_ENV, "").strip():
            # fault injection rides the DDP hook's relay masks; silently
            # running a healthy world under a set plan would be the exact
            # "set-but-broken is quiet" failure the env contract forbids
            raise ValueError(
                f"{FAULT_PLAN_ENV} requires --dp-mode ddp (fault injection "
                "drives the DDP trainer's per-step relay masks; zero1/fsdp "
                "have no relay plane to inject into)"
            )
        from adapcc_tpu_torch.sim.congestion import CONGESTION_PROFILE_ENV as _CONG

        if os.environ.get(_CONG, "").strip():
            # congestion injection rides the DDP adaptation controller;
            # same set-but-quiet contract as the fault plan above
            raise ValueError(
                f"{_CONG} requires --dp-mode ddp (congestion injection "
                "feeds the adaptation controller's observation funnel, "
                "which rides the DDP gradient hook)"
            )
    if args.zero1_ring and args.dp_mode != "zero1":
        raise ValueError("--zero1-ring requires --dp-mode zero1")
    # one wire-codec knob across modes: --wire-dtype wins over the older
    # --grad-compress spelling when both are given
    wire_dtype = args.wire_dtype if args.wire_dtype is not None else args.grad_compress
    if args.error_feedback and args.dp_mode != "ddp":
        raise ValueError(
            "--error-feedback requires --dp-mode ddp (the residual bank "
            "rides the DDP gradient hook)"
        )
    if wire_dtype == "strategy" and args.dp_mode != "ddp":
        raise ValueError(
            "--wire-dtype strategy requires --dp-mode ddp (only the "
            "gradient hook carries a synthesized strategy to adopt)"
        )
    if args.tune and args.dp_mode == "fsdp":
        raise ValueError(
            "--tune requires --dp-mode ddp or zero1: fsdp syncs via GSPMD "
            "and exposes none of the tuner's knobs (chunk/codec)"
        )
    # the overlap schedule actually in force (ADAPCC_OVERLAP wins over the
    # flag; malformed env -> loud error before any engine side effects)
    from adapcc_tpu_torch.ddp.overlap import resolve_overlap_mode

    overlap = resolve_overlap_mode(args.overlap)
    if args.dp_mode == "fsdp" and overlap != "off":
        raise ValueError(
            "--overlap requires --dp-mode ddp or zero1: fsdp's collectives "
            "are GSPMD-inserted and expose no overlap schedule"
        )
    if args.dp_mode == "zero1" and overlap == "microbatch":
        raise ValueError(
            "--overlap microbatch requires --dp-mode ddp: the pipeline "
            "rides the DDP trainer's accumulation scan (zero1 supports "
            "--overlap bucket — chunked reduce-scatter/all-gather)"
        )
    if args.accum < 1:
        raise ValueError(f"--accum must be >= 1, got {args.accum}")
    if args.accum > 1 and args.dp_mode != "ddp":
        raise ValueError(
            "--accum requires --dp-mode ddp (gradient accumulation rides "
            "the DDP trainer's compiled scan)"
        )
    return adapt, supervised, wire_dtype, overlap


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the driver; returns the logged losses (every 5th step and the
    last, the world's mean on fsdp, this rank's otherwise)."""
    args = build_parser().parse_args(argv)
    adapt, supervised, wire_dtype, overlap = check_args(args)
    # join the multi-process world if the launcher set the coordinator env
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, resolve_device
    from adapcc_tpu_torch.ddp.trainer import DDPTrainer, adam
    from adapcc_tpu_torch.launch import apply_platform_env, maybe_initialize_distributed
    from adapcc_tpu_torch.strategy.ir import Strategy

    maybe_initialize_distributed()
    dev = resolve_device(args.device or apply_platform_env())
    world = build_world_mesh(args.world, device=dev)
    n = world.world_size

    comm_args = CommArgs.from_namespace(args)
    if args.dp_mode == "ddp":
        # the adaptive bootstrap + collective engine back the gradient hook;
        # the sharded modes never touch them, so they skip the lifecycle
        AdapCC.init(comm_args, world=world)
        AdapCC.setup(ALLREDUCE)
        if args.coordinator:
            AdapCC.communicator.enable_coordinator(is_master=True, num_processes=1, port=0)

    loss_fn, model, batch_fn = make_workload(args.model, args.batch, dev, world.rank, n)
    tx = adam(args.lr)
    supervisor = None

    if args.dp_mode == "fsdp":
        from adapcc_tpu_torch.parallel import fsdp_shardings, fsdp_train_step, shard_fsdp

        sh = fsdp_shardings(model, world, min_shard_elems=args.min_shard_elems)
        print(f"fsdp: {sum(bool(s) for s in sh.values())}/{len(sh)} leaves sharded")
        params = shard_fsdp(model, world, min_shard_elems=args.min_shard_elems)
        opt_state = tx(params.parameters())
        fsdp_step = fsdp_train_step(loss_fn, tx, world)

        def run_step(step):
            nonlocal params, opt_state
            params, opt_state, loss = fsdp_step(params, opt_state, batch_fn())
            return loss

    elif args.dp_mode == "zero1":
        # the trainer's ZeRO-1: the hook's allreduce (the codec on each
        # contribution), this rank's float32 master row and its optimizer,
        # one all-gather; with ADAPCC_SHARD_REPLICAS > 0 each step's rows go
        # to their ring-neighbor holders
        trainer = DDPTrainer(loss_fn, tx, world, Strategy.ring(n), zero1=True, zero1_ring=args.zero1_ring,
                             grad_compress=wire_dtype, tune=args.tune, overlap=overlap)
        state = trainer.init_state(model)
        if trainer.shard_replicas:
            print(f"redundancy: zero1 shard replicas k={trainer.shard_replicas} "
                  f"(ring-neighbor placement over world={n})")

        def run_step(step):
            nonlocal state
            state, loss = trainer.step(state, batch_fn(), step_idx=step)
            return loss

    else:
        trainer = DDPTrainer(
            loss_fn,
            tx,
            world,
            AdapCC.communicator.strategy,
            communicator=AdapCC.communicator,
            use_xla_fastpath=comm_args.use_xla_fastpath,
            bsp=args.is_bsp,
            sync_mode=args.sync_mode,
            grad_compress=wire_dtype,
            error_feedback=args.error_feedback,
            tune=args.tune,
            accum_steps=args.accum,
            overlap=overlap,
        )
        state = trainer.init_state(model)

        # deterministic fault injection (docs/ELASTIC.md): with
        # ADAPCC_FAULT_PLAN set, each step's relay mask comes from the
        # plan's fault state
        from adapcc_tpu_torch.elastic import load_fault_plan
        from adapcc_tpu_torch.sim.congestion import CONGESTION_PROFILE_ENV, load_congestion_profile

        fault_plan = load_fault_plan(world=n)
        if fault_plan is not None:
            print(f"fault injection: {fault_plan!r}")
        congestion_profile = load_congestion_profile(world=n)
        if congestion_profile is not None and adapt == "off":
            # the profile feeds the adaptation controller's triage; a set
            # profile with the loop disarmed would silently inject nothing
            raise ValueError(
                f"{CONGESTION_PROFILE_ENV} requires --adapt detect|swap "
                "(congestion injection rides the adaptation controller's "
                "observation funnel; with the loop off nothing consumes it)"
            )

        # closed-loop online adaptation (docs/ADAPT.md): step walltimes are
        # the controller's passive measurement feed — zero probe traffic
        adapt_ctl = None
        grad_bytes = 0
        if adapt != "off":
            prewarm = None
            if args.is_bsp and not args.error_feedback:
                prewarm = lambda s: trainer.prewarm(s, state, batch_fn())  # noqa: E731
            adapt_ctl = AdapCC.communicator.adaptation_controller(trainer=trainer, mode=args.adapt,
                                                                  trainer_prewarm=prewarm)
            grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
            print(f"online adaptation: mode={adapt} every={args.adapt_every}")
            if congestion_profile is not None:
                adapt_ctl.attach_congestion_profile(congestion_profile)
                print(f"congestion injection: {congestion_profile!r}")

        # autonomous supervisor (docs/SUPERVISOR.md): the daemon — not this
        # loop — folds the fault plan (and any heartbeat silence) into the
        # worldview, journals every decision and actuates the swaps
        current_step = [0]
        if supervised:
            # a FRESH run must not replay the previous run's journal into
            # its healthy world; an elastic restart of the SAME run (the
            # replay case the journal exists for) is marked by the
            # launcher's ADAPCC_RESTART_GEN and keeps it
            journal_path = os.path.join(comm_args.topology_dir, "supervisor.journal")
            if not os.environ.get("ADAPCC_RESTART_GEN", "").strip() and os.path.exists(journal_path):
                os.remove(journal_path)
            supervisor = AdapCC.communicator.supervisor(
                journal_path=journal_path,
                trainer=trainer,
                fault_plan=fault_plan,
                step_source=(lambda: current_step[0]) if fault_plan is not None else None,
                adapt=adapt_ctl,
                # polls, not steps: the daemon's clock is its own
                adapt_every=args.adapt_every if adapt_ctl is not None else 0,
            )
            trainer.attach_supervisor(supervisor)
            if args.is_bsp and not args.error_feedback and args.accum == 1:
                # prewarm the top standby plans so the daemon's adoption is
                # a cache hit on the trainer plane too
                for splan in supervisor.cache.ranked()[: supervisor.cache.top_k]:
                    trainer.prewarm(splan.strategy, state, batch_fn())
            supervisor.start(period_s=args.supervisor_period)
            print(f"supervisor: period={args.supervisor_period}s journal={supervisor.journal.path}")

        def run_step(step):
            nonlocal state
            current_step[0] = step
            if supervisor is not None and fault_plan is not None:
                # the injected feed is STEP-indexed: one deterministic tick a step
                supervisor.poll()
            # periodic re-adaptation (reference train_ddp.py:45-46)
            if args.profile_freq and step > 0 and step % args.profile_freq == 0:
                AdapCC.reconstruct_topology(comm_args, ALLREDUCE)
                trainer.rebuild(AdapCC.communicator.strategy)
            mask = None
            if fault_plan is not None and supervisor is None:
                mask = torch.as_tensor(fault_plan.mask_at(step), dtype=torch.bool)
            t0 = time.perf_counter() if adapt_ctl is not None else 0.0
            state, loss = trainer.step(state, batch_fn(), step_idx=step, active_mask=mask)
            if adapt_ctl is not None:
                # the sync serializes the loop by design: the sample is the
                # step's dispatch-to-completion walltime
                from adapcc_tpu_torch.tuner.measure import sync_outputs

                sync_outputs(loss)
                adapt_ctl.observe_step(time.perf_counter() - t0, grad_bytes)
                adapt_ctl.tick(step)
                if supervisor is None and step > 0 and step % args.adapt_every == 0:
                    rep = adapt_ctl.maybe_adapt()
                    if rep.swapped:
                        print(f"adapt: step {step} swapped to {rep.winner_label} ({rep.winner_fingerprint}) "
                              f"stall={rep.stall_s:.6f}s trainer_hit={rep.trainer_adopt_hit}")
                    elif rep.outcome == "uninvertible":
                        print(f"adapt: step {step} drift detected but uninvertible (step-walltime evidence "
                              "only; link-attributable samples — tuner-recorded engine dispatches — are "
                              "needed to re-calibrate and swap)")
                    elif rep.outcome not in ("no-drift", "off"):
                        print(f"adapt: step {step} {rep.outcome}")
            return loss

    logged = []
    t_last = time.perf_counter()
    for step in range(args.steps):
        loss = run_step(step)
        if step % 5 == 0 or step == args.steps - 1:
            now = time.perf_counter()
            value = float(loss.float().mean())
            logged.append(value)
            print(f"step {step:4d}  loss {value:.4f}  ({(now - t_last):.3f}s since last log)  world={n} "
                  f"mode={args.dp_mode}")
            t_last = now

    if args.dp_mode == "ddp":
        if supervisor is not None:
            supervisor.stop()
            wv = supervisor.worldview()
            print(f"supervisor: {supervisor.decisions} decisions, wv_epoch={wv.epoch} alive={sorted(wv.alive)} "
                  f"relays={sorted(wv.relays)} journal={supervisor.journal.path}")
        AdapCC.clear(ALLREDUCE)
    return logged


if __name__ == "__main__":
    main()
