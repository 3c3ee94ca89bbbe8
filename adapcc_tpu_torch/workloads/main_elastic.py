"""Elastic image-classification training — the reference main_elastic.py
flow, the port of :mod:`adapcc_tpu.workloads.main_elastic`.

Reference behavior (models/image-classification/main_elastic.py): torchrun
elastic workers restore the newest checkpoint at rendezvous, train epochs
with DDP, atomically checkpoint each epoch, and survive ``--max_restarts``
crashes.  Here the worker trains a classifier under the AdapCC DDP trainer,
checkpoints through :mod:`adapcc_tpu_torch.checkpoint`, and the
``--supervise`` mode wraps the worker in the elastic restart loop
(:func:`~adapcc_tpu_torch.checkpoint.run_elastic`).

Under ``--norm batch`` the ResNet's BatchNorm is SyncBN over the process
group: its running statistics are the model's buffers, which
``DDPTrainer`` carries as ``TrainState.model_state`` and the checkpoint's
``extra["model_state"]``, so a restarted worker resumes
them with the weights and the optimizer.  ``--deterministic`` runs the
worker on deterministic kernels only (``torch.use_deterministic_algorithms``,
which also picks the convolutions' deterministic algorithms), so that a
resumed run can be held bit for bit against an uninterrupted one on the
card, as it is on the CPU.

Run::

    python -m adapcc_tpu_torch.workloads.main_elastic --epochs 3 --steps-per-epoch 5            # on the card
    python -m adapcc_tpu_torch.workloads.main_elastic --device cpu --model mlp --supervise --crash-at-epoch 1
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from adapcc_tpu_torch.checkpoint import (
    AsyncCheckpointManager,
    TrainCheckpointState,
    async_checkpointing_enabled,
    load_checkpoint,
    restore_newest_across_processes,
    run_elastic,
    save_checkpoint,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps-per-epoch", type=int, default=5)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint-file", type=str,
                   default=os.path.join(tempfile.gettempdir(), "adapcc_elastic", "checkpoint.ckpt"))
    p.add_argument("--world", type=int, default=None,
                   help="the process group's size (default: the launcher's, else 1)")
    p.add_argument("--device", default=None, help="the device to train on (default: the card)")
    p.add_argument("--model", choices=("resnet18", "resnet50", "vgg11", "mlp"),
                   default="vgg11",
                   help="resnet18 is the reference's default --arch "
                        "(main_elastic.py:75); vgg11 is quicker; mlp runs in "
                        "seconds for restart-path tests")
    p.add_argument("--norm", choices=("group", "batch"), default="batch",
                   help="resnet norm layer: batch = SyncBN running stats "
                        "carried in the checkpoint (reference torchvision "
                        "behavior, cross-replica synced); group = stateless")
    p.add_argument("--crash-at-epoch", type=int, default=None,
                   help="fault injection: die after checkpointing this epoch")
    p.add_argument("--supervise", action="store_true",
                   help="run as the elastic supervisor wrapping a worker")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic kernels only, so a resumed run repeats an "
                        "uninterrupted one bit for bit")
    return p


def worker(args) -> int:
    from adapcc_tpu_torch.launch import apply_platform_env, maybe_initialize_distributed

    maybe_initialize_distributed()

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from adapcc_tpu_torch.comm.mesh import build_world_mesh, resolve_device
    from adapcc_tpu_torch.ddp.trainer import DDPTrainer, bind_model_state, sgd
    from adapcc_tpu_torch.strategy.ir import Strategy

    if args.deterministic:
        # cuBLAS reads its workspace setting when its first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    dev = resolve_device(args.device or apply_platform_env())
    world = build_world_mesh(args.world, device=dev)
    n = world.world_size

    stateful = False
    if args.model in ("resnet18", "resnet50"):
        from adapcc_tpu_torch.models.resnet import ResNet18, ResNet50

        ctor = ResNet18 if args.model == "resnet18" else ResNet50
        # small_inputs: the 32x32 synthetic data below is CIFAR-shaped
        model = ctor(num_classes=10, small_inputs=True, dtype=torch.float32, norm=args.norm,
                     group=dist.group.WORLD if args.norm == "batch" else None, device=dev)
        stateful = args.norm == "batch"
    elif args.model == "vgg11":
        from adapcc_tpu_torch.models.vgg import VGG11

        model = VGG11(num_classes=10, classifier_width=128, dtype=torch.float32, image_size=32, device=dev)
    else:
        from adapcc_tpu_torch.models.mlp import MLP

        mlp = MLP(32 * 32 * 3, features=(16, 10), device=dev)

        class _Flat(torch.nn.Module):
            def __init__(self) -> None:
                super().__init__()
                self.mlp = mlp

            def forward(self, x):
                return self.mlp(x.reshape(x.shape[0], -1))

        model = _Flat()
    model.train()  # SyncBN normalizes with the batch's statistics and updates its running ones
    rng = np.random.default_rng(0)
    images = rng.normal(size=(args.batch, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(args.batch,))
    per = args.batch // n
    rows = slice(world.rank * per, (world.rank + 1) * per)
    shard = (torch.as_tensor(images[rows], device=dev), torch.as_tensor(labels[rows], device=dev))

    def loss_fn(m, batch):
        x, y = batch
        return F.cross_entropy(m(x).float(), y.long())

    tx = sgd(args.lr, momentum=0.9)
    trainer = DDPTrainer(loss_fn, tx, world, Strategy.ring(n))
    train_state = trainer.init_state(model)

    def snapshot(epoch: int = -1) -> TrainCheckpointState:
        return TrainCheckpointState(
            params={k: p.detach() for k, p in model.named_parameters()},
            opt_state=train_state.optimizer.state_dict(),
            epoch=epoch, step=train_state.step,
            # SyncBN: the running statistics ride in the checkpoint's extra
            # (the reference's State carries the whole module with its buffers)
            extra={"model_state": dict(train_state.model_state)} if stateful else {},
        )

    # rendezvous restore: newest checkpoint wins across the (new) world
    ckpt = snapshot()
    # async crash-consistent checkpointing (ADAPCC_ASYNC_CKPT): epoch saves
    # run on the manager's background pipeline and the local restore reads
    # the newest VERIFIED step
    amgr = None
    if async_checkpointing_enabled():
        steps_dir = args.checkpoint_file + ".steps"
        if n > 1:
            # every process owns its own step directory: two publishers
            # racing one shared step-<n>/ rename is the collision the
            # manager's already-published guard rejects
            steps_dir += f".p{world.rank}"
        amgr = AsyncCheckpointManager(steps_dir)
    try:
        restored_step = None
        if amgr is not None:
            restored_step = amgr.latest_good_step()
            if restored_step is not None:
                amgr.restore(ckpt, restored_step)
        if restored_step is not None:
            # the legacy single-file checkpoint may still be FRESHER (async
            # was off in an earlier run); adopt it only then
            legacy = snapshot()
            try:
                fresher = load_checkpoint(legacy, args.checkpoint_file) and legacy.epoch > ckpt.epoch
            except (KeyError, ValueError, TypeError, RuntimeError):
                # an unreadable/incompatible stale file simply LOSES the
                # freshness comparison
                fresher = False
            if fresher:
                ckpt = legacy
            ckpt = restore_newest_across_processes(ckpt, args.checkpoint_file, load_local=False)
        else:
            ckpt = restore_newest_across_processes(ckpt, args.checkpoint_file)
        if ckpt.epoch >= 0 and stateful and "model_state" not in ckpt.extra:
            raise KeyError("model_state")
    except (KeyError, ValueError, TypeError, RuntimeError) as e:
        # a checkpoint written under another --norm mode carries other
        # tensors; surface the actual cause instead
        print(
            f"=> checkpoint {args.checkpoint_file!r} is incompatible with "
            f"--norm {args.norm!r} (was it written under a different norm "
            f"mode?): {e}",
            file=sys.stderr,
        )
        return 2
    start_epoch = ckpt.epoch + 1
    if start_epoch > 0:
        print(f"=> resuming from epoch {start_epoch}")
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(ckpt.params[k])
        train_state.optimizer.load_state_dict(ckpt.opt_state)
        train_state.step = ckpt.step
        if stateful:
            train_state.model_state = bind_model_state(model, ckpt.extra["model_state"])

    loss = None
    for epoch in range(start_epoch, args.epochs):
        for _ in range(args.steps_per_epoch):
            train_state, loss = trainer.step(train_state, shard)
        print(f"epoch {epoch:3d}  loss {float(loss):.4f}  world={n}")

        ckpt = snapshot(epoch)
        if amgr is not None:
            amgr.save_async(epoch, ckpt)
        else:
            save_checkpoint(ckpt, args.checkpoint_file)

        # fault injection fires only in the first generation, so the
        # supervisor's restart actually makes progress past the crash point
        gen = int(os.environ.get("ADAPCC_RESTART_GEN", "0"))
        if args.crash_at_epoch is not None and epoch == args.crash_at_epoch and gen == 0:
            if amgr is not None:
                # the INJECTED crash is deterministic by contract — the
                # genuinely-mid-save kill is the chaos drill's job
                amgr.wait()
            print(f"=> injected fault at epoch {epoch}", flush=True)
            return 17  # nonzero: the supervisor restarts us
    if amgr is not None:
        amgr.wait()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.supervise:
        worker_argv = [
            sys.executable, "-m", "adapcc_tpu_torch.workloads.main_elastic",
            "--epochs", str(args.epochs),
            "--steps-per-epoch", str(args.steps_per_epoch),
            "--batch", str(args.batch),
            "--lr", str(args.lr),
            "--checkpoint-file", args.checkpoint_file,
            "--model", args.model,
            "--norm", args.norm,
        ]
        if args.world:
            worker_argv += ["--world", str(args.world)]
        if args.device:
            worker_argv += ["--device", str(args.device)]
        if args.crash_at_epoch is not None:
            worker_argv += ["--crash-at-epoch", str(args.crash_at_epoch)]
        if args.deterministic:
            worker_argv += ["--deterministic"]
        return run_elastic(worker_argv, max_restarts=args.max_restarts)
    return worker(args)


if __name__ == "__main__":
    raise SystemExit(main())
