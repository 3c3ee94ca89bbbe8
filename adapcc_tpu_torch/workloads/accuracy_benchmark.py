"""Accuracy benchmark — the reference's image-classification accuracy study,
the port of :mod:`adapcc_tpu.workloads.accuracy_benchmark`.

Reference behavior (models/image-classification/accuracy_benchmark.py):
epoch-based classifier training with AverageMeter/ProgressMeter progress
lines, top-1/top-5 accuracy, a validation pass per epoch, optional
gradient-noise-scale hooks (first-class here via
``DDPTrainer(measure_gns=True)``, on a world of two or more), and accuracy
traces dumped to .txt for the committed plots.

The dataset is synthetic-but-learnable (Gaussian class blobs): accuracy
starts at chance and climbs, so the benchmark validates end-to-end learning
through the adaptive DDP stack, not just step mechanics.  The world is the
process group (one process a rank, each on its rank's rows of every batch).

Run::

    python -m adapcc_tpu_torch.workloads.accuracy_benchmark --epochs 3               # on the card
    python -m adapcc_tpu_torch.workloads.accuracy_benchmark --device cpu --epochs 3
"""

from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from adapcc_tpu_torch.utils import AverageMeter, ProgressMeter


def topk_accuracy(logits, labels, ks: Sequence[int] = (1, 5)):
    """Top-k accuracies (%) for ``logits [B, C]`` vs ``labels [B]`` —
    the reference's ``accuracy(output, target, topk=(1, 5))``."""
    import torch

    ks = tuple(min(k, logits.shape[-1]) for k in ks)
    # JAX's argsort is stable and reversed, so ties rank the higher index first
    ranked = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    out = []
    for k in ks:
        hit = (ranked[:, :k] == labels[:, None]).any(dim=-1)
        out.append(100.0 * hit.float().mean())
    return out


def make_blob_dataset(
    n: int, num_classes: int, image_size: int = 8, channels: int = 3,
    noise: float = 1.0, seed: int = 0, means_seed: int = 1234,
) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic classification data: one Gaussian blob per class
    in pixel space, noise-corrupted.  Linear separability makes accuracy an
    honest end-to-end training signal without any dataset download.

    ``means_seed`` fixes the class centers independently of ``seed`` (the
    sample draw), so train and validation splits share one distribution.
    """
    means = np.random.default_rng(means_seed).normal(size=(num_classes, image_size, image_size, channels))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(n,))
    images = means[labels] + noise * rng.normal(size=(n, image_size, image_size, channels))
    return images.astype(np.float32), labels.astype(np.int32)


def batches(images: np.ndarray, labels: np.ndarray, batch: int, seed: int
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled full batches (drops the ragged tail, like the reference's
    DataLoader with drop_last)."""
    idx = np.random.default_rng(seed).permutation(len(images))
    for i in range(0, len(idx) - batch + 1, batch):
        sel = idx[i:i + batch]
        yield images[sel], labels[sel]


def validate(apply_fn, images, labels, batch: int = 64, device=None) -> Tuple[float, float]:
    """Full-dataset top-1/top-5 (%), batched to bound memory;
    ``apply_fn(images) -> logits`` on ``device``."""
    import torch

    hits1, hits5, seen = 0.0, 0.0, 0
    with torch.no_grad():
        for i in range(0, len(images), batch):
            x = torch.as_tensor(images[i:i + batch], device=device)
            y = torch.as_tensor(labels[i:i + batch], device=device)
            a1, a5 = topk_accuracy(apply_fn(x), y)
            hits1 += float(a1) * len(x)
            hits5 += float(a5) * len(x)
            seen += len(x)
    return hits1 / max(seen, 1), hits5 / max(seen, 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--train-size", type=int, default=512)
    p.add_argument("--val-size", type=int, default=128)
    # VGG11's five 2x pooling stages need ≥32px inputs
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--noise", type=float, default=1.0,
                   help="blob corruption; lower = easier problem")
    p.add_argument("--model", choices=["vgg", "resnet18", "mlp"], default="vgg",
                   help="resnet18 = the reference study's default --arch "
                        "(stateless GroupNorm variant here; the SyncBN path "
                        "runs in main_elastic); vgg = fast conv benchmark; "
                        "mlp = fast smoke")
    p.add_argument("--world", type=int, default=None,
                   help="the process group's size (default: the launcher's, else 1)")
    p.add_argument("--device", default=None, help="the device to train on (default: the card)")
    p.add_argument("--measure-gns", action="store_true")
    p.add_argument("--accuracy-trace", type=str, default=None,
                   help="append 'epoch top1 top5' lines (reference .txt traces)")
    p.add_argument("--print-freq", type=int, default=5)
    return p


def run(args, report: Optional[dict] = None) -> Tuple[float, float]:
    """Train + validate; returns the final (top1, top5).  ``report``, when
    given, gets each epoch's ``(top1, top5)`` and the last GNS."""
    from adapcc_tpu_torch.launch import apply_platform_env, maybe_initialize_distributed

    # joins a multi-process world when launched as one
    maybe_initialize_distributed()

    import torch
    import torch.nn.functional as F

    from adapcc_tpu_torch.comm.mesh import build_world_mesh, resolve_device
    from adapcc_tpu_torch.ddp.trainer import DDPTrainer, adam
    from adapcc_tpu_torch.strategy.ir import Strategy

    report = {} if report is None else report
    dev = resolve_device(args.device or apply_platform_env())
    world = build_world_mesh(args.world, device=dev)
    n = world.world_size

    train_x, train_y = make_blob_dataset(args.train_size, args.num_classes, args.image_size, noise=args.noise,
                                         seed=0)
    val_x, val_y = make_blob_dataset(args.val_size, args.num_classes, args.image_size, noise=args.noise, seed=1)

    if args.model == "vgg":
        from adapcc_tpu_torch.models.vgg import VGG11

        net = VGG11(num_classes=args.num_classes, classifier_width=64, dtype=torch.float32,
                    image_size=args.image_size, device=dev)
        apply_fn = net
    elif args.model == "resnet18":
        from adapcc_tpu_torch.models.resnet import ResNet18

        net = ResNet18(num_classes=args.num_classes, small_inputs=True, dtype=torch.float32, device=dev)
        apply_fn = net
    else:
        from adapcc_tpu_torch.models.mlp import MLP

        net = MLP(args.image_size * args.image_size * 3, features=(128, 64, args.num_classes), device=dev)

        def apply_fn(x):
            return net(x.reshape(x.shape[0], -1))

    def loss_fn(m, batch):
        x, y = batch
        return F.cross_entropy(apply_fn(x).float(), y.long())

    tx = adam(args.lr)
    trainer = DDPTrainer(loss_fn, tx, world, Strategy.ring(n), measure_gns=args.measure_gns and n > 1)
    state = trainer.init_state(net)
    per = args.batch // n

    top1 = top5 = 0.0
    for epoch in range(args.epochs):
        losses = AverageMeter("loss", ":.4f")
        steps = max(1, args.train_size // args.batch)
        progress = ProgressMeter(steps, [losses], prefix=f"epoch {epoch} ")
        for i, (x, y) in enumerate(batches(train_x, train_y, args.batch, seed=epoch)):
            rows = slice(world.rank * per, (world.rank + 1) * per)
            shard = (torch.as_tensor(x[rows], device=dev), torch.as_tensor(y[rows], device=dev))
            state, loss = trainer.step(state, shard)
            losses.update(float(loss), len(x))
            if i % args.print_freq == 0:
                progress.display(i)
        top1, top5 = validate(apply_fn, val_x, val_y, device=dev)
        gns = trainer.gns.gns if trainer.gns is not None else None
        gns_txt = f"  gns {gns:.1f}" if gns is not None else ""
        print(f"epoch {epoch:3d}  val top1 {top1:.2f}%  top5 {top5:.2f}%{gns_txt}")
        report.setdefault("epochs", []).append((top1, top5))
        report["gns"] = gns
        if args.accuracy_trace:
            with open(args.accuracy_trace, "a") as f:
                f.write(f"{epoch} {top1:.4f} {top5:.4f}\n")
    return top1, top5


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
