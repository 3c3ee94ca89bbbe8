"""Gradient-noise-scale (GNS) estimation (units-test/get_gns.py analog), the
port of :mod:`adapcc_tpu.measure.gns`.

The reference computes the GNS of a DDP run from two gradient-norm
estimates per step — the per-worker gradient (small batch ``b``) and the
allreduced gradient (large batch ``B = b × world``) — using the unbiased
estimators of the large-batch-training noise model (get_gns.py:26-108):

    |G|²  ≈ (B·|G_B|² − b·|G_b|²) / (B − b)
    S     ≈ (|G_b|² − |G_B|²) / (1/b − 1/B)
    B_noise = S / |G|²

Both are noisy per step, so the estimator EMA-smooths S and |G|²
*separately* before taking the ratio (the reference's running averages).

Per rank (one process a rank), :func:`ddp_grad_sq_norms` averages each
rank's local squared norm over the process group (JAX's ``pmean``);
:func:`stacked_grad_sq_norms` computes the same two numbers from every
rank's gradients stacked ``[world, ...]`` on one device.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def tree_sq_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Σ‖t‖² over the tensors, each squared and summed in float32 (one
    scalar)."""
    total = None
    for t in tensors:
        t = t.float()
        s = torch.sum(t * t)
        total = s if total is None else total + s
    if total is None:
        raise ValueError("no tensors to take a norm of")
    return total


def ddp_grad_sq_norms(local_grads: Sequence[torch.Tensor], mean_grads: Sequence[torch.Tensor],
                      group: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E|G_b|², |G_B|²)`` per rank: the small-batch norm is the
    cross-rank average of each rank's local gradient norm (an AVG
    all-reduce over ``group``, collective: every rank calls it); the
    big-batch norm is the norm of the already-averaged gradient."""
    small = tree_sq_norm(local_grads)
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world > 1:
        dist.all_reduce(small, group=group)
        small = small / world
    return small, tree_sq_norm(mean_grads)


def stacked_grad_sq_norms(stacked_grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E|G_b|², |G_B|²)`` from every rank's gradients stacked ``[world,
    ...]`` on one device: the mean over ranks of each rank's squared norm,
    and the squared norm of the mean over ranks."""
    per_rank = sum((g.float() * g.float()).flatten(1).sum(1) for g in stacked_grads)
    return per_rank.mean(), tree_sq_norm(g.float().mean(0) for g in stacked_grads)


def gns_from_norms(small_sq: float, big_sq: float, b_small: int, b_big: int) -> Tuple[float, float]:
    """Unbiased (|G|², S) from one pair of norm estimates."""
    if b_big <= b_small:
        raise ValueError(f"need b_big > b_small, got {b_big} <= {b_small}")
    g2 = (b_big * big_sq - b_small * small_sq) / (b_big - b_small)
    s = (small_sq - big_sq) / (1.0 / b_small - 1.0 / b_big)
    return g2, s


class GNSEstimator:
    """EMA-smoothed gradient noise scale over a training run.

    ``update`` per step with the two squared norms (host floats or scalar
    tensors from :func:`ddp_grad_sq_norms`); read ``gns`` any time.
    """

    def __init__(self, b_small: int, b_big: int, ema: float = 0.9) -> None:
        self.b_small = b_small
        self.b_big = b_big
        self.ema = ema
        self._g2: Optional[float] = None
        self._s: Optional[float] = None

    def update(self, small_sq: float, big_sq: float) -> Optional[float]:
        g2, s = gns_from_norms(float(small_sq), float(big_sq), self.b_small, self.b_big)
        if self._g2 is None:
            self._g2, self._s = g2, s
        else:
            self._g2 = self.ema * self._g2 + (1 - self.ema) * g2
            self._s = self.ema * self._s + (1 - self.ema) * s
        return self.gns

    @property
    def gns(self) -> Optional[float]:
        """Current B_noise estimate (None before any update or while the
        smoothed |G|² is ≤ 0, which happens early in noisy runs)."""
        if self._g2 is None or self._g2 <= 0:
            return None
        return self._s / self._g2
