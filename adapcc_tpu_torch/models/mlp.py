"""Small MLP: the unit-test workload, the port of
:mod:`adapcc_tpu.models.mlp` (the reference's smoke benchmarks train tiny
models just to exercise the collectives)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device


def lecun_normal_(lin: nn.Module, gen: torch.Generator) -> None:
    """A ``Linear`` or ``Conv2d`` weight drawn N(0, 1/fan_in) (flax's lecun
    normal, untruncated) on the CPU from ``gen``; its bias zeroed."""
    w = lin.weight
    fan_in = w[0].numel()
    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
    if lin.bias is not None:
        lin.bias.zero_()


class MLP(nn.Module):
    """``x [B, in_features]`` → ``[B, features[-1]]``: ``Dense`` layers
    ``dense_{i}`` with a ReLU between them, float32 (flax's defaults)."""

    def __init__(self, in_features: int, features: Sequence[int] = (32, 32, 10), device: DeviceLike = None,
                 seed: Optional[int] = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.features = tuple(features)
        widths = (in_features, *self.features)
        for i in range(len(self.features)):
            self.add_module(f"dense_{i}", nn.Linear(widths[i], widths[i + 1], device=dev))
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for i in range(len(self.features)):
            lecun_normal_(getattr(self, f"dense_{i}"), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.features)
        for i in range(n):
            x = F.linear(x, getattr(self, f"dense_{i}").weight, getattr(self, f"dense_{i}").bias)
            if i < n - 1:
                x = F.relu(x)
        return x
