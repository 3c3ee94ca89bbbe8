"""ZeRO-1 per rank: the update cycle of one process a rank.

The per-rank half of :mod:`adapcc_tpu_torch.parallel.fsdp`, kept apart from
it: the single-controller ring plane there reaches the card only through the
hand-written ring kernels, while one process a rank rebuilds its replicated
parameters with the process group's all-gather (gloo on the CPU, NCCL on
the card).  ``DDPTrainer(zero1=True)`` runs it after the hook's allreduce.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from adapcc_tpu_torch.ddp.overlap import even_chunk_bounds
from adapcc_tpu_torch.parallel.fsdp import _FlatMeta, _unflatten


@torch.no_grad()
def zero1_apply_shard_rank(
    opt_state: torch.optim.Optimizer,
    row: torch.Tensor,
    g_row: torch.Tensor,
    meta: _FlatMeta,
    model: nn.Module,
    group: Optional[Any] = None,
    overlap_chunks: int = 1,
) -> None:
    """The per-rank update cycle (one process a rank): the optimizer step on
    this rank's ``[N/world]`` master ``row`` with its gradient slice
    ``g_row``, then one ``all_gather_into_tensor`` over ``group`` rebuilds
    the replicated parameters in ``model``.  ``overlap_chunks > 1`` gathers
    ``even_chunk_bounds`` slices of the row as independent collectives and
    puts the bytes in the same places."""
    row.grad = g_row
    opt_state.step()
    row.grad = None
    world = meta.padded // row.numel()
    bounds = even_chunk_bounds(row.numel(), overlap_chunks)
    if len(bounds) == 1:
        flat_p = torch.empty(meta.padded, dtype=row.dtype, device=row.device)
        dist.all_gather_into_tensor(flat_p, row.detach(), group=group)
    else:
        parts = []
        for off, n in bounds:
            out = torch.empty(world * n, dtype=row.dtype, device=row.device)
            dist.all_gather_into_tensor(out, row.detach()[off:off + n].contiguous(), group=group)
            parts.append(out.view(world, n))
        flat_p = torch.cat(parts, dim=1).reshape(-1)
    _unflatten(flat_p, meta, model)
