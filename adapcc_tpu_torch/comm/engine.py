"""Collective engine: the psum plane.

The port of the flat-collective fast path of :mod:`adapcc_tpu.comm.engine`:
a full-world allreduce and the masked (subset) allreduce
``psum(where(active, x, identity))`` (``masked_psum_shard``).  Each runs as
one ``torch.distributed.all_reduce`` over the process group, which NCCL
schedules bandwidth-optimally on the card.  The strategy-tree, ring and
latency planes come in later slices.

Where the JAX functions return a new array, these reduce in place on the
tensor they are given (gradients are reduced where they lie) and return it.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

from adapcc_tpu_torch.primitives import ReduceOp

MaskLike = Union[torch.Tensor, Sequence[bool]]

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVG: dist.ReduceOp.SUM,  # divided afterwards, by world or active count
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


def _identity_for(op: ReduceOp, dtype: torch.dtype) -> float:
    if op is ReduceOp.MAX:
        return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
    return 0


def _fused_reduce(x: torch.Tensor, op: ReduceOp, denom: int, group=None) -> torch.Tensor:
    """One collective for the op; AVG divides by ``denom`` (the full world on
    the fast path, the active count on the masked path)."""
    dist.all_reduce(x, op=_DIST_OPS[op], group=group)
    if op is ReduceOp.AVG:
        x.div_(denom)
    return x


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """Full-world allreduce of ``x`` in place (``lax.psum``; AVG divides by
    the world size, as ``GradSyncHook``'s static full-world path does)."""
    return _fused_reduce(x, op, dist.get_world_size(group), group)


def _mask_contribution(
    x: torch.Tensor, active_mask: torch.Tensor, rank: int, op: ReduceOp
) -> torch.Tensor:
    """Relay masking: an inactive rank contributes the reduction identity
    (reference hasLocal gate, control.cu)."""
    if bool(active_mask[rank]):
        return x
    return x.fill_(_identity_for(op, x.dtype))


def _active_count(active_mask: torch.Tensor) -> int:
    return max(int(active_mask.sum()), 1)


def masked_psum_shard(
    x: torch.Tensor,
    active_mask: MaskLike,
    op: ReduceOp = ReduceOp.SUM,
    group=None,
) -> torch.Tensor:
    """Subset allreduce as one collective, in place: inactive ranks
    contribute the identity, and AVG divides by the active count.  Every
    rank, active or not, receives the result."""
    mask = torch.as_tensor(active_mask, dtype=torch.bool).cpu()
    world = dist.get_world_size(group)
    if mask.shape != (world,):
        raise ValueError(f"active mask of shape {tuple(mask.shape)} for a world of {world}")
    contrib = _mask_contribution(x, mask, dist.get_rank(group), op)
    return _fused_reduce(contrib, op, _active_count(mask), group)

