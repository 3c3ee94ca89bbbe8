"""Collective engine: the psum plane and the ring plane.

The port of two parts of :mod:`adapcc_tpu.comm.engine`:

- the flat-collective fast path, per process: a full-world allreduce and the
  masked (subset) allreduce ``psum(where(active, x, identity))``
  (``masked_psum_shard``).  Each runs as one ``torch.distributed.all_reduce``
  over the process group.  Where the JAX functions return a new array, these
  reduce in place on the tensor they are given and return it.
- the ring entry points of :class:`CollectiveEngine` (``ring_allreduce``,
  ``ring_reduce_scatter``, ``ring_all_gather``), in the JAX engine's
  single-controller form: a stacked ``[world, ...]`` tensor in, the stacked
  result out, through the hand-written ring kernels of
  :mod:`adapcc_tpu_torch.comm.ring` on the card (their plain version on a
  CPU tensor).

The strategy-tree and latency planes come in later slices.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from adapcc_tpu_torch.comm import ring
from adapcc_tpu_torch.primitives import ReduceOp, not_ported
from adapcc_tpu_torch.strategy.ir import Strategy

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



#: env overrides of the JAX engine that pick a plane this slice has not
#: ported (a pin the port cannot honour raises instead of running the ring)
WIRE_DTYPE_ENV = "ADAPCC_WIRE_DTYPE"
COLL_ALGO_ENV = "ADAPCC_COLL_ALGO"


class CollectiveEngine:
    """The ring plane of the JAX ``CollectiveEngine`` over ``world_size``
    ranks whose rows live on one device (the tensor's: the card, or the CPU
    for a CPU tensor).

    ``trace``, when given, is a list that receives one dispatch record per
    call: the primitive, the implementation that ran (``cuda_ring[<path>]``
    on the card, ``plain_ring[<path>]`` on a CPU tensor), the stacked bytes
    and the executed schedule (``RingSchedule.to_row()``).
    """

    def __init__(
        self,
        world_size: int,
        strategy: Strategy,
        trace: Optional[List[Dict[str, Any]]] = None,
        num_slices: int = 1,
        tuner: Optional[Any] = None,
    ) -> None:
        if num_slices != 1:
            raise not_ported("two-level worlds (num_slices > 1)", "the two-level plane slice")
        if tuner is not None:
            raise not_ported("a tuner-attached engine", "the tuner slice")
        if strategy.world_size != world_size:
            raise ValueError(f"strategy for {strategy.world_size} ranks on a world of {world_size}")
        self.world_size = world_size
        self.strategy = strategy
        self.trace = trace

    def _check_world_dim(self, stacked: torch.Tensor, what: str) -> None:
        if stacked.dim() == 0 or stacked.shape[0] != self.world_size:
            raise ValueError(
                f"{what} expects a stacked [world, ...] tensor with leading dim "
                f"{self.world_size}, got shape {tuple(stacked.shape)}"
            )

    def _check_ring_plane(self, wire_dtype: Optional[str], algo: Optional[str]) -> None:
        """Raise for a codec or an algorithm pin: their planes are not ported."""
        env_algo = os.environ.get(COLL_ALGO_ENV, "").strip()
        for pin in (algo, env_algo or None):
            if pin is not None and pin != "ring":
                raise not_ported(f"algo={pin!r}", "the latency plane slice (rd, tree) and the IR slice")
        env_wire = os.environ.get(WIRE_DTYPE_ENV, "").strip()
        wire = env_wire or (wire_dtype if wire_dtype is not None else self.strategy.wire_dtype)
        if wire != "off":
            raise not_ported(f"wire_dtype={wire!r} on the ring", "the fused-codec ring slice (K5a, K5b)")

    def _ring_plan(self, stacked: torch.Tensor, chunk_bytes: Optional[int], rs: bool, ag: bool):
        """The executed schedule of a stacked call: ``strategy.chunk_bytes``
        is the default granularity, an explicit argument overrides it, and
        the ``ADAPCC_RING_CHUNK_BYTES`` env (resolved in the planner)
        overrides both."""
        per_rank = stacked[0].numel()
        # allreduce / reduce-scatter rows carry the full payload per rank;
        # an all-gather row is one chunk of a world × chunk payload
        nelems = per_rank if rs else per_rank * self.world_size
        return ring.plan_ring_schedule(
            nelems, stacked.dtype, self.world_size,
            chunk_bytes if chunk_bytes is not None else self.strategy.chunk_bytes,
            rs=rs, ag=ag,
        )

    def _record_ring(self, primitive: str, plan: ring.RingSchedule, stacked: torch.Tensor) -> None:
        if self.trace is not None:
            impl = "cuda_ring" if stacked.device.type == "cuda" else "plain_ring"
            self.trace.append({
                "primitive": primitive,
                "impl": f"{impl}[{plan.path}]",
                "nbytes": stacked.numel() * stacked.element_size(),
                **plan.to_row(),
            })

    def ring_allreduce(
        self,
        stacked: torch.Tensor,
        chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
        algo: Optional[str] = None,
    ) -> torch.Tensor:
        """Ring sum-allreduce of every row of ``[world, ...]`` (reduce-scatter
        then all-gather in one kernel launch).  ``chunk_bytes=None`` uses the
        strategy's granularity: payloads above it stream through staging
        tiles (K1b), below it each chunk is one stage (K1a)."""
        self._check_world_dim(stacked, "ring_allreduce")
        self._check_ring_plane(wire_dtype, algo)
        plan = self._ring_plan(stacked, chunk_bytes, rs=True, ag=True)
        out = ring.ring_allreduce_stacked(stacked, chunk_bytes=plan.chunk_bytes)
        self._record_ring("allreduce", plan, stacked)
        return out

    def ring_reduce_scatter(
        self,
        stacked: torch.Tensor,
        chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
    ) -> torch.Tensor:
        """Ring reduce-scatter: ``[world, n]`` → ``[world, chunk]`` with row
        ``r`` the fully reduced chunk ``r`` of the flattened, tile-padded
        input (``chunk = tile_round(ceil(n / world))``).  The kernel leaves
        chunk ``(r + 1) % world`` on rank ``r``; one roll restores chunk order."""
        self._check_world_dim(stacked, "ring_reduce_scatter")
        self._check_ring_plane(wire_dtype, None)
        plan = self._ring_plan(stacked, chunk_bytes, rs=True, ag=False)
        out = ring.ring_reduce_scatter_stacked(stacked, chunk_bytes=plan.chunk_bytes)
        self._record_ring("reduce_scatter", plan, stacked)
        return torch.roll(out, 1, dims=0)

    def ring_all_gather(
        self,
        stacked: torch.Tensor,
        chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
    ) -> torch.Tensor:
        """Ring all-gather: ``[world, chunk]`` (row ``r`` = rank ``r``'s
        tile-aligned payload) → ``[world, world, chunk]``, row ``r`` the
        gathered stack as rank ``r`` holds it."""
        self._check_world_dim(stacked, "ring_all_gather")
        self._check_ring_plane(wire_dtype, None)
        plan = self._ring_plan(stacked, chunk_bytes, rs=False, ag=True)
        out = ring.ring_all_gather_stacked(stacked, chunk_bytes=plan.chunk_bytes)
        self._record_ring("all_gather", plan, stacked)
        return out
