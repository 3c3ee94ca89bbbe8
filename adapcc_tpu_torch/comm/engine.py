"""Collective engine: the psum plane and the ring plane.

The port of two parts of :mod:`adapcc_tpu.comm.engine`:

- the flat-collective fast path, per process: a full-world allreduce and the
  masked (subset) allreduce ``psum(where(active, x, identity))``
  (``masked_psum_shard``).  Each runs as one ``torch.distributed.all_reduce``
  over the process group.  Where the JAX functions return a new array, these
  reduce in place on the tensor they are given and return it, except an
  integer AVG, which returns a new float32 tensor (JAX's ``s / denom``).
- the ring entry points of :class:`CollectiveEngine` (``ring_allreduce``,
  ``ring_reduce_scatter``, ``ring_all_gather``), in the JAX engine's
  single-controller form: a stacked ``[world, ...]`` tensor in, the stacked
  result out, through the hand-written ring kernels of
  :mod:`adapcc_tpu_torch.comm.ring` on the card (their plain version on a
  CPU tensor).  A wire codec (the argument, ``Strategy.wire_dtype`` or
  ``ADAPCC_WIRE_DTYPE``) runs the fused codec kernels; where they cannot
  run, the allreduce takes the unfused quant ring
  (:mod:`adapcc_tpu_torch.quant.ring`) and says so once on stderr, and the
  reduce-scatter and all-gather, which have no unfused codec plane, raise.

The strategy-tree and latency planes come in later slices.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from adapcc_tpu_torch.comm import ring
from adapcc_tpu_torch.primitives import ReduceOp, not_ported
from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE, get_codec, resolve_wire_dtype
from adapcc_tpu_torch.quant.ring import wire_ring_allreduce_stacked
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
    the fast path, the active count on the masked path).  A floating ``x``
    is reduced and divided in place; an integer AVG sums ``x`` in place and
    returns the quotient as a new float32 tensor, as JAX's ``s / denom``
    promotes an integer sum."""
    dist.all_reduce(x, op=_DIST_OPS[op], group=group)
    if op is not ReduceOp.AVG:
        return x
    if x.is_floating_point():
        return x.div_(denom)
    return x.to(torch.float32) / denom


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """Full-world allreduce of ``x`` (``lax.psum``; AVG divides by the world
    size, as ``GradSyncHook``'s static full-world path does).  Reduces in
    place and returns ``x``, except an integer AVG, which returns a new
    float32 tensor: callers use the return value."""
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
    """Subset allreduce as one collective: inactive ranks contribute the
    identity, and AVG divides by the active count.  Every rank, active or
    not, receives the result.  Reduces in place and returns ``x``, except an
    integer AVG, which returns a new float32 tensor: callers use the return
    value."""
    mask = torch.as_tensor(active_mask, dtype=torch.bool).cpu()
    world = dist.get_world_size(group)
    if mask.shape != (world,):
        raise ValueError(f"active mask of shape {tuple(mask.shape)} for a world of {world}")
    contrib = _mask_contribution(x, mask, dist.get_rank(group), op)
    return _fused_reduce(contrib, op, _active_count(mask), group)



#: env override of the JAX engine that picks a plane this slice has not
#: ported (a pin the port cannot honour raises instead of running the ring)
COLL_ALGO_ENV = "ADAPCC_COLL_ALGO"


class CollectiveEngine:
    """The ring plane of the JAX ``CollectiveEngine`` over ``world_size``
    ranks whose rows live on one device (the tensor's: the card, or the CPU
    for a CPU tensor).

    ``trace``, when given, is a list that receives one dispatch record per
    call: the primitive, the implementation that ran (``cuda_ring[<path>]``
    on the card, ``plain_ring[<path>]`` on a CPU tensor, ``+<codec>`` with a
    fused codec; ``quant_ring[<codec>]`` for the unfused quant ring, with its
    ``reroute_reason``), the stacked bytes, the executed schedule
    (``RingSchedule.to_row()``) and the wire bytes a rank's payload costs.
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

    def _check_algo(self, algo: Optional[str]) -> None:
        """Raise for an algorithm pin: its planes are not ported."""
        env_algo = os.environ.get(COLL_ALGO_ENV, "").strip()
        for pin in (algo, env_algo or None):
            if pin is not None and pin != "ring":
                raise not_ported(f"algo={pin!r}", "the latency plane slice (rd, tree) and the IR slice")

    def _resolved_wire_dtype(self, wire_dtype: Optional[str]) -> str:
        """The codec a ring dispatch runs: ``ADAPCC_WIRE_DTYPE`` > the
        argument > the strategy's ``wire_dtype``."""
        return resolve_wire_dtype(wire_dtype if wire_dtype is not None else self.strategy.wire_dtype)

    def _ring_plan(self, stacked: torch.Tensor, chunk_bytes: Optional[int], rs: bool, ag: bool,
                   wire_dtype: str = "off", block_size: Optional[int] = None) -> ring.RingSchedule:
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
            rs=rs, ag=ag, wire_dtype=wire_dtype, block_size=block_size,
        )

    @staticmethod
    def _ring_extras(plan: ring.RingSchedule) -> Dict[str, Any]:
        """The trace fields of a ring-kernel dispatch, one definition for the
        three primitives: the executed schedule (the JAX record, and the
        CUDA kernels' own staging slot), and the bytes a rank's payload
        costs on the wire under the executed codec."""
        extras: Dict[str, Any] = {**plan.to_row(), "slot_bytes": plan.slot_bytes}
        if plan.wire_dtype == "off":
            extras["wire_bytes"] = plan.payload_bytes
        else:
            per_elem = get_codec(plan.wire_dtype).wire_bytes_per_element(plan.block_size or 1)
            extras.update(wire_bytes=int(plan.payload_bytes / 4.0 * per_elem), block_size=plan.block_size,
                          fused=True)
        return extras

    def _record(self, primitive: str, impl: str, stacked: torch.Tensor, extras: Dict[str, Any]) -> None:
        if self.trace is not None:
            self.trace.append({"primitive": primitive, "impl": impl,
                               "nbytes": stacked.numel() * stacked.element_size(), **extras})

    def _record_ring(self, primitive: str, plan: ring.RingSchedule, stacked: torch.Tensor) -> None:
        impl = "cuda_ring" if stacked.device.type == "cuda" else "plain_ring"
        suffix = "" if plan.wire_dtype == "off" else f"+{plan.wire_dtype}"
        self._record(primitive, f"{impl}[{plan.path}{suffix}]", stacked, self._ring_extras(plan))

    def _wire_ring_allreduce(self, stacked: torch.Tensor, wire_dtype: str,
                             block_size: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The unfused quant ring (the engine's reroute arm): the result and
        its trace fields."""
        codec = get_codec(wire_dtype)
        out = wire_ring_allreduce_stacked(stacked, codec.name, block_size)
        per_rank = stacked[0].numel()
        extras = {"wire_dtype": codec.name, "block_size": block_size,
                  "wire_bytes": int(per_rank * codec.wire_bytes_per_element(block_size))}
        return out, extras

    def ring_allreduce(
        self,
        stacked: torch.Tensor,
        chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
        quant_block_size: Optional[int] = None,
        algo: Optional[str] = None,
    ) -> torch.Tensor:
        """Ring sum-allreduce of every row of ``[world, ...]`` (reduce-scatter
        then all-gather in one kernel launch).  ``chunk_bytes=None`` uses the
        strategy's granularity: payloads above it stream through staging
        tiles (K1b, K5b), below it each chunk is one stage (K1a, K5a).

        ``wire_dtype=None`` adopts the strategy's codec (``ADAPCC_WIRE_DTYPE``
        overrides both).  A codec runs the fused kernels where
        :func:`~adapcc_tpu_torch.comm.ring.fused_ring_dispatch_reason` allows
        it; otherwise (``ADAPCC_FUSED_WIRE=off``, or a payload dtype or block
        size the codec kernels cannot take) the unfused quant ring runs, the
        trace records ``reroute_reason``, and stderr says so once.  A CUDA
        tensor on a card the kernels were not built for raises."""
        self._check_world_dim(stacked, "ring_allreduce")
        self._check_algo(algo)
        wd = self._resolved_wire_dtype(wire_dtype)
        if wd == "off":
            plan = self._ring_plan(stacked, chunk_bytes, rs=True, ag=True)
            out = ring.ring_allreduce_stacked(stacked, chunk_bytes=plan.chunk_bytes)
            self._record_ring("allreduce", plan, stacked)
            return out
        block = quant_block_size or DEFAULT_BLOCK_SIZE
        reroute = ring.fused_ring_dispatch_reason(stacked.dtype, wd, block)
        if reroute is None:
            plan = self._ring_plan(stacked, chunk_bytes, rs=True, ag=True, wire_dtype=wd, block_size=block)
            out = ring.ring_allreduce_stacked(stacked, chunk_bytes=plan.chunk_bytes, wire_dtype=wd,
                                              block_size=block)
            self._record_ring("allreduce", plan, stacked)
            return out
        ring.note_quant_reroute(wd, reroute)
        out, extras = self._wire_ring_allreduce(stacked, wd, block)
        self._record("allreduce", f"quant_ring[{wd}]", stacked, {**extras, "reroute_reason": reroute})
        return out

    def _ring_wire_args(self, stacked: torch.Tensor, wire_dtype: Optional[str],
                        quant_block_size: Optional[int], primitive: str) -> Tuple[str, Optional[int]]:
        """The codec of a ring reduce-scatter or all-gather, checked against
        the fused kernels: their only codec plane, so a combination they
        cannot run raises instead of running float32 under a codec's name."""
        wd = self._resolved_wire_dtype(wire_dtype)
        if wd == "off":
            return wd, None
        block = quant_block_size or DEFAULT_BLOCK_SIZE
        reason = ring.fused_ring_dispatch_reason(stacked.dtype, wd, block)
        if reason is not None:
            raise ValueError(
                f"{primitive} has no unfused wire data plane (quant/ring.py is allreduce-only): "
                f"wire_dtype={wd!r} cannot run here: {reason}.  Pin wire_dtype='off' (or "
                "ADAPCC_WIRE_DTYPE=off) to run the float32 kernels."
            )
        return wd, block

    def ring_reduce_scatter(
        self,
        stacked: torch.Tensor,
        chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
        quant_block_size: Optional[int] = None,
    ) -> torch.Tensor:
        """Ring reduce-scatter: ``[world, n]`` → ``[world, chunk]`` with row
        ``r`` the fully reduced chunk ``r`` of the flattened, tile-padded
        input (``chunk = tile_round(ceil(n / world))``).  The kernel leaves
        chunk ``(r + 1) % world`` on rank ``r``; one roll restores chunk order.
        A codec (precedence as in :meth:`ring_allreduce`) runs the fused
        kernels, or raises where they cannot run."""
        self._check_world_dim(stacked, "ring_reduce_scatter")
        wd, block = self._ring_wire_args(stacked, wire_dtype, quant_block_size, "ring_reduce_scatter")
        plan = self._ring_plan(stacked, chunk_bytes, rs=True, ag=False, wire_dtype=wd, block_size=block)
        out = ring.ring_reduce_scatter_stacked(stacked, chunk_bytes=plan.chunk_bytes, wire_dtype=wd,
                                               block_size=block)
        self._record_ring("reduce_scatter", plan, stacked)
        return torch.roll(out, 1, dims=0)

    def ring_all_gather(
        self,
        stacked: torch.Tensor,
        chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
        quant_block_size: Optional[int] = None,
    ) -> torch.Tensor:
        """Ring all-gather: ``[world, chunk]`` (row ``r`` = rank ``r``'s
        tile-aligned payload) → ``[world, world, chunk]``, row ``r`` the
        gathered stack as rank ``r`` holds it.  Under a codec each rank's
        chunk is encoded once and every rank holds the same decoded bits."""
        self._check_world_dim(stacked, "ring_all_gather")
        wd, block = self._ring_wire_args(stacked, wire_dtype, quant_block_size, "ring_all_gather")
        plan = self._ring_plan(stacked, chunk_bytes, rs=False, ag=True, wire_dtype=wd, block_size=block)
        out = ring.ring_all_gather_stacked(stacked, chunk_bytes=plan.chunk_bytes, wire_dtype=wd,
                                           block_size=block)
        self._record_ring("all_gather", plan, stacked)
        return out
