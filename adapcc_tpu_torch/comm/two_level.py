"""Two-level (inter-host × intra-host) collective execution, stacked on one
device.

The port of :mod:`adapcc_tpu.comm.two_level`.  A multi-host world is
``num_slices`` slices (hosts: the JAX package's ``dcn`` axis, the network
between nodes here) of ``ici_size`` ranks each (its ``ici`` axis, NVLink
inside a node here); flat rank ``r`` sits at slice ``r // ici_size``, lane
``r % ici_size``.  A strategy runs as

1. a **slice-local** reduction over the lanes (JAX's ``psum`` over ``ici``);
2. the **master-tree rounds** over slice indices (:func:`slice_tree`: the
   strategy's inter-slice edges), reduce then broadcast, like the flat
   schedule plane but between slices only;
3. the broadcast lands on every lane of a slice at once.

A synthesized :class:`~adapcc_tpu_torch.strategy.hierarchy.TwoLevelPlan`
with ``pod_algo="rs-ag"`` runs the composed form instead
(:func:`allreduce_two_level_composed_stacked`: reduce-scatter within the
slice, allreduce of each lane's chunk across the slices by the plan's
leader algorithm, all-gather within the slice), so the slow level carries
``1/ici_size`` of the payload.

Every function here takes the JAX engine's stacked view: a ``[world, ...]``
tensor on one device, row ``r`` rank ``r``'s contribution, and returns the
stacked result as a new tensor.  A lane-level sum (the slice's ``psum``) adds
in the port's order, XLA's in its own: the two agree bit for bit where the
order cannot matter (integer-valued data), within a rounding elsewhere.  The
per-rank form over two process subgroups (lanes and slices) comes with the
per-process slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from adapcc_tpu_torch.comm.engine import (
    _avg_normalize,
    _build_merged_plan,
    _identity_for,
    _masked_copy,
    _MergedPlan,
    _run_groups_rows,
    _segment_sizes,
    _stack_segments,
    _stages,
    _tree_rounds_rows,
    _unstack_segments,
)
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy, Tree

@dataclass(frozen=True)
class TwoLevelMesh:
    """The layout of a world of ``num_slices × ici_size`` ranks (the port's
    counterpart of the JAX package's ``("dcn", "ici")`` mesh).  One slice
    is the flat world."""

    num_slices: int
    ici_size: int


def build_two_level_mesh(
    num_slices: int, ici_size: Optional[int] = None, world_size: Optional[int] = None,
) -> TwoLevelMesh:
    """The ``(num_slices, ici_size)`` layout, ``ici_size`` from
    ``world_size`` when not given.  Rejected loudly: a world that does not
    split into equal slices, a slice of one rank (no intra-host level).
    ``num_slices=1`` is the flat world."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if ici_size is not None and ici_size < 2:
        raise ValueError(
            f"ici_size must be >= 2, got {ici_size}: a slice of one rank has no ICI level — use the flat "
            "ranks mesh"
        )
    if ici_size is None:
        if world_size is None:
            raise ValueError("build_two_level_mesh needs ici_size or world_size")
        if world_size % num_slices:
            raise ValueError(f"{world_size} devices do not split into {num_slices} slices")
        ici_size = world_size // num_slices
        if ici_size < 2:
            raise ValueError(
                f"{world_size} devices over {num_slices} slices leave ici_size={ici_size}: a slice of one "
                "rank has no ICI level — use the flat ranks mesh"
            )
    elif world_size is not None and world_size != num_slices * ici_size:
        raise ValueError(f"need {num_slices * ici_size} devices, have {world_size}")
    return TwoLevelMesh(num_slices, ici_size)


def is_two_level(mesh: TwoLevelMesh) -> bool:
    return mesh.num_slices > 1


def slice_tree(tree: Tree, rank_slice: Sequence[int], num_slices: int) -> Tree:
    """A world tree collapsed to its inter-slice master tree: edges inside
    a slice run as the slice-local reduction; the rest must give every
    non-root slice exactly one inbound edge and reach every slice."""
    children: Dict[int, List[int]] = {}
    inbound: Dict[int, int] = {}
    for c, p in tree.parent.items():
        sp, sc = rank_slice[p], rank_slice[c]
        if sp == sc:
            continue
        if sc in inbound:
            raise ValueError(
                f"slice {sc} has two inbound inter-slice edges (from {inbound[sc]} and {sp}); strategy is not "
                "slice-hierarchical"
            )
        inbound[sc] = sp
        children.setdefault(sp, []).append(sc)
    st = Tree(rank_slice[tree.root], children)
    missing = set(range(num_slices)) - st.ranks
    if missing:
        raise ValueError(f"slices {sorted(missing)} unreachable in the master tree")
    return st


def mesh_rank_slice(num_slices: int, ici_size: int) -> List[int]:
    if num_slices < 1 or ici_size < 1:
        raise ValueError(f"need num_slices/ici_size >= 1, got {num_slices}x{ici_size}")
    return [r // ici_size for r in range(num_slices * ici_size)]


_TL_MERGED_PLANS: Dict = {}


def _two_level_merged_plan(strategy: Strategy, num_slices: int, ici_size: int) -> Optional[_MergedPlan]:
    """The merged plan over the strategy's slice trees (every tree's
    slice-local reduction at once, then the trees' inter-slice rounds
    merged), or None where merging buys nothing."""

    def rounds_of():
        rank_slice = mesh_rank_slice(num_slices, ici_size)
        slice_trees = [slice_tree(t, rank_slice, num_slices) for t in strategy.trees]
        return [st.reduce_rounds() for st in slice_trees], [st.broadcast_rounds() for st in slice_trees]

    return _build_merged_plan(strategy, num_slices, rounds_of, _TL_MERGED_PLANS, key_extra=(num_slices, ici_size))


def _slices(flat: torch.Tensor, num_slices: int, ici_size: int) -> torch.Tensor:
    """``[world, *rest]`` as ``[slices, lanes, *rest]`` (a view)."""
    return flat.view(num_slices, ici_size, *flat.shape[1:])


def _lane_reduce(flat: torch.Tensor, num_slices: int, ici_size: int, op: ReduceOp) -> torch.Tensor:
    """The slice-local reduction (JAX's ``psum``/``pmax`` over ``ici``):
    ``[world, *rest]`` → ``[slices, *rest]``."""
    v = _slices(flat, num_slices, ici_size)
    return v.amax(1) if op is ReduceOp.MAX else v.sum(1, dtype=v.dtype)


def _to_lanes(per_slice: torch.Tensor, ici_size: int) -> torch.Tensor:
    """``[slices, *rest]`` → every lane's row, ``[world, *rest]``."""
    s = per_slice.shape[0]
    return per_slice.unsqueeze(1).expand(s, ici_size, *per_slice.shape[1:]).reshape(s * ici_size,
                                                                                    *per_slice.shape[1:])


def _root_value(row: torch.Tensor) -> torch.Tensor:
    """A root's row as the slice's ``psum`` delivers it when only the root
    contributes: ``-0.0`` arrives as ``+0.0``."""
    return row.clone() if row.dtype == torch.bool else row + 0


def _run_two_level_merged(
    contrib: torch.Tensor, strategy: Strategy, plan: _MergedPlan, num_slices: int, ici_size: int,
    op: ReduceOp, phases: str, root_select: bool = False,
) -> torch.Tensor:
    """One merged two-level execution over ``[world, n]`` (``contrib``, the
    relays' rows already the identity): the trees' segments stacked
    ``[world, T, pad]``, one slice-local reduction of all of them, the
    merged inter-slice groups over the ``[slices, T, pad]`` result.
    ``root_select`` is the broadcast's first level: row ``t`` of a slice
    takes tree ``t``'s root rank's segment (the root slice) or zeros."""
    sizes = _segment_sizes(contrib.shape[1], strategy.tree_shares())
    buf = _stack_segments(contrib, sizes, _identity_for(op, contrib.dtype))
    if root_select:
        acc = torch.zeros((num_slices, *buf.shape[1:]), dtype=buf.dtype, device=buf.device)
        for t, tree in enumerate(strategy.trees):
            acc[tree.root // ici_size, t] = _root_value(buf[tree.root, t])
    else:
        acc = _lane_reduce(buf, num_slices, ici_size, op)
    _run_groups_rows(acc, _stages(plan.reduce_groups, plan.broadcast_groups, op, phases))
    return _to_lanes(_unstack_segments(acc, sizes), ici_size)


def _per_tree(
    contrib: torch.Tensor, strategy: Strategy, num_slices: int, ici_size: int, op: ReduceOp, phases: str,
    root_select: bool = False,
) -> torch.Tensor:
    """The unmerged two-level execution over ``[world, n]``: each tree's
    segment reduced over the lanes (or, for a broadcast, its root's value on
    the root slice), then its master tree's rounds between the slices."""
    rank_slice = mesh_rank_slice(num_slices, ici_size)
    n = contrib.shape[1]
    per_slice = torch.empty((num_slices, n), dtype=contrib.dtype, device=contrib.device)
    off = 0
    for tree, size in zip(strategy.trees, _segment_sizes(n, strategy.tree_shares())):
        if size == 0:
            continue
        seg = contrib[:, off:off + size]
        acc = per_slice[:, off:off + size]
        if root_select:
            acc.zero_()
            acc[rank_slice[tree.root]] = _root_value(seg[tree.root])
        else:
            acc.copy_(_lane_reduce(seg, num_slices, ici_size, op))
        _tree_rounds_rows(acc, slice_tree(tree, rank_slice, num_slices), op, phases)
        off += size
    return _to_lanes(per_slice, ici_size)


def _schedule_two_level(
    stacked: torch.Tensor, active_mask: Optional[torch.Tensor], strategy: Strategy, num_slices: int,
    ici_size: int, op: ReduceOp, phases: str,
) -> torch.Tensor:
    world = num_slices * ici_size
    flat = stacked.reshape(world, -1)
    if flat.shape[1] == 0:
        return stacked.clone()
    root_select = phases == "broadcast"
    contrib = flat if root_select else _masked_copy(flat, active_mask, _identity_for(op, flat.dtype))
    plan = _two_level_merged_plan(strategy, num_slices, ici_size)
    if plan is not None:
        out = _run_two_level_merged(contrib, strategy, plan, num_slices, ici_size, op, phases, root_select)
    else:
        out = _per_tree(contrib, strategy, num_slices, ici_size, op, phases, root_select)
    return out.reshape(stacked.shape)


def allreduce_two_level_stacked(
    stacked: torch.Tensor, active_mask: torch.Tensor, strategy: Strategy, num_slices: int, ici_size: int,
    op: ReduceOp = ReduceOp.SUM,
) -> torch.Tensor:
    """The strategy allreduce on a two-level world (JAX's
    ``allreduce_two_level_shard``): relays contribute the identity and
    receive; AVG divides by the active count."""
    out = _schedule_two_level(stacked, active_mask, strategy, num_slices, ici_size, op, "both")
    return _avg_normalize(out, active_mask, op)


def reduce_two_level_stacked(
    stacked: torch.Tensor, active_mask: torch.Tensor, strategy: Strategy, num_slices: int, ici_size: int,
    op: ReduceOp = ReduceOp.SUM,
) -> torch.Tensor:
    """Two-level reduce (``reduce_two_level_shard``): every lane of a
    tree's root slice holds the total for its segment, other slices their
    partials."""
    out = _schedule_two_level(stacked, active_mask, strategy, num_slices, ici_size, op, "reduce")
    return _avg_normalize(out, active_mask, op)


def broadcast_two_level_stacked(
    stacked: torch.Tensor, strategy: Strategy, num_slices: int, ici_size: int,
) -> torch.Tensor:
    """Two-level broadcast (``broadcast_two_level_shard``): each tree's root
    rank's segment across its slice, then down the master tree."""
    return _schedule_two_level(stacked, None, strategy, num_slices, ici_size, ReduceOp.SUM, "broadcast")


def all_to_all_two_level_stacked(stacked: torch.Tensor, num_slices: int, ici_size: int) -> torch.Tensor:
    """The hierarchical all-to-all (``all_to_all_two_level_shard``):
    ``stacked[src, dst]`` → rank ``dst``'s row ``src``.  JAX's two hops
    (lane blocks within the slice, then slice blocks lane to lane) deliver
    the flat exchange's bits, which is what one transpose of the rows
    gives."""
    world = num_slices * ici_size
    if stacked.dim() < 2 or stacked.shape[1] != world:
        raise ValueError(f"all_to_all payload leading dim {tuple(stacked.shape[1:2])} != world {world}")
    return stacked.transpose(0, 1).contiguous()


def all_gather_two_level_stacked(stacked: torch.Tensor, num_slices: int, ici_size: int) -> torch.Tensor:
    """The hierarchical all-gather (``all_gather_two_level_shard``, DCN
    first): every rank's row the gathered stack in flat rank order."""
    world = num_slices * ici_size
    return stacked.unsqueeze(0).expand(world, *stacked.shape).contiguous()


def reduce_scatter_two_level_stacked(flat: torch.Tensor, num_slices: int, ici_size: int) -> torch.Tensor:
    """The hierarchical reduce-scatter, SUM (``reduce_scatter_two_level_
    shard``): ``[world, n]`` → ``[world, n / world]``, rank ``(s, i)`` the
    reduced flat chunk ``s·I + i``; summed over the lanes first, then over
    the slices, as JAX scatters ICI first."""
    world = num_slices * ici_size
    n = flat[0].numel()
    if n % world:
        raise ValueError(f"reduce_scatter payload ({n} elems) must divide the world ({world})")
    per_slice = _lane_reduce(flat.reshape(world, n), num_slices, ici_size, ReduceOp.SUM)
    return per_slice.sum(0, dtype=flat.dtype).view(world, n // world)


def allreduce_two_level_composed_stacked(
    stacked: torch.Tensor, active_mask: torch.Tensor, plan, num_slices: int, ici_size: int,
    op: ReduceOp = ReduceOp.SUM,
) -> torch.Tensor:
    """The synthesized two-level allreduce (``allreduce_two_level_composed_
    shard``, a plan with ``pod_algo="rs-ag"``): (1) reduce-scatter within
    the slice, lane ``i`` the slice's reduced chunk ``i``; (2) each lane's
    chunk allreduced across the slices by the plan's leader algorithm, the
    leader strategy's trees (``tree``) or the segmented ring (``rs-ag``);
    (3) all-gather within the slice.  Relays contribute zeros and receive;
    AVG divides by the active count.  MAX raises (no reduce-scatter has a
    max); the payload is zero-padded to the world and cut back."""
    if op is ReduceOp.MAX:
        raise ValueError(
            "the composed two-level path supports SUM/AVG only (psum_scatter has no max variant); MAX rides "
            "the projected schedule path"
        )
    world = num_slices * ici_size
    flat = stacked.reshape(world, -1)
    n = flat.shape[1]
    contrib = _masked_copy(flat, active_mask, 0)
    pad = (-n) % world
    if pad:
        contrib = torch.cat([contrib, contrib.new_zeros((world, pad))], dim=1)
    # (1) the slice's reduction: lane i's chunk i is per_slice[:, i]
    per_slice = _lane_reduce(contrib, num_slices, ici_size, op)
    chunks = per_slice.view(num_slices, ici_size, -1)
    # (2) each chunk across the slices
    if plan.leader_algo == "rs-ag":
        per_slice = per_slice.sum(0, dtype=per_slice.dtype).expand(num_slices, -1)
    else:
        sizes = _segment_sizes(chunks.shape[2], plan.leader_strategy.tree_shares())
        off = 0
        for tree, size in zip(plan.leader_strategy.trees, sizes):
            if size == 0:
                continue
            _tree_rounds_rows(chunks[:, :, off:off + size], tree, op, "both")
            off += size
    # (3) the all-gather within the slice
    full = _to_lanes(per_slice, ici_size)[:, :n]
    return _avg_normalize(full.reshape(stacked.shape), active_mask, op)
