"""Collective engine: the psum plane, the schedule plane and the ring plane.

The port of :mod:`adapcc_tpu.comm.engine`, in two forms:

- **per rank**, one process per rank over a process group:

  - the flat-collective fast path: a full-world allreduce and the masked
    (subset) allreduce ``psum(where(active, x, identity))``
    (``masked_psum_shard``), each one ``torch.distributed.all_reduce``.
    Where the JAX functions return a new array, these reduce in place on the
    tensor they are given and return it, except an integer AVG, which
    returns a new float32 tensor (JAX's ``s / denom``);
  - the strategy-tree ("schedule") plane with relay masks
    (``allreduce_shard``, ``reduce_shard``, ``broadcast_shard`` and the
    fused ``reduce_fastpath_shard`` / ``broadcast_fastpath_shard``): each
    tree round, or each merged group of rounds, is one
    ``dist.batch_isend_irecv``; a rank with no edge in it posts nothing.
    These return new tensors, as JAX does;
  - the bucket-rolling entry points ``chunked_psum_shard`` and
    ``chunked_allreduce_shard`` (the overlapped sync's engine half): the
    payload as independent collectives of at most ``chunk_bytes``, with an
    ``async_op`` path that returns a :class:`PendingCollective`.

- **stacked**, the JAX engine's single-controller form: the entry points of
  :class:`CollectiveEngine` take a ``[world, ...]`` tensor (row ``r`` = rank
  ``r``'s contribution) on one device and return the stacked result on it.
  ``all_reduce``, ``reduce`` and ``broadcast`` run the schedule plane, a
  round being a gather of the sources' rows and a combine (add, max or
  adopt) into the destinations' rows, or, unmasked and with the fast path
  allowed, one torch reduction over the rows (trace impl ``torch_fused``,
  where JAX runs XLA's psum); ``all_gather``, ``all_to_all`` and
  ``reduce_scatter`` run their flat paths.  ``all_reduce`` and
  ``ring_allreduce`` also run the latency plane (:mod:`adapcc_tpu_torch.
  comm.latency`: recursive halving/doubling ``rd``, the binomial ``tree``),
  by pin or by the size-adaptive selector, and ``reduce_scatter`` and
  ``all_gather`` its ``rd`` halves by pin; an engine over ``num_slices > 1``
  runs every collective on the two-level plane (:mod:`adapcc_tpu_torch.
  comm.two_level`).  The ring entry points
  (``ring_allreduce``, ``ring_reduce_scatter``, ``ring_all_gather``) run
  the hand-written ring kernels of :mod:`adapcc_tpu_torch.comm.ring` on the
  card (their plain version on a CPU tensor).  A wire codec (the argument,
  ``Strategy.wire_dtype`` or ``ADAPCC_WIRE_DTYPE``) runs the fused codec
  kernels; where they cannot run, the allreduce takes the unfused quant ring
  (:mod:`adapcc_tpu_torch.quant.ring`) and says so once on stderr, and the
  reduce-scatter and all-gather, which have no unfused codec plane, raise.

Both forms of the schedule plane share one set of round tables
(``Tree.reduce_rounds`` / ``broadcast_rounds`` and the merged plan) and give
the JAX package's bits, op for op:

- a round reads the state from before the round (``lax.ppermute`` sends
  every source's value before any destination combines);
- the unmerged SUM path adds what a round delivers to *every* rank, zeros
  included, so a rank that is no destination of a round turns ``-0.0``
  into ``+0.0`` (``acc = acc + recvd``); the merged path adds on
  destinations only;
- relays contribute the op's identity and still forward; AVG divides by the
  active count in the result's dtype, an integer sum by true division to
  float32, and by a tensor on the result's device (torch on CUDA turns a
  division by a Python scalar into a multiply by its reciprocal).

``all_reduce`` and ``ring_allreduce`` also run the IR plane (``algo="ir"``):
the engine's :class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram` (pinned
by :meth:`CollectiveEngine.set_schedule_program`, else derived from the
strategy), verified once per fingerprint, through the optimizer passes in
force (``ADAPCC_IR_OPT``) and the stacked executor of
:mod:`adapcc_tpu_torch.compiler.lower`; per rank, :func:`ir_allreduce_shard`
runs a program over a process group.
"""

from __future__ import annotations

import os
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from adapcc_tpu_torch.comm import ring
from adapcc_tpu_torch.comm import latency as lat
from adapcc_tpu_torch.comm.latency import latency_algo_unsupported_reason, resolve_coll_algo
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE, WIRE_DTYPE_ENV, get_codec, resolve_wire_dtype
from adapcc_tpu_torch.quant.ring import wire_ring_allreduce_stacked
from adapcc_tpu_torch.strategy.ir import CommRound, Strategy, Tree
from adapcc_tpu_torch.tuner import CollectiveTuner, tuner_mode
from adapcc_tpu_torch.tuner.measure import sync_outputs
from adapcc_tpu_torch.tuner.policy import (
    A2A_XLA_PATH,
    ALGO_OF_PATH,
    ALGO_PATHS,
    IR_OPT_PATH,
    IR_PATH,
    NO_CHUNK,
    QUANT_PATH,
    TWO_LEVEL_PATH,
    XLA_PATH,
)

MaskLike = Union[torch.Tensor, Sequence[bool]]

#: default KV-stream granularity: one chunk per 4 MiB of wire payload (the
#: reference's transmission contexts moved 4 MB IPC chunks); the trace
#: records the chunk count
KV_TRANSFER_CHUNK_BYTES = 4 << 20

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVG: dist.ReduceOp.SUM,  # divided afterwards, by world or active count
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


class EpochMismatch(RuntimeError):
    """A collective was issued against a world epoch that is no longer
    current (the engine's plan was swapped by :meth:`CollectiveEngine.
    advance_epoch`).  Retryable: the caller refreshes its epoch token
    (``current``) and issues again."""

    def __init__(self, issued: int, current: int) -> None:
        super().__init__(
            f"collective issued against dead epoch {issued} (current epoch is {current}); "
            "refresh the epoch token and retry"
        )
        self.issued = issued
        self.current = current


def _identity_for(op: ReduceOp, dtype: torch.dtype) -> float:
    if op is ReduceOp.MAX:
        return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
    return 0


def _divide(x: torch.Tensor, op: ReduceOp, denom: int) -> torch.Tensor:
    """AVG's division of a reduced ``x`` by ``denom``: a floating ``x`` in
    place, an integer sum as a new float32 tensor (JAX's ``s / denom``
    promotes it)."""
    if op is not ReduceOp.AVG:
        return x
    if x.is_floating_point():
        return x.div_(denom)
    return x.to(torch.float32) / denom


def _fused_reduce(x: torch.Tensor, op: ReduceOp, denom: int, group=None) -> torch.Tensor:
    """One collective for the op; AVG divides by ``denom`` (the full world on
    the fast path, the active count on the masked path).  A floating ``x``
    is reduced and divided in place; an integer AVG sums ``x`` in place and
    returns the quotient as a new float32 tensor, as JAX's ``s / denom``
    promotes an integer sum."""
    dist.all_reduce(x, op=_DIST_OPS[op], group=group)
    return _divide(x, op, denom)


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


def _as_mask(active_mask: MaskLike, world: int) -> torch.Tensor:
    """A ``[world]`` bool mask on the host."""
    mask = torch.as_tensor(active_mask, dtype=torch.bool).cpu()
    if mask.shape != (world,):
        raise ValueError(f"active mask of shape {tuple(mask.shape)} for a world of {world}")
    return mask


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
    mask = _as_mask(active_mask, dist.get_world_size(group))
    contrib = _mask_contribution(x, mask, dist.get_rank(group), op)
    return _fused_reduce(contrib, op, _active_count(mask), group)


# --------------------------------------------------------------------------- #
# the schedule plane's round tables (shared by both forms)
# --------------------------------------------------------------------------- #


def _dst_mask(round_: CommRound, world: int) -> List[bool]:
    m = [False] * world
    for _, d in round_.edges:
        m[d] = True
    return m


def _segment_sizes(n: int, shares: Sequence[float]) -> List[int]:
    """Static split of ``n`` elements across trees, proportional to shares
    (``int(n * s)``, then the remainder dealt one by one from tree 0)."""
    sizes = [int(n * s) for s in shares]
    rem = n - sum(sizes)
    i = 0
    while rem > 0:
        sizes[i % len(sizes)] += 1
        rem -= 1
        i += 1
    return sizes


#: one merged group: ``(perm, src_row, dst_row, is_dst)``, the edges of one
#: exchange and, per rank, the tree whose stacked row it sends and the tree
#: whose row it combines into (and whether it receives at all)
_Group = Tuple[Tuple[Tuple[int, int], ...], Tuple[int, ...], Tuple[int, ...], Tuple[bool, ...]]


class _MergedPlan:
    """Per-round send/receive tables of merged multi-tree execution: the
    trees' round-k edges combined into as few partial permutations as the
    contract allows, each rank sending its ``src_row``-th segment and
    folding what it receives into its ``dst_row``-th."""

    def __init__(self, reduce_groups: List[_Group], broadcast_groups: List[_Group]) -> None:
        self.reduce_groups = reduce_groups
        self.broadcast_groups = broadcast_groups


class _Prepared:
    """What one stacked schedule-plane dispatch derives on the host, kept by
    the engine under its cache key: the merged plan (None: the trees'
    rounds one by one), the trees' segment sizes and the pad value (the
    op's identity)."""

    __slots__ = ("plan", "sizes", "pad")

    def __init__(self, plan: Optional[_MergedPlan], sizes: List[int], pad: float) -> None:
        self.plan = plan
        self.sizes = sizes
        self.pad = pad


def _color_rounds(per_tree_rounds: Sequence[Sequence[CommRound]], world: int) -> List[_Group]:
    """Align trees' rounds by index and split each union greedily into
    partial permutations."""
    groups: List[_Group] = []
    depth = max((len(r) for r in per_tree_rounds), default=0)
    for k in range(depth):
        edges: List[Tuple[int, int, int]] = []  # (src, dst, tree)
        for ti, rounds in enumerate(per_tree_rounds):
            if k < len(rounds):
                edges.extend((s, d, ti) for s, d in rounds[k].edges)
        colors: List[List[Tuple[int, int, int]]] = []
        for e in edges:
            for c in colors:
                if all(e[0] != s and e[1] != d for s, d, _ in c):
                    c.append(e)
                    break
            else:
                colors.append([e])
        for c in colors:
            src_row, dst_row, is_dst = [0] * world, [0] * world, [False] * world
            for s, d, t in c:
                src_row[s] = t
                dst_row[d] = t
                is_dst[d] = True
            groups.append((tuple((s, d) for s, d, _ in c), tuple(src_row), tuple(dst_row), tuple(is_dst)))
    return groups


#: merged plans by (strategy fingerprint, shares); None = not merged
_MERGED_PLANS: Dict[Tuple, Optional[_MergedPlan]] = {}

#: env knob of the merged executor (the A/B against per-tree rounds)
MERGE_ROUNDS_ENV = "ADAPCC_MERGE_ROUNDS"

#: one deprecation warning per process for the reference's "boardcast"
_BOARDCAST_WARNED = False


def _merged_env_disabled() -> bool:
    """``ADAPCC_MERGE_ROUNDS=0`` turns round merging off everywhere; an
    unknown value raises (a typo silently keeping the default would
    invalidate the A/B)."""
    val = os.environ.get(MERGE_ROUNDS_ENV, "1").strip().lower()
    if val in ("0", "off", "false", "no"):
        return True
    if val in ("", "1", "on", "true", "yes"):
        return False
    raise ValueError(f"{MERGE_ROUNDS_ENV}={val!r}: expected 1/on/true or 0/off/false")


def _build_merged_plan(
    strategy: Strategy,
    world: int,
    rounds_of: Callable[[], Tuple[list, list]],
    cache: Dict,
    key_extra: Tuple = (),
) -> Optional[_MergedPlan]:
    """The merged plan, or None where merging buys nothing: the env switch,
    a single tree, skewed shares (``max > 2 · min``: stacking pads every
    segment to the largest) or a coloring that does not cut the round
    count.  Cached by strategy fingerprint and shares."""
    if _merged_env_disabled():
        return None
    shares = strategy.tree_shares()
    key = (strategy.fingerprint(), *key_extra, tuple(round(s, 6) for s in shares))
    if key in cache:
        return cache[key]
    plan: Optional[_MergedPlan] = None
    if len(strategy.trees) > 1 and max(shares) <= 2.0 * min(shares):
        reduce_rounds, bcast_rounds = rounds_of()
        rg = _color_rounds(reduce_rounds, world)
        bg = _color_rounds(bcast_rounds, world)
        n_sequential = sum(len(r) for r in reduce_rounds) + sum(len(r) for r in bcast_rounds)
        if len(rg) + len(bg) < n_sequential:
            plan = _MergedPlan(rg, bg)
    cache[key] = plan
    return plan


def _merged_plan(strategy: Strategy) -> Optional[_MergedPlan]:
    return _build_merged_plan(
        strategy, strategy.world_size,
        lambda: ([t.reduce_rounds() for t in strategy.trees], [t.broadcast_rounds() for t in strategy.trees]),
        _MERGED_PLANS,
    )


def _avg_normalize(result: torch.Tensor, active_mask: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """AVG divides by the active count in the result's dtype (an integer sum
    by true division, to float32), as a tensor on the result's device."""
    if op is not ReduceOp.AVG:
        return result
    n_active = torch.full((), _active_count(active_mask), dtype=result.dtype, device=result.device)
    return result / n_active


def _stack_segments(flat: torch.Tensor, sizes: List[int], pad_value: float) -> torch.Tensor:
    """``[rows, n]`` → a new ``[rows, T, max(sizes)]``: each tree's segment
    of every row, padded with ``pad_value`` (the op's identity)."""
    rows, pad = flat.shape[0], max(sizes)
    if all(size == pad for size in sizes):
        return flat.reshape(rows, len(sizes), pad).clone()
    buf = torch.full((rows, len(sizes), pad), pad_value, dtype=flat.dtype, device=flat.device)
    off = 0
    for t, size in enumerate(sizes):
        buf[:, t, :size].copy_(flat[:, off:off + size])
        off += size
    return buf


def _unstack_segments(buf: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    if all(size == buf.shape[2] for size in sizes):
        return buf.view(buf.shape[0], -1)
    return torch.cat([buf[:, t, :size] for t, size in enumerate(sizes)], dim=1)


def _stages(reduce_groups: list, broadcast_groups: list, op: ReduceOp, phases: str) -> List[Tuple[list, str]]:
    """The merged phases to run (``phases``: reduce, broadcast or both), each
    with its combine."""
    stages = []
    if phases in ("reduce", "both"):
        stages.append((reduce_groups, "max" if op is ReduceOp.MAX else "add"))
    if phases in ("broadcast", "both"):
        stages.append((broadcast_groups, "adopt"))
    return stages


def _combine_into(dst: torch.Tensor, recvd: torch.Tensor, combine: str) -> None:
    """Fold ``recvd`` into ``dst`` in place: add, max, or adopt (broadcast).
    The same IEEE operation, element for element, as JAX's combine."""
    if combine == "add":
        dst.add_(recvd)
    elif combine == "max":
        torch.maximum(dst, recvd, out=dst)
    else:
        dst.copy_(recvd)


# --------------------------------------------------------------------------- #
# the schedule plane, per rank: one process per rank over a process group
# --------------------------------------------------------------------------- #

#: process groups that have run a collective (NCCL wants every rank of a
#: group in its first call, each with its device set; a partial P2P batch
#: may follow)
_WARMED: "weakref.WeakSet" = weakref.WeakSet()


def _warm(group, device: torch.device) -> None:
    pg = dist.group.WORLD if group is None else group
    if pg in _WARMED:
        return
    if dist.get_backend(pg) == "nccl":
        dist.all_reduce(torch.zeros(1, device=device), group=pg)
    _WARMED.add(pg)


def _exchange(send: Optional[torch.Tensor], dst: Optional[int], src: Optional[int],
              like: torch.Tensor, group) -> Optional[torch.Tensor]:
    """One round for this rank: send ``send`` to ``dst`` and receive a
    ``like``-shaped tensor from ``src`` (either may be None) as one
    ``batch_isend_irecv``; returns what arrived.  A rank with nothing to do
    posts nothing (the call rejects an empty list)."""
    ops = []
    if dst is not None:
        peer = dst if group is None else dist.get_global_rank(group, dst)
        ops.append(dist.P2POp(dist.isend, send, peer, group))
    recvd = None
    if src is not None:
        recvd = torch.empty_like(like)
        peer = src if group is None else dist.get_global_rank(group, src)
        ops.append(dist.P2POp(dist.irecv, recvd, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recvd


def _peers(edges: Sequence[Tuple[int, int]], me: int) -> Tuple[Optional[int], Optional[int]]:
    """``(dst, src)`` of ``me`` in one partial permutation."""
    dst = next((d for s, d in edges if s == me), None)
    src = next((s for s, d in edges if d == me), None)
    return dst, src


def _shard_setup(x: torch.Tensor, strategy: Strategy, group) -> int:
    world = dist.get_world_size(group)
    if strategy.world_size != world:
        raise ValueError(f"strategy for {strategy.world_size} ranks on a group of {world}")
    _warm(group, x.device)
    return dist.get_rank(group)


def _run_tree_rank(acc: torch.Tensor, tree: Tree, me: int, op: ReduceOp, phases: str, group) -> torch.Tensor:
    """One tree's rounds on this rank's segment ``acc`` (owned, updated in
    place where it can be)."""
    if phases in ("reduce", "both"):
        normalized = False
        for rnd in tree.reduce_rounds():
            dst, src = _peers(rnd.edges, me)
            recvd = _exchange(acc, dst, src, acc, group)
            if op is ReduceOp.MAX:
                if recvd is not None:
                    acc = torch.maximum(acc, recvd)
            elif recvd is not None:
                acc.add_(recvd)
            elif acc.is_floating_point() and not normalized:
                # JAX adds the zeros ppermute delivers here: -0.0 + 0.0 is
                # +0.0, and once normalized a row stays so
                acc.add_(0)
                normalized = True
    if phases in ("broadcast", "both"):
        for rnd in tree.broadcast_rounds():
            dst, src = _peers(rnd.edges, me)
            recvd = _exchange(acc, dst, src, acc, group)
            if recvd is not None:
                acc = recvd
    return acc


def _run_merged_rank(flat: torch.Tensor, sizes: List[int], plan: _MergedPlan, me: int, op: ReduceOp,
                     phases: str, group) -> torch.Tensor:
    """The merged groups on this rank's segments, stacked ``[T, pad]`` with
    each tree's segment padded by the op's identity."""
    buf = _stack_segments(flat[None], sizes, _identity_for(op, flat.dtype))[0]
    for groups, combine in _stages(plan.reduce_groups, plan.broadcast_groups, op, phases):
        for perm, src_row, dst_row, _ in groups:
            dst, src = _peers(perm, me)
            recvd = _exchange(buf[src_row[me]], dst, src, buf[0], group)
            if recvd is not None:
                _combine_into(buf[dst_row[me]], recvd, combine)
    return _unstack_segments(buf[None], sizes)[0]


def _schedule_rank(x: torch.Tensor, active_mask: Optional[torch.Tensor], strategy: Strategy, op: ReduceOp,
                   phases: str, group) -> torch.Tensor:
    """This rank's part of a schedule-plane collective (before AVG)."""
    me = _shard_setup(x, strategy, group)
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return x
    masked = active_mask is not None and not bool(active_mask[me])
    sizes = _segment_sizes(flat.numel(), strategy.tree_shares())
    plan = _merged_plan(strategy)
    if plan is not None:
        if masked:
            flat = torch.full_like(flat, _identity_for(op, flat.dtype))
        return _run_merged_rank(flat, sizes, plan, me, op, phases, group).reshape(x.shape)
    outs = []
    off = 0
    for tree, size in zip(strategy.trees, sizes):
        if size == 0:
            continue
        seg = flat[off:off + size].clone()
        off += size
        if masked:
            seg.fill_(_identity_for(op, seg.dtype))
        outs.append(_run_tree_rank(seg, tree, me, op, phases, group))
    return (torch.cat(outs) if len(outs) > 1 else outs[0]).reshape(x.shape)


def allreduce_shard(
    x: torch.Tensor,
    active_mask: MaskLike,
    strategy: Strategy,
    op: ReduceOp = ReduceOp.SUM,
    group=None,
) -> torch.Tensor:
    """Strategy-shaped allreduce of this rank's ``x`` over ``group``: every
    rank, active or not, receives the result (relays forward and receive).
    ``active_mask`` is a ``[world]`` bool mask; inactive ranks contribute
    the op's identity and AVG divides by the active count.  Returns a new
    tensor."""
    mask = _as_mask(active_mask, strategy.world_size)
    return _avg_normalize(_schedule_rank(x, mask, strategy, op, "both", group), mask, op)


#: program fingerprints :func:`ir_allreduce_shard` has verified, and its
#: optimized programs by (base fingerprint, passes)
_IR_VERIFIED: set = set()
_IR_OPTIMIZED: Dict[Tuple, Any] = {}


def _certify(program, verified: set) -> None:
    """Verify ``program`` once per fingerprint (``verified`` remembers)."""
    from adapcc_tpu_torch.compiler.verify import verify_program

    fp = program.fingerprint()
    if fp not in verified:
        verify_program(program)
        verified.add(fp)


def _optimized_program(program, verified: set, optimized: Dict[Tuple, Any]):
    """``program`` certified and through the optimizer passes in force
    (``ADAPCC_IR_OPT``), memoized per (base fingerprint, passes); a program
    the passes leave alone comes back as itself."""
    from adapcc_tpu_torch.compiler.optimize import optimize_program, resolve_ir_opt

    _certify(program, verified)
    passes = resolve_ir_opt()
    key = (program.fingerprint(), passes)
    out = optimized.get(key)
    if out is None:
        out = optimize_program(program, passes=passes)
        verified.add(out.fingerprint())
        optimized[key] = out
    return out


def ir_allreduce_shard(x: torch.Tensor, program, op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """The IR plane per rank: this rank's ``x`` through ``program`` (a
    ``compiler.ScheduleProgram`` for the group's world, verified once per
    fingerprint and optimized by the passes in force) over ``group``, one
    ``batch_isend_irecv`` a color and wire array.  Returns a new tensor."""
    from adapcc_tpu_torch.compiler.lower import execute_program_shard

    return execute_program_shard(x, _optimized_program(program, _IR_VERIFIED, _IR_OPTIMIZED), group, op)


class PendingCollective:
    """A collective issued with ``async_op=True``: :meth:`wait` waits for its
    work handles (on NCCL: makes the current stream wait for them) and
    returns its result; a second call returns the same tensor."""

    def __init__(self, works: Sequence[Any], finish: Callable[[], torch.Tensor]) -> None:
        self._works = list(works)
        self._finish: Optional[Callable[[], torch.Tensor]] = finish
        self._result: Optional[torch.Tensor] = None

    @classmethod
    def done(cls, result: torch.Tensor) -> "PendingCollective":
        return cls((), lambda: result)

    def wait(self) -> torch.Tensor:
        if self._finish is not None:
            for work in self._works:
                work.wait()
            self._result, self._finish, self._works = self._finish(), None, []
        return self._result


def _chunk_bounds(nelems: int, chunk_elems: int) -> List[Tuple[int, int]]:
    """Static ``(offset, length)`` split of a flat payload at the chunk
    granularity; the tail chunk keeps the remainder."""
    return [(off, min(chunk_elems, nelems - off)) for off in range(0, nelems, chunk_elems)]


def _chunk_elems(flat: torch.Tensor, chunk_bytes: Optional[int]) -> int:
    """Elements a chunk: ``ADAPCC_RING_CHUNK_BYTES`` > ``chunk_bytes`` > the
    default, over the payload's element size."""
    return max(1, ring.resolve_chunk_bytes(chunk_bytes) // flat.element_size())


def _tree_allreduce_chunk(seg: torch.Tensor, tree: Tree, active: bool, me: int, op: ReduceOp,
                          group) -> torch.Tensor:
    """One chunk's allreduce through one tree's rounds (before AVG): the unit
    the chunked dispatch fans out over.  ``active``: this rank contributes;
    a relay contributes the op's identity and still forwards."""
    acc = seg.clone() if active else torch.full_like(seg, _identity_for(op, seg.dtype))
    return _run_tree_rank(acc, tree, me, op, "both", group)


def chunked_allreduce_shard(
    x: torch.Tensor,
    active_mask: MaskLike,
    strategy: Strategy,
    op: ReduceOp = ReduceOp.SUM,
    chunk_bytes: Optional[int] = None,
    group=None,
    async_op: bool = False,
) -> Union[torch.Tensor, PendingCollective]:
    """Bucket-rolling strategy allreduce: the payload as independent
    collectives of at most ``chunk_bytes`` each (``ADAPCC_RING_CHUNK_BYTES``
    overrides), the engine half of the per-bucket rolling sync.

    Bitwise contract, as in JAX: the payload is split across the trees by
    share over the whole payload (``_segment_sizes``) first, and only then
    chunked within each tree's segment, each chunk through that tree's own
    rounds; AVG divides once over the concatenation.  Every element rides
    the tree and the add order of :func:`allreduce_shard`.  A payload of one
    chunk is :func:`allreduce_shard` itself.  Returns a new tensor, or with
    ``async_op`` a :class:`PendingCollective`.  A round's adds depend on its
    receives, so the rounds are issued here in order: on NCCL neither they
    nor the adds block the host (each wait only orders the current stream),
    on gloo they have completed when this returns."""
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return PendingCollective.done(x) if async_op else x
    chunk_elems = _chunk_elems(flat, chunk_bytes)
    if flat.numel() <= chunk_elems:
        out = allreduce_shard(x, active_mask, strategy, op, group)
        return PendingCollective.done(out) if async_op else out
    me = _shard_setup(x, strategy, group)
    mask = _as_mask(active_mask, strategy.world_size)
    active = bool(mask[me])
    outs: List[torch.Tensor] = []
    off = 0
    for tree, size in zip(strategy.trees, _segment_sizes(flat.numel(), strategy.tree_shares())):
        if size == 0:
            continue
        seg = flat[off:off + size]
        off += size
        outs.extend(_tree_allreduce_chunk(seg[o:o + n], tree, active, me, op, group)
                    for o, n in _chunk_bounds(size, chunk_elems))
    out = _avg_normalize(torch.cat(outs) if len(outs) > 1 else outs[0], mask, op).reshape(x.shape)
    return PendingCollective.done(out) if async_op else out


def chunked_psum_shard(
    x: torch.Tensor,
    active_mask: Optional[MaskLike],
    op: ReduceOp = ReduceOp.SUM,
    chunk_bytes: Optional[int] = None,
    world: Optional[int] = None,
    group=None,
    async_op: bool = False,
) -> Union[torch.Tensor, PendingCollective]:
    """Bucket-rolling flat allreduce, the psum-plane twin of
    :func:`chunked_allreduce_shard`: one ``all_reduce`` a chunk of at most
    ``chunk_bytes`` (``ADAPCC_RING_CHUNK_BYTES`` overrides), each issued
    with ``async_op=True``.  ``active_mask=None`` is the static full world
    (``world`` is AVG's denominator); a mask gives the chunks
    :func:`masked_psum_shard`'s semantics.  A sum is elementwise, so the
    result is the unchunked one bit for bit.

    Reduces in place where ``x`` is contiguous and returns the result (an
    integer AVG: a new float32 tensor); with ``async_op`` a
    :class:`PendingCollective` whose ``wait`` does the AVG division."""
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return PendingCollective.done(x) if async_op else x
    if active_mask is None and world is None:
        raise ValueError("chunked_psum_shard needs world when active_mask is None")
    if active_mask is None:
        denom = world
    else:
        mask = _as_mask(active_mask, dist.get_world_size(group))
        flat = _mask_contribution(flat, mask, dist.get_rank(group), op)
        denom = _active_count(mask)
    works = [dist.all_reduce(flat[o:o + n], op=_DIST_OPS[op], group=group, async_op=True)
             for o, n in _chunk_bounds(flat.numel(), _chunk_elems(flat, chunk_bytes))]
    pending = PendingCollective(works, lambda: _divide(flat, op, denom).reshape(x.shape))
    return pending if async_op else pending.wait()


def reduce_shard(
    x: torch.Tensor,
    active_mask: MaskLike,
    strategy: Strategy,
    op: ReduceOp = ReduceOp.SUM,
    group=None,
) -> torch.Tensor:
    """Reduce to each tree's root: a tree's segment is the full reduction on
    its root only; other ranks keep partial sums for it (reference
    reduce.cu:258-269).  AVG divides every rank's result by the active
    count."""
    mask = _as_mask(active_mask, strategy.world_size)
    return _avg_normalize(_schedule_rank(x, mask, strategy, op, "reduce", group), mask, op)


def broadcast_shard(x: torch.Tensor, strategy: Strategy, group=None) -> torch.Tensor:
    """Broadcast from each tree's root: the root's segment replaces every
    other rank's (reference boardcast.cu:279-282)."""
    return _schedule_rank(x, None, strategy, ReduceOp.SUM, "broadcast", group)


def _segments_rank(x: torch.Tensor, strategy: Strategy,
                   per_segment: Callable[[torch.Tensor, Tree], torch.Tensor]) -> torch.Tensor:
    """Split ``x`` across the trees by share, run each tree's segment, join."""
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return x
    outs = []
    off = 0
    for tree, size in zip(strategy.trees, _segment_sizes(flat.numel(), strategy.tree_shares())):
        if size == 0:
            continue
        outs.append(per_segment(flat[off:off + size], tree))
        off += size
    return (torch.cat(outs) if len(outs) > 1 else outs[0]).reshape(x.shape)


def reduce_fastpath_shard(x: torch.Tensor, strategy: Strategy, op: ReduceOp = ReduceOp.SUM,
                          group=None) -> torch.Tensor:
    """Full-world reduce as one collective per tree segment, the total kept
    on that segment's root and the local value elsewhere."""
    me = _shard_setup(x, strategy, group)

    def per_segment(seg: torch.Tensor, tree: Tree) -> torch.Tensor:
        total = _fused_reduce(seg.clone(), op, strategy.world_size, group)
        return total if me == tree.root else seg.to(total.dtype)

    return _segments_rank(x, strategy, per_segment)


def broadcast_fastpath_shard(x: torch.Tensor, strategy: Strategy, group=None) -> torch.Tensor:
    """Full-world broadcast as one sum per tree segment in which only the
    root contributes (so ``-0.0`` arrives as ``+0.0``, as in JAX's psum)."""
    me = _shard_setup(x, strategy, group)

    def per_segment(seg: torch.Tensor, tree: Tree) -> torch.Tensor:
        wire = seg.to(torch.int32) if seg.dtype == torch.bool else seg
        contrib = wire.clone() if me == tree.root else torch.zeros_like(wire)
        dist.all_reduce(contrib, group=group)
        return contrib.to(seg.dtype)

    return _segments_rank(x, strategy, per_segment)


# --------------------------------------------------------------------------- #
# the schedule plane, stacked: every rank's row on one device
# --------------------------------------------------------------------------- #


def _fill_rows(t: torch.Tensor, rows: Sequence[int], value: float) -> None:
    for r in rows:
        t[r].fill_(value)


def _masked_copy(flat: torch.Tensor, active_mask: Optional[torch.Tensor], value: float) -> torch.Tensor:
    """A copy of the rows ``[world, ...]`` with every inactive row (a relay)
    ``value``: the op's identity, or the zeros of a gather."""
    out = flat.clone()
    if active_mask is not None:
        _fill_rows(out, [r for r in range(flat.shape[0]) if not bool(active_mask[r])], value)
    return out


def _run_groups_rows(buf: torch.Tensor, stages: List[Tuple[list, str]]) -> None:
    """Merged groups over the rows of ``buf`` (``[rows, T, pad]``), in
    place: each edge ``(s, d)`` of a group folds row ``s``'s segment of its
    tree into row ``d``'s.  No edge of a group reads a segment another edge
    of it writes (a rank never sends and receives in one round of one
    tree), so each edge reads the state from before the group, as
    ``ppermute`` delivers it."""
    for groups, combine in stages:
        for perm, src_row, _, _ in groups:
            for s, d in perm:
                t = src_row[s]
                _combine_into(buf[d, t], buf[s, t], combine)


def _run_merged_stacked(flat: torch.Tensor, inactive: List[int], sizes: List[int], plan: _MergedPlan,
                        op: ReduceOp, phases: str, pad: float) -> torch.Tensor:
    """The merged groups over ``[world, n]``: every row's segments stacked as
    ``[world, T, pad]`` (padded with ``pad``, the op's identity, an inactive
    row all identity), then :func:`_run_groups_rows`."""
    buf = _stack_segments(flat, sizes, pad)
    _fill_rows(buf, inactive, pad)
    _run_groups_rows(buf, _stages(plan.reduce_groups, plan.broadcast_groups, op, phases))
    return _unstack_segments(buf, sizes)


def _tree_rounds_rows(acc: torch.Tensor, tree: Tree, op: ReduceOp, phases: str) -> None:
    """One tree's rounds over the rows of ``acc`` (row ``r`` rank ``r``'s
    segment, any trailing shape), in place; within a round no edge reads a
    row another writes."""
    normalize = op is not ReduceOp.MAX and acc.is_floating_point()
    combine = "max" if op is ReduceOp.MAX else "add"
    rows = acc.shape[0]
    if phases in ("reduce", "both"):
        normalized: set = set()
        for rnd in tree.reduce_rounds():
            for s, d in rnd.edges:
                _combine_into(acc[d], acc[s], combine)
            if normalize:
                # no destination of the round: + the zeros ppermute
                # delivers (-0.0 turns +0.0, once for good), after the
                # round's sends have read the row
                is_dst = _dst_mask(rnd, rows)
                for r in range(rows):
                    if not is_dst[r] and r not in normalized:
                        acc[r].add_(0)
                        normalized.add(r)
    if phases in ("broadcast", "both"):
        for rnd in tree.broadcast_rounds():
            for s, d in rnd.edges:
                acc[d].copy_(acc[s])


def _run_trees_stacked(flat: torch.Tensor, inactive: List[int], sizes: List[int], strategy: Strategy,
                       op: ReduceOp, phases: str, pad: float) -> torch.Tensor:
    """Each tree's rounds over its segment's columns of ``[world, n]``, in
    place on one copy, an inactive row ``pad`` (the op's identity)."""
    out = flat.clone()
    _fill_rows(out, inactive, pad)
    off = 0
    for tree, size in zip(strategy.trees, sizes):
        if size == 0:
            continue
        _tree_rounds_rows(out[:, off:off + size], tree, op, phases)
        off += size
    return out


class CollectiveEngine:
    """The collective engine over ``world_size`` ranks whose rows live on one
    device (the tensor's: the card, or the CPU for a CPU tensor), in the JAX
    engine's single-controller form: every entry point takes a stacked
    ``[world, ...]`` tensor, row ``r`` rank ``r``'s contribution, and returns
    the stacked result (row ``r`` rank ``r``'s result) as a new tensor.

    ``use_xla_fastpath`` keeps the reference's name for "the flat collective
    is allowed": an unmasked ``all_reduce``, ``reduce`` or ``broadcast``
    then runs one torch reduction over the rows instead of the tree rounds.

    ``trace``, when given, is a :class:`~adapcc_tpu_torch.utils.
    observability.CollectiveTrace` that records one event per call: the
    primitive, the implementation that ran (``schedule`` for the tree
    rounds, with ``merged``; ``torch_fused`` / ``torch_flat`` for the flat
    paths; ``cuda_ring[<path>]`` / ``plain_ring[<path>]`` for the ring
    plane, ``+<codec>`` with a fused codec, ``quant_ring[<codec>]`` with its
    ``reroute_reason``), the stacked bytes and, in its extras, the engine's
    epoch; the schedule and flat paths add ``algo``, the ring plane its
    executed schedule (``RingSchedule.to_row()``) and the wire bytes a
    rank's payload costs.  Every dispatch but the ring plane's stamps
    ``cache_hit``: whether the engine's prepared-plan cache already held the
    dispatch's key (the JAX engine's compiled-program keys: primitive,
    strategy variant, shape, dtype, op), looked up before the dispatch
    fills it.  The cache holds what the port derives on the host (the
    merged plan, the segment sizes, the pad value); it survives
    :meth:`advance_epoch`, so a swap back to a warmed plan is a hit, and
    :meth:`clear` drops it.  Relay masks are runtime state, not part of a
    key.

    ``tuner`` (a :class:`~adapcc_tpu_torch.tuner.CollectiveTuner`) is
    consulted under ``ADAPCC_TUNER=choose`` by :meth:`ring_allreduce` (every
    algorithm a pin leaves) and by :meth:`all_reduce` (its ``xla`` cell
    against the rd and tree cells), and fed the walltime of every ring,
    latency-plane, composed two-level, IR (``ir``/``ir-opt``) and unmasked
    flat allreduce under ``record`` or ``choose``; a timed event carries
    ``duration_s``, a consulted one ``tuner={chosen, source, objective,
    applied}``.  Without
    one, a mode other than ``off`` builds one for this world at the first
    dispatch, fingerprinted with the tensor's device.

    ``num_slices > 1`` makes the world two-level: ``num_slices`` slices of
    ``world_size / num_slices`` ranks (flat rank ``r`` at slice ``r //
    ici_size``), each collective on :mod:`adapcc_tpu_torch.comm.two_level`;
    a ragged split or a slice of one rank raises.
    """

    def __init__(
        self,
        world_size: int,
        strategy: Strategy,
        trace: Optional[List[Dict[str, Any]]] = None,
        num_slices: int = 1,
        tuner: Optional[Any] = None,
        use_xla_fastpath: bool = True,
    ) -> None:
        if strategy.world_size != world_size:
            raise ValueError(f"strategy for {strategy.world_size} ranks on a world of {world_size}")
        #: a two-level world: (num_slices, ici_size) slices of lanes
        self.two_level = num_slices != 1
        self.num_slices, self.ici_size = 1, world_size
        if self.two_level:
            from adapcc_tpu_torch.comm.two_level import build_two_level_mesh

            layout = build_two_level_mesh(num_slices, world_size=world_size)
            self.num_slices, self.ici_size = layout.num_slices, layout.ici_size
        # a typo'd A/B knob, tuner mode or algorithm fails here, not at the
        # first collective
        _merged_env_disabled()
        resolve_coll_algo(None)
        #: the cost model's ring/rd crossover the ``auto`` selector reads
        #: without a tuner, computed at first use
        self._algo_crossover: Optional[float] = None
        #: a tuner mode other than off with no tuner given builds one for
        #: this world at the first dispatch (the device is the tensor's)
        self._auto_tuner = tuner_mode() != "off" and tuner is None
        #: the plan tuner (None: untuned)
        self.tuner = tuner
        self.world_size = world_size
        self.strategy = strategy
        self.trace = trace
        self.use_xla_fastpath = use_xla_fastpath
        #: prepared plans by the JAX engine's cache keys (class docstring)
        self._cache: Dict[Tuple, Any] = {}
        #: world epoch: bumped by :meth:`advance_epoch`; a collective issued
        #: with a stale ``epoch=`` raises :class:`EpochMismatch`
        self.epoch = 0
        #: the program ``algo="ir"`` runs: None derives it from the strategy
        #: at first use; a :meth:`set_schedule_program` pin survives a
        #: strategy swap, a derived program is derived again after one
        self._ir_program: Optional[Any] = None
        self._ir_program_explicit = False
        #: fingerprints verified (once each) and optimized programs by
        #: (base fingerprint, passes)
        self._ir_verified: set = set()
        self._ir_optimized: Dict[Tuple, Any] = {}
        #: whether the last derived program came from the strategy's memo
        #: (a trace extra); None until something derives
        self._ir_derived_cache_hit: Optional[bool] = None
        #: the expert exchanges already traced (:meth:`expert_a2a`)
        self._moe_traced: set = set()

    # -- epochs and bookkeeping ------------------------------------------------

    def advance_epoch(self, strategy: Optional[Strategy] = None) -> int:
        """World change: bump the epoch and optionally swap the executing
        strategy (same world: dead ranks are masked, not removed).  The
        prepared plans stay cached under their strategy's key: a swap to a
        warmed standby plan, or back to the base plan, finds them."""
        if strategy is not None:
            if strategy.world_size != self.world_size:
                raise ValueError(
                    f"standby strategy world {strategy.world_size} != engine world {self.world_size}; "
                    "elastic swaps keep the world and mask dead ranks (relay semantics)"
                )
            self.strategy = strategy
            # a derived program belongs to the old strategy (a pin stays)
            if not self._ir_program_explicit:
                self._ir_program = None
        self.epoch += 1
        return self.epoch

    def _check_epoch(self, epoch: Optional[int]) -> None:
        if epoch is not None and epoch != self.epoch:
            raise EpochMismatch(epoch, self.epoch)

    def clear(self) -> None:
        """The reference's ``exitThreads`` before a re-synthesis: the prepared
        plans are dropped, and the tuner's timer forgets its warmups, so the
        first dispatch after a rebuild is discarded again."""
        self._cache.clear()
        if self.tuner is not None:
            self.tuner.timer.reset()

    def _prepare(self, key: Tuple, build: Callable[[], Any]) -> Tuple[Any, bool]:
        """The prepared plan under ``key`` and whether the cache held it
        (looked up before ``build`` fills it)."""
        hit = key in self._cache
        if not hit:
            self._cache[key] = build()
        return self._cache[key], hit

    def _schedule_variant(self) -> Tuple[str, bool]:
        """The strategy part of a schedule-plane key: its fingerprint and
        whether the merged executor runs it (flipping
        ``ADAPCC_MERGE_ROUNDS`` must miss)."""
        return (self.strategy.fingerprint(), self._merged() is not None)

    def _merged(self) -> Optional[_MergedPlan]:
        if self.two_level:
            from adapcc_tpu_torch.comm.two_level import _two_level_merged_plan

            return _two_level_merged_plan(self.strategy, self.num_slices, self.ici_size)
        return _merged_plan(self.strategy)

    def _prepare_schedule(self, primitive: str, stacked: torch.Tensor, tail: Any) -> Tuple[_Prepared, bool]:
        """The schedule plane's prepared plan for ``stacked``: JAX's key
        ``(primitive[2l], variant, shape, dtype, tail)``, ``tail`` the op
        (the masked flag for a broadcast)."""
        name = f"{primitive}2l" if self.two_level else primitive
        key = (name, self._schedule_variant(), tuple(stacked.shape), ring._dtype_name(stacked.dtype), tail)
        op = tail if isinstance(tail, ReduceOp) else ReduceOp.SUM

        def build() -> _Prepared:
            n = stacked[0].numel()
            return _Prepared(self._merged(), _segment_sizes(n, self.strategy.tree_shares()),
                             _identity_for(op, stacked.dtype))

        return self._prepare(key, build)

    def _prepare_sizes(self, name: str, stacked: torch.Tensor, *tail: Any) -> Tuple[List[int], bool]:
        """A fast path's prepared segment sizes under JAX's key ``(name,
        fingerprint, shape, dtype, *tail)``."""
        key = (name, self.strategy.fingerprint(), tuple(stacked.shape), ring._dtype_name(stacked.dtype), *tail)
        flat_n = stacked[0].numel()
        return self._prepare(key, lambda: _segment_sizes(flat_n, self.strategy.tree_shares()))

    def _tuner_for(self, stacked: torch.Tensor) -> Optional[CollectiveTuner]:
        """The tuner of a dispatch on ``stacked``: the one given, or the one
        an ``ADAPCC_TUNER`` mode other than off at construction asked for,
        built now for this world on the tensor's device."""
        if self.tuner is None and self._auto_tuner:
            self.tuner = CollectiveTuner.for_mesh(stacked.device, world=self.world_size)
        return self.tuner

    def _observe(self, tuner: CollectiveTuner, out: torch.Tensor, t0: float, key, token, extras: Dict[str, Any]) -> None:
        """Record-mode timing of one dispatch: wait for ``out``, put the
        walltime since ``t0`` into the trace's extras and the database (the
        token's first sample is its warmup)."""
        sync_outputs(out)
        duration = time.perf_counter() - t0
        extras["duration_s"] = duration
        tuner.observe_dispatch(key, token, duration)

    def _active_to_mask(self, active_gpus: Optional[Sequence[int]]) -> torch.Tensor:
        """``[world]`` bools on the host: everyone for None."""
        if active_gpus is None:
            return torch.ones((self.world_size,), dtype=torch.bool)
        ranks = [int(r) for r in active_gpus]
        bad = [r for r in ranks if not 0 <= r < self.world_size]
        if bad:
            raise ValueError(f"active ranks {bad} outside world [0, {self.world_size})")
        mask = torch.zeros((self.world_size,), dtype=torch.bool)
        mask[ranks] = True
        return mask

    def _check_world_dim(self, stacked: torch.Tensor, what: str) -> None:
        if stacked.dim() == 0 or stacked.shape[0] != self.world_size:
            raise ValueError(
                f"{what} expects a stacked [world, ...] tensor with leading dim "
                f"{self.world_size}, got shape {tuple(stacked.shape)}"
            )

    # -- the latency plane: the size-adaptive algorithm -------------------------

    #: the tuner-grid narrowing a pinned algorithm implies: a dispatch that
    #: can run one plane only must not offer the others' cells
    _ALGO_NARROW = {"ring": ("ring",), "rd": ("rd",), "tree": ("tree",)}

    def _allreduce_crossover_bytes(self) -> float:
        """The cost model's ring/rd crossover for this world: the tuner's
        policy's when a tuner is attached (its grid gate and this selector
        then agree on every payload), else the calibration or the card's
        defaults, cached."""
        if self.tuner is not None:
            return self.tuner.policy.algo_crossover_bytes()
        if self._algo_crossover is None:
            from adapcc_tpu_torch.sim.calibrate import load_or_default
            from adapcc_tpu_torch.sim.cost_model import allreduce_crossover_bytes, bottleneck_ring_coeffs

            model = load_or_default(world=self.world_size)
            self._algo_crossover = allreduce_crossover_bytes(
                self.world_size, bottleneck_ring_coeffs(model, self.world_size))
        return self._algo_crossover

    def _auto_algo(self, per_rank_bytes: int, wire_dtype: Optional[str] = None) -> Optional[str]:
        """``auto``'s decision on the model: ``rd`` below the crossover where
        the latency plane can run, None (the ring or flat plane) otherwise.
        Trees never win an allreduce on the model; they run by pin or by a
        measured cell.  A pinned codec keeps ``auto`` on the ring planes."""
        if self.two_level or self.world_size < 2:
            return None
        if self._wire_pinned_non_off(wire_dtype):
            return None
        if latency_algo_unsupported_reason(self.world_size, "rd", self.two_level) is not None:
            return None
        if per_rank_bytes < self._allreduce_crossover_bytes():
            return "rd"
        return None

    def _wire_pinned_non_off(self, wire_dtype: Optional[str]) -> bool:
        """Whether an explicit codec pin (the env or the argument, never the
        strategy's default) names a codec."""
        env = os.environ.get(WIRE_DTYPE_ENV)
        if wire_dtype is None and (env is None or not env.strip()):
            return False
        return resolve_wire_dtype(wire_dtype) != "off"

    def _check_algo_wire_conflict(self, algo: str, wire_dtype: Optional[str]) -> None:
        """A pinned latency-plane algorithm and a pinned codec contradict
        each other (the latency plane has no codec): raise."""
        if self._wire_pinned_non_off(wire_dtype):
            raise ValueError(
                f"collective algo {algo!r} has no wire-codec plane but a wire_dtype is pinned (env or argument); "
                "pin one knob or the other — codecs ride the ring planes only"
            )

    def _latency_allreduce(self, stacked: torch.Tensor, algo: str, mask: Optional[torch.Tensor] = None,
                           op: ReduceOp = ReduceOp.SUM) -> Tuple[torch.Tensor, bool]:
        """One latency-plane allreduce (``rd`` | ``tree``) over the rows and
        its ``cache_hit``; raises where the plane cannot run (reached by a
        pin only: the selector and the tuner's grid ask the same funnel
        first)."""
        reason = latency_algo_unsupported_reason(self.world_size, algo, self.two_level)
        if reason is not None:
            raise ValueError(f"allreduce algo={algo!r} cannot run here: {reason}")
        _, hit = self._prepare((f"{algo}_allreduce", tuple(stacked.shape), ring._dtype_name(stacked.dtype), op),
                               lambda: None)
        if mask is None:
            mask = torch.ones((self.world_size,), dtype=torch.bool)
        if algo == "rd":
            return lat.rd_allreduce_stacked(stacked, mask, op), hit
        return lat.tree_allreduce_stacked(stacked, mask, op), hit

    def _latency_variant(self, primitive: str, algo: Optional[str]) -> Optional[str]:
        """The latency-plane algorithm of a reduce-scatter or all-gather:
        ``ADAPCC_COLL_ALGO`` > the argument; a pin the plane cannot run
        raises; ``auto``, ``ring``, ``ir`` and no pin keep the flat (or
        two-level) plane."""
        algo_req = resolve_coll_algo(algo)
        if algo_req not in ("rd", "tree"):
            return None
        reason = latency_algo_unsupported_reason(self.world_size, algo_req, self.two_level, primitive=primitive)
        if reason is not None:
            raise ValueError(f"{primitive} algo={algo_req!r} cannot run here: {reason}")
        return algo_req

    # -- the IR plane (compiler/): the ScheduleProgram executor -----------------

    def _certify_program(self, program) -> None:
        """Verify a program once per fingerprint."""
        _certify(program, self._ir_verified)

    def set_schedule_program(self, program) -> None:
        """Pin the :class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram`
        ``algo="ir"`` runs (a synthesized schedule with no Strategy
        spelling, for one).  It is verified here: a bad program dies at the
        pin, before anything runs."""
        if program.world != self.world_size:
            raise ValueError(
                f"schedule program {program.name!r} is for world {program.world}, engine world is {self.world_size}"
            )
        self._certify_program(program)
        self._ir_program = program
        self._ir_program_explicit = True

    def schedule_program(self):
        """The program ``algo="ir"`` resolves before the optimizer: the
        pinned one, else the strategy's (``Strategy.schedule_program``,
        memoized; whether the memo hit goes into the trace), and on a
        two-level world the composed two-level program of its shape."""
        if self._ir_program is None:
            if self.two_level:
                from adapcc_tpu_torch.compiler.builders import two_level_allreduce_program

                program = two_level_allreduce_program(self.num_slices, self.ici_size,
                                                      wire_dtype=self.strategy.wire_dtype)
                self._ir_derived_cache_hit = False
            else:
                program = self.strategy.schedule_program()
                self._ir_derived_cache_hit = bool(self.strategy.__dict__.get("_last_program_cache_hit"))
            self._certify_program(program)
            self._ir_program = program
        return self._ir_program

    def optimized_schedule_program(self):
        """The program ``algo="ir"`` runs: :meth:`schedule_program` through
        the passes in force (``ADAPCC_IR_OPT``), memoized per (base
        fingerprint, passes); every pass is verified on the way in and out,
        and a program the passes leave alone comes back as the same
        object."""
        return _optimized_program(self.schedule_program(), self._ir_verified, self._ir_optimized)

    def _ir_allreduce(self, stacked: torch.Tensor, op: ReduceOp, active_gpus: Optional[Sequence[int]]) -> torch.Tensor:
        """One allreduce through the program executor: resolve the program,
        run the optimized one over the rows, and trace its name,
        fingerprint, codec, passes and static dispatch count; ``record`` and
        ``choose`` time it into the ``ir`` cell, or ``ir-opt`` where the
        passes rewrote the program."""
        from adapcc_tpu_torch.compiler import lower as ir_lower

        if active_gpus is not None:
            raise ValueError(
                "algo='ir' executes the program's own relay masks; "
                "active_gpus subsets are not expressible on this path — "
                "build a program with relays= and set_schedule_program it"
            )
        base = self.schedule_program()
        program = self.optimized_schedule_program()
        # the codec is a program property: an env pin that disagrees with it
        # cannot be honored silently
        if self._wire_pinned_non_off(None):
            pinned = resolve_wire_dtype(None)
            if pinned != program.wire_dtype:
                raise ValueError(
                    f"algo='ir' program {program.name!r} carries "
                    f"wire_dtype={program.wire_dtype!r} but {pinned!r} is "
                    "pinned; IR wire codecs are program properties — "
                    "rebuild the program with that codec or drop the pin"
                )
        if self.two_level:
            # refuses a program that does not decompose, naming the round,
            # before anything runs
            ir_lower.two_level_color_axes(program, self.num_slices, self.ici_size)
        tuner = self._tuner_for(stacked)
        timing = tuner is not None and tuner.recording
        t0 = time.perf_counter()
        _, hit = self._prepare(
            ("ir_allreduce", program.fingerprint(), tuple(stacked.shape), ring._dtype_name(stacked.dtype), op),
            lambda: program)
        out = ir_lower.execute_program_stacked(stacked, program, op)
        extras: Dict[str, Any] = {
            "cache_hit": hit,
            "algo": "ir",
            "program": program.name,
            "program_fingerprint": program.fingerprint(),
            "wire_dtype": program.wire_dtype,
            "passes": list(program.applied_passes),
            "dispatches": ir_lower.dispatch_count(program),
        }
        if program is not base:
            extras["base_fingerprint"] = base.fingerprint()
        if not self._ir_program_explicit and self._ir_derived_cache_hit is not None:
            extras["program_cache_hit"] = self._ir_derived_cache_hit
        if self.two_level:
            extras["hier"] = f"{self.num_slices}x{self.ici_size}"
        if timing:
            # the naive and the optimized program are different executables:
            # two cells, so measured medians arbitrate ADAPCC_IR_OPT
            per_rank_bytes = stacked[0].numel() * stacked.element_size()
            key = tuner.key_for("allreduce", per_rank_bytes, IR_PATH if program is base else IR_OPT_PATH, NO_CHUNK,
                                program.wire_dtype)
            token = ("ir_allreduce", program.fingerprint(), tuple(stacked.shape), ring._dtype_name(stacked.dtype), op,
                     stacked.device.type)
            self._observe(tuner, out, t0, key, token, extras)
        self._record("allreduce", "ir", stacked, extras)
        return out

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
            self.trace.record(primitive, impl, stacked.numel() * stacked.element_size(), epoch=self.epoch,
                              **extras)

    @staticmethod
    def _ring_impl(plan: ring.RingSchedule, stacked: torch.Tensor) -> str:
        impl = "cuda_ring" if stacked.device.type == "cuda" else "plain_ring"
        suffix = "" if plan.wire_dtype == "off" else f"+{plan.wire_dtype}"
        return f"{impl}[{plan.path}{suffix}]"

    def _record_ring(self, primitive: str, plan: ring.RingSchedule, stacked: torch.Tensor) -> None:
        self._record(primitive, self._ring_impl(plan, stacked), stacked, self._ring_extras(plan))

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
        tensor on a card the kernels were not built for raises.

        ``algo`` (``ADAPCC_COLL_ALGO`` > the argument > the tuner's cell >
        the crossover under ``auto``; unset keeps the ring) may run the
        latency plane instead: ``rd`` or ``tree`` over the rows, the trace's
        impl and ``algo`` naming it.  A pinned ``rd``/``tree`` and a pinned
        codec raise; ``ir`` runs the IR plane (:meth:`all_reduce`), and then
        ``chunk_bytes`` and ``wire_dtype``, which a program carries itself,
        raise.

        With a tuner, ``ADAPCC_TUNER=choose`` lets the policy fill the knobs
        the caller left open, under the precedence **env > explicit arg >
        tuner > strategy**: the algorithm, the chunk and the codec, and with
        a codec the path (a chosen ``quant-ring`` cell runs the unfused
        quant ring, unless ``ADAPCC_FUSED_WIRE=on`` forbids it).  The policy
        is asked with every algorithm a pin leaves (a pinned codec leaves
        the ring).  ``record`` and ``choose`` time every dispatch to
        completion into the database, the first of each configuration
        discarded as its build and first launch."""
        if self.two_level:
            raise ValueError(
                "ring_allreduce needs a flat ranks mesh (a single ICI ring); two-level worlds use the strategy "
                "allreduce"
            )
        self._check_world_dim(stacked, "ring_allreduce")
        algo_req = resolve_coll_algo(algo)
        wire_arg = wire_dtype  # the caller's pin, before the tuner adopts one
        if algo_req == "ir":
            # the program carries its own chunking and codec: the ring
            # plane's knobs conflict with the pin
            if wire_arg is not None or chunk_bytes is not None:
                raise ValueError(
                    "algo='ir' executes a ScheduleProgram whose chunking "
                    "and wire codec are program properties; drop the "
                    "chunk_bytes/wire_dtype arguments or the ir pin"
                )
            return self._ir_allreduce(stacked, ReduceOp.SUM, None)
        if algo_req in ("rd", "tree"):
            # two pins in conflict, before the consult: under both the grid
            # is empty and choose() would fail with a worse message
            self._check_algo_wire_conflict(algo_req, wire_arg)
        per_rank_bytes = stacked[0].numel() * stacked.element_size()
        tuner = self._tuner_for(stacked)
        tplan = None
        tuner_chose_quant = False
        tuner_chose_algo: Optional[str] = None
        algos_narrow = self._ALGO_NARROW.get(algo_req)
        if algos_narrow is None and self._wire_pinned_non_off(wire_arg):
            # a codec the caller pinned rides the ring planes only
            algos_narrow = ("ring",)
        if tuner is not None and tuner.choosing:
            tplan = tuner.choose("allreduce", per_rank_bytes, ring._dtype_name(stacked.dtype), algos=algos_narrow)
            if algo_req in (None, "auto") and tplan.key.path in ALGO_PATHS:
                tuner_chose_algo = ALGO_OF_PATH[tplan.key.path]
            if wire_dtype is None and tplan.key.path not in ALGO_PATHS:
                wire_dtype = tplan.wire_dtype
                # a codec cell names its path too: the unfused cell must run
                # unfused, or its side of the fused/unfused A/B never runs
                tuner_chose_quant = tplan.wire_dtype != "off" and tplan.key.path == QUANT_PATH
            if chunk_bytes is None and tplan.chunk_bytes is not None:
                chunk_bytes = tplan.chunk_bytes
        executed_algo: Optional[str] = None
        if algo_req in ("rd", "tree"):
            executed_algo = algo_req  # pinned: raises where it cannot run
        elif tuner_chose_algo is not None:
            executed_algo = tuner_chose_algo
        elif algo_req == "auto" and tplan is None:
            # the crossover is the last rung: a choosing tuner's committed
            # cell, a ring cell included, outranks it
            executed_algo = self._auto_algo(per_rank_bytes, wire_arg)
        timing = tuner is not None and tuner.recording
        t0 = time.perf_counter()
        if executed_algo is not None:
            self._check_algo_wire_conflict(executed_algo, wire_arg)
            out, hit = self._latency_allreduce(stacked, executed_algo)
            impl, extras, wd = executed_algo, {"cache_hit": hit, "algo": executed_algo}, "off"
            executed_path, executed_chunk = executed_algo, NO_CHUNK
            token = (f"{executed_algo}_allreduce", tuple(stacked.shape), ring._dtype_name(stacked.dtype))
        else:
            out, impl, extras, wd, executed_path, executed_chunk, token = self._ring_arm(
                stacked, wire_dtype, chunk_bytes, quant_block_size, tuner_chose_quant)
        if timing:
            # a vmem dispatch is one cell whatever its budget (the grid's key)
            key = tuner.key_for("allreduce", per_rank_bytes, executed_path,
                                NO_CHUNK if executed_path == "vmem" else executed_chunk, wd)
            self._observe(tuner, out, t0, key, token, extras)
        if tplan is not None:
            applied = (wd == tplan.wire_dtype and executed_path == tplan.key.path
                       and (tplan.chunk_bytes is None or executed_chunk == tplan.chunk_bytes))
            extras["tuner"] = tplan.trace_extra(applied=applied)
        self._record("allreduce", impl, stacked, extras)
        return out

    def _ring_arm(self, stacked: torch.Tensor, wire_dtype: Optional[str], chunk_bytes: Optional[int],
                  quant_block_size: Optional[int], tuner_chose_quant: bool) -> Tuple:
        """The ring plane of :meth:`ring_allreduce`: ``(out, impl, extras,
        wire dtype, executed path, executed chunk, timer token)``."""
        wd = self._resolved_wire_dtype(wire_dtype)
        reroute = None
        block = (quant_block_size or DEFAULT_BLOCK_SIZE) if wd != "off" else None
        if wd != "off":
            reroute = ring.fused_ring_dispatch_reason(stacked.dtype, wd, block)
            # ADAPCC_FUSED_WIRE=on outranks the tuner's path: nothing runs
            # unfused then, exploration included
            chosen_reroute = reroute is None and tuner_chose_quant and ring.resolve_fused_wire() != "on"
            if chosen_reroute:
                reroute = "tuner chose the unfused quant-ring cell"
            elif reroute is not None:
                ring.note_quant_reroute(wd, reroute)
        if reroute is None:
            plan = self._ring_plan(stacked, chunk_bytes, rs=True, ag=True, wire_dtype=wd, block_size=block)
            out = ring.ring_allreduce_stacked(stacked, chunk_bytes=plan.chunk_bytes, wire_dtype=wd,
                                              block_size=block)
            impl, extras, stage = self._ring_impl(plan, stacked), self._ring_extras(plan), plan.stage_bytes
            executed_path, executed_chunk = plan.path, plan.chunk_bytes
        else:
            out, extras = self._wire_ring_allreduce(stacked, wd, block)
            extras["reroute_reason"] = reroute
            impl, stage = f"quant_ring[{wd}]", 0
            executed_path, executed_chunk = QUANT_PATH, NO_CHUNK
        # one timer token a configuration: its first dispatch pays the build
        # and the first launch
        token = (impl, tuple(stacked.shape), ring._dtype_name(stacked.dtype), stage, block)
        extras["algo"] = "ring"  # the executed algorithm, as JAX's trace has it
        return out, impl, extras, wd, executed_path, executed_chunk, token

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

    def _check_flat_ring(self, what: str) -> None:
        if self.two_level:
            raise ValueError(
                f"{what} needs a flat ranks mesh (a single ICI ring); two-level worlds use the strategy primitives"
            )

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
        self._check_flat_ring("ring_reduce_scatter")
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
        self._check_flat_ring("ring_all_gather")
        self._check_world_dim(stacked, "ring_all_gather")
        wd, block = self._ring_wire_args(stacked, wire_dtype, quant_block_size, "ring_all_gather")
        plan = self._ring_plan(stacked, chunk_bytes, rs=False, ag=True, wire_dtype=wd, block_size=block)
        out = ring.ring_all_gather_stacked(stacked, chunk_bytes=plan.chunk_bytes, wire_dtype=wd,
                                           block_size=block)
        self._record_ring("all_gather", plan, stacked)
        return out

    # -- the schedule plane and the flat paths ----------------------------------

    def _schedule(self, stacked: torch.Tensor, mask: Optional[torch.Tensor], op: ReduceOp, phases: str,
                  prepared: _Prepared) -> torch.Tensor:
        """The tree rounds over the rows of ``stacked`` (before AVG) under
        the prepared plan, on the two-level plane for a two-level world."""
        world = self.world_size
        strategy = self.strategy
        if self.two_level:
            from adapcc_tpu_torch.comm import two_level

            return two_level._schedule_two_level(stacked, mask, strategy, self.num_slices, self.ici_size, op, phases)
        flat = stacked.reshape(world, -1)
        if flat.shape[1] == 0:
            return stacked.clone()
        inactive = [] if mask is None else [r for r in range(world) if not bool(mask[r])]
        if prepared.plan is not None:
            out = _run_merged_stacked(flat, inactive, prepared.sizes, prepared.plan, op, phases, prepared.pad)
        else:
            out = _run_trees_stacked(flat, inactive, prepared.sizes, strategy, op, phases, prepared.pad)
        return out.reshape(stacked.shape)

    def _record_schedule(self, primitive: str, stacked: torch.Tensor, prepared: _Prepared, hit: bool) -> None:
        self._record(primitive, "schedule", stacked,
                     {"cache_hit": hit, "algo": "ring", "merged": prepared.plan is not None})

    def all_reduce(
        self,
        stacked: torch.Tensor,
        *,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
        epoch: Optional[int] = None,
        algo: Optional[str] = None,
    ) -> torch.Tensor:
        """Allreduce with subset semantics and a size-adaptive algorithm.
        ``active_gpus`` (keyword-only, as ``op``: a positional ``ReduceOp``
        must not bind to it) names the active ranks; the others are relays
        that contribute the identity, forward, and receive the result; AVG
        averages over the active count.

        ``algo`` is ``auto|ring|rd|tree|ir`` under the precedence **env >
        explicit arg > tuner > crossover**: ``ADAPCC_COLL_ALGO``, then the
        argument (``rd``/``tree`` run the latency plane, and raise where it
        cannot run), then, unpinned or ``auto`` with a choosing tuner, the
        measured cell of ``xla``/``rd``/``tree`` (read only: no
        exploration), then under ``auto`` the cost model's crossover.  What
        is left runs as before: unmasked with the fast path allowed, one
        torch reduction over the rows (``torch_fused``, JAX's psum), else
        the strategy's tree rounds (``schedule``; on a two-level world the
        two-level plane, or, unpinned and for SUM/AVG, the composed plan of
        a strategy that carries one, ``two_level[composed]``).  ``ir`` runs
        the engine's schedule program (:meth:`schedule_program` through the
        passes in force, trace impl ``ir``); its relays are the program's,
        so ``active_gpus`` raises there, as does an ``ADAPCC_WIRE_DTYPE``
        pin other than the program's codec.  The trace names the executed
        algorithm.

        With a tuner, ``record`` and ``choose`` time the fast path into the
        ``xla`` cell, a latency-plane dispatch into its algorithm's and the
        composed plan into the ``two-level`` cell."""
        self._check_epoch(epoch)
        self._check_world_dim(stacked, "all_reduce")
        algo_req = resolve_coll_algo(algo)
        if algo_req == "ir":
            return self._ir_allreduce(stacked, op, active_gpus)
        tuner = self._tuner_for(stacked)
        per_rank_bytes = stacked[0].numel() * stacked.element_size()
        dtype = ring._dtype_name(stacked.dtype)
        mask = self._active_to_mask(active_gpus)
        tplan = None
        executed_algo: Optional[str] = None
        if algo_req in ("rd", "tree"):
            executed_algo = algo_req  # pinned: raises where it cannot run
        elif (algo_req in (None, "auto") and not self.two_level and tuner is not None and tuner.choosing
              # a pinned codec leaves no cell this plane can run
              and not self._wire_pinned_non_off(None)):
            # rank the cells this plane can run, read only: an exploring
            # choose() would pin the explorer on ring cells it never fills
            tplan = tuner.rank_only("allreduce", per_rank_bytes, dtype, algos=("xla", "rd", "tree"))
            executed_algo = ALGO_OF_PATH.get(tplan.key.path)
        elif algo_req == "auto":
            executed_algo = self._auto_algo(per_rank_bytes)
        timing = tuner is not None and tuner.recording
        if executed_algo is not None:
            self._check_algo_wire_conflict(executed_algo, None)
            t0 = time.perf_counter()
            out, hit = self._latency_allreduce(stacked, executed_algo, mask, op)
            extras: Dict[str, Any] = {"cache_hit": hit, "algo": executed_algo}
            if timing:
                key = tuner.key_for("allreduce", per_rank_bytes, executed_algo, NO_CHUNK, "off")
                token = (f"{executed_algo}_allreduce", tuple(stacked.shape), dtype, op, stacked.device.type)
                self._observe(tuner, out, t0, key, token, extras)
            if tplan is not None:
                extras["tuner"] = tplan.trace_extra(applied=tplan.key.path == executed_algo)
            self._record("allreduce", executed_algo, stacked, extras)
            return out
        plan2l = None
        # an explicit ring pin names the psum/schedule plane: the composed
        # plan stands down, as every selector does; MAX has no reduce-scatter
        if self.two_level and op is not ReduceOp.MAX and algo_req in (None, "auto"):
            from adapcc_tpu_torch.strategy.hierarchy import plan_of

            candidate = plan_of(self.strategy)
            if candidate is not None and candidate.pod_algo == "rs-ag":
                plan2l = candidate
        if plan2l is not None:
            from adapcc_tpu_torch.comm.two_level import allreduce_two_level_composed_stacked

            t0 = time.perf_counter()
            _, hit = self._prepare(("allreduce2l-composed", self.strategy.fingerprint(), plan2l.leader_algo,
                                    tuple(stacked.shape), dtype, op), lambda: plan2l)
            out = allreduce_two_level_composed_stacked(stacked, mask, plan2l, self.num_slices, self.ici_size, op)
            extras = {"cache_hit": hit, "algo": "two-level", "hier": {
                "pods": plan2l.sketch.num_pods, "pod_size": plan2l.sketch.pod_size, "pod_algo": plan2l.pod_algo,
                "leader_algo": plan2l.leader_algo, "resolved_level": plan2l.resolved_level}}
            if timing:
                key = tuner.key_for("allreduce", per_rank_bytes, TWO_LEVEL_PATH, NO_CHUNK, "off")
                token = ("allreduce2l-composed", plan2l.leader_algo, tuple(stacked.shape), dtype, op)
                self._observe(tuner, out, t0, key, token, extras)
            self._record("allreduce", "two_level[composed]", stacked, extras)
            return out
        fast = self.use_xla_fastpath and active_gpus is None
        t0 = time.perf_counter()
        if fast:
            _, hit = self._prepare(("psum", tuple(stacked.shape), dtype, op), lambda: None)
            out = _fused_stacked(stacked, op, self.world_size)
        else:
            prepared, hit = self._prepare_schedule("allreduce", stacked, op)
            out = _avg_normalize(self._schedule(stacked, mask, op, "both", prepared), mask, op)
        extras = {"cache_hit": hit, "algo": "ring"}
        if fast and timing:
            key = tuner.key_for("allreduce", per_rank_bytes, XLA_PATH, NO_CHUNK, "off")
            token = ("psum", tuple(stacked.shape), dtype, op, stacked.device.type)
            self._observe(tuner, out, t0, key, token, extras)
        if tplan is not None:
            extras["tuner"] = tplan.trace_extra(applied=tplan.key.path == XLA_PATH and fast)
        if fast:
            self._record("allreduce", "torch_fused", stacked, extras)
        else:
            self._record("allreduce", "schedule", stacked, {**extras, "merged": prepared.plan is not None})
        return out

    def reduce(
        self,
        stacked: torch.Tensor,
        *,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """Reduce to each tree's root: a tree's segment holds the full
        reduction on its root's row; other rows keep partial sums (the
        fast path: their own values).  On a two-level world every lane of
        the root's slice holds the total, and other slices their partials."""
        self._check_epoch(epoch)
        self._check_world_dim(stacked, "reduce")
        if self.use_xla_fastpath and active_gpus is None and not self.two_level:
            sizes, hit = self._prepare_sizes("reduce_fast", stacked, op)
            out = self._reduce_fast(stacked, op, sizes)
            self._record("reduce", "torch_fused", stacked, {"cache_hit": hit, "algo": "ring"})
            return out
        mask = self._active_to_mask(active_gpus)
        prepared, hit = self._prepare_schedule("reduce", stacked, op)
        out = self._schedule(stacked, mask, op, "reduce", prepared)
        self._record_schedule("reduce", stacked, prepared, hit)
        return _avg_normalize(out, mask, op)

    def _reduce_fast(self, stacked: torch.Tensor, op: ReduceOp, sizes: List[int]) -> torch.Tensor:
        world = self.world_size
        flat = stacked.reshape(world, -1)
        out = None
        off = 0
        for tree, size in zip(self.strategy.trees, sizes):
            if size == 0:
                continue
            total = _fused_total(flat[:, off:off + size], op, world)
            if out is None:
                out = flat.to(total.dtype, copy=True)
            out[tree.root, off:off + size] = total
            off += size
        return stacked.clone() if out is None else out.reshape(stacked.shape)

    def broadcast(
        self,
        stacked: torch.Tensor,
        active_gpus: Optional[Sequence[int]] = None,
        *,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """Broadcast from each tree's root.  Values do not depend on relay
        roles (inactive ranks forward and receive), but the roots source
        them: ``active_gpus`` that leave out a root raise rather than
        broadcast a dead rank's row."""
        self._check_epoch(epoch)
        self._check_world_dim(stacked, "broadcast")
        self._active_to_mask(active_gpus)
        if active_gpus is not None:
            act = {int(r) for r in active_gpus}
            dead_roots = sorted({t.root for t in self.strategy.trees} - act)
            if dead_roots:
                # the JAX engine's words, the standby module the port's
                raise ValueError(
                    f"broadcast roots {dead_roots} are not in the active set {sorted(act)}: a dead root "
                    "cannot source the broadcast — swap to a degraded plan rooted on alive ranks "
                    "(adapcc_tpu_torch.elastic.standby), or, if the root is only demoted-slow, include it "
                    "in active_gpus (broadcast values are unaffected by relay roles)"
                )
        if self.use_xla_fastpath and active_gpus is None and not self.two_level:
            sizes, hit = self._prepare_sizes("broadcast_fast", stacked)
            out = self._broadcast_fast(stacked, sizes)
            self._record("broadcast", "torch_fused", stacked, {"cache_hit": hit, "algo": "ring"})
            return out
        prepared, hit = self._prepare_schedule("broadcast", stacked, active_gpus is not None)
        out = self._schedule(stacked, None, ReduceOp.SUM, "broadcast", prepared)
        self._record_schedule("broadcast", stacked, prepared, hit)
        return out

    def _broadcast_fast(self, stacked: torch.Tensor, sizes: List[int]) -> torch.Tensor:
        """Each segment becomes its root's, as a sum in which only the root
        contributes (``-0.0`` arrives as ``+0.0``)."""
        world = self.world_size
        flat = stacked.reshape(world, -1)
        out = torch.empty_like(flat)
        off = 0
        for tree, size in zip(self.strategy.trees, sizes):
            row = flat[tree.root, off:off + size]
            out[:, off:off + size] = row if row.dtype == torch.bool else row + 0
            off += size
        return out.reshape(stacked.shape)

    def boardcast(
        self,
        stacked: torch.Tensor,
        active_gpus: Optional[Sequence[int]] = None,
        *,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """Deprecated: the reference's spelling of :meth:`broadcast`; warns
        once a process, then delegates."""
        global _BOARDCAST_WARNED
        if not _BOARDCAST_WARNED:
            _BOARDCAST_WARNED = True
            warnings.warn(
                "CollectiveEngine.boardcast (the reference's spelling) is deprecated; call "
                "CollectiveEngine.broadcast instead",
                DeprecationWarning, stacklevel=2,
            )
        return self.broadcast(stacked, active_gpus, epoch=epoch)

    def _zero_inactive(self, stacked: torch.Tensor, active_gpus: Optional[Sequence[int]]) -> torch.Tensor:
        """An inactive rank's row as zeros, whatever the op (the gather and
        scatter identity)."""
        mask = self._active_to_mask(active_gpus)
        if active_gpus is None or bool(mask.all()):
            return stacked
        out = stacked.clone()
        _fill_rows(out, [r for r in range(self.world_size) if not bool(mask[r])], 0)
        return out

    def all_gather(
        self,
        stacked: torch.Tensor,
        active_gpus: Optional[Sequence[int]] = None,
        *,
        epoch: Optional[int] = None,
        algo: Optional[str] = None,
    ) -> torch.Tensor:
        """All-gather with subset semantics: ``[world, *payload]`` →
        ``[world, world, *payload]``, row ``r`` the gathered stack as rank
        ``r`` holds it; an inactive rank contributes zeros and still
        receives.  ``algo="rd"`` (or ``ADAPCC_COLL_ALGO``) runs the
        recursive-doubling all-gather, and raises where it cannot run; a
        two-level world gathers on the two-level plane."""
        self._check_epoch(epoch)
        self._check_world_dim(stacked, "all_gather")
        variant = self._latency_variant("all_gather", algo)
        v = self._zero_inactive(stacked, active_gpus)
        name = "allgather_rd" if variant == "rd" else "allgather2l" if self.two_level else "allgather"
        _, hit = self._prepare((name, tuple(stacked.shape), ring._dtype_name(stacked.dtype), active_gpus is not None),
                               lambda: None)
        if variant == "rd":
            out = lat.rd_all_gather_stacked(v)
            self._record("all_gather", "rd", stacked, {"cache_hit": hit, "algo": "rd"})
        elif self.two_level:
            from adapcc_tpu_torch.comm.two_level import all_gather_two_level_stacked

            out = all_gather_two_level_stacked(v, self.num_slices, self.ici_size)
            self._record("all_gather", "two_level", stacked, {"cache_hit": hit, "algo": "ring"})
        else:
            out = v.unsqueeze(0).expand(self.world_size, *v.shape).contiguous()
            self._record("all_gather", "torch_flat", stacked, {"cache_hit": hit, "algo": "ring"})
        return out

    def all_to_all(
        self,
        stacked: torch.Tensor,
        active_gpus: Optional[Sequence[int]] = None,
        *,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """All-to-all: ``stacked[src, dst]`` blocks are exchanged so that rank
        ``r`` holds ``stacked[:, r]``.  Blocks from inactive ranks are
        zeros; every rank still receives.

        Tuned as every other collective: with a tuner recording (``record``
        or ``choose``), the walltime of each dispatch to completion goes into
        the database under the ``all_to_all`` primitive, its size bucket one
        rank's send volume (its ``[world, *payload]`` row), on JAX's path
        ``xla`` for the flat exchange (trace impl ``torch_flat``) and
        ``two_level`` on a two-level world."""
        self._check_epoch(epoch)
        self._check_world_dim(stacked, "all_to_all")
        if stacked.dim() < 2 or stacked.shape[1] != self.world_size:
            raise ValueError(f"all_to_all needs a [world, world, ...] stacked tensor, got {tuple(stacked.shape)}")
        key = ("alltoall2l" if self.two_level else "alltoall", tuple(stacked.shape),
               ring._dtype_name(stacked.dtype), active_gpus is not None)
        _, hit = self._prepare(key, lambda: None)
        tuner = self._tuner_for(stacked)
        t0 = time.perf_counter()
        v = self._zero_inactive(stacked, active_gpus)
        if self.two_level:
            from adapcc_tpu_torch.comm.two_level import all_to_all_two_level_stacked

            out = all_to_all_two_level_stacked(v, self.num_slices, self.ici_size)
            impl = path = "two_level"
        else:
            out = v.transpose(0, 1).contiguous()
            impl, path = "torch_flat", A2A_XLA_PATH
        extras: Dict[str, Any] = {"cache_hit": hit}
        if tuner is not None and tuner.recording:
            per_rank_bytes = stacked[0].numel() * stacked.element_size()
            self._observe(tuner, out, t0, tuner.key_for("all_to_all", per_rank_bytes, path, NO_CHUNK, "off"), key,
                          extras)
        self._record("all_to_all", impl, stacked, extras)
        return out

    def expert_a2a(self, axis: Optional[Any] = None) -> Callable:
        """The MoE token exchange for :func:`adapcc_tpu_torch.parallel.expert.
        expert_parallel_moe`, routed through the engine so that expert
        traffic runs the engine's configuration and is traced.

        Returns ``a2a(v, leg=...)``: with no ``axis`` or a stacked one, ``v``
        is a stacked ``[world(src), world(dst), ...]`` tensor and the
        exchange swaps its first two dimensions (on a two-level world,
        :func:`~adapcc_tpu_torch.comm.two_level.all_to_all_two_level_stacked`);
        with a per-rank :class:`~adapcc_tpu_torch.parallel.axis.Axis`, ``v``
        is this rank's ``[world, ...]`` and the exchange is
        :func:`~adapcc_tpu_torch.parallel.axis.all_to_all` over its group.
        All three are differentiable.  An exchange records one
        ``all_to_all`` event (impl ``torch_flat[moe]``, ``two_level[moe]``
        or ``process_group[moe]``, extra ``moe=True``) the first time the
        engine sees its (leg, shape, dtype, axis): JAX records once per
        compiled program, whose dispatch and return legs each record."""
        from adapcc_tpu_torch.parallel.expert import _raw_a2a

        if axis is not None and axis.size != self.world_size:
            raise ValueError(
                f"expert_a2a axis {axis.name!r} of size {axis.size} does not span the engine world "
                f"{self.world_size}"
            )
        per_rank = axis is not None and not axis.stacked
        if self.two_level:
            if per_rank:
                raise ValueError("a per-rank expert exchange on a two-level world is not ported; the per-rank "
                                 "two-level plane waits for one process a card")
            from adapcc_tpu_torch.comm.two_level import all_to_all_two_level_stacked

            def inner(v: torch.Tensor, leg: str) -> torch.Tensor:
                return all_to_all_two_level_stacked(v, self.num_slices, self.ici_size)

            impl = "two_level[moe]"
        else:
            inner = _raw_a2a(axis)
            impl = "process_group[moe]" if per_rank else "torch_flat[moe]"
        name = None if axis is None else axis.name

        def a2a(v: torch.Tensor, leg: str = "dispatch") -> torch.Tensor:
            key = ("expert_a2a", leg, tuple(v.shape), ring._dtype_name(v.dtype), name)
            if self.trace is not None and key not in self._moe_traced:
                self._moe_traced.add(key)
                self.trace.record("all_to_all", impl, v.numel() * v.element_size(), moe=True)
            return inner(v, leg)

        return a2a

    def kv_transfer(
        self,
        pages: Any,
        *,
        src_pod: int,
        dst_pod: int,
        wire_dtype: str = "off",
        block_size: Optional[int] = None,
        chunk_bytes: int = KV_TRANSFER_CHUNK_BYTES,
        dst_device: Optional[Union[str, torch.device]] = None,
        epoch: Optional[int] = None,
    ) -> Any:
        """Point-to-point KV-cache handoff between serving pods, a chunked
        stream as an engine primitive.

        ``pages`` is a nest of lists and tuples of stacked ``[world, ...]``
        tensors (one slot's per-layer K/V pages in the
        :class:`~adapcc_tpu_torch.serve.kv_cache.SlotKVCache` layout); the
        return value is the same nest as it arrives on ``dst_device`` (the
        pages' own device when None).  ``wire_dtype="off"`` (the default) is
        the identity: the tensors given are returned, bit-exact.  A codec of
        the quant registry puts its wire under the stream: the returned pages
        carry ``codec.apply`` of the whole payload of each tensor, so the
        block geometry never depends on the chunking.  Each transfer records
        ONE trace event (``kv_transfer``, impl ``dcn_stream[+codec]``) with
        the payload bytes and, in its extras, the epoch, wire dtype, wire
        bytes, the chunk count at ``chunk_bytes``, the wall duration (the
        device synced), the (``src_pod``, ``dst_pod``) route and, under a
        codec, the block size.  On one device nothing moves: the time is
        the codec's pass, or nothing under ``off``."""
        self._check_epoch(epoch)
        if chunk_bytes < 1:
            raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
        from adapcc_tpu_torch.sim.cost_model import wire_bytes_per_element

        codec = get_codec(wire_dtype)  # loud on an unknown codec name
        block = int(block_size) if block_size is not None else DEFAULT_BLOCK_SIZE
        leaves: List[torch.Tensor] = []

        def flatten(node: Any) -> None:
            if isinstance(node, (list, tuple)):
                for child in node:
                    flatten(child)
            else:
                leaves.append(node)

        flatten(pages)
        if not leaves:
            raise ValueError("kv_transfer needs at least one page array")
        for leaf in leaves:
            self._check_world_dim(leaf, "kv_transfer")
        t0 = time.perf_counter()
        nbytes = 0
        wire_bytes = 0.0
        moved = []
        for leaf in leaves:
            nbytes += leaf.numel() * leaf.element_size()
            if codec.name == "off":
                out = leaf  # identity: the bit-exact default path
                wire_bytes += float(leaf.numel() * leaf.element_size())
            else:
                out = codec.apply(leaf, block).to(leaf.dtype)
                wire_bytes += float(leaf.numel()) * wire_bytes_per_element(codec.name, block)
            if dst_device is not None:
                out = out.to(dst_device)
            moved.append(out)
        sync_outputs(moved)
        duration = time.perf_counter() - t0
        chunks = max(1, -(-int(wire_bytes) // int(chunk_bytes)))
        if self.trace is not None:
            suffix = "" if codec.name == "off" else f"+{codec.name}"
            extras: Dict[str, Any] = {
                "epoch": self.epoch,
                "wire_dtype": codec.name,
                "wire_bytes": int(wire_bytes),
                "chunks": chunks,
                "chunk_bytes": int(chunk_bytes),
                "duration_s": duration,
                "src_pod": int(src_pod),
                "dst_pod": int(dst_pod),
            }
            if codec.name != "off":
                extras["block_size"] = block
            self.trace.record("kv_transfer", f"dcn_stream{suffix}", nbytes, **extras)
        it = iter(moved)

        def rebuild(node: Any) -> Any:
            if isinstance(node, (list, tuple)):
                return type(node)(rebuild(child) for child in node)
            return next(it)

        return rebuild(pages)

    def pipe_send(
        self,
        stacked: torch.Tensor,
        *,
        src: int,
        dst: int,
        kind: str = "activation",
        mb: Optional[int] = None,
        tick: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """A pipeline stage hop: rank ``src``'s row of a stacked ``[world,
        ...]`` tensor moves to rank ``dst``; every other row stays as it was
        (a new tensor, as JAX's ppermute gives).  On one device the hop is a
        row copy (trace impl ``torch_row_copy``; JAX's ``ici_hop`` is a
        ppermute over the chip's links).  Each hop records one
        ``pipe_send`` event of one row's bytes with the route (``src``,
        ``dst``), ``kind`` (``activation``/``grad``/``tied_embed``), and the
        microbatch and tick where the executor gives them; the prepared-plan
        cache key is JAX's ``("pipe_send", src, dst, shape, dtype)``."""
        self._check_epoch(epoch)
        self._check_world_dim(stacked, "pipe_send")
        w = self.world_size
        for label, r in (("src", src), ("dst", dst)):
            if not 0 <= r < w:
                raise ValueError(f"pipe_send {label}={r} outside world [0, {w})")
        if src == dst:
            raise ValueError(f"pipe_send src == dst == {src}: nothing to move")
        if kind not in ("activation", "grad", "tied_embed"):
            raise ValueError(
                f"pipe_send kind={kind!r}: expected 'activation', 'grad' or "
                "'tied_embed'"
            )
        _, hit = self._prepare(("pipe_send", src, dst, tuple(stacked.shape), ring._dtype_name(stacked.dtype)),
                               lambda: None)
        out = stacked.clone()
        out[dst] = stacked[src]
        if self.trace is not None:
            extras: Dict[str, Any] = {"epoch": self.epoch, "src": int(src), "dst": int(dst), "kind": kind,
                                      "cache_hit": hit}
            if mb is not None:
                extras["mb"] = int(mb)
            if tick is not None:
                extras["tick"] = int(tick)
            self.trace.record("pipe_send", "torch_row_copy", stacked.numel() * stacked.element_size() // w,
                              **extras)
        return out

    def pipe_recv(self, stacked: torch.Tensor, *, src: int, dst: int, **kwargs: Any) -> torch.Tensor:
        """The destination's spelling of the stage hop: one dispatch is both
        halves of the send/recv pair, so this is :meth:`pipe_send` (one
        trace event a hop either way)."""
        return self.pipe_send(stacked, src=src, dst=dst, **kwargs)

    def reduce_scatter(
        self,
        stacked: torch.Tensor,
        *,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
        epoch: Optional[int] = None,
        algo: Optional[str] = None,
    ) -> torch.Tensor:
        """Reduce-scatter with subset semantics: ``[world, n]`` → ``[world, n
        // world]``, row ``r`` the reduction of every rank's ``r``-th slice;
        inactive ranks contribute zeros; AVG averages over the active count
        (the world when unmasked).  SUM and AVG only; ``n`` must divide by
        the world.  ``algo="rd"`` (or ``ADAPCC_COLL_ALGO``) runs the
        recursive-halving reduce-scatter, and raises where it cannot run; a
        two-level world scatters on the two-level plane."""
        self._check_epoch(epoch)
        self._check_world_dim(stacked, "reduce_scatter")
        if op is ReduceOp.MAX:
            raise ValueError(
                "reduce_scatter supports SUM/AVG (psum_scatter has no max variant); use reduce + a "
                "local slice for MAX"
            )
        world = self.world_size
        n = stacked[0].numel()
        if n % world:
            raise ValueError(f"reduce_scatter payload ({n} elems) must divide the world ({world})")
        mask = self._active_to_mask(active_gpus)
        rd = self._latency_variant("reduce_scatter", algo) == "rd"
        name = "reducescatter_rd" if rd else "reducescatter2l" if self.two_level else "reducescatter"
        _, hit = self._prepare((name, tuple(stacked.shape), ring._dtype_name(stacked.dtype), op,
                                active_gpus is not None), lambda: None)
        if rd:
            out = lat.rd_reduce_scatter_stacked(stacked.reshape(world, n), None if active_gpus is None else mask, op)
            self._record("reduce_scatter", "rd", stacked, {"cache_hit": hit, "algo": "rd"})
            return out
        v = self._zero_inactive(stacked, active_gpus).reshape(world, n)
        if self.two_level:
            from adapcc_tpu_torch.comm.two_level import reduce_scatter_two_level_stacked

            out = reduce_scatter_two_level_stacked(v, self.num_slices, self.ici_size)
            impl = "two_level"
        else:
            out = v.sum(0, dtype=v.dtype).view(world, n // world)
            impl = "torch_flat"
        if op is ReduceOp.AVG:
            out = _avg_normalize(out, mask, op)
        self._record("reduce_scatter", impl, stacked, {"cache_hit": hit, "algo": "ring"})
        return out


def _fused_total(stacked: torch.Tensor, op: ReduceOp, world: int) -> torch.Tensor:
    """The fast path's reduction over the rows: one torch sum or max, AVG
    divided by the world in the result's dtype."""
    if op is ReduceOp.MAX:
        return stacked.amax(0)
    total = stacked.sum(0, dtype=stacked.dtype)
    if op is ReduceOp.AVG:
        total = total / torch.full((), world, dtype=total.dtype, device=total.device)
    return total


def _fused_stacked(stacked: torch.Tensor, op: ReduceOp, world: int) -> torch.Tensor:
    """The fused allreduce of the rows: every row the reduction."""
    total = _fused_total(stacked, op, world)
    return total.unsqueeze(0).expand((stacked.shape[0], *total.shape)).contiguous()
