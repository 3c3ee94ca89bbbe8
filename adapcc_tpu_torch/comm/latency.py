"""The latency plane: recursive halving/doubling and binomial trees.

The port of :mod:`adapcc_tpu.comm.latency`.  Small payloads pay the ring's
``2·(p−1)·α`` fixed cost and little else; a logarithmic schedule pays
``log2(p)·α`` instead:

- recursive **halving** reduce-scatter then recursive **doubling**
  all-gather (:func:`rd_allreduce_shard`; the halves alone are
  :func:`rd_reduce_scatter_shard` and :func:`rd_all_gather_shard`):
  ``2·log2(p)`` rounds, each an exchange between XOR partners, at the ring's
  wire volume;
- single-shot binomial trees (:func:`binomial_reduce_shard`,
  :func:`binomial_broadcast_shard`), ``ceil(log2 p)`` rounds of the full
  payload, and the tree allreduce (:func:`tree_allreduce_shard`), a reduce
  to the root and a broadcast back.

Each executor comes in the port's two forms: **per rank** (the ``*_shard``
functions, JAX's names: this rank's tensor over a process group, one
``batch_isend_irecv`` a round) and **stacked** (the ``*_stacked`` functions:
every rank's row of a ``[world, ...]`` tensor on one device, a round the
exchange between rows, which :class:`~adapcc_tpu_torch.comm.engine.
CollectiveEngine` runs).  Both give the JAX package's bits: a halving round
combines ``keep + received`` in that order, padding is the op's identity,
and a binomial round combines on destinations only.

Contracts kept from JAX: recursive doubling pairs ranks by XOR and rejects a
world that is not a power of two with :func:`latency_algo_unsupported_reason`'s
message (the cost model prices such worlds; the data plane never runs them),
binomial trees run on any world; a relay (inactive rank) contributes the
op's identity, stays on the exchange path and receives the result; AVG
divides by the active count (``_avg_normalize``), and the tree allreduce
reduces as SUM and divides once, after the broadcast; a world of one returns
its input.

The selector (``ADAPCC_COLL_ALGO`` > the ``algo=`` argument > a measured
tuner cell > the cost model's crossover under ``auto``) lives in the engine.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from adapcc_tpu_torch.primitives import ReduceOp

#: the selector's vocabulary: ``auto`` = size-adaptive, the rest pin a plane
COLL_ALGOS = ("auto", "ring", "rd", "tree", "ir")

#: env override of the collective algorithm (env > argument > tuner > crossover)
COLL_ALGO_ENV = "ADAPCC_COLL_ALGO"


def resolve_coll_algo(algo: Optional[str] = None) -> Optional[str]:
    """The algorithm in force: ``ADAPCC_COLL_ALGO`` > the argument > None
    (the caller's default).  A malformed value raises."""
    env = os.environ.get(COLL_ALGO_ENV)
    value = env if env is not None and env.strip() else algo
    if value is None:
        return None
    v = str(value).strip().lower()
    if v not in COLL_ALGOS:
        raise ValueError(f"{COLL_ALGO_ENV}/algo={value!r}: expected one of {'|'.join(COLL_ALGOS)}")
    return v


#: primitives with a latency-plane variant and the algorithms each speaks
_LATENCY_PRIMITIVE_ALGOS = {
    "allreduce": ("rd", "tree"),
    "reduce_scatter": ("rd",),
    "all_gather": ("rd",),
}


def latency_algo_unsupported_reason(
    world: int, algo: str, two_level: bool = False, primitive: str = "allreduce",
) -> Optional[str]:
    """Why the latency plane cannot run ``algo`` for ``primitive`` on this
    world, or None when it can: the one funnel the dispatches, the
    selector and the tuner's grid share."""
    if algo not in ("rd", "tree"):
        raise ValueError(f"algo={algo!r} is not a latency-plane algorithm ('rd'|'tree')")
    allowed = _LATENCY_PRIMITIVE_ALGOS.get(primitive)
    if allowed is None:
        return f"primitive {primitive!r} has no latency-plane variant (only {sorted(_LATENCY_PRIMITIVE_ALGOS)})"
    if algo not in allowed:
        return (
            f"{primitive} has no {algo!r} variant: binomial trees are rooted phases only allreduce "
            "composes — reduce_scatter/all_gather speak the recursive halving/doubling ('rd') half"
        )
    if two_level:
        return "two-level (dcn, ici) worlds route through the hierarchical schedule; the latency plane needs a flat ranks mesh"
    if algo == "rd" and world & (world - 1):
        return (
            f"recursive doubling pairs ranks by XOR and needs a power-of-two world, got {world}; the cost "
            "model prices the fold-in, the data plane rejects it"
        )
    return None


# --------------------------------------------------------------------------- #
# round tables (shared by both forms)
# --------------------------------------------------------------------------- #


def _binomial_rounds(world: int) -> List[int]:
    """Ascending round distances 1, 2, 4, ... < world (any world size)."""
    out: List[int] = []
    d = 1
    while d < world:
        out.append(d)
        d *= 2
    return out


def _tree_round_tables(world: int, d: int, root: int, up: bool) -> Tuple[List[Tuple[int, int]], List[bool]]:
    """One binomial round's edges and destination mask, in virtual ranks
    rotated so ``root`` is vrank 0: ``up`` (reduce) sends vrank ``v + d``'s
    partial down to ``v`` (``v % 2d == 0``), otherwise (broadcast) a holder
    ``v`` sends up to ``v + d``."""
    perm: List[Tuple[int, int]] = []
    dst_mask = [False] * world
    for v in range(0, world, 2 * d):
        other = v + d
        if other >= world:
            continue
        src_v, dst_v = (other, v) if up else (v, other)
        src, dst = (src_v + root) % world, (dst_v + root) % world
        perm.append((src, dst))
        dst_mask[dst] = True
    return perm, dst_mask


def _check_rd(world: int, primitive: str, fn: str) -> None:
    reason = latency_algo_unsupported_reason(world, "rd", primitive=primitive)
    if reason is not None:
        raise ValueError(f"{fn}: {reason}")


def _check_root(root: int, world: int) -> None:
    if not 0 <= root < world:
        raise ValueError(f"root {root} outside world [0, {world})")


def _combine_op(a: torch.Tensor, b: torch.Tensor, op: ReduceOp, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a ⊕ b`` in JAX's operand order (``keep + received``, ``acc +
    received``)."""
    if op is ReduceOp.MAX:
        return torch.maximum(a, b, out=out)
    return torch.add(a, b, out=out)


def _normalize_unmasked(result: torch.Tensor, world: int, op: ReduceOp) -> torch.Tensor:
    """JAX's ``result / world`` for an unmasked AVG, by a tensor on the
    result's device (an integer sum to float32)."""
    if op is not ReduceOp.AVG:
        return result
    return result / torch.full((), world, dtype=result.dtype, device=result.device)


# --------------------------------------------------------------------------- #
# the stacked form: every rank's row on one device
# --------------------------------------------------------------------------- #


def _masked_rows(flat: torch.Tensor, active_mask: Optional[torch.Tensor], op: ReduceOp) -> torch.Tensor:
    """A copy of ``[world, n]`` with every inactive row the op's identity."""
    from adapcc_tpu_torch.comm.engine import _identity_for, _masked_copy

    return _masked_copy(flat, active_mask, _identity_for(op, flat.dtype))


def _halving_rows(cur: torch.Tensor, world: int, op: ReduceOp) -> torch.Tensor:
    """The recursive-halving rounds over ``[world, m]`` (distances p/2 … 1):
    rank ``i`` keeps the half its segment lives in (bit ``(i // d) % 2``)
    and folds in its partner ``i ^ d``'s copy of that half.  Viewed as
    ``[world / 2d, bit, d, half, m / 2]``, rank ``(a, b, c)`` gets
    ``cur[a, b, c, b] ⊕ cur[a, 1 − b, c, b]``: two strided combines a
    round.  Row ``r`` ends holding the reduced segment ``r``."""
    d = world // 2
    while d >= 1:
        m = cur.shape[1]
        c5 = cur.view(world // (2 * d), 2, d, 2, m // 2)
        nxt = torch.empty((world // (2 * d), 2, d, m // 2), dtype=cur.dtype, device=cur.device)
        _combine_op(c5[:, 0, :, 0], c5[:, 1, :, 0], op, out=nxt[:, 0])
        _combine_op(c5[:, 1, :, 1], c5[:, 0, :, 1], op, out=nxt[:, 1])
        cur = nxt.view(world, m // 2)
        d //= 2
    return cur


def _doubling_rows(cur: torch.Tensor, world: int) -> torch.Tensor:
    """The recursive-doubling rounds over ``[world, m]`` (distances 1 …
    p/2): partners ``i`` and ``i ^ d`` both end holding the bit-0 rank's
    block then the bit-1 rank's, one copy a round."""
    d = 1
    while d < world:
        m = cur.shape[1]
        pairs = cur.view(world // (2 * d), 2, d, m).transpose(1, 2).reshape(world // (2 * d), 1, d, 2 * m)
        cur = pairs.expand(world // (2 * d), 2, d, 2 * m).reshape(world, 2 * m)
        d *= 2
    return cur


def rd_allreduce_stacked(
    stacked: torch.Tensor, active_mask: Optional[torch.Tensor], op: ReduceOp = ReduceOp.SUM,
) -> torch.Tensor:
    """:func:`rd_allreduce_shard` over the rows of ``[world, ...]``: every
    row the reduction (a new tensor)."""
    world = stacked.shape[0]
    _check_rd(world, "allreduce", "rd_allreduce_shard")
    flat = stacked.reshape(world, -1)
    n = flat.shape[1]
    if n == 0 or world == 1:
        return stacked.clone()
    from adapcc_tpu_torch.comm.engine import _avg_normalize, _identity_for

    seg = -(-n // world)
    cur = _masked_rows(flat, active_mask, op)
    if world * seg != n:
        cur = torch.cat([cur, cur.new_full((world, world * seg - n), _identity_for(op, flat.dtype))], dim=1)
    cur = _doubling_rows(_halving_rows(cur, world, op), world)
    result = cur[:, :n].reshape(stacked.shape)
    if active_mask is not None:
        return _avg_normalize(result, active_mask, op)
    return _normalize_unmasked(result, world, op)


def rd_reduce_scatter_stacked(
    stacked: torch.Tensor, active_mask: Optional[torch.Tensor], op: ReduceOp = ReduceOp.SUM,
) -> torch.Tensor:
    """:func:`rd_reduce_scatter_shard` over the rows: ``[world, n]`` →
    ``[world, n / world]``, row ``r`` the reduced segment ``r``."""
    world = stacked.shape[0]
    _check_rd(world, "reduce_scatter", "rd_reduce_scatter_shard")
    flat = stacked.reshape(world, -1)
    if flat.shape[1] % world:
        raise ValueError(f"rd reduce-scatter payload ({flat.shape[1]} elems) must divide the world ({world})")
    if world == 1:
        return flat.clone()
    from adapcc_tpu_torch.comm.engine import _avg_normalize

    out = _halving_rows(_masked_rows(flat, active_mask, op), world, op)
    if active_mask is not None:
        return _avg_normalize(out, active_mask, op)
    return _normalize_unmasked(out, world, op)


def rd_all_gather_stacked(stacked: torch.Tensor) -> torch.Tensor:
    """:func:`rd_all_gather_shard` over the rows: ``[world, *payload]`` →
    ``[world, world, *payload]``.  Relay zeroing is the caller's."""
    world = stacked.shape[0]
    _check_rd(world, "all_gather", "rd_all_gather_shard")
    if world == 1:
        return stacked.unsqueeze(1).clone()
    return _doubling_rows(stacked.reshape(world, -1), world).reshape((world, world) + tuple(stacked.shape[1:]))


#: (world, root, device) -> per round (src index, dst index) tensors
_TREE_INDEX: Dict[Tuple, List[Tuple[torch.Tensor, torch.Tensor]]] = {}


def _tree_index(world: int, root: int, up: bool, device: torch.device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The binomial rounds as index tensors on ``device``, in execution
    order (reduce: ascending distances, broadcast: descending)."""
    key = (world, root, up, str(device))
    hit = _TREE_INDEX.get(key)
    if hit is None:
        dists = _binomial_rounds(world) if up else list(reversed(_binomial_rounds(world)))
        hit = []
        for d in dists:
            perm, _ = _tree_round_tables(world, d, root, up)
            hit.append((torch.tensor([s for s, _ in perm], device=device),
                        torch.tensor([t for _, t in perm], device=device)))
        _TREE_INDEX[key] = hit
    return hit


def _binomial_reduce_rows(acc: torch.Tensor, root: int, op: ReduceOp) -> torch.Tensor:
    """The reduce rounds over ``[world, m]``, in place: a round's sources
    and destinations are disjoint, so each destination reads the state from
    before the round."""
    for src, dst in _tree_index(acc.shape[0], root, True, acc.device):
        acc.index_copy_(0, dst, _combine_op(acc.index_select(0, dst), acc.index_select(0, src), op))
    return acc


def _binomial_broadcast_rows(out: torch.Tensor, root: int) -> torch.Tensor:
    for src, dst in _tree_index(out.shape[0], root, False, out.device):
        out.index_copy_(0, dst, out.index_select(0, src))
    return out


def binomial_broadcast_stacked(stacked: torch.Tensor, root: int) -> torch.Tensor:
    """:func:`binomial_broadcast_shard` over the rows: every row the root's."""
    world = stacked.shape[0]
    _check_root(root, world)
    if world == 1:
        return stacked.clone()
    flat = stacked.reshape(world, -1).clone()
    return _binomial_broadcast_rows(flat, root).reshape(stacked.shape)


def binomial_reduce_stacked(
    stacked: torch.Tensor, active_mask: Optional[torch.Tensor], root: int, op: ReduceOp = ReduceOp.SUM,
) -> torch.Tensor:
    """:func:`binomial_reduce_shard` over the rows: the root's row the
    reduction, the others their subtree's partials."""
    world = stacked.shape[0]
    _check_root(root, world)
    from adapcc_tpu_torch.comm.engine import _avg_normalize

    acc = _masked_rows(stacked.reshape(world, -1), active_mask, op)
    if world > 1:
        _binomial_reduce_rows(acc, root, op)
    acc = acc.reshape(stacked.shape)
    if active_mask is not None:
        return _avg_normalize(acc, active_mask, op)
    if world == 1:
        return acc
    return _normalize_unmasked(acc, world, op)


def tree_allreduce_stacked(
    stacked: torch.Tensor, active_mask: Optional[torch.Tensor], op: ReduceOp = ReduceOp.SUM, root: int = 0,
) -> torch.Tensor:
    """:func:`tree_allreduce_shard` over the rows: reduce to ``root`` (as
    SUM under AVG), broadcast back, then AVG's one division."""
    world = stacked.shape[0]
    if world == 1:
        return stacked.clone()
    reduced = binomial_reduce_stacked(stacked, active_mask, root, ReduceOp.SUM if op is ReduceOp.AVG else op)
    out = binomial_broadcast_stacked(reduced, root)
    if op is ReduceOp.AVG:
        if active_mask is not None:
            from adapcc_tpu_torch.comm.engine import _avg_normalize

            return _avg_normalize(out, active_mask, ReduceOp.AVG)
        return _normalize_unmasked(out, world, op)
    return out


# --------------------------------------------------------------------------- #
# the per-rank form: this rank's tensor over a process group
# --------------------------------------------------------------------------- #


def _rank_setup(x: torch.Tensor, world: int, group) -> int:
    import torch.distributed as dist

    from adapcc_tpu_torch.comm.engine import _warm

    if dist.get_world_size(group) != world:
        raise ValueError(f"a latency-plane collective for {world} ranks on a group of {dist.get_world_size(group)}")
    _warm(group, x.device)
    return dist.get_rank(group)


def _masked_flat(x: torch.Tensor, active_mask: Optional[Sequence[bool]], me: int, op: ReduceOp) -> torch.Tensor:
    """A copy of this rank's flat payload, the op's identity on a relay."""
    from adapcc_tpu_torch.comm.engine import _identity_for

    flat = x.reshape(-1).clone()
    if active_mask is not None and not bool(active_mask[me]):
        flat.fill_(_identity_for(op, flat.dtype))
    return flat


def _halving_rank(cur: torch.Tensor, me: int, world: int, op: ReduceOp, group) -> torch.Tensor:
    from adapcc_tpu_torch.comm.engine import _exchange

    d = world // 2
    while d >= 1:
        half = cur.shape[0] // 2
        bit = (me // d) % 2
        send = cur[(1 - bit) * half:(2 - bit) * half].contiguous()
        keep = cur[bit * half:(bit + 1) * half]
        recvd = _exchange(send, me ^ d, me ^ d, send, group)
        cur = _combine_op(keep, recvd, op)
        d //= 2
    return cur


def _doubling_rank(cur: torch.Tensor, me: int, world: int, group) -> torch.Tensor:
    from adapcc_tpu_torch.comm.engine import _exchange

    d = 1
    while d < world:
        recvd = _exchange(cur, me ^ d, me ^ d, cur, group)
        cur = torch.cat([cur, recvd] if (me // d) % 2 == 0 else [recvd, cur])
        d *= 2
    return cur


def _as_rank_mask(active_mask, world: int) -> Optional[torch.Tensor]:
    if active_mask is None:
        return None
    from adapcc_tpu_torch.comm.engine import _as_mask

    return _as_mask(active_mask, world)


def rd_allreduce_shard(
    x: torch.Tensor, active_mask, world: int, op: ReduceOp = ReduceOp.SUM, group=None,
) -> torch.Tensor:
    """Recursive-halving reduce-scatter + recursive-doubling all-gather of
    this rank's ``x`` over ``group`` (``2·log2(world)`` exchanges, each one
    ``batch_isend_irecv`` with the XOR partner).  Power-of-two worlds only;
    ``active_mask`` (a ``[world]`` bool mask, or None for everyone) follows
    the relay contract.  Returns a new tensor."""
    _check_rd(world, "allreduce", "rd_allreduce_shard")
    flat = x.reshape(-1)
    if flat.numel() == 0 or world == 1:
        return x.clone()
    from adapcc_tpu_torch.comm.engine import _avg_normalize, _identity_for

    mask = _as_rank_mask(active_mask, world)
    me = _rank_setup(x, world, group)
    flat = _masked_flat(x, mask, me, op)
    n = flat.numel()
    seg = -(-n // world)
    if world * seg != n:
        flat = torch.cat([flat, flat.new_full((world * seg - n,), _identity_for(op, flat.dtype))])
    cur = _doubling_rank(_halving_rank(flat, me, world, op, group), me, world, group)
    result = cur[:n].reshape(x.shape)
    if mask is not None:
        return _avg_normalize(result, mask, op)
    return _normalize_unmasked(result, world, op)


def rd_reduce_scatter_shard(
    x: torch.Tensor, active_mask, world: int, op: ReduceOp = ReduceOp.SUM, group=None,
) -> torch.Tensor:
    """Recursive-halving reduce-scatter of this rank's full ``n``-element
    payload (``n`` must divide the world): this rank's reduced
    ``n / world`` segment, in ``log2(world)`` exchanges."""
    _check_rd(world, "reduce_scatter", "rd_reduce_scatter_shard")
    flat = x.reshape(-1)
    if flat.numel() % world:
        raise ValueError(f"rd reduce-scatter payload ({flat.numel()} elems) must divide the world ({world})")
    if world == 1:
        return flat.clone()
    from adapcc_tpu_torch.comm.engine import _avg_normalize

    mask = _as_rank_mask(active_mask, world)
    me = _rank_setup(x, world, group)
    out = _halving_rank(_masked_flat(x, mask, me, op), me, world, op, group)
    if mask is not None:
        return _avg_normalize(out, mask, op)
    return _normalize_unmasked(out, world, op)


def rd_all_gather_shard(x: torch.Tensor, world: int, group=None) -> torch.Tensor:
    """Recursive-doubling all-gather: ``[world, *payload]``, every rank's
    payload in rank order, in ``log2(world)`` exchanges.  Relay zeroing is
    the caller's."""
    _check_rd(world, "all_gather", "rd_all_gather_shard")
    if world == 1:
        return x.unsqueeze(0).clone()
    me = _rank_setup(x, world, group)
    cur = _doubling_rank(x.reshape(-1).contiguous(), me, world, group)
    return cur.reshape((world,) + tuple(x.shape))


def binomial_broadcast_shard(x: torch.Tensor, root: int, world: int, group=None) -> torch.Tensor:
    """Single-shot binomial broadcast from ``root``: ``ceil(log2 world)``
    rounds, the holders doubling each round; any world.  Returns a new
    tensor, the root's value on every rank."""
    _check_root(root, world)
    if world == 1:
        return x.clone()
    from adapcc_tpu_torch.comm.engine import _exchange, _peers

    me = _rank_setup(x, world, group)
    out = x.clone()
    for d in reversed(_binomial_rounds(world)):
        perm, _ = _tree_round_tables(world, d, root, up=False)
        dst, src = _peers(perm, me)
        recvd = _exchange(out, dst, src, out, group)
        if recvd is not None:
            out = recvd
    return out


def binomial_reduce_shard(
    x: torch.Tensor, active_mask, root: int, world: int, op: ReduceOp = ReduceOp.SUM, group=None,
) -> torch.Tensor:
    """Single-shot binomial reduce to ``root``: the root holds the
    reduction, every other rank its subtree's partial; relays contribute the
    identity; any world.  Returns a new tensor."""
    _check_root(root, world)
    from adapcc_tpu_torch.comm.engine import _avg_normalize, _exchange, _peers

    mask = _as_rank_mask(active_mask, world)
    me = _rank_setup(x, world, group) if world > 1 else 0
    acc = _masked_flat(x, mask, me, op).reshape(x.shape)
    if world > 1:
        for d in _binomial_rounds(world):
            perm, _ = _tree_round_tables(world, d, root, up=True)
            dst, src = _peers(perm, me)
            recvd = _exchange(acc, dst, src, acc, group)
            if recvd is not None:
                acc = _combine_op(acc, recvd, op)
    if mask is not None:
        return _avg_normalize(acc, mask, op)
    if world == 1:
        return acc
    return _normalize_unmasked(acc, world, op)


def tree_allreduce_shard(
    x: torch.Tensor, active_mask, world: int, op: ReduceOp = ReduceOp.SUM, root: int = 0, group=None,
) -> torch.Tensor:
    """Binomial-tree allreduce: reduce to ``root`` (as SUM under AVG) and
    broadcast back, ``2·ceil(log2 world)`` rounds of the full payload, then
    AVG's one division.  Any world; returns a new tensor."""
    if world == 1:
        return x.clone()
    reduced = binomial_reduce_shard(x, active_mask, root, world, ReduceOp.SUM if op is ReduceOp.AVG else op, group)
    out = binomial_broadcast_shard(reduced, root, world, group)
    if op is ReduceOp.AVG:
        mask = _as_rank_mask(active_mask, world)
        if mask is not None:
            from adapcc_tpu_torch.comm.engine import _avg_normalize

            return _avg_normalize(out, mask, ReduceOp.AVG)
        return _normalize_unmasked(out, world, op)
    return out
