"""Redundant ZeRO-1 shard placement: k-replicated optimizer shards.

The port of :mod:`adapcc_tpu.elastic.redundancy`.  A ZeRO-1 optimizer shard
is single-owner state: a dead rank's master row and moments live only on
its card, and without redundancy the only recovery is a checkpoint reload.
Each rank's rows are therefore replicated to ``k`` ring-neighbour holders
after every step, and a death is repaired by pulling the lost rows back
from a holder.

:func:`replica_placement` walks the ring from ``r + 1``, preferring holders
on another host than the primary, each host's primaries rotated so holder
load stays balanced; a one-host world (or one without an ip table) falls
back to plain ring neighbours.  Every process derives the same placement.

:class:`ShardReplicaStore` works on two forms of the state:

- the stacked pair ``(master [world, L], optimizer state)`` of one process
  holding every rank (:class:`~adapcc_tpu_torch.parallel.fsdp.
  Zero1Optimizer`): ``capture`` materializes the rows each holder would
  keep, ``reconstruct`` repairs dead rows from them (the JAX package's
  process-local twin);
- one rank's row in a process group (``DDPTrainer(zero1=True)``):
  ``exchange`` sends this rank's rows to its holders and receives the rows
  it holds in one ``batch_isend_irecv``, ``send_back`` returns them to a
  rank that lost its own.

The optimizer state is a torch optimizer or its ``state_dict()``; a tensor
leaf with a leading ``[world]`` dimension is per rank, any other leaf (the
step count) is shared.  Every held row is stamped with the step it was
captured at, and a repair against another step refuses (the freshness
guard).  The wire cost is priced by
:func:`adapcc_tpu_torch.sim.cost_model.replication_overhead_time`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

#: replica count for ZeRO-1 shards (``0`` disables replication); malformed
#: raises, never a silent default
SHARD_REPLICAS_ENV = "ADAPCC_SHARD_REPLICAS"

#: one replica survives any single failure unit (a rank, or a host with a
#: multi-host placement) at one shard send a step
DEFAULT_SHARD_REPLICAS = 1


def shard_replicas(default: int = DEFAULT_SHARD_REPLICAS) -> int:
    """The ``ADAPCC_SHARD_REPLICAS`` funnel: env > ``default``."""
    raw = os.environ.get(SHARD_REPLICAS_ENV, "").strip()
    if not raw:
        return int(default)
    try:
        value = int(raw)
    except ValueError as e:
        raise ValueError(f"{SHARD_REPLICAS_ENV}={raw!r}: expected an integer") from e
    if value < 0:
        raise ValueError(f"{SHARD_REPLICAS_ENV}={raw!r}: must be >= 0")
    return value


def replica_placement(world: int, ips: Optional[Mapping[int, str]] = None,
                      replicas: int = DEFAULT_SHARD_REPLICAS) -> Dict[int, Tuple[int, ...]]:
    """Primary rank → its ``replicas`` holder ranks: the ring from ``r + 1``,
    off-host ranks first (rotated by the primary's index within its host),
    then the nearest on-host neighbours; never the primary, all distinct."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if replicas < 0:
        raise ValueError(f"replicas must be >= 0, got {replicas}")
    if replicas >= world:
        raise ValueError(
            f"replicas={replicas} needs at least replicas+1={replicas + 1} ranks (world={world}): a shard "
            "cannot be replicated onto more distinct holders than there are other ranks"
        )
    ips = dict(ips or {})
    out: Dict[int, Tuple[int, ...]] = {}
    for r in range(world):
        ring = [(r + i) % world for i in range(1, world)]
        my_host = ips.get(r)
        off_host = [h for h in ring if ips.get(h) != my_host] if ips else []
        off_set = frozenset(off_host)
        on_host = [h for h in ring if h not in off_set]
        if off_host:
            g = sum(1 for q in range(r) if ips.get(q) == my_host) % len(off_host)
            off_host = off_host[g:] + off_host[:g]
        out[r] = tuple((off_host + on_host)[:replicas])
    return out


# -- the optimizer state as a tree of tensors ----------------------------------


def _state_tree(opt_state: Any) -> Any:
    """An optimizer's ``state_dict()``; a state dict or tree as it is."""
    return opt_state.state_dict() if isinstance(opt_state, torch.optim.Optimizer) else opt_state


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in a fixed order
    (dict keys sorted by their string form)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for k in sorted(tree, key=str) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return []


def tree_map(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every tensor, in :func:`tree_leaves`'s
    order, the rest kept (copied containers, dict keys in that order)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return type(tree)((k, tree_map(fn, tree[k])) for k in sorted(tree, key=str))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _per_rank(t: torch.Tensor, world: int) -> bool:
    return t.dim() >= 1 and t.shape[0] == world


def _rows_of(opt_pair: Tuple[Any, Any], world: int) -> Tuple[torch.Tensor, Any]:
    """Validate a stacked ``(master [world, L], optimizer state)`` pair and
    return it as ``(master, state tree)``."""
    master, opt_state = opt_pair
    if master.dim() != 2 or master.shape[0] != world:
        raise ValueError(f"expected a [world={world}, shard] master, got shape {tuple(master.shape)}")
    return master, _state_tree(opt_state)


class ShardReplicaStore:
    """The replica set of one world's ZeRO-1 shards (module docstring).

    ``_held`` maps a primary rank to ``(master row, optimizer state rows,
    step)``: every primary in the stacked form, the primaries this rank
    holds in the per-rank form."""

    def __init__(self, world: int, ips: Optional[Mapping[int, str]] = None, replicas: Optional[int] = None) -> None:
        self.world = int(world)
        self.replicas = shard_replicas() if replicas is None else int(replicas)
        if self.replicas < 1:
            raise ValueError(
                f"a replica store needs replicas >= 1, got {self.replicas} (replicas=0 means replication is "
                "off — build no store)"
            )
        self.placement = replica_placement(self.world, ips, self.replicas)
        self._held: Dict[int, Tuple[torch.Tensor, Any, int]] = {}
        self.captures = 0

    def holders_of(self, rank: int) -> Tuple[int, ...]:
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside world [0, {self.world})")
        return self.placement[rank]

    def primaries_of(self, rank: int) -> Tuple[int, ...]:
        """The primaries whose rows ``rank`` holds."""
        return tuple(p for p in range(self.world) if rank in self.placement[p])

    # -- the stacked form ------------------------------------------------------

    def capture(self, opt_pair: Tuple[Any, Any], step: int) -> None:
        """Record every rank's replica rows as of ``step``: one copy of the
        state in all, row by row."""
        master, tree = _rows_of(opt_pair, self.world)
        step = int(step)
        for r in range(self.world):
            rows = tree_map(lambda t: t[r].clone() if _per_rank(t, self.world) else t.clone(), tree)
            self._held[r] = (master[r].clone(), rows, step)
        self.captures += 1

    def replica_step(self, rank: int) -> Optional[int]:
        held = self._held.get(rank)
        return held[2] if held is not None else None

    def payload_for(self, rank: int, expect_step: Optional[int] = None) -> Tuple[torch.Tensor, Any, int]:
        """The replica rows for ``rank``, the bytes its holder would send
        back; ``expect_step`` is the freshness guard."""
        held = self._held.get(rank)
        if held is None:
            raise KeyError(
                f"no replica held for rank {rank}: the store never captured a step (replication must run "
                "before the first failure it is supposed to survive)"
            )
        master_row, opt_rows, step = held
        if expect_step is not None and step != int(expect_step):
            raise ValueError(
                f"replica for rank {rank} is stamped step {step} but the repair expects step {expect_step}; "
                "restoring it would rewind one shard's optimizer state relative to its peers — fall back to "
                "the checkpoint path"
            )
        return master_row, opt_rows, step

    def reconstruct(self, opt_pair: Tuple[Any, Any], dead: Iterable[int],
                    step: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """``opt_pair`` with every ``dead`` rank's rows replaced by its
        replica, as ``(master, state tree)`` copies; surviving rows pass
        through untouched."""
        dead = sorted({int(r) for r in dead})
        bad = [r for r in dead if not 0 <= r < self.world]
        if bad:
            raise ValueError(f"dead ranks {bad} outside world [0, {self.world})")
        master, tree = _rows_of(opt_pair, self.world)
        master = master.clone()
        payloads = {r: self.payload_for(r, expect_step=step) for r in dead}
        for r, (master_row, _, _) in payloads.items():
            if master_row.shape != master[r].shape:
                raise ValueError(
                    f"replica master row for rank {r} has shape {tuple(master_row.shape)}, state expects "
                    f"{tuple(master[r].shape)}; the replica belongs to a different layout"
                )
            master[r] = master_row.to(master.device)
        row_leaves = {r: tree_leaves(rows) for r, (_, rows, _) in payloads.items()}
        index = iter(range(len(tree_leaves(tree))))

        def repair(t: torch.Tensor) -> torch.Tensor:
            i = next(index)
            t = t.clone()
            if _per_rank(t, self.world):
                for r, rows in row_leaves.items():
                    t[r] = rows[i].to(t.device)
            return t

        return master, tree_map(repair, tree)

    # -- the per-rank form -----------------------------------------------------

    def exchange(self, master_row: torch.Tensor, opt_rows: Any, step: int, rank: int,
                 group: Optional[Any] = None) -> None:
        """This rank's post-step window in a process group: its rows (the
        master row and the per-element tensors of ``opt_rows``, a state
        tree) go to each of its holders, and the rows of every primary it
        holds come in, all in one ``batch_isend_irecv``; received rows are
        stamped with ``step``.  A tensor whose shape is not the master
        row's (the step count) is shared and taken from this rank."""
        import torch.distributed as dist

        tree = _state_tree(opt_rows)
        sent = [master_row] + [t for t in tree_leaves(tree) if t.shape == master_row.shape]
        ops, incoming = [], {}
        for h in self.holders_of(rank):
            ops += [dist.P2POp(dist.isend, t.contiguous(), h, group) for t in sent]
        for p in self.primaries_of(rank):
            bufs = [torch.empty_like(t) for t in sent]
            incoming[p] = bufs
            ops += [dist.P2POp(dist.irecv, b, p, group) for b in bufs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for p, bufs in incoming.items():
            it = iter(bufs[1:])
            rows = tree_map(lambda t: next(it) if t.shape == master_row.shape else t.clone(), tree)
            self._held[p] = (bufs[0], rows, int(step))
        self.captures += 1

    def send_back(self, master_row: torch.Tensor, opt_rows: Any, dead: Sequence[int], rank: int,
                  step: Optional[int] = None, group: Optional[Any] = None) -> Tuple[torch.Tensor, Any]:
        """The per-rank repair, a collective of every live rank and each
        ``dead`` rank's replacement: the first live holder of each dead rank
        sends the rows it holds (after the freshness guard against
        ``step``); a dead rank receives them into copies of its own
        ``(master_row, opt_rows)``, which it returns.  Every other rank
        returns its rows unchanged."""
        import torch.distributed as dist

        dead = sorted({int(r) for r in dead})
        bad = [r for r in dead if not 0 <= r < self.world]
        if bad:
            raise ValueError(f"dead ranks {bad} outside world [0, {self.world})")
        tree = _state_tree(opt_rows)
        ops, mine = [], None
        for d in dead:
            alive = [h for h in self.holders_of(d) if h not in dead]
            if not alive:
                raise ValueError(f"rank {d} and all its holders {self.holders_of(d)} are dead: no replica survives")
            holder = alive[0]
            if rank == holder:
                m, rows, _ = self.payload_for(d, expect_step=step)
                payload = [m] + [t for t in tree_leaves(rows) if t.shape == m.shape]
                ops += [dist.P2POp(dist.isend, t.contiguous(), d, group) for t in payload]
            if rank == d:
                mine = [torch.empty_like(master_row)] + [
                    torch.empty_like(t) for t in tree_leaves(tree) if t.shape == master_row.shape]
                ops += [dist.P2POp(dist.irecv, b, holder, group) for b in mine]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if mine is None:
            return master_row, tree
        it = iter(mine[1:])
        return mine[0], tree_map(lambda t: next(it) if t.shape == master_row.shape else t.clone(), tree)


__all__ = [
    "DEFAULT_SHARD_REPLICAS",
    "SHARD_REPLICAS_ENV",
    "ShardReplicaStore",
    "replica_placement",
    "shard_replicas",
]
