"""Elastic ZeRO-1 re-balance: reshard the flat optimizer state on a world
change, validated through the checkpoint layout-tag funnel.

The port of :mod:`adapcc_tpu.elastic.rebalance`.  A checkpoint's layout tag
(``extra["zero1_layout"] = {ring, align, world}``) makes a ZeRO-1 master
restored under the wrong geometry fail loudly.  A world change is the one
legitimate layout change: the ``[world, N/world]`` master and its optimizer
rows are gathered back to the canonical flat vector (ring ownership undone,
padding dropped), re-padded and re-split for the new world, and re-tagged.
The result then goes through :meth:`~adapcc_tpu_torch.checkpoint.
TrainCheckpointState.apply_snapshot`, whose layout guard checks it against
the resuming optimizer's geometry: a reshard is exactly as validated as a
resume, and an un-resharded snapshot still refuses to load.

Two forms of the state:

- the stacked pair ``(master [world, L], optimizer or its state_dict())``
  of :class:`~adapcc_tpu_torch.parallel.fsdp.Zero1Optimizer`
  (:func:`rebalance_zero1_pair`, :func:`reshard_zero1_snapshot`), exact;
- the per-rank :class:`~adapcc_tpu_torch.ddp.trainer.DDPTrainer` with
  ``zero1=True``: :func:`shrink_zero1_trainer_state` and
  :func:`grow_zero1_trainer_state` take the old world's stacked snapshot
  (gathered over the old group with :func:`gather_zero1_pair`, or loaded
  from a checkpoint) and return this rank's row in the new world;
  :func:`recover_zero1_trainer_state` pulls a lost rank's rows back from
  its holders (:class:`~adapcc_tpu_torch.elastic.redundancy.
  ShardReplicaStore`).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from adapcc_tpu_torch.checkpoint import TrainCheckpointState
from adapcc_tpu_torch.elastic.redundancy import _state_tree, tree_map
from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer, _flatten_meta

LAYOUT_KEY = Zero1Optimizer.LAYOUT_KEY


def _require_layout(extra: Optional[Mapping[str, Any]]) -> Mapping[str, Any]:
    layout = (extra or {}).get(LAYOUT_KEY)
    if layout is None:
        raise ValueError(
            f"snapshot carries no zero1 layout tag (extra[{LAYOUT_KEY!r}]); cannot re-balance a master of unknown "
            "chunk geometry — save with Zero1Optimizer.checkpoint_extra() first"
        )
    return layout


def _shard_len(total: int, world: int, align: int = 1) -> int:
    shard = -(-int(total) // int(world))
    return -(-shard // int(align)) * int(align)


def _to_canonical_flat(rows: torch.Tensor, layout: Mapping[str, Any], total: int) -> torch.Tensor:
    """``[old_world, L_old]`` shard rows → the canonical flat ``[total]``
    vector (ring ownership unrolled, padding dropped)."""
    world = int(layout["world"])
    if rows.dim() != 2 or rows.shape[0] != world:
        raise ValueError(f"expected a [world={world}, shard] array, got shape {tuple(rows.shape)}")
    if layout.get("ring"):
        # init assigned row r ← chunk (r + 1) % world: rolling +1 restores
        # chunk order
        rows = torch.roll(rows, 1, dims=0)
    flat = rows.reshape(-1)
    if flat.numel() < total:
        raise ValueError(
            f"flat master holds {flat.numel()} elements but the model needs {total}; the snapshot belongs to a "
            "different model"
        )
    return flat[:total]


def _split_rows(flat: torch.Tensor, layout: Mapping[str, Any]) -> torch.Tensor:
    """The canonical flat vector → ``[world, L]`` rows in ``layout`` (its
    ``world``, ``align`` and ``ring``): padded with zeros, ring-rolled."""
    world = int(layout["world"])
    shard = _shard_len(flat.numel(), world, int(layout.get("align", 1)))
    padded = torch.zeros(world * shard, dtype=flat.dtype, device=flat.device)
    padded[:flat.numel()] = flat
    rows = padded.view(world, shard)
    if layout.get("ring"):
        rows = torch.roll(rows, -1, dims=0)
    return rows.contiguous()


def rebalance_zero1_pair(opt_pair: Tuple[Any, Any], model: torch.nn.Module, old_layout: Mapping[str, Any],
                         new_opt: Zero1Optimizer) -> Tuple[torch.Tensor, Any]:
    """Reshard a stacked ``(master [old_world, L], optimizer state)`` pair
    onto ``new_opt``'s geometry: ``(master, state_dict)`` copies.  Every
    ``[old_world, L]`` optimizer tensor reshards like the master (the
    moments, in their own dtype); a ``[old_world]`` tensor (a per-rank
    count) fans its first value out to the new world; a scalar (torch's
    step count) stays.  Padding holds zeros on both sides of the move, so
    truncating and re-padding loses nothing."""
    master, opt_state = opt_pair
    old_world = int(old_layout["world"])
    old_align = int(old_layout.get("align", 1))
    new_layout = new_opt.layout_metadata()
    meta_old = _flatten_meta(model, old_world, old_align)
    meta_new = _flatten_meta(model, new_opt.world, new_opt._align())
    total = meta_old.total
    if meta_new.total != total:
        raise ValueError(f"model sizes disagree: {total} vs {meta_new.total}")
    old_shape = (old_world, meta_old.padded // old_world)

    def reshard_rows(t: torch.Tensor) -> torch.Tensor:
        return _split_rows(_to_canonical_flat(t, old_layout, total), new_layout)

    def one(t: torch.Tensor) -> torch.Tensor:
        if tuple(t.shape) == old_shape:
            return reshard_rows(t)
        if tuple(t.shape) == (old_world,):
            return torch.full((new_opt.world,), t[0].item(), dtype=t.dtype, device=t.device)
        if t.dim() == 0:
            return t.clone()
        raise ValueError(
            f"cannot re-balance optimizer leaf of shape {tuple(t.shape)}; expected [{old_world}, shard], "
            f"[{old_world}] or scalar"
        )

    new_master = reshard_rows(master.detach())
    new_state = tree_map(one, _state_tree(opt_state))
    # the target layout, so the pair is usable without an init that would
    # reset the master
    new_opt._meta = meta_new
    new_opt._device = new_master.device
    return new_master, new_state


def reshard_zero1_snapshot(snapshot: TrainCheckpointState, model: torch.nn.Module,
                           new_opt: Zero1Optimizer) -> TrainCheckpointState:
    """Re-balance a tagged ZeRO-1 snapshot (``opt_state`` the stacked pair)
    onto ``new_opt``'s world and validate it at the load funnel: the
    returned state is what applying the re-tagged snapshot to a receiver
    declaring the new layout gave, and ``new_opt.restore(returned)`` makes
    the ``(master, optimizer)`` pair."""
    old_layout = _require_layout(snapshot.extra)
    new_pair = rebalance_zero1_pair(snapshot.opt_state, model, old_layout, new_opt)
    resharded = TrainCheckpointState(
        params=snapshot.params,
        opt_state=new_pair,
        epoch=snapshot.epoch,
        step=snapshot.step,
        best_metric=snapshot.best_metric,
        extra=new_opt.checkpoint_extra({k: v for k, v in (snapshot.extra or {}).items() if k != LAYOUT_KEY}),
    )
    receiver = TrainCheckpointState(params=snapshot.params, opt_state=new_pair, extra=new_opt.checkpoint_extra())
    receiver.apply_snapshot(resharded.capture_snapshot())
    return receiver


# -- the per-rank trainer --------------------------------------------------------


def gather_zero1_pair(trainer, state, group: Optional[Any] = None) -> Tuple[torch.Tensor, dict]:
    """The stacked ``(master [world, L], state_dict)`` pair of a per-rank
    ZeRO-1 trainer, all-gathered over ``group`` (a collective of every
    rank): each row tensor of the optimizer's state gathered like the
    master, the rest (the step count) this rank's."""
    import torch.distributed as dist

    world = trainer._zero1_opt.world
    row = state.master

    def gather(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(world * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.detach().contiguous(), group=group)
        return out.view(world, *t.shape)

    sd = state.optimizer.state_dict()
    return gather(row), tree_map(lambda t: gather(t) if t.shape == row.shape else t.clone(), sd)


def _row_state(trainer, state, rows_pair: Tuple[torch.Tensor, Any], step: int):
    """A :class:`~adapcc_tpu_torch.ddp.trainer.TrainState` of this rank from
    its row and its optimizer state rows (a state_dict)."""
    from adapcc_tpu_torch.ddp.trainer import TrainState

    row, sd = rows_pair
    device = next(state.model.parameters()).device
    row = row.detach().to(device=device, dtype=torch.float32, copy=True).contiguous()
    optimizer = trainer.tx([row])
    optimizer.load_state_dict(tree_map(lambda t: t.to(device) if t.dim() else t, sd))
    return TrainState(model=state.model, optimizer=optimizer, step=int(step), master=row)


def _rebalance_zero1_trainer_state(trainer, state, snapshot, old_world: Optional[int], direction: str):
    opt = trainer._zero1_opt
    if opt is None:
        raise ValueError(
            "call trainer.init_state(model) once before re-balancing into it: the target optimizer geometry "
            "comes from the constructed Zero1Optimizer"
        )
    master, opt_state = snapshot
    if old_world is None:
        old_world = int(master.shape[0])
    if direction == "shrink" and old_world < opt.world:
        raise ValueError(
            f"shrink_zero1_trainer_state: old world {old_world} is smaller than the target world {opt.world}; "
            "a rejoin that grows the shard layout goes through grow_zero1_trainer_state"
        )
    if direction == "grow" and old_world > opt.world:
        raise ValueError(
            f"grow_zero1_trainer_state: old world {old_world} is larger than the target world {opt.world}; a "
            "world loss goes through shrink_zero1_trainer_state"
        )
    # the old layout: this trainer's configuration at the old world
    old_layout = dict(opt.layout_metadata(), world=int(old_world))
    snap = TrainCheckpointState(params=None, opt_state=(master, _state_tree(opt_state)), step=int(state.step),
                                extra={LAYOUT_KEY: old_layout})
    restored = reshard_zero1_snapshot(snap, state.model, opt)
    new_master, new_sd = restored.opt_state
    rank = trainer.mesh.rank
    rows = tree_map(lambda t: t[rank] if t.dim() == 2 and t.shape[0] == opt.world else t, new_sd)
    return _row_state(trainer, state, (new_master[rank], rows), state.step)


def shrink_zero1_trainer_state(trainer, state, snapshot, old_world: Optional[int] = None):
    """Re-balance the stacked ``snapshot`` (``(master [old_world, L],
    optimizer state)``) of a ZeRO-1 state made under a larger world onto
    ``trainer``'s smaller world: this rank's new
    :class:`~adapcc_tpu_torch.ddp.trainer.TrainState` (the model of
    ``state``, its step), validated through the checkpoint funnel.
    ``trainer`` is a ``zero1=True`` trainer whose ``init_state`` ran once."""
    return _rebalance_zero1_trainer_state(trainer, state, snapshot, old_world, "shrink")


def grow_zero1_trainer_state(trainer, state, snapshot, old_world: Optional[int] = None):
    """The grow-back twin of :func:`shrink_zero1_trainer_state`: a snapshot
    made under a smaller world onto ``trainer``'s larger one, through the
    same funnel."""
    return _rebalance_zero1_trainer_state(trainer, state, snapshot, old_world, "grow")


def recover_zero1_trainer_state(trainer, state, dead, store=None, expect_step: Optional[int] = None,
                                model: Optional[torch.nn.Module] = None):
    """Repair a ZeRO-1 state whose ``dead`` ranks' rows are lost, from their
    replicas: no checkpoint reload.  ``store`` defaults to the trainer's
    replica set; ``expect_step`` (default the state's step) is the
    freshness guard.

    - Per rank (``state.master`` a row): a collective of every rank; the
      first live holder of each dead rank sends the rows back and the dead
      rank's replacement takes them (:meth:`ShardReplicaStore.send_back`).
    - Stacked (``state`` a ``(master [world, L], optimizer)`` pair, the
      trainer a :class:`Zero1Optimizer`, ``model`` the model it shards): the
      dead rows are replaced from the store (:meth:`ShardReplicaStore.
      reconstruct`), and the pair returned as ``(master, optimizer)``.

    Either way the repaired state goes through the same
    :func:`reshard_zero1_snapshot` funnel as a shrink or a resume (a
    same-world reshard, which the guard only validates)."""
    if isinstance(trainer, Zero1Optimizer):
        opt, master, optimizer = trainer, state[0], state[1]
        step = int(_state_tree(optimizer)["state"][0]["step"]) if expect_step is None else int(expect_step)
        pair = store.reconstruct((master, optimizer), dead, step=step)
        snap = TrainCheckpointState(params=None, opt_state=pair, step=step, extra=opt.checkpoint_extra())
        return opt.restore(reshard_zero1_snapshot(snap, model, opt))
    opt = trainer._zero1_opt
    if opt is None:
        raise ValueError(
            "call trainer.init_state(model) once before recovering into it: the target optimizer geometry "
            "comes from the constructed Zero1Optimizer"
        )
    store = trainer.replica_store if store is None else store
    if store is None:
        raise ValueError("no replica store: build the trainer with shard_replicas >= 1")
    step = int(state.step) if expect_step is None else int(expect_step)
    row, sd = store.send_back(state.master, state.optimizer, dead, trainer.mesh.rank, step=step)
    # the funnel: this rank's row as a one-row stacked pair under its own
    # layout tag
    layout = dict(opt.layout_metadata())
    receiver = TrainCheckpointState(params=None, opt_state=(row, sd), extra={LAYOUT_KEY: layout})
    receiver.apply_snapshot(TrainCheckpointState(params=None, opt_state=(row, sd), step=step,
                                                 extra={LAYOUT_KEY: layout}).capture_snapshot())
    return _row_state(trainer, state, receiver.opt_state, step)
