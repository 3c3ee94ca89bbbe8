"""ZeRO-1: sharded optimizer state over the flat gradient vector.

FSDP per rank, the other half of JAX's ``parallel/fsdp.py``, is
:mod:`adapcc_tpu_torch.parallel.fsdp_rank`.

The port of :mod:`adapcc_tpu.parallel.fsdp`'s ZeRO-1 in the
single-controller form.  Parameters stay replicated; the optimizer state
is a flat float32 master of ``[world, N/world]``, row ``r`` belonging to rank
``r``.  One step:

1. each rank's forward and backward on its batch shard, one rank after
   another on the one model replica this process holds, stacked into
   ``[world, N]`` as ``flat_grad / world``; under a wire codec each row is
   replaced by its wire value ``codec.apply(·)`` (the JAX package's value
   semantics: the scattered sum is the sum of quantized contributions);
2. the reduce-scatter:

   - ``ring=False`` (the JAX package's default): the identity layout, row
     ``r`` = chunk ``r``.  Rank ``r`` receives the sum over ranks of chunk
     ``r`` of their contributions (``lax.psum_scatter(..., tiled=False)``),
     the stacked sum of the engine's psum plane (``engine._fused_total``)
     over the ``[world, world, N/world]`` view; with ``overlap="bucket"`` as
     independent sums over ``even_chunk_bounds`` slices of the shard, bit
     for bit the same;
   - ``ring=True``: the ring reduce-scatter (K1), which leaves rank ``r``
     with the reduced chunk ``(r + 1) % world``, exactly the row layout of
     the ring master;

3. AdamW on the ``[world, N/world]`` master (``ddp/trainer.py::adamw``:
   optax's defaults);
4. the all-gather of the updated rows, unflattened into the model's
   parameters, cast to each parameter's dtype: without the ring the rows
   concatenated (by ``even_chunk_bounds`` slices under ``"bucket"``); on the
   ring K1's all-gather, rolled back into chunk order.

The flat layout is the JAX package's element for element: leaves in
``jax.tree_util`` order of the flax tree (dict keys sorted at every level),
``Dense`` kernels as ``[in, out]`` (``models/convert.py::flax_paths``), each
rank's shard padded to whole float32 ring tiles on the ring and not
otherwise.  So the master and its shard ownership match the JAX package's,
and on the ring the summation order of every element too.  The model's
parameters are updated in place.  :meth:`Zero1Optimizer.checkpoint_extra`
tags a checkpoint with the layout, and :meth:`Zero1Optimizer.restore`
refuses one of another layout.

With a ``tuner`` on the ring, ``init`` asks it for the ring's staging
chunk (``choose("zero1_ring", …)``) when nobody pinned one, and the step
records its walltime under :meth:`Zero1Optimizer.tuning_key`, the cell the
next ``init`` ranks: the loop closes across runs through the database.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from adapcc_tpu_torch.comm.engine import _fused_total
from adapcc_tpu_torch.comm.ring import (
    _tile_elems,
    plan_ring_schedule,
    ring_all_gather_stacked,
    ring_reduce_scatter_stacked,
)
from adapcc_tpu_torch.ddp.overlap import even_chunk_bounds, overlap_chunk_count
from adapcc_tpu_torch.ddp.trainer import OptimizerFactory
from adapcc_tpu_torch.models.convert import flax_paths, flax_shape, from_flax_layout, to_flax_layout
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.quant.codec import get_codec, resolve_wire_dtype
from adapcc_tpu_torch.tuner.measure import sync_device, sync_outputs
from adapcc_tpu_torch.tuner.policy import NO_CHUNK


class _Leaf(NamedTuple):
    name: str                 #: the torch parameter
    shape: Tuple[int, ...]    #: the flax leaf's shape
    size: int
    dtype: torch.dtype
    transpose: bool           #: the flax leaf is the parameter in another layout (``to_flax_layout``)


class _FlatMeta(NamedTuple):
    leaves: Tuple[_Leaf, ...]
    total: int
    padded: int


def _flatten_meta(model: nn.Module, world: int, align: int = 1) -> _FlatMeta:
    """The flat layout of ``model``'s parameters; ``align`` rounds the
    per-rank shard length up to a multiple (the ring moves whole tiles)."""
    paths = flax_paths(model)
    params = dict(model.named_parameters())
    leaves = []
    for name in sorted(paths, key=lambda n: paths[n][0]):
        p, transpose = params[name], paths[name][1]
        shape = flax_shape(tuple(p.shape)) if transpose else tuple(p.shape)
        leaves.append(_Leaf(name, shape, p.numel(), p.dtype, transpose))
    total = sum(leaf.size for leaf in leaves)
    shard = -(-total // world)
    shard = -(-shard // align) * align
    return _FlatMeta(tuple(leaves), total, world * shard)


def _flatten(tensors: Dict[str, torch.Tensor], meta: _FlatMeta,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[padded]`` float32: the leaves of ``tensors`` (by parameter name) in
    flat order, zero-padded; written into ``out`` when given."""
    if out is None:
        device = next(iter(tensors.values())).device
        out = torch.empty(meta.padded, dtype=torch.float32, device=device)
    off = 0
    for leaf in meta.leaves:
        t = tensors[leaf.name]
        out[off:off + leaf.size].view(leaf.shape).copy_(to_flax_layout(t) if leaf.transpose else t)
        off += leaf.size
    out[meta.total:].zero_()
    return out


@torch.no_grad()
def _unflatten(flat: torch.Tensor, meta: _FlatMeta, model: nn.Module) -> None:
    """Write ``flat`` into ``model``'s parameters, cast to their dtypes."""
    params = dict(model.named_parameters())
    off = 0
    for leaf in meta.leaves:
        part = flat[off:off + leaf.size].view(leaf.shape)
        params[leaf.name].copy_(from_flax_layout(part) if leaf.transpose else part)
        off += leaf.size


def _reduce_scatter_rows(stacked: torch.Tensor, world: int, overlap_chunks: int = 1) -> torch.Tensor:
    """The non-ring reduce-scatter of ``[world, N]`` contributions:
    ``[world, N/world]``, row ``r`` the sum over ranks of their chunk ``r``
    (``lax.psum_scatter(..., tiled=False)``).  ``overlap_chunks > 1`` sums
    ``even_chunk_bounds`` slices of the shard as independent reductions,
    each element in the same order: bit for bit the single one."""
    shard = stacked.shape[1] // world
    parts = stacked.view(world, world, shard)  # [rank, chunk, shard]
    bounds = even_chunk_bounds(shard, overlap_chunks)
    if len(bounds) == 1:
        return _fused_total(parts, ReduceOp.SUM, world)
    return torch.cat([_fused_total(parts[:, :, off:off + n], ReduceOp.SUM, world) for off, n in bounds], dim=1)


def _all_gather_rows(master: torch.Tensor, overlap_chunks: int = 1) -> torch.Tensor:
    """The non-ring all-gather of the ``[world, N/world]`` rows as a rank
    holds it: the rows concatenated (identity layout).  ``overlap_chunks >
    1`` gathers ``even_chunk_bounds`` slices of every row and concatenates
    them back: the same bytes in the same places."""
    bounds = even_chunk_bounds(master.shape[1], overlap_chunks)
    if len(bounds) == 1:
        return master.reshape(-1)
    return torch.cat([master[:, off:off + n] for off, n in bounds], dim=1).reshape(-1)


def zero1_apply_shard(
    opt_state: torch.optim.Optimizer,
    master: torch.Tensor,
    g_shard: torch.Tensor,
    meta: _FlatMeta,
    model: nn.Module,
    ring: bool = False,
    ring_chunk_bytes: Optional[int] = None,
    overlap_chunks: int = 1,
) -> None:
    """The sharded update cycle: the optimizer step on every rank's row of
    ``master`` with ``g_shard`` (``[world, N/world]``, row ``r`` = rank
    ``r``'s reduced chunk), then the all-gather of the updated rows into
    ``model``'s parameters.  ``ring=False``: the rows concatenated, in
    ``overlap_chunks`` slices.  ``ring=True``: K1's all-gather; every rank
    gathers the same rows, and rank 0's view (``gathered[0][i]`` = rank
    ``i``'s row = chunk ``(i + 1) % world``) is rolled back into chunk order
    (the ring streams its own chunks: ``overlap_chunks`` is for the other
    path)."""
    master.grad = g_shard
    opt_state.step()
    master.grad = None
    if ring:
        gathered = ring_all_gather_stacked(master.detach(), chunk_bytes=ring_chunk_bytes)
        flat_p = torch.roll(gathered[0], 1, dims=0).reshape(-1)
    else:
        flat_p = _all_gather_rows(master.detach(), overlap_chunks)
    _unflatten(flat_p, meta, model)


def local_grad_shard(flat_g: torch.Tensor, meta: _FlatMeta, world: int, rank: int, offset: int = 0) -> torch.Tensor:
    """This rank's ``[N/world]`` slice of a replicated flat gradient, a local
    read with no collective; ``offset=1`` is the ring's ownership (rank
    ``r`` owns chunk ``(r + 1) % world``)."""
    return flat_g.view(world, meta.padded // world)[(rank + offset) % world]


class Zero1Optimizer:
    """Optimizer-state-sharded DDP (ZeRO stage 1) over ``world`` ranks,
    single-controller form.

    ``init(model)`` gives ``(master, opt_state)``: the ``[world, N/world]``
    float32 master and ``tx([master])``, the optimizer holding every rank's
    row of Adam state.  ``ring=False`` (the default, as in JAX) keeps the
    identity layout, row ``r`` = chunk ``r``, shards unaligned; ``ring=True``
    puts both collectives on the ring kernels, row ``r`` = chunk ``(r + 1) %
    world`` (the ring's ownership), shards tile-aligned.  Checkpoints of
    ring and non-ring masters are not interchangeable
    (:meth:`layout_metadata`, :meth:`checkpoint_extra`).

    ``overlap="bucket"`` (the caller resolves ``ADAPCC_OVERLAP``) splits the
    non-ring reduce-scatter and all-gather into :meth:`overlap_chunks`
    independent collectives of about ``overlap_chunk_bytes`` (the 4 MiB
    default, ``ADAPCC_RING_CHUNK_BYTES`` overriding): the same bytes in the
    same layout.

    ``wire_dtype`` (``ADAPCC_WIRE_DTYPE`` overrides it) gives each rank's
    gradient contribution its codec's wire value before the reduce-scatter,
    as the JAX package does; the collectives still move float32.

    ``tuner`` (a :class:`~adapcc_tpu_torch.tuner.CollectiveTuner`): on the
    ring with no ``ring_chunk_bytes`` given and the tuner choosing,
    ``init`` adopts the policy's chunk for the padded flat master
    (:attr:`tuned_plan`); ``ADAPCC_RING_CHUNK_BYTES`` still overrides it in
    the planner.
    """

    LAYOUT_KEY = "zero1_layout"

    def __init__(
        self,
        tx: OptimizerFactory,
        world: int,
        ring: bool = False,
        ring_chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
        tuner: Optional[Any] = None,
        overlap: str = "off",
        overlap_chunk_bytes: Optional[int] = None,
    ) -> None:
        if overlap == "microbatch":
            raise ValueError(
                "Zero1Optimizer has no microbatch axis to pipeline over — microbatch overlap lives in "
                "DDPTrainer's accumulation scan (overlap='microbatch' there composes with zero1=True)"
            )
        if overlap not in ("off", "bucket"):
            raise ValueError(f"overlap={overlap!r}: expected 'off' or 'bucket'")
        if overlap == "bucket" and ring:
            raise ValueError(
                "overlap='bucket' with ring=True would chunk the ring's payload twice: the ring kernel "
                "already streams chunk_bytes-sized tiles (ring_chunk_bytes steers it); use one chunking "
                "plane or the other"
            )
        self.tx = tx
        self.world = world
        self.ring = ring
        self.overlap = overlap
        #: granularity of the overlapped non-ring collectives (None: the
        #: default, env-overridable)
        self.overlap_chunk_bytes = overlap_chunk_bytes
        #: staging granularity of the ring collectives (None: the default,
        #: env-overridable); it never changes the chunk layout
        self.ring_chunk_bytes = ring_chunk_bytes
        #: codec of each rank's gradient contribution: ADAPCC_WIRE_DTYPE >
        #: the argument > "off", resolved now so a typo raises here
        self.wire_dtype = resolve_wire_dtype(wire_dtype)
        self.tuner = tuner
        #: the TunedPlan behind an adopted chunk (None: not the tuner's)
        self.tuned_plan = None
        self._meta: Optional[_FlatMeta] = None
        #: the device of the master ``init`` made (where ``restore`` puts one)
        self._device: Optional[torch.device] = None

    def _align(self) -> int:
        """The ring moves whole float32 tiles, so its shards are
        tile-aligned; the other path's are not (alignment 1)."""
        return _tile_elems(torch.float32) if self.ring else 1

    def overlap_chunks(self, shard_len: Optional[int] = None) -> int:
        """How many independent collectives the overlapped reduce-scatter
        and all-gather each split into: 1 with overlap off, else the float32
        shard's bytes over ``overlap_chunk_bytes``.  ``shard_len`` defaults
        to the initialized master's."""
        if self.overlap != "bucket":
            return 1
        if shard_len is None:
            if self._meta is None:
                raise RuntimeError("call init(model) first")
            shard_len = self._meta.padded // self.world
        return overlap_chunk_count(int(shard_len) * 4, self.overlap_chunk_bytes)

    def tuning_key(self):
        """The database cell the ring collectives of this optimizer execute,
        or None off the ring, without a tuner or before ``init``: the
        tuner-chosen cell, else the executed configuration by the ring's
        planner, in the grid's vocabulary (vmem is one cell)."""
        if self.tuner is None or self._meta is None or not self.ring:
            return None
        if self.tuned_plan is not None:
            return self.tuned_plan.key
        plan = plan_ring_schedule(self._meta.padded, torch.float32, self.world, self.ring_chunk_bytes)
        return self.tuner.key_for("zero1_ring", self._meta.padded * 4, plan.path,
                                  NO_CHUNK if plan.path == "vmem" else plan.chunk_bytes, "off")

    def init(self, model: nn.Module) -> Tuple[torch.Tensor, torch.optim.Optimizer]:
        """``(master [world, N/world] float32, opt_state)`` on the model's
        device: row ``r`` chunk ``r``, or on the ring chunk ``(r + 1) %
        world``.  On the ring with a choosing tuner and no pinned chunk, the
        chunk is the policy's for the whole padded master."""
        meta = self._meta = _flatten_meta(model, self.world, self._align())
        if self.ring and self.ring_chunk_bytes is None and self.tuner is not None and self.tuner.choosing:
            # "zero1_ring" cells carry the chunk axis only (the codec is a
            # separate knob)
            self.tuned_plan = self.tuner.choose("zero1_ring", meta.padded * 4)
            self.ring_chunk_bytes = self.tuned_plan.chunk_bytes
        flat = _flatten({n: p.detach() for n, p in model.named_parameters()}, meta)
        master = flat.view(self.world, -1)
        if self.ring:
            # row r ← chunk (r + 1) % world
            master = torch.roll(master, -1, dims=0)
        master = master.contiguous()
        self._device = master.device
        return master, self.tx([master])

    def init_row(self, model: nn.Module, rank: int) -> Tuple[torch.Tensor, torch.optim.Optimizer]:
        """One rank's share of :meth:`init` (the per-rank trainer):
        ``(row [N/world] float32, tx([row]))``, row ``rank`` of the master
        :meth:`init` would make."""
        meta = self._meta = _flatten_meta(model, self.world, self._align())
        flat = _flatten({n: p.detach() for n, p in model.named_parameters()}, meta).view(self.world, -1)
        row = flat[(rank + 1) % self.world if self.ring else rank].clone()
        del flat
        self._device = row.device
        return row, self.tx([row])

    def layout_metadata(self) -> Dict[str, Any]:
        """The layout of the master and optimizer state: ring mode permutes
        chunk ownership and tile-aligns shards."""
        return {"ring": self.ring, "align": self._align(), "world": self.world}

    def checkpoint_extra(self, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """A checkpoint's ``extra`` with this optimizer's layout recorded."""
        out = dict(extra or {})
        out[self.LAYOUT_KEY] = self.layout_metadata()
        return out

    def validate_checkpoint_extra(self, extra: Optional[Dict[str, Any]]) -> None:
        """Raise unless the checkpoint's recorded layout is this optimizer's.
        An untagged checkpoint is refused too: an untagged ZeRO-1 master is
        exactly the silent-corruption hazard the tag exists to close."""
        recorded = (extra or {}).get(self.LAYOUT_KEY)
        if recorded is None:
            raise ValueError(
                f"checkpoint has no zero1 layout tag (extra[{self.LAYOUT_KEY!r}]); refusing to restore a "
                "ZeRO-1 master of unknown chunk layout — re-save with Zero1Optimizer.checkpoint_extra()"
            )
        expected = self.layout_metadata()
        mismatches = {k: (recorded.get(k), v) for k, v in expected.items() if recorded.get(k) != v}
        if mismatches:
            detail = ", ".join(f"{k}: checkpoint={a!r} vs optimizer={b!r}"
                               for k, (a, b) in sorted(mismatches.items()))
            raise ValueError(
                f"ZeRO-1 checkpoint layout mismatch ({detail}); restoring would load chunk-permuted "
                "master weights — resume with the matching ring/world configuration or re-shard offline"
            )

    def restore(self, ckpt: Any) -> Tuple[torch.Tensor, torch.optim.Optimizer]:
        """Validated restore from a :class:`~adapcc_tpu_torch.checkpoint.
        TrainCheckpointState`-shaped object whose ``opt_state`` is ``(master,
        optimizer state_dict)`` and whose ``extra`` carries the layout tag:
        ``(master, opt_state)`` on the device of the master ``init`` made
        (before ``init``: the checkpoint master's), the optimizer
        ``tx([master])`` holding the saved state."""
        self.validate_checkpoint_extra(getattr(ckpt, "extra", None))
        saved_master, opt_sd = ckpt.opt_state
        device = self._device if self._device is not None else saved_master.device
        master = saved_master.detach().to(device=device, dtype=torch.float32, copy=True).contiguous()
        opt_state = self.tx([master])
        opt_state.load_state_dict(opt_sd)
        return master, opt_state


def zero1_train_step(
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    opt: Zero1Optimizer,
) -> Callable:
    """The full ZeRO-1 step: per-rank gradients of the batch shards, the
    reduce-scatter, the sharded update, the all-gather (on the ring with
    ``opt.ring``).

    ``step(model, master, opt_state, batch) -> (model, master, opt_state,
    losses)``: ``batch``'s leading dim is global and rank ``r`` takes the
    ``r``-th contiguous ``1/world`` of it; ``model``, ``master`` and
    ``opt_state`` are updated in place; ``losses`` is the ``[world]``
    per-rank loss.  Gradients are the mean over ranks, as in DDP.  The flat
    layout is the one ``opt.init`` made.  Nothing waits for the card (a
    wedged ring raises at a later ring launch or at the caller's
    ``comm.ring.check_errors()``), except while ``opt``'s tuner records:
    then each step is timed to completion under ``opt.tuning_key()``, the
    first discarded as its warmup.
    """
    world = opt.world

    def step(model: nn.Module, master: torch.Tensor, opt_state: torch.optim.Optimizer, batch: Any):
        key = opt.tuning_key()
        if key is None or not opt.tuner.recording:
            return run(model, master, opt_state, batch)
        sync_device(master.device)
        t0 = time.perf_counter()
        out = run(model, master, opt_state, batch)
        sync_outputs(out[3])
        opt.tuner.observe_dispatch(key, ("zero1_step",), time.perf_counter() - t0)
        return out

    def run(model: nn.Module, master: torch.Tensor, opt_state: torch.optim.Optimizer, batch: Any):
        if batch.shape[0] % world:
            raise ValueError(
                f"zero1_train_step: batch leading dim {batch.shape[0]} does not divide world={world}"
            )
        meta = opt._meta
        if meta is None:
            raise RuntimeError("zero1_train_step: opt.init(model) has not run")
        per = batch.shape[0] // world
        stacked = torch.empty((world, meta.padded), dtype=torch.float32, device=master.device)
        losses = []
        for r in range(world):
            model.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch[r * per:(r + 1) * per])
            loss.backward()
            # an unused parameter's gradient is zero, as jax.grad gives it
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in model.named_parameters()}
            _flatten(grads, meta, out=stacked[r])
            losses.append(loss.detach())
        model.zero_grad(set_to_none=True)
        stacked.div_(world)
        if opt.wire_dtype != "off":
            # the codec on each contribution; blocks never cross rows, and a
            # row at a time keeps one row's temporaries
            apply = get_codec(opt.wire_dtype).apply
            for r in range(world):
                stacked[r] = apply(stacked[r])
        chunks = opt.overlap_chunks(meta.padded // world)
        if opt.ring:
            # the ring leaves rank r with reduced chunk (r + 1) % world: the
            # master's row layout
            g_shard = ring_reduce_scatter_stacked(stacked, chunk_bytes=opt.ring_chunk_bytes)
        else:
            g_shard = _reduce_scatter_rows(stacked, world, chunks)
        del stacked
        zero1_apply_shard(opt_state, master, g_shard, meta, model, ring=opt.ring,
                          ring_chunk_bytes=opt.ring_chunk_bytes, overlap_chunks=chunks)
        return model, master, opt_state, torch.stack(losses)

    return step

