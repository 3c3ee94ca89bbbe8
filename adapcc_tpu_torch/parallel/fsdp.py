"""ZeRO-1 on the ring: sharded optimizer state over the flat gradient vector.

The port of the ring path of :mod:`adapcc_tpu.parallel.fsdp`'s ZeRO-1 in
the single-controller form.  Parameters stay replicated; the optimizer state
is a flat float32 master of ``[world, N/world]``, row ``r`` belonging to rank
``r``.  One step:

1. each rank's forward and backward on its batch shard, one rank after
   another on the one model replica this process holds, stacked into
   ``[world, N]`` as ``flat_grad / world``; under a wire codec each row is
   replaced by its wire value ``codec.apply(·)`` (the JAX package's value
   semantics: the scattered sum is the sum of quantized contributions);
2. the ring reduce-scatter (K1): rank ``r`` is left with the reduced chunk
   ``(r + 1) % world``, which is exactly the row layout of the master;
3. AdamW on the ``[world, N/world]`` master (``ddp/trainer.py::adamw``:
   optax's defaults);
4. the ring all-gather (K1) of the updated rows; they are rolled back into
   chunk order and unflattened into the model's parameters, cast to each
   parameter's dtype.

The flat layout is the JAX package's element for element: leaves in
``jax.tree_util`` order of the flax tree (dict keys sorted at every level),
``Dense`` kernels as ``[in, out]`` (``models/convert.py::flax_paths``), each
rank's shard padded to whole float32 ring tiles.  So the master, its shard
ownership and the ring's summation order of every element match the JAX
package's.  The model's parameters are updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from adapcc_tpu_torch.comm.ring import _tile_elems, ring_all_gather_stacked, ring_reduce_scatter_stacked
from adapcc_tpu_torch.ddp.trainer import OptimizerFactory
from adapcc_tpu_torch.models.convert import flax_paths
from adapcc_tpu_torch.primitives import not_ported
from adapcc_tpu_torch.quant.codec import get_codec, resolve_wire_dtype

_XLA_SLICE = "the per-process ring slice (one process per card)"


class _Leaf(NamedTuple):
    name: str                 #: the torch parameter
    shape: Tuple[int, ...]    #: the flax leaf's shape
    size: int
    dtype: torch.dtype
    transpose: bool           #: the flax leaf is the parameter transposed


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
        shape = tuple(p.shape[::-1]) if transpose else tuple(p.shape)
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
        out[off:off + leaf.size].view(leaf.shape).copy_(t.t() if leaf.transpose else t)
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
        params[leaf.name].copy_(part.t() if leaf.transpose else part)
        off += leaf.size


def zero1_apply_shard(
    opt_state: torch.optim.Optimizer,
    master: torch.Tensor,
    g_shard: torch.Tensor,
    meta: _FlatMeta,
    model: nn.Module,
    ring: bool = True,
    ring_chunk_bytes: Optional[int] = None,
) -> None:
    """The sharded update cycle: the optimizer step on every rank's row of
    ``master`` with ``g_shard`` (``[world, N/world]``, row ``r`` = rank
    ``r``'s reduced chunk), then the ring all-gather of the updated rows into
    ``model``'s parameters.  Every rank gathers the same rows; rank 0's view
    (``gathered[0][i]`` = rank ``i``'s row = chunk ``(i + 1) % world``) is
    rolled back into chunk order and unflattened."""
    if not ring:
        raise not_ported("ZeRO-1's XLA (psum_scatter / all_gather) path", _XLA_SLICE)
    master.grad = g_shard
    opt_state.step()
    master.grad = None
    gathered = ring_all_gather_stacked(master.detach(), chunk_bytes=ring_chunk_bytes)
    _unflatten(torch.roll(gathered[0], 1, dims=0).reshape(-1), meta, model)


class Zero1Optimizer:
    """Optimizer-state-sharded DDP (ZeRO stage 1) over ``world`` ranks on
    the ring, single-controller form.

    ``init(model)`` gives ``(master, opt_state)``: the ``[world, N/world]``
    float32 master with row ``r`` = chunk ``(r + 1) % world`` (the ring's
    ownership) and ``tx([master])``, the optimizer holding every rank's row of
    Adam state.  Checkpoints of ring and non-ring masters are not
    interchangeable (:meth:`layout_metadata`).

    ``wire_dtype`` (``ADAPCC_WIRE_DTYPE`` overrides it) gives each rank's
    gradient contribution its codec's wire value before the reduce-scatter,
    as the JAX package does; the ring itself still runs K1 on float32.
    """

    LAYOUT_KEY = "zero1_layout"

    def __init__(
        self,
        tx: OptimizerFactory,
        world: int,
        ring: bool = True,
        ring_chunk_bytes: Optional[int] = None,
        wire_dtype: Optional[str] = None,
        tuner: Optional[Any] = None,
        overlap: str = "off",
        shard_replicas: int = 0,
    ) -> None:
        if not ring:
            raise not_ported("ZeRO-1's XLA (psum_scatter / all_gather) path", _XLA_SLICE)
        if tuner is not None:
            raise not_ported("a tuner-chosen ZeRO-1 ring chunk", "the tuner slice")
        if overlap != "off":
            raise not_ported(f"ZeRO-1 with overlap={overlap!r}", "the overlapped-sync slice")
        if shard_replicas:
            raise not_ported("ZeRO-1 shard replicas", "the elasticity slice")
        self.tx = tx
        self.world = world
        self.ring = ring
        #: staging granularity of the ring collectives (None: the default,
        #: env-overridable); it never changes the chunk layout
        self.ring_chunk_bytes = ring_chunk_bytes
        #: codec of each rank's gradient contribution: ADAPCC_WIRE_DTYPE >
        #: the argument > "off", resolved now so a typo raises here
        self.wire_dtype = resolve_wire_dtype(wire_dtype)
        self._meta: Optional[_FlatMeta] = None

    def _align(self) -> int:
        """The ring moves whole float32 tiles, so each shard is tile-aligned
        (the XLA path's alignment of 1 comes with that path)."""
        return _tile_elems(torch.float32)

    def init(self, model: nn.Module) -> Tuple[torch.Tensor, torch.optim.Optimizer]:
        """``(master [world, N/world] float32, opt_state)`` on the model's device."""
        meta = self._meta = _flatten_meta(model, self.world, self._align())
        flat = _flatten({n: p.detach() for n, p in model.named_parameters()}, meta)
        # row r ← chunk (r + 1) % world
        master = torch.roll(flat.view(self.world, -1), -1, dims=0).contiguous()
        return master, self.tx([master])

    def layout_metadata(self) -> Dict[str, Any]:
        """The layout of the master and optimizer state: ring mode permutes
        chunk ownership and tile-aligns shards."""
        return {"ring": self.ring, "align": self._align(), "world": self.world}

    def restore(self, ckpt: Any):
        raise not_ported("ZeRO-1 checkpoint restore", "the checkpoint slice")


def zero1_train_step(
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    opt: Zero1Optimizer,
) -> Callable:
    """The full ZeRO-1 step: per-rank gradients of the batch shards, the
    ring reduce-scatter, the sharded update, the ring all-gather.

    ``step(model, master, opt_state, batch) -> (model, master, opt_state,
    losses)``: ``batch``'s leading dim is global and rank ``r`` takes the
    ``r``-th contiguous ``1/world`` of it; ``model``, ``master`` and
    ``opt_state`` are updated in place; ``losses`` is the ``[world]``
    per-rank loss.  Gradients are the mean over ranks, as in DDP.  The flat
    layout is the one ``opt.init`` made.  Nothing waits for the card: a
    wedged ring raises at a later ring launch or at the caller's
    ``comm.ring.check_errors()``.
    """
    world = opt.world

    def step(model: nn.Module, master: torch.Tensor, opt_state: torch.optim.Optimizer, batch: Any):
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
        # the ring leaves rank r with reduced chunk (r + 1) % world: the
        # master's row layout
        g_shard = ring_reduce_scatter_stacked(stacked, chunk_bytes=opt.ring_chunk_bytes)
        del stacked
        zero1_apply_shard(opt_state, master, g_shard, meta, model,
                          ring=opt.ring, ring_chunk_bytes=opt.ring_chunk_bytes)
        return model, master, opt_state, torch.stack(losses)

    return step
