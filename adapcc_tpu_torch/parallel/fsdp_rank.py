"""FSDP (ZeRO-3) per rank: the port of JAX's GSPMD FSDP
(``adapcc_tpu/parallel/fsdp.py:46-170``), one process a rank.

Every parameter leaf of at least ``min_shard_elems`` elements is sharded
over the world along its largest dimension that the world divides (ties to
the later one), chosen on the flax leaf's shape (:func:`_leaf_spec`, JAX's
rule, so the same leaves shard the same dimensions); smaller leaves stay
replicated.  Each rank of the process group keeps its slice of every
sharded leaf (in the torch layout, along the corresponding torch dimension)
and the optimizer state of exactly those slices and of the replicated
leaves.  A step (:func:`fsdp_train_step`) all-gathers the sharded parameters
into the model before use, runs forward and backward on this rank's batch
shard, reduce-scatters each sharded gradient (AVG: the gradient of the
global mean loss) and all-reduces the replicated ones, steps the optimizer
on the slices, and releases the gathered parameters.  The returned loss is
the world's mean, JAX's one loss of the global batch.  The optimizer's
transformation must be elementwise (Adam, SGD): one over the whole tree (a
global norm clip) would see one rank's slices only.

Kept apart from :mod:`adapcc_tpu_torch.parallel.fsdp`, whose
single-controller ZeRO-1 reaches the card only through the hand-written
ring kernels: here the process group's collectives move the slices (gloo
on the CPU, NCCL on the card).  ``fsdp_tp_shardings`` and
``fsdp_tp_train_step`` (FSDP × tensor parallel on a 2D mesh) wait for their
slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from adapcc_tpu_torch.comm.mesh import World
from adapcc_tpu_torch.ddp.trainer import OptimizerFactory
from adapcc_tpu_torch.models.convert import flax_paths, flax_shape
from adapcc_tpu_torch.primitives import not_ported


#: the data axis' name in a spec (JAX's ``RANKS_AXIS``)
RANKS_AXIS = "ranks"
#: a partition spec over a leaf's dimensions: None (replicated) or the axis
FsdpSpec = Tuple[Optional[str], ...]


def _leaf_spec(shape: Tuple[int, ...], world: int, min_elems: int, axis_name: str = RANKS_AXIS) -> FsdpSpec:
    """The spec sharding the largest dim divisible by ``world`` (JAX's
    ``PartitionSpec`` as a tuple; ``()`` is replicated).

    Small leaves (biases, layernorm scales) stay replicated — sharding them
    buys nothing and costs a gather of a few scalars.
    """
    if not shape or int(np.prod(shape)) < min_elems:
        return ()
    # largest divisible dim wins; ties go to the later (usually output) dim
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if d % world == 0 and d >= best_size:
            best, best_size = i, d
    if best is None:
        return ()
    spec: List[Optional[str]] = [None] * len(shape)
    spec[best] = axis_name
    return tuple(spec)


def _world_size(world: Union[int, World]) -> int:
    return world if isinstance(world, int) else world.world_size


def fsdp_shardings(model: nn.Module, world: Union[int, World], axis_name: str = RANKS_AXIS,
                   min_shard_elems: int = 2**14) -> Dict[str, FsdpSpec]:
    """``{parameter name: spec}`` on each parameter's flax leaf shape (a
    ``Dense`` kernel ``[in, out]``, a ``Conv`` kernel ``HWIO``), JAX's
    ``fsdp_shardings`` leaf by leaf."""
    n = _world_size(world)
    paths = flax_paths(model)
    return {name: _leaf_spec(flax_shape(tuple(p.shape)) if paths[name][1] else tuple(p.shape), n,
                             min_shard_elems, axis_name)
            for name, p in model.named_parameters()}


def _torch_dim(p: torch.Tensor, transposed: bool, spec: FsdpSpec) -> Optional[int]:
    """The torch dimension a spec on the flax leaf shards (None: replicated)."""
    if not any(spec):
        return None
    flax_dim = next(i for i, a in enumerate(spec) if a is not None)
    if not transposed:
        return flax_dim
    # the flax layout's dim i is the torch layout's perm[i]
    perm = tuple(range(p.dim()))[::-1] if p.dim() == 2 else (2, 3, 1, 0)
    return perm[flax_dim]


class FSDPParams:
    """One rank's FSDP parameters: the slices of the sharded leaves and the
    replicated leaves (``shards``, leaves in ``model.named_parameters()``
    order, the replicated ones the model's own parameters) over ``model``,
    whose sharded parameters hold nothing between steps."""

    def __init__(self, model: nn.Module, world: World, specs: Dict[str, FsdpSpec]) -> None:
        self.model = model
        self.world = world
        self.specs = specs
        paths = flax_paths(model)
        #: parameter name -> the torch dim its leaf shards (None: replicated)
        self.dims: Dict[str, Optional[int]] = {}
        self.shards: Dict[str, nn.Parameter] = {}
        n, r = world.world_size, world.rank
        for name, p in model.named_parameters():
            dim = _torch_dim(p, paths[name][1], specs[name])
            self.dims[name] = dim
            if dim is None:
                self.shards[name] = p
            else:
                self.shards[name] = nn.Parameter(p.detach().chunk(n, dim)[r].clone())
                p.data = p.data.new_empty(0)
        #: the full shapes of the sharded parameters
        self.shapes = {name: tuple(s.shape[:d]) + (s.shape[d] * n,) + tuple(s.shape[d + 1:])
                       for name, s in self.shards.items() if (d := self.dims[name]) is not None}

    def parameters(self) -> List[nn.Parameter]:
        """The tensors the optimizer updates."""
        return list(self.shards.values())

    @torch.no_grad()
    def gather(self) -> nn.Module:
        """All-gather every sharded leaf into the model (a collective: every
        rank calls it); returns the model, whole."""
        n = self.world.world_size
        params = dict(self.model.named_parameters())
        for name, dim in self.dims.items():
            if dim is None:
                continue
            shard = self.shards[name].detach()
            out = torch.empty((n * shard.numel(),), dtype=shard.dtype, device=shard.device)
            dist.all_gather_into_tensor(out, shard.contiguous().reshape(-1))
            params[name].data = torch.cat(list(out.view(n, *shard.shape)), dim=dim)
        return self.model

    def release(self) -> None:
        """Free the gathered copies of the sharded leaves."""
        params = dict(self.model.named_parameters())
        for name, dim in self.dims.items():
            if dim is not None:
                params[name].data = params[name].data.new_empty(0)
                params[name].grad = None

    @torch.no_grad()
    def reduce_scatter_grads(self) -> None:
        """Each sharded leaf's gradient averaged over the world onto this
        rank's slice (one reduce-scatter), each replicated one averaged in
        place (one all-reduce); an unused parameter's gradient is zero."""
        n = self.world.world_size
        for name, p in self.model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            dim = self.dims[name]
            if dim is None:
                dist.all_reduce(g)
                p.grad = g.div_(n)
                continue
            shard = self.shards[name]
            stacked = torch.stack(g.chunk(n, dim)).reshape(-1)
            out = torch.empty((shard.numel(),), dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, stacked)
            shard.grad = out.view(shard.shape).div_(n)


def shard_fsdp(model: nn.Module, world: World, axis_name: str = RANKS_AXIS,
               min_shard_elems: int = 2**14) -> FSDPParams:
    """This rank's FSDP parameters (1/world of every sharded leaf); the
    model's sharded parameters are released."""
    return FSDPParams(model, world, fsdp_shardings(model, world, axis_name, min_shard_elems))


def fsdp_train_step(
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    tx: OptimizerFactory,
    world: World,
) -> Callable:
    """The per-rank FSDP step: ``step(params, opt_state, batch) -> (params,
    opt_state, loss)``, with ``params`` from :func:`shard_fsdp` (which alone
    decides the sharding), ``opt_state`` a ``tx(params.parameters())``
    optimizer (``None`` builds it) and ``batch`` this rank's shard of the
    global batch; updated in place.  ``loss`` is the world's mean loss."""

    def step(params: FSDPParams, opt_state: Optional[torch.optim.Optimizer], batch: Any):
        if opt_state is None:
            opt_state = tx(params.parameters())
        model = params.gather()
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        params.reduce_scatter_grads()
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        params.release()
        loss = loss.detach().clone()
        dist.all_reduce(loss)
        return params, opt_state, loss / world.world_size

    return step


def fsdp_tp_shardings(*args: Any, **kwargs: Any):
    """FSDP × tensor parallel's 2D layout: waits for its slice."""
    raise not_ported("fsdp_tp_shardings (FSDP x tensor parallel on a 2D mesh)", _FSDP_TP_SLICE)


def fsdp_tp_train_step(*args: Any, **kwargs: Any):
    """FSDP × tensor parallel's step: waits for its slice."""
    raise not_ported("fsdp_tp_train_step (FSDP x tensor parallel on a 2D mesh)", _FSDP_TP_SLICE)


_FSDP_TP_SLICE = "the FSDP x TP slice (per-rank 2D subgroups of the World)"
