"""Mesh axes for the parallel planes: the port's counterpart of a named
``shard_map`` axis.

The JAX package runs a plane's shard body under ``shard_map`` and names the
mesh axis it crosses (``axis_name``, ``GPT2Config.sp_axis``).  The port runs
the same bodies in its two forms (the ROADMAP's process model):

- **per rank**: one process holds one shard, and the axis carries this
  rank's process group along it (gloo on the CPU, NCCL on cards);
- **stacked**: one process holds every shard, rank ``r``'s being row ``r``
  of a leading ``[size, ...]`` dimension, and a collective is a tensor
  operation along that dimension.

An :class:`Axis` names the axis, its size and its group (``None`` when
stacked); a :class:`Mesh` is a tuple of axes laid out row-major over the
ranks, as ``jax.sharding.Mesh(devices.reshape(sizes), names)`` lays them.

The collectives the planes cross an axis with:

- :func:`ring_shift`, ``lax.ppermute`` by the ring's receive-from-right
  permutation (:func:`_ring_perm`); its backward permutes the cotangent by
  the inverse pairs, ppermute's transpose;
- :func:`all_to_all`, ``lax.all_to_all`` on the leading dimension (per
  rank); its backward is the same exchange;
- :func:`psum`, whose forward sums over the axis and whose backward gives
  each rank its own cotangent: a rank's gradient is then that of its own
  term, and the caller sums gradients over the axis (one SUM all-reduce), as
  Megatron's conjugate pair does;
- :func:`pmax`, a forward statistic with no gradient.

Per rank, every rank must call each of them in the same order.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """A mesh axis: its ``name``, its ``size`` and, per rank, this rank's
    process ``group`` along it (``None``: stacked)."""

    name: str
    size: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def stacked(self) -> bool:
        return self.group is None

    def index(self) -> int:
        """This rank's position along the axis (per rank only)."""
        if self.stacked:
            raise ValueError(f"axis {self.name!r} is stacked: every rank's row is in this process")
        return dist.get_rank(self.group)

    def ranks(self) -> range:
        """The axis positions whose rows this process holds: all of them
        when stacked, this rank's alone per rank."""
        if self.stacked:
            return range(self.size)
        me = self.index()
        return range(me, me + 1)


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks, row-major (the last axis varies fastest)."""

    axes: Tuple[Axis, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return {a.name: a.size for a in self.axes}

    @property
    def stacked(self) -> bool:
        return all(a.stacked for a in self.axes)

    def __getitem__(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"axis {name!r} not in mesh axes {self.axis_names}")

    @staticmethod
    def stacked_mesh(shape: Mapping[str, int]) -> "Mesh":
        """Every rank's row in this process."""
        return Mesh(tuple(Axis(name, int(size)) for name, size in shape.items()))

    @staticmethod
    def per_rank(shape: Mapping[str, int]) -> "Mesh":
        """This rank's axes in the initialized process group, whose size
        must be the product of ``shape``: one new group a line of ranks along
        each axis.  Every rank must call it, with the same ``shape``."""
        names, sizes = list(shape), [int(s) for s in shape.values()]
        world, me = dist.get_world_size(), dist.get_rank()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {dict(shape)} needs {math.prod(sizes)} ranks, the world has {world}")
        coords = list(itertools.product(*(range(s) for s in sizes)))
        axes = []
        for i, name in enumerate(names):
            mine = None
            # every line along axis i, in one order on every rank
            for fixed in sorted({c[:i] + c[i + 1:] for c in coords}):
                line = [r for r, c in enumerate(coords) if c[:i] + c[i + 1:] == fixed]
                group = dist.new_group(line)
                if me in line:
                    mine = group
            axes.append(Axis(name, sizes[i], mine))
        return Mesh(tuple(axes))


# --------------------------------------------------------------------------- #
# collectives over an axis
# --------------------------------------------------------------------------- #


def _ring_perm(world: int) -> List[Tuple[int, int]]:
    """Receive-from-right rotation as ``(source, destination)`` pairs:
    after ``j`` shifts a rank holds the block first owned by rank ``(me +
    j) % world``.  The one definition of the rotation's direction."""
    return [(i, (i - 1) % world) for i in range(world)]


def _ppermute(x: torch.Tensor, group: dist.ProcessGroup, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over ``group``: this rank sends ``x`` where ``perm``
    sends it and receives what ``perm`` sends it (one send, one receive)."""
    me = dist.get_rank(group)
    dst = next(d for s, d in perm if s == me)
    src = next(s for s, d in perm if d == me)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


def ring_shift(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Receive from the right: afterwards rank ``r`` holds what rank
    ``(r + 1) % size`` held.  Stacked, the rows along ``dim`` rotate (row
    ``r`` takes row ``r + 1``); per rank, ``x`` goes whole to the left
    neighbour.  Differentiable."""
    if axis.size == 1:
        return x
    if axis.stacked:
        return torch.roll(x, -1, dims=dim)
    return _PPermute.apply(x, axis.group, _ring_perm(axis.size))


def _a2a(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)`` over a per-rank
    axis: ``x`` is ``[size, ...]`` and row ``j`` of the result is row
    ``me`` of rank ``j``'s ``x``.  Differentiable (the exchange is its own
    transpose)."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis.group)


class _SumOwnGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the axis, replicated: stacked, ``x``'s rows summed
    (``x.sum(0)``); per rank, a SUM all-reduce.  The gradient of each
    rank's ``x`` is the cotangent of the sum itself, so a rank's gradient
    is that of its own term and the caller sums gradients over the axis."""
    if axis.stacked:
        return x.sum(0)
    if axis.size == 1:
        return x
    return _SumOwnGrad.apply(x, axis.group)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The elementwise maximum over the axis, replicated; no gradient."""
    x = x.detach()
    if axis.stacked:
        return x.amax(0)
    out = x.clone()
    if axis.size > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


def sum_grads(params, axes) -> None:
    """Sum each parameter's ``.grad`` over the per-rank ``axes`` in place
    (one flat SUM all-reduce an axis); stacked axes sum in the autograd
    graph already and are skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    live = [a for a in axes if a is not None and not a.stacked and a.size > 1]
    if not grads or not live:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    for a in live:
        dist.all_reduce(flat, group=a.group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
