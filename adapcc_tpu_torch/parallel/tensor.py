"""Tensor parallelism: Megatron-style sharded matmuls.

The port of :mod:`adapcc_tpu.parallel.tensor`, in two parts:

1. **Sharding rules** (:func:`gpt2_tp_rules`, :func:`tree_shardings`,
   :func:`shard_tree`): which parameter of the GPT-2 shards which dimension
   over which mesh axis, by pattern over the flax paths.  qkv and fc are
   column parallel (a flax kernel ``[Din, Dout]`` shards ``Dout``), both
   residual ``proj`` kernels row parallel (shard ``Din``), the embedding its
   vocabulary.  A flax ``Dense`` kernel is the transpose of the torch
   ``Linear.weight``, so the spec of a kernel applies to the weight's
   dimensions reversed (:func:`~adapcc_tpu_torch.models.convert.flax_paths`
   carries the flag).  Where JAX places a leaf on its mesh, the port hands
   each rank its slice: per rank the rank's slice, stacked the ``[*mesh
   shape, ...]`` stack of every rank's.

2. **Explicit primitives** (:func:`column_parallel_dense`,
   :func:`row_parallel_dense`), in JAX's layout (a kernel ``[Din, Dout]``):
   the column output stays sharded and feeds the row matmul, which ends
   with the pair's one sum over the axis.  Stacked, a sharded operand leads
   with ``[world, ...]`` and a replicated one has no such dimension.
"""

from __future__ import annotations

import itertools
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from adapcc_tpu_torch.models.convert import flax_paths
from adapcc_tpu_torch.parallel.axis import Axis, Mesh, psum

#: a partition spec: one entry a dimension, None (replicated), an axis
#: name, or a tuple of axis names (the dimension split over their product)
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def column_parallel_dense(x: torch.Tensor, w_shard: torch.Tensor,
                          b_shard: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [..., Din] @ w_shard [Din, Dout/world]`` → the sharded ``[...,
    Dout/world]``.  ``x`` is replicated; stacked, ``w_shard`` (and
    ``b_shard``) lead with ``[world]`` and so does the result.  No
    collective."""
    if w_shard.dim() == 3:  # stacked: [world, Din, Dout/world]
        w_shard = _lead(w_shard, x.dim() - 1)
        b_shard = None if b_shard is None else _lead(b_shard, x.dim() - 1)
        x = x.unsqueeze(0)
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def _lead(t: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """A stacked ``[world, ...]`` operand viewed to broadcast against a
    ``[world, <batch_dims>, ...]`` one, with its last two (a weight) or
    last (a bias) dimensions kept."""
    keep = 2 if t.dim() == 3 else 1
    return t.view(t.shape[0], *([1] * (batch_dims - (keep - 1))), *t.shape[-keep:])


def row_parallel_dense(x_shard: torch.Tensor, w_shard: torch.Tensor, axis: Axis,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x_shard [..., Din/world] @ w_shard [Din/world, Dout]``, summed over
    ``axis`` → the replicated ``[..., Dout]`` (the pair's one collective:
    stacked a sum over the rows, per rank one SUM all-reduce).  The full
    bias ``b`` is added once, after the sum.  The backward gives each rank
    the sum's cotangent (:func:`~adapcc_tpu_torch.parallel.axis.psum`)."""
    if axis.stacked:
        w_shard = _lead(w_shard, x_shard.dim() - 2)
    y = psum(x_shard @ w_shard, axis)
    if b is not None:
        y = y + b
    return y


def gpt2_tp_rules(tp_axis: str = "model") -> List[Tuple[str, Spec]]:
    """Megatron sharding of the GPT-2's parameters, as ``(flax path regex,
    spec over the flax leaf's dimensions)``: attention qkv and MLP fc
    column parallel, both residual ``proj`` kernels row parallel, the
    embedding's vocabulary sharded; LayerNorms and the row layers' biases
    replicated."""
    return [
        (r".*attn/qkv/kernel", (None, tp_axis)),
        (r".*attn/qkv/bias", (tp_axis,)),
        (r".*attn/proj/kernel", (tp_axis, None)),
        (r".*/fc/kernel", (None, tp_axis)),
        (r".*/fc/bias", (tp_axis,)),
        (r".*h\d+/proj/kernel", (tp_axis, None)),
        (r".*wte/embedding", (tp_axis, None)),
    ]


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def tree_shardings(model: nn.Module, mesh: Mesh, rules: Sequence[Tuple[str, Spec]]) -> Dict[str, Spec]:
    """``{parameter name: spec over the torch parameter's dimensions}``:
    the first rule whose regex fully matches the parameter's flax path
    (``h0/attn/qkv/kernel``) wins, and applies only if it divides the
    leaf's shape evenly; otherwise, and for an unmatched leaf, the
    parameter is replicated (``()``)."""
    paths = flax_paths(model)
    shape = mesh.shape
    out = {}
    for name, param in model.named_parameters():
        path, transposed = paths[name]
        flax_shape = tuple(reversed(param.shape)) if transposed else tuple(param.shape)
        spec: Spec = ()
        for pat, rule in rules:
            if re.fullmatch(pat, "/".join(path)):
                divides = all(
                    entry is None or (
                        dim < len(flax_shape)
                        and flax_shape[dim] % math.prod(shape[a] for a in _axes(entry)) == 0)
                    for dim, entry in enumerate(rule))
                if divides:
                    spec = tuple(reversed(rule)) if transposed else tuple(rule)
                break
        out[name] = spec
    return out


def _slice(t: torch.Tensor, spec: Spec, coord: Dict[str, int], shape: Dict[str, int]) -> torch.Tensor:
    """The block of ``t`` that ``spec`` gives the rank at ``coord``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts, index = 1, 0
        for a in _axes(entry):  # row-major over the entry's axes, as JAX splits
            parts, index = parts * shape[a], index * shape[a] + coord[a]
        n = t.shape[dim] // parts
        t = t.narrow(dim, index * n, n)
    return t


def shard_tree(model: nn.Module, mesh: Mesh, rules: Sequence[Tuple[str, Spec]]) -> Dict[str, torch.Tensor]:
    """Each parameter's shard under :func:`tree_shardings`: per rank this
    rank's slice, stacked the ``[*mesh shape, ...]`` stack of every rank's
    (a replicated parameter's copies included)."""
    specs = tree_shardings(model, mesh, rules)
    shape = mesh.shape
    names = list(shape)
    params = dict(model.named_parameters())
    if not mesh.stacked:
        coord = {a.name: a.index() for a in mesh.axes}
        return {n: _slice(p.detach(), specs[n], coord, shape).clone() for n, p in params.items()}
    coords = [dict(zip(names, c)) for c in itertools.product(*(range(shape[a]) for a in names))]
    return {n: torch.stack([_slice(p.detach(), specs[n], c, shape) for c in coords]).reshape(
        *shape.values(), *_slice(p, specs[n], coords[0], shape).shape) for n, p in params.items()}

