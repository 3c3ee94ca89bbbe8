"""Forward pipeline building block: one GPipe fill and drain over stacked
stage parameters.

The port of :mod:`adapcc_tpu.pipe.forward`.  JAX compiles the pipeline into
one program: a ``lax.scan`` over ticks in which every stage computes and
hands its output to the next stage by a ``ppermute``, and one ``psum``
replicates the last stage's outputs.  The port runs it in the stacked form
on one device: a tick loop, the row shift between stages, and the last
stage's outputs as the result.  Stages whose slot in a tick is a bubble
(filling or draining) compute nothing: in JAX their results are never
collected, so the outputs are the same.  The whole loop is differentiable
(gradients flow back through the shifts).  The training executor
(:mod:`adapcc_tpu_torch.pipe.executor`) does not use it.

Formerly ``parallel.pipeline`` (still importable there through a warn-once
alias).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, List, Optional

import torch

from adapcc_tpu_torch.primitives import not_ported

if TYPE_CHECKING:  # parallel/ re-exports this module
    from adapcc_tpu_torch.parallel.axis import Mesh


def _stage_slice(tree: Any, s: int) -> Any:
    """Stage ``s``'s row of every leaf of a (nested tuple/list/dict) tree."""
    if isinstance(tree, torch.Tensor):
        return tree[s]
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_stage_slice(v, s) for v in tree)
    raise TypeError(f"stage parameters must be tensors in tuples, lists or dicts, got {type(tree).__name__}")


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    batch: torch.Tensor,
    mesh: "Mesh",
    axis_name: str = "stages",
    num_microbatches: int = 4,
) -> torch.Tensor:
    """Run ``stage_fn`` as a forward pipeline over ``mesh[axis_name]``.

    ``stacked_params``: a tree whose leaves have a leading ``num_stages``
    dimension (stage ``s`` uses ``leaf[s]``).  ``batch [B, ...]`` with ``B``
    divisible by ``num_microbatches``; ``stage_fn`` keeps the microbatch's
    shape.  Returns the ``[B, ...]`` outputs.  A stacked axis only: the
    per-rank pipeline comes with one process a card."""
    axis = mesh[axis_name]
    if not axis.stacked:
        raise not_ported("the per-rank forward pipeline (one stage a process)", "the per-process planes")
    B = batch.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by microbatches {num_microbatches}")
    stages = axis.size
    x = batch.reshape(num_microbatches, B // num_microbatches, *batch.shape[1:])
    params = [_stage_slice(stacked_params, s) for s in range(stages)]

    outputs: List[Optional[torch.Tensor]] = [None] * num_microbatches
    incoming: List[Optional[torch.Tensor]] = [None] * stages
    for t in range(num_microbatches + stages - 1):
        # stage s holds microbatch t − s at tick t; the rest are bubbles
        outs = [
            stage_fn(params[s], x[t] if s == 0 else incoming[s]) if 0 <= t - s < num_microbatches else None
            for s in range(stages)
        ]
        if outs[-1] is not None:
            outputs[t - (stages - 1)] = outs[-1]
        # the row shift: stage s's output is stage s + 1's next input
        incoming = [None] + outs[:-1]
    out = torch.stack(outputs)
    return out.reshape(B, *out.shape[2:])


__all__ = ["pipeline_apply"]
