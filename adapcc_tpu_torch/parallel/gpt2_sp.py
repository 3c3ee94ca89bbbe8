"""Sequence-parallel GPT-2 training: the step over sequence shards.

The port of :mod:`adapcc_tpu.parallel.gpt2_sp`.  The global batch ``[B, T]``
is sharded along ``T`` over the mesh axis the model's ``cfg.sp_axis`` names;
every layer is position-wise except attention, which crosses shards through
the ring or Ulysses program (``cfg.sp_impl``), on the flash kernels with
``attention="flash"``.  The loss takes each shard's boundary target with one
``[B]`` ring shift (``models.gpt2.lm_loss_sp``).  With ``data_axis`` (a
``(data, sp)`` mesh) the batch is also sharded over the data axis: each data
row runs its own sequence-parallel ring, losses and gradients average over
the rows, DP × SP.

The gradient is the unsharded one, the number JAX returns.  JAX gets it
with a ``pmean`` of per-shard gradients that carry a ``world×`` factor (its
loss ``psum``s in the forward, and the psum transposes to a psum).  The port
gets it directly: per rank, each rank's backward is that of its own share
of the loss (the loss's ``psum`` passes each rank its own cotangent; with a
data axis the rows' losses are averaged first), and one SUM all-reduce of
the gradients over the sequence axis, then one over the data axis, adds the
shares; stacked, every rank's rows run through one model, so autograd adds
them.

Forms (:mod:`adapcc_tpu_torch.parallel.axis`): on a stacked mesh the step
takes the global ``[B, T]`` batch; per rank it takes this rank's ``[B/dp,
T/sp]`` shard (:func:`local_tokens`).  Stacked, the data rows are batch rows
of one sequence-parallel run: every data row holds the same number of valid
positions, so the mean of the rows' means is the mean over all of them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from adapcc_tpu_torch.models.gpt2 import GPT2, lm_loss_sp, lm_loss_sp_chunked
from adapcc_tpu_torch.parallel.axis import Mesh, psum, sum_grads


def local_tokens(tokens: torch.Tensor, mesh: Mesh, axis_name: str = "ranks",
                 data_axis: Optional[str] = None) -> torch.Tensor:
    """This rank's ``[B/dp, T/sp]`` shard of the global ``[B, T]`` batch on
    a per-rank mesh (JAX's ``P(data_axis, axis_name)``)."""
    sp = mesh[axis_name]
    B, T = tokens.shape
    Tl = T // sp.size
    rows = tokens
    if data_axis is not None:
        dp = mesh[data_axis]
        rows = tokens.view(dp.size, B // dp.size, T)[dp.index()]
    return rows[:, sp.index() * Tl:(sp.index() + 1) * Tl]


def _stack_rows(tokens: torch.Tensor, world: int) -> torch.Tensor:
    """``[B, T]`` → the stacked rows ``[world·B, T/world]``, rank ``r``'s at
    ``[r·B, (r+1)·B)``."""
    B, T = tokens.shape
    if T % world:
        raise ValueError(f"sequence length {T} does not divide by the axis size {world}")
    return tokens.view(B, world, T // world).transpose(0, 1).reshape(world * B, T // world)


def gpt2_sp_loss_and_grad(
    model: GPT2, mesh: Mesh, axis_name: str = "ranks",
    data_axis: Optional[str] = None, loss: str = "dense",
    loss_block: int = 1024,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``tokens → (loss, grads)`` with the sequence sharded over
    ``axis_name``: ``grads`` the unsharded gradient by parameter name (the
    parameters' ``.grad``, replicated per rank), ``loss`` replicated.

    ``model.cfg.sp_axis`` must be the mesh's ``axis_name`` axis, and ``T``
    must divide by its size.  ``loss="chunked"`` takes the vocabulary in
    blocks of ``loss_block`` (no ``[B, T_local, V]`` logits).
    """
    cfg = model.cfg
    axis = next((a for a in mesh.axes if a.name == axis_name), None)
    if cfg.sp_axis is None or cfg.sp_axis != axis:
        name = None if cfg.sp_axis is None else cfg.sp_axis.name
        raise ValueError(
            f"model.cfg.sp_axis {name!r} must equal the mesh axis "
            f"{axis_name!r} the step is sharded over"
        )
    if data_axis is not None and data_axis not in mesh.axis_names:
        raise ValueError(f"data_axis {data_axis!r} not in mesh axes {mesh.axis_names}")
    if loss not in ("dense", "chunked"):
        raise ValueError(f"loss must be 'dense' or 'chunked', got {loss!r}")
    data = None if data_axis is None else mesh[data_axis]
    params = dict(model.named_parameters())

    def loss_fn(tokens: torch.Tensor) -> torch.Tensor:
        if axis.stacked:
            tokens = _stack_rows(tokens, axis.size)
        if loss == "chunked":
            hidden = model(tokens, return_hidden=True)
            return lm_loss_sp_chunked(hidden, model.wte.weight, tokens, axis,
                                      block=min(loss_block, cfg.vocab_size), compute_dtype=cfg.dtype)
        return lm_loss_sp(model(tokens), tokens, axis)

    def loss_and_grad(tokens: torch.Tensor):
        model.zero_grad(set_to_none=True)
        value = loss_fn(tokens)
        if data is not None and not data.stacked:
            # each data row's backward is 1/dp of its loss's, so one SUM
            # over both axes is the rows' mean gradient
            value = psum(value, data) / data.size
        value.backward()
        sum_grads(params.values(), (axis, data))
        return value.detach(), {n: p.grad for n, p in params.items()}

    return loss_and_grad


def gpt2_sp_train_step(
    model: GPT2, tx, mesh: Mesh, axis_name: str = "ranks",
    data_axis: Optional[str] = None, loss: str = "dense",
    loss_block: int = 1024,
) -> Callable:
    """``step(model, opt_state, tokens) → (model, opt_state, loss)``: the
    full SP (or DP × SP, with ``data_axis``) training step, ``model``
    updated in place by ``opt_state``, a ``tx(model.parameters())``
    optimizer (``tx`` is an optimizer factory such as
    :func:`~adapcc_tpu_torch.ddp.trainer.adamw`; ``opt_state=None`` builds
    it)."""
    loss_and_grad = gpt2_sp_loss_and_grad(model, mesh, axis_name, data_axis, loss, loss_block)

    def step(m: GPT2, opt_state: Optional[torch.optim.Optimizer], tokens: torch.Tensor):
        if m is not model:
            raise ValueError("gpt2_sp_train_step: the step was built for another model")
        if opt_state is None:
            opt_state = tx(model.parameters())
        value, _ = loss_and_grad(tokens)
        opt_state.step()
        return model, opt_state, value

    return step
