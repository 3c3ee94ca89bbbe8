"""Expert parallelism: MoE dispatch and combine over an ``experts`` axis.

The port of :mod:`adapcc_tpu.parallel.expert`.  Each rank owns ``E /
world`` experts and a shard of the tokens: routing happens locally, the
per-expert buffers go to the experts' home ranks by an all-to-all, the
experts run there on every rank's tokens, and a second all-to-all brings
the results back for the weighted combine.  Capacity is static per (rank,
expert), so every shape is fixed.

The shard body :func:`_moe_shard` runs on an
:class:`~adapcc_tpu_torch.parallel.axis.Axis` in the port's two forms:

- **stacked** (one process holds every rank's row): the tokens are
  ``[world, n_loc, D]``, the exchange swaps the source and destination
  dimensions of ``[world, world, ...]``, and ``pmean`` is the mean over the
  rows;
- **per rank** over a process group: this rank's ``[1, n_loc, D]``, the
  exchange :func:`~adapcc_tpu_torch.parallel.axis.all_to_all` (its own
  transpose in the backward), and ``pmean`` a SUM all-reduce over the world
  whose backward gives each rank its own cotangent: a rank's router
  gradient is then that of its own tokens' terms, and the caller sums the
  router's gradients over the axis (:func:`~adapcc_tpu_torch.parallel.axis.
  sum_grads`) to get the full gradient; the experts' gradients need no sum
  (each rank holds its own experts').

With an engine, the two exchanges go through
:meth:`~adapcc_tpu_torch.comm.engine.CollectiveEngine.expert_a2a`, which
traces them; the result is the raw exchange's bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from adapcc_tpu_torch.models.moe import MoEConfig, MoEMLP, experts_ffn, route, router_logits, switch_aux
from adapcc_tpu_torch.parallel import axis as ax
from adapcc_tpu_torch.parallel.axis import Axis, Mesh

#: a two-level world's axis names (JAX's ``is_two_level`` mesh)
TWO_LEVEL_AXES = ("dcn", "ici")


def moe_capacity(cfg: MoEConfig, n_loc: int) -> int:
    """Static per-(rank, expert) token capacity for a local shard of
    ``n_loc`` tokens: the one definition of the exchange geometry, shared
    by the shard body and train_moe's tuner probe."""
    return max(
        1,
        int(-(-cfg.capacity_factor * cfg.top_k * n_loc // cfg.num_experts)),
    )


def _pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.pmean`` over ``axis`` of the per-row statistics ``x [R, ...]``
    (R = world stacked, 1 per rank): the sum over the axis divided by its
    size, replicated."""
    total = x.sum(0) if axis.stacked else ax.psum(x[0], axis)
    return total / torch.full((), axis.size, dtype=total.dtype, device=total.device)


def _raw_a2a(axis: Optional[Axis]) -> Callable:
    """The exchange without an engine: stacked (``axis`` None or stacked),
    the swap of the source and destination dimensions; per rank, the
    axis's all-to-all."""
    if axis is None or axis.stacked:
        return lambda v, leg="dispatch": v.transpose(0, 1)
    return lambda v, leg="dispatch": ax.all_to_all(v, axis)


def _moe_shard(
    router_weight: torch.Tensor,
    router_bias: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    x: torch.Tensor,
    *,
    cfg: MoEConfig,
    axis: Axis,
    capacity: int,
    a2a: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The EP MoE over the rows this process holds: ``x [R, n_loc, D]``,
    ``w1 [R, e_loc, D, H]`` and ``w2 [R, e_loc, H, D]`` each row's expert
    slice, the router replicated (R = ``axis.size`` stacked, 1 per rank).
    ``a2a(v, leg)`` overrides the exchange (the engine's, or the two-level
    one).  Returns ``(y [R, n_loc, D], aux_loss)``."""
    if a2a is None:
        a2a = _raw_a2a(axis)

    def exchange(v: torch.Tensor, leg: str) -> torch.Tensor:
        return a2a(v, leg=leg) if axis.stacked else a2a(v[0], leg=leg)[None]

    world = axis.size
    R, n_loc, D = x.shape
    E = cfg.num_experts
    e_loc = w1.shape[1]

    # --- local routing (fp32 softmax) ------------------------------------
    logits = router_logits(x, router_weight, router_bias)             # [R, n_loc, E]
    probs = torch.softmax(logits, dim=-1)
    me, ce = switch_aux(probs, E)                                       # [R, E] each
    aux_loss = E * (_pmean(me, axis) * _pmean(ce, axis)).sum()
    if cfg.router_z_coef:
        # ST-MoE router z-loss, the mean over every rank's tokens
        z = torch.logsumexp(logits, dim=-1)
        aux_loss = aux_loss + cfg.router_z_coef * _pmean((z ** 2).mean(-1), axis)

    combine = route(probs, cfg.top_k, capacity)                        # [R, n_loc, E, C]
    dispatch = (combine > 0).to(cfg.dtype)

    # --- dispatch all-to-all: my tokens' buffers, grouped by owner rank ---
    expert_in = torch.einsum("rnec,rnd->recd", dispatch, x.to(cfg.dtype))
    expert_in = expert_in.reshape(R, world, e_loc, capacity, D)
    # afterwards dim 1 indexes the source rank and the experts are mine
    recv = exchange(expert_in, "dispatch")

    # --- my experts run on everyone's tokens -----------------------------
    flat = recv.transpose(1, 2).reshape(R, e_loc, world * capacity, D)
    out = experts_ffn(flat, w1, w2, cfg.dtype)
    out = out.reshape(R, e_loc, world, capacity, D).transpose(1, 2)

    # --- return all-to-all and the weighted combine ----------------------
    back = exchange(out, "return")
    expert_out = back.reshape(R, E, capacity, D)
    y = torch.einsum("rnec,recd->rnd", combine.to(cfg.dtype), expert_out)
    return y.to(x.dtype), aux_loss


def expert_parallel_moe(
    params: MoEMLP,
    x: torch.Tensor,
    cfg: MoEConfig,
    mesh: Mesh,
    axis_name: str = "experts",
    capacity: Optional[int] = None,
    engine: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """An EP-sharded MoE MLP.

    ``params``: a :class:`~adapcc_tpu_torch.models.moe.MoEMLP` holding
    every expert; experts shard over ``mesh[axis_name]``, tokens shard over
    the same axis, the router is replicated.  Stacked, ``x [N, D]`` is every token (``N`` divisible by
    the axis size) and ``y [N, D]`` comes back; per rank, ``x [n_loc, D]``
    is this rank's shard, which runs this rank's experts, and ``y`` is its
    tokens' output.  Returns ``(y, aux_loss)``.

    On a stacked two-level ``("dcn", "ici")`` mesh the expert and token
    world is the flattened grid and the exchanges run the hierarchical
    all-to-all (:func:`~adapcc_tpu_torch.comm.two_level.
    all_to_all_two_level_stacked`); a per-rank two-level mesh is refused
    (the per-rank two-level plane waits for one process a card).

    ``engine`` (a :class:`~adapcc_tpu_torch.comm.engine.CollectiveEngine`
    over the same world) routes the exchanges through its
    :meth:`~adapcc_tpu_torch.comm.engine.CollectiveEngine.expert_a2a`:
    the same bits, but traced, as every collective is."""
    a2a = None
    two_level = tuple(mesh.axis_names) == TWO_LEVEL_AXES
    if two_level:
        if axis_name != "experts":
            raise ValueError(
                "on a (dcn, ici) mesh expert_parallel_moe shards experts over "
                f"the full flattened grid; a specific axis_name ({axis_name!r}) "
                "would be silently ignored — build a flat sub-mesh for "
                "single-axis EP instead"
            )
        if not mesh.stacked:
            raise ValueError("per-rank expert parallelism on a (dcn, ici) mesh is not ported; the per-rank "
                             "two-level plane waits for one process a card")
        num_slices, ici_size = mesh["dcn"].size, mesh["ici"].size
        world = num_slices * ici_size
        axis = Axis("experts", world)
        from adapcc_tpu_torch.comm.two_level import all_to_all_two_level_stacked

        def a2a(v: torch.Tensor, leg: str = "dispatch") -> torch.Tensor:
            return all_to_all_two_level_stacked(v, num_slices, ici_size)
    else:
        axis = mesh[axis_name]
        world = axis.size
    if engine is not None:
        if engine.world_size != world:
            raise ValueError(
                f"engine world {engine.world_size} != expert-parallel world "
                f"{world}; build the engine on the MoE mesh"
            )
        if bool(getattr(engine, "two_level", False)) != two_level:
            raise ValueError(
                "engine and mesh disagree about the (dcn, ici) hierarchy; "
                "build the engine on the MoE mesh"
            )
        a2a = engine.expert_a2a(None if two_level else axis)
    if cfg.num_experts % world:
        raise ValueError(f"{cfg.num_experts} experts not divisible by world {world}")
    e_loc = cfg.num_experts // world
    n_loc = x.shape[0] // world if axis.stacked else x.shape[0]
    if capacity is None:
        capacity = moe_capacity(cfg, n_loc)

    w1, w2 = params.w1, params.w2
    if axis.stacked:
        rows = x.reshape(world, n_loc, x.shape[-1])
        w1 = w1.reshape(world, e_loc, *w1.shape[1:])
        w2 = w2.reshape(world, e_loc, *w2.shape[1:])
    else:
        me = axis.index()
        rows = x[None]
        w1 = w1[me * e_loc:(me + 1) * e_loc][None]
        w2 = w2[me * e_loc:(me + 1) * e_loc][None]
    y, aux = _moe_shard(
        params.router.weight, params.router.bias, w1, w2, rows,
        cfg=cfg, axis=axis, capacity=capacity, a2a=a2a,
    )
    return y.reshape(x.shape), aux


__all__ = ["TWO_LEVEL_AXES", "expert_parallel_moe", "moe_capacity"]
