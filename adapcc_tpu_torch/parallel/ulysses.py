"""Ulysses (DeepSpeed-style) sequence parallelism: an all-to-all head exchange.

The port of :mod:`adapcc_tpu.parallel.ulysses`.  Instead of rotating K/V
blocks around a ring, each rank trades its sequence shard for a head shard
with one all-to-all, computes full-sequence attention on its ``H/world``
heads, and trades back::

    in:   [B, T/world, H, D]      sequence-sharded
    →     [B, T, H/world, D]      head-sharded (all-to-all)
    attn: attention over the whole T on H/world heads
    →     [B, T/world, H, D]      sequence-sharded again (all-to-all)

``block_impl="flash"`` runs the full-sequence attention on the flash
kernels (K2 forward, K3 and K4 backward) through
:func:`~adapcc_tpu_torch.ops.flash_attention.flash_attention`; ``"dense"``
is JAX's materialized softmax in float32.

Per rank (``q/k/v [B, T_local, H, D]``) Q, K and V cross the axis as one
``[world, 3, ...]`` tensor: one all-to-all each way, whose backward is the
same exchange.  Stacked (``[world, B, T_local, H, D]``) the exchange is a
permutation of the rank and head-group dimensions, and one kernel launch
covers every rank's head group: ``[world·B, T, H/world, D]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from adapcc_tpu_torch.ops.flash_attention import flash_attention
from adapcc_tpu_torch.parallel.axis import Axis, all_to_all
from adapcc_tpu_torch.parallel.ring_attention import (
    _NEG_INF, _check_shard, shard_sequence, unshard_sequence,
)


def _seq_to_heads(qkv: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[3, (world,) B, Tl, H, D]`` → ``[3, B', T, H/world, D]``, ``B'`` =
    ``B`` per rank, ``world·B`` stacked (head group ``g``'s rows at ``g·B``)."""
    w = axis.size
    if axis.stacked:
        _, _, B, Tl, H, D = qkv.shape
        x = qkv.view(3, w, B, Tl, w, H // w, D)  # [3, rank, B, Tl, group, h, D]
        return x.permute(0, 4, 2, 1, 3, 5, 6).reshape(3, w * B, w * Tl, H // w, D)
    _, B, Tl, H, D = qkv.shape
    x = qkv.view(3, B, Tl, w, H // w, D).permute(3, 0, 1, 2, 4, 5)  # [group, 3, B, Tl, h, D]
    # row j is now rank j's sequence block of my head group
    x = all_to_all(x, axis)
    return x.permute(1, 2, 0, 3, 4, 5).reshape(3, B, w * Tl, H // w, D)


def _heads_to_seq(out: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The inverse: ``[B', T, H/world, D]`` → ``[(world,) B, Tl, H, D]``."""
    w = axis.size
    if axis.stacked:
        wB, T, h, D = out.shape
        x = out.view(w, wB // w, w, T // w, h, D)  # [group, B, rank, Tl, h, D]
        return x.permute(2, 1, 3, 0, 4, 5).reshape(w, wB // w, T // w, w * h, D)
    B, T, h, D = out.shape
    x = out.view(B, w, T // w, h, D).permute(1, 0, 2, 3, 4)  # [rank, B, Tl, h, D]
    # row g is now my sequence block of head group g
    x = all_to_all(x, axis)
    return x.permute(1, 2, 0, 3, 4).reshape(B, T // w, w * h, D)


def ulysses_attention_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Axis,
    causal: bool = True,
    scale: Optional[float] = None,
    block_impl: str = "dense",
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Ulysses attention over ``axis`` (JAX's ``axis_name``): per rank
    ``q/k/v [B, T_local, H, D]``, stacked ``[world, B, T_local, H, D]``, with
    ``H`` divisible by the axis size; returns the same shape in
    ``q.dtype``."""
    if block_impl not in ("dense", "flash"):
        raise ValueError(f"unknown block_impl {block_impl!r} (dense|flash)")
    _check_shard(q, axis)
    D, H = q.shape[-1], q.shape[-2]
    world = axis.size
    if H % world != 0:
        raise ValueError(f"heads ({H}) must divide by the axis size ({world})")
    if scale is None:
        scale = 1.0 / (D**0.5)

    qh, kh, vh = _seq_to_heads(torch.stack([q, k, v]), axis)
    if block_impl == "flash":
        out = flash_attention(qh, kh, vh, causal=causal, scale=scale, block_q=block_q, block_k=block_k)
        return _heads_to_seq(out, axis).to(q.dtype)

    s = torch.einsum("bqhd,bkhd->bhqk", qh.float() * scale, kh.float())
    if causal:
        T = s.shape[-1]
        above = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh.float())
    return _heads_to_seq(out, axis).to(q.dtype)


def ulysses_attention(
    world: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_impl: str = "dense",
) -> torch.Tensor:
    """Global view: ``q/k/v [B, T, H, D]`` with ``T`` and ``H`` divisible
    by ``world``, over a stacked axis of ``world`` ranks.  (JAX takes a
    mesh where the port takes its size.)"""
    axis = Axis("ranks", world)
    out = ulysses_attention_shard(
        shard_sequence(q, world), shard_sequence(k, world), shard_sequence(v, world), axis,
        causal=causal, scale=scale, block_impl=block_impl,
    )
    return unshard_sequence(out)
