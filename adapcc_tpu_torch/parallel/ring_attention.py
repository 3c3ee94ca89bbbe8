"""Ring attention: exact causal attention over a sequence-sharded axis.

The port of :mod:`adapcc_tpu.parallel.ring_attention`.  Each rank holds a
contiguous sequence shard of Q/K/V (rank ``r`` holds global positions
``[r·T_local, (r+1)·T_local)``); the K/V blocks rotate around the axis,
received from the right (``axis._ring_perm``, :func:`axis.ring_shift`),
while an online softmax accumulates exact attention in float32.

Two block implementations, as in JAX:

- ``"dense"``: each step's ``[T_local, T_local]`` scores in float32, merged
  by the running ``(max, sum)`` of the online softmax (plain torch);
- ``"flash"``: each step's block on the flash kernels (K2 forward; K3, K4
  in the backward, ``csrc/flash_attention.cu``) through the kernel-layout
  autograd entry ``_FlashAttention``, merged by log-sum-exp over the
  kernel's ``lse``.  The merge makes each block's ``lse`` an output with a
  cotangent, which reaches K3/K4 as ``delta − dlse``.  On CPU tensors the
  flash wrappers run their plain versions; on CUDA tensors they launch the
  kernels or raise.

The rotation carries K and V as one ``[2, ...]`` tensor, so per rank each
ring step is one send and one receive, and the backward's shifts form a
single chain that every rank runs in the same order.

Forms (:mod:`adapcc_tpu_torch.parallel.axis`): per rank ``q/k/v`` are ``[B,
T_local, H, D]``; stacked they are ``[world, B, T_local, H, D]``, and at
each step the ranks whose block has the same kind (full, diagonal or
skipped) share one kernel launch over their stacked ``B·H`` rows: with a
causal mask step 0 is one diagonal launch over every rank and step ``j > 0``
one full launch over ranks ``[world − j, world)``, whose source block lies
in their past; the others skip.  A skipped block launches nothing and gives
zeros with ``lse = _NEG_INF``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from adapcc_tpu_torch.ops.flash_attention import _check_blocks, _FlashAttention
from adapcc_tpu_torch.parallel.axis import Axis, ring_shift

_NEG_INF = -1e30  # finite "masked" score: keeps exp() well-defined


def _rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[R, B, T, H, D]``: the stacked tensor as it is, a rank's shard with
    a leading 1 (``R`` = the rows this process holds)."""
    return x if axis.stacked else x.unsqueeze(0)


def _unrows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.stacked else x.squeeze(0)


def _check_shard(q: torch.Tensor, axis: Axis) -> None:
    want = 5 if axis.stacked else 4
    if q.dim() != want:
        form = "[world, B, T_local, H, D] stacked" if axis.stacked else "[B, T_local, H, D] per rank"
        raise ValueError(f"ring attention takes {form} shards, got {tuple(q.shape)}")
    if axis.stacked and q.shape[0] != axis.size:
        raise ValueError(f"stacked shards lead with the axis size {axis.size}, got {q.shape[0]}")


def ring_attention_shard(
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
    """Ring attention over ``axis`` (JAX's ``axis_name``): per rank ``q/k/v
    [B, T_local, H, D]``, stacked ``[world, B, T_local, H, D]``; returns the
    same shape in ``q.dtype``.  ``block_impl="flash"`` runs each step's
    block on the flash kernels and merges by log-sum-exp."""
    if block_impl == "flash":
        return _ring_flash_shard(q, k, v, axis, causal, scale, block_q, block_k)
    if block_impl != "dense":
        raise ValueError(f"unknown block_impl {block_impl!r} (dense|flash)")
    _check_shard(q, axis)
    qr, kr, vr = _rows(q, axis), _rows(k, axis), _rows(v, axis)
    R, B, Tl, H, D = qr.shape
    world = axis.size
    if scale is None:
        scale = 1.0 / (D**0.5)
    me = torch.tensor(list(axis.ranks()), device=q.device)  # [R]
    qf = qr.float() * scale
    q_pos = me[:, None] * Tl + torch.arange(Tl, device=q.device)  # [R, Tl] global positions

    o = torch.zeros((R, B, H, Tl, D), dtype=torch.float32, device=q.device)
    m = torch.full((R, B, H, Tl), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((R, B, H, Tl), dtype=torch.float32, device=q.device)
    kv = torch.stack([kr, vr])  # [2, R, B, Tl, H, D]
    for j in range(world):
        if j:
            kv = ring_shift(kv, axis, dim=1)
        k_blk, v_blk = kv[0], kv[1]
        s = torch.einsum("rbqhd,rbkhd->rbhqk", qf, k_blk.float())  # [R, B, H, Tl, Tl]
        if causal:
            src = (me + j) % world
            k_pos = src[:, None] * Tl + torch.arange(Tl, device=q.device)
            mask = k_pos[:, None, :] <= q_pos[:, :, None]  # [R, q, k]
            s = torch.where(mask[:, None, None], s, torch.tensor(_NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("rbhqk,rbkhd->rbhqd", p, v_blk.float())
        m = m_new
    # a fully masked row (impossible for causal self-attention) would have
    # l == 0; the divide is guarded anyway, as in JAX
    out = o / torch.clamp(l, min=1e-20)[..., None]
    return _unrows(out.permute(0, 1, 3, 2, 4).to(q.dtype), axis)


class _Anchor(torch.autograd.Function):
    """``x`` as it is, with a gradient edge to ``dep`` that carries zeros.
    A rank whose ring step skips its block still runs that step's shift in
    the backward, as every other rank does."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _block_kinds(ranks: range, j: int, world: int, causal: bool) -> List[Tuple[str, int, int]]:
    """Runs ``(kind, lo, hi)`` of rows ``[lo, hi)`` whose step-``j`` block
    has the same kind: ``"full"`` (a past block, or any without the causal
    mask), ``"diag"`` (its own block, causal) or ``"skip"`` (a future
    block)."""
    runs: List[Tuple[str, int, int]] = []
    for row, me in enumerate(ranks):
        src = (me + j) % world
        kind = "full" if not causal or src < me else "diag" if src == me else "skip"
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1], row + 1)
        else:
            runs.append((kind, row, row + 1))
    return runs


def _flash_step(qf, kv, ranks: range, j: int, world: int, causal: bool, scale: float):
    """Step ``j``'s ``(o [R, BH, Tl, D], lse [R, BH, Tl])``: one kernel
    launch for each run of rows with a computed block, zeros and
    ``_NEG_INF`` for skipped ones."""
    R, BH, Tl, D = qf.shape
    outs, lses = [], []
    computed = False
    for kind, lo, hi in _block_kinds(ranks, j, world, causal):
        n = hi - lo
        if kind == "skip":
            outs.append(qf.new_zeros((n, BH, Tl, D)))
            lses.append(torch.full((n, BH, Tl), _NEG_INF, dtype=torch.float32, device=qf.device))
            continue
        computed = True
        o, lse = _FlashAttention.apply(
            qf[lo:hi].reshape(n * BH, Tl, D), kv[0, lo:hi].reshape(n * BH, Tl, D),
            kv[1, lo:hi].reshape(n * BH, Tl, D), scale, kind == "diag",
        )
        outs.append(o.view(n, BH, Tl, D))
        lses.append(lse.view(n, BH, Tl))
    o_blk = outs[0] if len(outs) == 1 else torch.cat(outs)
    lse_blk = lses[0] if len(lses) == 1 else torch.cat(lses)
    if not computed:
        o_blk = _Anchor.apply(o_blk, kv)
    return o_blk, lse_blk


def _ring_flash_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Axis,
    causal: bool,
    scale: Optional[float],
    block_q: int,
    block_k: int,
) -> torch.Tensor:
    """Flash ring: each step's block on the flash kernels, merged by
    log-sum-exp over their ``lse``.  The whole ring runs in the kernels'
    ``[B·H, T_local, D]`` layout, entered once and left once, not at every
    step."""
    _check_shard(q, axis)
    qr, kr, vr = _rows(q, axis), _rows(k, axis), _rows(v, axis)
    R, B, Tl, H, D = qr.shape
    _check_blocks(Tl, block_q, block_k)
    world = axis.size
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    scale = float(scale)

    qf = qr.permute(0, 1, 3, 2, 4).reshape(R, B * H, Tl, D)
    kv = torch.stack([kr, vr]).permute(0, 1, 2, 4, 3, 5).reshape(2, R, B * H, Tl, D)
    ranks = axis.ranks()
    o_acc = torch.zeros((R, B * H, Tl, D), dtype=torch.float32, device=q.device)
    m = torch.full((R, B * H, Tl), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((R, B * H, Tl), dtype=torch.float32, device=q.device)
    for j in range(world):
        if j:
            kv = ring_shift(kv, axis, dim=1)
        o_blk, lse_blk = _flash_step(qf, kv, ranks, j, world, causal, scale)
        # log-sum-exp merge: o_blk is normalized within its block, so its
        # weight in the running estimate is exp(lse_blk − m_new)
        m_new = torch.maximum(m, lse_blk)
        alpha = torch.exp(m - m_new)
        w = torch.exp(lse_blk - m_new)
        o_acc = o_acc * alpha[..., None] + o_blk.float() * w[..., None]
        l = l * alpha + w
        m = m_new
    out = o_acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.view(R, B, H, Tl, D).permute(0, 1, 3, 2, 4).to(q.dtype)
    return _unrows(out, axis)


def shard_sequence(x: torch.Tensor, world: int) -> torch.Tensor:
    """``[B, T, ...]`` → the stacked shards ``[world, B, T/world, ...]``."""
    B, T = x.shape[:2]
    if T % world:
        raise ValueError(f"sequence length {T} does not divide by the axis size {world}")
    return x.reshape(B, world, T // world, *x.shape[2:]).transpose(0, 1)


def unshard_sequence(x: torch.Tensor) -> torch.Tensor:
    """The stacked shards ``[world, B, T_local, ...]`` → ``[B, T, ...]``."""
    world, B, Tl = x.shape[:3]
    return x.transpose(0, 1).reshape(B, world * Tl, *x.shape[3:])


def ring_attention(
    world: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_impl: str = "dense",
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Global view: ``q/k/v [B, T, H, D]`` with ``T`` divisible by
    ``world``; shards the sequence over a stacked axis of ``world`` ranks,
    runs the ring, returns ``[B, T, H, D]``.  (JAX takes a mesh where the
    port takes its size.)"""
    axis = Axis("ranks", world)
    out = ring_attention_shard(
        shard_sequence(q, world), shard_sequence(k, world), shard_sequence(v, world), axis,
        causal=causal, scale=scale, block_impl=block_impl, block_q=block_q, block_k=block_k,
    )
    return unshard_sequence(out)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Plain full attention in float32, the ring's oracle."""
    B, T, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (D**0.5)
    if causal:
        above = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
