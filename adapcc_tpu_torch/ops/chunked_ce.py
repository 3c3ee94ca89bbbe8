"""Chunked (online-softmax) cross-entropy over the vocabulary.

The port of :mod:`adapcc_tpu.ops.chunked_ce`'s single-device forms.  The LM
head is the memory hog of GPT-2 training: ``logits = x @ wte.T`` is a
``[B, T, V]`` float32 tensor (512 MiB at 16 × 512 × 16384) that the loss
reads once and the backward reads again.  This loss never forms it: the
forward walks the vocabulary in blocks keeping the running ``(max,
sum of exp)`` of each row, the trick flash attention plays over keys, and
saves only the log-sum-exp; the backward recomputes each block's logits
from it.  Peak memory is one ``[N, block]`` tile instead of ``[N, V]``.

A vocabulary that is not a multiple of the block is zero-padded to one, and
the padded columns are set to ``-inf`` before the statistics, so they add
exactly nothing in either pass.

This is no Pallas kernel in the JAX package: each block is a plain large
matrix product, which stays ``torch.matmul``.

:func:`chunked_softmax_xent_shard` is the vocabulary-parallel form (the
embedding's rows sharded over a mesh axis, ``parallel/axis.py``): each rank
scans its shard, and the statistics merge across the axis with one maximum
and two sums of ``[N]`` vectors; only ``dx`` is summed in the backward.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _pad_blocks(w: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """``w [V, D]`` zero-padded to ``[V/block (rounded up), block, D]``."""
    V, D = w.shape
    pad = (-V) % block
    if pad:
        w = torch.cat([w, torch.zeros((pad, D), dtype=w.dtype, device=w.device)])
    return w.reshape((V + pad) // block, block, D), V


def _block_logits(x: torch.Tensor, w_blk: torch.Tensor, off: int, V: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """One block's logits ``[N, C]`` in float32, padded columns ``-inf``."""
    logits = (x.to(compute_dtype) @ w_blk.to(compute_dtype).T).float()
    C = logits.shape[-1]
    if off + C > V:
        logits[:, V - off:] = float("-inf")
    return logits


def _in_block(y: torch.Tensor, off: int, C: int, V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(local index clamped into the block, whether the target lies in
    it)`` for labels ``y``."""
    yb = y - off
    return yb.clamp(0, C - 1), (yb >= 0) & (yb < C) & (y >= 0) & (y < V)


def _stats_scan(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, block: int, compute_dtype: torch.dtype):
    """The online-softmax scan over ``w``'s vocabulary blocks: per row of
    ``x`` the running ``(max, sum of exp at the max, target logit)``, each
    ``[N]`` float32.  Labels outside ``[0, V)`` (another shard's) add no
    target logit."""
    N = x.shape[0]
    w_blocks, V = _pad_blocks(w, block)
    m = torch.full((N,), float("-inf"), dtype=torch.float32, device=x.device)
    s = torch.zeros((N,), dtype=torch.float32, device=x.device)
    t = torch.zeros((N,), dtype=torch.float32, device=x.device)
    for i, w_blk in enumerate(w_blocks):
        off = i * block
        logits = _block_logits(x, w_blk, off, V, compute_dtype)
        m_b = logits.max(dim=-1).values
        s_b = torch.exp(logits - m_b[:, None]).sum(dim=-1)
        m_new = torch.maximum(m, m_b)
        s = s * torch.exp(m - m_new) + s_b * torch.exp(m_b - m_new)
        m = m_new
        idx, hit = _in_block(y, off, logits.shape[-1], V)
        t = t + torch.where(hit, logits.gather(1, idx[:, None])[:, 0], 0.0)
    return m, s, t


def _bwd_scan(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
              block: int, cd: torch.dtype):
    """The backward scan: each block's logits again, against the (global)
    ``lse``; ``dlogits = (softmax − onehot)·g`` (``g`` a row's cotangent);
    returns float32 ``dx`` (this ``w``'s share) and ``dw``."""
    w_blocks, V = _pad_blocks(w, block)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = []
    for i, w_blk in enumerate(w_blocks):
        off = i * block
        logits = _block_logits(x, w_blk, off, V, cd)
        p = torch.exp(logits - lse[:, None])  # softmax columns; 0 at the pads
        C = logits.shape[-1]
        onehot = (((y - off)[:, None] == torch.arange(C, device=y.device)[None, :])
                  & ((y >= 0) & (y < V))[:, None]).float()
        dl = ((p - onehot) * g[:, None]).to(cd)
        dx = dx + (dl @ w_blk.to(cd)).float()
        dw.append((dl.T @ x.to(cd)).float())
    return dx, torch.cat(dw)[:V]


class _ChunkedNLL(torch.autograd.Function):
    """Per-row negative log-likelihood of ``softmax(x @ w.T)`` at ``y``."""

    @staticmethod
    def forward(ctx, x, w, y, block: int, compute_dtype: torch.dtype):
        m, s, t = _stats_scan(x, w, y, block, compute_dtype)
        lse = torch.log(s) + m
        ctx.save_for_backward(x, w, y, lse)
        ctx.block, ctx.compute_dtype = block, compute_dtype
        return lse - t

    @staticmethod
    def backward(ctx, g):
        x, w, y, lse = ctx.saved_tensors
        dx, dw = _bwd_scan(x, w, y, lse, g, ctx.block, ctx.compute_dtype)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def chunked_softmax_nll(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, block: int = 1024,
                        compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Per-row NLL ``[N]`` float32 of ``softmax(x @ w.T)`` at labels ``y``
    (``x [N, D]``, ``w [V, D]``, ``y [N]``), the products in
    ``compute_dtype``, the statistics in float32; one ``[N, block]`` tile
    at a time in both passes."""
    return _ChunkedNLL.apply(x, w, y, int(block), compute_dtype)


def chunked_softmax_xent(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, block: int = 1024,
                         compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(x @ w.T)`` against ``y``: equal to
    ``-mean(log_softmax(x @ w.T)[n, y[n]])``, never more than one
    ``[N, block]`` logit tile at once.  Any ``V``."""
    return chunked_softmax_nll(x, w, y, block, compute_dtype).mean()


def chunked_lm_loss(hidden: torch.Tensor, wte: torch.Tensor, tokens: torch.Tensor, block: int = 1024,
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Next-token LM loss from post-LayerNorm hiddens ``[B, T, D]``:
    positions ``:-1`` against targets ``1:``, the weight-tied head in
    ``compute_dtype``, no ``[B, T, V]`` tensor."""
    B, T, D = hidden.shape
    x = hidden[:, :-1].reshape(B * (T - 1), D)
    y = tokens[:, 1:].reshape(B * (T - 1)).long()
    return chunked_softmax_xent(x, wte, y, block, compute_dtype)


# -- vocab-parallel (tensor-parallel) variant ----------------------------------


class _ChunkedXentShard(torch.autograd.Function):
    """Mean cross-entropy with the vocabulary sharded over ``axis``."""

    @staticmethod
    def forward(ctx, x, w_shard, y, axis, block: int, compute_dtype: torch.dtype):
        from adapcc_tpu_torch.parallel.axis import pmax, psum

        w_rows = w_shard if axis.stacked else w_shard[None]  # [R, V_local, D]
        V_local = w_rows.shape[1]
        stats = [_stats_scan(x, w_r, y - me * V_local, block, compute_dtype)
                 for me, w_r in zip(axis.ranks(), w_rows)]
        m_r, s_r, t_r = (torch.stack(v) for v in zip(*stats))  # each [R, N]
        # a shard is never empty (V_local >= 1), so m_r > -inf and the
        # rescale is well defined
        m = pmax(_one_row(m_r, axis), axis)
        s = psum(_one_row(s_r * torch.exp(m_r - m), axis), axis)
        t = psum(_one_row(t_r, axis), axis)
        lse = torch.log(s) + m
        ctx.save_for_backward(x, w_shard, y, lse)
        ctx.axis, ctx.block, ctx.compute_dtype = axis, block, compute_dtype
        return (lse - t).mean()

    @staticmethod
    def backward(ctx, g):
        from adapcc_tpu_torch.parallel.axis import psum

        x, w_shard, y, lse = ctx.saved_tensors
        axis = ctx.axis
        w_rows = w_shard if axis.stacked else w_shard[None]
        V_local = w_rows.shape[1]
        g_rows = (g / x.shape[0]).expand(x.shape[0]).float()
        grads = [_bwd_scan(x, w_r, y - me * V_local, lse, g_rows, ctx.block, ctx.compute_dtype)
                 for me, w_r in zip(axis.ranks(), w_rows)]
        # x is replicated over the axis: its gradient sums the shards';
        # each shard's dw stays its own
        dx = psum(_one_row(torch.stack([d for d, _ in grads]), axis), axis)
        dw = torch.stack([d for _, d in grads]) if axis.stacked else grads[0][1]
        return dx.to(x.dtype), dw.to(w_shard.dtype), None, None, None, None


def _one_row(rows: torch.Tensor, axis) -> torch.Tensor:
    """``[R, ...]`` statistics as the axis's collectives take them: the
    stacked rows, or per rank the one row."""
    return rows if axis.stacked else rows[0]


def chunked_softmax_xent_shard(x: torch.Tensor, w_shard: torch.Tensor, y: torch.Tensor, axis,
                               block: int = 1024, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Vocabulary-parallel chunked cross-entropy over ``axis`` (JAX's
    ``axis_name``; :class:`~adapcc_tpu_torch.parallel.axis.Axis`).

    ``w_shard`` is this rank's contiguous ``[V/world, D]`` vocabulary rows
    (the Megatron ``wte`` layout; stacked, ``[world, V/world, D]``), ``x
    [N, D]`` and ``y [N]`` (global ids) replicated.  Each rank scans its
    shard; the ``(max, sum of exp)`` statistics and the target logit merge
    over the axis with one maximum and two sums of ``[N]`` vectors.  Returns
    the replicated loss; the backward sums ``dx`` over the axis and leaves
    each ``dw`` on its shard."""
    return _ChunkedXentShard.apply(x, w_shard, y.long(), axis, int(block), compute_dtype)
