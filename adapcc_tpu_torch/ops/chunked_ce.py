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
matrix product, which stays ``torch.matmul``.  The vocabulary-parallel
(``chunked_softmax_xent_shard``) and sequence-parallel forms belong to the
parallel planes and are not ported yet.
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


class _ChunkedNLL(torch.autograd.Function):
    """Per-row negative log-likelihood of ``softmax(x @ w.T)`` at ``y``."""

    @staticmethod
    def forward(ctx, x, w, y, block: int, compute_dtype: torch.dtype):
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
        lse = torch.log(s) + m
        ctx.save_for_backward(x, w, y, lse)
        ctx.block, ctx.compute_dtype = block, compute_dtype
        return lse - t

    @staticmethod
    def backward(ctx, g):
        x, w, y, lse = ctx.saved_tensors
        block, cd = ctx.block, ctx.compute_dtype
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
        dw = torch.cat(dw)[:V]
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
