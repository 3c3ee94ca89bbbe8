"""Tensor-parallel GPT-2 decode step with batching that leaves a slot's bits
alone (the port of :mod:`adapcc_tpu.serve.model`).

The serving plane's bar: a batched, head-sharded decode step emits **the
same bits** for a slot as the same request run alone through
:func:`adapcc_tpu_torch.models.gpt2_generate.generate`.  Three construction
rules buy that:

1. **The model's own code.**  The step applies the port's GPT-2 modules
   and helpers with the model's parameters (``wte``/``wpe``,
   ``_layer_norm``, ``_dense``, ``Block.mlp``, ``GPT2.head``), not a second
   implementation, in the decode branch's op order.

2. **Products a row at a time.**  A matrix product's row is not the same
   bits at every row count: the CPU's and the card's GEMM libraries pick
   their blocking, and so their summation order, by the product's shape
   (on the CPU a float32 ``Linear`` at M = 2 already differs from M = 1 in
   the last bit).  So every product that contracts the model width (the
   qkv, the attention projection, the MLP, the LM head) runs on each
   computed slot's ``[1, 1, C]`` row alone: the call a batch of one makes
   in ``generate``.  Elementwise ops, the LayerNorms and the softmax are
   row by row already and run batched, as does attention over the cache
   (:func:`~adapcc_tpu_torch.models.gpt2.decode_attention`, shared with
   the model's decode step: its contractions are products and sums whose
   order a row keeps at any batch).

3. **A re-association-free collective.**  Attention is head-sharded: rank
   ``r`` owns heads ``[r·Hl, (r+1)·Hl)`` and its slice of the KV cache,
   computes its heads' outputs and places them into a zero-padded ``[world,
   S, 1, d_model]`` partial.  The per-token combine is ONE
   :meth:`~adapcc_tpu_torch.comm.engine.CollectiveEngine.all_reduce` per
   layer whose sum has one addend that may be non-zero in each column
   (``x + 0 = x``): the size-adaptive algorithm selection and the dispatch
   trace apply to decode traffic, and the sum is exact.

Only the slots a step computes (``rows``) are written, sampled and drawn
from: each has its own ``torch.Generator``, and one step draws once from
each (a ``[1, vocab]`` uniform row, the shape of ``generate``'s draw for a
batch of one).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from adapcc_tpu_torch.models.gpt2 import GPT2, _dense, _layer_norm, decode_attention
from adapcc_tpu_torch.models.gpt2_generate import sample_token


def per_row(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """``fn`` on each row in ``rows`` of ``x`` as a batch of one (``x[r:r +
    1]``); the rows not in ``rows`` are zero.  A row's bits are those of
    ``fn`` on that row alone."""
    parts = torch.cat([fn(x[r : r + 1]) for r in rows])
    if len(rows) == x.shape[0] and list(rows) == list(range(x.shape[0])):
        return parts
    out = parts.new_zeros((x.shape[0], *parts.shape[1:]))
    return out.index_copy_(0, torch.tensor(list(rows), device=x.device), parts)


class TPDecodeModel:
    """Head-sharded one-token-per-step decode over a stacked world of
    ``world`` ranks, with the parameters of ``model`` (a port
    :class:`~adapcc_tpu_torch.models.gpt2.GPT2`) on its device.  Nothing
    here records a gradient."""

    def __init__(self, model: GPT2, world: int, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0) -> None:
        cfg = model.cfg
        if cfg.n_head % world:
            raise ValueError(f"n_head={cfg.n_head} must divide over the TP world {world}")
        if cfg.d_model % cfg.n_head:
            raise ValueError(f"d_model={cfg.d_model} must divide over n_head={cfg.n_head}")
        self.model = model
        self.cfg = cfg
        self.world = int(world)
        self.heads_local = cfg.n_head // world
        self.head_dim = cfg.d_model // cfg.n_head
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.device = model.wte.weight.device

    # -- per-step pieces -------------------------------------------------------

    @torch.no_grad()
    def embed(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """``tok [S, 1]``, ``pos [S]`` → ``x [S, 1, C]``: token plus
        per-slot position embeddings, as ``GPT2``'s decode step adds them."""
        m, dt = self.model, self.cfg.dtype
        return m.wte(tok).to(dt) + m.wpe(pos[:, None]).to(dt)

    @torch.no_grad()
    def attn_partial(self, layer: int, x: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                     pos: torch.Tensor, rows: Optional[Sequence[int]] = None) -> torch.Tensor:
        """One layer's pre-collective half: ln1 and qkv, each computed slot's
        key and value written into its pages (``[world, S, max_seq, Hl,
        hd]``, in place) at its own position, and the head-sharded
        attention; returns the zero-padded stacked partial ``[world, S, 1,
        C]`` ready for ``engine.all_reduce``."""
        cfg = self.cfg
        world, Hl, hd, dt = self.world, self.heads_local, self.head_dim, cfg.dtype
        S, C = x.shape[0], cfg.d_model
        rows = list(range(S)) if rows is None else list(rows)
        block = getattr(self.model, f"h{layer}")
        qkv = per_row(lambda r: _dense(block.attn.qkv, _layer_norm(block.ln1, r), dt), x, rows)
        q, k, v = qkv.split(C, dim=-1)

        def shard_heads(t: torch.Tensor) -> torch.Tensor:
            # [S, 1, C] → [world, S, 1, Hl, hd]: rank w's contiguous heads
            return t.reshape(S, 1, world, Hl, hd).movedim(2, 0)

        q_s = shard_heads(q)
        idx = torch.tensor(rows, device=x.device)
        at = pos[idx]
        k_pages[:, idx, at] = shard_heads(k)[:, idx, 0].to(dt)
        v_pages[:, idx, at] = shard_heads(v)[:, idx, 0].to(dt)
        valid = torch.arange(cfg.max_seq, device=x.device) <= pos[:, None]  # [S, max_seq]
        # head-major views: q [world, S, Hl, 1, hd], pages [world, S, Hl, max_seq, hd]
        out = decode_attention(q_s.movedim(2, 3), k_pages.movedim(2, 3), v_pages.movedim(2, 3),
                               valid[None, :, None, :], 1.0 / math.sqrt(hd), dt)
        out = out.reshape(world, S, 1, Hl * hd)
        # rank w's heads land at their concat offset; every other element is
        # an exact zero, so the allreduce's sum is a concatenation
        partial = torch.zeros((world, S, 1, C), dtype=dt, device=x.device)
        for w in range(world):
            partial[w, :, :, w * Hl * hd : (w + 1) * Hl * hd] = out[w]
        return partial

    @torch.no_grad()
    def post_attn(self, layer: int, x: torch.Tensor, attn_full: torch.Tensor,
                  rows: Optional[Sequence[int]] = None) -> torch.Tensor:
        """One layer's post-collective half: the attention projection of the
        combined head concat and the MLP, each with its residual add."""
        rows = list(range(x.shape[0])) if rows is None else list(rows)
        block = getattr(self.model, f"h{layer}")
        x = x + per_row(lambda r: block.attn._project(r, None), attn_full, rows)
        return x + per_row(block.mlp, x, rows)

    @torch.no_grad()
    def logits(self, x: torch.Tensor, rows: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``ln_f`` and the weight-tied head: ``[S, 1, vocab]`` float32."""
        rows = list(range(x.shape[0])) if rows is None else list(rows)
        m = self.model
        return per_row(lambda r: m.head(_layer_norm(m.ln_f, r)), x, rows)

    @torch.no_grad()
    def sample(self, logits: torch.Tensor, generators: Sequence[Optional[torch.Generator]],
               rows: Optional[Sequence[int]] = None) -> torch.Tensor:
        """One token for each slot in ``rows`` from its ``[1, vocab]`` row
        and its own generator (one draw each): ``[len(rows)]`` int64."""
        rows = list(range(logits.shape[0])) if rows is None else list(rows)
        return torch.cat([
            sample_token(logits[r : r + 1, 0], generators[r], self.temperature, self.top_k, self.top_p)
            for r in rows
        ])

    # -- one full decode step --------------------------------------------------

    @torch.no_grad()
    def decode_step(self, engine, cache_layers: List[Tuple[torch.Tensor, torch.Tensor]], tok: torch.Tensor,
                    pos: torch.Tensor, generators: Sequence[Optional[torch.Generator]],
                    rows: Optional[Sequence[int]] = None, algo: Optional[str] = "auto") -> torch.Tensor:
        """One token for every slot in ``rows`` (all when None): embed → per
        layer (attention partial → ``engine.all_reduce`` → projection and
        MLP) → logits → per-slot sample.  The pages are written in place;
        returns the sampled ``[len(rows)]`` tokens.  The per-layer allreduce
        is the only cross-rank exchange, traced as any collective."""
        rows = list(range(tok.shape[0])) if rows is None else list(rows)
        x = self.embed(tok, pos)
        for layer in range(self.cfg.n_layer):
            k_pages, v_pages = cache_layers[layer]
            partial = self.attn_partial(layer, x, k_pages, v_pages, pos, rows)
            full = engine.all_reduce(partial, algo=algo)
            x = self.post_attn(layer, x, full[0], rows)
        return self.sample(self.logits(x, rows), generators, rows)

    @property
    def collective_bytes(self) -> int:
        """Per-rank payload of one decode-step allreduce for one slot: times
        the slot count, the dispatch size the selector sees."""
        return self.cfg.d_model * torch.empty((), dtype=self.cfg.dtype).element_size()
