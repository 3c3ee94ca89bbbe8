"""GPT-2: the flagship training workload, in PyTorch.

The port of :mod:`adapcc_tpu.models.gpt2`'s training path: a pre-LN GPT-2
with a weight-tied LM head and the GPT-2 initialization scheme (scaled
residual projections).  The numerics follow the flax model point by point:

- embeddings are looked up in ``cfg.dtype``;
- every LayerNorm computes in float32 with epsilon 1e-6 (flax's default);
- every Linear computes in ``cfg.dtype``;
- the MLP's GELU is the tanh approximation (flax ``nn.gelu``);
- ``attention="xla"`` is the materialized masked softmax (scores in
  ``cfg.dtype``, softmax in float32, probabilities back in ``cfg.dtype``),
  ``attention="flash"`` the blockwise kernels of
  :mod:`adapcc_tpu_torch.ops.flash_attention`, taken only at ``dropout ==
  0`` (as the JAX model routes);
- logits are ``x.to(dtype) @ wte.T`` and come out float32.

``dropout`` drops the embedding sum, the attention probabilities, and the
attention and MLP projections' outputs (flax ``nn.Dropout``: kept elements
scaled by ``1/(1-p)``), with masks drawn from an explicit
``torch.Generator`` (``forward(generator=)``, else the model's
``dropout_generator``, else torch's default one); ``deterministic`` (default:
``not self.training``) turns it off.  ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``, non-reentrant): ``remat_policy="full"``
recomputes everything, ``"dots"`` saves every matrix product's output and
``"dots_no_batch"`` those without a batch dimension (the Linear layers',
not attention's), as JAX's ``checkpoint_dots`` and
``dots_with_no_batch_dims_saveable``.  A block under dropout takes one seed
from the generator and draws its masks from it, so the recomputation draws
the same masks.  The flash kernels are not matrix products the policies
see: their forward runs again in the backward under every policy.

``forward(return_hidden=True)`` returns the post-``ln_f`` hiddens for the
chunked loss (:func:`lm_loss_chunked`).

Sequence parallelism (``sp_axis``, an
:class:`~adapcc_tpu_torch.parallel.axis.Axis`): the model runs on
sequence shards, positions offset by the shard's place on the axis, and
attention crosses shards through the ring or Ulysses programs
(``sp_impl``; ``attention="flash"`` runs their blocks on the flash
kernels).  Per rank, ``tokens`` are this rank's ``[B, T_local]``; stacked,
they are ``[world·B, T_local]``, rank ``r``'s rows at ``[r·B, (r+1)·B)``.
:func:`lm_loss_sp` and :func:`lm_loss_sp_chunked` are the losses;
:mod:`adapcc_tpu_torch.parallel.gpt2_sp` wraps the step.

Decode with a KV cache: ``forward(tokens [B, 1], decode=True, pos=t,
cache=c)`` runs one autoregressive step and returns ``(logits [B, 1, vocab],
cache)``.  The cache is explicit state (:class:`DecodeCache`, from
:meth:`GPT2.init_cache`): one ``(k, v)`` pair a layer, each ``[B, max_seq,
H, head_dim]`` in ``cfg.dtype``, written in place at its ``index``, which
the step advances.  The step keeps the JAX branch's op order (the new key
and value written at ``index``, the scores cast to float32 and scaled,
every row past ``index`` masked to ``-1e30``, the softmax, the
probabilities in ``cfg.dtype``, their mix of the values); ``pos`` drives
``wpe``.  Its two contractions over the cache are an elementwise product
and a sum (:func:`decode_attention`), not a batched GEMM: a GEMM's
summation order, and so a row's bits, changes with the number of rows and
heads in the call, on the CPU and on the card alike, and the serving plane
(:mod:`adapcc_tpu_torch.serve`) holds a slot's bits to a batch of one's.

Parameters keep the flax names (``h{i}.attn.qkv``, ``ln_f``, ...), so
:mod:`adapcc_tpu_torch.models.convert` maps a flax tree onto them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.ops.flash_attention import flash_attention

if TYPE_CHECKING:
    from adapcc_tpu_torch.parallel.axis import Axis

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    #: compute dtype of embeddings, Linear layers and attention
    dtype: torch.dtype = torch.bfloat16
    #: "xla" materializes [T, T] scores; "flash" runs the blockwise kernels
    attention: str = "xla"
    #: flash block edge (block_q == block_k); T must divide into it
    flash_block: int = 128
    #: dropout rate of the embeddings, attention probabilities and the
    #: attention and MLP outputs (flash runs only at 0)
    dropout: float = 0.0
    #: recompute each block in the backward
    remat: bool = False
    #: what the recomputation keeps: "full" nothing, "dots" every matrix
    #: product's output, "dots_no_batch" those without a batch dimension
    remat_policy: str = "full"
    #: sequence parallelism: the axis the sequence is sharded over (None:
    #: off).  Training only; needs dropout == 0
    sp_axis: Optional["Axis"] = None
    #: which program carries attention across shards: "ring" rotates K/V
    #: blocks (O(T_local) memory), "ulysses" trades sequence for heads with
    #: one all-to-all each way (needs n_head % world == 0)
    sp_impl: str = "ring"

    def __post_init__(self) -> None:
        if self.attention not in ("xla", "flash"):
            raise ValueError(f"attention {self.attention!r} not in xla|flash")
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} not in {sorted(REMAT_POLICIES)}")
        if self.d_model % self.n_head:
            raise ValueError(f"d_model {self.d_model} not divisible by n_head {self.n_head}")

    @staticmethod
    def tiny() -> "GPT2Config":
        """Test-sized config."""
        return GPT2Config(vocab_size=512, max_seq=64, n_layer=2, n_head=2, d_model=64)


#: matrix products with and without a batch dimension, as the dispatcher
#: sees them (a Linear layer is mm/addmm on a 2-D view; einsum's attention
#: products are bmm)
_DOTS_NO_BATCH = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_DOTS = _DOTS_NO_BATCH + (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)

#: remat policy → the ops whose outputs the recomputation keeps (None: none)
REMAT_POLICIES = {"full": None, "dots": _DOTS, "dots_no_batch": _DOTS_NO_BATCH}


def _remat_context(policy: str):
    """``torch.utils.checkpoint``'s ``context_fn`` for a policy that keeps
    ``REMAT_POLICIES[policy]``'s outputs."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = REMAT_POLICIES[policy]

    def decide(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(decide)


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - p``,
    kept ones scaled by ``1/(1-p)``, the mask drawn from ``generator``."""
    if p == 0.0 or generator is None:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=generator.device) >= p
    return torch.where(keep.to(x.device), x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: float32 in, float32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, scale: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """One query row a head against its cached keys and values: ``q [...,
    1, hd]``, ``k``/``v [..., max_seq, hd]``, ``valid`` broadcastable to
    ``[..., max_seq]`` → ``[..., hd]``.  The scores are ``q·k`` cast to
    float32 and scaled, the invalid rows ``-1e30``, the softmax's
    probabilities in ``dtype`` mix the values.  Each contraction is an
    elementwise product and a sum over its last axis (the innermost of the
    product for the scores, the cache row for the mix): the reduction's
    order per output does not depend on how many slots or heads share the
    call."""
    att = (q * k).sum(dim=-1).float() * scale
    att = att.masked_fill(~valid, -1e30).softmax(dim=-1).to(dtype)
    return (att.unsqueeze(-1) * v).sum(dim=-2)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.d_model, 3 * cfg.d_model, device=device)
        self.proj = nn.Linear(cfg.d_model, cfg.d_model, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        B, T, C = x.shape
        head_dim = C // cfg.n_head
        q, k, v = _dense(self.qkv, x, cfg.dtype).split(C, dim=-1)
        q = q.reshape(B, T, cfg.n_head, head_dim)
        k = k.reshape(B, T, cfg.n_head, head_dim)
        v = v.reshape(B, T, cfg.n_head, head_dim)
        scale = 1.0 / math.sqrt(head_dim)
        if cfg.sp_axis is not None:
            return self._project(self._sp_attention(q, k, v, scale).reshape(B, T, C), generator)
        if cfg.attention == "flash" and cfg.dropout == 0.0:
            out = flash_attention(
                q, k, v, causal=True, scale=scale,
                block_q=cfg.flash_block, block_k=cfg.flash_block,
            )
        else:
            att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            above = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
            att = att.masked_fill(above, -1e30).softmax(dim=-1).to(cfg.dtype)
            att = _dropout(att, cfg.dropout, generator)
            out = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return self._project(out.reshape(B, T, C), generator)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, idx: int) -> torch.Tensor:
        """One token against the layer's cache (``[B, max_seq, H, hd]``,
        written in place at row ``idx``); attention sees rows ``<= idx``."""
        cfg = self.cfg
        B, T, C = x.shape
        head_dim = C // cfg.n_head
        q, k, v = _dense(self.qkv, x, cfg.dtype).split(C, dim=-1)
        q = q.reshape(B, T, cfg.n_head, head_dim)
        k_cache[:, idx] = k.reshape(B, cfg.n_head, head_dim).to(cfg.dtype)
        v_cache[:, idx] = v.reshape(B, cfg.n_head, head_dim).to(cfg.dtype)
        valid = torch.arange(cfg.max_seq, device=x.device) <= idx
        # head-major views: q [B, H, 1, hd], the cache [B, H, max_seq, hd]
        out = decode_attention(q.movedim(1, 2), k_cache.movedim(1, 2), v_cache.movedim(1, 2), valid,
                               1.0 / math.sqrt(head_dim), cfg.dtype)
        return self._project(out.reshape(B, T, C), None)

    def _project(self, out: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return _dropout(_dense(self.proj, out, self.cfg.dtype), self.cfg.dropout, generator)

    def _sp_attention(self, q, k, v, scale: float) -> torch.Tensor:
        """Attention across the sequence shards (``[B, T_local, H, D]``
        per rank; stacked, the ``[world·B, ...]`` rows as ``[world, B,
        ...]``), through the ring or Ulysses program."""
        cfg = self.cfg
        if cfg.dropout != 0.0:
            raise ValueError("sequence parallelism requires dropout == 0")
        block_impl = "flash" if cfg.attention == "flash" else "dense"
        axis = cfg.sp_axis
        if axis.stacked:
            q, k, v = (x.view(axis.size, x.shape[0] // axis.size, *x.shape[1:]) for x in (q, k, v))
        if cfg.sp_impl == "ring":
            from adapcc_tpu_torch.parallel.ring_attention import ring_attention_shard as attend
        elif cfg.sp_impl == "ulysses":
            from adapcc_tpu_torch.parallel.ulysses import ulysses_attention_shard as attend
        else:
            raise ValueError(f"unknown sp_impl {cfg.sp_impl!r} (ring|ulysses)")
        out = attend(q, k, v, axis, causal=True, scale=scale, block_impl=block_impl,
                     block_q=cfg.flash_block, block_k=cfg.flash_block)
        return out.reshape(-1, *out.shape[-3:]) if axis.stacked else out


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.fc = nn.Linear(d, 4 * d, device=device)
        self.proj = nn.Linear(4 * d, d, device=device)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """``seed``: this call's dropout masks come from a generator seeded
        with it (None: no dropout)."""
        dt = self.cfg.dtype
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        x = x + self.attn(_layer_norm(self.ln1, x), gen)
        return x + _dropout(self.mlp(x), self.cfg.dropout, gen)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP half's branch, before its residual add: ln2, fc, the tanh
        GELU and the projection."""
        dt = self.cfg.dtype
        return _dense(self.proj, F.gelu(_dense(self.fc, _layer_norm(self.ln2, x), dt), approximate="tanh"), dt)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, idx: int) -> torch.Tensor:
        """One decode step of the block against its layer's cache."""
        x = x + self.attn.decode(_layer_norm(self.ln1, x), k_cache, v_cache, idx)
        return x + self.mlp(x)


@dataclass
class DecodeCache:
    """The decode step's KV cache: per layer ``(k, v)``, each ``[B,
    max_seq, n_head, head_dim]`` in ``cfg.dtype``, and the row the next
    step writes."""

    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    index: int = 0


class GPT2(nn.Module):
    """``tokens [B, T] int64`` → logits ``[B, T, vocab] float32``.

    Built on ``device`` (the CUDA card when None; raises without one) with
    float32 parameters drawn from ``seed``; ``.to(torch.bfloat16)`` gives
    the bf16-parameter configuration the headline bench trains.
    """

    def __init__(self, cfg: GPT2Config, device: DeviceLike = None, seed: Optional[int] = 0) -> None:
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, device=dev)
        self.wpe = nn.Embedding(cfg.max_seq, cfg.d_model, device=dev)
        for i in range(cfg.n_layer):
            self.add_module(f"h{i}", Block(cfg, device=dev))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=LN_EPS, device=dev)
        #: the dropout masks' generator when ``forward`` is given none
        self.dropout_generator: Optional[torch.Generator] = None
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """GPT-2 initialization, drawn on the CPU from ``seed`` (so a seed
        gives the same weights on every device): embeddings N(0, 0.02) and
        N(0, 0.01), Linear weights N(0, 1/fan_in) (flax's lecun normal,
        untruncated), residual projections N(0, 0.02/sqrt(2·n_layer)),
        biases 0, LayerNorm scale 1."""
        gen = torch.Generator().manual_seed(seed)
        resid_std = 0.02 / math.sqrt(2 * self.cfg.n_layer)

        def normal_(p: torch.Tensor, std: float) -> None:
            p.copy_(torch.randn(p.shape, generator=gen) * std)

        normal_(self.wte.weight, 0.02)
        normal_(self.wpe.weight, 0.01)
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                std = resid_std if name.endswith("proj") else 1.0 / math.sqrt(mod.in_features)
                normal_(mod.weight, std)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def init_cache(self, batch: int) -> DecodeCache:
        """A zeroed :class:`DecodeCache` for ``batch`` rows on the model's
        device."""
        cfg = self.cfg
        shape = (batch, cfg.max_seq, cfg.n_head, cfg.d_model // cfg.n_head)
        dev = self.wte.weight.device
        return DecodeCache([(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                             torch.zeros(shape, dtype=cfg.dtype, device=dev)) for _ in range(cfg.n_layer)])

    def forward(self, tokens: torch.Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None, return_hidden: bool = False,
                decode: bool = False, pos: Union[int, torch.Tensor, None] = None,
                cache: Optional[DecodeCache] = None):
        """``tokens [B, T]`` → logits ``[B, T, vocab]`` float32, or with
        ``return_hidden`` the post-``ln_f`` hiddens ``[B, T, d_model]``
        float32.  Dropout (``cfg.dropout > 0``) runs unless
        ``deterministic`` (default ``not self.training``), its masks from
        ``generator`` (else ``self.dropout_generator``, else torch's
        default generator for the model's device).

        ``decode=True`` runs one step (``T == 1``) at absolute position
        ``pos`` (required) against ``cache`` (a fresh one when None) and
        returns ``(logits, cache)``; it has no dropout and records no
        gradient (the cache is state written in place)."""
        cfg = self.cfg
        B, T = tokens.shape
        if decode:
            return self._decode(tokens, pos, cache)
        if deterministic is None:
            deterministic = not self.training
        gen = None
        if cfg.dropout > 0.0 and not deterministic:
            gen = generator if generator is not None else self.dropout_generator
            if gen is None:
                gen = torch.default_generator if tokens.device.type == "cpu" else \
                    torch.cuda.default_generators[tokens.device.index or 0]
        x = self.wte(tokens).to(cfg.dtype) + self._position_embedding(B, T, tokens.device)
        x = _dropout(x, cfg.dropout, gen)
        for i in range(cfg.n_layer):
            block = getattr(self, f"h{i}")
            # one seed a block, drawn before it runs: a recomputation draws
            # the same masks
            seed = None if gen is None else int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
            x = self._remat(block)(x, seed) if cfg.remat else block(x, seed)
        x = _layer_norm(self.ln_f, x)
        if return_hidden:
            return x
        return self.head(x)

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, pos: Union[int, torch.Tensor, None],
                cache: Optional[DecodeCache]) -> Tuple[torch.Tensor, DecodeCache]:
        cfg = self.cfg
        if pos is None:
            raise ValueError("decode=True needs pos (the fed token's absolute position)")
        B, T = tokens.shape
        if T != 1:
            raise ValueError(f"decode mode feeds one token at a time, got T={T}")
        if cache is None:
            cache = self.init_cache(B)
        positions = torch.as_tensor(pos, device=tokens.device).reshape(1)
        x = self.wte(tokens).to(cfg.dtype) + self.wpe(positions).to(cfg.dtype)[None]
        for i in range(cfg.n_layer):
            k_cache, v_cache = cache.layers[i]
            x = getattr(self, f"h{i}").decode(x, k_cache, v_cache, cache.index)
        cache.index += 1
        x = _layer_norm(self.ln_f, x)
        return self.head(x), cache

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The weight-tied LM head on post-``ln_f`` hiddens: ``x.to(dtype)
        @ wte.T`` in ``cfg.dtype``, out in float32."""
        dt = self.cfg.dtype
        return (x.to(dt) @ self.wte.weight.to(dt).T).float()

    def _position_embedding(self, B: int, T: int, device: torch.device) -> torch.Tensor:
        """``wpe`` at each row's positions, broadcastable to ``[B, T, C]``:
        ``[0, T)``, or under sequence parallelism the shard's global
        positions ``[r·T, (r+1)·T)`` (stacked: rank ``r``'s rows at
        ``[r·B/world, (r+1)·B/world)``)."""
        axis = self.cfg.sp_axis
        local = torch.arange(T, device=device)
        if axis is None:
            return self.wpe(local).to(self.cfg.dtype)[None]
        if axis.size * T > self.cfg.max_seq:
            raise ValueError(f"{axis.size} shards of {T} positions exceed max_seq {self.cfg.max_seq}")
        ranks = torch.tensor(list(axis.ranks()), device=device)
        pos = self.wpe(ranks[:, None] * T + local).to(self.cfg.dtype)  # [R, T, C]
        return pos if len(ranks) == 1 else pos.repeat_interleave(B // len(ranks), dim=0)

    def _remat(self, block: nn.Module) -> Callable:
        """``block`` under ``torch.utils.checkpoint`` with the config's
        policy."""
        from torch.utils.checkpoint import checkpoint

        kw = {} if self.cfg.remat_policy == "full" else {
            "context_fn": functools.partial(_remat_context, self.cfg.remat_policy)}
        return lambda x, seed: checkpoint(block, x, seed, use_reentrant=False, **kw)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over a ``[B, T]`` batch."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()


def lm_loss_chunked(model: GPT2, tokens: torch.Tensor, block: int = 1024, **forward_kw) -> torch.Tensor:
    """:func:`lm_loss` without the ``[B, T, vocab]`` logits: the model
    returns its post-``ln_f`` hiddens and the weight-tied head's product
    goes into the chunked online-softmax loss
    (:mod:`adapcc_tpu_torch.ops.chunked_ce`), head in ``cfg.dtype``,
    softmax in float32.  The gradient reaches ``wte`` through the
    embedding and the head.  ``forward_kw`` go to the model's forward."""
    from adapcc_tpu_torch.ops.chunked_ce import chunked_lm_loss

    hidden = model(tokens, return_hidden=True, **forward_kw)
    return chunked_lm_loss(hidden, model.wte.weight, tokens, block, model.cfg.dtype)


def _sp_targets_and_mask(tokens: torch.Tensor, axis: "Axis") -> Tuple[torch.Tensor, torch.Tensor]:
    """Each local position's target is the next token; the shard's last
    position's target lives on the next rank and arrives by one ``[B]``
    ring shift (received from the right, the ring's convention).  The last
    rank's final position has no target and is masked out.  Returns
    ``(targets, valid)`` shaped like ``tokens`` (``valid`` float32)."""
    from adapcc_tpu_torch.parallel.axis import ring_shift

    ranks = axis.ranks()
    R = len(ranks)
    tok = tokens.view(R, -1, tokens.shape[-1])  # [R, B, Tl]
    next_first = ring_shift(tok[:, :, 0], axis)  # [R, B]
    targets = torch.cat([tok[:, :, 1:], next_first[:, :, None]], dim=2)
    valid = torch.ones(tok.shape, dtype=torch.float32, device=tokens.device)
    valid[[row for row, me in enumerate(ranks) if me == axis.size - 1], :, -1] = 0.0
    return targets.reshape(tokens.shape), valid.reshape(tokens.shape)


def _sp_masked_mean(nll: torch.Tensor, valid: torch.Tensor, axis: "Axis") -> torch.Tensor:
    """The mean of ``nll`` over the valid positions of every shard,
    replicated; each rank's gradient is that of its own positions' share
    (:func:`~adapcc_tpu_torch.parallel.axis.psum`), and the shares' sum is
    the unsharded mean's gradient."""
    from adapcc_tpu_torch.parallel.axis import psum

    total, count = (nll * valid.to(nll.dtype)).sum(), valid.sum()
    if not axis.stacked:
        total, count = psum(total, axis), psum(count.detach(), axis)
    return total / count


def lm_loss_sp(logits: torch.Tensor, tokens: torch.Tensor, axis: "Axis") -> torch.Tensor:
    """:func:`lm_loss` under sequence sharding over ``axis``: ``logits``
    and ``tokens`` are the shards' ``[B, T_local, V]`` / ``[B, T_local]``
    (stacked: every rank's rows).  Equal to :func:`lm_loss` on the
    unsharded batch."""
    targets, valid = _sp_targets_and_mask(tokens, axis)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return _sp_masked_mean(nll, valid, axis)


def lm_loss_sp_chunked(hidden: torch.Tensor, wte: torch.Tensor, tokens: torch.Tensor, axis: "Axis",
                       block: int = 1024, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`lm_loss_sp` without the ``[B, T_local, vocab]`` logits: the
    per-position NLL from the chunked online-softmax scan
    (:func:`~adapcc_tpu_torch.ops.chunked_ce.chunked_softmax_nll`) over
    the post-``ln_f`` hiddens and the tied embedding, the head in
    ``compute_dtype`` (default: the hiddens')."""
    from adapcc_tpu_torch.ops.chunked_ce import chunked_softmax_nll

    B, Tl, D = hidden.shape
    targets, valid = _sp_targets_and_mask(tokens, axis)
    nll = chunked_softmax_nll(hidden.reshape(B * Tl, D), wte, targets.reshape(B * Tl).long(), block,
                              compute_dtype or hidden.dtype).reshape(B, Tl)
    return _sp_masked_mean(nll, valid, axis)
