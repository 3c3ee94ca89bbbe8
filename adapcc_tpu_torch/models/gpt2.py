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
  :mod:`adapcc_tpu_torch.ops.flash_attention`;
- logits are ``x.to(dtype) @ wte.T`` and come out float32.

Parameters keep the flax names (``h{i}.attn.qkv``, ``ln_f``, ...), so
:mod:`adapcc_tpu_torch.models.convert` maps a flax tree onto them.  Decode
with a KV cache, sequence parallelism, remat and dropout are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.ops.flash_attention import flash_attention

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

    def __post_init__(self) -> None:
        if self.attention not in ("xla", "flash"):
            raise ValueError(f"attention {self.attention!r} not in xla|flash")
        if self.d_model % self.n_head:
            raise ValueError(f"d_model {self.d_model} not divisible by n_head {self.n_head}")

    @staticmethod
    def tiny() -> "GPT2Config":
        """Test-sized config."""
        return GPT2Config(vocab_size=512, max_seq=64, n_layer=2, n_head=2, d_model=64)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: float32 in, float32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.d_model, 3 * cfg.d_model, device=device)
        self.proj = nn.Linear(cfg.d_model, cfg.d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, C = x.shape
        head_dim = C // cfg.n_head
        q, k, v = _dense(self.qkv, x, cfg.dtype).split(C, dim=-1)
        q = q.reshape(B, T, cfg.n_head, head_dim)
        k = k.reshape(B, T, cfg.n_head, head_dim)
        v = v.reshape(B, T, cfg.n_head, head_dim)
        scale = 1.0 / math.sqrt(head_dim)
        if cfg.attention == "flash":
            out = flash_attention(
                q, k, v, causal=True, scale=scale,
                block_q=cfg.flash_block, block_k=cfg.flash_block,
            )
        else:
            att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            above = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
            att = att.masked_fill(above, -1e30).softmax(dim=-1).to(cfg.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return _dense(self.proj, out.reshape(B, T, C), cfg.dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.attn(_layer_norm(self.ln1, x))
        h = F.gelu(_dense(self.fc, _layer_norm(self.ln2, x), dt), approximate="tanh")
        return x + _dense(self.proj, h, dt)


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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T = tokens.shape
        positions = torch.arange(T, device=tokens.device)
        x = self.wte(tokens).to(cfg.dtype) + self.wpe(positions).to(cfg.dtype)[None]
        for i in range(cfg.n_layer):
            x = getattr(self, f"h{i}")(x)
        x = _layer_norm(self.ln_f, x)
        # weight-tied LM head
        return (x.to(cfg.dtype) @ self.wte.weight.to(cfg.dtype).T).float()


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over a ``[B, T]`` batch."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()
