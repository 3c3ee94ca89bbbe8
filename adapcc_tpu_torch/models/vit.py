"""ViT: the vision-transformer DDP workload (reference
models/vit/train_vit.py), the port of :mod:`adapcc_tpu.models.vit`.

Patch embed → encoder blocks → CLS head on ``[B, H, W, C]`` images.
Attention is flax's ``MultiHeadDotProductAttention`` written out: the query,
key and value projections, the query scaled by ``1/sqrt(head_dim)`` before
the product, a softmax and a product, all in ``cfg.dtype`` (JAX computes it
in XLA, not in a kernel, so the port does not route it through the flash
kernels).  Where JAX rounds to ``cfg.dtype`` the port rounds: each product's
output, the GELU (flax's ``nn.gelu``, the tanh approximation), the residual
sums; the LayerNorms are float32 in and out (flax's ``LayerNorm(dtype=
float32)``, epsilon 1e-6).  flax's ``DenseGeneral`` kernels ``query/key/
value [d, h, hd]`` and ``out [h, hd, d]`` are ``Linear`` weights ``[h·hd,
d]`` and ``[d, h·hd]`` here (:mod:`adapcc_tpu_torch.models.convert`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.models.mlp import lecun_normal_
from adapcc_tpu_torch.models.resnet import Conv, dense

LN_EPS = 1e-6


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 384
    n_layer: int = 12
    n_head: int = 6
    mlp_ratio: int = 4
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, num_classes=10, d_model=64, n_layer=2, n_head=2)


def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, LN_EPS)


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention block with ``query``, ``key``, ``value`` and
    ``out`` projections."""

    def __init__(self, d: int, n_head: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.n_head, self.dtype = n_head, dtype
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        h, dt = self.n_head, self.dtype
        hd = D // h
        q, k, v = (dense(lin, x, dt).view(B, N, h, hd) for lin in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(hd), dtype=dt)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(w.float(), dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, N, D)
        return dense(self.out, o, dt)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.LayerNorm_0 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.attn = MultiHeadDotProductAttention(d, cfg.n_head, cfg.dtype, device=device)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.Dense_0 = nn.Linear(d, cfg.mlp_ratio * d, device=device)
        self.Dense_1 = nn.Linear(cfg.mlp_ratio * d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.attn(_ln(self.LayerNorm_0, x))
        h = dense(self.Dense_0, _ln(self.LayerNorm_1, x), dt)
        h = F.gelu(h.float(), approximate="tanh").to(dt)
        h = dense(self.Dense_1, h, dt)
        if self.cfg.dropout > 0.0 and self.training:
            h = F.dropout(h, self.cfg.dropout)
        return x + h


class ViT(nn.Module):
    """``images [B, H, W, C]`` → logits ``[B, num_classes]`` float32."""

    def __init__(self, cfg: ViTConfig, in_channels: int = 3, device: DeviceLike = None,
                 seed: Optional[int] = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch_size
        n = (cfg.image_size // p) ** 2
        self.patch_embed = Conv(in_channels, d, p, p, dtype=cfg.dtype, device=dev)
        self.cls = nn.Parameter(torch.zeros(1, 1, d, device=dev))
        self.pos = nn.Parameter(torch.zeros(1, n + 1, d, device=dev))
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", EncoderBlock(cfg, device=dev))
        self.ln_f = nn.LayerNorm(d, eps=LN_EPS, device=dev)
        self.head = nn.Linear(d, cfg.num_classes, device=dev)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Products N(0, 1/fan_in) (lecun normal, untruncated), ``cls`` and
        ``pos`` N(0, 0.02), biases 0, LayerNorm scales 1."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                lecun_normal_(mod, gen)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for p in (self.cls, self.pos):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        B = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls.to(dt).expand(B, 1, cfg.d_model), x], dim=1)
        x = x + self.pos.to(dt)
        for i in range(cfg.n_layer):
            x = getattr(self, f"block_{i}")(x)
        x = _ln(self.ln_f, x)
        return F.linear(x[:, 0], self.head.weight, self.head.bias)
