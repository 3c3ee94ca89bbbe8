"""Mixture-of-Experts MLP: top-k routing with static capacity.

The port of :mod:`adapcc_tpu.models.moe`.  The numerics follow the flax
module point by point:

- the router is a float32 dense layer on float32 tokens (``x @ Wᵀ + b``,
  the bias added after the product, as flax ``Dense`` adds it) and the
  softmax is float32;
- the auxiliary loss is the switch transformer's load-balancing term,
  ``E · Σ mean(probs) · mean(one_hot(argmax))``, plus, when
  ``router_z_coef`` is set, ST-MoE's router z-loss ``coef · mean(lse²)``;
- top-k dispatch with per-expert positional capacity ``ceil(cf · k · N /
  E)``: each of the k rounds takes every token's best remaining expert
  (``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does), its
  position in that expert's buffer, and keeps it below the capacity; a
  position past it is dropped (JAX's one-hot of an out-of-range index is
  zeros; ``F.one_hot`` raises, so the position is clamped and its weight
  is already zero);
- the experts are one-hot einsums over a stacked expert axis in
  ``cfg.dtype`` with the tanh GELU (flax ``nn.gelu``).

The parameters are ``router`` (a ``Linear``: flax's ``[D, E]`` kernel is its
``[E, D]`` weight, transposed) and the stacked ``w1 [E, D, H]``, ``w2 [E,
H, D]``; :func:`adapcc_tpu_torch.models.convert.moe_state_dict_from_flax`
carries flax parameters across.  No kernel lies on this path: the products
are torch matmuls, as JAX computes them outside any Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    d_model: int = 256
    d_hidden: int = 1024
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16
    #: ST-MoE router z-loss coefficient (0: off); the term rides inside the
    #: aux scalar, so its weight on the objective is this times the
    #: consumer's aux weight
    router_z_coef: float = 0.0

    @staticmethod
    def tiny() -> "MoEConfig":
        return MoEConfig(num_experts=4, d_model=32, d_hidden=64, top_k=2)


def router_logits(tokens: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=float32)``: ``x @ W + b`` in float32, the product
    first and the bias added after it."""
    return tokens.float() @ weight.float().t() + bias.float()


def switch_aux(probs: torch.Tensor, num_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean(probs), mean(one_hot(argmax(probs))))`` over the token
    dimension (the one before the last): the load-balancing loss's two
    factors."""
    me = probs.mean(-2)
    ce = F.one_hot(probs.argmax(-1), num_experts).float().mean(-2)
    return me, ce


def route(probs: torch.Tensor, top_k: int, capacity: int) -> torch.Tensor:
    """The float32 combine weights ``[..., n, E, C]`` of top-k positional
    dispatch over ``probs [..., n, E]`` (the module docstring); any leading
    dimensions route independently."""
    *lead, n, E = probs.shape
    combine = torch.zeros((*lead, n, E, capacity), dtype=torch.float32, device=probs.device)
    remaining = probs
    used = torch.zeros((*lead, E), dtype=torch.int64, device=probs.device)
    for _ in range(top_k):
        choice = remaining.argmax(-1)                                 # [..., n]
        prob = torch.gather(remaining, -1, choice[..., None])[..., 0]
        onehot = F.one_hot(choice, E)                                 # int64
        # position of each token within its chosen expert's buffer
        pos_in_expert = (onehot.cumsum(-2) - onehot) + used[..., None, :]
        pos = (onehot * pos_in_expert).sum(-1)                        # [..., n]
        keep = pos < capacity
        combine = combine + (
            (prob * keep)[..., None, None]
            * onehot.float()[..., :, None]
            * F.one_hot(pos.clamp(max=capacity - 1), capacity).float()[..., None, :]
        )
        used = used + (onehot * keep[..., None]).sum(-2)
        remaining = remaining * (1.0 - onehot.float())
    return combine


def experts_ffn(expert_in: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``gelu(x @ w1) @ w2`` for each expert of ``[..., e, c, d]``, in
    ``dtype``."""
    h = F.gelu(torch.einsum("...ecd,...edh->...ech", expert_in, w1.to(dtype)), approximate="tanh")
    return torch.einsum("...ech,...ehd->...ecd", h, w2.to(dtype))


class MoEMLP(nn.Module):
    """Top-k routed expert MLP (switch-style dispatch, static capacity).

    Built on ``device`` (the card when None; raises without one) with
    float32 parameters from ``seed``: the router's weight lecun-normal
    (flax ``Dense``'s default, untruncated), its bias zero, ``w1`` and
    ``w2`` N(0, 0.02)."""

    def __init__(self, cfg: MoEConfig, device: DeviceLike = None, seed: Optional[int] = 0) -> None:
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E, D, H = cfg.num_experts, cfg.d_model, cfg.d_hidden
        self.router = nn.Linear(D, E, device=dev)
        self.w1 = nn.Parameter(torch.empty(E, D, H, device=dev))
        self.w2 = nn.Parameter(torch.empty(E, H, D, device=dev))
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        D = self.cfg.d_model
        self.router.weight.copy_(torch.randn(self.router.weight.shape, generator=gen) / math.sqrt(D))
        self.router.bias.zero_()
        self.w1.copy_(torch.randn(self.w1.shape, generator=gen) * 0.02)
        self.w2.copy_(torch.randn(self.w2.shape, generator=gen) * 0.02)

    def capacity(self, n_tokens: int) -> int:
        cfg = self.cfg
        return int(np.ceil(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.num_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [B, T, D]`` → ``(y [B, T, D], aux_loss scalar)``."""
        cfg = self.cfg
        B, T, D = x.shape
        n_tokens = B * T
        capacity = self.capacity(n_tokens)
        tokens = x.reshape(n_tokens, D)

        gate_logits = router_logits(tokens, self.router.weight, self.router.bias)
        gate_probs = torch.softmax(gate_logits, dim=-1)

        me, ce = switch_aux(gate_probs, cfg.num_experts)
        aux_loss = cfg.num_experts * (me * ce).sum()
        if cfg.router_z_coef:
            z = torch.logsumexp(gate_logits, dim=-1)
            aux_loss = aux_loss + cfg.router_z_coef * (z ** 2).mean()

        combine = route(gate_probs, cfg.top_k, capacity)               # [N, E, C]
        dispatch = (combine > 0).to(cfg.dtype)
        expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens.to(cfg.dtype))
        expert_out = experts_ffn(expert_in, self.w1, self.w2, cfg.dtype)
        y = torch.einsum("nec,ecd->nd", combine.to(cfg.dtype), expert_out)
        return y.reshape(B, T, D).to(x.dtype), aux_loss


__all__ = ["MoEConfig", "MoEMLP", "experts_ffn", "route", "router_logits", "switch_aux"]
