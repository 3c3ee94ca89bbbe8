"""ResNet: the reference's headline image-classification architecture, the
port of :mod:`adapcc_tpu.models.resnet`.

Inputs are ``[B, H, W, C]`` images as the JAX package takes them; the
convolutions run on the NCHW view of them (channels-last in memory).
Module and parameter names follow the flax tree (``stem_conv``,
``BasicBlock_0``, ``Conv_0``, ``_AutoGroupNorm_0.GroupNorm_0``,
``BatchNorm_0``, ``shortcut_conv``, ``Dense_0``), so
:func:`~adapcc_tpu_torch.models.convert.flax_to_state_dict` carries a flax
tree across by name.

What flax does and the port repeats:

- ``padding="SAME"`` pads ``total = max((ceil(in/s) - 1)·s + k - in, 0)``
  as ``(total // 2, total - total // 2)``: a 3x3 conv at stride 2 on an even
  input pads (0, 1), not torch's (1, 1), so such a conv pads explicitly and
  then convolves unpadded;
- ``nn.Conv`` / ``nn.Dense`` in ``dtype`` cast input, kernel and bias to it
  and add the bias after the product, in ``dtype``;
- ``GroupNorm`` (epsilon 1e-6, the largest group count up to 32 that
  divides the channels) and ``BatchNorm`` (epsilon 1e-5) take their
  statistics in float32 as ``E[x²] − E[x]²`` clipped at 0, normalize in
  float32 as ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` and round the
  result to ``dtype``;
- ``BatchNorm(momentum=0.9)`` (torch's momentum 0.1) updates its running
  mean and its running **biased** variance (``F.batch_norm`` would take the
  unbiased one), so the port writes the update itself; with a process
  ``group`` the per-channel mean and mean of squares are averaged over it
  (SyncBN, JAX's ``pmean`` over ``axis_name``), stacked into one all-reduce.
  The running statistics are the module's buffers ``mean`` and ``var``
  (flax's ``batch_stats``), which ``DDPTrainer`` carries as
  ``TrainState.model_state``.

``ResNet.train()`` selects batch statistics (JAX's ``train=True``);
``eval()`` the running ones.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.models.mlp import lecun_normal_

GROUP_NORM_EPS = 1e-6
BATCH_NORM_EPS = 1e-5
#: flax's BatchNorm momentum: the running statistics keep this share
BATCH_NORM_MOMENTUM = 0.9


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's ``padding="SAME"`` for one spatial dim: ``(low, high)``."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on an NCHW tensor: ``padding`` is ``"SAME"``,
    ``"VALID"`` or explicit ``((lo, hi), (lo, hi))``; input, kernel and bias
    in ``dtype``, the bias added after the convolution."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: Any = "SAME", bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias, device=device)
        self.pad_spec = padding
        self.dtype = dtype

    def _pads(self, x: torch.Tensor) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        if self.pad_spec == "VALID":
            return (0, 0), (0, 0)
        if self.pad_spec == "SAME":
            k, s = self.kernel_size[0], self.stride[0]
            return same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
        return tuple(self.pad_spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        (top, bottom), (left, right) = self._pads(x)
        x = x.to(dt)
        if x.device.type == "cpu":
            # torch's CPU backward of a strided 1x1 conv aborts on a
            # channels-last input (torch 2.13); the card's takes it as is
            x = x.contiguous()
        if top == bottom and left == right:
            y = F.conv2d(x, self.weight.to(dt), None, self.stride, (top, left))
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight.to(dt), None, self.stride)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``, the bias added after the product."""
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y + lin.bias.to(dtype) if lin.bias is not None else y


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``_normalize`` on float32 statistics broadcastable to ``x``."""
    y = x.float() - mean
    return (y * (torch.rsqrt(var + eps) * scale) + bias).to(dtype)


def _channel(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel ``[C]`` vector broadcastable over an NCHW (or NC) tensor."""
    return t.view(-1, *([1] * (ndim - 2)))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over the channels of an NCHW tensor."""

    def __init__(self, channels: int, num_groups: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        g = x.float().reshape(B, self.num_groups, -1)
        mean = g.mean(-1)
        var = torch.clamp_min((g * g).mean(-1) - mean * mean, 0.0)
        gs = C // self.num_groups
        shape = (B, C) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(gs, 1).view(shape)
        var = var.repeat_interleave(gs, 1).view(shape)
        return _normalize(x, mean, var, _channel(self.weight, x.dim()), _channel(self.bias, x.dim()),
                          GROUP_NORM_EPS, self.dtype)


class _AutoGroupNorm(nn.Module):
    """GroupNorm whose group count is the largest up to 32 that divides the
    channel count (JAX's ``_AutoGroupNorm``; flax nests the GroupNorm)."""

    def __init__(self, channels: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        groups = next(g for g in range(min(32, channels), 0, -1) if channels % g == 0)
        self.GroupNorm_0 = GroupNorm(channels, groups, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


class _SumMeans(torch.autograd.Function):
    """A SUM all-reduce over ``group`` whose backward sums the cotangents
    over the group too: the transpose of JAX's ``pmean`` inside the
    differentiated ``shard_map``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sync_mean(stats: torch.Tensor, group: Any) -> torch.Tensor:
    """``stats`` averaged over the process ``group`` (JAX's ``pmean``)."""
    world = dist.get_world_size(group)
    if world == 1:
        return stats
    return _SumMeans.apply(stats, group) / world


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NCHW tensor; with ``group``, SyncBN over that process group
    (``dist.group.WORLD`` for the whole world)."""

    def __init__(self, channels: int, dtype: torch.dtype, group: Any = None, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.group = group
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = x.dim()
        if not self.training:
            mean, var = self.mean, self.var
        else:
            dims = [0] + list(range(2, nd))
            xf = x.float()
            stats = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
            if self.group is not None:
                stats = sync_mean(stats, self.group)
            mean = stats[0]
            var = torch.clamp_min(stats[1] - mean * mean, 0.0)
            with torch.no_grad():
                m = BATCH_NORM_MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
                self.var.copy_(m * self.var + (1 - m) * var.detach())
        return _normalize(x, _channel(mean, nd), _channel(var, nd), _channel(self.weight, nd),
                          _channel(self.bias, nd), BATCH_NORM_EPS, self.dtype)


class _Norms:
    """Names and builds a block's norm layers as flax auto-names them."""

    def __init__(self, norm: str, dtype: torch.dtype, group: Any, device) -> None:
        if norm not in ("group", "batch"):
            raise ValueError(f"norm must be 'group' or 'batch', got {norm!r}")
        self.norm, self.dtype, self.group, self.device = norm, dtype, group, device

    def make(self, channels: int) -> nn.Module:
        if self.norm == "group":
            return _AutoGroupNorm(channels, self.dtype, device=self.device)
        return BatchNorm(channels, self.dtype, self.group, device=self.device)

    def name(self, i: int) -> str:
        return f"_AutoGroupNorm_{i}" if self.norm == "group" else f"BatchNorm_{i}"


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, features: int, norms: _Norms, stride: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride, bias=False, dtype=dtype, device=device)
        self.Conv_1 = Conv(features, features, 3, 1, bias=False, dtype=dtype, device=device)
        self.norm_names = [norms.name(0), norms.name(1)]
        for name in self.norm_names:
            self.add_module(name, norms.make(features))
        self.projects = stride != 1 or cin != features
        if self.projects:
            self.shortcut_conv = Conv(cin, features, 1, stride, bias=False, dtype=dtype, device=device)
            self.shortcut_norm = norms.make(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n0, n1 = (getattr(self, n) for n in self.norm_names)
        y = F.relu(n0(self.Conv_0(x)))
        y = n1(self.Conv_1(y))
        residual = self.shortcut_norm(self.shortcut_conv(x)) if self.projects else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1(x4) bottleneck (ResNet-50+), stride on the 3x3 (v1.5)."""

    expansion = 4

    def __init__(self, cin: int, features: int, norms: _Norms, stride: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.Conv_0 = Conv(cin, features, 1, 1, bias=False, dtype=dtype, device=device)
        self.Conv_1 = Conv(features, features, 3, stride, bias=False, dtype=dtype, device=device)
        self.Conv_2 = Conv(features, features * 4, 1, 1, bias=False, dtype=dtype, device=device)
        self.norm_names = [norms.name(i) for i in range(3)]
        for name, c in zip(self.norm_names, (features, features, features * 4)):
            self.add_module(name, norms.make(c))
        self.projects = stride != 1 or cin != features * 4
        if self.projects:
            self.shortcut_conv = Conv(cin, features * 4, 1, stride, bias=False, dtype=dtype, device=device)
            self.shortcut_norm = norms.make(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n0, n1, n2 = (getattr(self, n) for n in self.norm_names)
        y = F.relu(n0(self.Conv_0(x)))
        y = F.relu(n1(self.Conv_1(y)))
        y = n2(self.Conv_2(y))
        residual = self.shortcut_norm(self.shortcut_conv(x)) if self.projects else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Configurable ResNet over ``[B, H, W, C]`` images → logits ``[B,
    num_classes]`` float32.  ``small_inputs=True`` is the 3x3/1 stem
    without the max pool (the CIFAR-style variant); otherwise the ImageNet
    7x7/2 stem and 3x3/2 max pool.  ``group`` is SyncBN's process group
    under ``norm="batch"``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type = BasicBlock, num_classes: int = 1000,
                 width: int = 64, norm: str = "group", group: Any = None, dtype: torch.dtype = torch.bfloat16,
                 small_inputs: bool = False, in_channels: int = 3, device: DeviceLike = None,
                 seed: Optional[int] = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.small_inputs = small_inputs
        self.norm = norm
        norms = _Norms(norm, dtype, group, dev)
        if small_inputs:
            self.stem_conv = Conv(in_channels, width, 3, 1, bias=False, dtype=dtype, device=dev)
        else:
            self.stem_conv = Conv(in_channels, width, 7, 2, padding=((3, 3), (3, 3)), bias=False, dtype=dtype,
                                  device=dev)
        self.stem_norm = norms.make(width)
        self.block_names: List[str] = []
        cin = width
        k = 0
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                features = width * 2 ** stage
                name = f"{block_cls.__name__}_{k}"
                self.add_module(name, block_cls(cin, features, norms, stride, dtype, device=dev))
                self.block_names.append(name)
                cin = features * block_cls.expansion
                k += 1
        self.Dense_0 = nn.Linear(cin, num_classes, device=dev)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Convs and the head N(0, 1/fan_in) from ``seed`` (flax's lecun
        normal, untruncated), biases 0, norm scales 1."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                lecun_normal_(mod, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        if not self.small_inputs:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.Dense_0.weight.float(), self.Dense_0.bias.float())


def ResNet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def ResNet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, **kw)
