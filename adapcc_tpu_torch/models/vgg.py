"""VGG: the reference's default DDP benchmark model (train_ddp.py:33
VGG16), the port of :mod:`adapcc_tpu.models.vgg`.

Inputs are ``[B, H, W, C]`` images as the JAX package takes them; the
convolutions run on their NCHW view.  Before the classifier the features
are flattened in NHWC order, as JAX flattens them, so ``fc1``'s weight is
flax's ``fc1`` kernel transposed and nothing is permuted when converting.
Every 3x3 ``SAME`` conv here is at stride 1, whose padding is symmetric.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.models.mlp import lecun_normal_
from adapcc_tpu_torch.models.resnet import Conv, dense

# layer specs: int = conv channels, "M" = maxpool (VGG16 = D configuration)
VGG16_CFG: Tuple[Union[int, str], ...] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
    512, 512, 512, "M", 512, 512, 512, "M",
)
VGG11_CFG: Tuple[Union[int, str], ...] = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class VGG(nn.Module):
    """``x [B, H, W, C]`` → logits ``[B, num_classes]`` float32; convs
    ``conv_{i}`` (``i`` the spec's index), ``fc1``, ``fc2`` in ``dtype``,
    the ``head`` in float32."""

    def __init__(self, cfg: Tuple[Union[int, str], ...] = VGG16_CFG, num_classes: int = 10,
                 classifier_width: int = 4096, dtype: torch.dtype = torch.bfloat16, image_size: int = 32,
                 in_channels: int = 3, device: DeviceLike = None, seed: Optional[int] = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = tuple(cfg)
        self.dtype = dtype
        cin, size = in_channels, image_size
        for i, spec in enumerate(self.cfg):
            if spec == "M":
                size //= 2
            else:
                self.add_module(f"conv_{i}", Conv(cin, int(spec), 3, 1, dtype=dtype, device=dev))
                cin = int(spec)
        self.fc1 = nn.Linear(cin * size * size, classifier_width, device=dev)
        self.fc2 = nn.Linear(classifier_width, classifier_width, device=dev)
        self.head = nn.Linear(classifier_width, num_classes, device=dev)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                lecun_normal_(mod, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i, spec in enumerate(self.cfg):
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(dense(self.fc1, x, self.dtype))
        x = F.relu(dense(self.fc2, x, self.dtype))
        return dense(self.head, x, torch.float32)


def VGG16(**kw) -> VGG:
    return VGG(cfg=VGG16_CFG, **kw)


def VGG11(**kw) -> VGG:
    return VGG(cfg=VGG11_CFG, **kw)
