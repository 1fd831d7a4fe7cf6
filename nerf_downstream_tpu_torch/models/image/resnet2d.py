"""2D ResNet/ResNeXt/WideResNet family (counterpart of
``nerf_downstream_tpu/models/image/resnet2d.py``), NCHW, built to flax's
semantics: flax's BatchNorm (``layers.BatchNorm``), the zero-initialised
last BN scale of every block, the 3x3/s2 max-pool with padding 1, and the
pooled features in f32. Modules carry the reference's names
(``conv1``, ``bn1``, ``layer<s>_<i>``, ``downsample_conv``,
``downsample_bn``), so ``convert.py`` maps them one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch.models.image.layers import BatchNorm, Conv2d


class BasicBlock2D(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32, **_):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(planes, zero_scale=True, dtype=dtype)
        self.has_downsample = cin != planes or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, planes, 1, stride, dtype=dtype)
            self.downsample_bn = BatchNorm(planes, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class Bottleneck2D(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64, dtype=torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(cin, width, 1, dtype=dtype)
        self.bn1 = BatchNorm(width, dtype=dtype)
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups, dtype=dtype)
        self.bn2 = BatchNorm(width, dtype=dtype)
        self.conv3 = Conv2d(width, out_ch, 1, dtype=dtype)
        self.bn3 = BatchNorm(out_ch, zero_scale=True, dtype=dtype)
        self.has_downsample = cin != out_ch or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, out_ch, 1, stride, dtype=dtype)
            self.downsample_bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet2D(nn.Module):
    """Backbone from NCHW images to pooled features [B, C] in f32."""

    def __init__(self, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2), groups: int = 1,
                 base_width: int = 64, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        cls = BasicBlock2D if block == "basic" else Bottleneck2D
        self.blocks = []
        cin = 64
        for stage, (p, n) in enumerate(zip((64, 128, 256, 512), layers)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, cls(cin, p, stride, groups=groups,
                                          base_width=base_width, dtype=dtype))
                self.blocks.append(name)
                cin = p * cls.expansion
        self.out_channels = cin

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))


RESNET_SPECS = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3)),
    "resnet152": dict(block="bottleneck", layers=(3, 8, 36, 3)),
    "resnext50_32x4d": dict(
        block="bottleneck", layers=(3, 4, 6, 3), groups=32, base_width=4
    ),
    "resnext101_32x8d": dict(
        block="bottleneck", layers=(3, 4, 23, 3), groups=32, base_width=8
    ),
    "wide_resnet50_2": dict(
        block="bottleneck", layers=(3, 4, 6, 3), base_width=128
    ),
    "wide_resnet101_2": dict(
        block="bottleneck", layers=(3, 4, 23, 3), base_width=128
    ),
}
