"""2D model registry (counterpart of
``nerf_downstream_tpu/models/image/__init__.py``): ``ResNetBased``,
``ViTBased`` and ``select_model``, gin-configurable under the reference's
names. ``dtype`` is the compute type (the 2D CLI binds bf16 under
``run.precision = 16``); parameters stay f32.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.models.image.layers import Dense, init_weights
from nerf_downstream_tpu_torch.models.image.resnet2d import (
    RESNET_SPECS,
    ResNet2D,
)
from nerf_downstream_tpu_torch.models.image.vit import VIT_SPECS, ViT

__all__ = ["RESNET_LIST", "VIT_LIST", "ResNetBased", "ViTBased",
           "init_weights", "select_model"]

RESNET_LIST = list(RESNET_SPECS)
VIT_LIST = list(VIT_SPECS)


def dropout(x, rate: float, generator: torch.Generator | None):
    """flax's ``nn.Dropout``: keep each entry with probability 1 - rate
    and scale the kept ones by 1 / (1 - rate), the mask drawn from
    ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class _ResNetBased(nn.Module):
    """Backbone (``model``) -> Dropout(0.2) -> Linear(51) (``fc``, f32).
    In train mode the dropout mask comes from the ``generator`` passed to
    ``forward``."""

    flax_paths = "image"  # convert.flax_layout
    pretrained_submodule = "model"

    def __init__(self, model: str = "resnet18", dropout_rate: float = 0.2,
                 num_classes: int = 51, pretrained: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.arch, self.dropout_rate = model, dropout_rate
        self.pretrained, self.pretrained_arch = pretrained, model
        self.model = ResNet2D(**RESNET_SPECS[model], dtype=dtype)
        self.fc = Dense((self.model.out_channels,), (num_classes,))

    def forward(self, x, generator=None):
        feats = self.model(x)
        if self.training and self.dropout_rate > 0:
            feats = dropout(feats, self.dropout_rate, generator)
        return self.fc(feats)


@cfg.configurable("ResNetBased")
def ResNetBased(model: str = "resnet18", dropout_rate: float = 0.2,
                pretrained: bool = False, num_classes: int = 51,
                dtype=torch.float32, bn_axis_name: str | None = None):
    # pretrained weights come from the local converted store at state
    # creation (LitModel.create_state -> torch_weights.apply_pretrained)
    if bn_axis_name is not None:
        raise NotImplementedError(
            "SyncBatchNorm (bn_axis_name) is not ported (ROADMAP.md Queue 1 "
            "item 4)")
    return _ResNetBased(model=model, dropout_rate=dropout_rate,
                        num_classes=num_classes, pretrained=pretrained,
                        dtype=dtype)


@cfg.configurable("ViTBased")
def ViTBased(model: str = "vit_small_patch16_224", pretrained: bool = False,
             num_classes: int = 51, dtype=torch.float32,
             image_size: int = 224):
    return ViT(num_classes=num_classes, dtype=dtype, pretrained=pretrained,
               pretrained_arch=model, image_size=image_size,
               **VIT_SPECS[model])


def select_model(model_name: str, bn_axis_name: str | None = None):
    if model_name is None:
        raise NameError("model_name is required")
    if model_name in RESNET_LIST:
        return ResNetBased(model_name, bn_axis_name=bn_axis_name)
    if model_name in VIT_LIST:
        # ViTs carry no BatchNorm: nothing to sync
        return ViTBased(model_name)
    raise NameError(f"Unknown model name : {model_name}")
