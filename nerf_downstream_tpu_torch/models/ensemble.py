"""Fused 2D+3D ensemble classifier (counterpart of
``nerf_downstream_tpu/models/ensemble.py``): a 2D image backbone
(``models/image/resnet2d.py``) and a 3D sparse-voxel ResNet
(``models/mink/resnet.py``) over the same scene, fused by a learned
convex combination of their logits ("logit") or by a dense head over the
image features and the voxel logits ("feature").

Modules carry the reference's names (``image``, ``voxel``,
``image_head``, ``head``, ``fusion_alpha``), so ``convert.py`` maps the
flax trees both ways (``ensemble_flax_path``). The images come as the
reference's NHWC [B, H, W, 3] and go to the backbone as NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.models.image.resnet2d import (
    RESNET_SPECS,
    ResNet2D,
)
from nerf_downstream_tpu_torch.models.mink.resnet import (
    _VARIANTS,
    Dense,
    MinkResNetBase,
)
from nerf_downstream_tpu_torch.sparse.types import PointField


class Ensemble2D3D(nn.Module):
    """``in_channels`` is the voxel features' width (the reference infers
    it); ``ctx`` and ``assume_unique`` configure the voxel branch as they
    do ``MinkResNetBase`` (None: the gin binding of
    ``field_to_sparse.assume_unique``, as the reference's quantization
    reads it). Logits [num_batches, out_channel] in f32."""

    flax_paths = "ensemble"  # convert.flax_layout

    def __init__(self, in_channels: int = 27, out_channel: int = 51,
                 image_model: str = "resnet18",
                 voxel_model: str = "ResNet14", num_batches: int = 1,
                 fusion: str = "logit", bn_axis_name: str | None = None,
                 compute_dtype: torch.dtype = torch.float32,
                 ctx: dict | None = None, assume_unique: bool | None = None):
        super().__init__()
        if bn_axis_name is not None:
            raise NotImplementedError(
                "SyncBatchNorm (bn_axis_name) is not ported (ROADMAP.md "
                "Queue 1 item 4)")
        if fusion not in ("logit", "feature"):
            raise ValueError(f"unknown fusion {fusion!r}")
        self.out_channel = out_channel
        self.num_batches = num_batches
        self.fusion = fusion
        self.compute_dtype = compute_dtype
        self.image = ResNet2D(**RESNET_SPECS[image_model],
                              dtype=compute_dtype)
        block, layers = _VARIANTS[voxel_model]
        self.voxel = MinkResNetBase(
            in_channels, out_channel, block=block, layers=layers,
            num_batches=num_batches, compute_dtype=compute_dtype, ctx=ctx,
            assume_unique=assume_unique)
        feats = self.image.out_channels
        if fusion == "feature":
            self.head = Dense(feats + out_channel, out_channel)
        else:
            self.image_head = Dense(feats, out_channel)
            self.fusion_alpha = nn.Parameter(torch.zeros(()))

    def forward(self, images: torch.Tensor,
                field: PointField) -> torch.Tensor:
        img = self.image(images.permute(0, 3, 1, 2))
        vox = self.voxel(field)
        if self.fusion == "feature":
            return self.head(torch.cat([img, vox.to(img.dtype)], -1))
        mix = torch.sigmoid(self.fusion_alpha)
        return (1 - mix) * self.image_head(img) + mix * vox


@cfg.configurable("Ensemble2D3D")
def make_ensemble(out_channel: int = 51, image_model: str = "resnet18",
                  voxel_model: str = "ResNet14", fusion: str = "logit",
                  **kwargs) -> Ensemble2D3D:
    return Ensemble2D3D(out_channel=out_channel, image_model=image_model,
                        voxel_model=voxel_model, fusion=fusion, **kwargs)
