"""MinkowskiPointNet and the dense PointNet (counterpart of
``nerf_downstream_tpu/models/mink/pointnet.py``).

Per-point MLPs (dense, BatchNorm, ReLU) to 64, 64, 64, 128 and
``embedding_channel`` channels, a global max pool per cloud, then the head:
``linear1`` (no bias), flax's BatchNorm ``linear1_bn``, ReLU, dropout 0.5
and ``linear2``. ``MinkowskiPointNet`` runs on a ``PointField`` (rows of
every cloud of the batch, padding masked out) with the masked BatchNorm
(torch's momentum convention) in each block; ``PointNet`` on dense
[B, N, C] clouds with flax's BatchNorm. Modules carry the reference's
variable names (``conv1/Dense_0``, ``conv1/MaskedBatchNorm_0``; ``conv1``,
``bn1``); dropout draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch.models.mink.dgcnn import (
    BatchNorm,
    check_generator,
)
from nerf_downstream_tpu_torch.models.mink.fcnn import Dropout, Linear
from nerf_downstream_tpu_torch.models.mink.layers import MaskedBatchNorm
from nerf_downstream_tpu_torch.models.mink.resnet import Dense
from nerf_downstream_tpu_torch.ops.pool import global_pool
from nerf_downstream_tpu_torch.sparse.types import PointField, SparseVoxels

WIDTHS = (64, 64, 64, 128)


class PointBlock(nn.Module):
    """Dense (no bias), masked BatchNorm, ReLU on point rows."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.Dense_0 = Linear(in_channels, out_channels)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels)

    def forward(self, feats, mask):
        f = self.Dense_0(feats)
        rows = SparseVoxels(
            coords=torch.zeros((f.shape[0], 4), dtype=torch.int32,
                               device=f.device),
            feats=f, mask=mask, stride=1)
        return F.relu(self.MaskedBatchNorm_0(rows).feats)


class _Head(nn.Module):
    flax_paths = "point"  # convert.flax_layout
    uses_dropout = True

    def _head(self, x, generator):
        x = F.relu(self.linear1_bn(self.linear1(x)))
        if self.training:
            x = self.dropout(x, generator)
        return self.linear2(x)


class MinkowskiPointNet(_Head):
    """Logits [num_batches, out_channel] of a batch of point clouds."""

    def __init__(self, in_channel: int, out_channel: int,
                 embedding_channel: int = 1024, num_batches: int = 1):
        super().__init__()
        self.out_channel = out_channel
        self.num_batches = num_batches
        widths = (*WIDTHS, embedding_channel)
        for i, (cin, cout) in enumerate(zip((in_channel, *widths), widths)):
            setattr(self, f"conv{i + 1}", PointBlock(cin, cout))
        self.linear1 = Linear(embedding_channel, 512)
        self.linear1_bn = BatchNorm(512)
        self.dropout = Dropout(0.5)
        self.linear2 = Dense(512, out_channel)

    def forward(self, field: PointField,
                generator: torch.Generator | None = None):
        check_generator(self, generator)
        f, m = field.feats, field.mask
        for i in range(5):
            f = getattr(self, f"conv{i + 1}")(f, m)
        bid = torch.where(m, field.coords[:, 0].to(torch.int32),
                          self.num_batches)
        x = global_pool(torch.where(m[:, None], f, 0), bid,
                        self.num_batches, "max")
        return self._head(x, generator)


class PointNet(_Head):
    """Logits [B, out_channel] of dense clouds [B, N, in_channel]."""

    def __init__(self, in_channel: int, out_channel: int,
                 embedding_channel: int = 1024):
        super().__init__()
        self.out_channel = out_channel
        widths = (*WIDTHS, embedding_channel)
        for i, (cin, cout) in enumerate(zip((in_channel, *widths), widths)):
            setattr(self, f"conv{i + 1}", Linear(cin, cout))
            setattr(self, f"bn{i + 1}", BatchNorm(cout))
        self.linear1 = Linear(embedding_channel, 512)
        self.linear1_bn = BatchNorm(512)
        self.dropout = Dropout(0.5)
        self.linear2 = Dense(512, out_channel)

    def forward(self, x, generator: torch.Generator | None = None):
        check_generator(self, generator)
        for i in range(1, 6):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self._head(torch.amax(x, dim=1), generator)


def make_pointnet(name: str, in_channel: int, out_channel: int, **kwargs):
    if name == "PointNet":
        kwargs.pop("num_batches", None)
        return PointNet(in_channel, out_channel, **kwargs)
    return MinkowskiPointNet(in_channel, out_channel, **kwargs)
