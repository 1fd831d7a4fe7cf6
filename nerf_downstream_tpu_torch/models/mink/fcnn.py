"""MinkowskiFCNN and MinkowskiSplatFCNN point-cloud classifiers
(counterpart of ``nerf_downstream_tpu/models/mink/fcnn.py``).

A point MLP (``mlp1``: linear, masked BatchNorm, LeakyReLU) on the point
field; voxelization; four conv blocks (``conv1`` k3/s1, ``conv2``-``conv4``
k3/s2; conv, masked BatchNorm, LeakyReLU), each followed by a k3/s2 max
pooling (``pool1``-``pool4``), at strides 2, 8, 32 and 128; each pooled
level sliced back onto the points and the four concatenated; a second
voxelization of that field; three k3/s2 conv blocks (``conv5a``-
``conv5c``, to a quarter, half and all of ``embedding_channel``); a global
max and average pool per scene; the head: ``head1`` (linear, no bias),
flax BatchNorm (``head1_bn``, momentum 0.9), LeakyReLU, dropout 0.5,
``head2`` (the same, without the dropout) and ``final`` (linear). The
splat variant replaces the voxelizations' quantization by a trilinear
splat onto the points' floor voxels and the slicing by trilinear
interpolation (``ops/interpolate.py``).

Every sparse conv takes the route its context gives it; ModelNet40's
config binds no grid extent, so all of them take the row path (kernel
maps by sort and search, K6). The model builds a ``CoordinateContext``
for each forward with its ``num_batches`` and the knobs in ``ctx``; the
gin configuration binds the rest, as in the reference.
``assume_unique`` is the voxelizations' one-point-per-voxel declaration
(None leaves it to the ``field_to_sparse.assume_unique`` binding).

Dropout draws from an explicit ``torch.Generator``: a forward in train
mode takes ``generator`` (the training task seeds one from the step
count) and raises without one; eval mode draws nothing. Modules carry
the reference's names, so ``convert.fcnn_flax_path`` maps the weights
both ways.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch.models.image.layers import BatchNorm
from nerf_downstream_tpu_torch.models.mink.layers import (
    MaskedBatchNorm,
    SparseConv,
    SparsePool,
)
from nerf_downstream_tpu_torch.models.mink.resnet import Dense
from nerf_downstream_tpu_torch.ops.interpolate import interpolate, splat
from nerf_downstream_tpu_torch.ops.pool import global_pool
from nerf_downstream_tpu_torch.sparse import (
    CoordinateContext,
    field_to_sparse,
    slice_field,
    unique_coords,
)
from nerf_downstream_tpu_torch.sparse.types import PointField, SparseVoxels


def _leaky(x):
    return F.leaky_relu(x, 0.01)


class Linear(nn.Module):
    """``x @ kernel`` with flax's ``kernel [C_in, C_out]``, no bias
    (``nn.Dense(use_bias=False)``), in the wider of the input's type and
    the kernel's (f32 unless the model was cast to f64)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.promote_types(x.dtype, self.kernel.dtype)) \
            @ self.kernel


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: each entry kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, else 0; the draw comes
    from ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)


class PointMLPBlock(nn.Module):
    """Linear (no bias), masked BatchNorm, LeakyReLU on point (or row)
    features; padding rows count in no statistic."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.dense = Linear(in_channels, out_channels)
        self.norm = MaskedBatchNorm(out_channels)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor):
        f = self.dense(feats)
        rows = SparseVoxels(
            coords=torch.zeros((f.shape[0], 4), dtype=torch.int32,
                               device=f.device),
            feats=f, mask=mask, stride=1)
        return _leaky(self.norm(rows).feats)


class ConvBlock(nn.Module):
    """Sparse conv with bias, masked BatchNorm, LeakyReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.conv = SparseConv(cin, cout, kernel, stride, use_bias=True,
                               compute_dtype=compute_dtype)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, sv: SparseVoxels, ctx: CoordinateContext):
        sv = self.bn(self.conv(sv, ctx))
        return sv.replace(feats=_leaky(sv.feats))


class MinkowskiFCNN(nn.Module):
    """Logits [num_batches, out_channel] (f32) of a batch of point
    clouds; ``use_splat`` selects the splat variant."""

    flax_paths = "fcnn"  # convert.flax_layout
    uses_dropout = True

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int = 3,
        embedding_channel: int = 1024,
        channels: Sequence[int] = (32, 48, 64, 96, 128),
        num_batches: int = 1,
        compute_dtype: torch.dtype = torch.float32,
        use_splat: bool = False,
        ctx: dict | None = None,
        assume_unique: bool | None = None,
    ):
        super().__init__()
        ch = tuple(channels)
        self.out_channel = out_channel
        self.num_batches = num_batches
        self.channels = ch
        self.embedding_channel = embedding_channel
        self.use_splat = use_splat
        self.ctx_kwargs = dict(ctx or {})
        self.assume_unique = assume_unique
        k, cd, e = kernel_size, compute_dtype, embedding_channel
        self.mlp1 = PointMLPBlock(in_channel, ch[0])
        self.conv1 = ConvBlock(ch[0], ch[1], k, 1, cd)
        self.conv2 = ConvBlock(ch[1], ch[2], k, 2, cd)
        self.conv3 = ConvBlock(ch[2], ch[3], k, 2, cd)
        self.conv4 = ConvBlock(ch[3], ch[4], k, 2, cd)
        self.pools = nn.ModuleList(SparsePool(3, 2, "max") for _ in range(4))
        self.conv5a = ConvBlock(sum(ch[1:]), e // 4, 3, 2, cd)
        self.conv5b = ConvBlock(e // 4, e // 2, 3, 2, cd)
        self.conv5c = ConvBlock(e // 2, e, 3, 2, cd)
        self.head1 = Linear(2 * e, 512)
        self.head1_bn = BatchNorm(512)
        self.dropout = Dropout(0.5)
        self.head2 = Linear(512, 512)
        self.head2_bn = BatchNorm(512)
        self.final = Dense(512, out_channel)
        for name, mod in self.named_modules():
            if isinstance(mod, SparseConv):
                mod.path = name.replace(".", "_")

    def _voxelize(self, field: PointField) -> SparseVoxels:
        if self.assume_unique is None:
            return field_to_sparse(field)[0]
        return field_to_sparse(field, assume_unique=self.assume_unique)[0]

    def forward(self, field: PointField,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.training and generator is None:
            raise ValueError("a train-mode forward draws its dropout from "
                             "an explicit generator: pass generator=")
        ctx = CoordinateContext(**dict(dict(num_batches=self.num_batches),
                                       **self.ctx_kwargs))
        field1 = PointField(coords=field.coords,
                            feats=self.mlp1(field.feats, field.mask),
                            mask=field.mask)
        if self.use_splat:
            # each point splats onto the 8 corners of its floor voxel; the
            # voxel set is the points' floor voxels
            corners = torch.floor(field1.coords[:, 1:]).to(torch.int32)
            coords = torch.cat(
                [field1.coords[:, :1].to(torch.int32), corners], 1)
            uc, um, _ = unique_coords(coords, field1.mask)
            y = SparseVoxels(coords=uc, feats=splat(field1, uc, um, 1),
                             mask=um, stride=1)
        else:
            y = self._voxelize(field1)
        levels = []
        for conv, pool in zip((self.conv1, self.conv2, self.conv3,
                               self.conv4), self.pools):
            y = pool(conv(y, ctx), ctx)
            levels.append(y)
        if self.use_splat:
            xs = [interpolate(t.coords, t.mask, t.feats, t.stride, field1)
                  for t in levels]
        else:
            xs = [slice_field(t, field1).feats for t in levels]
        y = self._voxelize(PointField(coords=field1.coords,
                                      feats=torch.cat(xs, 1),
                                      mask=field1.mask))
        for block in (self.conv5a, self.conv5b, self.conv5c):
            y = block(y, ctx)
        bid = y.batch_ids(self.num_batches)
        feats = y.masked_feats()
        x = torch.cat([global_pool(feats, bid, self.num_batches, "max"),
                       global_pool(feats, bid, self.num_batches, "avg")], 1)
        x = _leaky(self.head1_bn(self.head1(x)))
        if self.training:
            x = self.dropout(x, generator)
        x = _leaky(self.head2_bn(self.head2(x)))
        return self.final(x)


def make_fcnn(name: str, in_channel: int, out_channel: int,
              **kwargs) -> MinkowskiFCNN:
    return MinkowskiFCNN(in_channel, out_channel,
                         use_splat=(name == "MinkowskiSplatFCNN"), **kwargs)
