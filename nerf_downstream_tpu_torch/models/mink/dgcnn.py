"""DGCNN: edge convolutions over dense kNN graphs (counterpart of
``nerf_downstream_tpu/models/mink/dgcnn.py``).

Dense [B, N, C] clouds; kNN by the matmul distance trick, edge features
(x_j - x_i, x_i), 1x1 convs as dense layers, flax's BatchNorm
(momentum 0.9, biased running variance, flax's one-pass statistics) over
every axis but the last.
The reference leaves all of it to XLA (no Pallas kernel), so the port
computes it in plain PyTorch:

- ``knn`` orders the negated distances with a stable descending sort, so
  that ties keep the lower index first, as ``lax.top_k`` does (a
  ``torch.topk`` makes no such promise);
- the neighbour rows are gathered by index from the flattened cloud (the
  reference's ``x[:, None].repeat(N, 1)`` would materialise [B, N, N, C]
  in eager PyTorch) with ``ops/scatter.gather_rows``, whose backward adds
  in a fixed order on the card and on the CPU;
- the max over the neighbours and over the points is ``amax``, whose
  gradient is shared among ties, as the reference's is.

Modules carry the reference's variable names (``conv1/Dense_0``,
``conv1/BatchNorm_0``, ``bn5``, ``linear1`` ...), so
``convert.point_flax_path`` maps the weights one to one. Dropout draws
from an explicit ``torch.Generator`` (``generator=`` of a train-mode
forward, which raises without one).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch.models.image import layers as image_layers
from nerf_downstream_tpu_torch.models.mink.fcnn import Dropout, Linear
from nerf_downstream_tpu_torch.models.mink.resnet import Dense
from nerf_downstream_tpu_torch.ops.scatter import gather_rows


class BatchNorm(image_layers.BatchNorm):
    """flax's ``nn.BatchNorm(momentum=0.9)`` over the last axis of an
    input of any rank: statistics over every other axis, computed as flax
    computes them (the mean and the mean square in one pass, the variance
    ``max(E[x^2] - E[x]^2, 0)``, then ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``), so that a training step's gradients round as the
    reference's do: these models stack many train-mode norms over small
    batches, which amplify the difference of a two-pass variance
    (PAConvDGCNN's step gradients sat 10x the reference's own one-ulp
    spread away with one). The 2D models and the FCNN heads keep the
    parent's cuDNN BatchNorm (two-pass statistics, within their parity
    tests' 1e-5): these statistics, written out as here, made a ResNet50
    2D step on the H100 2.7x longer on the device (16.6 to 44.8 ms,
    ``chip_smoke.py``'s ``cli_2d``)."""

    def forward(self, x):
        shape = x.shape
        x = image_layers.at_least_f32(x.reshape(-1, shape[-1]))
        if self.training:
            mean = x.mean(0)
            var = torch.clamp((x * x).mean(0) - mean * mean, min=0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean, alpha=1 - m)
                self.var.mul_(m).add_(var, alpha=1 - m)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(torch.promote_types(self.dtype, y.dtype)).reshape(shape)


def _leaky(x):
    return F.leaky_relu(x, 0.2)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [B, N, C] -> int64 indices [B, N, k] of each point's k nearest
    (itself included), nearest first, ties by the lower index."""
    with torch.no_grad():
        x = image_layers.at_least_f32(x)
        inner = -2 * torch.matmul(x, x.transpose(1, 2))
        xx = (x * x).sum(-1, keepdim=True)
        neg_dist = -xx - inner - xx.transpose(1, 2)
        order = torch.sort(neg_dist, dim=-1, descending=True, stable=True)
        return order.indices[..., :k]


def gather_neighbours(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, M, k] -> the rows x[b, idx[b, m, j]]
    [B, M, k, C], by index into the flattened cloud."""
    b, n, c = x.shape
    base = torch.arange(b, device=x.device)[:, None, None] * n
    return gather_rows(x.reshape(b * n, c), idx + base)


def get_graph_feature(x: torch.Tensor, k: int, idx=None) -> torch.Tensor:
    """[B, N, C] -> edge features [B, N, k, 2C] = (x_j - x_i, x_i)."""
    if idx is None:
        idx = knn(x, k)
    nbr = gather_neighbours(x, idx)
    center = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - center, center], -1)


class EdgeConv(nn.Module):
    """Dense (no bias), BatchNorm over [B, N, k, C], LeakyReLU 0.2, max
    over the k neighbours."""

    def __init__(self, in_channels: int, out_channels: int, k: int):
        super().__init__()
        self.k = k
        self.Dense_0 = Linear(2 * in_channels, out_channels)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(self, x):
        e = self.Dense_0(get_graph_feature(x, self.k))
        return torch.amax(_leaky(self.BatchNorm_0(e)), dim=2)


class DGCNN_cls(nn.Module):
    """Logits [B, output_channels] of dense clouds [B, N, in_channel]."""

    flax_paths = "point"  # convert.flax_layout
    uses_dropout = True

    def __init__(self, in_channel: int = 3, output_channels: int = 40,
                 k: int = 20, emb_dims: int = 1024, dropout: float = 0.5):
        super().__init__()
        self.out_channel = output_channels
        self.conv1 = EdgeConv(in_channel, 64, k)
        self.conv2 = EdgeConv(64, 64, k)
        self.conv3 = EdgeConv(64, 128, k)
        self.conv4 = EdgeConv(128, 256, k)
        self.conv5 = Linear(512, emb_dims)
        self.bn5 = BatchNorm(emb_dims)
        self.linear1 = Linear(2 * emb_dims, 512)
        self.bn6 = BatchNorm(512)
        self.dropout1 = Dropout(dropout)
        self.linear2 = Dense(512, 256)
        self.bn7 = BatchNorm(256)
        self.dropout2 = Dropout(dropout)
        self.linear3 = Dense(256, output_channels)

    def forward(self, x, generator: torch.Generator | None = None):
        check_generator(self, generator)
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        x4 = self.conv4(x3)
        y = _leaky(self.bn5(self.conv5(torch.cat([x1, x2, x3, x4], -1))))
        z = torch.cat([torch.amax(y, dim=1), y.mean(1)], -1)
        z = _leaky(self.bn6(self.linear1(z)))
        if self.training:
            z = self.dropout1(z, generator)
        z = _leaky(self.bn7(self.linear2(z)))
        if self.training:
            z = self.dropout2(z, generator)
        return self.linear3(z)


class DGCNN_semseg(nn.Module):
    """Per-point logits [B, N, output_channels]."""

    flax_paths = "point"  # convert.flax_layout
    uses_dropout = True

    def __init__(self, in_channel: int = 3, output_channels: int = 13,
                 k: int = 20, emb_dims: int = 1024, dropout: float = 0.5):
        super().__init__()
        self.out_channel = output_channels
        self.conv1 = EdgeConv(in_channel, 64, k)
        for i in range(2, 6):
            setattr(self, f"conv{i}", EdgeConv(64, 64, k))
        self.conv6 = Linear(192, emb_dims)
        self.bn6 = BatchNorm(emb_dims)
        self.conv7 = Linear(emb_dims + 192, 512)
        self.conv7_bn = BatchNorm(512)
        self.conv8 = Linear(512, 256)
        self.conv8_bn = BatchNorm(256)
        self.dropout = Dropout(dropout)
        self.conv9 = Dense(256, output_channels)

    def forward(self, x, generator: torch.Generator | None = None):
        check_generator(self, generator)
        x1 = self.conv2(self.conv1(x))
        x2 = self.conv4(self.conv3(x1))
        x3 = self.conv5(x2)
        cat = torch.cat([x1, x2, x3], -1)
        y = _leaky(self.bn6(self.conv6(cat)))
        g = torch.amax(y, dim=1, keepdim=True).expand(-1, x.shape[1], -1)
        z = torch.cat([g, x1, x2, x3], -1)
        z = _leaky(self.conv7_bn(self.conv7(z)))
        z = _leaky(self.conv8_bn(self.conv8(z)))
        if self.training:
            z = self.dropout(z, generator)
        return self.conv9(z)


def check_generator(model: nn.Module, generator) -> None:
    if model.training and generator is None:
        raise ValueError("a train-mode forward draws its dropout from an "
                         "explicit generator: pass generator=")


def make_dgcnn(name: str, in_channel: int, out_channel: int, **kwargs):
    kwargs.pop("num_batches", None)
    if name == "DGCNN_semseg":
        return DGCNN_semseg(in_channel, out_channel, **kwargs)
    return DGCNN_cls(in_channel, out_channel, **kwargs)
