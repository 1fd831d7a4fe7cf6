"""PAConv models: PAConvPointNet and PAConvDGCNN (counterpart of
``nerf_downstream_tpu/models/paconv/__init__.py``).

kNN on the coordinates, ScoreNet MLPs over (neighbour - center,
neighbour) giving each (point, neighbour) its scores over a bank of
``m`` weight matrices, the bank's matrix product, and the assign-score
assembly (``ops/paconv.py``). The bank ``matrice<i>`` is a parameter laid
out [Cin, m * Cout], the reference's (a [m, Cin, Cout] draw transposed;
``train.modules.init_variables`` draws it).
Every BatchNorm is flax's (momentum 0.9) over every axis but the last;
modules carry the reference's variable names. Dropout draws from an
explicit ``torch.Generator``.

``PAConvPointNet`` is gin-configurable under that name
(``paconv_pointnet``): ``get_model`` builds it through the factory, so
``PAConvPointNet.k = 8`` binds. (The reference registers the name too,
but its factory's ``__new__`` bypasses the ``__init__`` that the binding
wraps, so there the binding is accepted and has no effect; ROADMAP
Queue 3.)
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.models.mink.dgcnn import (
    BatchNorm,
    check_generator,
    gather_neighbours,
    knn,
)
from nerf_downstream_tpu_torch.models.mink.fcnn import Dropout, Linear
from nerf_downstream_tpu_torch.models.mink.resnet import Dense
from nerf_downstream_tpu_torch.ops.paconv import (
    assign_score_withk,
    assign_score_withk_halfkernel,
)


def get_scorenet_input(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, 3], idx [B, N, K] -> (neighbour - center, neighbour)
    [B, N, K, 6]."""
    nbr = gather_neighbours(x, idx)
    center = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - center, nbr], -1)


def feat_trans_pointnet(x: torch.Tensor, kernel: torch.Tensor,
                        m: int) -> torch.Tensor:
    """x [B, N, Cin] @ kernel [Cin, m * Cout] -> [B, N, m, Cout] (f32)."""
    b, n, _ = x.shape
    return (x.float() @ kernel).reshape(b, n, m, -1)


def feat_trans_dgcnn(x: torch.Tensor, kernel: torch.Tensor, m: int):
    """The DGCNN variant: points from the duplicated features (x, x),
    centers from the first half of the kernel's rows."""
    b, n, c = x.shape
    point = (torch.cat([x, x], -1) @ kernel).reshape(b, n, m, -1)
    center = (x @ kernel[:c]).reshape(b, n, m, -1)
    return point, center


class ScoreNet(nn.Module):
    """Dense layers (no bias) with BatchNorm and ReLU (``hidden<i>``,
    ``bn<i>``), then ``out`` (with a bias unless ``last_bn``) and the
    scores' softmax or sigmoid over the m matrices, plus ``bias``."""

    def __init__(self, in_channels: int, out_channel: int,
                 hidden_unit: Sequence[int] = (16,), last_bn: bool = False):
        super().__init__()
        self.last_bn = last_bn
        hidden = list(hidden_unit or [])
        for i, (cin, h) in enumerate(zip([in_channels, *hidden], hidden)):
            setattr(self, f"hidden{i}", Linear(cin, h))
            setattr(self, f"bn{i}", BatchNorm(h))
        self.n_hidden = len(hidden)
        width = hidden[-1] if hidden else in_channels
        self.out = (Linear(width, out_channel) if last_bn
                    else Dense(width, out_channel))
        if last_bn:
            self.bn_out = BatchNorm(out_channel)

    def forward(self, xyz, calc_scores: str = "softmax", bias: float = 0.0):
        s = xyz
        for i in range(self.n_hidden):
            s = F.relu(getattr(self, f"bn{i}")(getattr(self, f"hidden{i}")(s)))
        s = self.out(s)
        if self.last_bn:
            s = self.bn_out(s)
        if calc_scores == "softmax":
            return F.softmax(s, dim=-1) + bias
        if calc_scores == "sigmoid":
            return torch.sigmoid(s) + bias
        raise ValueError("Not Implemented!")


class _PAConvBase(nn.Module):
    flax_paths = "point"  # convert.flax_layout
    uses_dropout = True

    def _bank(self, tag: str, m: int, cin: int, cout: int):
        setattr(self, f"matrice{tag}",
                nn.Parameter(torch.zeros(cin, m * cout)))
        setattr(self, f"scorenet{tag}", ScoreNet(6, m))


class PAConvPointNet(_PAConvBase):
    """Logits [B, out_channel] of dense clouds [B, N, 3]."""

    def __init__(self, in_channel: int = 3, out_channel: int = 40,
                 k: int = 20, calc_scores: str = "softmax",
                 num_matrices: Sequence[int] = (8, 8, 8),
                 dropout: float = 0.5):
        super().__init__()
        self.out_channel, self.k = out_channel, k
        self.calc_scores = calc_scores
        self.num_matrices = tuple(num_matrices)
        self.conv1 = Linear(in_channel, 64)
        self.bn1 = BatchNorm(64)
        self.dims = [(m, ci, co, tag) for m, (ci, co, tag) in zip(
            self.num_matrices, ((64, 64, "2"), (64, 64, "3"),
                                (64, 128, "4")))]
        for m, ci, co, tag in self.dims:
            self._bank(tag, m, ci, co)
            setattr(self, f"bn{tag}", BatchNorm(co))
        self.conv5 = Linear(128, 1024)
        self.bn5 = BatchNorm(1024)
        self.linear1 = Linear(1024, 512)
        self.bn6 = BatchNorm(512)
        self.dropout = Dropout(dropout)
        self.linear2 = Dense(512, out_channel)

    def forward(self, x, generator: torch.Generator | None = None):
        check_generator(self, generator)
        idx = knn(x, self.k)
        xyz = get_scorenet_input(x, idx)
        h = F.relu(self.bn1(self.conv1(x)))
        for m, _, _, tag in self.dims:
            pt = feat_trans_pointnet(h, getattr(self, f"matrice{tag}"), m)
            score = getattr(self, f"scorenet{tag}")(xyz, self.calc_scores,
                                                     0.0)
            h = assign_score_withk_halfkernel(score, pt, idx)
            h = F.relu(getattr(self, f"bn{tag}")(h))
        h = F.relu(self.bn5(self.conv5(h)))
        g = F.relu(self.bn6(self.linear1(torch.amax(h, dim=1))))
        if self.training:
            g = self.dropout(g, generator)
        return self.linear2(g)


class PAConvDGCNN(_PAConvBase):
    """PAConv on the DGCNN backbone: logits [B, out_channel] of dense
    clouds [B, N, 3]."""

    def __init__(self, in_channel: int = 3, out_channel: int = 40,
                 k: int = 20, calc_scores: str = "softmax",
                 num_matrices: Sequence[int] = (8, 8, 8, 8),
                 dropout: float = 0.5):
        super().__init__()
        self.out_channel, self.k = out_channel, k
        self.calc_scores = calc_scores
        self.num_matrices = tuple(num_matrices)
        self.dims = [(m, ci, co, tag) for m, (ci, co, tag) in zip(
            self.num_matrices, ((in_channel, 64, "1"), (64, 64, "2"),
                                (64, 128, "3"), (128, 256, "4")))]
        for m, ci, co, tag in self.dims:
            self._bank(tag, m, 2 * ci, co)
            setattr(self, f"bn{tag}", BatchNorm(co))
        self.conv5 = Linear(512, 1024)
        self.bn5 = BatchNorm(1024)
        self.linear1 = Linear(2048, 512)
        self.bn6 = BatchNorm(512)
        self.dropout1 = Dropout(dropout)
        self.linear2 = Dense(512, 256)
        self.bn7 = BatchNorm(256)
        self.dropout2 = Dropout(dropout)
        self.linear3 = Dense(256, out_channel)

    def forward(self, x, generator: torch.Generator | None = None):
        check_generator(self, generator)
        idx = knn(x, self.k)
        xyz = get_scorenet_input(x, idx)
        h, feats = x.float(), []
        for m, _, _, tag in self.dims:
            pt, ctr = feat_trans_dgcnn(h, getattr(self, f"matrice{tag}"), m)
            score = getattr(self, f"scorenet{tag}")(xyz, self.calc_scores,
                                                     0.5)
            h = assign_score_withk(score, pt, ctr, idx)
            h = F.relu(getattr(self, f"bn{tag}")(h))
            feats.append(h)
        y = F.leaky_relu(self.bn5(self.conv5(torch.cat(feats, -1))), 0.2)
        g = torch.cat([torch.amax(y, dim=1), y.mean(1)], -1)
        g = F.leaky_relu(self.bn6(self.linear1(g)), 0.2)
        if self.training:
            g = self.dropout1(g, generator)
        g = F.leaky_relu(self.bn7(self.linear2(g)), 0.2)
        if self.training:
            g = self.dropout2(g, generator)
        return self.linear3(g)


@cfg.configurable("PAConvPointNet")
def paconv_pointnet(in_channel: int = 3, out_channel: int = 40, k: int = 20,
                    calc_scores: str = "softmax", num_matrices=(8, 8, 8),
                    dropout: float = 0.5) -> PAConvPointNet:
    """The gin surface of ``PAConvPointNet``."""
    return PAConvPointNet(in_channel, out_channel, k, calc_scores,
                          tuple(num_matrices), dropout)


def make_paconv(name: str, in_channel: int, out_channel: int, **kwargs):
    kwargs.pop("num_batches", None)
    if name == "PAConvDGCNN":
        return PAConvDGCNN(in_channel, out_channel, **kwargs)
    return paconv_pointnet(in_channel=in_channel, out_channel=out_channel,
                           **kwargs)
