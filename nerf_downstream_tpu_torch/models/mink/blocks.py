"""Residual blocks over SparseVoxels (counterpart of
``nerf_downstream_tpu/models/mink/blocks.py``)."""

from __future__ import annotations

import torch
from torch import nn

from nerf_downstream_tpu_torch.models.mink.layers import (
    SparseConv,
    get_nonlinearity,
    make_norm,
)


class BasicBlock(nn.Module):
    """conv3-norm-act-conv3-norm (+ skip, through a 1x1 conv-norm when the
    width changes) - act. Expansion 1. ``conv_mode`` goes to the two 3x3
    convs (``SparseConv``)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, norm_type: str = "BN",
                 nonlinearity: str = "MinkowskiReLU",
                 compute_dtype: torch.dtype = torch.float32,
                 conv_mode: int = 0, bn_momentum: float = 0.1):
        super().__init__()
        self.non = get_nonlinearity(nonlinearity)
        self.conv1 = SparseConv(inplanes, planes, 3, 1,
                                compute_dtype=compute_dtype,
                                conv_mode=conv_mode)
        self.norm1 = make_norm(norm_type, planes, bn_momentum=bn_momentum)
        self.conv2 = SparseConv(planes, planes, 3, 1,
                                compute_dtype=compute_dtype,
                                conv_mode=conv_mode)
        self.norm2 = make_norm(norm_type, planes, bn_momentum=bn_momentum)
        self.downsample = None
        if inplanes != planes * self.expansion:
            self.downsample = nn.ModuleDict({
                "conv": SparseConv(inplanes, planes * self.expansion, 1, 1,
                                   compute_dtype=compute_dtype),
                "norm": make_norm(norm_type, planes * self.expansion,
                                  bn_momentum=bn_momentum),
            })

    def forward(self, sv, ctx):
        out = self.non(self.norm1(self.conv1(sv, ctx)))
        out = self.norm2(self.conv2(out, ctx))
        residual = sv
        if self.downsample is not None:
            residual = self.downsample["norm"](self.downsample["conv"](sv, ctx))
        return self.non(out.replace(feats=out.feats + residual.feats))


BLOCKS = {"BasicBlock": BasicBlock}
