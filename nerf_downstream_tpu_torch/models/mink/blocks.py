"""Residual blocks over SparseVoxels (counterpart of
``nerf_downstream_tpu/models/mink/blocks.py``).

A block with a stride of 2 or a change of width takes its shortcut
through a 1x1 conv of the same stride and a norm (``downsample``): on the
fully-windowed path a k1/s2 conv is a cross-set window plan, and the
strided k3 conv of the main branch takes the row path; both land on the
same coarser level (the context caches it). Under "block_resident" the
k1/s2 shortcut steps down in-block while the k3/s2 main branch takes the
row path; the add then reads both back to rows (``_aligned``)."""

from __future__ import annotations

import functools

import torch
from torch import nn

from nerf_downstream_tpu_torch.models.mink.layers import (
    SparseConv,
    as_rows,
    get_nonlinearity,
    make_norm,
)
from nerf_downstream_tpu_torch.ops.block_resident import BlockVoxels


def _aligned(out, residual):
    """Both branches of a residual add in one representation: rows when
    one of them left the blocks."""
    if isinstance(out, BlockVoxels) != isinstance(residual, BlockVoxels):
        return as_rows(out), as_rows(residual)
    return out, residual


def _downsample(inplanes, outplanes, stride, norm, compute_dtype):
    return nn.ModuleDict({
        "conv": SparseConv(inplanes, outplanes, 1, stride,
                           compute_dtype=compute_dtype),
        "norm": norm(outplanes),
    })


class BasicBlock(nn.Module):
    """conv3-norm-act-conv3-norm (+ skip) - act. Expansion 1. ``stride``
    goes to the first 3x3 conv; ``conv_mode`` and ``dilation`` to both 3x3
    convs (``SparseConv``); ``num_batches`` to instance norms."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, norm_type: str = "BN",
                 nonlinearity: str = "MinkowskiReLU",
                 compute_dtype: torch.dtype = torch.float32,
                 conv_mode: int = 0, bn_momentum: float = 0.1,
                 stride: int = 1, num_batches: int = 1, dilation: int = 1):
        super().__init__()
        norm = functools.partial(make_norm, norm_type,
                                 bn_momentum=bn_momentum,
                                 num_batches=num_batches)
        self.non = get_nonlinearity(nonlinearity)
        self.conv1 = SparseConv(inplanes, planes, 3, stride,
                                compute_dtype=compute_dtype,
                                conv_mode=conv_mode, dilation=dilation)
        self.norm1 = norm(planes)
        self.conv2 = SparseConv(planes, planes, 3, 1,
                                compute_dtype=compute_dtype,
                                conv_mode=conv_mode, dilation=dilation)
        self.norm2 = norm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            self.downsample = _downsample(inplanes, planes * self.expansion,
                                          stride, norm, compute_dtype)

    def forward(self, sv, ctx):
        out = self.non(self.norm1(self.conv1(sv, ctx)))
        out = self.norm2(self.conv2(out, ctx))
        residual = sv
        if self.downsample is not None:
            residual = self.downsample["norm"](self.downsample["conv"](sv, ctx))
        out, residual = _aligned(out, residual)
        return self.non(out.replace(feats=out.feats + residual.feats))


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 bottleneck, expansion 4: conv1-norm1-act (1x1),
    conv2-norm2-act (3x3, ``stride``, ``conv_mode`` and ``dilation``),
    conv3-norm3 (1x1
    to ``4 * planes``), + skip, act."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, norm_type: str = "BN",
                 nonlinearity: str = "MinkowskiReLU",
                 compute_dtype: torch.dtype = torch.float32,
                 conv_mode: int = 0, bn_momentum: float = 0.1,
                 stride: int = 1, num_batches: int = 1, dilation: int = 1):
        super().__init__()
        out = planes * self.expansion
        norm = functools.partial(make_norm, norm_type,
                                 bn_momentum=bn_momentum,
                                 num_batches=num_batches)
        self.non = get_nonlinearity(nonlinearity)
        self.conv1 = SparseConv(inplanes, planes, 1, 1,
                                compute_dtype=compute_dtype)
        self.norm1 = norm(planes)
        self.conv2 = SparseConv(planes, planes, 3, stride,
                                compute_dtype=compute_dtype,
                                conv_mode=conv_mode, dilation=dilation)
        self.norm2 = norm(planes)
        self.conv3 = SparseConv(planes, out, 1, 1,
                                compute_dtype=compute_dtype)
        self.norm3 = norm(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = _downsample(inplanes, out, stride, norm,
                                          compute_dtype)

    def forward(self, sv, ctx):
        out = self.non(self.norm1(self.conv1(sv, ctx)))
        out = self.non(self.norm2(self.conv2(out, ctx)))
        out = self.norm3(self.conv3(out, ctx))
        residual = sv
        if self.downsample is not None:
            residual = self.downsample["norm"](self.downsample["conv"](sv, ctx))
        out, residual = _aligned(out, residual)
        return self.non(out.replace(feats=out.feats + residual.feats))


BLOCKS = {"BasicBlock": BasicBlock, "Bottleneck": Bottleneck}
