"""Positional encoding and the EncodedRes16UNet variants (counterpart of
``nerf_downstream_tpu/models/mink/encoding.py``).

``positional_encode`` gives each input channel sin and cos features at
``num_encoding_functions`` frequencies (the reference's column order:
channel-major, sines then cosines). ``EncodedRes16UNet``: the encoding
through a point MLP (``enc_mlp``: dense, masked BatchNorm, nonlinearity)
into a Res16UNet trunk (``trunk``, out_channel = ``planes[7]``), the MLP's
output concatenated with the trunk's per-point features, a second MLP
(``dec_mlp``) and a dense ``final``. ``variant2`` (EncodedRes16UNet2)
concatenates the raw encoding instead of the MLP's output.

The trunk's first conv declares ``input_grad=False``, which acts on the
windowed route only (the row path differentiates its input whatever the
flag says), as in the reference: on the windowed route ``enc_mlp`` gets
no gradient through the trunk, only through the skip; on the row route
it gets both. The port copies this reference defect on purpose, so that
each route matches the reference's (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nerf_downstream_tpu_torch.models.mink.fcnn import Linear
from nerf_downstream_tpu_torch.models.mink.layers import (
    MaskedBatchNorm,
    get_nonlinearity,
)
from nerf_downstream_tpu_torch.models.mink.res16unet import Res16UNet
from nerf_downstream_tpu_torch.models.mink.resnet import Dense
from nerf_downstream_tpu_torch.sparse.types import PointField, SparseVoxels


def encoding_frequencies(num_encoding_functions: int,
                         min_resolution: Optional[float] = None) -> np.ndarray:
    if min_resolution is not None:
        max_exp = np.log2(0.5 / min_resolution)
        return 2.0 ** np.linspace(max_exp - num_encoding_functions - 1,
                                  max_exp, num_encoding_functions)
    return 2.0 ** np.arange(num_encoding_functions)


def positional_encode(
    feats: torch.Tensor,
    num_encoding_functions: int = 4,
    include_original_channel_range: Optional[Tuple[int, int]] = None,
    min_resolution: Optional[float] = None,
) -> torch.Tensor:
    """[N, C] -> [N, C * 2F (+ the passthrough channels)] in f32."""
    if num_encoding_functions < 1:
        return feats
    freqs = torch.as_tensor(
        encoding_frequencies(num_encoding_functions, min_resolution),
        dtype=torch.float32, device=feats.device)
    x = feats[:, :, None] * freqs
    out = torch.cat([torch.sin(x), torch.cos(x)], -1).reshape(
        feats.shape[0], -1)
    if include_original_channel_range is not None:
        lo, hi = include_original_channel_range
        out = torch.cat([out, feats[:, lo:hi]], 1)
    return out


def encoded_out_channels(in_channel: int, num_encoding_functions: int = 4,
                         include_original_channel_range=None) -> int:
    if num_encoding_functions < 1:
        return in_channel
    extra = (0 if include_original_channel_range is None
             else include_original_channel_range[1]
             - include_original_channel_range[0])
    return in_channel * 2 * num_encoding_functions + extra


class PointMLP(nn.Module):
    """Dense (no bias, ``mlp<i>``), masked BatchNorm (``bn<i>``) and the
    nonlinearity, per layer, on point rows."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 nonlinearity: str = "MinkowskiReLU"):
        super().__init__()
        self.non = get_nonlinearity(nonlinearity)
        self.depth = len(channels)
        for i, (cin, c) in enumerate(zip([in_channels, *channels],
                                         channels)):
            setattr(self, f"mlp{i}", Linear(cin, c))
            setattr(self, f"bn{i}", MaskedBatchNorm(c))

    def forward(self, feats, mask):
        for i in range(self.depth):
            f = getattr(self, f"mlp{i}")(feats)
            rows = SparseVoxels(
                coords=torch.zeros((f.shape[0], 4), dtype=torch.int32,
                                   device=f.device),
                feats=f, mask=mask, stride=1)
            feats = self.non(getattr(self, f"bn{i}")(rows)).feats
        return feats


class EncodedRes16UNet(nn.Module):
    """Per-point logits [N, out_channel] (f32). ``kwargs`` go to the
    trunk (``Res16UNet``: planes, layers, dilations, block, norm_type,
    bn_momentum, num_batches, compute_dtype, ctx, assume_unique)."""

    flax_paths = "point"  # convert.flax_layout

    def __init__(self, in_channel: int, out_channel: int,
                 enc_planes: Sequence[int] = (32, 32),
                 dec_planes: Sequence[int] = (64, 64),
                 num_encoding_functions: int = 4, variant2: bool = False,
                 nonlinearity: str = "MinkowskiReLU", **kwargs):
        super().__init__()
        self.out_channel = out_channel
        self.num_batches = kwargs.get("num_batches", 1)
        self.num_encoding_functions = num_encoding_functions
        self.variant2 = variant2
        enc = encoded_out_channels(in_channel, num_encoding_functions)
        self.enc_mlp = PointMLP(enc, enc_planes, nonlinearity)
        planes = kwargs.pop("planes", (32, 48, 64, 96, 96, 96, 64, 64))
        self.trunk = Res16UNet(enc_planes[-1], planes[7], planes=planes,
                               nonlinearity=nonlinearity, **kwargs)
        skip = enc if variant2 else enc_planes[-1]
        self.dec_mlp = PointMLP(skip + planes[7], dec_planes, nonlinearity)
        self.final = Dense(dec_planes[-1], out_channel)

    def forward(self, field: PointField) -> torch.Tensor:
        enc = positional_encode(field.feats, self.num_encoding_functions)
        enc_feats = self.enc_mlp(enc, field.mask)
        unet_out = self.trunk(PointField(coords=field.coords,
                                         feats=enc_feats, mask=field.mask))
        skip = enc if self.variant2 else enc_feats
        dec = self.dec_mlp(torch.cat([skip, unet_out], 1), field.mask)
        return self.final(dec)
