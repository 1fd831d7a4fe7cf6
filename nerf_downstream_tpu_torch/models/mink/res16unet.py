"""Res16UNet sparse U-Net family (counterpart of
``nerf_downstream_tpu/models/mink/res16unet.py``). ``model.train()``
selects training (batch statistics in every BatchNorm and PowerNorm,
which update the running ones); ``model.eval()`` inference. Nothing else
in the forward depends on the mode.

Encoder: a two-conv stem at stride 1, then 4 x [k2/s2 down conv -> residual
stage]; decoder: 4 x [k2 transpose conv onto the cached encoder level ->
skip concat -> stage]; a 1x1 head; features sliced back onto the points.
A fresh CoordinateContext per forward holds the level pyramid and the
window plans, so each plan is built once and shared by every conv of its
level and by the matching transpose conv.

``sparse_mode`` is the reference's nine-slot conv-mode list: slot 0
covers ``conv0a``-``conv4``, slots 1-8 the stages ``block1``-``block8``.
Only modes 1 (pruned offsets) and 2 (ZAXIS) change a conv; 3 and 4 mean
dense. Transpose convs ignore the mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nerf_downstream_tpu_torch.convert import flax_path
from nerf_downstream_tpu_torch.models.mink.blocks import BLOCKS
from nerf_downstream_tpu_torch.models.mink.layers import (
    SparseConv,
    SparseConvTranspose,
    as_rows,
    cat,
    get_nonlinearity,
    make_norm,
)
from nerf_downstream_tpu_torch.sparse import (
    CoordinateContext,
    field_to_sparse,
    sparse_to_field,
)
from nerf_downstream_tpu_torch.sparse.types import PointField


class _ConvNormAct(nn.Module):
    def __init__(self, conv: nn.Module, channels: int, norm_type: str,
                 nonlinearity: str, bn_momentum: float = 0.1,
                 num_batches: int = 1):
        super().__init__()
        self.conv = conv
        self.norm = make_norm(norm_type, channels, bn_momentum=bn_momentum,
                              num_batches=num_batches)
        self.non = get_nonlinearity(nonlinearity)

    def forward(self, *args):
        return self.non(self.norm(self.conv(*args)))


class Res16UNet(nn.Module):
    """``ctx`` holds CoordinateContext knobs (see ``serve.PRESETS``); the
    context of each forward also takes whatever the gin configuration
    binds for ``CoordinateContext`` (arguments in ``ctx`` win), so a model
    built with ``ctx=None`` takes its knobs from the configuration as the
    reference's does. ``assume_unique`` is the quantization's
    one-point-per-voxel declaration; None leaves it to the
    ``field_to_sparse.assume_unique`` binding (default False).
    ``num_batches`` is the batch's scene count (the reference's, for the
    row path's grid index and the instance norms); ``dilations`` (one
    per stage, given to the stage's blocks) other than 1 put those
    blocks' 3x3 convs on the row path, as in the reference. ``norm_type`` is "BN", "IN", "LN" or "PN".
    With ``insseg`` the forward also returns per-point offsets from a
    second head (``offset_conv1`` -> norm -> nonlinearity ->
    ``offset_conv2`` to 3 channels): ``(offsets, logits)``."""

    def __init__(
        self,
        in_channels: int,
        out_channel: int,
        planes: Sequence[int] = (32, 48, 64, 96, 96, 96, 64, 64),
        layers: Sequence[int] = (2,) * 8,
        block: str = "BasicBlock",
        norm_type: str = "BN",
        nonlinearity: str = "MinkowskiReLU",
        compute_dtype: torch.dtype = torch.float32,
        ctx: dict | None = None,
        assume_unique: bool | None = False,
        sparse_mode: Sequence[int] = (0,) * 9,
        dilations: Sequence[int] = (1,) * 8,
        bn_momentum: float = 0.1,
        num_batches: int = 1,
        insseg: bool = False,
    ):
        super().__init__()
        if block not in BLOCKS:
            raise NotImplementedError(f"block {block!r} is not ported")
        self.num_batches = num_batches
        self.out_channel = out_channel
        self.planes, self.layers = tuple(planes), tuple(layers)
        self.compute_dtype = compute_dtype
        self.ctx_kwargs = dict(ctx or {})
        self.assume_unique = assume_unique
        self.sparse_mode = tuple(sparse_mode)
        self.dilations = tuple(int(d) for d in dilations)
        p, cd = self.planes, compute_dtype
        block_cls = BLOCKS[block]
        exp = block_cls.expansion

        def unit(conv, ch):
            return _ConvNormAct(conv, ch, norm_type, nonlinearity,
                                bn_momentum, num_batches)

        def stage(idx, inplanes):
            blocks = []
            for _ in range(self.layers[idx]):
                blocks.append(block_cls(inplanes, p[idx], norm_type,
                                        nonlinearity, cd,
                                        self._conv_mode(idx + 1),
                                        bn_momentum,
                                        num_batches=num_batches,
                                        dilation=self.dilations[idx]))
                inplanes = p[idx] * exp
            return nn.ModuleList(blocks), inplanes

        def conv(cin, cout, k, s, **kw):
            return SparseConv(cin, cout, k, s, compute_dtype=cd,
                              conv_mode=self._conv_mode(0), **kw)

        self.conv0a = unit(conv(in_channels, p[0], 3, 1, input_grad=False),
                           p[0])
        self.conv0b = unit(conv(p[0], p[0], 3, 1), p[0])
        self.conv1 = unit(conv(p[0], p[0], 2, 2), p[0])
        self.block1, c1 = stage(0, p[0])
        self.conv2 = unit(conv(c1, c1, 2, 2), c1)
        self.block2, c2 = stage(1, c1)
        self.conv3 = unit(conv(c2, c2, 2, 2), c2)
        self.block3, c3 = stage(2, c2)
        self.conv4 = unit(conv(c3, c3, 2, 2), c3)
        self.block4, c4 = stage(3, c3)
        cin = c4
        for i, skip in enumerate((c3, c2, c1, p[0])):
            ch = p[4 + i]
            setattr(self, f"convtr{4 + i}", unit(
                SparseConvTranspose(cin, ch, compute_dtype=cd), ch))
            blk, cin = stage(4 + i, ch + skip)
            setattr(self, f"block{5 + i}", blk)
        self.final = SparseConv(cin, out_channel, 1, 1, use_bias=True,
                                compute_dtype=cd)
        self.insseg = insseg
        if insseg:
            self.offset_conv1 = SparseConv(cin, cin, 1, 1, use_bias=True,
                                           compute_dtype=cd)
            self.offset_norm = make_norm(norm_type, cin,
                                         bn_momentum=bn_momentum,
                                         num_batches=num_batches)
            self.offset_non = get_nonlinearity(nonlinearity)
            self.offset_conv2 = SparseConv(cin, 3, 1, 1, use_bias=True,
                                           compute_dtype=cd)
        # each conv's name in the reference's variable tree keys the
        # pruned-eval maps (ctx.valid_offsets_map, ctx.block_live_map)
        for name, mod in self.named_modules():
            if isinstance(mod, SparseConv):
                mod.path = "/".join(flax_path(f"{name}.kernel")[1:-1])

    def _conv_mode(self, slot: int) -> int:
        m = self.sparse_mode[slot] if slot < len(self.sparse_mode) else 0
        return m if m in (1, 2) else 0

    @staticmethod
    def _run(blocks, sv, ctx):
        for b in blocks:
            sv = b(sv, ctx)
        return sv

    def forward(self, field: PointField):
        """Per-point logits [N, out_channel] (f32); with ``insseg``
        (offsets [N, 3], logits)."""
        ctx = CoordinateContext(**dict(dict(num_batches=self.num_batches),
                                       **self.ctx_kwargs))
        if self.assume_unique is None:
            sv, p2v = field_to_sparse(field)
        else:
            sv, p2v = field_to_sparse(field, assume_unique=self.assume_unique)
        out = self.conv0a(sv, ctx)
        out_p1 = self.conv0b(out, ctx)
        out_b1p2 = self._run(self.block1, self.conv1(out_p1, ctx), ctx)
        out_b2p4 = self._run(self.block2, self.conv2(out_b1p2, ctx), ctx)
        out_b3p8 = self._run(self.block3, self.conv3(out_b2p4, ctx), ctx)
        out = self._run(self.block4, self.conv4(out_b3p8, ctx), ctx)
        for i, skip in enumerate((out_b3p8, out_b2p4, out_b1p2, out_p1)):
            out = getattr(self, f"convtr{4 + i}")(out, ctx, skip)
            out = self._run(getattr(self, f"block{5 + i}"), cat(out, skip),
                            ctx)
        logits_sv = as_rows(self.final(out, ctx))
        logits = sparse_to_field(logits_sv, field, p2v).feats
        if not self.insseg:
            return logits
        off = self.offset_non(self.offset_norm(self.offset_conv1(out, ctx)))
        off = as_rows(self.offset_conv2(off, ctx))
        return sparse_to_field(off, field, p2v).feats, logits


# Variant tables (reference res16unet.py:175-234)
_BASE = {
    "Res16UNet14": ("BasicBlock", (1,) * 8),
    "Res16UNet18": ("BasicBlock", (2,) * 8),
    "Res16UNet34": ("BasicBlock", (2, 3, 4, 6, 2, 2, 2, 2)),
    "Res16UNet50": ("Bottleneck", (2, 3, 4, 6, 2, 2, 2, 2)),
    "Res16UNet101": ("Bottleneck", (2, 3, 4, 23, 2, 2, 2, 2)),
}
_PLANES = {
    "A": (32, 64, 128, 256, 128, 128, 96, 96),
    "B": (32, 64, 128, 256, 128, 128, 128, 128),
    "C": (32, 64, 128, 256, 192, 192, 128, 128),
    "D": (32, 64, 128, 256, 384, 384, 384, 384),
}
_PLANES_18C = (32, 64, 128, 256, 256, 128, 96, 96)
_PLANES_34 = {
    "A": (32, 64, 128, 256, 256, 128, 64, 64),
    "B": (32, 64, 128, 256, 256, 128, 64, 32),
    "C": (32, 64, 128, 256, 256, 128, 96, 96),
}
_LAYER_OVERRIDES = {
    "Res16UNet14A2": (1, 1, 1, 1, 2, 2, 2, 2),
    "Res16UNet14B2": (1, 1, 1, 1, 2, 2, 2, 2),
    "Res16UNet14B3": (2, 2, 2, 2, 1, 1, 1, 1),
}


def _variant_table() -> dict:
    table = {}
    for base, (block, layers) in _BASE.items():
        table[base] = dict(block=block, layers=layers)
        for suffix, planes in _PLANES.items():
            table[base + suffix] = dict(block=block, layers=layers,
                                        planes=planes)
    table["Res16UNet18C"] = dict(block="BasicBlock", layers=(2,) * 8,
                                 planes=_PLANES_18C)
    for suffix, planes in _PLANES_34.items():
        table["Res16UNet34" + suffix] = dict(
            block="BasicBlock", layers=_BASE["Res16UNet34"][1], planes=planes
        )
    for name, layers in _LAYER_OVERRIDES.items():
        table[name] = dict(table[name[:-1]], layers=layers)
    # instance-segmentation variants (reference :145-160)
    for name in ("Res16UNet14A", "Res16UNet14B", "Res16UNet18A",
                 "Res16UNet18B"):
        table[name + "Ins"] = dict(table[name], insseg=True)
    table["MinkUNet14"] = table["Res16UNet14"]
    table["MinkUNet18"] = table["Res16UNet18"]
    table["MinkUNet34"] = table["Res16UNet34"]
    return table


VARIANTS = _variant_table()


def make_res16unet(name: str, in_channels: int, out_channel: int,
                   **kwargs) -> Res16UNet:
    spec = dict(VARIANTS[name])
    spec.update(kwargs)
    return Res16UNet(in_channels, out_channel, **spec)
