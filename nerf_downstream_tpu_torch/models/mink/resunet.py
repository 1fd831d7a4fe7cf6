"""The ResUNet2 family: a 4-level sparse U-Net for registration and
feature learning (counterpart of ``nerf_downstream_tpu/models/mink/
resunet.py``).

Encoder: ``conv1`` (kernel ``conv1_kernel_size``, stride 1) and three
k3/s2 convs (``conv2``-``conv4``), each followed by a norm (``norm_type``;
none for ``ResUNet2``) and a residual ``BasicBlock`` (``block_norm_type``);
decoder: three k3/s2 transposed convs (``conv4_tr``-``conv2_tr``) onto the
encoder's levels, each with a norm and a block, then a skip concat; a 1x1
``conv1_tr``, ReLU and the 1x1 ``final`` head (with a bias). The output is
the voxel rows (``as_rows``), L2-normalised by ``max(|f|, 1e-8)`` with
``normalize_feature``.

As in the reference, the model builds its own ``CoordinateContext`` with
its ``num_batches`` and no grid extent (the gin configuration may bind
more), so every conv takes the row path: kernel maps by sort and search
and K6 (``row_gather_matmul``) for the k3 convs, the conv1 kernel and the
transposes; the 1x1 convs are plain matrix products, as the reference
leaves them to XLA. The variant table is the reference's, IN names
included (top-level norms "BN", block norms "IN"). Modules carry the
reference's names, the top-level norms its automatic ones (the norm's
class and its place in creation order, ``MaskedBatchNorm_0``-``_6``);
the blocks' norms map by ``convert.resunet_flax_path``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nerf_downstream_tpu_torch.models.mink.blocks import BasicBlock
from nerf_downstream_tpu_torch.models.mink.layers import (
    SparseConv,
    SparseConvTranspose,
    as_rows,
    cat,
    make_norm,
)
from nerf_downstream_tpu_torch.sparse import CoordinateContext, field_to_sparse
from nerf_downstream_tpu_torch.sparse.types import PointField, SparseVoxels


def _relu(sv: SparseVoxels) -> SparseVoxels:
    return sv.replace(feats=torch.relu(sv.feats))


class ResUNet2(nn.Module):
    """Output features [N_voxels, out_channel] of a point field, as the
    finest level's ``SparseVoxels`` (rows in the voxel set's order, padding
    masked). ``assume_unique`` is the quantization's one-point-per-voxel
    declaration (None: the ``field_to_sparse.assume_unique`` binding)."""

    flax_paths = "resunet"  # convert.flax_layout

    def __init__(
        self,
        in_channel: int,
        out_channel: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256),
        tr_channels: Sequence[int] = (32, 64, 64, 128),
        norm_type: str | None = None,
        block_norm_type: str = "BN",
        bn_momentum: float = 0.1,
        normalize_feature: bool = False,
        conv1_kernel_size: int = 3,
        num_batches: int = 1,
        compute_dtype: torch.dtype = torch.float32,
        assume_unique: bool | None = None,
    ):
        super().__init__()
        ch, tr = tuple(channels), tuple(tr_channels)
        self.out_channel = out_channel
        self.num_batches = num_batches
        self.normalize_feature = normalize_feature
        self.assume_unique = assume_unique
        cd = compute_dtype
        self.norms = []  # the top-level norms' names, in creation order

        def norm(c):
            if norm_type is not None:
                mod = make_norm(norm_type, c, bn_momentum=bn_momentum,
                                num_batches=num_batches)
                name = getattr(type(mod), "flax_name", "MaskedBatchNorm")
                self.norms.append(f"{name}_{len(self.norms)}")
                setattr(self, self.norms[-1], mod)

        def block(name, c):
            setattr(self, name, BasicBlock(
                c, c, block_norm_type, "MinkowskiReLU", cd,
                bn_momentum=bn_momentum, num_batches=num_batches))

        cin = in_channel
        for i in range(4):
            k = conv1_kernel_size if i == 0 else 3
            setattr(self, f"conv{i + 1}", SparseConv(
                cin, ch[i], k, 1 if i == 0 else 2, compute_dtype=cd))
            norm(ch[i])
            block(f"block{i + 1}", ch[i])
            cin = ch[i]
        for i in range(3, 0, -1):
            setattr(self, f"conv{i + 1}_tr", SparseConvTranspose(
                cin, tr[i], compute_dtype=cd, kernel_size=3))
            norm(tr[i])
            block(f"block{i + 1}_tr", tr[i])
            cin = tr[i] + ch[i - 1]
        # the flax class of the blocks' norms (convert.norm_name)
        self.flax_norm = getattr(
            type(self.block1.norm1), "flax_name", "MaskedBatchNorm")
        self.conv1_tr = SparseConv(cin, tr[0], 1, 1, compute_dtype=cd)
        self.final = SparseConv(tr[0], out_channel, 1, 1, use_bias=True,
                                compute_dtype=cd)

    def _norm(self, sv, i: int):
        return sv if not self.norms else getattr(self, self.norms[i])(sv)

    def forward(self, field: PointField) -> SparseVoxels:
        ctx = CoordinateContext(num_batches=self.num_batches)
        if self.assume_unique is None:
            out, _ = field_to_sparse(field)
        else:
            out, _ = field_to_sparse(field, assume_unique=self.assume_unique)
        levels = []
        for i in range(1, 5):
            out = getattr(self, f"conv{i}")(out, ctx)
            out = getattr(self, f"block{i}")(self._norm(out, i - 1), ctx)
            levels.append(out)
            out = _relu(out)
        for i in range(3, 0, -1):
            out = getattr(self, f"conv{i + 1}_tr")(out, ctx, levels[i - 1])
            out = self._norm(out, 7 - i)
            out = _relu(getattr(self, f"block{i + 1}_tr")(out, ctx))
            out = cat(out, levels[i - 1])
        out = _relu(self.conv1_tr(out, ctx))
        out = as_rows(self.final(out, ctx))
        feats = out.feats
        if self.normalize_feature:
            feats = feats / torch.clamp(
                torch.linalg.vector_norm(feats, dim=1, keepdim=True),
                min=1e-8)
        return out.replace(feats=feats)


_VARIANTS = {
    "ResUNet2": dict(norm_type=None),
    "ResUNetBN2": dict(norm_type="BN"),
    "ResUNetBN2B": dict(norm_type="BN", tr_channels=(64, 64, 64, 64)),
    "ResUNetBN2C": dict(norm_type="BN", tr_channels=(64, 64, 64, 128)),
    "ResUNetBN2D": dict(norm_type="BN", tr_channels=(64, 64, 128, 128)),
    "ResUNetBN2E": dict(norm_type="BN", channels=(128, 128, 128, 256),
                        tr_channels=(64, 128, 128, 128)),
}
# the reference's IN names: its top-level norms stay "BN", the blocks' IN
for _name, _spec in list(_VARIANTS.items()):
    _in = _name.replace("BN2", "IN2") if "BN2" in _name else "ResUNetIN2"
    _VARIANTS[_in] = dict(_spec, norm_type="BN", block_norm_type="IN")

# the reference's aliases of Res16UNet variants
ALIASES = {"ResUNet14": "Res16UNet14A", "ResUNet18": "Res16UNet18A",
           "ResUNet34": "Res16UNet34C"}
NAMES = (*_VARIANTS, *ALIASES)


def make_resunet(name: str, in_channel: int, out_channel: int, **kwargs):
    if name in ALIASES:
        from nerf_downstream_tpu_torch.models.mink.res16unet import (
            make_res16unet,
        )

        return make_res16unet(ALIASES[name], in_channel, out_channel,
                              **kwargs)
    kwargs.pop("ctx", None)
    spec = dict(_VARIANTS[name])
    spec.update(kwargs)
    return ResUNet2(in_channel, out_channel, **spec)
