"""Sparse ResNet classifiers (counterpart of
``nerf_downstream_tpu/models/mink/resnet.py``).

k3 stem conv -> norm -> act -> k2/s2 sum pooling -> four residual stages,
each opening with a stride-2 block -> global average pooling per scene ->
a linear head. ResNet14/18/34 stack ``BasicBlock``s, ResNet50/101
``Bottleneck``s, in the reference's ``LAYERS`` and ``PLANES``. Modules
carry the reference's names (``conv1``, ``pool``, ``layer<i>_block<j>``,
``final``), so ``convert.flax_path`` maps the weights both ways; the head
keeps flax's ``kernel [C, out]`` layout. ``model.train()`` selects batch
statistics in every norm.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nerf_downstream_tpu_torch.convert import flax_path
from nerf_downstream_tpu_torch.models.mink.blocks import BLOCKS
from nerf_downstream_tpu_torch.models.mink.layers import (
    GlobalPool,
    SparseConv,
    SparsePool,
    get_nonlinearity,
    make_norm,
)
from nerf_downstream_tpu_torch.sparse import CoordinateContext, field_to_sparse
from nerf_downstream_tpu_torch.sparse.types import PointField


class Dense(nn.Module):
    """``x @ kernel + bias`` with flax's ``kernel [C_in, C_out]``, in the
    wider of the input's type and the kernel's (f32 unless the model was
    cast to f64)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.kernel.dtype))
        return x @ self.kernel + self.bias


class MinkResNetBase(nn.Module):
    """``ctx`` holds CoordinateContext knobs; each forward's context also
    takes whatever the gin configuration binds (arguments in ``ctx``
    win). ``assume_unique`` is the quantization's one-point-per-voxel
    declaration; None leaves it to the ``field_to_sparse.assume_unique``
    binding. ``num_batches`` is the scene count of a batch: the logits
    have one row per scene slot, [num_batches, out_channel]."""

    def __init__(
        self,
        in_channels: int,
        out_channel: int,
        block: str = "BasicBlock",
        layers: Sequence[int] = (1, 1, 1, 1),
        planes: Sequence[int] = (64, 128, 256, 512),
        init_dim: int = 64,
        norm_type: str = "BN",
        nonlinearity: str = "MinkowskiReLU",
        bn_momentum: float = 0.1,
        num_batches: int = 1,
        compute_dtype: torch.dtype = torch.float32,
        ctx: dict | None = None,
        assume_unique: bool | None = False,
    ):
        super().__init__()
        self.out_channel = out_channel
        self.num_batches = num_batches
        self.planes, self.layers = tuple(planes), tuple(layers)
        self.compute_dtype = compute_dtype
        self.ctx_kwargs = dict(ctx or {})
        self.assume_unique = assume_unique
        self.non = get_nonlinearity(nonlinearity)
        self.conv1 = SparseConv(in_channels, init_dim, 3, 1,
                                compute_dtype=compute_dtype)
        self.norm = make_norm(norm_type, init_dim, bn_momentum=bn_momentum,
                              num_batches=num_batches)
        self.pool = SparsePool(2, 2, "sum")
        block_cls = BLOCKS[block]
        inplanes = init_dim
        self.stages = []
        for i, (p, n) in enumerate(zip(self.planes, self.layers), start=1):
            names = []
            for j in range(n):
                name = f"layer{i}_block{j}"
                setattr(self, name, block_cls(
                    inplanes, p, norm_type, nonlinearity, compute_dtype,
                    bn_momentum=bn_momentum, stride=2 if j == 0 else 1,
                    num_batches=num_batches))
                inplanes = p * block_cls.expansion
                names.append(name)
            self.stages.append(names)
        self.global_pool = GlobalPool("avg", num_batches)
        self.final = Dense(inplanes, out_channel)
        for name, mod in self.named_modules():
            if isinstance(mod, SparseConv):
                mod.path = "/".join(flax_path(f"{name}.kernel")[1:-1])

    def forward(self, field: PointField) -> torch.Tensor:
        """Logits [num_batches, out_channel] (f32)."""
        ctx = CoordinateContext(**dict(dict(num_batches=self.num_batches),
                                       **self.ctx_kwargs))
        if self.assume_unique is None:
            sv, _ = field_to_sparse(field)
        else:
            sv, _ = field_to_sparse(field, assume_unique=self.assume_unique)
        sv = self.non(self.norm(self.conv1(sv, ctx)))
        sv = self.pool(sv, ctx)
        for names in self.stages:
            for name in names:
                sv = getattr(self, name)(sv, ctx)
        return self.final(self.global_pool(sv))


_VARIANTS = {
    "ResNet14": ("BasicBlock", (1, 1, 1, 1)),
    "ResNet18": ("BasicBlock", (2, 2, 2, 2)),
    "ResNet34": ("BasicBlock", (3, 4, 6, 3)),
    "ResNet50": ("Bottleneck", (3, 4, 6, 3)),
    "ResNet101": ("Bottleneck", (3, 4, 23, 3)),
}


def make_resnet(name: str, in_channels: int, out_channel: int,
                **kwargs) -> MinkResNetBase:
    block, layers = _VARIANTS[name]
    return MinkResNetBase(in_channels, out_channel, block=block,
                          layers=layers, **kwargs)
