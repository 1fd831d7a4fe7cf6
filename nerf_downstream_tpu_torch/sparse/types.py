"""Fixed-capacity batched voxel sets (counterpart of
``nerf_downstream_tpu/sparse/types.py``).

A :class:`SparseVoxels` carries a static row capacity ``N`` with a validity
mask; the batch index sits in ``coords[:, 0]``. Coordinate tensors keep
their identity through a forward pass (layers pass ``coords`` on
unchanged), which is what the coordinate context's plan cache keys on.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SparseVoxels:
    """coords int32[N, 4] (b, x, y, z) in finest-voxel units; feats [N, C];
    mask bool[N]; stride: the tensor stride of the level."""

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    stride: int = 1

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def masked_feats(self) -> torch.Tensor:
        return torch.where(self.mask[:, None], self.feats, 0)

    def batch_ids(self, num_batches: int) -> torch.Tensor:
        """Batch index per row (int32); padding rows map to
        ``num_batches``."""
        return torch.where(self.mask, self.coords[:, 0],
                           num_batches).to(torch.int32)

    def replace(self, **changes) -> "SparseVoxels":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class PointField:
    """Continuous-coordinate point set: coords float32[N, 4] with the batch
    index in column 0, feats [N, C], mask bool[N]."""

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]
