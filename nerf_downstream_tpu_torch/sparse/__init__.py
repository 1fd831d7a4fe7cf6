"""Sparse voxel types, packed-key search and coordinate-set algebra."""

from nerf_downstream_tpu_torch.sparse.context import CoordinateContext
from nerf_downstream_tpu_torch.sparse.kernels import (
    field_to_sparse,
    kernel_offsets,
    slice_field,
    sparse_to_field,
    stride_coords_capped,
    unique_coords,
)
from nerf_downstream_tpu_torch.sparse.types import PointField, SparseVoxels

__all__ = [
    "CoordinateContext",
    "PointField",
    "SparseVoxels",
    "field_to_sparse",
    "kernel_offsets",
    "slice_field",
    "sparse_to_field",
    "stride_coords_capped",
    "unique_coords",
]
