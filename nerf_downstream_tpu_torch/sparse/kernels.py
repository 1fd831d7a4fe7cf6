"""Coordinate-set algebra: kernel offsets, dedup, striding, field<->sparse
(counterpart of ``nerf_downstream_tpu/sparse/kernels.py``).

All results keep static shapes: unique entries are packed at the front in
key order and padding rows are masked out. Division of coordinates is
floor division, as in the reference, so negative coordinates stride the
same way.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from nerf_downstream_tpu_torch.sparse import packing
from nerf_downstream_tpu_torch.sparse.types import PointField, SparseVoxels


def kernel_offsets(kernel_size, tensor_stride: int, dilation: int = 1):
    """Integer kernel offsets [K, 3] in finest-voxel units, x fastest
    (MinkowskiEngine's region order, which fixes the weight row layout).
    Odd kernels are centred on the output; even kernels span 0..k-1."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * 3
    axes = []
    for k in kernel_size:
        r = np.arange(-(k // 2), k // 2 + 1) if k % 2 else np.arange(0, k)
        axes.append(r * tensor_stride * dilation)
    return np.array(
        [(x, y, z) for z, y, x in itertools.product(*axes[::-1])],
        dtype=np.int32,
    )


def _scatter_rows(n: int, rows: torch.Tensor, dest: torch.Tensor):
    """zeros[n + 1, ...] with ``rows`` written at ``dest`` (index n is the
    drop row), sliced back to n rows."""
    out = torch.zeros(
        (n + 1,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device
    )
    out[dest.to(torch.int64)] = rows
    return out[:n]


def unique_coords(coords: torch.Tensor, mask: torch.Tensor):
    """Deduplicate a coordinate set under a static capacity.

    Returns (out_coords [N, 4], out_mask [N], row_to_unique [N]): unique
    coordinates in key order at the front, padding rows all zero, and for
    each input row the slot holding its coordinate.
    """
    n = coords.shape[0]
    hi, lo = packing.pack(coords, mask)
    idx = torch.arange(n, dtype=torch.int32, device=coords.device)
    s_hi, s_lo, s_idx = packing.sort_with_payload(hi, lo, idx)
    s_valid = s_hi != packing.INVALID_KEY
    first = packing.unique_first_occurrence(s_hi, s_lo, s_valid)
    slot = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_unique = first.sum()
    slot = torch.where(s_valid, slot, n - 1)
    out_mask = idx < num_unique
    scatter_to = torch.where(first, slot, n)
    out_coords = _scatter_rows(n, coords[s_idx.long()], scatter_to)
    row_to_unique = torch.zeros(n, dtype=torch.int32, device=coords.device)
    row_to_unique[s_idx.long()] = slot
    return out_coords, out_mask, row_to_unique


def stride_coords_capped(sv: SparseVoxels, stride: int, cap: int | None):
    """unique(floor(coords / s) * s) with a per-level row capacity.

    Returns (SparseVoxels with zero-width feats, lost): ``lost`` counts the
    valid coordinates beyond ``cap``; the caller NaN-poisons the level when
    it is non-zero.
    """
    new_stride = sv.stride * stride
    xyz = torch.div(sv.coords[:, 1:], new_stride, rounding_mode="floor")
    coords = torch.cat([sv.coords[:, :1], xyz * new_stride], 1)
    uniq_coords, uniq_mask, _ = unique_coords(coords, sv.mask)
    if cap is None or cap >= sv.capacity:
        lost = torch.zeros((), dtype=torch.int32, device=coords.device)
    else:
        lost = uniq_mask[cap:].sum().to(torch.int32)
        uniq_coords = uniq_coords[:cap]
        uniq_mask = uniq_mask[:cap]
    out = SparseVoxels(
        coords=uniq_coords,
        feats=sv.feats.new_zeros((uniq_coords.shape[0], 0)),
        mask=uniq_mask,
        stride=new_stride,
    )
    return out, lost


def field_to_sparse(
    field: PointField, voxel_size: float = 1.0, assume_unique: bool = False
):
    """Quantize a PointField into SparseVoxels, averaging duplicate points.

    Returns (SparseVoxels, point_to_voxel int32[N]). ``assume_unique``
    declares that every valid point has a voxel of its own (Plenoxel grids
    without warping augmentation): the averaging is skipped, and a violated
    declaration NaN-poisons the features instead of merging silently.
    """
    n = field.capacity
    dev = field.coords.device
    vox = torch.floor(field.coords[:, 1:] / voxel_size).to(torch.int32)
    coords = torch.cat([field.coords[:, :1].to(torch.int32), vox], 1)
    hi, lo = packing.pack(coords, field.mask)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    s_hi, s_lo, s_idx = packing.sort_with_payload(hi, lo, idx)
    s_idx_l = s_idx.long()
    s_valid = s_hi != packing.INVALID_KEY
    if assume_unique:
        dup = (s_hi[1:] == s_hi[:-1]) & (s_lo[1:] == s_lo[:-1]) & s_valid[1:]
        poison = torch.where(dup.any(), float("nan"), 1.0).to(
            field.feats.dtype
        )
        sv = SparseVoxels(
            coords=coords[s_idx_l],
            feats=field.feats[s_idx_l] * poison,
            mask=s_valid,
            stride=1,
        )
        p2v = torch.zeros(n, dtype=torch.int32, device=dev)
        p2v[s_idx_l] = idx
        return sv, p2v
    first = packing.unique_first_occurrence(s_hi, s_lo, s_valid)
    slot = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_unique = first.sum()
    slot = torch.where(s_valid, slot, n - 1)
    out_mask = idx < num_unique
    # run sums from cumulative sums over the sorted rows: run u spanning
    # sorted rows [i, e] sums to csum[e] - csum[i - 1]
    s_feats = torch.where(s_valid[:, None], field.feats[s_idx_l], 0)
    csum = torch.cumsum(s_feats.to(torch.float32), 0)
    ccnt = torch.cumsum(s_valid.to(torch.int32), 0, dtype=torch.int32)
    pos_next = torch.cat(
        [torch.where(first, idx, n)[1:], torch.full((1,), n, device=dev,
                                                    dtype=torch.int32)]
    )
    next_first = torch.flip(torch.cummin(torch.flip(pos_next, [0]), 0).values,
                            [0])
    end_pos = (next_first - 1).clamp(0, n - 1).long()
    csum_prev = torch.cat([csum.new_zeros((1, csum.shape[1])), csum[:-1]])
    ccnt_prev = torch.cat([ccnt.new_zeros((1,)), ccnt[:-1]])
    run_sum = csum[end_pos] - csum_prev
    run_cnt = torch.clamp(ccnt[end_pos] - ccnt_prev, min=1)
    avg = (run_sum / run_cnt[:, None]).to(field.feats.dtype)
    scatter_to = torch.where(first, slot, n)
    sv = SparseVoxels(
        coords=_scatter_rows(n, coords[s_idx_l], scatter_to),
        feats=_scatter_rows(n, avg, scatter_to),
        mask=out_mask,
        stride=1,
    )
    row_to_unique = torch.zeros(n, dtype=torch.int32, device=dev)
    row_to_unique[s_idx_l] = slot
    return sv, row_to_unique


def sparse_to_field(sv: SparseVoxels, field: PointField, point_to_voxel):
    """Gather voxel features back onto the original points (``.slice()``);
    ``point_to_voxel=None`` marks the identity map."""
    if point_to_voxel is None:
        feats = torch.where(field.mask[:, None], sv.feats, 0)
        return PointField(coords=field.coords, feats=feats, mask=field.mask)
    feats_ext = torch.cat([sv.feats, sv.feats.new_zeros((1, sv.num_channels))])
    idx = torch.where(field.mask, point_to_voxel, sv.capacity).long()
    return PointField(coords=field.coords, feats=feats_ext[idx],
                      mask=field.mask)
