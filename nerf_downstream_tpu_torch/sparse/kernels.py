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

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.ops.consts import const
from nerf_downstream_tpu_torch.ops.scatter import gather_rows
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


def build_grid_index(coords: torch.Tensor, mask: torch.Tensor,
                     num_batches: int, extent: int, stride: int):
    """Dense per-batch lookup grid of a coordinate set:
    grid[b, x, y, z] = row index (or N), flattened to [B * E^3], with
    coordinates taken relative to each batch element's min corner and
    cells of size ``stride`` covering ``extent`` finest units per axis.
    Kernel maps against this set are then single gathers.

    Returns (grid int32[B * E^3], origin int32[B, 3]).
    """
    n = coords.shape[0]
    dev = coords.device
    e = max(extent // stride, 1)
    b = coords[:, 0].to(torch.int64)
    b_ids = torch.where(mask & (b >= 0) & (b < num_batches), b, num_batches)
    big = 1 << 30
    xyz = coords[:, 1:].to(torch.int64)
    masked_xyz = torch.where(mask[:, None], xyz, big)
    origin = torch.full((num_batches + 1, 3), big, dtype=torch.int64,
                        device=dev).scatter_reduce(
        0, b_ids[:, None].expand(n, 3), masked_xyz, "amin")[:num_batches]
    origin = torch.where(origin == big, 0, origin)
    bc = b_ids.clamp(0, num_batches - 1)
    rel = torch.div(xyz - origin[bc], stride, rounding_mode="floor")
    in_bounds = mask & ((rel >= 0) & (rel < e)).all(1)
    flat = bc * (e * e * e) + rel[:, 0] * (e * e) + rel[:, 1] * e + rel[:, 2]
    flat = torch.where(in_bounds, flat, num_batches * e * e * e)
    grid = torch.full((num_batches * e * e * e + 1,), n, dtype=torch.int32,
                      device=dev)
    grid[flat] = torch.arange(n, dtype=torch.int32, device=dev)
    return grid[:-1], origin.to(torch.int32)


def lookup_grid(grid, origin, num_batches: int, extent: int, stride: int,
                q_coords: torch.Tensor, q_mask: torch.Tensor, n_in: int):
    """Exact lookup of query coords in a grid index; missing or out of the
    grid -> ``n_in``."""
    e = max(extent // stride, 1)
    q = q_coords.to(torch.int64)
    b_ids = q[:, 0].clamp(0, num_batches - 1)
    delta = q[:, 1:] - origin.to(torch.int64)[b_ids]
    rel = torch.div(delta, stride, rounding_mode="floor")
    in_bounds = q_mask & ((rel >= 0) & (rel < e)).all(1)
    if stride > 1:
        # cells are stride-sized: only exact multiples are coordinates
        in_bounds = in_bounds & (torch.remainder(delta, stride) == 0).all(1)
    flat = b_ids * (e * e * e) + rel[:, 0] * (e * e) + rel[:, 1] * e + rel[:, 2]
    rows = grid[flat.clamp(0, grid.shape[0] - 1)]
    return torch.where(in_bounds, rows, n_in).to(torch.int32)


def _map_queries(out_coords, out_mask, offsets, transpose: bool):
    """[K * N_out, 4] query coordinates (output coordinate + offset, or -
    offset for a transposed map) and their mask."""
    offs = np.asarray(offsets)
    offs = const(-offs if transpose else offs, torch.int32,
                 out_coords.device)
    k, n_out = offs.shape[0], out_coords.shape[0]
    q_xyz = out_coords[None, :, 1:].to(torch.int32) + offs[:, None, :]
    q = torch.cat([out_coords[None, :, :1].to(torch.int32).expand(k, n_out, 1),
                   q_xyz], -1).reshape(-1, 4)
    q_mask = out_mask[None, :].expand(k, n_out).reshape(-1)
    return q, q_mask


def build_kernel_map_grid(grid, origin, num_batches: int, extent: int,
                          in_stride: int, n_in: int, out_coords, out_mask,
                          offsets, transpose: bool = False) -> torch.Tensor:
    """Kernel map int32[K, N_out] through the dense grid index: one gather
    for all K offsets; missing entries = ``n_in``."""
    q, q_mask = _map_queries(out_coords, out_mask, offsets, transpose)
    rows = lookup_grid(grid, origin, num_batches, extent, in_stride, q,
                       q_mask, n_in)
    return rows.reshape(len(offsets), out_coords.shape[0])


def build_kernel_map(in_coords, in_mask, out_coords, out_mask, offsets,
                     transpose: bool = False) -> torch.Tensor:
    """Neighbour index table int32[K, N_out] by sort and binary search
    (no extent needed); missing entries = N_in.

    The input neighbour of output voxel ``o`` at offset ``d`` sits at
    ``o + d``; for a transposed conv the relation is ``o - d``.
    """
    q, q_mask = _map_queries(out_coords, out_mask, offsets, transpose)
    rows = lookup_rows(sorted_rows(in_coords, in_mask), q, q_mask)
    return rows.reshape(len(offsets), out_coords.shape[0])


@cfg.configurable("field_to_sparse")
def field_to_sparse(
    field: PointField, voxel_size: float = 1.0, assume_unique: bool = False
):
    """Quantize a PointField into SparseVoxels, averaging duplicate points.

    Returns (SparseVoxels, point_to_voxel int32[N]). Each voxel's mean is
    a sum of its own points (a segmented scan within its run of sorted
    rows), not the reference's difference of running sums over all the
    sorted rows, whose f32 error grows with the running sum (about 5e-5
    of the largest mean on a ScanNet batch of 2,000 points) and moves
    with any change of its inputs (ROADMAP Queue 3). The port's means
    are the same on the card and on the CPU. ``assume_unique``
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
    # each run's own sum: a segmented scan over the sorted rows by
    # doubling (ceil(log2 n) shifted adds within runs, in one fixed order
    # on every device), read at the run's last row; the reference's
    # differences of running sums over all the rows carry about 2^-24 x
    # the running sum instead
    f32 = torch.float32
    run = torch.where(s_valid, slot, -1)
    total = torch.where(s_valid[:, None], field.feats[s_idx_l].to(f32), 0.0)
    count = s_valid.to(f32)
    d = 1
    while d < n:
        same = (run[d:] == run[:-d])[:, None]
        total = torch.cat([total[:d], total[d:] + torch.where(
            same, total[:-d], 0.0)])
        count = torch.cat([count[:d], count[d:] + torch.where(
            same[:, 0], count[:-d], 0.0)])
        d *= 2
    last = s_valid & torch.cat([run[1:] != run[:-1],
                                torch.ones(1, dtype=torch.bool, device=dev)])
    avg = (total / torch.clamp(count, min=1.0)[:, None]).to(field.feats.dtype)
    avg = _scatter_rows(n, avg, torch.where(last, slot, n))
    scatter_to = torch.where(first, slot, n)
    sv = SparseVoxels(
        coords=_scatter_rows(n, coords[s_idx_l], scatter_to),
        feats=avg,
        mask=out_mask,
        stride=1,
    )
    row_to_unique = torch.zeros(n, dtype=torch.int32, device=dev)
    row_to_unique[s_idx_l] = slot
    return sv, row_to_unique


def sorted_rows(coords: torch.Tensor, mask: torch.Tensor):
    """The packed-key table of a coordinate set for lookups: (sorted hi,
    sorted lo, the row index of each sorted key with the sentinel ``N``
    appended)."""
    n = coords.shape[0]
    dev = coords.device
    hi, lo = packing.pack(coords, mask)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    s_hi, s_lo, s_idx = packing.sort_with_payload(hi, lo, idx)
    s_idx_ext = torch.cat([s_idx, torch.full((1,), n, dtype=torch.int32,
                                             device=dev)])
    return s_hi, s_lo, s_idx_ext


def lookup_rows(table, q_coords: torch.Tensor, q_mask: torch.Tensor):
    """Row of each query coordinate in a ``sorted_rows`` table, or ``N``
    (the table's size) where it has none."""
    s_hi, s_lo, s_idx_ext = table
    n = s_hi.shape[0]
    q_hi, q_lo = packing.pack(q_coords, q_mask)
    pos = packing.find(s_hi, s_lo, q_hi, q_lo, missing=n)
    return s_idx_ext[pos.long()]


def slice_field(sv: SparseVoxels, field: PointField) -> PointField:
    """``SparseTensor.slice(tensor_field)`` at any tensor stride: each
    point gathers the features of the voxel enclosing it at ``sv.stride``,
    ``floor(coords / stride) * stride`` (floor division, so negative
    coordinates fall into the voxel below), or zeros where that voxel is
    not in ``sv``."""
    vox = torch.floor(field.coords[:, 1:] / sv.stride).to(torch.int32) \
        * sv.stride
    q = torch.cat([field.coords[:, :1].to(torch.int32), vox], 1)
    rows = lookup_rows(sorted_rows(sv.coords, sv.mask), q, field.mask)
    feats_ext = torch.cat([sv.feats, sv.feats.new_zeros((1, sv.num_channels))])
    return PointField(coords=field.coords, feats=gather_rows(feats_ext, rows),
                      mask=field.mask)


def sparse_to_field(sv: SparseVoxels, field: PointField, point_to_voxel):
    """Gather voxel features back onto the original points (``.slice()``);
    ``point_to_voxel=None`` marks the identity map."""
    if point_to_voxel is None:
        feats = torch.where(field.mask[:, None], sv.feats, 0)
        return PointField(coords=field.coords, feats=feats, mask=field.mask)
    feats_ext = torch.cat([sv.feats, sv.feats.new_zeros((1, sv.num_channels))])
    idx = torch.where(field.mask, point_to_voxel, sv.capacity).long()
    return PointField(coords=field.coords, feats=gather_rows(feats_ext, idx),
                      mask=field.mask)
