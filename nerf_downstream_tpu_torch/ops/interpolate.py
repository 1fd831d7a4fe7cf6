"""Trilinear splat and interpolation between point fields and voxel sets
(counterpart of ``nerf_downstream_tpu/ops/interpolate.py``, used by
``MinkowskiSplatFCNN``).

Each point couples to the 8 voxels at the corners of the cell that holds
it at the set's stride, ``floor(coords / stride)`` plus 0 or 1 per axis
(floor division, so negative coordinates take the cell below), with the
trilinear weights of its fractional position. ``interpolate`` gathers
voxel features onto the points; ``splat`` scatter-adds point features
onto the voxels with ``ops/scatter.add_rows`` (each row's terms in a
fixed order, on the card and on the CPU, so a step repeats bit for bit).
A corner that is not in the voxel set takes weight
0. The reference computes both with XLA ops (no Pallas kernel), so the
port computes them in plain PyTorch.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from nerf_downstream_tpu_torch.ops.consts import const
from nerf_downstream_tpu_torch.ops.scatter import add_rows, gather_rows
from nerf_downstream_tpu_torch.sparse.kernels import lookup_rows, sorted_rows
from nerf_downstream_tpu_torch.sparse.types import PointField

# the 8 corner offsets, z fastest (the reference's order)
CORNERS = np.array(list(itertools.product((0, 1), repeat=3)), np.int32)


def corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights [8, N] of fractional positions ``frac`` [N, 3]."""
    c = const(CORNERS, torch.int32, frac.device)
    w = torch.where(c[:, None, :] == 1, frac[None], 1.0 - frac[None])
    return w[..., 0] * w[..., 1] * w[..., 2]


def corner_coords(field_coords: torch.Tensor, stride: int):
    """(corner voxel coordinates [8, N, 4] with each point's batch index,
    fractional positions [N, 3] in f32) of points at ``stride``."""
    scaled = field_coords[:, 1:] / stride
    base = torch.floor(scaled).to(torch.int32)
    frac = (scaled - base.to(field_coords.dtype)).to(torch.float32)
    c = const(CORNERS, torch.int32, field_coords.device)
    corners = (base[None] + c[:, None, :]) * stride
    b = field_coords[None, :, :1].to(torch.int32).expand(8, -1, 1)
    return torch.cat([b, corners], -1), frac


def _corner_rows(table, field: PointField, stride: int):
    """(rows [8, N] of each point's corners in the voxel table, the
    table's size where absent; their weights [8, N])."""
    corners, frac = corner_coords(field.coords, stride)
    n = field.coords.shape[0]
    q_mask = field.mask[None, :].expand(8, n).reshape(-1)
    rows = lookup_rows(table, corners.reshape(-1, 4), q_mask).reshape(8, n)
    n_table = table[0].shape[0]
    weights = corner_weights(frac) * (rows < n_table).to(torch.float32)
    return rows.long(), weights


def interpolate(sv_coords: torch.Tensor, sv_mask: torch.Tensor,
                sv_feats: torch.Tensor, sv_stride: int,
                field: PointField) -> torch.Tensor:
    """Features [N, C] of the voxels (``sv_coords``, ``sv_mask``,
    ``sv_feats`` at ``sv_stride``) trilinearly interpolated at the
    field's points, summed in f32 and returned in the features' type."""
    rows, weights = _corner_rows(sorted_rows(sv_coords, sv_mask), field,
                                 sv_stride)
    feats_ext = torch.cat([sv_feats,
                           sv_feats.new_zeros((1, sv_feats.shape[1]))])
    out = (weights[..., None]
           * gather_rows(feats_ext, rows).to(torch.float32)).sum(0)
    return out.to(sv_feats.dtype)


def splat(field: PointField, out_coords: torch.Tensor,
          out_mask: torch.Tensor, out_stride: int) -> torch.Tensor:
    """The field's features [N_out, C] trilinearly scattered onto the
    voxels ``out_coords`` at ``out_stride``; padding points add nothing.
    ``out_coords`` should hold the corner voxels the points reach."""
    n_out = out_coords.shape[0]
    rows, weights = _corner_rows(sorted_rows(out_coords, out_mask), field,
                                 out_stride)
    masked = torch.where(field.mask[:, None], field.feats, 0)
    contrib = weights.reshape(-1, 1) * masked.to(torch.float32).repeat(8, 1)
    out = torch.zeros((n_out + 1, field.feats.shape[1]), dtype=torch.float32,
                      device=field.feats.device)
    out = add_rows(out, rows.reshape(-1), contrib)
    return out[:n_out].to(field.feats.dtype)
