"""Synthetic PeRFception-ScanNet-like scenes and fixed-capacity collation
(numpy; the port's own copies of ``nerf_downstream_tpu/data/plenoxel.py::
make_synthetic_scene`` and ``nerf_downstream_tpu/data/utils.py::
collate_mink``, per-point labels only)."""

from __future__ import annotations

import numpy as np


def make_synthetic_scene(rng, n_voxels=500, reso=(128, 128, 128),
                         with_labels=False, num_classes=20,
                         surface: bool = False):
    """A random scene in the Plenoxel npz schema: coords, density, 27 SH
    coefficients (+ labels, dists).

    ``surface=True`` samples a contiguous ellipsoid-shell band cropped to a
    spherical cap (the locally dense structure of real reconstructions);
    the default scatters voxels uniformly.
    """
    reso = np.asarray(reso)
    total = int(np.prod(reso))
    if surface:
        center = reso / 2
        radii = reso * rng.uniform(0.25, 0.45, 3)
        lo = np.maximum(np.floor(center - radii - 3).astype(int), 0)
        hi = np.minimum(np.ceil(center + radii + 3).astype(int), reso - 1)
        gx, gy, gz = np.meshgrid(
            np.arange(lo[0], hi[0] + 1),
            np.arange(lo[1], hi[1] + 1),
            np.arange(lo[2], hi[2] + 1),
            indexing="ij",
        )
        p = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
        rel = (p + 0.5 - center) / radii
        f = np.sqrt((rel**2).sum(1))
        band = np.abs(f - 1.0) * radii.min() < 1.2
        pb = p[band].astype(np.int64)
        if len(pb) > n_voxels:
            u = rng.standard_normal(3)
            u /= np.linalg.norm(u)
            d = (pb + 0.5 - center) @ u
            pb = pb[np.argsort(-d)[:n_voxels]]
        lin = np.unique((pb[:, 0] * reso[1] + pb[:, 1]) * reso[2] + pb[:, 2])
        if len(lin) < n_voxels:  # small shell: top up with floaters
            extra = rng.choice(total, n_voxels - len(lin), replace=False)
            lin = np.unique(np.concatenate([lin, extra]))[:n_voxels]
    else:
        lin = rng.choice(total, size=n_voxels, replace=False)
    coords = np.stack(
        [lin // (reso[1] * reso[2]), (lin % (reso[1] * reso[2])) // reso[2],
         lin % reso[2]], axis=1,
    ).astype(np.int64)
    n_voxels = len(coords)
    density = rng.normal(size=(n_voxels, 1)).astype(np.float32)
    sh = rng.normal(size=(n_voxels, 27)).astype(np.float32)
    out = dict(coords=coords, density=density, sh=sh, reso=reso)
    if with_labels:
        out["labels"] = rng.integers(0, num_classes, n_voxels).astype(np.int32)
        out["dists"] = rng.uniform(0, 0.1, n_voxels).astype(np.float16)
    return out


def collate_mink(samples: list[dict], capacity: int,
                 ignore_label: int = -100,
                 grid_extent: int | None = None) -> dict:
    """Concatenate per-scene samples (batch index prepended) and pad to a
    fixed ``capacity``: {coordinates f32[cap, 4], features f32[cap, C],
    mask bool[cap], labels i32[cap] (padding = ignore_label), num_points}.
    ``grid_extent`` rejects scenes whose coordinate span reaches it."""
    coords_rows, feats_rows, labels = [], [], []
    for b, s in enumerate(samples):
        c = np.asarray(s["coordinates"], np.float32)
        if grid_extent is not None and len(c):
            span = float((c.max(0) - c.min(0)).max())
            if span >= grid_extent:
                raise ValueError(
                    f"scene {b} coordinate span {span:.0f} exceeds the grid "
                    f"extent {grid_extent}"
                )
        coords_rows.append(
            np.concatenate([np.full((len(c), 1), b, np.float32), c], 1)
        )
        feats_rows.append(np.asarray(s["features"], np.float32))
        labels.append(np.asarray(s["labels"]).reshape(-1).astype(np.int32))
    coords = np.concatenate(coords_rows, 0)
    feats = np.concatenate(feats_rows, 0)
    total = len(coords)
    if total > capacity:
        raise ValueError(f"batch has {total} points > capacity {capacity}")
    out_coords = np.zeros((capacity, 4), np.float32)
    out_feats = np.zeros((capacity, feats.shape[1]), np.float32)
    out_labels = np.full(capacity, ignore_label, np.int32)
    mask = np.zeros(capacity, bool)
    out_coords[:total] = coords
    out_feats[:total] = feats
    out_labels[:total] = np.concatenate(labels, 0)
    mask[:total] = True
    return {
        "coordinates": out_coords,
        "features": out_feats,
        "mask": mask,
        "labels": out_labels,
        "num_points": np.int32(total),
    }


def scene_sample(rng, n_voxels: int, num_classes: int) -> dict:
    """One collate sample as the repo's serving benchmark builds it: a
    128^3 surface scene with its 27 SH-derived input channels."""
    sc = make_synthetic_scene(rng, n_voxels=n_voxels, reso=(128, 128, 128),
                              with_labels=True, num_classes=num_classes,
                              surface=True)
    return {
        "coordinates": sc["coords"].astype(np.float32),
        "features": np.concatenate([sc["density"], sc["sh"]], 1)[:, 1:28]
        .astype(np.float32),
        "labels": sc["labels"],
    }
