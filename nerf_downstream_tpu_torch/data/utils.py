"""Collate functions: fixed-capacity sparse batching (counterpart of
``nerf_downstream_tpu/data/utils.py``; the sharded collate waits for the
multi-GPU trainer, ROADMAP.md Queue 1 item 4).

The reference collates with ME.utils.sparse_collate (prepend batch index,
concat label/dists keys, pass metadata through — src/data/utils.py:25-50).
The TPU version does the same concat, then pads to a *static capacity* so
XLA compiles once per bucket: capacities are rounded up to the next power of
two (or a fixed ``capacity``), padding rows are masked out, per-point labels
pad with the ignore label.
"""

from __future__ import annotations

import numpy as np


def next_bucket(n: int, min_capacity: int = 1024) -> int:
    cap = min_capacity
    while cap < n:
        cap *= 2
    return cap


_CONFIGURED = object()


def _configured_grid_extent():
    from nerf_downstream_tpu_torch import config as cfg

    try:
        return cfg.query_parameter(
            "CoordinateContext.grid_extent", default=None
        )
    except Exception:
        return None


def collate_mink(
    samples: list[dict],
    capacity: int | None = None,
    ignore_label: int = -100,
    min_capacity: int = 1024,
    pad_to_batch: int | None = None,
    grid_extent=_CONFIGURED,
) -> dict:
    """Batch sample dicts -> fixed-capacity arrays.

    Returns {coordinates f32[cap,4], features f32[cap,C], mask bool[cap],
    labels i32[cap] (per-point) or i32[B] (per-sample), num_points,
    metadata list, [dists f32[cap,1]]}. A sample whose coordinate span
    reaches ``grid_extent`` raises; by default the extent is the
    ``CoordinateContext.grid_extent`` binding (None: no check).
    """
    coords_rows, feats_rows, dists_rows = [], [], []
    point_labels, sample_labels = [], []
    metadata = []
    has_dists = "dists" in samples[0]
    # per-point vs per-sample labels, decided on the first sample with rows
    # (zero-row pad samples from the sharded collate are uninformative)
    per_point = None
    for s in samples:
        n = len(s["coordinates"])
        if n > 0:
            per_point = len(np.asarray(s["labels"]).reshape(-1)) == n and n > 1
            break
    extent = (_configured_grid_extent() if grid_extent is _CONFIGURED
              else grid_extent)
    for b, s in enumerate(samples):
        c = np.asarray(s["coordinates"], np.float32)
        if extent is not None and len(c):
            # the dense-grid kernel-map builder silently treats neighbors
            # outside grid_extent as missing (kernels.build_grid_index
            # in_bounds filter) — fail loudly at batch build instead
            span = c.max(0) - c.min(0)
            if float(span.max()) >= extent:
                raise ValueError(
                    f"sample {s.get('metadata', {})} coordinate span "
                    f"{span.max():.0f} exceeds CoordinateContext.grid_extent="
                    f"{extent}; raise the binding for this dataset or "
                    "downsample — out-of-extent voxels would silently lose "
                    "their conv neighbors"
                )
        n = len(c)
        coords_rows.append(
            np.concatenate([np.full((n, 1), b, np.float32), c], axis=1)
        )
        feats_rows.append(np.asarray(s["features"], np.float32))
        lab = np.asarray(s["labels"]).reshape(-1)
        if per_point:
            point_labels.append(lab.astype(np.int32))
        else:
            sample_labels.append(int(lab[0]) if len(lab) else 0)
        if has_dists:
            dists_rows.append(np.asarray(s["dists"], np.float32).reshape(n, -1))
        metadata.append(s.get("metadata", {}))

    coords = np.concatenate(coords_rows, 0)
    feats = np.concatenate(feats_rows, 0)
    total = len(coords)
    cap = capacity or next_bucket(total, min_capacity)
    if total > cap:
        raise ValueError(
            f"batch has {total} points > capacity {cap}; raise capacity or "
            f"subsample upstream"
        )
    out_coords = np.zeros((cap, 4), np.float32)
    out_feats = np.zeros((cap, feats.shape[1]), np.float32)
    mask = np.zeros(cap, bool)
    out_coords[:total] = coords
    out_feats[:total] = feats
    mask[:total] = True
    batch = {
        "coordinates": out_coords,
        "features": out_feats,
        "mask": mask,
        "num_points": np.int32(total),
        "metadata": metadata,
    }
    if per_point:
        lab = np.concatenate(point_labels, 0)
        out_lab = np.full(cap, ignore_label, np.int32)
        out_lab[:total] = lab
        batch["labels"] = out_lab
    else:
        labs = np.asarray(sample_labels, np.int32)
        b = len(labs)
        if pad_to_batch and pad_to_batch > b:
            # pad ragged final val batches to a static sample count; padded
            # rows are masked out of metrics via sample_mask
            labs = np.concatenate([labs, np.zeros(pad_to_batch - b, np.int32)])
            batch["sample_mask"] = np.arange(pad_to_batch) < b
        batch["labels"] = labs
    if has_dists:
        d = np.concatenate(dists_rows, 0)
        out_d = np.zeros((cap, d.shape[1]), np.float32)
        out_d[:total] = d
        batch["dists"] = out_d
    return batch


def collate_pointnet(samples: list[dict]) -> dict:
    """Dense stacking for fixed-size point clouds (utils.py:53-73)."""
    ns = {len(s["coordinates"]) for s in samples}
    assert len(ns) == 1, f"pointnet collate requires equal N, got {ns}"
    return {
        "coordinates": np.stack(
            [np.asarray(s["coordinates"], np.float32) for s in samples]
        ),
        "features": np.stack(
            [np.asarray(s["features"], np.float32) for s in samples]
        ),
        "labels": np.asarray(
            [np.asarray(s["labels"]).reshape(-1)[0] for s in samples], np.int32
        ),
        "metadata": [s.get("metadata", {}) for s in samples],
    }


def collate_pair(
    samples: list[dict], capacity: int | None = None, min_capacity: int = 1024
) -> dict:
    """Registration pairs with correspondence index offsetting
    (utils.py:76-131): each sample has coords0/coords1/feats0/feats1/matches."""
    out = {}
    for side in (0, 1):
        rows, frows = [], []
        for b, s in enumerate(samples):
            c = np.asarray(s[f"coordinates{side}"], np.float32)
            rows.append(
                np.concatenate([np.full((len(c), 1), b, np.float32), c], 1)
            )
            frows.append(np.asarray(s[f"features{side}"], np.float32))
        coords = np.concatenate(rows, 0)
        feats = np.concatenate(frows, 0)
        cap = capacity or next_bucket(len(coords), min_capacity)
        oc = np.zeros((cap, 4), np.float32)
        of = np.zeros((cap, feats.shape[1]), np.float32)
        m = np.zeros(cap, bool)
        oc[: len(coords)] = coords
        of[: len(feats)] = feats
        m[: len(coords)] = True
        out[f"coordinates{side}"] = oc
        out[f"features{side}"] = of
        out[f"mask{side}"] = m
    # offset per-sample correspondence indices into the concatenated rows
    if "matches" in samples[0]:
        matches, off0, off1 = [], 0, 0
        for s in samples:
            m = np.asarray(s["matches"], np.int64)
            matches.append(m + np.array([[off0, off1]]))
            off0 += len(s["coordinates0"])
            off1 += len(s["coordinates1"])
        out["matches"] = np.concatenate(matches, 0)
    return out


COLLATE_FNS = {
    "collate_mink": collate_mink,
    "collate_pair": collate_pair,
    "collate_pointnet": collate_pointnet,
}
