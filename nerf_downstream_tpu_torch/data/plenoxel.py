"""Plenoxel checkpoint decoding (counterpart of
``nerf_downstream_tpu/data/plenoxel.py``, numpy only).

Scene data is a sparse voxel grid saved either as ``data.npz``
(links/density/sh(+quantization)/reso[/labels/dists], schema from reference
scripts/preprocess.py:49-57 and preprocess_scannet.py:164-174) or as the raw
Plenoxel ``last.ckpt`` torch checkpoint (reference co3d.py:133-162).

``links`` is the linear index into a reso[0]xreso[1]xreso[2] grid; decode to
(x, y, z) by div/mod (reference co3d.py:196-203). SH coefficients are stored
uint8-quantized; dequantize as ``sh * sh_scale + sh_min`` (co3d.py:169).
"""

from __future__ import annotations

import os

import numpy as np


def decode_links(links: np.ndarray, reso) -> np.ndarray:
    """linear link index -> (x, y, z) int32 [N, 3]."""
    links = np.asarray(links).astype(np.int64)
    r1, r2 = int(reso[1]), int(reso[2])
    x = links // (r1 * r2)
    y = (links % (r1 * r2)) // r2
    z = links % r2
    return np.stack([x, y, z], axis=1).astype(np.int32)


def load_npz(path: str) -> dict:
    """Load a preprocessed scene npz; returns dict with dequantized sh and
    pre-decoded ``coords`` (numpy; the reference's native C++ decoder is
    not ported, ROADMAP.md Queue 1 item 1). The SH dequantisation
    ``sh * sh_scale + sh_min`` is rounded once to float32, as that
    decoder's fused multiply-add does: the product of a uint8 and a float32
    and its sum with a float32 are exact in float64 at these ranges."""
    ckpt = np.load(path)
    sh = (np.asarray(ckpt["sh"]).astype(np.float64)
          * np.float64(np.float32(ckpt["sh_scale"]))
          + np.float64(np.float32(ckpt["sh_min"])))
    out = {
        "links": np.asarray(ckpt["links"]),
        "density": np.asarray(ckpt["density"], np.float32),
        "sh": sh.astype(np.float32),
    }
    out["reso"] = (
        np.asarray(ckpt["reso"]) if "reso" in ckpt else np.array([128, 128, 128])
    )
    for k in ("labels", "dists"):
        if k in ckpt:
            out[k] = np.asarray(ckpt[k])
    out["coords"] = decode_links(out["links"], out["reso"])
    return out


def load_torch_ckpt(path: str) -> dict:
    """Load a raw Plenoxel ``last.ckpt`` (256^3) via torch (CPU)."""
    import torch

    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt["state_dict"]
    sh = (
        sd["model.sh_data"].float() * ckpt["model.sh_data_scale"]
        + ckpt["model.sh_data_min"]
    )
    links = sd["model.links_idx"].numpy()
    reso = np.array([256, 256, 256])
    return {
        "links": links,
        "density": sd["model.density_data"].numpy().astype(np.float32),
        "sh": sh.numpy().astype(np.float32),
        "reso": reso,
        "coords": decode_links(links, reso),
    }


def load_scene(scene_dir: str) -> dict:
    npz = os.path.join(scene_dir, "data.npz")
    ckpt = os.path.join(scene_dir, "last.ckpt")
    if os.path.exists(npz):
        return load_npz(npz)
    if os.path.exists(ckpt):
        return load_torch_ckpt(ckpt)
    raise FileNotFoundError(f"no Plenoxel data under {scene_dir}")


def save_npz(path: str, coords: np.ndarray, density: np.ndarray,
             sh: np.ndarray, reso, labels=None, dists=None,
             quantize_sh: bool = True):
    """Write a scene npz in the reference schema (preprocess.py:49-57).
    ``coords`` are (x,y,z) voxel indices; re-encoded into linear links."""
    reso = np.asarray(reso)
    coords = np.asarray(coords, np.int64)
    links = (coords[:, 0] * reso[1] + coords[:, 1]) * reso[2] + coords[:, 2]
    sh = np.asarray(sh, np.float32)
    if quantize_sh:
        sh_min = sh.min()
        sh_scale = (sh.max() - sh_min) / 255.0 or 1.0
        sh_q = np.round((sh - sh_min) / sh_scale).astype(np.uint8)
    else:
        sh_min, sh_scale, sh_q = np.float32(0.0), np.float32(1.0), sh
    payload = dict(
        links=links,
        density=np.asarray(density, np.float32),
        sh=sh_q,
        sh_min=np.float32(sh_min),
        sh_scale=np.float32(sh_scale),
        reso=reso,
    )
    if labels is not None:
        payload["labels"] = np.asarray(labels)
    if dists is not None:
        payload["dists"] = np.asarray(dists, np.float16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **payload)


def stride_downsample(coords: np.ndarray, arrays: list, stride: int):
    """Keep rows whose coords are divisible by stride on every axis
    (downsample mode 1, reference co3d.py:122-124)."""
    sel = np.all(coords % stride == 0, axis=1)
    return coords[sel], [a[sel] for a in arrays]


def avg_downsample(coords: np.ndarray, feats: np.ndarray, stride: int):
    """Average-pool features into stride-cells (downsample mode 0; the
    reference uses ME.MinkowskiAvgPooling, co3d.py:116-121)."""
    cell = coords // stride
    key = (cell[:, 0].astype(np.int64) << 42) | (
        cell[:, 1].astype(np.int64) << 21
    ) | cell[:, 2].astype(np.int64)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    sums = np.zeros((len(uniq), feats.shape[1]), np.float64)
    np.add.at(sums, inv, feats)
    out_feats = (sums / counts[:, None]).astype(np.float32)
    rep = np.full(len(uniq), -1, np.int64)
    rep[inv[::-1]] = np.arange(len(coords))[::-1]  # first row of each cell
    out_coords = (cell[rep] * stride).astype(coords.dtype)
    return out_coords, out_feats


def make_synthetic_scene(rng, n_voxels=500, reso=(128, 128, 128),
                         with_labels=False, num_classes=20,
                         surface: bool = False):
    """Generate a random scene matching the npz schema (for tests/benches).

    ``surface=True`` samples a noisy ellipsoid shell — the locally-dense
    surface structure of real Plenoxel reconstructions (a radiance field's
    occupied voxels hug geometry), which is what locality-aware kernels see
    in production. Default stays uniform-random for worst-case tests.
    """
    reso = np.asarray(reso)
    total = int(np.prod(reso))
    if surface:
        # CONTIGUOUS ellipsoid shell band: every voxel within ~1.5 voxels
        # of the surface is occupied (a radiance field keeps the full
        # density band above threshold, not a point sample of it), cropped
        # to a spherical-cap patch around a random direction — the shape a
        # RandomCrop of a real Plenoxel-ScanNet reconstruction produces.
        # The previous sampler scattered isolated points across a fuzzy
        # shell (measured 3.5 rows per 4^3 block vs the 8-16 of real
        # shells), which misrepresents every locality-aware kernel.
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
        # |f - 1| * r_min ~ voxel distance to the surface along the
        # steepest axis; 1.2 gives a 2-3 voxel thick band
        band = np.abs(f - 1.0) * radii.min() < 1.2
        pb = p[band].astype(np.int64)
        if len(pb) > n_voxels:
            # contiguous angular crop: keep the cap closest to a random
            # direction (locally dense, like a cropped reconstruction)
            u = rng.standard_normal(3)
            u /= np.linalg.norm(u)
            d = (pb + 0.5 - center) @ u
            keep = np.argsort(-d)[:n_voxels]
            pb = pb[keep]
        lin = np.unique(
            (pb[:, 0] * reso[1] + pb[:, 1]) * reso[2] + pb[:, 2]
        )
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
