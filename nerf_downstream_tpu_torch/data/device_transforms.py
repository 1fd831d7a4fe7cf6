"""Augmentations that run on the device inside the training step
(counterpart of ``nerf_downstream_tpu/data/device_transforms.py``).

Each transform keeps its random draws apart from its arithmetic:
``draw(batch, generator)`` returns the uniform and normal numbers it needs
from an explicit ``torch.Generator``, and ``apply(batch, draws)`` is
deterministic, so the same numbers can be fed to this package and to the
reference. ``t(batch, generator)`` does both. ``jax.random`` and
``torch.Generator`` give different numbers from one seed, so the two
packages agree in distribution, not draw for draw.

Semantics are the reference's (host twins in its ``data/transforms.py``):
per-scene application gates, the same noise shapes, and the same defaults,
kept here as the port's own copy. Every capacity guard NaN-poisons: a
scene wider than ElasticDistortion's static noise grid turns the
coordinates to NaN, which the level guards carry to the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# per-scene gate table size: scene ids come from coords[:, 0]
_MAX_SCENES = 1024


def _scene_ids(coords: torch.Tensor, n: int) -> torch.Tensor:
    return coords[:, 0].to(torch.int64).clamp(0, n - 1)


class _Transform:
    """``t(batch, generator)`` draws, then applies."""

    def __call__(self, batch: dict, gen: torch.Generator) -> dict:
        return self.apply(batch, self.draw(batch, gen))


@dataclasses.dataclass
class RandomFeatureJitter(_Transform):
    """feats[:, s:s+fd] += (randn - 0.5) * std on the valid rows of the
    scenes whose gate opens (probability ``application_ratio``); the slice
    is clamped to the feature width."""

    std: float = 0.01
    application_ratio: float = 0.9
    start_ind: int = 4
    feature_dim: int = 27

    def _width(self, feats) -> int:
        return min(self.start_ind + self.feature_dim, feats.shape[1]) - \
            self.start_ind

    def draw(self, batch: dict, gen: torch.Generator) -> dict:
        feats = batch["features"]
        dev = feats.device
        return {
            "gate": torch.rand(_MAX_SCENES, generator=gen, device=dev),
            "noise": torch.randn((feats.shape[0], max(self._width(feats), 0)),
                                 generator=gen, device=dev),
        }

    def apply(self, batch: dict, draws: dict) -> dict:
        feats = batch["features"]
        s, w = self.start_ind, self._width(feats)
        if w <= 0:
            return batch
        gate = draws["gate"] < self.application_ratio
        on = (gate[_scene_ids(batch["coordinates"], _MAX_SCENES)]
              & batch["mask"]).to(feats.dtype)[:, None]
        noise = (draws["noise"] - 0.5) * self.std
        out = feats.clone()
        out[:, s:s + w] = feats[:, s:s + w] + noise.to(feats.dtype) * on
        return dict(batch, features=out)


@dataclasses.dataclass
class ChromaticTranslation(_Transform):
    """One RGB shift per scene, uniform in +-255 * ``trans_range_ratio``,
    on the scenes whose gate opens; colours clipped to [0, 255]."""

    trans_range_ratio: float = 0.1
    application_ratio: float = 0.9

    def draw(self, batch: dict, gen: torch.Generator) -> dict:
        dev = batch["features"].device
        return {"gate": torch.rand(_MAX_SCENES, generator=gen, device=dev),
                "shift": torch.rand((_MAX_SCENES, 3), generator=gen,
                                    device=dev)}

    def apply(self, batch: dict, draws: dict) -> dict:
        feats = batch["features"]
        gate = draws["gate"] < self.application_ratio
        tr = (draws["shift"] - 0.5) * (255 * 2 * self.trans_range_ratio)
        bidx = _scene_ids(batch["coordinates"], _MAX_SCENES)
        on = (gate[bidx] & batch["mask"]).to(feats.dtype)[:, None]
        rgb = torch.clamp(feats[:, :3] + tr[bidx].to(feats.dtype) * on,
                          0, 255)
        out = feats.clone()
        out[:, :3] = torch.where(on > 0, rgb, feats[:, :3])
        return dict(batch, features=out)


def masked_box_blur(noise: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Per-scene grids ``noise`` [S, d, d, d, 3] with the cells at and past
    each scene's ``dims`` [S, 3] zeroed, then blurred twice by a separable
    zero-padded 3-tap box, re-masked after every pass (the host blur's
    zero padding sits at each scene's own boundary)."""
    d = noise.shape[1]
    ar = torch.arange(d, device=noise.device)
    mask = ((ar[None, :, None, None] < dims[:, 0, None, None, None])
            & (ar[None, None, :, None] < dims[:, 1, None, None, None])
            & (ar[None, None, None, :] < dims[:, 2, None, None, None])
            )[..., None].to(noise.dtype)
    noise = noise * mask
    for _ in range(2):
        for ax in (1, 2, 3):
            zero = torch.zeros_like(noise.narrow(ax, 0, 1))
            lo = torch.cat([zero, noise.narrow(ax, 0, d - 1)], ax)
            hi = torch.cat([noise.narrow(ax, 1, d - 1), zero], ax)
            noise = (lo + noise + hi) * np.float32(1.0 / 3.0) * mask
    return noise


def trilinear_scenes(noise: torch.Tensor, sidx: torch.Tensor,
                     gpos: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of per-scene grids ``noise`` [S, d, d, d, 3]
    at grid positions ``gpos`` [N, 3] of scenes ``sidx`` [N]; the lower
    corner is clamped to [0, d - 2], so a point on the upper boundary takes
    the last cell with weight 1."""
    d = noise.shape[1]
    i0 = torch.floor(gpos).to(torch.int64).clamp(0, d - 2)
    f = gpos - i0
    disp = torch.zeros_like(gpos)
    for dx in (0, 1):
        wx = f[:, 0:1] if dx else 1 - f[:, 0:1]
        for dy in (0, 1):
            wy = f[:, 1:2] if dy else 1 - f[:, 1:2]
            zed = torch.zeros_like(gpos)
            for dz in (0, 1):
                wz = f[:, 2:3] if dz else 1 - f[:, 2:3]
                zed = zed + wz * noise[sidx, i0[:, 0] + dx, i0[:, 1] + dy,
                                       i0[:, 2] + dz]
            disp = disp + (wx * wy) * zed
    return disp


@dataclasses.dataclass
class ElasticDistortion(_Transform):
    """Blurred noise-grid displacement per scene, for each (granularity,
    magnitude) of ``distortion_params`` in turn, on the scenes whose gate
    opens. The noise lattice is anchored at the scene's ``coords_min -
    granularity``; the device grid is a static cube of ``max_extent //
    granularity + 3`` cells, zeroed past each scene's own dims before
    blurring. A gated scene wider than the grid poisons every coordinate
    with NaN."""

    distortion_params: tuple = ((4, 16), (8, 24))
    application_ratio: float = 0.9
    max_extent: float | None = None
    num_scenes: int | None = None

    def _grid(self, granularity) -> int:
        if self.max_extent is None:
            raise ValueError("ElasticDistortion on the device needs "
                             "max_extent, the static noise-grid bound")
        return int(np.floor(float(self.max_extent) / float(granularity))) + 3

    def draw(self, batch: dict, gen: torch.Generator) -> dict:
        if self.num_scenes is None:
            raise ValueError("ElasticDistortion on the device needs the "
                             "scene count (num_scenes)")
        dev = batch["coordinates"].device
        s = int(self.num_scenes)
        return {
            "gate": torch.rand(s, generator=gen, device=dev),
            "noise": [torch.randn((s, *(self._grid(g),) * 3, 3),
                                  generator=gen, device=dev)
                      for g, _ in self.distortion_params],
        }

    def apply(self, batch: dict, draws: dict) -> dict:
        coords, mask = batch["coordinates"], batch["mask"]
        s = int(self.num_scenes)
        sidx = _scene_ids(coords, s)
        xyz = coords[:, 1:4].to(torch.float32)
        gate = draws["gate"] < self.application_ratio
        inf = torch.tensor(float("inf"), device=xyz.device)
        for (granularity, magnitude), noise in zip(self.distortion_params,
                                                   draws["noise"]):
            g = float(granularity)
            d = self._grid(granularity)
            # per-scene bounds over the valid rows, recomputed per pass
            seg = sidx[:, None].expand(-1, 3)
            cmin = torch.full((s, 3), float("inf"), device=xyz.device)
            cmin = cmin.scatter_reduce(
                0, seg, torch.where(mask[:, None], xyz, inf), "amin")
            cmax = torch.full((s, 3), -float("inf"), device=xyz.device)
            cmax = cmax.scatter_reduce(
                0, seg, torch.where(mask[:, None], xyz, -inf), "amax")
            cmin = torch.where(torch.isfinite(cmin), cmin, 0.0)
            cmax = torch.where(torch.isfinite(cmax), cmax, 0.0)
            dims = torch.floor((cmax - cmin) / g).to(torch.int32) + 3
            noise = masked_box_blur(noise, dims)
            gpos = (xyz - (cmin[sidx] - g)) / g
            overflow = ((dims > d) & gate[:, None]).any()
            disp = trilinear_scenes(noise, sidx, gpos)
            on = (gate[sidx] & mask).to(torch.float32)[:, None]
            xyz = xyz + disp * np.float32(magnitude) * on
            xyz = torch.where(overflow, float("nan"), xyz)
        return dict(batch, coordinates=torch.cat(
            [coords[:, :1], xyz.to(coords.dtype)], 1))


DEVICE_CAPABLE = {
    "RandomFeatureJitter": RandomFeatureJitter,
    "ChromaticTranslation": ChromaticTranslation,
    "ElasticDistortion": ElasticDistortion,
}


def configured_names() -> tuple:
    """The ``train.device_transforms`` binding (empty when unbound)."""
    from nerf_downstream_tpu_torch import config as cfg

    names = cfg.query_parameter("train.device_transforms", default=())
    return tuple(names or ())


def configured_params(names: Sequence[str]) -> dict:
    """Each named transform's parameters as the gin configuration binds
    them for its host twin (``data/transforms.py``), as the reference's
    device transforms take theirs: {name: {field: value}}."""
    from nerf_downstream_tpu_torch.data import transforms as T

    out = {}
    for name in names:
        host = T.TRANSFORMS[name]()
        out[name] = {f.name: getattr(host, f.name)
                     for f in dataclasses.fields(DEVICE_CAPABLE[name])
                     if hasattr(host, f.name)}
    return out


def build(names: Sequence[str], num_scenes: int | None = None,
          params: dict | None = None):
    """fn(batch, generator) -> batch applying the named transforms in
    order, or None for an empty list. ``params`` maps a transform's name to
    keyword overrides of its defaults; ``num_scenes`` is the batch's scene
    count (ElasticDistortion allocates one noise grid per scene)."""
    names = tuple(names or ())
    if not names:
        return None
    unknown = [n for n in names if n not in DEVICE_CAPABLE]
    if unknown:
        raise ValueError(f"transforms not device-capable: {unknown} "
                         f"(supported: {sorted(DEVICE_CAPABLE)})")
    params = dict(params or {})
    fns = []
    for name in names:
        kw = dict(params.get(name, {}))
        if name == "ElasticDistortion":
            kw.setdefault("num_scenes", num_scenes)
        fns.append(DEVICE_CAPABLE[name](**kw))

    def apply(batch: dict, gen: torch.Generator) -> dict:
        for fn in fns:
            batch = fn(batch, gen)
        return batch

    apply.transforms = tuple(fns)
    return apply
