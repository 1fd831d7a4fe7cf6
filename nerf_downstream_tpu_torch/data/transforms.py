"""Host augmentations: the gin-configurable transforms of the flagship
config's list and of every ``co3d_aug*.gin`` on (coords, feats, labels)
triples, ``Compose`` and ``build`` (counterpart of
``nerf_downstream_tpu/data/transforms.py``, the port's own copy, draw for
draw from the module's ``_rng`` stream: the same ``seed`` gives the same
arrays), with the colour transforms of ``scannet_semseg.gin``
(``ChromaticTranslation``, ``ChromaticAutoContrast``, ``ChromaticJitter``,
``NormalizeColor``, ``HueSaturationTranslation``; colours in [0, 255]).
Every transform of the reference is here, the sampling ones
(``FarthestPointSample``, ``RandomSample``, ``LabelBasedSample``) and
``PerlinNoise`` included. Rotations use the closed-form Rodrigues formula (the reference's
``scipy.expm`` matrix).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np

from nerf_downstream_tpu_torch import config as cfg

_rng = np.random.default_rng()
_local = threading.local()  # a loader thread's own generator, drawing_from


def seed(s: int):
    """Seed the transform RNG (called by seed_everything)."""
    global _rng
    _rng = np.random.default_rng(s)


def _gen() -> np.random.Generator:
    """The generator this thread draws from: its own under
    ``drawing_from``, else the module's ``_rng``."""
    own = getattr(_local, "rng", None)
    return _rng if own is None else own


@contextlib.contextmanager
def drawing_from(rng: np.random.Generator):
    """Draw this thread's transforms from ``rng`` instead of ``_rng``."""
    _local.rng = rng
    try:
        yield
    finally:
        _local.rng = None


def _rand():
    return float(_gen().random())


def _sel(coords, feats, labels, sel):
    return (
        coords[sel],
        feats if feats is None else feats[sel],
        labels if labels is None else labels[sel],
    )


@cfg.configurable
class RandomFeatureJitter:
    """Jitter a feature slice (the SH coefficients) — transforms.py:21-40.
    Keeps the reference's (randn - 0.5) * std noise shape."""

    def __init__(self, std=0.01, application_ratio=0.9, start_ind: int = 4,
                 feature_dim: int = 27):
        self.std = std
        self.application_ratio = application_ratio
        self.start_ind = start_ind
        self.feature_dim = feature_dim

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            # float32 generation: same distribution, half the RNG cost
            # (this jitter was the #2 host-side hot spot at bench scale)
            noise = (
                _gen().standard_normal(
                    (feats.shape[0], self.feature_dim), dtype=np.float32
                )
                - np.float32(0.5)
            ) * np.float32(self.std)
            feats = feats.copy()
            feats[:, self.start_ind : self.start_ind + self.feature_dim] += (
                noise.astype(feats.dtype)
            )
        return coords, feats, labels


@cfg.configurable
class ChromaticTranslation:
    """Random global color shift; colors in [0, 255]."""

    def __init__(self, translation_range_ratio=1e-1, application_ratio=0.9):
        self.trans_range_ratio = translation_range_ratio
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            tr = (_gen().random((1, 3)) - 0.5) * 255 * 2 * self.trans_range_ratio
            feats = feats.copy()
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


@cfg.configurable
class ChromaticAutoContrast:
    def __init__(self, randomize_blend_factor=True, blend_factor=0.5,
                 application_ratio=0.2):
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            assert hi.max() > 1, "colors expected in [0, 255]"
            scale = 255 / np.maximum(hi - lo, 1e-8)
            contrast = (feats[:, :3] - lo) * scale
            blend = _rand() if self.randomize_blend_factor else self.blend_factor
            feats = feats.copy()
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * contrast
        return coords, feats, labels


@cfg.configurable
class ChromaticJitter:
    def __init__(self, std=0.01, application_ratio=0.9):
        self.std = std
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            noise = _gen().standard_normal((feats.shape[0], 3)) * self.std * 255
            feats = feats.copy()
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels


@cfg.configurable
class NormalizeColor:
    def __init__(self, mean=(128, 128, 128), std=(256, 256, 256)):
        self.mean = np.array([mean], np.float32)
        self.std = np.array([std], np.float32)

    def __call__(self, coords, feats, labels):
        return coords, (feats - self.mean) / self.std, labels


def _rgb_to_hsv(rgb):
    rgb = rgb.astype(np.float64)
    hsv = np.zeros_like(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    hsv[..., 2] = maxc
    span = np.maximum(maxc - minc, 1e-12)
    hsv[..., 1] = np.where(maxc > 0, (maxc - minc) / np.maximum(maxc, 1e-12), 0)
    rc = (maxc - r) / span
    gc = (maxc - g) / span
    bc = (maxc - b) / span
    h = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc], 4.0 + gc - rc)
    hsv[..., 0] = (h / 6.0) % 1.0
    hsv[..., 0] = np.where(maxc == minc, 0.0, hsv[..., 0])
    return hsv


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int) % 6
    f = (h * 6.0) - (h * 6.0).astype(int)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb = np.empty_like(hsv)
    rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
    return rgb


@cfg.configurable
class HueSaturationTranslation:
    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, coords, feats, labels):
        hsv = _rgb_to_hsv(feats[:, :3])
        hue_val = (_rand() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (_rand() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        feats = feats.copy()
        feats[:, :3] = np.clip(_hsv_to_rgb(hsv), 0, 255)
        return coords, feats, labels


@cfg.configurable
class RandomCrop:
    """Axis-aligned random crop with a retry loop — transforms.py:194-243."""

    def __init__(self, x=200, y=200, z=200, application_ratio=1.0,
                 max_retries=10):
        assert x > 0 and y > 0 and z > 0
        self.max_size = np.array([[x, y, z]], np.float64)
        self.application_ratio = application_ratio
        self.max_retries = max_retries

    def __call__(self, coords, feats, labels):
        if _rand() > self.application_ratio:
            return coords, feats, labels
        norm = coords - coords.min(0, keepdims=True)
        coord_range = np.clip(norm.max(0, keepdims=True) - self.max_size, 0, None)
        if np.prod(coord_range == 0):
            return coords, feats, labels
        for _ in range(self.max_retries):
            lo = _gen().random((1, 3)) * coord_range
            hi = lo + self.max_size
            sel = np.all((norm > lo) & (norm < hi), axis=1)
            if sel.sum() > 0:
                return _sel(coords, feats, labels, sel)
        return coords, feats, labels


@cfg.configurable
class CoordinateDropout:
    def __init__(self, dropout_ratio=0.2, application_ratio=0.2):
        self.dropout_ratio = dropout_ratio
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            n = len(coords)
            keep = _gen().choice(n, int(n * (1 - self.dropout_ratio)),
                               replace=False)
            return _sel(coords, feats, labels, keep)
        return coords, feats, labels


@cfg.configurable
class CoordinateJitter:
    def __init__(self, jitter_std=0.5, application_ratio=0.7):
        self.jitter_std = jitter_std
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            coords = coords + (2 * self.jitter_std) * (
                _gen().random((len(coords), 3)) - 0.5
            )
        return coords, feats, labels


@cfg.configurable
class CoordinateUniformTranslation:
    def __init__(self, max_translation=0.2):
        self.max_translation = max_translation

    def __call__(self, coords, feats, labels):
        if self.max_translation > 0:
            coords = coords + _gen().uniform(
                -self.max_translation, self.max_translation, (1, 3)
            )
        return coords, feats, labels


@cfg.configurable
class RegionDropout:
    """Drop a random axis-aligned region (at most half of the points)."""

    def __init__(self, box_center_range=(100, 100, 10),
                 max_region_size=(300, 300, 300),
                 min_region_size=(100, 100, 100), application_ratio=0.3):
        self.max_region_size = np.array(max_region_size)
        self.min_region_size = np.array(min_region_size)
        self.box_range = self.max_region_size - self.min_region_size
        self.box_center_range = np.array([box_center_range])
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            for _ in range(100):
                center = self.box_center_range * (
                    _gen().random((1, 3)) - 0.5
                ) * 2 + coords.mean(0, keepdims=True)
                size = self.box_range * _gen().random((1, 3))
                lo, hi = center - size / 2, center + size / 2
                sel = ~np.all((coords < hi) & (coords > lo), axis=1)
                if sel.sum() > len(coords) * 0.5:
                    return _sel(coords, feats, labels, sel)
        return coords, feats, labels


def rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about ``axis`` by ``theta`` (== expm(cross(I,
    axis/|axis| * theta)), reference transforms.py:333-336)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


@cfg.configurable
class RandomRotation:
    """Rotation about a slightly perturbed upright axis."""

    def __init__(self, upright_axis="z", axis_std=0.01, application_ratio=0.9):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.axis_std = axis_std
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            axis = self.axis_std * _gen().standard_normal(3)
            axis[self.upright_axis] += 1
            angle = _rand() * 2 * np.pi
            coords = coords @ rotation_matrix(axis, angle)
        return coords, feats, labels


@cfg.configurable
class RandomScale:
    def __init__(self, scale_ratio=0.1, application_ratio=0.9):
        self.scale_ratio = scale_ratio
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            coords = coords * _gen().uniform(
                1 - self.scale_ratio, 1 + self.scale_ratio
            )
        return coords, feats, labels


@cfg.configurable
class RandomTranslation:
    def __init__(self, max_translation=3, application_ratio=0.9):
        self.max_translation = max_translation
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            coords = coords + 2 * (_gen().random((1, 3)) - 0.5) * self.max_translation
        return coords, feats, labels


@cfg.configurable
class RandomAffine:
    """rotation @ (scale + shear) — transforms.py:394-426."""

    def __init__(self, upright_axis="z", axis_std=0.1, scale_range=0.2,
                 affine_range=0.1, application_ratio=0.9):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.axis_std = axis_std
        self.scale_range = scale_range
        self.affine_range = affine_range
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            axis = self.axis_std * _gen().standard_normal(3)
            axis[self.upright_axis] += 1
            angle = 2 * (_rand() - 0.5) * np.pi
            T = rotation_matrix(axis, angle) @ (
                np.diag(2 * (_gen().random(3) - 0.5) * self.scale_range + 1)
                + 2 * (_gen().random((3, 3)) - 0.5) * self.affine_range
            )
            coords = coords @ T
        return coords, feats, labels


@cfg.configurable
class RandomHorizontalFlip:
    def __init__(self, upright_axis="z", application_ratio=0.9):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = sorted(set(range(3)) - {self.upright_axis})
        self.application_ratio = application_ratio

    def __call__(self, coords, feats, labels):
        if _rand() < self.application_ratio:
            coords = coords.copy()
            for ax in self.horz_axes:
                coords[:, ax] = coords[:, ax].max() - coords[:, ax]
        return coords, feats, labels


@cfg.configurable
class DimensionlessCoordinates:
    def __init__(self, voxel_size=0.02):
        self.voxel_size = voxel_size

    def __call__(self, coords, feats, labels):
        return coords / self.voxel_size, feats, labels


@cfg.configurable
class VoxelDownsampleSimple:
    """Stride-divisibility mask downsample (the reference defines it
    itself: ``co3d_aug*.gin`` names it, the original source does not)."""

    def __init__(self, stride=2):
        self.stride = stride

    def __call__(self, coords, feats, labels):
        sel = np.all(np.mod(coords, self.stride) == 0, axis=1)
        return _sel(coords, feats, labels, sel)


def _trilinear_uniform(noise: np.ndarray, gmin, step, pts: np.ndarray):
    """Trilinear interpolation of ``noise`` [D0, D1, D2, C] on a UNIFORM
    grid (origin ``gmin``, spacing ``step``) at ``pts`` [N, 3]; zero
    outside the grid (scipy RegularGridInterpolator fill_value=0
    semantics, ~5x faster — the generic scipy path was the #1 host-side
    hot spot at bench scale)."""
    d0, d1, d2, c = noise.shape
    # float64 coordinate math (matches scipy's boundary classification);
    # the 8 corner gathers + weighted sum stay float32
    g = (np.asarray(pts, np.float64) - np.asarray(gmin, np.float64)) / (
        np.asarray(step, np.float64)
    )
    inside = (
        (g[:, 0] >= 0) & (g[:, 0] <= d0 - 1)
        & (g[:, 1] >= 0) & (g[:, 1] <= d1 - 1)
        & (g[:, 2] >= 0) & (g[:, 2] <= d2 - 1)
    )
    i0 = np.floor(g).astype(np.int64)
    # clamp BEFORE taking fractions so the exact upper boundary lands on
    # the last cell with weight 1 (f = g - clamped corner)
    i0[:, 0] = np.clip(i0[:, 0], 0, d0 - 2)
    i0[:, 1] = np.clip(i0[:, 1], 0, d1 - 2)
    i0[:, 2] = np.clip(i0[:, 2], 0, d2 - 2)
    f = (g - i0).astype(np.float32)
    flat = noise.reshape(-1, c)
    base = (i0[:, 0] * d1 + i0[:, 1]) * d2 + i0[:, 2]
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    out = np.zeros((pts.shape[0], c), np.float32)
    for dx in (0, 1):
        wx = fx if dx else 1 - fx
        for dy in (0, 1):
            wy = fy if dy else 1 - fy
            for dz in (0, 1):
                wz = fz if dz else 1 - fz
                idx = base + (dx * d1 + dy) * d2 + dz
                out += (wx * wy * wz) * flat[idx]
    out[~inside] = 0
    return out


def _box_smooth3(noise: np.ndarray, iterations: int = 2) -> np.ndarray:
    """Separable 3-tap box blur over the three spatial axes, applied twice
    (the reference's conv-smoothing, transforms.py:560-571)."""
    import scipy.ndimage

    k = np.ones(3, np.float32) / 3
    for _ in range(iterations):
        for ax in range(3):
            noise = scipy.ndimage.convolve1d(
                noise, k, axis=ax, mode="constant", cval=0.0
            )
    return noise


@cfg.configurable
class PerlinNoise:
    """Smoothed grid noise interpolated at the points and added to their
    coordinates, once per (quantization, std) pair of ``noise_params``
    (the reference builds it with ME convs and interpolation; numpy
    here, as in the JAX package). ``device`` is accepted and unused."""

    def __init__(self, noise_params=((4, 4), (16, 16)), application_ratio=0.9,
                 device=None):
        self.noise_params = noise_params
        self.application_ratio = application_ratio

    def _noise(self, coords, quant, std):
        g = coords / quant
        gmin = np.floor(g.min(0)) - 1
        gmax = np.floor(g.max(0)) + 2
        dims = (gmax - gmin + 1).astype(int)
        noise = _gen().standard_normal((*dims, 3), dtype=np.float32)
        noise = _box_smooth3(noise, iterations=1)
        # a unit-spaced grid at origin gmin: direct trilinear
        return coords + std * _trilinear_uniform(noise, gmin, 1.0, g)

    def __call__(self, coords, feats, labels):
        if self.noise_params is not None and _rand() < self.application_ratio:
            for quant, std in self.noise_params:
                coords = self._noise(coords, quant, std)
        return coords, feats, labels


@cfg.configurable
class ElasticDistortion:
    """Blurred noise-grid displacement field (transforms.py:535-594).

    ``max_extent`` is only consumed by the device twin
    (data/device_transforms.py): the static per-scene noise-grid size the
    training step allocates. The host path ignores it (grids are sized per
    scene)."""

    def __init__(self, distortion_params=((4, 16), (8, 24)),
                 application_ratio=0.9, max_extent=None):
        self.distortion_params = distortion_params
        self.application_ratio = application_ratio
        self.max_extent = max_extent

    def _distort(self, coords, granularity, magnitude):
        coords_min = coords.min(0)
        noise_dim = ((coords - coords_min).max(0) // granularity).astype(int) + 3
        # float32 generation: same distribution, half the RNG cost (the
        # float64 default was ~half this transform's host time)
        noise = _gen().standard_normal((*noise_dim, 3), dtype=np.float32)
        noise = _box_smooth3(noise, iterations=2)
        # the ax grids are uniform (linspace spacing == granularity), so
        # the generic scipy interpolator reduces to uniform trilinear
        disp = _trilinear_uniform(
            noise, coords_min - granularity, granularity, coords
        )
        return coords + disp * magnitude

    def __call__(self, coords, feats, labels):
        if self.distortion_params is not None and _rand() < self.application_ratio:
            for granularity, magnitude in self.distortion_params:
                coords = self._distort(coords, granularity, magnitude)
        return coords, feats, labels


@cfg.configurable
class FarthestPointSample:
    """Farthest point sampling of ``num_points`` points from a random
    first point. Labels pass through unsampled, as in the reference
    (a whole-cloud classification transform)."""

    def __init__(self, num_points=2048):
        self.num_points = num_points

    def __call__(self, coords, feats, labels):
        xyz = np.asarray(coords[:, :3], np.float64)
        n = len(xyz)
        k = min(self.num_points, n)
        centroids = np.zeros(k, np.int64)
        distance = np.full(n, 1e10)
        farthest = int(_gen().integers(0, n))
        for i in range(k):
            centroids[i] = farthest
            d = np.sum((xyz - xyz[farthest]) ** 2, -1)
            distance = np.minimum(distance, d)
            farthest = int(np.argmax(distance))
        return coords[centroids], feats[centroids], labels


@cfg.configurable
class RandomSample:
    """``num_points`` points drawn at random (with replacement only when
    the cloud is smaller); labels pass through unsampled."""

    def __init__(self, num_points=2048):
        self.num_points = num_points

    def __call__(self, coords, feats, labels):
        n = len(coords)
        ind = _gen().choice(n, self.num_points, replace=n < self.num_points)
        return coords[ind], feats[ind], labels


@cfg.configurable
class DensityBasedSample:
    """Keep the points above a density percentile. ``percentile`` <= 1 is
    a fraction (the reference's reading of its configs' 0.95)."""

    def __init__(self, percentile=0.95, density_dim: int = 3):
        assert density_dim > 0
        self.percentile = percentile
        self.density_dim = density_dim

    def __call__(self, coords, feats, labels):
        assert feats.shape[1] > self.density_dim
        q = self.percentile * 100 if self.percentile <= 1 else self.percentile
        ths = np.percentile(feats[:, self.density_dim], q)
        sel = feats[:, self.density_dim] > ths
        if sel.sum() == 0:
            return coords, feats, labels
        return _sel(coords, feats, labels, sel)


@cfg.configurable
class LabelBasedSample:
    """Keep the points whose label is ``filter_label``."""

    def __init__(self, filter_label=0):
        self.filter_label = filter_label

    def __call__(self, coords, feats, labels):
        assert coords.shape[0] == labels.shape[0]
        sel = labels == self.filter_label
        return _sel(coords, feats, labels, sel)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, *args):
        for t in self.transforms:
            args = t(*args)
        return args

    def __repr__(self):
        return f"Compose({[type(t).__name__ for t in self.transforms]})"


TRANSFORMS = {
    name: obj
    for name, obj in list(globals().items())
    if isinstance(obj, type) and hasattr(obj, "__call__") and name[0].isupper()
    and name not in ("Compose",)
}

# transforms that read or write coordinates (vs feature-only): moving one
# of these to the device reorders it after every host transform, which is
# only sound when it was already last among the coordinate transforms
COORD_AFFECTING = frozenset(
    name for name in TRANSFORMS
    if name not in (
        "RandomFeatureJitter", "ChromaticTranslation",
        "ChromaticAutoContrast", "ChromaticJitter", "NormalizeColor",
        "HueSaturationTranslation",
    )
)


def build(
    names: Sequence[str], device_ok: bool = False
) -> Optional[Compose]:
    """Instantiate a transform pipeline from config names (the reference's
    ``transforms.__dict__[t]()`` lookup, co3d.py:86-90).

    ``device_ok`` (train-phase datasets): transforms listed in the
    ``train.device_transforms`` gin binding are dropped here — the task
    applies them inside the training step on the device instead
    (data/device_transforms.py), cutting host data_time without changing
    augmentation semantics. Eval/test pipelines pass device_ok=False and
    always run everything on host."""
    if not names:
        return None
    missing = [n for n in names if n not in TRANSFORMS]
    if missing:
        raise ValueError(f"unknown transforms: {missing}")
    if device_ok:
        from nerf_downstream_tpu_torch.data import device_transforms as DT

        on_device = set(DT.configured_names())
        bad = on_device - set(DT.DEVICE_CAPABLE)
        if bad:
            raise ValueError(
                f"train.device_transforms lists non-device-capable "
                f"transforms: {sorted(bad)}"
            )
        moved_coord = [
            i for i, n in enumerate(names)
            if n in on_device and n in COORD_AFFECTING
        ]
        if moved_coord:
            last_host_coord = max(
                (
                    i for i, n in enumerate(names)
                    if n in COORD_AFFECTING and n not in on_device
                ),
                default=-1,
            )
            if last_host_coord > min(moved_coord):
                raise ValueError(
                    "device-moved coordinate transforms "
                    f"({[names[i] for i in moved_coord]}) run after every "
                    "host transform; they must already be last among the "
                    f"coordinate transforms in {list(names)}"
                )
        names = [n for n in names if n not in on_device]
        if not names:
            return None
    return Compose([TRANSFORMS[n]() for n in names])
