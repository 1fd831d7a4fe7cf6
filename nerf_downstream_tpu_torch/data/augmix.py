"""AugMix data augmentation (counterpart of
``nerf_downstream_tpu/data/augmix.py``, the port's own copy; Hendrycks et
al., ICLR 2020), applied to every 2D train sample.

Width-``w`` Dirichlet-weighted chains over {autocontrast, equalize,
posterize, rotate, solarize, shear, translate}, Beta-mixed with the clean
image. ``preprocess`` maps a PIL image to a float numpy array; mixing
happens in preprocessed space (coefficients are convex so it commutes).
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageOps

_rng = np.random.default_rng()


def seed(s: int):
    """Restart the module's stream from ``s`` (the 2D CLI seeds it from
    ``--seed``): every op's draws and the mixing weights come from it."""
    global _rng
    _rng = np.random.default_rng(s)


def _int_param(level, maxval):
    return int(level * maxval / 10)


def _float_param(level, maxval):
    return float(level) * maxval / 10.0


def _sample_level(n):
    return _rng.uniform(0.1, n)


def autocontrast(img, _):
    return ImageOps.autocontrast(img)


def equalize(img, _):
    return ImageOps.equalize(img)


def posterize(img, level):
    level = _int_param(_sample_level(level), 4)
    return ImageOps.posterize(img, 4 - level)


def rotate(img, level):
    degrees = _int_param(_sample_level(level), 30)
    if _rng.uniform() > 0.5:
        degrees = -degrees
    return img.rotate(degrees, resample=Image.BILINEAR)


def solarize(img, level):
    level = _int_param(_sample_level(level), 256)
    return ImageOps.solarize(img, 256 - level)


def _affine(img, coeffs):
    return img.transform(img.size, Image.AFFINE, coeffs, resample=Image.BILINEAR)


def shear_x(img, level):
    level = _float_param(_sample_level(level), 0.3)
    if _rng.uniform() > 0.5:
        level = -level
    return _affine(img, (1, level, 0, 0, 1, 0))


def shear_y(img, level):
    level = _float_param(_sample_level(level), 0.3)
    if _rng.uniform() > 0.5:
        level = -level
    return _affine(img, (1, 0, 0, level, 1, 0))


def translate_x(img, level):
    level = _int_param(_sample_level(level), img.size[0] / 3)
    if _rng.random() > 0.5:
        level = -level
    return _affine(img, (1, 0, level, 0, 1, 0))


def translate_y(img, level):
    level = _int_param(_sample_level(level), img.size[1] / 3)
    if _rng.random() > 0.5:
        level = -level
    return _affine(img, (1, 0, 0, 0, 1, level))


AUGMENTATIONS = [
    autocontrast, equalize, posterize, rotate, solarize, shear_x, shear_y,
    translate_x, translate_y,
]


def augment_and_mix(image: Image.Image, preprocess, severity=3, width=3,
                    depth=-1, alpha=1.0) -> np.ndarray:
    ws = np.float32(_rng.dirichlet([alpha] * width))
    m = np.float32(_rng.beta(alpha, alpha))

    clean = preprocess(image)
    mix = np.zeros_like(clean)
    for i in range(width):
        image_aug = image.copy()
        d = depth if depth > 0 else int(_rng.integers(1, 4))
        for _ in range(d):
            op = AUGMENTATIONS[int(_rng.integers(len(AUGMENTATIONS)))]
            image_aug = op(image_aug, severity)
        mix = mix + ws[i] * preprocess(image_aug)
    return (1 - m) * clean + m * mix
