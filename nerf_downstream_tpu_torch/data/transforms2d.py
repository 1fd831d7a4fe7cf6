"""2D image transforms (counterpart of
``nerf_downstream_tpu/data/transforms2d.py``, the port's own copy) in PIL
and numpy. Arrays are float32 HWC in [0,1] after ToTensor; Normalize uses
the Inception-style ``MEAN`` and ``STD``. Every random draw comes from the
module's ``_rng`` stream, which ``seed`` restarts (the 2D CLI seeds it from
``--seed``), so the same seed gives the same crops, jitter, flips,
lighting noise and background swaps.
"""

from __future__ import annotations

import colorsys
from typing import Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data.augmix import augment_and_mix

_rng = np.random.default_rng()


def seed(s: int):
    global _rng
    _rng = np.random.default_rng(s)


MEAN = np.array([123.68, 116.779, 103.939], np.float32) / 255.0
STD = np.array([58.393, 57.12, 57.375], np.float32) / 255.0


class ToTensor:
    """PIL -> float32 HWC in [0,1]."""

    def __call__(self, x):
        if isinstance(x, Image.Image):
            x = np.asarray(x.convert("RGB"), np.float32) / 255.0
        return np.asarray(x, np.float32)


class Normalize:
    mean = MEAN
    std = STD

    def __call__(self, x):
        return (np.asarray(x, np.float32) - self.mean) / self.std


@cfg.configurable("Resize")
class Resize:
    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        s = self.image_size / min(w, h)
        return img.resize(
            (max(1, round(w * s)), max(1, round(h * s))), Image.BILINEAR
        )


@cfg.configurable("CenterCrop")
class CenterCrop:
    def __init__(self, image_size: int = 224):
        self.image_size = image_size
        self.resize = Resize(image_size)

    def __call__(self, img: Image.Image) -> Image.Image:
        img = self.resize(img)
        w, h = img.size
        s = self.image_size
        left = (w - s) // 2
        top = (h - s) // 2
        return img.crop((left, top, left + s, top + s))


@cfg.configurable("RandomResizedCrop")
class RandomResizedCrop:
    """Random area/aspect crop resized to the target (torchvision
    semantics: scale (0.08, 1.0), ratio (3/4, 4/3), 10 tries)."""

    def __init__(self, image_size: Tuple[int, int] = (224, 224),
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        self.size = tuple(image_size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        area = w * h
        for _ in range(10):
            target = area * _rng.uniform(*self.scale)
            log_ratio = np.log(self.ratio)
            ar = np.exp(_rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(_rng.integers(0, w - cw + 1))
                top = int(_rng.integers(0, h - ch + 1))
                return img.crop((left, top, left + cw, top + ch)).resize(
                    self.size, Image.BILINEAR
                )
        # fallback: center crop
        return CenterCrop(self.size[0])(img)


@cfg.configurable("RandomHorizontalFlip")
class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: Image.Image) -> Image.Image:
        if _rng.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


@cfg.configurable("ColorJitter")
class ColorJitter:
    """brightness/saturation/hue jitter (reference binds 0.4 each)."""

    def __init__(self, brightness: float = 0.4, saturation: float = 0.4,
                 hue: float = 0.4):
        self.brightness = brightness
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: Image.Image) -> Image.Image:
        ops = []
        if self.brightness > 0:
            f = _rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
        if self.saturation > 0:
            g = _rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: ImageEnhance.Color(im).enhance(g))
        if self.hue > 0:
            shift = _rng.uniform(-self.hue, self.hue)

            def hue_op(im, shift=shift):
                hsv = np.asarray(im.convert("HSV"), np.uint8).copy()
                hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                               + int(shift * 255)) % 256
                return Image.fromarray(hsv, "HSV").convert("RGB")

            ops.append(hue_op)
        order = _rng.permutation(len(ops))
        for i in order:
            img = ops[i](img)
        return img


@cfg.configurable("PCALoss")
class PCALoss:
    """AlexNet-style PCA lighting noise added in tensor space
    (reference transforms.py:82-99)."""

    eigval = np.array([55.46, 4.794, 1.148], np.float32) / 255.0
    eigvec = np.array(
        [
            [-0.5675, 0.7192, 0.4009],
            [-0.5808, -0.0045, -0.8140],
            [-0.5836, -0.6948, 0.4203],
        ],
        np.float32,
    )

    def __init__(self, alphastd: float = 0.1):
        self.alphastd = alphastd

    def __call__(self, x: np.ndarray) -> np.ndarray:
        alpha = _rng.normal(0, self.alphastd, size=3).astype(np.float32)
        rgb = ((self.eigvec * alpha) @ self.eigval[:, None]).reshape(-1)
        return np.asarray(x, np.float32) + rgb[None, None, :]


@cfg.configurable("AugMix")
class AugMix:
    def __init__(self, severity=3, width=3, depth=-1, alpha=1.0):
        self.kwargs = dict(severity=severity, width=width, depth=depth,
                           alpha=alpha)

    def __call__(self, img, preprocess):
        return augment_and_mix(img, preprocess, **self.kwargs)


@cfg.configurable("BackgroundAug")
class BackgroundAug:
    """Rescale the rendered fg/bg frame and composite it over another
    scene's background using this scene's mask (reference
    transforms.py:113-158, loader.py:172-193)."""

    def __init__(self, rescale_range: Sequence[float] = (0.5, 1.5)):
        self.rescale_min, self.rescale_max = rescale_range

    def __call__(self, fg: Image.Image, bg: Image.Image,
                 mask: Image.Image) -> Image.Image:
        scale = _rng.random() * (self.rescale_max - self.rescale_min) + self.rescale_min
        size = (int(fg.size[0] * scale), int(fg.size[1] * scale))
        fg = fg.resize(size)
        mask = mask.resize(size)
        fg_arr = np.asarray(fg.convert("RGB"))
        bg_arr = np.asarray(bg.convert("RGB")).copy()
        m = np.asarray(mask.convert("RGB"))[..., 0] / 255.0
        bg_h, bg_w = bg_arr.shape[:2]
        fg_h, fg_w = fg_arr.shape[:2]
        h0, w0 = max(0, (bg_h - fg_h) // 2), max(0, (bg_w - fg_w) // 2)
        h1, w1 = min(bg_h, (bg_h + fg_h) // 2), min(bg_w, (bg_w + fg_w) // 2)
        fh0 = fg_h // 2 - (h1 - h0) // 2
        fw0 = fg_w // 2 - (w1 - w0) // 2
        crop = fg_arr[fh0 : fh0 + (h1 - h0), fw0 : fw0 + (w1 - w0)]
        mcrop = m[fh0 : fh0 + (h1 - h0), fw0 : fw0 + (w1 - w0), None]
        bg_arr[h0:h1, w0:w1] = (
            crop * mcrop + (1 - mcrop) * bg_arr[h0:h1, w0:w1]
        ).astype(np.uint8)
        return Image.fromarray(bg_arr)


TRANSFORMS_2D = {
    "ToTensor": ToTensor,
    "Normalize": Normalize,
    "Resize": Resize,
    "CenterCrop": CenterCrop,
    "RandomResizedCrop": RandomResizedCrop,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "ColorJitter": ColorJitter,
    "PCALoss": PCALoss,
    "AugMix": AugMix,
}


class Compose2D:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return np.asarray(x, np.float32)


def build(names) -> Compose2D:
    return Compose2D([TRANSFORMS_2D[n]() for n in names])
