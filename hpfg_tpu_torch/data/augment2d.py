"""Host-side 2-D augmentations of the PNG and JPEG datasets (port of
``hpfg_tpu/data/augment2d.py``), in numpy and ``scipy.ndimage``.

numpy forms of the albumentations pipelines the LIDC, ISIC and Building
loaders use: RandomResizedCrop, flips, ShiftScaleRotate, ColorJitter,
RandomRotate90, RandomGamma, GaussNoise, brightness / contrast. They match
albumentations in distribution, not bit for bit; they match the JAX
package's transforms bit for bit on the same seed.

Every function takes and returns float32 HWC images in [0, 1] and integer
H x W masks; masks are always resampled by nearest neighbour. The train
transforms hold one ``np.random.default_rng(seed)`` that every call draws
from, as the JAX package's do: a loader's thread pool shares it, so which
sample gets which draw depends on the threads' order unless the loader runs
one thread.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _resize(img: np.ndarray, out_hw: tuple[int, int], order: int) -> np.ndarray:
    h, w = img.shape[:2]
    if (h, w) == tuple(out_hw):
        return img
    factors = (out_hw[0] / h, out_hw[1] / w) + (1,) * (img.ndim - 2)
    return ndimage.zoom(img, factors, order=order)


def resize(image: np.ndarray, mask: np.ndarray | None,
           out_hw: tuple[int, int]):
    image = _resize(image, out_hw, order=1).astype(np.float32)
    if mask is None:
        return image, None
    return image, _resize(mask, out_hw, order=0)


def random_resized_crop(image, mask, out_hw, scale=(0.5, 2.0),
                        ratio=(3 / 4, 4 / 3), rng=None):
    """albumentations RandomResizedCrop: sample area fraction and aspect,
    crop, then resize to out_hw."""
    rng = rng or np.random.default_rng()
    h, w = image.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        ch = int(round(np.sqrt(target_area / aspect)))
        cw = int(round(np.sqrt(target_area * aspect)))
        if 0 < ch <= h and 0 < cw <= w:
            y0 = rng.integers(0, h - ch + 1)
            x0 = rng.integers(0, w - cw + 1)
            image = image[y0:y0 + ch, x0:x0 + cw]
            mask = mask[y0:y0 + ch, x0:x0 + cw] if mask is not None else None
            return resize(image, mask, out_hw)
    return resize(image, mask, out_hw)  # fallback: plain resize


def hflip(image, mask, rng, p=0.5):
    if rng.random() < p:
        image = image[:, ::-1].copy()
        mask = mask[:, ::-1].copy() if mask is not None else None
    return image, mask


def vflip(image, mask, rng, p=0.5):
    if rng.random() < p:
        image = image[::-1].copy()
        mask = mask[::-1].copy() if mask is not None else None
    return image, mask


def random_rotate90(image, mask, rng):
    k = int(rng.integers(0, 4))
    return np.rot90(image, k).copy(), (
        np.rot90(mask, k).copy() if mask is not None else None)


def shift_scale_rotate(image, mask, rng, p=0.5, shift_limit=0.0625,
                       scale_limit=0.1, rotate_limit=45):
    if rng.random() >= p:
        return image, mask
    h, w = image.shape[:2]
    angle = rng.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + rng.uniform(-scale_limit, scale_limit)
    dx = rng.uniform(-shift_limit, shift_limit) * w
    dy = rng.uniform(-shift_limit, shift_limit) * h
    theta = np.deg2rad(angle)
    m = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]]) / scale
    center = np.array([h / 2, w / 2])
    offset = center - m @ (center + np.array([dy, dx]))

    def warp(arr, order):
        if arr.ndim == 3:
            return np.stack([
                ndimage.affine_transform(arr[..., c], m, offset=offset,
                                         order=order, mode="constant")
                for c in range(arr.shape[-1])], axis=-1)
        return ndimage.affine_transform(arr, m, offset=offset, order=order,
                                        mode="constant")

    image = warp(image, 1).astype(np.float32)
    mask = warp(mask, 0) if mask is not None else None
    return image, mask


def color_jitter(image, rng, brightness=0.4, contrast=0.4, saturation=0.4,
                 p=0.5):
    if rng.random() >= p:
        return image
    img = image.copy()
    for op in rng.permutation(3):
        if op == 0 and brightness:
            img = img * rng.uniform(1 - brightness, 1 + brightness)
        elif op == 1 and contrast:
            mean = img.mean()
            img = (img - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
        elif op == 2 and saturation and img.ndim == 3 and img.shape[-1] == 3:
            gray = img.mean(axis=-1, keepdims=True)
            f = rng.uniform(1 - saturation, 1 + saturation)
            img = gray + (img - gray) * f
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def random_gamma(image, rng, gamma_limit=(80, 120), p=0.2):
    if rng.random() >= p:
        return image
    gamma = rng.uniform(*gamma_limit) / 100.0
    return np.clip(image, 0, 1) ** gamma


def gauss_noise(image, rng, var_limit=(10.0, 50.0), p=0.2):
    """albumentations GaussNoise var_limit is in 0-255 pixel units."""
    if rng.random() >= p:
        return image
    var = rng.uniform(*var_limit) / (255.0 ** 2)
    noise = rng.normal(0, np.sqrt(var), image.shape).astype(np.float32)
    return np.clip(image + noise, 0.0, 1.0)


def brightness_contrast(image, rng, limit=0.2):
    img = image * (1.0 + rng.uniform(-limit, limit))
    mean = img.mean()
    img = (img - mean) * (1.0 + rng.uniform(-limit, limit)) + mean
    return np.clip(img, 0.0, 1.0).astype(np.float32)


class LIDCSSLTrainTransform:
    """The semi-supervised LIDC pipeline: RandomRotate90, RandomGamma
    (p=0.2), GaussNoise (p=0.2), one of a colour jitter or a brightness /
    contrast change, then a resize."""

    def __init__(self, out_hw, seed=None):
        self.out_hw = tuple(out_hw)
        self.rng = np.random.default_rng(seed)

    def __call__(self, image, mask):
        rng = self.rng
        image, mask = random_rotate90(image, mask, rng)
        image = random_gamma(image, rng)
        image = gauss_noise(image, rng)
        if rng.random() < 0.5:
            image = color_jitter(image, rng, 0.2, 0.3, 0.2, p=1.0)
        else:
            image = brightness_contrast(image, rng)
        image, mask = resize(image, mask, self.out_hw)
        return image.astype(np.float32), mask.astype(np.uint8)


class RRCFlipJitterTransform:
    """The supervised LIDC and the ISIC pipeline: RandomResizedCrop +
    HorizontalFlip + ColorJitter."""

    def __init__(self, out_hw, scale=(0.75, 1.5), seed=None):
        self.out_hw = tuple(out_hw)
        self.scale = scale
        self.rng = np.random.default_rng(seed)

    def __call__(self, image, mask):
        rng = self.rng
        image, mask = random_resized_crop(image, mask, self.out_hw,
                                          self.scale, rng=rng)
        image, mask = hflip(image, mask, rng)
        image = color_jitter(image, rng)
        return image.astype(np.float32), mask.astype(np.uint8)


class BuildingTrainTransform:
    """The Building pipeline: RandomResizedCrop (scale 0.5-2.0) + HFlip +
    ShiftScaleRotate (p=0.6) + ColorJitter."""

    def __init__(self, out_hw, seed=None):
        self.out_hw = tuple(out_hw)
        self.rng = np.random.default_rng(seed)

    def __call__(self, image, mask):
        rng = self.rng
        image, mask = random_resized_crop(image, mask, self.out_hw,
                                          (0.5, 2.0), rng=rng)
        image, mask = hflip(image, mask, rng)
        image, mask = shift_scale_rotate(image, mask, rng, p=0.6)
        image = color_jitter(image, rng)
        return image.astype(np.float32), mask.astype(np.uint8)


class ResizeTransform:
    def __init__(self, out_hw):
        self.out_hw = tuple(out_hw)

    def __call__(self, image, mask):
        image, mask = resize(image, mask, self.out_hw)
        return image.astype(np.float32), mask.astype(np.uint8)
