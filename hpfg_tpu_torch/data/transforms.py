"""Host-side numpy augmentation (port of the part of
``hpfg_tpu/data/transforms.py`` the ACDC and Synapse loaders use).

``RandomGenerator``: with p=0.5 a random rot90 + flip, else with p=0.5 a
+-20 degree nearest-neighbour rotation; always a nearest zoom to the crop
size.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def nearest_zoom(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """scipy.ndimage.zoom(..., order=0) to ``out_hw``."""
    x, y = arr.shape[:2]
    if (x, y) == tuple(out_hw):
        return arr
    return ndimage.zoom(arr, (out_hw[0] / x, out_hw[1] / y), order=0)


def random_rot_flip(image: np.ndarray, label: np.ndarray,
                    rng: np.random.Generator):
    """k*90 degree rotation + axis flip."""
    k = rng.integers(0, 4)
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = rng.integers(0, 2)
    image = np.flip(image, axis=axis).copy()
    label = np.flip(label, axis=axis).copy()
    return image, label


def random_rotate(image: np.ndarray, label: np.ndarray,
                  rng: np.random.Generator):
    """+-20 degree nearest rotation, no reshape."""
    angle = rng.integers(-20, 20)
    image = ndimage.rotate(image, angle, order=0, reshape=False)
    label = ndimage.rotate(label, angle, order=0, reshape=False)
    return image, label


class RandomGenerator:
    """Returns (image [H, W, 1] float32, mask [H, W] uint8)."""

    def __init__(self, output_size: tuple[int, int], seed: int | None = None):
        self.output_size = tuple(output_size)
        self.rng = np.random.default_rng(seed)

    def __call__(self, image: np.ndarray, mask: np.ndarray,
                 rng: np.random.Generator | None = None):
        """``rng`` (given by the loader) is derived from (loader seed,
        epoch, sample index); without it the shared generator is used."""
        rng = self.rng if rng is None else rng
        if rng.random() > 0.5:
            image, mask = random_rot_flip(image, mask, rng)
        elif rng.random() > 0.5:
            image, mask = random_rotate(image, mask, rng)
        image = nearest_zoom(image, self.output_size).astype(np.float32)
        mask = nearest_zoom(mask, self.output_size).astype(np.uint8)
        return image[..., None], mask
