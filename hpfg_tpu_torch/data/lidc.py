"""LIDC lung-CT nodule dataset (port of ``hpfg_tpu/data/lidc.py``).

Layout on disk:

    <root>/{train,val,test}.txt          sample names, one a line
    <root>/image_r/<name>.png            RGB image
    <root>/mask_r/LIDC_Mask_<id>.png     binary mask (255 -> 1), where <id>
                                         is ``name.split('_')[1]``

Pillow is imported where a file is read. ``PNGPairDataset`` serves the ISIC
and Building loaders too.
"""

from __future__ import annotations

import os

import numpy as np

from hpfg_tpu_torch.data.augment2d import (
    LIDCSSLTrainTransform,
    ResizeTransform,
    RRCFlipJitterTransform,
)
from hpfg_tpu_torch.data.loader import BatchLoader, random_split

PALETTE = np.array([[0, 0, 0], [255, 255, 255]], dtype=np.uint8)


class PNGPairDataset:
    """Image / mask file pairs, decoded once and cached when ``cache``.
    ``binarize``: ``"eq255"`` maps 255 to 1 (LIDC, Building), ``"gt0"``
    every nonzero value (ISIC)."""

    PALETTE = PALETTE

    def __init__(self, img_paths, ann_paths, binarize="eq255", cache=True):
        if len(img_paths) != len(ann_paths):
            raise ValueError(f"{len(img_paths)} images but {len(ann_paths)} "
                             "masks")
        self.img_paths = list(img_paths)
        self.ann_paths = list(ann_paths)
        self.binarize = binarize
        self.cache = cache
        self._cached: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.img_paths)

    def load(self, idx: int):
        if self.cache and idx in self._cached:
            return self._cached[idx]
        from PIL import Image

        image = np.asarray(Image.open(self.img_paths[idx]).convert("RGB"),
                           dtype=np.float32) / 255.0
        mask = np.asarray(Image.open(self.ann_paths[idx]).convert("L"),
                          dtype=np.uint8).copy()
        if self.binarize == "eq255":
            mask[mask == 255] = 1
        else:
            mask[mask > 0] = 1
        if self.cache:
            self._cached[idx] = (image, mask)
        return image, mask

    def label_to_img(self, label):
        label = np.asarray(label).astype(np.int64)
        label[label == 255] = 0
        return self.PALETTE[label].astype(np.uint8)


def _lidc_paths(root: str, split: str):
    with open(os.path.join(root, f"{split}.txt"), "r") as f:
        names = [line.strip() for line in f if line.strip()]
    imgs = [os.path.join(root, "image_r", f"{n}.png") for n in names]
    anns = [os.path.join(root, "mask_r",
                         f"LIDC_Mask_{n.split('_')[1]}.png") for n in names]
    return imgs, anns


def get_lidc_loader(root: str, batch_size: int = 1,
                    train_crop_size=(96, 96), seed: int = 0):
    """Supervised (train, test) loaders; the test split is resized to the
    crop and batched by ``batch_size``, its last batch kept."""
    train = PNGPairDataset(*_lidc_paths(root, "train"))
    test = PNGPairDataset(*_lidc_paths(root, "test"), cache=False)
    train_loader = BatchLoader(
        train, batch_size,
        transform=RRCFlipJitterTransform(train_crop_size, seed=seed),
        shuffle=True, drop_last=True, seed=seed)
    test_loader = BatchLoader(test, batch_size,
                              transform=ResizeTransform(train_crop_size),
                              shuffle=False, drop_last=False, seed=seed)
    return train_loader, test_loader


def get_ssl_lidc_loader(root: str, batch_size: int = 8,
                        unlabel_batch_size: int = 24,
                        train_crop_size=(96, 96), label_num: float = 0.2,
                        seed: int = 0):
    """SSL (label, unlabel, test) loaders over a fraction-``label_num``
    random split of the training images; the test loader yields one image
    at a time."""
    train = PNGPairDataset(*_lidc_paths(root, "train"))
    label_len = int(len(train) * label_num)
    train_label, train_unlabel = random_split(train, label_len, seed)
    test = PNGPairDataset(*_lidc_paths(root, "test"), cache=False)
    label_loader = BatchLoader(
        train_label, batch_size,
        transform=LIDCSSLTrainTransform(train_crop_size, seed=seed),
        shuffle=True, drop_last=True, seed=seed)
    unlabel_loader = BatchLoader(
        train_unlabel, unlabel_batch_size,
        transform=LIDCSSLTrainTransform(train_crop_size, seed=seed + 1),
        shuffle=True, drop_last=True, seed=seed + 1)
    test_loader = BatchLoader(test, 1,
                              transform=ResizeTransform(train_crop_size),
                              shuffle=False, drop_last=False, seed=seed)
    return label_loader, unlabel_loader, test_loader
