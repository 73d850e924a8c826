"""ISIC 2018 skin-lesion dataset (port of ``hpfg_tpu/data/isic.py``).

Layout on disk:

    <root>/{train,test}.txt               sample names, one a line
    <root>/image/<name>.jpg               RGB image
    <root>/gt/<name>_segmentation.png     mask, every nonzero value -> 1
"""

from __future__ import annotations

import os

import numpy as np

from hpfg_tpu_torch.data.augment2d import ResizeTransform, RRCFlipJitterTransform
from hpfg_tpu_torch.data.lidc import PNGPairDataset
from hpfg_tpu_torch.data.loader import BatchLoader, random_split

PALETTE = np.array([[0, 0, 0], [255, 255, 255]], dtype=np.uint8)


def _isic_paths(root: str, split: str):
    list_file = "train.txt" if split == "train" else "test.txt"
    with open(os.path.join(root, list_file), "r") as f:
        names = [line.strip() for line in f if line.strip()]
    imgs = [os.path.join(root, "image", f"{n}.jpg") for n in names]
    anns = [os.path.join(root, "gt", f"{n}_segmentation.png") for n in names]
    return imgs, anns


def _dataset(root, split, cache=True):
    return PNGPairDataset(*_isic_paths(root, split), binarize="gt0",
                          cache=cache)


def get_isic_loader(root: str, batch_size: int = 2,
                    train_crop_size=(224, 224), seed: int = 0):
    """Supervised (train, test) loaders; train augmentation RandomResizedCrop
    (scale 0.75-1.5) + HFlip + ColorJitter."""
    train = _dataset(root, "train")
    test = _dataset(root, "test", cache=False)
    train_loader = BatchLoader(
        train, batch_size,
        transform=RRCFlipJitterTransform(train_crop_size, (0.75, 1.5), seed),
        shuffle=True, drop_last=True, seed=seed)
    test_loader = BatchLoader(test, batch_size,
                              transform=ResizeTransform(train_crop_size),
                              shuffle=False, drop_last=False, seed=seed)
    return train_loader, test_loader


def get_ssl_isic_loader(root: str, batch_size: int = 8,
                        unlabel_batch_size: int = 24,
                        train_crop_size=(224, 224), label_num: float = 0.2,
                        seed: int = 0):
    """SSL (label, unlabel, test) loaders; train augmentation
    RandomResizedCrop (scale 0.5-2.0) + HFlip + ColorJitter."""
    train = _dataset(root, "train")
    label_len = int(len(train) * label_num)
    train_label, train_unlabel = random_split(train, label_len, seed)
    test = _dataset(root, "test", cache=False)

    def aug(s):
        return RRCFlipJitterTransform(train_crop_size, (0.5, 2.0), s)

    label_loader = BatchLoader(train_label, batch_size, transform=aug(seed),
                               shuffle=True, drop_last=True, seed=seed)
    unlabel_loader = BatchLoader(train_unlabel, unlabel_batch_size,
                                 transform=aug(seed + 1), shuffle=True,
                                 drop_last=True, seed=seed + 1)
    test_loader = BatchLoader(test, 1,
                              transform=ResizeTransform(train_crop_size),
                              shuffle=False, drop_last=False, seed=seed)
    return label_loader, unlabel_loader, test_loader
