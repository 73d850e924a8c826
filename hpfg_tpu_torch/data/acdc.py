"""ACDC cardiac MR dataset (port of ``hpfg_tpu/data/acdc.py``).

Layout on disk:

    <root>/train_slices.list       names of per-slice h5 files
    <root>/val.list, test.list     names of per-volume h5 files
    <root>/data/slices/<name>.h5   keys: image [H, W] float, label [H, W]
    <root>/data/<name>.h5          keys: image [D, H, W], label [D, H, W]

``h5py`` is imported where a file is read, so the package imports on a
machine without it.
"""

from __future__ import annotations

import os

import numpy as np

from hpfg_tpu_torch.data.loader import BatchLoader, VolumeLoader, random_split
from hpfg_tpu_torch.data.transforms import RandomGenerator


class ACDCDataset:
    """h5-backed slice (train) or volume (val/test) source."""

    def __init__(self, root: str, split: str = "train", cache: bool = True):
        self.root = root
        self.split = split
        self.cache = cache
        self._cached: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.sample_list = self._load_annotations()

    def _load_annotations(self) -> list[str]:
        if self.split == "train":
            list_file, pattern = "train_slices.list", "data/slices/{}.h5"
        elif self.split == "val":
            list_file, pattern = "val.list", "data/{}.h5"
        else:
            list_file, pattern = "test.list", "data/{}.h5"
        with open(os.path.join(self.root, list_file), "r") as f:
            names = [line.strip() for line in f if line.strip()]
        return [os.path.join(self.root, pattern.format(name)) for name in names]

    def __len__(self) -> int:
        return len(self.sample_list)

    def load(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        if self.cache and idx in self._cached:
            return self._cached[idx]
        import h5py

        with h5py.File(self.sample_list[idx], "r") as h5f:
            image = np.asarray(h5f["image"][:], dtype=np.float32)
            mask = np.asarray(h5f["label"][:], dtype=np.uint8)
        if self.cache:
            self._cached[idx] = (image, mask)
        return image, mask


def get_acdc_loader(root: str, batch_size: int = 4,
                    train_crop_size=(224, 224), seed: int = 0,
                    num_threads: int = 8):
    """Supervised (train, test) loaders."""
    train = ACDCDataset(root, split="train")
    test = ACDCDataset(root, split="test", cache=False)
    train_loader = BatchLoader(
        train, batch_size, transform=RandomGenerator(train_crop_size, seed),
        shuffle=True, drop_last=True, seed=seed, num_threads=num_threads)
    return train_loader, VolumeLoader(test)


def get_ssl_acdc_loader(root: str, batch_size: int = 8,
                        unlabel_batch_size: int = 24,
                        train_crop_size=(224, 224), label_num: float = 0.2,
                        seed: int = 0, num_threads: int = 8):
    """SSL (label, unlabel, test) loaders over a fraction-``label_num``
    random split of the training slices."""
    train = ACDCDataset(root, split="train")
    label_length = int(len(train) * label_num)
    train_label, train_unlabel = random_split(train, label_length, seed)
    test = ACDCDataset(root, split="test", cache=False)
    label_loader = BatchLoader(
        train_label, batch_size,
        transform=RandomGenerator(train_crop_size, seed),
        shuffle=True, drop_last=True, seed=seed, num_threads=num_threads)
    unlabel_loader = BatchLoader(
        train_unlabel, unlabel_batch_size,
        transform=RandomGenerator(train_crop_size, seed + 1),
        shuffle=True, drop_last=True, seed=seed + 1, num_threads=num_threads)
    return label_loader, unlabel_loader, VolumeLoader(test)
