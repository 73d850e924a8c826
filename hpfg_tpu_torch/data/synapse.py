"""Synapse abdominal-CT dataset (port of ``hpfg_tpu/data/synapse.py``).

Layout on disk:

    <root>/train.txt, test_vol.txt          sample names, one a line
    <root>/train_npz/<name>.npz             keys image [H, W], label [H, W]
    <root>/test_vol_h5/<name>.npy.h5        keys image [D, H, W], label

Nine classes. Training slices take the ACDC ``RandomGenerator``. ``h5py``
is imported where a volume is read, so the package imports on a machine
without it.
"""

from __future__ import annotations

import os

import numpy as np

from hpfg_tpu_torch.data.loader import BatchLoader, VolumeLoader, random_split
from hpfg_tpu_torch.data.transforms import RandomGenerator

PALETTE = np.array(
    [[0, 0, 0], [0, 128, 192], [128, 0, 0], [64, 0, 128], [192, 192, 128],
     [64, 64, 128], [64, 64, 0], [128, 64, 128], [0, 0, 192],
     [192, 128, 128]], dtype=np.uint8)


class SynapseDataset:
    """npz-backed slices (train) or h5-backed volumes (test)."""

    PALETTE = PALETTE

    def __init__(self, root: str, split: str = "train", cache: bool = True):
        self.root = root
        self.split = split
        self.cache = cache
        self._cached: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if split == "train":
            list_file, pattern = "train.txt", "train_npz/{}.npz"
        else:
            list_file, pattern = "test_vol.txt", "test_vol_h5/{}.npy.h5"
        with open(os.path.join(root, list_file), "r") as f:
            names = [line.strip() for line in f if line.strip()]
        self.sample_list = [os.path.join(root, pattern.format(n))
                            for n in names]

    def __len__(self) -> int:
        return len(self.sample_list)

    def load(self, idx: int):
        if self.cache and idx in self._cached:
            return self._cached[idx]
        path = self.sample_list[idx]
        if self.split == "train":
            data = np.load(path)
            out = (np.asarray(data["image"], np.float32),
                   np.asarray(data["label"], np.uint8))
        else:
            import h5py

            with h5py.File(path, "r") as f:
                out = (np.asarray(f["image"][:], np.float32),
                       np.asarray(f["label"][:], np.uint8))
        if self.cache:
            self._cached[idx] = out
        return out

    def label_to_img(self, label):
        label = np.asarray(label).astype(np.int64)
        label[label == 255] = 0
        return self.PALETTE[label].astype(np.uint8)


def get_synapse_loader(root: str, batch_size: int = 8,
                       train_crop_size=(224, 224), seed: int = 0):
    """Supervised (train, test volumes) loaders."""
    train = SynapseDataset(root, "train")
    test = SynapseDataset(root, "test", cache=False)
    train_loader = BatchLoader(train, batch_size,
                               transform=RandomGenerator(train_crop_size, seed),
                               shuffle=True, drop_last=True, seed=seed)
    return train_loader, VolumeLoader(test)


def get_ssl_synapse_loader(root: str, batch_size: int = 8,
                           unlabel_batch_size: int = 24,
                           train_crop_size=(224, 224),
                           label_num: float = 0.2, seed: int = 0):
    """SSL (label, unlabel, test volumes) loaders over a fraction-
    ``label_num`` random split of the training slices."""
    train = SynapseDataset(root, "train")
    label_len = int(len(train) * label_num)
    train_label, train_unlabel = random_split(train, label_len, seed)
    test = SynapseDataset(root, "test", cache=False)
    label_loader = BatchLoader(train_label, batch_size,
                               transform=RandomGenerator(train_crop_size, seed),
                               shuffle=True, drop_last=True, seed=seed)
    unlabel_loader = BatchLoader(
        train_unlabel, unlabel_batch_size,
        transform=RandomGenerator(train_crop_size, seed + 1),
        shuffle=True, drop_last=True, seed=seed + 1)
    return label_loader, unlabel_loader, VolumeLoader(test)
