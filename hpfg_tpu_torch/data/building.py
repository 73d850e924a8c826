"""Aerial building-footprint dataset (port of ``hpfg_tpu/data/building.py``).

Layout on disk:

    <root>/{train,val,test}.txt     file names with their extension
    <root>/train/image/<name>       train and val images (RGB)
    <root>/train/mask/<stem>.png    their masks (255 -> 1)
    <root>/test/image/<name>        test images, without masks

Supervised only: (train, val, test) loaders. The test split yields images
with all-zero masks (``BuildingTestDataset``), as the JAX package's does.
"""

from __future__ import annotations

import os

import numpy as np

from hpfg_tpu_torch.data.augment2d import BuildingTrainTransform
from hpfg_tpu_torch.data.lidc import PNGPairDataset
from hpfg_tpu_torch.data.loader import BatchLoader

PALETTE = np.array([[0, 0, 0], [255, 255, 255]], dtype=np.uint8)


class BuildingTestDataset:
    """The image-only test split; each image comes with an all-zero mask so
    that the batch loader can stack pairs."""

    PALETTE = PALETTE

    def __init__(self, img_paths):
        self.img_paths = list(img_paths)

    def __len__(self):
        return len(self.img_paths)

    def load(self, idx: int):
        from PIL import Image

        image = np.asarray(Image.open(self.img_paths[idx]).convert("RGB"),
                           dtype=np.float32) / 255.0
        return image, np.zeros(image.shape[:2], np.uint8)


def _paths(root: str, split: str):
    with open(os.path.join(root, f"{split}.txt"), "r") as f:
        names = [line.strip() for line in f if line.strip()]
    sub = "train" if split in ("train", "val") else "test"
    base = os.path.join(root, sub)
    imgs = [os.path.join(base, "image", n) for n in names]
    anns = [os.path.join(base, "mask", f"{n.split('.')[0]}.png")
            for n in names]
    return imgs, anns


def get_building_loader(root: str, batch_size: int = 8,
                        train_crop_size=(512, 512), seed: int = 0):
    """(train, val, test) loaders: train augmented and shuffled with its
    last batch kept, val and test at their own size, unshuffled."""
    timgs, tanns = _paths(root, "train")
    vimgs, vanns = _paths(root, "val")
    simgs, _ = _paths(root, "test")
    train = PNGPairDataset(timgs, tanns, binarize="eq255")
    val = PNGPairDataset(vimgs, vanns, binarize="eq255", cache=False)
    test = BuildingTestDataset(simgs)
    train_loader = BatchLoader(
        train, batch_size,
        transform=BuildingTrainTransform(train_crop_size, seed=seed),
        shuffle=True, drop_last=False, seed=seed)
    val_loader = BatchLoader(val, batch_size, shuffle=False, drop_last=True,
                             seed=seed)
    test_loader = BatchLoader(test, batch_size, shuffle=False,
                              drop_last=False, seed=seed)
    return train_loader, val_loader, test_loader
