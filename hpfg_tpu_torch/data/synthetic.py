"""Synthetic data trees in the layouts the loaders read (port of
``hpfg_tpu/data/synthetic.py``: ACDC, LIDC, ISIC, Synapse and Building).

The images are learnable phantoms: concentric ellipse rings with noise, one
ring a class. For the same arguments the arrays, file names and list files
equal the JAX package's; the PNG, JPEG and npz files are byte-equal, and the
h5 files (ACDC, Synapse's test volumes) are written by the port's own HDF5
writer (``data/h5.py``), so no h5py is needed. Pillow is imported where an
image is written.
"""

from __future__ import annotations

import os

import numpy as np

from hpfg_tpu_torch.data import h5

def _phantom_slice(rng: np.random.Generator, h: int, w: int,
                   num_classes: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """One slice: background + (num_classes-1) concentric ellipse rings."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = h / 2 + rng.uniform(-h / 8, h / 8)
    cx = w / 2 + rng.uniform(-w / 8, w / 8)
    ry = rng.uniform(h / 8, h / 4)
    rx = rng.uniform(w / 8, w / 4)
    theta = rng.uniform(0, np.pi)
    ys, xs = yy - cy, xx - cx
    yr = ys * np.cos(theta) + xs * np.sin(theta)
    xr = -ys * np.sin(theta) + xs * np.cos(theta)
    r = np.sqrt((yr / ry) ** 2 + (xr / rx) ** 2)

    mask = np.zeros((h, w), dtype=np.uint8)
    # outer ring = class 1, middle = class 2, core = class 3 (ACDC-like)
    radii = np.linspace(1.0, 0.3, num_classes)
    for cls in range(1, num_classes):
        mask[r < radii[cls - 1]] = cls

    image = 0.2 + 0.15 * mask.astype(np.float32)
    image += rng.normal(0, 0.05, (h, w)).astype(np.float32)
    image = np.clip(image, 0.0, 1.0)
    return image, mask


def make_synthetic_acdc(root: str, n_train_slices: int = 48,
                        n_test_volumes: int = 3, depth: int = 6,
                        hw: tuple[int, int] = (256, 216),
                        num_classes: int = 4, seed: int = 0) -> str:
    """ACDC layout: data/slices/<name>.h5 training slices, data/<name>.h5
    volumes (the first ``n_test_volumes`` in test.list, as many again in
    val.list), each with ``image`` (float32) and ``label`` (uint8)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "data", "slices"), exist_ok=True)
    train_names = []
    for i in range(n_train_slices):
        name = f"patient{i:03d}_frame01_slice_{i % 10}"
        train_names.append(name)
        image, mask = _phantom_slice(rng, h, w, num_classes)
        h5.write(os.path.join(root, "data", "slices", f"{name}.h5"),
                 {"image": image, "label": mask})
    test_names, val_names = [], []
    for i in range(n_test_volumes * 2):
        name = f"patient{100 + i:03d}_volume"
        (test_names if i < n_test_volumes else val_names).append(name)
        vol_img = np.zeros((depth, h, w), dtype=np.float32)
        vol_msk = np.zeros((depth, h, w), dtype=np.uint8)
        for d in range(depth):
            vol_img[d], vol_msk[d] = _phantom_slice(rng, h, w, num_classes)
        h5.write(os.path.join(root, "data", f"{name}.h5"),
                 {"image": vol_img, "label": vol_msk})
    for list_name, names in [("train_slices.list", train_names),
                             ("test.list", test_names),
                             ("val.list", val_names)]:
        with open(os.path.join(root, list_name), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def make_synthetic_png_pairs(root: str, n: int = 24, hw: tuple[int, int] = (96, 96),
                             rgb: bool = True, seed: int = 0,
                             image_dir: str = "image_r", mask_dir: str = "mask_r",
                             mask_prefix: str = "LIDC_Mask_") -> str:
    """Write an image / mask PNG tree in the LIDC naming (no name lists)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, image_dir), exist_ok=True)
    os.makedirs(os.path.join(root, mask_dir), exist_ok=True)
    for i in range(n):
        image, mask = _phantom_slice(rng, h, w, num_classes=2)
        arr = (image * 255).astype(np.uint8)
        if rgb:
            arr = np.stack([arr] * 3, axis=-1)
        Image.fromarray(arr).save(os.path.join(root, image_dir, f"{i:04d}.png"))
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(root, mask_dir, f"{mask_prefix}{i:04d}.png"))
    return root


def make_synthetic_lidc(root: str, n: int = 24, hw: tuple[int, int] = (96, 96),
                        seed: int = 0) -> str:
    """LIDC layout: image_r/<name>.png, mask_r/LIDC_Mask_<id>.png, names
    '<k>_<id>' listed in train.txt (the first 3/4) and val.txt / test.txt
    (the rest)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "image_r"), exist_ok=True)
    os.makedirs(os.path.join(root, "mask_r"), exist_ok=True)
    names = []
    for i in range(n):
        name = f"{i:03d}_{1000 + i}"
        names.append(name)
        image, mask = _phantom_slice(rng, h, w, num_classes=2)
        arr = np.stack([(image * 255).astype(np.uint8)] * 3, axis=-1)
        Image.fromarray(arr).save(os.path.join(root, "image_r", f"{name}.png"))
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(root, "mask_r", f"LIDC_Mask_{1000 + i}.png"))
    cut = int(n * 0.75)
    for list_name, sel in [("train.txt", names[:cut]), ("val.txt", names[cut:]),
                           ("test.txt", names[cut:])]:
        with open(os.path.join(root, list_name), "w") as f:
            f.write("\n".join(sel) + "\n")
    return root


def make_synthetic_isic(root: str, n: int = 16, hw: tuple[int, int] = (64, 64),
                        seed: int = 0) -> str:
    """ISIC layout: image/<name>.jpg, gt/<name>_segmentation.png, the first
    3/4 of the names in train.txt and the rest in test.txt."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "image"), exist_ok=True)
    os.makedirs(os.path.join(root, "gt"), exist_ok=True)
    names = []
    for i in range(n):
        name = f"ISIC_{i:07d}"
        names.append(name)
        image, mask = _phantom_slice(rng, h, w, num_classes=2)
        arr = np.stack([(image * 255).astype(np.uint8)] * 3, axis=-1)
        Image.fromarray(arr).save(os.path.join(root, "image", f"{name}.jpg"))
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(root, "gt", f"{name}_segmentation.png"))
    cut = int(n * 0.75)
    for list_name, sel in [("train.txt", names[:cut]), ("test.txt", names[cut:])]:
        with open(os.path.join(root, list_name), "w") as f:
            f.write("\n".join(sel) + "\n")
    return root


def make_synthetic_synapse(root: str, n_train: int = 16, n_vols: int = 2,
                           depth: int = 4, hw: tuple[int, int] = (64, 64),
                           num_classes: int = 9, seed: int = 0) -> str:
    """Synapse layout: train slices as train_npz/<name>.npz (image/label),
    test volumes as test_vol_h5/<name>.npy.h5."""
    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "train_npz"), exist_ok=True)
    os.makedirs(os.path.join(root, "test_vol_h5"), exist_ok=True)
    train_names = []
    for i in range(n_train):
        name = f"case{i:04d}_slice{i:03d}"
        train_names.append(name)
        image, mask = _phantom_slice(rng, h, w, min(num_classes, 4))
        np.savez(os.path.join(root, "train_npz", f"{name}.npz"),
                 image=image, label=mask)
    vol_names = []
    for i in range(n_vols):
        name = f"case{100 + i:04d}"
        vol_names.append(name)
        img = np.zeros((depth, h, w), np.float32)
        msk = np.zeros((depth, h, w), np.uint8)
        for d in range(depth):
            img[d], msk[d] = _phantom_slice(rng, h, w, min(num_classes, 4))
        h5.write(os.path.join(root, "test_vol_h5", f"{name}.npy.h5"),
                 {"image": img, "label": msk})
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(train_names) + "\n")
    with open(os.path.join(root, "test_vol.txt"), "w") as f:
        f.write("\n".join(vol_names) + "\n")
    return root


def make_synthetic_building(root: str, n: int = 12,
                            hw: tuple[int, int] = (64, 64),
                            seed: int = 0) -> str:
    """Building layout: train and val under <root>/train/{image,mask}, test
    images under <root>/test/image; the name lists carry extensions."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    for sub in ("train/image", "train/mask", "test/image"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = [f"tile_{i:04d}.png" for i in range(n)]
    for i, name in enumerate(names):
        image, mask = _phantom_slice(rng, h, w, num_classes=2)
        arr = np.stack([(image * 255).astype(np.uint8)] * 3, axis=-1)
        sub = "train" if i < n - 3 else "test"
        Image.fromarray(arr).save(os.path.join(root, sub, "image", name))
        if sub == "train":
            Image.fromarray((mask * 255).astype(np.uint8)).save(
                os.path.join(root, "train", "mask",
                             f"{name.split('.')[0]}.png"))
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names[:n - 6]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(names[n - 6:n - 3]) + "\n")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(names[n - 3:]) + "\n")
    return root
