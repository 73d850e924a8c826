"""Data-tree preflight (port of ``hpfg_tpu/data/preflight.py``): fail in
seconds with every problem listed, before any model is built. The layouts
checked, one for each name ``data.builder.build_loader`` accepts (a
``sup_`` name shares its dataset's):

  acdc      train_slices.list + data/slices/<n>.h5 (keys image/label,
            2-D); val.list/test.list + data/<n>.h5 (3-D volumes)
  synapse   train.txt + train_npz/<n>.npz (keys image/label);
            test_vol.txt + test_vol_h5/<n>.npy.h5 (3-D volumes)
  lidc      {train,val,test}.txt + image_r/<n>.png +
            mask_r/LIDC_Mask_<n.split('_')[1]>.png
  isic      {train,test}.txt + image/<n>.jpg + gt/<n>_segmentation.png
  building  {train,val,test}.txt + train/image/<n> + train/mask/<stem>.png;
            test images under test/image/<n>

The h5 files are read with the port's own HDF5 reader (``data/h5.py``).
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from hpfg_tpu_torch.data import h5

class DataPreflightError(RuntimeError):
    """Raised with EVERY problem found, one actionable line each."""


def _read_list(root: str, name: str, issues: list[str]) -> list[str]:
    path = os.path.join(root, name)
    if not os.path.isfile(path):
        issues.append(
            f"missing list file {path} (the loader builds its sample list "
            f"from it) — is data_path={root!r} the dataset root?")
        return []
    with open(path) as f:
        names = [line.strip() for line in f if line.strip()]
    if not names:
        issues.append(f"{path} is empty — no samples to train/evaluate on")
    return names


def _sample_idx(n: int, k: int = 3) -> list[int]:
    """First / last / middle: bounded work whatever the list's size."""
    return sorted(set([0, n - 1, n // 2][:max(min(k, n), 0)]))


def _check_h5(path: str, issues: list[str], *, ndim: int, num_classes: int,
              what: str) -> None:
    if not os.path.isfile(path):
        issues.append(f"{what}: listed file {path} does not exist — list "
                      "and data/ tree out of sync")
        return
    try:
        h5f = h5.File(path)
        for key in ("image", "label"):
            if key not in h5f:
                issues.append(
                    f"{what}: {path} has no dataset {key!r} (keys: "
                    f"{sorted(h5f.keys())}) — the loaders read "
                    "h5f['image']/h5f['label']")
                return
        img = np.asarray(h5f["image"])
        lbl = np.asarray(h5f["label"])
    except OSError as e:
        issues.append(f"{what}: {path} is not a readable HDF5 file ({e})")
        return
    except NotImplementedError as e:
        issues.append(f"{what}: {path} uses an HDF5 feature the reader "
                      f"does not read ({e})")
        return
    if img.ndim != ndim:
        issues.append(f"{what}: {path} image is {img.ndim}-D "
                      f"{img.shape}, expected {ndim}-D "
                      f"({'per-slice' if ndim == 2 else 'volume'} layout)")
    if img.shape != lbl.shape:
        issues.append(f"{what}: {path} image {img.shape} vs label "
                      f"{lbl.shape} shape mismatch")
    if lbl.size and int(lbl.max()) >= num_classes:
        issues.append(f"{what}: {path} label max {int(lbl.max())} >= "
                      f"num_classes {num_classes} — wrong dataset or "
                      "num_classes misconfigured")


def _check_file(path: str, issues: list[str], what: str) -> None:
    if not os.path.isfile(path):
        issues.append(f"{what}: expected file {path} does not exist")


def _validate_acdc(root: str, num_classes: int, issues: list[str]) -> None:
    train = _read_list(root, "train_slices.list", issues)
    for i in _sample_idx(len(train)):
        _check_h5(os.path.join(root, "data", "slices", f"{train[i]}.h5"),
                  issues, ndim=2, num_classes=num_classes,
                  what=f"train slice [{i}]")
    for split in ("val", "test"):
        vols = _read_list(root, f"{split}.list", issues)
        for i in _sample_idx(len(vols), 2):
            _check_h5(os.path.join(root, "data", f"{vols[i]}.h5"), issues,
                      ndim=3, num_classes=num_classes,
                      what=f"{split} volume [{i}]")


def _validate_synapse(root: str, num_classes: int, issues: list[str]) -> None:
    train = _read_list(root, "train.txt", issues)
    for i in _sample_idx(len(train)):
        path = os.path.join(root, "train_npz", f"{train[i]}.npz")
        what = f"train npz [{i}]"
        if not os.path.isfile(path):
            issues.append(f"{what}: listed file {path} does not exist")
            continue
        try:
            with np.load(path) as z:
                missing = [k for k in ("image", "label") if k not in z]
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            issues.append(f"{what}: {path} unreadable ({e})")
            continue
        if missing:
            issues.append(f"{what}: {path} missing keys {missing}")
    vols = _read_list(root, "test_vol.txt", issues)
    for i in _sample_idx(len(vols), 2):
        _check_h5(os.path.join(root, "test_vol_h5", f"{vols[i]}.npy.h5"),
                  issues, ndim=3, num_classes=num_classes,
                  what=f"test volume [{i}]")


def _validate_lidc(root: str, num_classes: int, issues: list[str]) -> None:
    for split in ("train", "val", "test"):
        names = _read_list(root, f"{split}.txt", issues)
        for i in _sample_idx(len(names), 2):
            n = names[i]
            _check_file(os.path.join(root, "image_r", f"{n}.png"), issues,
                        f"{split} image [{i}]")
            parts = n.split("_")
            if len(parts) < 2:
                issues.append(
                    f"{split} [{i}]: name {n!r} has no '_' — the mask path "
                    "is mask_r/LIDC_Mask_<name.split('_')[1]>.png")
                continue
            _check_file(
                os.path.join(root, "mask_r", f"LIDC_Mask_{parts[1]}.png"),
                issues, f"{split} mask [{i}]")


def _validate_isic(root: str, num_classes: int, issues: list[str]) -> None:
    for split in ("train", "test"):
        names = _read_list(root, f"{split}.txt", issues)
        for i in _sample_idx(len(names), 2):
            n = names[i]
            _check_file(os.path.join(root, "image", f"{n}.jpg"), issues,
                        f"{split} image [{i}]")
            _check_file(os.path.join(root, "gt", f"{n}_segmentation.png"),
                        issues, f"{split} mask [{i}]")


def _validate_building(root: str, num_classes: int,
                       issues: list[str]) -> None:
    for split in ("train", "val"):
        names = _read_list(root, f"{split}.txt", issues)
        for i in _sample_idx(len(names), 2):
            n = names[i]
            _check_file(os.path.join(root, "train", "image", n), issues,
                        f"{split} image [{i}]")
            stem = os.path.splitext(n)[0]
            _check_file(os.path.join(root, "train", "mask", f"{stem}.png"),
                        issues, f"{split} mask [{i}]")
    names = _read_list(root, "test.txt", issues)
    for i in _sample_idx(len(names), 2):
        _check_file(os.path.join(root, "test", "image", names[i]), issues,
                    f"test image [{i}]")


#: one validator for each name data.builder.build_loader accepts; the
#: validators do not depend on the split, so the sup_ names share them
_VALIDATORS = {
    "acdc": _validate_acdc,
    "sup_acdc": _validate_acdc,
    "synapse": _validate_synapse,
    "sup_synapse": _validate_synapse,
    "lidc": _validate_lidc,
    "sup_lidc": _validate_lidc,
    "isic": _validate_isic,
    "sup_isic": _validate_isic,
    "sup_building": _validate_building,
}


def validate_data_tree(root: str, dataset: str,
                       num_classes: int = 4) -> list[str]:
    """Issues found in ``root`` for ``dataset`` (empty: OK). Bounded work:
    list files plus at most three sample files per split."""
    dataset = str(dataset).lower()
    if dataset not in _VALIDATORS:
        return [f"unknown dataset {dataset!r} — preflight knows "
                f"{sorted(_VALIDATORS)}"]
    if not os.path.isdir(root):
        return [f"data_path {root!r} is not a directory"]
    issues: list[str] = []
    _VALIDATORS[dataset](root, int(num_classes), issues)
    return issues


def preflight_or_raise(cfg) -> None:
    """Validate cfg's data tree, raising DataPreflightError with every
    problem found. Skipped when cfg.preflight is false."""
    if not bool(cfg.get("preflight", True)):
        return
    root = str(cfg.get("data_path", ""))
    issues = validate_data_tree(root, str(cfg.get("datasets", "")),
                                int(cfg.get("num_classes", 4)))
    if issues:
        raise DataPreflightError(
            f"data preflight failed for data_path={root!r} "
            f"(datasets={cfg.get('datasets')!r}) — "
            f"{len(issues)} problem(s):\n  - " + "\n  - ".join(issues)
            + "\n(set preflight=0 to skip)")
