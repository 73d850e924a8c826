"""Data-tree preflight (port of ``hpfg_tpu/data/preflight.py`` for the
ACDC layout, the one the port's loaders read): fail in seconds with every
problem listed, before any model is built.

  acdc, sup_acdc: train_slices.list + data/slices/<n>.h5 (keys image/label,
                  2-D); val.list/test.list + data/<n>.h5 (3-D volumes)
"""

from __future__ import annotations

import os

import numpy as np


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
    import h5py

    if not os.path.isfile(path):
        issues.append(f"{what}: listed file {path} does not exist — list "
                      "and data/ tree out of sync")
        return
    try:
        with h5py.File(path, "r") as h5f:
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


def validate_data_tree(root: str, dataset: str,
                       num_classes: int = 4) -> list[str]:
    """Issues found in ``root`` for ``dataset`` (empty: OK). Bounded work:
    list files plus at most three sample files per split."""
    dataset = str(dataset).lower()
    if dataset not in ("acdc", "sup_acdc"):
        return [f"unknown dataset {dataset!r} — the port's preflight knows "
                "acdc, sup_acdc"]
    if not os.path.isdir(root):
        return [f"data_path {root!r} is not a directory"]
    issues: list[str] = []
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
