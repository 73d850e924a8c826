"""TensorBoard image helpers (port of ``hpfg_tpu/utils/visual.py``), in
numpy: ``make_grid``, feature-map grids and train-batch panels. The
first-volume palette panels of an eval live in the Trainer."""

from __future__ import annotations

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              normalize: bool = True, scale_each: bool = True) -> np.ndarray:
    """[N, H, W] or [N, H, W, C] → single [H', W', C] grid image (uint8)."""
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    if normalize:
        if scale_each:
            mins = images.reshape(n, -1).min(1).reshape(n, 1, 1, 1)
            maxs = images.reshape(n, -1).max(1).reshape(n, 1, 1, 1)
        else:
            mins = images.min()
            maxs = images.max()
        images = (images - mins) / np.maximum(maxs - mins, 1e-6)
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + pad) + pad
        x = col * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[i]
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return (grid * 255).astype(np.uint8)


def log_feature_grids(writer, tag_prefix: str, features, step: int,
                      max_channels: int = 64) -> None:
    """Log per-channel feature-map grids of a list of NHWC feature arrays:
    the low-level and the bottleneck features, each channel normalized."""
    names = ["low_level_features", "high_level_features"]
    feats = list(features)
    if len(feats) > 2:
        feats = [feats[1], feats[-1]]  # low level and bottleneck
    for name, feat in zip(names, feats):
        feat = np.asarray(feat)
        channels = np.moveaxis(feat[0], -1, 0)[:max_channels]  # [C, H, W]
        writer.add_image(f"{tag_prefix}/{name}", make_grid(channels, nrow=8),
                         step)


def log_train_panels(writer, images, pred_logits, labels, step: int,
                     label_to_img, tag: str = "train") -> None:
    """Image / argmax-prediction / ground-truth panels of a train batch
    (NHWC images and logits)."""
    images = np.asarray(images)
    writer.add_image(f"{tag}/img", make_grid(images[:4], nrow=2), step)
    preds = np.argmax(np.asarray(pred_logits), axis=-1)
    writer.add_image(f"{tag}/label_pred", label_to_img(preds[0]), step)
    writer.add_image(f"{tag}/label_true",
                     label_to_img(np.asarray(labels)[0]), step)
