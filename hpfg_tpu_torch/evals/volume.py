"""Volume and image evaluation (port of ``hpfg_tpu/evals/volume.py``:
``predict_volume``, ``evaluate_volumes`` and ``evaluate_images``).

Slices of a volume are zoomed to the patch size once (scipy order-0 index
map, as the reference), forwarded in eval mode in chunks through the same
kernels as training (running BN statistics, no statistics epilogue),
argmaxed on the device and zoomed back to native resolution. The forward
is the model's ``val`` (eval-mode logits, for UNet and UNet_Plus alike).
Dice and HD95 come from ``evals.metrics.calculate_metric_percase`` (numpy
and scipy). ``evaluate_images`` scores the binary 2-D datasets (LIDC, ISIC,
Building) batch by batch through the same forward.
"""

from __future__ import annotations

import numpy as np
import torch

from hpfg_tpu_torch.evals.metrics import (
    calculate_metric_percase,
    calculate_metric_percase_full,
)

DEFAULT_CHUNK = 16


def _zoom_index_map(in_size: int, out_size: int) -> np.ndarray:
    """Index map replicating scipy.ndimage.zoom(..., order=0) coordinates."""
    if out_size == 1:
        src = np.zeros(1)
    else:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    return np.clip(np.round(src).astype(np.int64), 0, in_size - 1)


def _resize_volume(image: np.ndarray, patch_size, zoom_order: int):
    d, h, w = image.shape
    ph, pw = patch_size
    if (h, w) == (ph, pw):
        return image
    if zoom_order == 0:
        ys = _zoom_index_map(h, ph)
        xs = _zoom_index_map(w, pw)
        return image[:, ys[:, None], xs[None, :]]
    from scipy.ndimage import zoom

    return np.stack([zoom(image[i], (ph / h, pw / w), order=zoom_order)
                     for i in range(d)])


@torch.no_grad()
def forward_slices(model: torch.nn.Module, slices: np.ndarray,
                   device: torch.device, chunk: int = DEFAULT_CHUNK):
    """slices [D, H, W, C_in] -> argmax predictions [D, H, W] int64 (host)."""
    preds = []
    for i in range(0, slices.shape[0], chunk):
        x = torch.from_numpy(np.ascontiguousarray(
            slices[i:i + chunk], dtype=np.float32)).to(device)
        preds.append(model.val(x).argmax(-1).cpu())
    return torch.cat(preds).numpy()


def predict_volume(model: torch.nn.Module, image: np.ndarray, patch_size,
                   device: torch.device, zoom_order: int = 0,
                   chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """image [D, H, W] -> predicted labels [D, H, W] at native resolution."""
    _, h, w = image.shape
    resized = _resize_volume(image, patch_size, zoom_order)
    preds = forward_slices(model, resized[..., None], device, chunk)
    ph, pw = patch_size
    if (h, w) != (ph, pw):
        preds = preds[:, _zoom_index_map(ph, h)[:, None],
                      _zoom_index_map(pw, w)[None, :]]
    return preds


def evaluate_volumes(model: torch.nn.Module, volumes, num_classes: int,
                     patch_size, device: torch.device, zoom_order: int = 0):
    """Evaluate (image [D,H,W], label [D,H,W]) volumes. Returns
    (mean_dice, mean_hd95, per_class [C-1, 2]) with the reference's
    volume-then-class averaging."""
    metric_sum = np.zeros((num_classes - 1, 2), dtype=np.float64)
    count = 0
    for image, label in volumes:
        image = np.asarray(image, dtype=np.float32)
        label = np.asarray(label)
        pred = predict_volume(model, image, patch_size, device, zoom_order)
        for c in range(1, num_classes):
            metric_sum[c - 1] += calculate_metric_percase(pred == c,
                                                          label == c)
        count += 1
    per_class = metric_sum / max(count, 1)
    return float(per_class[:, 0].mean()), float(per_class[:, 1].mean()), \
        per_class


def evaluate_images(model: torch.nn.Module, loader, device: torch.device,
                    full_metrics: bool = False):
    """Binary 2-D evaluation of a loader of (images [B, H, W, C], labels
    [B, H, W]) batches: each batch's class-1 prediction is scored as one
    case (HD95's distances over the batch's stacked masks) and weighted by
    its size. Returns the means (dice, hd95), or (dice, hd95, jaccard, asd)
    with ``full_metrics``."""
    metric = (calculate_metric_percase_full if full_metrics
              else calculate_metric_percase)
    sums = np.zeros(4 if full_metrics else 2, dtype=np.float64)
    n = 0
    for images, labels in loader:
        images = np.asarray(images, dtype=np.float32)
        labels = np.asarray(labels)
        preds = forward_slices(model, images, device)
        bs = images.shape[0]
        sums += np.asarray(metric(preds == 1, labels == 1)) * bs
        n += bs
    sums /= max(n, 1)
    return tuple(float(v) for v in sums)
