"""Volume and image evaluation (port of ``hpfg_tpu/evals/volume.py``:
``predict_volume``, ``evaluate_volumes``, ``evaluate_volumes_multi`` and
``evaluate_images``).

Slices of a volume are zoomed to the patch size once (scipy order-0 index
map, as the reference), forwarded in eval mode in chunks through the same
kernels as training (running BN statistics, no statistics epilogue),
argmaxed on the device and zoomed back to native resolution. The forward
is the model's ``val`` (eval-mode logits, for UNet and UNet_Plus alike).
``evaluate_volumes_multi`` scores several models over the same volumes with
the per-volume work shared (dice on the device, HD95 through
``evals.metrics.binary_hd95`` with the ground truth's EDT computed once);
``evaluate_volumes`` is its one-model call. ``evaluate_images`` scores the
binary 2-D datasets (LIDC, ISIC, Building) batch by batch through the same
forward.

Over W ranks (``mesh``), rank r evaluates the volumes (or batches) whose
index is r modulo W, loading only those (the loaders' ``share``); each
yields a float64 row, the rows are exchanged on the host
(``parallel.distributed.gather_objects``) and summed in index order, as
one process sums them, so every rank gets one process's result bit for
bit. The JAX package splits each volume's slices over its devices instead;
the function computed is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from hpfg_tpu_torch.evals.metrics import (
    binary_hd95,
    calculate_metric_percase,
    calculate_metric_percase_full,
    gt_surface_cache,
)

DEFAULT_CHUNK = 16


def _share(items, mesh):
    """(index, item) of this rank's share: the items whose index is the
    rank modulo W, from the loader's ``share``, which loads only those (in
    one process: every item)."""
    if mesh is None or mesh.world == 1:
        return enumerate(items)
    if not hasattr(items, "share"):
        raise TypeError(f"an eval over {mesh.world} ranks needs a loader "
                        f"with share(rank, world), not {type(items).__name__}")
    return items.share(mesh.rank, mesh.world)


def _gather(tag: str, rows: dict, mesh) -> list:
    """Every rank's {index: row}, merged and in index order."""
    if mesh is None or mesh.world == 1:
        merged = rows
    else:
        from hpfg_tpu_torch.parallel.distributed import gather_objects

        merged = {}
        for part in gather_objects(tag, rows):
            merged.update(part)
    return [merged[i] for i in sorted(merged)]


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
    volume-then-class averaging: ``evaluate_volumes_multi`` of one model."""
    return evaluate_volumes_multi({"model": model}, volumes, num_classes,
                                  patch_size, device, zoom_order)["model"][:3]


@torch.no_grad()
def evaluate_volumes_multi(models: dict, volumes, num_classes: int,
                           patch_size, device: torch.device,
                           zoom_order: int = 0, want_first: bool = False,
                           chunk: int = DEFAULT_CHUNK, mesh=None) -> dict:
    """Evaluate several models ({name: module}) over the same volumes with
    the per-volume work shared:

      * each volume's slices and labels upload once, for every model;
      * each volume's dice is computed on the device (float64, the
        arithmetic of ``calculate_metric_percase``) and read back as one
        row per model;
      * HD95's ground-truth border and distance transform are computed once
        per (volume, class) and shared (``metrics.gt_surface_cache``);
      * the prediction comes back once per (model, volume), at patch size,
        for HD95.

    The rows (dice per class, HD95 per class and whether it counts) are
    summed in volume order. With a ``mesh`` of W ranks each rank evaluates
    its share of the volumes and every rank gets the same sums.

    Returns {name: (mean_dice, mean_hd95, per_class [C-1, 2], first)} with
    the reference's volume-then-class averaging, each model's exactly what
    it would get alone (``first``: (image, label, prediction) of volume 0
    with ``want_first`` on the rank that evaluates it, else None)."""
    if num_classes > 256:
        raise ValueError(f"{num_classes} classes do not fit uint8")
    names = list(models)
    firsts = {n: None for n in names}
    rows = {}
    ph, pw = patch_size
    for i, (image, label) in _share(volumes, mesh):
        image = np.asarray(image, dtype=np.float32)
        label = np.asarray(label)
        d, h, w = image.shape
        resized = _resize_volume(image, patch_size, zoom_order)
        slices = torch.from_numpy(np.ascontiguousarray(
            resized[..., None], dtype=np.float32)).to(device)
        label_d = torch.from_numpy(np.ascontiguousarray(label)).to(device)
        same = (h, w) == (ph, pw)
        ys, xs = _zoom_index_map(ph, h), _zoom_index_map(pw, w)
        ys_d, xs_d = (torch.from_numpy(ys).to(device),
                      torch.from_numpy(xs).to(device))
        gt = [gt_surface_cache(label == c) for c in range(1, num_classes)]
        rows[i] = {}
        for n in names:
            patch = torch.cat([models[n].val(slices[j:j + chunk]).argmax(-1)
                               for j in range(0, d, chunk)])
            pred_d = patch if same else patch[:, ys_d[:, None], xs_d[None, :]]
            dice = _volume_dice(pred_d, label_d, num_classes).cpu().numpy()
            pred = patch.to(torch.uint8).cpu().numpy()
            if not same:
                pred = pred[:, ys[:, None], xs[None, :]]
            hd = np.zeros(num_classes - 1, dtype=np.float64)
            hit = np.zeros(num_classes - 1, dtype=bool)
            for c in range(1, num_classes):
                pmask = pred == c
                if pmask.any() and gt[c - 1]["any"]:
                    hd[c - 1] = binary_hd95(pmask, label == c,
                                            gt_cache=gt[c - 1])
                    hit[c - 1] = True
            rows[i][n] = (dice, hd, hit)
            if want_first and i == 0:
                firsts[n] = (image, label, pred)
    ordered = _gather("volumes", rows, mesh)
    out = {}
    for n in names:
        dice_sum = np.zeros(num_classes - 1, dtype=np.float64)
        hd_sum = np.zeros(num_classes - 1, dtype=np.float64)
        for row in ordered:
            dice, hd, hit = row[n]
            dice_sum += dice
            hd_sum[hit] += hd[hit]
        per_class = np.stack([dice_sum, hd_sum], axis=1) / max(len(ordered),
                                                                1)
        out[n] = (float(per_class[:, 0].mean()), float(per_class[:, 1].mean()),
                  per_class, firsts[n])
    return out


def _volume_dice(pred: torch.Tensor, label: torch.Tensor,
                 num_classes: int) -> torch.Tensor:
    """Per-class dice [C-1] float64 of one volume with the rule of
    ``calculate_metric_percase``: both non-empty -> 2|P and G| / (|P| +
    |G|); the prediction alone non-empty -> 1; else 0. One confusion
    count: label values outside the classes (an ignore value) land in an
    extra column that no class reads."""
    c = num_classes
    lab = torch.where(label < c, label.long(), c)
    conf = torch.bincount((pred * (c + 1) + lab).flatten(),
                          minlength=c * (c + 1)).view(c, c + 1)
    inter = conf.diagonal()[1:].double()
    ps = conf.sum(1)[1:].double()
    gs = conf[:, 1:c].sum(0).double()
    both = (ps > 0) & (gs > 0)
    return torch.where(both, 2.0 * inter / (ps + gs).clamp(min=1),
                       (ps > 0).double())


def evaluate_images(model: torch.nn.Module, loader, device: torch.device,
                    full_metrics: bool = False, mesh=None):
    """Binary 2-D evaluation of a loader of (images [B, H, W, C], labels
    [B, H, W]) batches: each batch's class-1 prediction is scored as one
    case (HD95's distances over the batch's stacked masks) and weighted by
    its size. With a ``mesh`` of W ranks each rank scores its share of the
    batches and every rank gets the same means. Returns the means (dice,
    hd95), or (dice, hd95, jaccard, asd) with ``full_metrics``."""
    metric = (calculate_metric_percase_full if full_metrics
              else calculate_metric_percase)
    rows = {}
    for j, (images, labels) in _share(loader, mesh):
        images = np.asarray(images, dtype=np.float32)
        labels = np.asarray(labels)
        preds = forward_slices(model, images, device)
        bs = images.shape[0]
        rows[j] = (np.asarray(metric(preds == 1, labels == 1)) * bs, bs)
    sums = np.zeros(4 if full_metrics else 2, dtype=np.float64)
    n = 0
    for weighted, bs in _gather("images", rows, mesh):
        sums += weighted
        n += bs
    sums /= max(n, 1)
    return tuple(float(v) for v in sums)
