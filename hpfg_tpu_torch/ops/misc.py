"""Misc utility ops (port of ``hpfg_tpu/ops/misc.py``: the reference's
utils/utils.py, utils/knn_monitor.py and utils/enhance helpers that no
trainer wires up).

``saliency_box_masks`` draws its two uniforms from an explicit
``torch.Generator`` on the images' device (``saliency_uniforms``) and
rasterises them deterministically (``saliency_masks_from_uniforms``), so a
test can feed the JAX package's draws to the rasterisation, as
``ops/cutmix.py`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def label_onehot(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[B, H, W] int -> [B, H, W, C] fp32 one-hot, negatives clamped to 0
    and labels >= C all zeros (NHWC; reference label_onehot)."""
    labels = torch.clamp(labels.long(), min=0)
    classes = torch.arange(num_segments, device=labels.device)
    return (labels.unsqueeze(-1) == classes).float()


class Denormalize:
    """Invert a mean/std normalization (reference Denormalize). Channel-last
    numpy arrays."""

    def __init__(self, mean, std):
        mean = np.asarray(mean, np.float32)
        std = np.asarray(std, np.float32)
        self._mean = -mean / std
        self._std = 1.0 / std

    def __call__(self, array: np.ndarray) -> np.ndarray:
        return (np.asarray(array) - self._mean) / self._std


def knn_predict(feature: torch.Tensor, feature_bank: torch.Tensor,
                feature_labels: torch.Tensor, classes: int, knn_k: int = 200,
                knn_t: float = 0.1) -> torch.Tensor:
    """Weighted kNN class scores (reference knn_predict): feature [B, D]
    (L2-normalised), feature_bank [D, N], feature_labels [N]. Returns
    [B, classes] scores."""
    sim = feature.float() @ feature_bank.float()
    sim_weight, sim_indices = torch.topk(sim, knn_k, dim=-1)
    sim_labels = feature_labels.long()[sim_indices]
    one_hot = (sim_labels.unsqueeze(-1)
               == torch.arange(classes, device=sim.device)).float()
    return (one_hot * torch.exp(sim_weight / knn_t)[..., None]).sum(1)


def knn_monitor(embed_fn, memory_batches, test_batches, classes: int,
                knn_k: int = 200, knn_t: float = 0.1, device=None) -> float:
    """SSL representation probe (reference knn_monitor): an L2-normalised
    feature bank from the memory set, test features ranked by weighted kNN;
    returns the top-1 accuracy. ``embed_fn`` maps an image tensor on
    ``device`` to [B, D] features."""
    def embed(images):
        f = embed_fn(torch.as_tensor(np.asarray(images), device=device))
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    bank, labels = [], []
    for images, lbls in memory_batches:
        bank.append(embed(images))
        labels.append(torch.as_tensor(np.asarray(lbls), device=device))
    bank_t = torch.cat(bank).T
    labels_t = torch.cat(labels)
    total, correct = 0, 0
    for images, lbls in test_batches:
        scores = knn_predict(embed(images), bank_t, labels_t, classes, knn_k,
                             knn_t)
        pred = scores.argmax(-1).cpu().numpy()
        correct += int((pred == np.asarray(lbls)).sum())
        total += len(lbls)
    return correct / max(total, 1)


def saliency_uniforms(generator: torch.Generator, batch: int,
                      prop_range=(0.25, 0.5), device=None) -> dict:
    """The two [batch] fp32 draws of one call: ``area`` in ``prop_range``
    and ``log_aspect`` in [-0.5, 0.5)."""
    lo, hi = prop_range
    area = lo + (hi - lo) * torch.rand(batch, generator=generator,
                                       device=device)
    log_aspect = torch.rand(batch, generator=generator, device=device) - 0.5
    return {"area": area, "log_aspect": log_aspect}


def saliency_masks_from_uniforms(images: torch.Tensor,
                                 u: dict) -> torch.Tensor:
    """Rasterise one box per image [B, H, W, C], centred on the peak of a
    gradient-magnitude saliency (the JAX package's on-device proxy of the
    reference's cv2 static saliency), of area ``u["area"]`` and aspect
    exp(``u["log_aspect"]``). Returns [B, H, W, 1] fp32 in {0, 1}."""
    b, h, w, _ = images.shape
    gray = images.float().mean(-1)
    gy = torch.abs(torch.diff(gray, dim=1, prepend=gray[:, :1]))
    gx = torch.abs(torch.diff(gray, dim=2, prepend=gray[:, :, :1]))
    peak = (gy + gx).reshape(b, -1).argmax(-1)
    cy, cx = peak // w, peak % w
    area = u["area"].float()
    aspect = torch.exp(u["log_aspect"].float())
    bh = torch.round(torch.sqrt(area / aspect) * h)
    bw = torch.round(torch.sqrt(area * aspect) * w)
    y0 = torch.clamp(cy - torch.div(bh, 2, rounding_mode="floor"), 0, h - 1)
    x0 = torch.clamp(cx - torch.div(bw, 2, rounding_mode="floor"), 0, w - 1)
    y1 = torch.clamp(y0 + bh, 0, h)
    x1 = torch.clamp(x0 + bw, 0, w)
    ys = torch.arange(h, device=images.device).view(1, h, 1)
    xs = torch.arange(w, device=images.device).view(1, 1, w)

    def edge(t):
        return t.view(-1, 1, 1)

    inside = ((ys >= edge(y0)) & (ys < edge(y1))
              & (xs >= edge(x0)) & (xs < edge(x1)))
    return inside.float()[..., None]


def saliency_box_masks(generator: torch.Generator, images: torch.Tensor,
                       prop_range=(0.25, 0.5)) -> torch.Tensor:
    """Saliency-guided CutMix boxes (reference SaliencyMaskGentor): one box
    per image, drawn from ``generator`` (on the images' device)."""
    return saliency_masks_from_uniforms(images, saliency_uniforms(
        generator, images.shape[0], prop_range, images.device))
