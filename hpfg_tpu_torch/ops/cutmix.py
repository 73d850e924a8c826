"""CutMix box masks (port of ``hpfg_tpu/ops/cutmix.py``, at the options the
HPFG trainer uses: proportion range (0.25, 0.5), 4 boxes, random aspect
ratio, proportion by area, within bounds, inverted so the mask is 1 inside
the boxes; overlapping boxes toggle it, so a pixel under k boxes ends at
parity k).

``box_masks`` draws its uniforms from an explicit ``torch.Generator`` on the
masks' device (``box_uniforms``) and rasterises them deterministically
(``masks_from_uniforms``), so a test can feed the JAX package's uniforms to
the rasterisation and compare bit for bit.
"""

from __future__ import annotations

import math

import torch

PROP_RANGE = (0.25, 0.5)
N_BOXES = 4


def box_uniforms(generator: torch.Generator, n_masks: int,
                 device=None) -> dict:
    """The four [n_masks, N_BOXES] fp32 draws of one call: ``props`` (box
    area proportion) in PROP_RANGE, and ``aspect``, ``pos_y``, ``pos_x`` in
    [0, 1)."""
    def rand():
        return torch.rand((n_masks, N_BOXES), generator=generator,
                          device=device)

    lo, hi = PROP_RANGE
    return {"props": lo + (hi - lo) * rand(), "aspect": rand(),
            "pos_y": rand(), "pos_x": rand()}


def masks_from_uniforms(u: dict, mask_shape: tuple[int, int]) -> torch.Tensor:
    """Rasterise the boxes of ``u`` (see :func:`box_uniforms`) into masks
    [N, H, W, 1] fp32 in {0, 1}, in the JAX package's fp32 arithmetic."""
    h, w = mask_shape
    props = u["props"]
    y_props = torch.exp(u["aspect"] * torch.log(torch.clamp(props,
                                                            min=1e-12)))
    x_props = props / torch.clamp(y_props, min=1e-12)
    zero = props == 0.0
    fac = math.sqrt(1.0 / props.shape[1])
    y_props = torch.where(zero, 0.0, y_props) * fac
    x_props = torch.where(zero, 0.0, x_props) * fac
    sizes_y = torch.round(y_props * h)
    sizes_x = torch.round(x_props * w)
    y0 = torch.round((h - sizes_y) * u["pos_y"])
    x0 = torch.round((w - sizes_x) * u["pos_x"])

    def edge(t):
        return t.to(torch.int32)[..., None, None]

    ys = torch.arange(h, device=props.device).view(1, 1, h, 1)
    xs = torch.arange(w, device=props.device).view(1, 1, 1, w)
    inside = ((ys >= edge(y0)) & (ys < edge(y0 + sizes_y))
              & (xs >= edge(x0)) & (xs < edge(x0 + sizes_x)))
    parity = inside.to(torch.int32).sum(1) % 2
    return parity.to(torch.float32)[..., None]


def box_masks(generator: torch.Generator, n_masks: int,
              mask_shape: tuple[int, int], device=None) -> torch.Tensor:
    """CutMix masks [n_masks, H, W, 1] (fp32 in {0, 1}) drawn from
    ``generator`` (on ``device``)."""
    return masks_from_uniforms(box_uniforms(generator, n_masks, device),
                               mask_shape)
