"""Model registry (port of ``hpfg_tpu/models/__init__.py``; ``unet``,
``unet_plus``, ``swinunet``, ``swinunet_plus``, ``swinunet_lidc``,
``segformer``, ``segformer_plus``, ``ssnet`` and ``swinmae``).

``build_model(cfg)`` reads a config mapping (``cfg.get``): ``model``,
``in_channels``, ``num_classes``, ``train_crop_size`` (the transformers'
image size), ``mask_ratio`` (Swin-MAE) and hooks that scale the network for
tests and benchmarks: the UNets' and SS-Net's ``feature_chns`` /
``dropout``, Swin-MAE's ``embed_dim``, ``decoder_embed_dim``, ``depths``,
``num_heads``, ``window_size`` and ``drop_path_rate``, the SwinUNets'
``embed_dim``, ``depths``, ``num_heads``, ``window_size``, ``drop_rate``,
``attn_drop_rate`` and ``drop_path_rate``, the SegFormers' ``mit`` (a
``MIT_SETTINGS`` name), ``drop_path_rate`` and ``drop_rate`` (the head's
dropout).
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.models.segformer import build_segformer
from hpfg_tpu_torch.models.ssnet import SSNet
from hpfg_tpu_torch.models.swin_mae import SwinMAE
from hpfg_tpu_torch.models.swinunet import build_swinunet
from hpfg_tpu_torch.models.unet import UNet, UNetPlus

#: models ported so far; the rest of the zoo is queued in ROADMAP.md
MODELS = {"unet": UNet, "unet_plus": UNetPlus, "swinunet": build_swinunet,
          "swinunet_plus": build_swinunet, "swinunet_lidc": build_swinunet,
          "segformer": build_segformer, "segformer_plus": build_segformer,
          "ssnet": SSNet, "swinmae": SwinMAE}

#: registry names whose forward returns (logits, h1, h2), which the
#: feature-contrastive algorithms (hpfg) unpack; the JAX package's list
FEATURE_MODELS = frozenset({
    "unet_plus", "swinunet_plus", "segformer_plus", "cmt_plus",
    "uniformer_plus",
})

#: the SwinUNet hooks: config key -> type
_SWIN_HOOKS = {"embed_dim": int, "depths": tuple, "num_heads": tuple,
               "window_size": int, "drop_rate": float,
               "attn_drop_rate": float, "drop_path_rate": float}
#: the SegFormer hooks
_SEGFORMER_HOOKS = {"mit": str, "drop_rate": float, "drop_path_rate": float}
#: the Swin-MAE hooks
_MAE_HOOKS = {"embed_dim": int, "decoder_embed_dim": int, "depths": tuple,
              "num_heads": tuple, "window_size": int,
              "drop_path_rate": float}


def returns_features(name: str) -> bool:
    """True when the registry model returns (logits, h1, h2)."""
    return str(name).lower() in FEATURE_MODELS


def _image_size(cfg) -> int:
    size = cfg.get("train_crop_size", 224)
    if isinstance(size, (list, tuple)):
        return int(size[0])
    return int(size)


def build_model(cfg, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Instantiate a model from a config block; parameters are initialized
    from ``generator``."""
    name = str(cfg.get("model")).lower()
    if name not in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to hpfg_tpu_torch yet "
            "(see ROADMAP.md, Queue 1)")
    in_channels = int(cfg.get("in_channels", 1))
    num_classes = int(cfg.get("num_classes", 4))
    for prefix, hook_types, build in (
            ("swinunet", _SWIN_HOOKS, build_swinunet),
            ("segformer", _SEGFORMER_HOOKS, build_segformer)):
        if name.startswith(prefix):
            hooks = {k: conv(cfg.get(k)) for k, conv in hook_types.items()
                     if cfg.get(k) is not None}
            return build(name, _image_size(cfg), in_channels, num_classes,
                         dtype=dtype, generator=generator, **hooks)
    if name == "swinmae":
        hooks = {k: conv(cfg.get(k)) for k, conv in _MAE_HOOKS.items()
                 if cfg.get(k) is not None}
        return SwinMAE(in_channels=in_channels, img_size=_image_size(cfg),
                       mask_ratio=float(cfg.get("mask_ratio", 0.75)),
                       dtype=dtype, generator=generator, **hooks)
    kwargs = {}
    if cfg.get("feature_chns") is not None:
        kwargs["feature_chns"] = tuple(cfg.get("feature_chns"))
    if cfg.get("dropout") is not None and \
            not isinstance(cfg.get("dropout"), (int, float)):
        kwargs["dropout"] = tuple(cfg.get("dropout"))
    return MODELS[name](in_channels=in_channels, num_classes=num_classes,
                        dtype=dtype, generator=generator, **kwargs)
