"""Model registry (port of ``hpfg_tpu/models/__init__.py``): every name the
JAX package's ``build_model`` accepts (``unet``, ``unet_plus``,
``unet_lidc``, ``unet_large``, ``swinunet``, ``swinunet_plus``,
``swinunet_lidc``, ``segformer``, ``segformer_plus``, ``transunet``,
``transunet_lidc``, ``cmt``, ``cmt_plus``, ``uniformer_plus``,
``resunet``, ``resunet_plusplus`` / ``resunetplusplus``, ``uctransnet``,
``ssnet`` and ``swinmae``), dispatched as the JAX package dispatches them.

``build_model(cfg)`` reads a config mapping (``cfg.get``): ``model``,
``in_channels``, ``num_classes``, ``train_crop_size`` (the image size of
the transformers, TransUNet, CMT, UniFormer and UCTransNet), ``base_c``
(UNet_Large: 32, or 64 for the LIDC variant), ``mask_ratio`` (Swin-MAE) and
hooks that scale the network or set its rates for tests and benchmarks: the
UNets' and SS-Net's ``feature_chns`` / ``dropout``, Swin-MAE's
``embed_dim``, ``decoder_embed_dim``, ``depths``, ``num_heads``,
``window_size`` and ``drop_path_rate``, the SwinUNets' ``embed_dim``,
``depths``, ``num_heads``, ``window_size``, ``drop_rate``,
``attn_drop_rate`` and ``drop_path_rate``, the SegFormers' ``mit`` (a
``MIT_SETTINGS`` name), ``drop_path_rate`` and ``drop_rate`` (the head's
dropout), the CMTs' ``drop_rate`` (the head's), UniFormer_Plus's
``drop_path_rate`` and ``drop_rate`` (the head's), and TransUNet's and
UCTransNet's ``drop_rate``. A rate left unset is the JAX module's.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.models.cmt import build_cmt
from hpfg_tpu_torch.models.resunet import ResUNet, ResUNetPlusPlus
from hpfg_tpu_torch.models.segformer import build_segformer
from hpfg_tpu_torch.models.ssnet import SSNet
from hpfg_tpu_torch.models.swin_mae import SwinMAE
from hpfg_tpu_torch.models.swinunet import build_swinunet
from hpfg_tpu_torch.models.transunet import build_transunet
from hpfg_tpu_torch.models.uctransnet import UCTransNet
from hpfg_tpu_torch.models.uniformer import UniformerPlus
from hpfg_tpu_torch.models.unet import UNet, UNetLarge, UNetLIDC, UNetPlus

#: the registry: name -> class or builder
MODELS = {"unet": UNet, "unet_plus": UNetPlus, "unet_lidc": UNetLIDC,
          "unet_large": UNetLarge,
          "swinunet": build_swinunet, "swinunet_plus": build_swinunet,
          "swinunet_lidc": build_swinunet,
          "segformer": build_segformer, "segformer_plus": build_segformer,
          "transunet": build_transunet, "transunet_lidc": build_transunet,
          "cmt": build_cmt, "cmt_plus": build_cmt,
          "uniformer_plus": UniformerPlus, "resunet": ResUNet,
          "resunet_plusplus": ResUNetPlusPlus,
          "resunetplusplus": ResUNetPlusPlus, "uctransnet": UCTransNet,
          "ssnet": SSNet, "swinmae": SwinMAE}

#: registry names whose forward returns (logits, h1, h2), which the
#: feature-contrastive algorithms (hpfg) unpack; the JAX package's list
FEATURE_MODELS = frozenset({
    "unet_plus", "swinunet_plus", "segformer_plus", "cmt_plus",
    "uniformer_plus",
})

#: per builder: the hooks it takes (config key -> type)
_SWIN_HOOKS = {"embed_dim": int, "depths": tuple, "num_heads": tuple,
               "window_size": int, "drop_rate": float,
               "attn_drop_rate": float, "drop_path_rate": float}
_SEGFORMER_HOOKS = {"mit": str, "drop_rate": float, "drop_path_rate": float}
_MAE_HOOKS = {"embed_dim": int, "decoder_embed_dim": int, "depths": tuple,
              "num_heads": tuple, "window_size": int,
              "drop_path_rate": float}
_DROP_HOOKS = {"drop_rate": float}
_UNIFORMER_HOOKS = {"drop_rate": float, "drop_path_rate": float}
#: the image-sized builders taking (name, img_size, in_channels,
#: num_classes): name prefix -> (builder, hooks)
_IMAGE_BUILDERS = {"swinunet": (build_swinunet, _SWIN_HOOKS),
                   "segformer": (build_segformer, _SEGFORMER_HOOKS),
                   "transunet": (build_transunet, _DROP_HOOKS),
                   "cmt": (build_cmt, _DROP_HOOKS)}


def returns_features(name: str) -> bool:
    """True when the registry model returns (logits, h1, h2)."""
    return str(name).lower() in FEATURE_MODELS


def _image_size(cfg) -> int:
    size = cfg.get("train_crop_size", 224)
    if isinstance(size, (list, tuple)):
        return int(size[0])
    return int(size)


def _hooks(cfg, types: dict) -> dict:
    return {k: conv(cfg.get(k)) for k, conv in types.items()
            if cfg.get(k) is not None}


def build_model(cfg, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Instantiate a model from a config block; parameters are initialized
    from ``generator``."""
    name = str(cfg.get("model")).lower()
    if name not in MODELS:
        raise NotImplementedError(f"unknown model {name!r}")
    in_channels = int(cfg.get("in_channels", 1))
    num_classes = int(cfg.get("num_classes", 4))
    common = dict(in_channels=in_channels, num_classes=num_classes,
                  dtype=dtype, generator=generator)
    for prefix, (build, hook_types) in _IMAGE_BUILDERS.items():
        if name.startswith(prefix):
            return build(name, _image_size(cfg), **common,
                         **_hooks(cfg, hook_types))
    if name == "swinmae":
        return SwinMAE(img_size=_image_size(cfg),
                       mask_ratio=float(cfg.get("mask_ratio", 0.75)),
                       in_channels=in_channels, dtype=dtype,
                       generator=generator, **_hooks(cfg, _MAE_HOOKS))
    if name == "uniformer_plus":
        return UniformerPlus(img_size=_image_size(cfg), **common,
                             **_hooks(cfg, _UNIFORMER_HOOKS))
    if name == "uctransnet":
        return UCTransNet(img_size=_image_size(cfg), **common,
                          **_hooks(cfg, _DROP_HOOKS))
    if name == "unet_large":
        return UNetLarge(base_c=int(cfg.get("base_c", 32)), **common)
    if name.startswith("resunet"):
        return MODELS[name](**common)
    kwargs = {}
    if cfg.get("feature_chns") is not None:
        kwargs["feature_chns"] = tuple(cfg.get("feature_chns"))
    if cfg.get("dropout") is not None and \
            not isinstance(cfg.get("dropout"), (int, float)):
        kwargs["dropout"] = tuple(cfg.get("dropout"))
    return MODELS[name](**common, **kwargs)
