"""Model registry (port of ``hpfg_tpu/models/__init__.py``; ``unet`` and
``unet_plus``).

``build_model(cfg)`` reads a config mapping (``cfg.get``): ``model``,
``in_channels``, ``num_classes`` and the ``feature_chns`` / ``dropout``
hooks that scale the network for tests and benchmarks.
"""

from __future__ import annotations

import torch

from hpfg_tpu_torch.models.unet import UNet, UNetPlus

#: models ported so far; the rest of the zoo is queued in ROADMAP.md
MODELS = {"unet": UNet, "unet_plus": UNetPlus}

#: registry names whose forward returns (logits, h1, h2), which the
#: feature-contrastive algorithms (hpfg) unpack; the JAX package's list
FEATURE_MODELS = frozenset({
    "unet_plus", "swinunet_plus", "segformer_plus", "cmt_plus",
    "uniformer_plus",
})


def returns_features(name: str) -> bool:
    """True when the registry model returns (logits, h1, h2)."""
    return str(name).lower() in FEATURE_MODELS


def build_model(cfg, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Instantiate a model from a config block; parameters are initialized
    from ``generator`` (torch's default init draws)."""
    name = str(cfg.get("model")).lower()
    if name not in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to hpfg_tpu_torch yet "
            "(see ROADMAP.md, Queue 1)")
    kwargs = {}
    if cfg.get("feature_chns") is not None:
        kwargs["feature_chns"] = tuple(cfg.get("feature_chns"))
    if cfg.get("dropout") is not None and \
            not isinstance(cfg.get("dropout"), (int, float)):
        kwargs["dropout"] = tuple(cfg.get("dropout"))
    return MODELS[name](in_channels=int(cfg.get("in_channels", 1)),
                        num_classes=int(cfg.get("num_classes", 4)),
                        dtype=dtype, generator=generator, **kwargs)
