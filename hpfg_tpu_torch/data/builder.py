"""Loader dispatch (port of ``hpfg_tpu/data/builder.py``).

The config's ``datasets`` name picks the loaders:

  * ``acdc``, ``lidc``, ``isic``, ``synapse`` -> (label, unlabel, test);
  * ``sup_acdc``, ``sup_lidc``, ``sup_isic``, ``sup_synapse`` -> (train,
    test);
  * ``sup_building`` -> (train, val, test).

An unknown name raises ``ValueError``. The on-device augmentation path
(``device_augment``, ``ops/augment.py``) is not ported yet (ROADMAP.md,
Queue 1) and raises.
"""

from __future__ import annotations

import importlib

#: dataset name -> the data module whose ``get_ssl_<module>_loader`` (SSL)
#: or ``get_<module>_loader`` (supervised) builds its loaders
_SSL = {"acdc": "acdc", "lidc": "lidc", "isic": "isic", "synapse": "synapse"}
_SUP = {"sup_acdc": "acdc", "sup_lidc": "lidc", "sup_isic": "isic",
        "sup_synapse": "synapse", "sup_building": "building"}


def build_loader(cfg, seed: int | None = None):
    name = str(cfg.get("datasets")).lower()
    seed = int(cfg.get("seed", 0) if seed is None else seed)
    crop = tuple(cfg.get("train_crop_size"))
    if name not in _SSL and name not in _SUP:
        raise ValueError(f"unknown datasets {cfg.get('datasets')!r}")
    if bool(cfg.get("device_augment", False)):
        raise NotImplementedError(
            "device_augment is not ported to hpfg_tpu_torch yet (ops/augment.py;"
            " ROADMAP.md, Queue 1): set device_augment=false")
    if name in _SSL:
        module = importlib.import_module(f"hpfg_tpu_torch.data.{_SSL[name]}")
        return getattr(module, f"get_ssl_{_SSL[name]}_loader")(
            cfg.get("data_path"), cfg.get("batch_size"),
            cfg.get("unlabel_batch_size"), crop, cfg.get("label_num"), seed)
    module = importlib.import_module(f"hpfg_tpu_torch.data.{_SUP[name]}")
    return getattr(module, f"get_{_SUP[name]}_loader")(
        cfg.get("data_path"), cfg.get("batch_size"), crop, seed)
