"""Loader dispatch (port of ``hpfg_tpu/data/builder.py``, ACDC only).

  * ``acdc``     -> (label, unlabel, test) SSL loaders;
  * ``sup_acdc`` -> (train, test).

The other datasets and the on-device augmentation path (``device_augment``,
``ops/augment.py``) are not ported yet (ROADMAP.md, Queue 1) and raise.
"""

from __future__ import annotations


def build_loader(cfg, seed: int | None = None):
    name = str(cfg.get("datasets")).lower()
    seed = int(cfg.get("seed", 0) if seed is None else seed)
    crop = tuple(cfg.get("train_crop_size"))
    if bool(cfg.get("device_augment", False)):
        raise NotImplementedError(
            "device_augment is not ported to hpfg_tpu_torch yet (ops/augment.py;"
            " ROADMAP.md, Queue 1): set device_augment=false")
    if name == "acdc":
        from hpfg_tpu_torch.data.acdc import get_ssl_acdc_loader

        return get_ssl_acdc_loader(cfg.get("data_path"), cfg.get("batch_size"),
                                   cfg.get("unlabel_batch_size"), crop,
                                   cfg.get("label_num"), seed)
    if name == "sup_acdc":
        from hpfg_tpu_torch.data.acdc import get_acdc_loader

        return get_acdc_loader(cfg.get("data_path"), cfg.get("batch_size"),
                               crop, seed)
    raise NotImplementedError(
        f"datasets {cfg.get('datasets')!r} is not ported to hpfg_tpu_torch yet"
        " (ported: acdc, sup_acdc; see ROADMAP.md, Queue 1)")
