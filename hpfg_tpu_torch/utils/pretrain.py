"""Swin-MAE -> SwinUNet encoder transfer (port of
``hpfg_tpu/utils/pretrain.py``), on the port's state dicts.

Swin-MAE's encoder modules are the SwinUNet encoder's, under the same
names, so the transfer matches by key: every MAE tensor under
``patch_embed.*`` or ``layer{i}.*`` (not ``layer_up*``) is copied to
``encoder.<key>`` of the target where that key exists with the same shape.
Swin-MAE pretrains with depths (2, 2, 2, 2) and the SwinUNet has
(2, 2, 6, 2): the blocks both have transfer, the rest keep their fresh
initialization. The report names every MAE encoder tensor once, under
``transferred``, ``skipped_shape`` or ``missing_target``, as the JAX
package's does (sorted by path, keys relative to the encoder).
"""

from __future__ import annotations

from typing import Mapping

import torch

ENCODER_PREFIX = "encoder."


def _is_encoder_key(key: str) -> bool:
    head = key.split(".", 1)[0]
    return head == "patch_embed" or (head.startswith("layer")
                                     and not head.startswith("layer_up"))


def transfer_mae_encoder(mae_state: Mapping[str, torch.Tensor],
                         swinunet_state: Mapping[str, torch.Tensor]):
    """(new state, report): a copy of ``swinunet_state`` (a SwinUNet or
    SwinUNet_Plus state dict, encoder under ``encoder.``) with the MAE
    encoder's tensors copied in, each cast to the target's dtype and
    device; report = {"transferred", "skipped_shape", "missing_target"},
    lists of MAE keys."""
    new_state = dict(swinunet_state)
    report = {"transferred": [], "skipped_shape": [], "missing_target": []}
    keys = sorted((k for k in mae_state if _is_encoder_key(k)),
                  key=lambda k: tuple(k.split(".")))
    for key in keys:
        target = ENCODER_PREFIX + key
        if target not in new_state:
            report["missing_target"].append(key)
            continue
        tgt, value = new_state[target], mae_state[key]
        if tuple(value.shape) != tuple(tgt.shape):
            report["skipped_shape"].append(key)
            continue
        new_state[target] = value.detach().to(tgt.device, tgt.dtype).clone()
        report["transferred"].append(key)
    return new_state, report


def extract_mae_params(saved: Mapping) -> Mapping[str, torch.Tensor]:
    """The Swin-MAE state dict inside a restored object: a trainer
    checkpoint ({"algorithm": {"models": {"model": ...}}}), an algorithm's
    ``state_dict()`` ({"models": {"model": ...}}) or a raw state dict."""
    if "algorithm" in saved:
        saved = saved["algorithm"]
    if "models" in saved:
        saved = saved["models"]
    if "model" in saved and isinstance(saved["model"], Mapping):
        saved = saved["model"]
    return saved


def load_pretrained_encoder(ckpt_dir: str,
                            swinunet_state: Mapping[str, torch.Tensor],
                            tag: str = "last"):
    """Restore checkpoint ``tag`` of a Swin-MAE run's checkpoint directory
    (config key ``pretrain_ckpt``: ``<save_path>/model``) and transfer its
    encoder into ``swinunet_state``; returns (new state, report)."""
    from hpfg_tpu_torch.utils.checkpoint import CheckpointManager

    saved = CheckpointManager(ckpt_dir).restore(tag)
    return transfer_mae_encoder(extract_mae_params(saved), swinunet_state)
