"""The Swin-MAE -> SwinUNet encoder transfer of the port
(``utils/pretrain.py``, ``Trainer``'s ``pretrain_ckpt``) against
``hpfg_tpu.utils.pretrain`` on the CPU, on a narrow four-stage geometry
(image 64, patch 4, embed 8, window 2; the MAE depths (2, 2, 2, 2) and
heads (1, 1, 2, 2), the SwinUNet the published depths (2, 2, 6, 2)).

The report must list the same keys as the JAX package's, in the same
order, and every tensor of the new state must equal the JAX result
exactly (a copy). A second target with depths (2, 2, 1, 2) and heads
(1, 1, 2, 4) has a missing block and bias tables of another shape, so all
three lists are exercised. A Trainer with ``pretrain_ckpt`` loads the
MAE's encoder into model2 and the EMA teacher of an S4CVNet, before a
resume, which then wins.
"""

import jax
import numpy as np
import pytest
import torch

from hpfg_tpu.utils import pretrain as jpre
from hpfg_tpu_torch.models.swin_mae import SwinMAE
from hpfg_tpu_torch.models.swinunet import SwinUNet
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.train.trainer import Trainer
from hpfg_tpu_torch.utils import pretrain as tpre
from hpfg_tpu_torch.utils.jax_weights import flatten_tree, module_variables
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

HW = 64
MAE = dict(embed_dim=8, decoder_embed_dim=64, depths=(2, 2, 2, 2),
           num_heads=(1, 1, 2, 2), window_size=2)
UNET = dict(embed_dim=8, depths=(2, 2, 6, 2), num_heads=(1, 1, 2, 2),
            window_size=2)


def _mae(seed=0):
    return SwinMAE(in_channels=1, img_size=HW,
                   generator=torch.Generator().manual_seed(seed), **MAE)


@pytest.mark.parametrize("target", [
    UNET, dict(UNET, depths=(2, 2, 1, 2), num_heads=(1, 1, 2, 4))])
def test_transfer_matches_jax(target):
    mae = _mae()
    unet = SwinUNet(in_channels=1, num_classes=4, img_size=HW,
                    generator=torch.Generator().manual_seed(1), **target)
    mae_params, _ = module_variables(mae)
    unet_params, _ = module_variables(unet)
    new_j, report_j = jpre.transfer_mae_encoder(mae_params, unet_params)
    new_t, report_t = tpre.transfer_mae_encoder(mae.state_dict(),
                                                unet.state_dict())
    assert report_t == report_j
    ref = flatten_tree(jax.device_get(new_j))
    assert set(new_t) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(new_t[k].numpy(), v, err_msg=k)
    n_enc = sum(1 for k in mae.state_dict()
                if k.startswith(("patch_embed", "layer"))
                and not k.startswith("layer_up"))
    assert sum(map(len, report_t.values())) == n_enc
    if target is UNET:
        assert not report_t["skipped_shape"] and \
            not report_t["missing_target"]
    else:
        assert report_t["missing_target"] and report_t["skipped_shape"]


def _s4_cfg(tmp_path, **kw):
    swin = dict(UNET, depths=list(UNET["depths"]),
                num_heads=list(UNET["num_heads"]), drop_rate=0.0,
                attn_drop_rate=0.0, drop_path_rate=0.0)
    common = dict(in_channels=1, num_classes=4, sched="medical",
                  total_itrs=4, step_size=2)
    base = dict(algorithm="s4cvnet", num_classes=4, in_channels=1,
                train_crop_size=[HW, HW], batch_size=2, unlabel_batch_size=2,
                consistency=0.1, consistency_rampup=4.0, ema_decay=0.99,
                seed=0, total_itrs=4, step_size=2,
                save_path=str(tmp_path / "s4"),
                model1=dict(model="unet", feature_chns=[8] * 5,
                            dropout=[0.0] * 5, opt="sgd", lr=0.01,
                            weight_decay=5e-4, momentum=0.9, **common),
                model2=dict(model="swinunet", opt="adamW", lr=0.0008,
                            weight_decay=0.05, **swin, **common))
    base.update(kw)
    return base


def test_trainer_pretrain_ckpt_loads_mae_encoder(tmp_path):
    mae_cfg = dict(algorithm="swin_mae", in_channels=1, num_classes=4,
                   train_crop_size=[HW, HW], batch_size=2, total_itrs=2,
                   step_size=2, opt="adamW", lr=1e-3, weight_decay=0.05,
                   sched="cosine", warmup_epochs=0, warmup_lr=1e-6,
                   min_lr=1e-6, seed=7, **{k: list(v) if isinstance(v, tuple)
                                          else v for k, v in MAE.items()})
    mae_algo = build_algorithm("swinmae", mae_cfg, device="cpu")
    mae_dir = tmp_path / "mae"
    Trainer(mae_cfg, mae_algo, loaders=([], []),
            workdir=str(mae_dir)).save("last")
    mae_state = mae_algo.model.state_dict()

    plain = build_algorithm("s4cvnet", _s4_cfg(tmp_path), device="cpu")
    before = {k: v.clone() for k, v in plain.model2.state_dict().items()}
    plain_trainer = Trainer(_s4_cfg(tmp_path), plain, loaders=([], [], []))
    assert plain_trainer.pretrain_reports == {}
    plain_trainer.save("last")

    cfg = _s4_cfg(tmp_path, pretrain_ckpt=str(mae_dir / "model"))
    algo = build_algorithm("s4cvnet", cfg, device="cpu")
    trainer = Trainer(cfg, algo, loaders=([], [], []))
    assert set(trainer.pretrain_reports) == {"model2", "ema"}
    for name in ("model2", "ema"):
        report = trainer.pretrain_reports[name]
        assert not report["skipped_shape"] and not report["missing_target"]
        state = getattr(algo, name).state_dict()
        for key in report["transferred"]:
            assert torch.equal(state["encoder." + key], mae_state[key]), key
        assert len(report["transferred"]) == sum(
            1 for k in mae_state if k.startswith(("patch_embed", "layer"))
            and not k.startswith("layer_up"))
        # layer2's blocks 2-5 exist only in the SwinUNet: initialized fresh
        key = "encoder.layer2.block5.attn.qkv.kernel"
        assert torch.equal(state[key], before[key])
    # a resume comes after the transfer and restores the checkpoint
    assert trainer.resume("last", strict=True)
    for k, v in algo.model2.state_dict().items():
        assert torch.equal(v, before[k]), k
