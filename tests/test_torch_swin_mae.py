"""Swin-MAE's slice of the port against the JAX package on the CPU: the
window masking, the forward and three pretraining steps, in fp32, on a
narrow geometry (image 32, patch 4, embed 8, decoder embed 16, depths
(2, 2), heads (1, 2), window 2, no drop path, mask window 4: 2 x 2 windows
of which one is kept), the flax SwinMAE built directly (its registry has no
depths hook) and given the port's weights.

The masking noise is injected: ``window_masking`` is called with an
explicit key on the JAX side, whose uniform draw the port gets as its
noise; for the steps, whose flax forward draws from ``make_rng("mask")``,
the port gets a noise whose argsort keeps the windows the JAX step's own
mask keeps (0 on them, 1 elsewhere).

Tolerances: forwards and losses to 1e-4 of the reference's largest
magnitude, the masks exactly, after three adamW steps parameters to 1e-4
absolute (adamW's first updates are nearly +-lr whatever the gradient's
size, so a sign flip of a near-zero gradient would show as O(lr); with
these weights none happens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hpfg_tpu.config import Config
from hpfg_tpu.models.swin_mae import SwinMAE as FlaxSwinMAE
from hpfg_tpu.models.swin_mae import get_2d_sincos_pos_embed as jax_sincos
from hpfg_tpu.train.algorithms import build_algorithm as jax_build_algorithm
from hpfg_tpu.train.algorithms.base import ModelState
from hpfg_tpu.train.algorithms.swin_mae import SwinMAEState
from hpfg_tpu_torch.models.swin_mae import SwinMAE, get_2d_sincos_pos_embed
from hpfg_tpu_torch.ops import window_attention as wa
from hpfg_tpu_torch.train.algorithms import build_algorithm
from hpfg_tpu_torch.utils.jax_weights import (
    flatten_tree,
    load_jax_state,
    module_arrays,
    module_variables,
)
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REL_TOL = 1e-4
PARAM_ATOL = 1e-4
HW, B = 32, 2
GEOM = dict(embed_dim=8, decoder_embed_dim=16, depths=(2, 2),
            num_heads=(1, 2), window_size=2, drop_path_rate=0.0)


def _rel(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: rel err {err:.2e}"


def _flax():
    return FlaxSwinMAE(in_channels=1, img_size=HW, **GEOM)


def _port(seed):
    return SwinMAE(in_channels=1, img_size=HW,
                   generator=torch.Generator().manual_seed(seed), **GEOM)


def _img(seed):
    return np.random.default_rng(seed).normal(size=(B, HW, HW, 1)).astype(
        np.float32)


def test_masking_and_forward_match_flax():
    model = _port(2)
    params, _ = module_variables(model)
    fm = _flax()
    v = {"params": params}
    x = _img(0)
    key = jax.random.PRNGKey(5)
    d2 = model.windows()
    noise = np.array(jax.random.uniform(key, (B, d2)))
    tokens = np.random.default_rng(1).normal(size=(B, 8, 8, 8)).astype(
        np.float32)
    mj, maskj = fm.apply(v, tokens, key, method=FlaxSwinMAE.window_masking)
    mt, maskt = model.window_masking(torch.from_numpy(tokens),
                                     torch.from_numpy(noise))
    np.testing.assert_array_equal(maskt.numpy(), np.asarray(maskj))
    np.testing.assert_array_equal(mt.detach().numpy(), np.asarray(mj))
    assert float(maskt.mean()) == 0.75

    latent, mask = fm.apply(v, x, key, False,
                            method=FlaxSwinMAE.forward_encoder)
    pred = fm.apply(v, latent, False, method=FlaxSwinMAE.forward_decoder)
    pred_img = fm.apply(v, pred, method=FlaxSwinMAE.unpatchify)
    for train in (False, True):
        pt, mkt = model(torch.from_numpy(x), train=train,
                        noise=torch.from_numpy(noise))
        _rel(pt.detach(), pred_img, what=f"reconstruction train={train}")
        np.testing.assert_array_equal(
            mkt.numpy()[..., 0].reshape(B, 8, 4, 8, 4)[:, :, 0, :, 0]
            .reshape(B, -1), np.asarray(mask))
    lt = model.forward_loss(torch.from_numpy(x),
                            torch.from_numpy(np.array(pred)),
                            torch.from_numpy(np.array(mask)))
    lj = fm.apply(v, x, pred, mask, method=FlaxSwinMAE.forward_loss)
    _rel(lt.item(), float(lj), what="forward_loss")
    np.testing.assert_array_equal(
        model.patchify(torch.from_numpy(x)).numpy(),
        np.asarray(fm.apply(v, x, method=FlaxSwinMAE.patchify)))
    np.testing.assert_allclose(get_2d_sincos_pos_embed(8, 8),
                               jax_sincos(8, 8))
    assert "pos_embed" not in model.state_dict()


def _cfg(**kw):
    base = dict(algorithm="swin_mae", model="swinmae", in_channels=1,
                num_classes=4, train_crop_size=[HW, HW], batch_size=B,
                mask_ratio=0.75, seed=0, total_itrs=20, step_size=10,
                opt="adamW", lr=1e-3, weight_decay=0.05, sched="cosine",
                warmup_epochs=0, warmup_lr=1e-6, min_lr=1e-6,
                epoch_unit_iters=1, **GEOM)
    base.update(kw)
    return Config(base)


def _noise_keeping(mask_img):
    """[B, d^2] noise whose stable argsort keeps the windows that the mask
    (NHWC, 1 = masked) keeps: 0 on kept windows, 1 on masked ones."""
    m = np.asarray(mask_img)[..., 0]
    top_left = m[:, ::16, ::16]  # 4 x 4 patches of 4 px per window
    return torch.from_numpy(top_left.reshape(B, -1).astype(np.float32))


def test_three_swin_mae_steps_match_jax():
    jalgo = jax_build_algorithm("swin_mae", _cfg(), dtype=jnp.float32)
    jalgo.model = _flax()
    src = build_algorithm("swinmae", _cfg(seed=1), device="cpu")
    params, stats = module_variables(src.model)
    assert not stats
    state = SwinMAEState(step=jnp.zeros((), jnp.int32),
                         rng=jax.random.PRNGKey(0),
                         model=ModelState(params=params, batch_stats={}),
                         opt_state=jalgo.tx.init(params))
    talgo = build_algorithm("swin_mae", _cfg(), device="cpu")
    load_jax_state(talgo, jax.device_get(state))
    assert talgo.eval_models() == {}

    step = jax.jit(jalgo.step)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = {"image": rng.normal(size=(B, HW, HW, 1)).astype(np.float32),
                 "label": np.zeros((B, HW, HW), np.int32)}
        _, d_rng, m_rng = jax.random.split(state.rng, 3)
        _, mask = jalgo.model.apply(
            {"params": state.model.params}, batch["image"], train=True,
            rngs={"dropout": d_rng, "mask": m_rng})
        state, m_j = step(state, batch)
        m_t = talgo.step(batch, noise=_noise_keeping(mask))
        assert set(m_t) == set(m_j)
        _rel(float(m_t["loss"]), float(m_j["loss"]), what="loss")
        np.testing.assert_allclose(m_t["lr"], float(m_j["lr"]), rtol=1e-6)
    ref = flatten_tree(jax.device_get(state).model.params)
    got = module_arrays(talgo.model)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
    panels = talgo.image_panels(batch)
    assert sorted(panels) == ["swin_mae/image", "swin_mae/masked",
                              "swin_mae/reconstruction"]
    for p in panels.values():
        assert p.dtype == np.uint8 and p.shape == (HW, HW, 3)


def test_window_attention_runs_over_every_window(monkeypatch):
    """Every token goes through the blocks: each attention call covers all
    windows of its stage at the batch (B * 16 and B * 4 here), 4 calls
    forward a step."""
    seen = []
    real = wa.window_attention

    def recording(qkv, *a, **k):
        seen.append(qkv.shape[0])
        return real(qkv, *a, **k)

    import hpfg_tpu_torch.models.swinunet as swinunet

    monkeypatch.setattr(swinunet, "window_attention", recording)
    model = _port(0)
    model(torch.from_numpy(_img(2)), train=True,
          generator=torch.Generator().manual_seed(0))
    # encoder stages at 8 and 4 tokens, decoder stage at 8 tokens
    assert seen == [B * 16, B * 16, B * 4, B * 4, B * 16, B * 16]
