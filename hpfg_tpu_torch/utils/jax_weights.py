"""Map the JAX package's model variables onto the port's modules.

The port names its modules and parameters as the flax modules do, and keeps
conv kernels HWIO ``[kh, kw, C, F]``, so the mapping is a flattening:
flax ``params/encoder/in_conv/conv1/kernel`` becomes the state-dict key
``encoder.in_conv.conv1.kernel`` and ``batch_stats/.../bn1/mean`` the
buffer ``....bn1.mean``. No transposition is needed. Inputs are nested dicts
of numpy-convertible arrays (``jax.device_get`` of a flax variable tree), so
this module needs no jax. Flax ``Dense`` kernels are ``[in, out]``, and the
port's ``Dense`` keeps that layout too. The same holds for every model of
the registry: the UNets and UNet_Large, the SwinUNets and the SegFormers
(whose head's BatchNorm statistics are ``batch_stats/decoder/bn/{mean,
var}``), SS-Net (its heads' ``Dense_0`` / ``BatchNorm_0`` / ``Dense_1``),
Swin-MAE, TransUNet (``vit.cls_token`` [1, 1, dim] and ``vit.embedding``
[tokens + 1, dim], sized by the image), CMT (``encoder.relative_pos_{s}``
[heads, N, N / sr^2], one parameter of the encoder per stage, not of its
blocks), UniFormer_Plus, ResUNet / ResUNet++ (the squeeze-excitation's
``Dense_0`` / ``Dense_1``) and UCTransNet (``mtc.pos_embed{i}``). A
depthwise kernel is ``[k, k, 1, C]`` on both sides (flax's
``feature_group_count=C`` layout), and every family's BatchNorm
statistics are ``batch_stats/.../{mean,var}``: no special case is needed,
and ``load_jax_weights`` refuses any name or shape that differs.
``module_variables`` goes the other way, for tests that start a JAX state
from the port's weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from hpfg_tpu_torch.utils.checkpoint import MODEL_FIELDS


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a.b': np.asarray(x)}."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def jax_to_torch_state(params: Mapping,
                       batch_stats: Mapping | None = None
                       ) -> dict[str, torch.Tensor]:
    """A state dict for the port's module from flax ``params`` and
    ``batch_stats`` (fp32 copies)."""
    flat = flatten_tree(params)
    flat.update(flatten_tree(batch_stats or {}))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def load_jax_weights(module: torch.nn.Module, params: Mapping,
                     batch_stats: Mapping | None = None) -> None:
    """Load flax variables into ``module`` (strict: every parameter and
    buffer must be matched, by name and shape)."""
    state = jax_to_torch_state(params, batch_stats)
    own = module.state_dict()
    for key, value in state.items():
        if key in own and tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: flax shape {tuple(value.shape)} vs "
                             f"port shape {tuple(own[key].shape)}")
    module.load_state_dict(state, strict=True)


def module_arrays(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """The module's parameters and buffers as flat fp32 numpy arrays (copies,
    not views of the live tensors), keyed like ``flatten_tree`` of the flax
    variables."""
    return {k: np.array(v.detach().float().cpu().numpy())
            for k, v in module.state_dict().items()}


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """{'a.b': x} -> {'a': {'b': x}}, the inverse of ``flatten_tree``."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def module_variables(module: torch.nn.Module) -> tuple[dict, dict]:
    """The module's flax variables as nested dicts of fp32 numpy arrays:
    (``params`` from its parameters, ``batch_stats`` from its buffers)."""
    arrays = module_arrays(module)
    names = {k for k, _ in module.named_parameters()}
    return (unflatten_tree({k: v for k, v in arrays.items() if k in names}),
            unflatten_tree({k: v for k, v in arrays.items()
                            if k not in names}))


def load_jax_state(algorithm, state) -> None:
    """Load every model of a JAX algorithm state (a host copy, e.g.
    ``jax.device_get(state)``) into the port's algorithm: each model field
    (``MODEL_FIELDS``) that both have, parameters and BN statistics, and
    SS-Net's memory bank (``memory``, ``memory_valid``). A model without
    BatchNorm (the SwinUNet, Swin-MAE) has empty ``batch_stats``; SS-Net's
    heads and Swin-MAE's ``mask_token`` are parameters like any other."""
    for name in MODEL_FIELDS:
        if hasattr(state, name) and hasattr(algorithm, name):
            mstate = getattr(state, name)
            load_jax_weights(getattr(algorithm, name), mstate.params,
                             mstate.batch_stats)
    for name in ("memory", "memory_valid"):
        if hasattr(state, name) and hasattr(algorithm, name):
            own = getattr(algorithm, name)
            setattr(algorithm, name, torch.from_numpy(
                np.array(getattr(state, name))).to(own.device, own.dtype))
