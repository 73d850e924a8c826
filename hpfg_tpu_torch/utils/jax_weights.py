"""Map the JAX package's model variables onto the port's modules.

The port names its modules and parameters as the flax modules do, and keeps
conv kernels HWIO ``[kh, kw, C, F]``, so the mapping is a flattening:
flax ``params/encoder/in_conv/conv1/kernel`` becomes the state-dict key
``encoder.in_conv.conv1.kernel`` and ``batch_stats/.../bn1/mean`` the
buffer ``....bn1.mean``. No transposition is needed. Inputs are nested dicts
of numpy-convertible arrays (``jax.device_get`` of a flax variable tree), so
this module needs no jax. Flax ``Dense`` kernels are ``[in, out]``, and the
port's ``Dense`` keeps that layout too.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


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
    """The module's parameters and buffers as flat fp32 numpy arrays, keyed
    like ``flatten_tree`` of the flax variables."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in module.state_dict().items()}


#: the model fields of the JAX algorithm states and the port's algorithms
#: (Mean-Teacher: model, ema; HPFG: model1, model2, ema)
STATE_MODELS = ("model", "model1", "model2", "ema")


def load_jax_state(algorithm, state) -> None:
    """Load every model of a JAX algorithm state (a host copy, e.g.
    ``jax.device_get(state)``) into the port's algorithm: each field of
    STATE_MODELS that both have, parameters and BN statistics."""
    for name in STATE_MODELS:
        if hasattr(state, name) and hasattr(algorithm, name):
            mstate = getattr(state, name)
            load_jax_weights(getattr(algorithm, name), mstate.params,
                             mstate.batch_stats)
