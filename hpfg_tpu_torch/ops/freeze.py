"""Parameter freezing over the port's optimizers (port of
``hpfg_tpu/ops/freeze.py``; reference model/base.py
EncoderDecoder.freeze / unfreeze and the config keys freeze_train /
unfreeze_itrs).

Both follow the optax wrappers exactly, which a ``requires_grad`` flip
would not:

  * ``freeze_subtrees`` is ``optax.multi_transform`` with ``set_to_zero``:
    the frozen top-level subtrees get no update and no optimizer state, so
    the inner optimizer is built over the other parameters alone;
  * ``unfreeze_after`` runs the inner optimizer on EVERY gradient, all
    parameters included, and zeroes only the frozen subtrees' updates for
    the first ``unfreeze_itrs`` steps: their momentum and Adam moments
    advance while they are frozen, weight decay moves nothing, and the
    first update after the switch carries the accumulated state.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch


def subtree_parameters(module: torch.nn.Module, keys: Iterable[str],
                       inside: bool) -> list[torch.nn.Parameter]:
    """The parameters of ``module`` whose top-level name (the first part of
    the dotted name, the flax params' top key) is in ``keys`` (``inside``)
    or is not."""
    keys = set(keys)
    return [p for name, p in module.named_parameters()
            if (name.split(".")[0] in keys) == inside]


def freeze_subtrees(make_optimizer: Callable, module: torch.nn.Module,
                    frozen_keys: Sequence[str]) -> torch.optim.Optimizer:
    """The optimizer ``make_optimizer(params)`` over every parameter of
    ``module`` outside the top-level subtrees ``frozen_keys``, which it
    never updates and holds no state for."""
    return make_optimizer(subtree_parameters(module, frozen_keys, False))


class UnfreezeAfter:
    """An optimizer whose steps leave ``frozen`` parameters where they were
    for the first ``unfreeze_itrs`` steps, while the inner optimizer still
    runs on their gradients (see the module docstring). Steps are counted
    from 0, as optax's step counter; ``param_groups``, ``zero_grad``,
    ``state_dict`` and ``load_state_dict`` are the inner optimizer's, the
    step count included."""

    def __init__(self, inner: torch.optim.Optimizer,
                 frozen: Sequence[torch.nn.Parameter], unfreeze_itrs: int):
        self.inner = inner
        self.frozen = list(frozen)
        self.unfreeze_itrs = int(unfreeze_itrs)
        self.count = 0

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        keep = None
        if self.count < self.unfreeze_itrs:
            keep = [p.detach().clone() for p in self.frozen]
        self.inner.step()
        if keep is not None:
            for p, v in zip(self.frozen, keep):
                p.copy_(v)
        self.count += 1

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def unfreeze_after(make_optimizer: Callable, module: torch.nn.Module,
                   frozen_keys: Sequence[str],
                   unfreeze_itrs: int) -> UnfreezeAfter:
    """``make_optimizer(params)`` over every parameter of ``module``, with
    the top-level subtrees ``frozen_keys`` held still for the first
    ``unfreeze_itrs`` steps (:class:`UnfreezeAfter`)."""
    return UnfreezeAfter(make_optimizer(list(module.parameters())),
                         subtree_parameters(module, frozen_keys, True),
                         unfreeze_itrs)
