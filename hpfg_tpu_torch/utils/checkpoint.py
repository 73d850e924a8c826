"""Checkpoints with exact resume (port of ``hpfg_tpu/utils/checkpoint.py``).

A checkpoint is one file per tag, ``<directory>/<tag>.pt``: a plain dict of
tensors, numbers and strings written by ``torch.save`` and read back by
``torch.load(weights_only=True)``, so loading one runs no pickled code. It
holds what the JAX state pytree holds (``Algorithm.state_dict``: models,
optimizers, generators, step count) and the trainer's best dice, so a
resumed run continues bit for bit.

A save writes a temporary file in the same directory, syncs it and renames
it over the tag (``os.replace``, atomic on one file system): a crash leaves
either the old tag or the new one, never half of one, and the temporary
file's name is no tag that a resume would pick. The crash-recovery saves
alternate between ``last_a`` and ``last_b``, so the newest complete one
survives a crash during the next.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

SUFFIX = ".pt"
#: the model fields an algorithm may have, as the JAX states' ModelStates
#: (Supervised: model; Mean-Teacher: model, ema; CPS and CTCT: model1,
#: model2; HPFG and S4CVNet: model1, model2, ema)
MODEL_FIELDS = ("model", "model1", "model2", "ema")
#: the optimizer fields
OPTIMIZER_FIELDS = ("optimizer", "optimizer1", "optimizer2")


class CheckpointManager:
    ROTATE_TAGS = ("last_a", "last_b")

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._rot_idx: int | None = None

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag + SUFFIX)

    def save(self, tag: str, state: dict) -> None:
        """Write ``state`` under ``tag``, atomically."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{tag}.",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            # a file system stamps a file with its clock tick, which two
            # saves can share; stamp it with the nanosecond clock so that
            # latest_resume_tag orders saves made within one tick
            now = time.time_ns()
            os.utime(tmp, ns=(now, now))
            os.replace(tmp, self._path(tag))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def save_rotating(self, state: dict) -> str:
        """The crash-recovery save, alternating ``last_a`` / ``last_b``;
        returns the tag written. A fresh manager first overwrites the older
        of the two, so the newest recovery point (the one a resumed run
        started from) outlives the next save."""
        if self._rot_idx is None:
            age = [self._mtime(t) if self.exists(t) else -1
                   for t in self.ROTATE_TAGS]
            self._rot_idx = 0 if age[0] <= age[1] else 1
        tag = self.ROTATE_TAGS[self._rot_idx]
        self._rot_idx ^= 1
        self.save(tag, state)
        return tag

    def latest_resume_tag(self, preferred: str = "last") -> str | None:
        """The newest tag among ``preferred``, ``last_a`` and ``last_b``, by
        modification time; None when none exists."""
        candidates = [t for t in (preferred,) + self.ROTATE_TAGS
                      if self.exists(t)]
        if not candidates:
            return None
        return max(candidates, key=self._mtime)

    def restore(self, tag: str) -> dict:
        """The dict saved under ``tag``, its tensors on the CPU."""
        return torch.load(self._path(tag), map_location="cpu",
                          weights_only=True)

    def exists(self, tag: str) -> bool:
        return os.path.isfile(self._path(tag))

    def _mtime(self, tag: str) -> int:
        return os.stat(self._path(tag)).st_mtime_ns


def state_mismatches(got, want, prefix: str = "") -> list[str]:
    """The paths at which two checkpoint states differ: tensors compared
    bitwise (dtype, shape and every bit), other leaves by ``==``, dicts by
    their keys and lists by their lengths. Empty when they are equal."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [prefix or "<root>"]
        out = []
        for k in want:
            out += state_mismatches(got[k], want[k], f"{prefix}/{k}")
        return out
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [prefix or "<root>"]
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += state_mismatches(g, w, f"{prefix}/{i}")
        return out
    if torch.is_tensor(want):
        if not (torch.is_tensor(got) and got.dtype == want.dtype
                and got.shape == want.shape):
            return [prefix]
        bits = [t.detach().cpu().reshape(-1).view(torch.uint8)
                for t in (got, want)]
        return [] if torch.equal(*bits) else [prefix]
    return [] if got == want else [prefix]
