"""The port stands apart from JAX: importing ``hpfg_tpu_torch`` and running
one tiny Mean-Teacher step on the CPU loads neither ``jax`` nor the JAX
package, the kernel wrappers take their plain versions for CPU tensors
(their launch counters stay 0), and a tensor on neither the CPU nor a CUDA
device is refused instead of falling back.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from hpfg_tpu_torch.ops import bn_act as tba
from hpfg_tpu_torch.ops import conv_block as tcb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STEP = r"""
import json, sys
import numpy as np
import torch
import hpfg_tpu_torch
import hpfg_tpu_torch.evals.volume, hpfg_tpu_torch.run
import hpfg_tpu_torch.train.trainer, hpfg_tpu_torch.utils.jax_weights
from hpfg_tpu_torch.ops import bn_act, conv_block
from hpfg_tpu_torch.train.algorithms import build_algorithm

cfg = dict(model="unet", feature_chns=[8] * 5, num_classes=4, in_channels=1,
           train_crop_size=[16, 16], batch_size=1, unlabel_batch_size=1,
           seed=0, total_itrs=10, step_size=5, opt="sgd", lr=0.01,
           weight_decay=1e-4, momentum=0.9, sched="medical")
algo = build_algorithm("mean_teacher", cfg, dtype=torch.float32,
                       device="cpu")
rng = np.random.default_rng(0)
m = algo.step({
    "label_img": rng.normal(size=(1, 16, 16, 1)).astype(np.float32),
    "label": rng.integers(0, 4, (1, 16, 16)).astype(np.int32),
    "unlabel_img": rng.normal(size=(1, 16, 16, 1)).astype(np.float32)})
print(json.dumps({
    "loss": float(m["loss"]),
    "jax": sorted(k for k in sys.modules
                  if k == "jax" or k.startswith(("jax.", "jaxlib", "flax"))),
    "hpfg_tpu": sorted(k for k in sys.modules
                       if k == "hpfg_tpu" or k.startswith("hpfg_tpu.")),
    "launches": [conv_block.conv3x3_nhwc.launches,
                 conv_block.conv3x3_wgrad_nhwc.launches,
                 bn_act.bn_act.launches, bn_act.bn_act_bwd.launches]}))
"""


def test_port_step_imports_no_jax_and_launches_no_kernel():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _STEP], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [] and out["hpfg_tpu"] == []
    assert out["loss"] == out["loss"] and out["loss"] > 0
    assert out["launches"] == [0, 0, 0, 0]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: tcb.conv3x3_nhwc(_meta(1, 8, 8, 4), _meta(3, 3, 4, 8)),
    lambda: tcb.conv3x3_wgrad_nhwc(_meta(1, 8, 8, 4), _meta(1, 8, 8, 8)),
    lambda: tba.bn_act(_meta(1, 8, 8, 8), _meta(8), _meta(8)),
    lambda: tba.bn_act_bwd(*(_meta(1, 8, 8, 8),) * 2, *(_meta(8),) * 4),
], ids=["conv3x3", "wgrad", "bn_act", "bn_act_bwd"])
def test_wrappers_refuse_non_cuda_devices(call):
    before = (tcb.conv3x3_nhwc.launches, tcb.conv3x3_wgrad_nhwc.launches,
              tba.bn_act.launches, tba.bn_act_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert (tcb.conv3x3_nhwc.launches, tcb.conv3x3_wgrad_nhwc.launches,
            tba.bn_act.launches, tba.bn_act_bwd.launches) == before
