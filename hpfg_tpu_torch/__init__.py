"""hpfg_tpu_torch — the PyTorch / CUDA port of ``hpfg_tpu`` for NVIDIA Hopper.

The JAX package ``hpfg_tpu`` stays the reference; this package mirrors its
layout (``models/``, ``ops/``, ``train/``, ``evals/``, ``utils/``) so each
module's counterpart is found by path. Every ConvBlock of the UNet runs
through the hand-written CUDA C++ kernels in ``csrc/conv3x3.cu`` and
``csrc/bn_act.cu``, and every window attention through
``csrc/window_attention.cu``, when its tensors are on a CUDA device; on the
CPU each kernel wrapper takes its plain PyTorch version instead. The
SegFormer, which no Pallas kernel serves in the JAX package, runs on cuDNN
convs and cuBLAS matmuls.

Activations are NHWC and conv weights HWIO ``[3, 3, C, F]``, as in the JAX
package, so weights map one to one (``utils/jax_weights.py``).

This package never imports ``jax``.
"""

__version__ = "0.1.0"
