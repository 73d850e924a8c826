"""Utilities: logging, TensorBoard, checkpoints, the encoder transfer,
profiling and the JAX-to-port weight mapper."""

from hpfg_tpu_torch.utils.logging import get_logger, mk_path  # noqa: F401
from hpfg_tpu_torch.utils.tb import TBWriter  # noqa: F401
