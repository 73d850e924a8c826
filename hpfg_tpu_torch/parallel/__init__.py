"""Data parallelism over processes (port of ``hpfg_tpu/parallel``)."""

from hpfg_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    Rows,
    get_mesh,
    make_mesh,
    shard_batch,
)
