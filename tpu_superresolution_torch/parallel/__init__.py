"""Data parallelism of the port (port of ``tpu_superresolution_tpu/parallel``):
one process a device, the data-parallel train and eval steps, and the
helpers ``evaluate.tiling.sharded_tiled_forward`` and ``Trainer.fit``
build on."""

from .mesh import Mesh, init_multihost, make_mesh, replicate, shard_batch
from .data_parallel import make_dp_eval_step, make_dp_train_step

__all__ = [
    "Mesh",
    "init_multihost",
    "make_mesh",
    "replicate",
    "shard_batch",
    "make_dp_train_step",
    "make_dp_eval_step",
]
