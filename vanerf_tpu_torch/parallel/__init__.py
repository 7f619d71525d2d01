"""Data parallelism over ``torch.distributed``: one process a device (port
of ``vanerf_tpu/parallel/``)."""

from .mesh import Mesh, launch, make_mesh, replicate, shard_batch  # noqa: F401
from .train import (batch_pspecs, fold_generator,  # noqa: F401
                    make_parallel_train_step)
