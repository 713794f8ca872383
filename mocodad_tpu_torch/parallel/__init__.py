"""Data parallelism over ranks, one process per device
(mocodad_tpu/parallel/ in the JAX package)."""

from mocodad_tpu_torch.parallel.distributed import (  # noqa: F401
    all_gather_rows, all_reduce_sum, barrier, global_rows, is_distributed,
    is_main_process, launch, local_rows, maybe_initialize, spawn,
    sum_gradients)
from mocodad_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, backend_for, make_mesh, replicate, shard_batch)
