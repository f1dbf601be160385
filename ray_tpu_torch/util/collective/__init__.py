"""``ray_tpu_torch.util.collective`` — collective communication among
actors.

Reference: ``python/ray/util/collective/``.  The shm backend moves numpy
arrays and torch tensors (CPU or CUDA) through the object store.
"""

from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    allgather, allreduce, alltoall, barrier, broadcast,
    create_collective_group, destroy_collective_group,
    get_collective_group_size, get_rank, init_collective_group,
    is_group_initialized, recv, reduce, reducescatter, send,
)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp  # noqa: F401
