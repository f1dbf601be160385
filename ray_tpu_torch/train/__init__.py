"""``ray_tpu_torch.train`` — distributed training.

Reference: ``python/ray/train/``.  Worker-side API: ``report``,
``get_context``, ``get_checkpoint``, ``get_dataset_shard``.  Driver-side:
``TorchTrainer`` / ``DataParallelTrainer`` + AIR configs::

    from ray_tpu_torch import train
    result = train.TorchTrainer(
        loop, scaling_config=train.ScalingConfig(num_workers=1,
                                                 use_gpu=True)).fit()
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig,
)
from ray_tpu_torch.train._checkpoint import (  # noqa: F401
    Checkpoint, restore_pytree, save_pytree,
)
from ray_tpu_torch.train._internal.session import TrainContext, get_session
from ray_tpu_torch.train.backend import (  # noqa: F401
    Backend, BackendConfig, TorchConfig,
)
from ray_tpu_torch.train.base_trainer import (  # noqa: F401
    BaseTrainer, DataParallelTrainer, TorchTrainer,
)
from ray_tpu_torch.train.result import Result  # noqa: F401


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Stream metrics (and optionally a checkpoint) to the driver.

    Reference: ``ray.train.report`` — must be called by every worker, the
    driver records rank 0's metrics once all ranks have reported.
    """
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return TrainContext(get_session())


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    """This worker's shard of ``datasets[name]``: a
    ``ray_tpu_torch.data.Dataset`` (or any object with a ``split(n)``
    method) is split across the workers, ``Dataset.split(n)``
    materializing it in the store first, and each worker reads its
    shard's blocks as a borrower of the driver's refs (``iter_batches``,
    ``iter_device_batches``); any other object is handed to every worker
    unchanged."""
    return get_session().get_dataset_shard(name)
