"""AIR umbrella: shared config/result/checkpoint types.

Reference: ``python/ray/air/`` — ``Checkpoint``, ``Result``,
``ScalingConfig``/``RunConfig``/``FailureConfig``/``CheckpointConfig``
shared by Train and Tune.
"""

from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig,
)
from ray_tpu_torch.train._checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train.result import Result  # noqa: F401
