"""Run/scaling/failure/checkpoint configuration.

Reference: ``python/ray/air/config.py``.  ``ScalingConfig`` takes the
reference's ``use_gpu``: every worker's bundle then asks for CUDA cards
(``"GPU"``), one each unless ``resources_per_worker`` says otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    """How many workers and what each one holds.

    num_workers: data-parallel worker count, one actor each.
    use_gpu: every worker gets CUDA cards: ``resources_per_worker["GPU"]``
        of them, 1.0 by default (0.5 lets two workers share one card).
    resources_per_worker: resources per worker (``"CPU"`` defaults to 1).
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    @property
    def num_gpus_per_worker(self) -> float:
        if not self.use_gpu:
            return 0.0
        return float((self.resources_per_worker or {}).get("GPU", 1.0))

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res["GPU"] = self.num_gpus_per_worker
        else:
            res.pop("GPU", None)
        return res


@dataclass
class FailureConfig:
    """Reference: ``ray.air.FailureConfig`` — worker-group restarts from the
    last checkpoint, up to ``max_failures`` (-1 = unlimited)."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Reference: ``ray.air.CheckpointConfig`` — retention policy."""

    num_to_keep: Optional[int] = None


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
