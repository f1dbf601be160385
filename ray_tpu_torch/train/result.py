"""Training result.

Reference: ``ray.air.Result`` / ``ray.train.Result``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train._checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: Optional[str] = None
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    best_checkpoints: List[Tuple[Checkpoint, Dict[str, Any]]] = \
        field(default_factory=list)

    @property
    def metrics_dataframe(self):
        import pandas as pd
        return pd.DataFrame(self.metrics_history)

    def __repr__(self) -> str:
        status = "ERROR" if self.error else "OK"
        return (f"Result({status}, metrics={self.metrics}, "
                f"checkpoint={self.checkpoint})")
