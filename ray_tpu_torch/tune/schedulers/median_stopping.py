"""Median stopping rule.

Reference: ``python/ray/tune/schedulers/median_stopping_rule.py`` — stop a
trial at step t if its best metric so far is worse than the median of
other trials' running averages at t.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class MedianStoppingRule(TrialScheduler):
    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_trial_result(self, controller, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        val = result.get(self.metric)
        if val is None:
            return self.CONTINUE
        sign = 1.0 if self.mode == "max" else -1.0
        self._avgs.setdefault(trial.id, []).append(sign * float(val))
        if t < self.grace_period:
            return self.CONTINUE
        others = [np.mean(v) for tid, v in self._avgs.items()
                  if tid != trial.id]
        if len(others) < self.min_samples:
            return self.CONTINUE
        best = max(self._avgs[trial.id])
        if best < np.median(others):
            return self.STOP
        return self.CONTINUE
