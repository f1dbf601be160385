"""ASHA: asynchronous successive halving.

Reference: ``python/ray/tune/schedulers/async_hyperband.py``
(``AsyncHyperBandScheduler`` / alias ``ASHAScheduler``): rungs at
``grace_period * reduction_factor**k``; when a trial reports at a rung it
is stopped unless its metric is in the top ``1/reduction_factor`` of all
results recorded at that rung.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class AsyncHyperBandScheduler(TrialScheduler):
    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestones
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(int(t))
            t *= reduction_factor
        # rung -> recorded metric values
        self._recorded: Dict[int, List[float]] = {r: [] for r in self.rungs}

    def on_trial_result(self, controller, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        val = result.get(self.metric)
        if t is None or val is None:
            return self.CONTINUE
        if t >= self.max_t:
            return self.STOP
        sign = 1.0 if self.mode == "max" else -1.0
        # rungs this report crosses for the first time
        crossed = [r for r in self.rungs
                   if t >= r and r not in trial.rungs_hit]
        decision = self.CONTINUE
        for rung in crossed:
            trial.rungs_hit.add(rung)
            vals = self._recorded[rung]
            vals.append(sign * float(val))
            k = max(1, int(np.ceil(len(vals) / self.rf)))
            cutoff = sorted(vals, reverse=True)[k - 1]
            if sign * float(val) < cutoff:
                decision = self.STOP
        return decision


ASHAScheduler = AsyncHyperBandScheduler
