"""HyperBand: bracketed successive halving.

Reference: ``python/ray/tune/schedulers/hyperband.py`` — trials are
assigned round-robin to brackets with different (initial budget, halving
aggressiveness) trade-offs; within a bracket, survivors at each milestone
are the top ``1/eta`` by metric.  Versus ASHA (async_hyperband.py), the
bracket structure hedges the choice of grace period; decisions here stay
asynchronous per-report (no barrier), matching the reference's practical
behavior under streaming results.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _Bracket:
    def __init__(self, r0: int, max_t: int, eta: float):
        self.milestones: List[int] = []
        t = r0
        while t < max_t:
            self.milestones.append(int(t))
            t = int(math.ceil(t * eta))
        self.recorded: Dict[int, List[float]] = {m: [] for m in self.milestones}


class HyperBandScheduler(TrialScheduler):
    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 max_t: int = 81, reduction_factor: float = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.eta = reduction_factor
        s_max = int(math.floor(math.log(max_t, reduction_factor)))
        # bracket s starts at budget max_t / eta^s (classic HyperBand)
        self.brackets = [
            _Bracket(max(1, int(max_t / reduction_factor ** s)),
                     max_t, reduction_factor)
            for s in range(s_max, -1, -1)]
        self._assignment: Dict[str, int] = {}
        self._next_bracket = 0

    def _bracket_for(self, trial) -> _Bracket:
        b = self._assignment.get(trial.id)
        if b is None:
            b = self._next_bracket % len(self.brackets)
            self._assignment[trial.id] = b
            self._next_bracket += 1
        return self.brackets[b]

    def on_trial_result(self, controller, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        val = result.get(self.metric)
        if t is None or val is None:
            return self.CONTINUE
        if t >= self.max_t:
            return self.STOP
        sign = 1.0 if self.mode == "max" else -1.0
        bracket = self._bracket_for(trial)
        decision = self.CONTINUE
        for m in bracket.milestones:
            if t >= m and m not in trial.rungs_hit:
                trial.rungs_hit.add(m)
                vals = bracket.recorded[m]
                vals.append(sign * float(val))
                k = max(1, int(math.ceil(len(vals) / self.eta)))
                cutoff = sorted(vals, reverse=True)[k - 1]
                if sign * float(val) < cutoff:
                    decision = self.STOP
        return decision
