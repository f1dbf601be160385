"""Population-based training.

Reference: ``python/ray/tune/schedulers/pbt.py`` — every
``perturbation_interval`` steps, bottom-quantile trials EXPLOIT a
top-quantile trial (clone its latest checkpoint) and EXPLORE (perturb its
hyperparameters).  Implemented stop-and-clone style: the controller stops
the bottom trial and relaunches it with the mutated config and the donor
checkpoint (the reference's in-place restore is an optimization of the
same semantics).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class PopulationBasedTraining(TrialScheduler):
    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search.sample import Domain
        out = dict(config)
        rng = np.random.default_rng(self._rng.randrange(2**31))
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if self._rng.random() < self.resample_p:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(rng)
                elif isinstance(spec, (list, tuple)):
                    out[key] = self._rng.choice(list(spec))
                elif callable(spec):
                    out[key] = spec()
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(out[key], (int, float)) and \
                        not isinstance(out[key], bool):
                    out[key] = type(out[key])(out[key] * factor)
                elif isinstance(spec, (list, tuple)):
                    out[key] = self._rng.choice(list(spec))
        return out

    def on_trial_result(self, controller, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        val = result.get(self.metric)
        if val is None:
            return self.CONTINUE
        sign = 1.0 if self.mode == "max" else -1.0
        self._scores[trial.id] = sign * float(val)
        last = self._last_perturb.get(trial.id, 0)
        if t - last < self.interval:
            return self.CONTINUE
        self._last_perturb[trial.id] = t
        scores = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(scores)
        if n < 2:
            return self.CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = [tid for tid, _ in scores[:k]]
        top = [tid for tid, _ in scores[-k:]]
        if trial.id in bottom:
            donor_id = self._rng.choice(top)
            donor = controller.get_trial(donor_id)
            if donor is not None and donor.latest_checkpoint_path:
                # stop-and-clone: relaunch with donor ckpt + mutated config
                controller.request_clone(
                    trial, self._mutate(donor.config),
                    donor.latest_checkpoint_path)
                return self.STOP
        return self.CONTINUE
