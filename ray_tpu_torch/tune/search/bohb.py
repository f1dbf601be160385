"""BOHB: Bayesian Optimization + HyperBand (native, no deps).

Reference analog: ``python/ray/tune/search/bohb/`` — Ray wraps the
``hpbandster`` package; this is a from-scratch implementation of the
same published algorithm (Falkner, Klein, Hutter, ICML 2018): run
HyperBand's bracketed successive halving for budget allocation, but
replace its random sampling with a TPE-style model.  The model for a new
suggestion is built from observations at the LARGEST budget that has
enough of them (the paper's |D_b| >= d + 2 rule) — low-budget results
bootstrap the model early, high-budget results dominate once available.

Pairs with ``HyperBandScheduler`` (``HyperBandForBOHB`` is the
reference-named alias) — the scheduler prunes, the searcher proposes:

    tune.Tuner(train_fn, tune_config=tune.TuneConfig(
        search_alg=BOHBSearcher(), scheduler=HyperBandForBOHB(...)))
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.schedulers.hyperband import HyperBandScheduler
from ray_tpu_torch.tune.search.tpe import TPESearcher, _walk

# reference-named alias: the reference couples BOHB to a HyperBand
# scheduler subclass; ours needs no coupling beyond the shared
# time_attr, so the alias IS the scheduler
HyperBandForBOHB = HyperBandScheduler


class BOHBSearcher(TPESearcher):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *,
                 time_attr: str = "training_iteration",
                 n_initial_points: int = 6, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode, n_initial_points=n_initial_points,
                         gamma=gamma, n_candidates=n_candidates, seed=seed)
        self.time_attr = time_attr
        # budget -> list of (config, signed score); a trial contributes
        # its LATEST score per budget
        self._by_budget: Dict[int, Dict[str, Tuple[Dict, float]]] = {}

    # -- observation intake --------------------------------------------------
    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        """Intermediate (rung) results feed the model — this is the
        entire point of BOHB versus plain TPE-on-final-results."""
        if not result or self.metric not in result:
            return
        cfg = self._pending.get(trial_id)
        if cfg is None:
            return
        budget = int(result.get(self.time_attr, 0) or 0)
        sign = 1.0 if self.mode == "max" else -1.0
        self._by_budget.setdefault(budget, {})[trial_id] = (
            cfg, sign * float(result[self.metric]))

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        if result and self.metric in result:
            self.on_trial_result(trial_id, result)
        self._pending.pop(trial_id, None)

    # -- model source --------------------------------------------------------
    def _model_observations(self) -> List[Tuple[Dict, float]]:
        if not self._by_budget:
            return []
        from ray_tpu_torch.tune.search.sample import Domain
        # d = number of HYPERPARAMETERS (Domain leaves) — constants in
        # the space must not inflate the |D_b| >= d+2 activation bar
        dims = sum(1 for _, leaf in _walk(self._space)
                   if isinstance(leaf, Domain)) if self._space else 1
        need = max(self.n_initial, dims + 2)
        for budget in sorted(self._by_budget, reverse=True):
            obs = list(self._by_budget[budget].values())
            if len(obs) >= need:
                return obs
        # no budget is rich enough yet: pool everything (still better
        # than random once a handful of rungs exist)
        pooled: List[Tuple[Dict, float]] = []
        for per_trial in self._by_budget.values():
            pooled.extend(per_trial.values())
        return pooled if len(pooled) >= need else []

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        # swap the TPE base's final-result list for the budget-aware
        # selection, then reuse its proposal machinery wholesale
        self._observations = self._model_observations()
        return super().suggest(trial_id)
