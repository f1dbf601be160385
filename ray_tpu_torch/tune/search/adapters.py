"""Third-party searcher adapters (Optuna / HyperOpt).

Reference: ``python/ray/tune/search/optuna/`` and
``python/ray/tune/search/hyperopt/`` — thin adapters that translate the
Searcher protocol (suggest / on_trial_complete) onto an external
optimization library's ask/tell interface.

Neither library is a dependency of the port (the card's machine has
neither); the adapters are import-gated with an actionable error naming
the native equivalents (TPESearcher — the same algorithm family
hyperopt implements — and BOHBSearcher), never a silent fallback.  When
the library IS installed the adapter is a real ask/tell bridge, not a
stub.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.search.sample import Categorical, Domain, Float, Integer
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.search.tpe import _set, _walk


class OptunaSearch(Searcher):
    """Adapter onto ``optuna``'s ask/tell API (reference: OptunaSearch)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *,
                 sampler: Any = None, seed: Optional[int] = None):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the 'optuna' package, which is not "
                "installed. The native TPESearcher "
                "(ray_tpu_torch.tune.search.tpe) implements the same TPE "
                "algorithm with no dependencies; BOHBSearcher adds "
                "multi-fidelity.") from e
        super().__init__(metric, mode)
        import optuna
        self._optuna = optuna
        optuna.logging.set_verbosity(optuna.logging.WARNING)
        self._sampler = sampler or optuna.samplers.TPESampler(seed=seed)
        self._rng = np.random.default_rng(seed)
        self._study = None
        self._trials: Dict[str, Any] = {}

    def _ensure_study(self):
        if self._study is None:
            self._study = self._optuna.create_study(
                direction="maximize" if self.mode == "max" else "minimize",
                sampler=self._sampler)
        return self._study

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        assert self._space is not None, "set_search_properties not called"
        study = self._ensure_study()
        ot = study.ask()
        cfg: Dict[str, Any] = {}
        for path, leaf in _walk(self._space):
            name = "/".join(map(str, path))
            if isinstance(leaf, Float):
                q = getattr(leaf, "q", None)
                log = bool(getattr(leaf, "log", False))
                # step inside the study so the told and executed values
                # match (optuna disallows step together with log)
                v = ot.suggest_float(name, leaf.lower, leaf.upper,
                                     log=log,
                                     step=None if log else q)
            elif isinstance(leaf, Integer):
                v = ot.suggest_int(name, int(leaf.lower),
                                   int(leaf.upper) - 1)
            elif isinstance(leaf, Categorical):
                cats = list(leaf.categories)
                try:
                    # unordered-aware modeling; optuna requires
                    # primitive choices
                    v = ot.suggest_categorical(name, cats)
                except Exception:  # noqa: BLE001 - non-primitive values
                    idx = ot.suggest_categorical(
                        f"{name}#idx", list(range(len(cats))))
                    v = cats[idx]
            elif isinstance(leaf, Domain):
                v = leaf.sample(self._rng)
            else:
                v = leaf
            _set(cfg, path, v)
        self._trials[trial_id] = ot
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        ot = self._trials.pop(trial_id, None)
        if ot is None or self._study is None:
            return
        if result and self.metric in result:
            self._study.tell(ot, float(result[self.metric]))
        else:
            self._study.tell(
                ot, state=self._optuna.trial.TrialState.FAIL)


class HyperOptSearch(Searcher):
    """Adapter onto ``hyperopt``'s suggest machinery (reference:
    HyperOptSearch)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *,
                 n_initial_points: int = 10, seed: Optional[int] = None):
        try:
            import hyperopt  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "HyperOptSearch requires the 'hyperopt' package, which is "
                "not installed. The native TPESearcher "
                "(ray_tpu_torch.tune.search.tpe) implements the same TPE "
                "algorithm with no dependencies.") from e
        super().__init__(metric, mode)
        import hyperopt
        self._hp = hyperopt
        self._n_initial = n_initial_points
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._domain = None
        self._hp_trials = hyperopt.Trials()
        self._ids: Dict[str, int] = {}
        self._next = 0

    def _hp_space(self) -> Tuple[Dict[str, Any], Dict[str, Tuple]]:
        hp = self._hp.hp
        space, paths = {}, {}
        for path, leaf in _walk(self._space):
            name = "/".join(map(str, path))
            paths[name] = (path, leaf)
            if isinstance(leaf, Float):
                if getattr(leaf, "log", False):
                    import math
                    space[name] = hp.loguniform(
                        name, math.log(leaf.lower), math.log(leaf.upper))
                else:
                    space[name] = hp.uniform(name, leaf.lower, leaf.upper)
            elif isinstance(leaf, Integer):
                space[name] = hp.randint(
                    name, int(leaf.lower), int(leaf.upper))
            elif isinstance(leaf, Categorical):
                space[name] = hp.choice(name, list(leaf.categories))
            elif not isinstance(leaf, Domain):
                space[name] = leaf
        return space, paths

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        assert self._space is not None, "set_search_properties not called"
        hp = self._hp
        if self._domain is None:
            space, self._paths = self._hp_space()
            self._domain = hp.base.Domain(lambda c: 0.0, space)
        tid = self._next
        self._next += 1
        self._ids[trial_id] = tid
        algo = hp.tpe.suggest if self._next > self._n_initial \
            else hp.rand.suggest
        docs = algo([tid], self._domain, self._hp_trials,
                    (self._seed or 0) + tid)
        self._hp_trials.insert_trial_docs(docs)
        self._hp_trials.refresh()
        vals = {k: v[0] for k, v in docs[0]["misc"]["vals"].items() if v}
        cfg: Dict[str, Any] = {}
        for name, (path, leaf) in self._paths.items():
            if name in vals:
                v = vals[name]
                if isinstance(leaf, Categorical):
                    v = leaf.categories[int(v)]
                elif isinstance(leaf, Integer):
                    v = int(v)
                _set(cfg, path, v)
            else:
                _set(cfg, path, leaf if not isinstance(leaf, Domain)
                     else leaf.sample(self._rng))
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        tid = self._ids.pop(trial_id, None)
        if tid is None:
            return
        hp = self._hp
        for doc in self._hp_trials.trials:
            if doc["tid"] != tid:
                continue
            if result and self.metric in result:
                sign = -1.0 if self.mode == "max" else 1.0
                doc["result"] = {"loss": sign * float(result[self.metric]),
                                 "status": hp.STATUS_OK}
            else:
                doc["result"] = {"status": hp.STATUS_FAIL}
            doc["state"] = hp.JOB_STATE_DONE
        self._hp_trials.refresh()
