"""TPE: Tree-structured Parzen Estimator searcher (native, no deps).

Reference analog: ``python/ray/tune/search/hyperopt/`` — Ray wraps
hyperopt's TPE; this is a from-scratch implementation of the same
published algorithm (Bergstra et al., NeurIPS 2011): split observed
trials into good (top ``gamma`` quantile) and bad; model each group with
a Parzen (kernel-density) estimator per dimension; propose the candidate
maximizing ``l(x)/g(x)`` (likelihood under good ÷ likelihood under bad).

Handles Float (linear/log/quantized), Integer, and Categorical domains;
``grid_search`` leaves are treated as Categorical; other leaves fall back
to random sampling.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.search.sample import Categorical, Domain, Float, Integer
from ray_tpu_torch.tune.search.searcher import Searcher


def _walk(space: Any, path: Tuple = ()):  # (path, leaf) pairs
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            yield (path, Categorical(space["grid_search"]))
            return
        for k, v in space.items():
            yield from _walk(v, path + (k,))
    else:
        yield (path, space)


def _set(d: Dict, path: Tuple, value: Any) -> None:
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _get(d: Dict, path: Tuple) -> Any:
    for k in path:
        d = d[k]
    return d


class TPESearcher(Searcher):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *,
                 n_initial_points: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = np.random.default_rng(seed)
        self._pending: Dict[str, Dict] = {}
        self._observations: List[Tuple[Dict, float]] = []

    # -- proposal ------------------------------------------------------------
    def suggest(self, trial_id: str) -> Dict[str, Any]:
        assert self._space is not None, "set_search_properties not called"
        cfg: Dict[str, Any] = {}
        use_tpe = len(self._observations) >= self.n_initial
        for path, leaf in _walk(self._space):
            if isinstance(leaf, Domain):
                if use_tpe and isinstance(leaf, (Float, Integer, Categorical)):
                    value = self._tpe_sample(path, leaf)
                else:
                    value = leaf.sample(self._rng)
            else:
                value = leaf  # constant
            _set(cfg, path, value)
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or not result or self.metric not in result:
            return
        sign = 1.0 if self.mode == "max" else -1.0
        self._observations.append((cfg, sign * float(result[self.metric])))

    # -- TPE core ------------------------------------------------------------
    def _split(self) -> Tuple[List[Dict], List[Dict]]:
        obs = sorted(self._observations, key=lambda o: -o[1])
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        return ([c for c, _ in obs[:n_good]], [c for c, _ in obs[n_good:]])

    def _tpe_sample(self, path: Tuple, leaf: Domain) -> Any:
        good, bad = self._split()
        gv = [_get(c, path) for c in good]
        bv = [_get(c, path) for c in bad]
        if isinstance(leaf, Categorical):
            return self._tpe_categorical(leaf, gv, bv)
        return self._tpe_numeric(leaf, gv, bv)

    def _tpe_categorical(self, leaf: Categorical, gv, bv) -> Any:
        cats = leaf.categories
        prior = 1.0
        g_counts = np.array([prior + sum(1 for v in gv if v == c)
                             for c in cats], float)
        b_counts = np.array([prior + sum(1 for v in bv if v == c)
                             for c in cats], float)
        score = (g_counts / g_counts.sum()) / (b_counts / b_counts.sum())
        # sample proportionally to l/g (softens pure argmax exploitation)
        p = score / score.sum()
        return cats[int(self._rng.choice(len(cats), p=p))]

    def _to_unit(self, leaf, v: float) -> float:
        lo, hi = float(leaf.lower), float(leaf.upper)
        if getattr(leaf, "log", False):
            return (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
        return (v - lo) / (hi - lo)

    def _from_unit(self, leaf, u: float) -> Any:
        lo, hi = float(leaf.lower), float(leaf.upper)
        u = min(1.0, max(0.0, u))
        if getattr(leaf, "log", False):
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        if isinstance(leaf, Integer):
            v = int(round(v))
            if leaf.q:
                v = int(round(v / leaf.q) * leaf.q)
            return max(leaf.lower, min(leaf.upper - 1, v))
        if getattr(leaf, "q", None):
            v = round(v / leaf.q) * leaf.q
        return float(v)

    def _kde_logpdf(self, xs: np.ndarray, centers: np.ndarray) -> np.ndarray:
        """Parzen estimator in unit space: mixture of Gaussians at the
        observed points with a scaled-silverman bandwidth + uniform prior."""
        n = len(centers)
        bw = max(1e-3, 1.06 * (np.std(centers) + 1e-3) * n ** -0.2)
        diffs = (xs[:, None] - centers[None, :]) / bw
        comp = np.exp(-0.5 * diffs ** 2) / (bw * math.sqrt(2 * math.pi))
        # mixture incl. a uniform component (the prior over [0,1])
        pdf = (comp.sum(axis=1) + 1.0) / (n + 1)
        return np.log(pdf + 1e-12)

    def _tpe_numeric(self, leaf, gv, bv) -> Any:
        g = np.array([self._to_unit(leaf, v) for v in gv], float)
        b = np.array([self._to_unit(leaf, v) for v in bv], float) \
            if bv else np.array([0.5])
        # candidates drawn from the GOOD model (plus uniform exploration)
        n_from_good = max(1, self.n_candidates - 4)
        bw = max(1e-3, 1.06 * (np.std(g) + 1e-3) * len(g) ** -0.2)
        cand = np.concatenate([
            self._rng.choice(g, size=n_from_good) +
            self._rng.normal(0, bw, size=n_from_good),
            self._rng.uniform(0, 1, size=4),
        ])
        cand = np.clip(cand, 0.0, 1.0)
        score = self._kde_logpdf(cand, g) - self._kde_logpdf(cand, b)
        return self._from_unit(leaf, float(cand[int(np.argmax(score))]))
