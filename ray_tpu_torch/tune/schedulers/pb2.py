"""PB2: population-based bandit hyperparameter optimization.

Reference: ``python/ray/tune/schedulers/pb2.py`` (Parker-Holder et al.,
"Provably Efficient Online Hyperparameter Optimization with
Population-Based Bandits", NeurIPS 2020).  PBT's EXPLOIT step is kept
(bottom-quantile trials clone a top-quantile trial's checkpoint); the
EXPLORE step replaces random perturbation with a **time-varying GP-UCB
bandit**: the scheduler records, for every perturbation window, the
hyperparameter point used and the reward improvement it produced, fits a
GP over (time, hyperparams) → improvement, and sends the cloned trial to
the UCB-argmax point inside ``hyperparam_bounds``.

Implemented from the paper against this package's GP-free stack (the
reference wraps GPy): a small numpy RBF-kernel GP with the paper's
time-decay treatment folded in as an extra kernel dimension, UCB argmax
by candidate sampling.  Same controller contract as PBT
(``request_clone`` stop-and-clone; tune/_internal/controller.py:107).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining


class _TinyGP:
    """RBF-kernel GP regression, numpy-only (no hyperparameter fitting —
    fixed unit lengthscale on normalized inputs, the paper's default
    regime; jitter keeps the Cholesky well-posed)."""

    def __init__(self, noise: float = 1e-2, lengthscale: float = 0.3):
        self.noise = noise
        self.ls = lengthscale
        self._X: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._L: Optional[np.ndarray] = None

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls ** 2))

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        self._X = X
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y))

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return mu, np.sqrt(var)


class PB2(PopulationBasedTraining):
    """PBT with GP-UCB explore over ``hyperparam_bounds``.

    hyperparam_bounds: {key: [low, high]} continuous ranges the bandit
        searches (the reference PB2 API; log-scaled keys can simply pass
        log-space bounds and exp in the trainable).
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, List[float]]] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds "
                             "({key: [low, high]})")
        super().__init__(time_attr=time_attr, metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},  # explore is the bandit
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self._keys = sorted(self.bounds)
        self._np_rng = np.random.default_rng(seed)
        # bandit dataset: rows (t_RAW, x_norm...) -> reward improvement;
        # the time column is normalized by the dataset's max at FIT time
        # (per-row normalization at record time would give every row the
        # same ~1.0 coordinate — a time-blind GP)
        self._data_X: List[List[float]] = []
        self._data_y: List[float] = []
        self._prev_score: Dict[str, float] = {}

    # ----------------------------------------------------------- encoding
    def _norm(self, config: Dict[str, Any]) -> List[float]:
        out = []
        for k in self._keys:
            lo, hi = self.bounds[k]
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def _denorm(self, x: np.ndarray) -> Dict[str, float]:
        return {k: self.bounds[k][0] +
                float(x[i]) * (self.bounds[k][1] - self.bounds[k][0])
                for i, k in enumerate(self._keys)}

    # ------------------------------------------------------------ dataset
    def _record_window(self, trial, t: float, val: float) -> None:
        prev = self._prev_score.get(trial.id)
        self._prev_score[trial.id] = val
        if prev is None:
            return
        self._data_X.append([float(t), *self._norm(trial.config)])
        self._data_y.append(val - prev)

    # ------------------------------------------------------------- explore
    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """GP-UCB argmax over the bounds (overrides PBT's random
        perturbation); falls back to uniform sampling until the bandit
        has data."""
        out = dict(config)
        if len(self._data_y) >= 3:
            X = np.asarray(self._data_X, np.float64)
            X[:, 0] /= max(1e-9, X[:, 0].max())    # normalize raw time col
            y = np.asarray(self._data_y, np.float64)
            ystd = y.std() or 1.0
            gp = _TinyGP()
            gp.fit(X, (y - y.mean()) / ystd)
            n_cand = 256
            cand = self._np_rng.random((n_cand, len(self._keys)))
            t_now = np.ones((n_cand, 1))           # "next window" time
            mu, sd = gp.predict(np.concatenate([t_now, cand], axis=1))
            # GP-UCB beta_t (paper uses the Srinivas schedule; constants
            # folded): sqrt(2 log(|C| t^2 pi^2 / 6 delta)), delta=0.1
            tstep = max(2, len(self._data_y))
            beta = math.sqrt(2 * math.log(
                n_cand * tstep ** 2 * math.pi ** 2 / (6 * 0.1)))
            best = cand[int(np.argmax(mu + beta * sd))]
            out.update(self._denorm(best))
        else:
            for k in self._keys:
                lo, hi = self.bounds[k]
                out[k] = lo + float(self._np_rng.random()) * (hi - lo)
        return out

    def on_trial_result(self, controller, trial,
                        result: Dict[str, Any]) -> str:
        val = result.get(self.metric)
        if val is not None:
            sign = 1.0 if self.mode == "max" else -1.0
            t = result.get(self.time_attr, 0)
            last = self._last_perturb.get(trial.id, 0)
            if t - last >= self.interval:
                # window closing: record (config used, improvement seen)
                self._record_window(trial, t, sign * float(val))
        decision = super().on_trial_result(controller, trial, result)
        if decision == self.STOP:
            # the cloned trial starts a fresh window
            self._prev_score.pop(trial.id, None)
        return decision
