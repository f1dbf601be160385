"""Tuner: the experiment entry point.

Reference: ``python/ray/tune/tuner.py`` + ``tune_config.py``: expand the param space into trials, run them through the
controller, return a ResultGrid; ``Tuner.restore`` reloads a finished or
interrupted experiment from its state file.
"""

from __future__ import annotations

import base64
import json
import os
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.tune._internal.controller import TuneController
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.trial import Trial


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[BasicVariantGenerator] = None
    seed: Optional[int] = None


class Tuner:
    def __init__(self, trainable: Any, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        # BaseTrainer instances become function trainables (reference:
        # Tuner(trainer) — Train rides on Tune)
        from ray_tpu_torch.train.base_trainer import BaseTrainer
        if isinstance(trainable, BaseTrainer):
            trainable = trainable.as_trainable()
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        exp_name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        from ray_tpu_torch.tune.search.searcher import Searcher
        searcher = None
        if isinstance(tc.search_alg, Searcher):
            # adaptive search: configs proposed lazily at launch time so
            # later trials exploit earlier results
            searcher = tc.search_alg
            searcher.set_search_properties(tc.metric, tc.mode,
                                           self.param_space)
            trials = [Trial(f"{exp_name}_{i:05d}", None)
                      for i in range(tc.num_samples)]
        else:
            gen = tc.search_alg or BasicVariantGenerator(seed=tc.seed)
            configs = gen.generate(self.param_space, tc.num_samples)
            trials = [Trial(f"{exp_name}_{i:05d}", cfg)
                      for i, cfg in enumerate(configs)]
        controller = TuneController(
            self.trainable, trials, scheduler=tc.scheduler,
            searcher=searcher,
            metric=tc.metric, mode=tc.mode,
            stop=self.run_config.stop or {},
            max_concurrent=tc.max_concurrent_trials,
            storage_root=self.run_config.resolved_storage_path(),
            experiment_name=exp_name,
            checkpoint_config=self.run_config.checkpoint_config)
        controller.run()
        return ResultGrid([_trial_to_result(t) for t in trials],
                          default_metric=tc.metric, default_mode=tc.mode)

    @classmethod
    def restore(cls, path: str, trainable: Any = None) -> "_RestoredTuner":
        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        return _RestoredTuner(state, trainable, os.path.dirname(path.rstrip("/")))


class _RestoredTuner:
    """Restored experiment: ``get_results()`` for what finished;
    ``fit()`` (requires the trainable) re-runs unfinished trials from
    their latest checkpoints and merges the results."""

    def __init__(self, state: Dict[str, Any], trainable: Any,
                 storage_root: str):
        self._state = state
        self._trainable = trainable
        self._storage_root = storage_root

    def get_results(self) -> ResultGrid:
        results = []
        for t in self._state["trials"]:
            results.append(self._to_result(t))
        return ResultGrid(results, default_metric=self._state.get("metric"),
                          default_mode=self._state.get("mode") or "max")

    def _to_result(self, t: Dict[str, Any]) -> Result:
        hist = t.get("metrics_history") or []
        ckpt = (Checkpoint.from_directory(t["latest_checkpoint_path"])
                if t.get("latest_checkpoint_path") and
                os.path.isdir(t["latest_checkpoint_path"]) else None)
        return Result(
            metrics=hist[-1] if hist else None, checkpoint=ckpt,
            metrics_history=hist,
            error=None if t["status"] != "ERROR" else
            RuntimeError("trial errored (restored)"))

    def fit(self) -> ResultGrid:
        if self._trainable is None:
            raise ValueError(
                "Tuner.restore(path, trainable=...) is required to re-run "
                "unfinished trials")
        from ray_tpu_torch.tune._internal.controller import TuneController
        from ray_tpu_torch.tune.trial import Trial
        done, rerun = [], []
        for t in self._state["trials"]:
            if t["status"] == "TERMINATED":
                done.append(self._to_result(t))
            else:
                tr = Trial(t["id"], t.get("config") or {})
                if t.get("latest_checkpoint_path") and \
                        os.path.isdir(t["latest_checkpoint_path"]):
                    tr.restore_path = t["latest_checkpoint_path"]
                # Resume iteration numbering where the interrupted run left
                # off so run-global stop criteria keep their meaning.
                for m in t.get("metrics_history") or []:
                    it = m.get("training_iteration")
                    if it is not None:
                        tr.all_seen_iters.add(int(it))
                        tr.metrics_history.append(m)
                # Rungs already passed (ASHA/median bookkeeping) must not be
                # re-recorded by the resumed run.
                tr.rungs_hit = set(t.get("rungs_hit") or [])
                rerun.append(tr)
        if rerun:
            def unb64(key):
                blob = self._state.get(key)
                if not blob:
                    return None
                import cloudpickle
                try:
                    return cloudpickle.loads(base64.b64decode(blob))
                except Exception:  # noqa: BLE001 - version drift
                    return None
            controller = TuneController(
                self._trainable, rerun,
                scheduler=unb64("scheduler_b64"),
                metric=self._state.get("metric"),
                mode=self._state.get("mode") or "max",
                stop=self._state.get("stop") or {},
                storage_root=self._storage_root,
                experiment_name=self._state["experiment_name"],
                checkpoint_config=unb64("checkpoint_config_b64"))
            controller.run()
            done.extend(_trial_to_result(t) for t in rerun)
        return ResultGrid(done, default_metric=self._state.get("metric"),
                          default_mode=self._state.get("mode") or "max")


def _trial_to_result(t: Trial) -> Result:
    ckpt = None
    if t.latest_checkpoint_path and os.path.isdir(t.latest_checkpoint_path):
        ckpt = Checkpoint.from_directory(t.latest_checkpoint_path)
    metrics = dict(t.last_result or {})
    if t.config is not None:
        metrics["config"] = t.config
    return Result(metrics=metrics or None, checkpoint=ckpt,
                  error=t.error, metrics_history=t.metrics_history)


def run(trainable: Any, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, metric: Optional[str] = None,
        mode: str = "max", scheduler: Optional[TrialScheduler] = None,
        stop: Optional[Dict[str, Any]] = None,
        storage_path: Optional[str] = None, name: Optional[str] = None,
        max_concurrent_trials: int = 4, **_compat: Any) -> ResultGrid:
    """``tune.run`` — the classic API (reference:
    ``python/ray/tune/tune.py``)."""
    rc = RunConfig(name=name, storage_path=storage_path, stop=stop)
    tuner = Tuner(trainable, param_space=config,
                  tune_config=TuneConfig(
                      metric=metric, mode=mode, num_samples=num_samples,
                      scheduler=scheduler,
                      max_concurrent_trials=max_concurrent_trials),
                  run_config=rc)
    return tuner.fit()
