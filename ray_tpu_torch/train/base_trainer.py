"""BaseTrainer / DataParallelTrainer / TorchTrainer.

Reference: ``python/ray/train/base_trainer.py`` +
``python/ray/train/data_parallel_trainer.py`` +
``python/ray/train/torch/torch_trainer.py``.  The reference routes
``fit()`` through a 1-trial Tune run; this one calls the backend executor
directly and Tune integrates by wrapping ``as_trainable`` (same layering,
thinner plumbing).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._internal.backend_executor import BackendExecutor
from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.result import Result


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self) -> Callable:
        """A Tune function-trainable wrapping this trainer (reference:
        ``BaseTrainer.as_trainable`` returning a Trainable class)."""
        trainer = self

        def _trainable(config: Dict[str, Any]):
            import copy

            from ray_tpu_torch import train as train_mod
            t = copy.copy(trainer)
            loop_cfg = dict(getattr(t, "train_loop_config", None) or {})
            loop_cfg.update(config.get("train_loop_config", {}))
            t.train_loop_config = loop_cfg
            result = t.fit()
            if result.error is not None:
                raise result.error
            # surface final metrics to the enclosing session when one
            # exists (a Tune trial session); plain function calls have no
            # session — returning the metrics covers that path
            from ray_tpu_torch.train._internal.session import try_session
            if result.metrics and try_session() is not None:
                train_mod.report(result.metrics)
            return result.metrics

        return _trainable


class DataParallelTrainer(BaseTrainer):
    """N identical workers each running ``train_loop_per_worker``."""

    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 mesh_config: Any = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._default_backend_config
        # the layout each worker reads from get_context().get_mesh_config()
        self.mesh_config = mesh_config

    def fit(self) -> Result:
        if getattr(self.backend_config, "elastic", False):
            return self._fit_elastic()
        executor = BackendExecutor(self.backend_config, self.scaling_config,
                                   self.run_config, self.mesh_config)
        try:
            return executor.run(self.train_loop_per_worker,
                                self.train_loop_config, self.datasets)
        finally:
            executor.shutdown()

    def _fit_elastic(self) -> Result:
        """Route this trainer through the elastic worker loop
        (DESIGN.md §4n): one ElasticityManager owns the worker group
        end to end — quiesce → re-mesh on drains (autopilot straggler
        drains included), restart-from-gathered-state as the unwarned
        fallback — instead of the BackendExecutor's
        restart-the-whole-group-from-checkpoint policy.

        Contract (``TorchConfig.elastic``): ``train_loop_per_worker``
        runs once per generation on every worker AFTER the generation's
        gloo domain is up, and must RETURN a program object exposing
        ``init_state / restore_state / gather_state / step`` (the
        ``ElasticSpec.build`` contract).  Per-step metrics flow back
        through the manager and land in ``Result.metrics_history`` keyed
        by ``training_iteration``.  ``resources_per_worker`` other than
        ``CPU`` (a ``GPU`` share, custom resources) go to every worker
        as they do through the backend executor."""
        from ray_tpu_torch.elastic.manager import (ElasticConfig,
                                                   ElasticityManager)
        from ray_tpu_torch.elastic.worker_loop import ElasticSpec
        cfg = self.backend_config
        total = int(cfg.elastic_total_steps or
                    (self.train_loop_config or {}).get("total_steps", 0))
        if total <= 0:
            raise ValueError(
                "elastic training needs a step budget: set "
                "TorchConfig.elastic_total_steps or "
                "train_loop_config['total_steps']")
        spec = ElasticSpec(
            build=_ElasticBuild(self.train_loop_per_worker,
                                dict(self.train_loop_config or {})),
            total_steps=total,
            gather_every=max(int(cfg.elastic_gather_every), 1),
            init_timeout_s=cfg.init_timeout_s)
        resources = dict(self.scaling_config.resources_per_worker or {})
        if self.scaling_config.use_gpu and "GPU" not in resources:
            resources["GPU"] = 1.0
        extra = {k: v for k, v in resources.items() if k != "CPU"}
        mgr = ElasticityManager(spec, ElasticConfig(
            num_workers=self.scaling_config.num_workers,
            min_workers=max(int(cfg.elastic_min_workers), 1),
            cpus_per_worker=float(resources.get("CPU", 1.0)),
            resources_per_worker=extra or None,
            auto_rejoin=cfg.elastic_auto_rejoin,
            quiesce_timeout_s=cfg.elastic_quiesce_timeout_s,
            group=self.run_config.name or None))
        res = mgr.fit(timeout_s=cfg.elastic_timeout_s)
        history = []
        for h in res.history:
            row = dict(h.get("metrics") or {})
            row["training_iteration"] = h["step"]
            history.append(row)
        metrics = dict(history[-1]) if history else None
        if metrics is not None:
            metrics["elastic"] = {
                "generations": res.generations,
                "transitions": [dict(t) for t in res.transitions],
                "workers": [dict(w) for w in res.worker_results],
                **res.goodput}
        return Result(metrics=metrics, checkpoint=None, path=None,
                      error=res.error, metrics_history=history)


class _ElasticBuild:
    """Picklable ``ElasticSpec.build`` adapter: call the user's train
    loop with its config and validate it returned an elastic program
    (a plain closure would work too, but the explicit class makes the
    error on a non-elastic loop precise instead of an attribute crash
    deep inside the worker loop)."""

    def __init__(self, fn, config):
        self.fn = fn
        self.config = config

    def __call__(self):
        import inspect
        takes_config = len(inspect.signature(self.fn).parameters) >= 1
        prog = self.fn(self.config) if takes_config else self.fn()
        missing = [m for m in ("init_state", "restore_state",
                               "gather_state", "step")
                   if not hasattr(prog, m)]
        if missing:
            raise TypeError(
                "TorchConfig(elastic=True) requires train_loop_per_worker "
                "to RETURN an elastic program (init_state/restore_state/"
                f"gather_state/step); returned {type(prog).__name__!r} "
                f"is missing {missing}")
        return prog


class TorchTrainer(DataParallelTrainer):
    """The PyTorch trainer (reference: ``TorchTrainer``).

    Each worker runs ``train_loop_per_worker`` in its own process; with
    ``ScalingConfig(use_gpu=True)`` that process sees the card, and the
    loop finds it with ``resolve_device(None)``.  A loop that finds none
    raises there, and the error reaches ``Result.error``.  With
    ``TorchConfig(use_distributed=True)`` the workers form one
    ``torch.distributed`` domain first, and a loop builds its mesh program
    with ``spmd.build_train_program(mesh_config=get_context()
    .get_mesh_config(), ...)`` (the trainer's ``mesh_config``).
    """

    _default_backend_config = TorchConfig()

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        super().__init__(train_loop_per_worker,
                         backend_config=torch_config or TorchConfig(),
                         **kwargs)
