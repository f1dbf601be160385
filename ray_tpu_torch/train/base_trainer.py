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
                 datasets: Optional[Dict[str, Any]] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._default_backend_config

    def fit(self) -> Result:
        executor = BackendExecutor(self.backend_config, self.scaling_config,
                                   self.run_config)
        try:
            return executor.run(self.train_loop_per_worker,
                                self.train_loop_config, self.datasets)
        finally:
            executor.shutdown()


class TorchTrainer(DataParallelTrainer):
    """The PyTorch trainer (reference: ``TorchTrainer``).

    Each worker runs ``train_loop_per_worker`` in its own process; with
    ``ScalingConfig(use_gpu=True)`` that process sees the card, and the
    loop finds it with ``resolve_device(None)``.  A loop that finds none
    raises there, and the error reaches ``Result.error``.
    """

    _default_backend_config = TorchConfig()

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        super().__init__(train_loop_per_worker,
                         backend_config=torch_config or TorchConfig(),
                         **kwargs)
