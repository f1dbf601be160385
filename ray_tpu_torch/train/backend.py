"""Backend hooks: per-framework worker-group setup.

Reference: ``python/ray/train/backend.py`` + ``train/torch/config.py`` —
the reference's ``TorchConfig`` picks a master address and calls
``dist.init_process_group`` on every worker.  The port's ``TorchConfig``
is the counterpart of the JAX package's ``JaxConfig``: a group of more
than one worker joins the shm collective group (``train_default``), the
gradient-sync path of one host; ``drain_handler`` subscribes the driver
to ``node_draining`` fleet events while the run is live, and
``elastic=True`` routes ``TorchTrainer.fit`` through the elasticity
manager (``train/base_trainer.py``).  ``torch.distributed`` over NCCL
waits for the multi-GPU slice, and asking for it raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class BackendConfig:
    """``init_timeout_s`` bounds the worker group's placement and its
    backend setup."""

    init_timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Worker-group lifecycle hooks (reference: ``train.backend.Backend``)."""

    def on_start(self, worker_group, backend_config: "BackendConfig") -> None:
        pass

    def on_training_start(self, worker_group,
                          backend_config: "BackendConfig") -> None:
        pass

    def on_shutdown(self, worker_group, backend_config: "BackendConfig") -> None:
        pass


@dataclass
class TorchConfig(BackendConfig):
    """PyTorch worker-group backend.

    init_collective_group: with more than one worker, every rank joins a
        shm collective group under a run- and attempt-unique name,
        aliased to ``train_default`` in each worker.
    use_distributed: ``torch.distributed`` over NCCL — the multi-GPU
        slice's (ROADMAP queue A, item 8); ``True`` raises.
    drain_handler: preemption-warning subscription (DESIGN.md §4j):
        called on the DRIVER with each ``node_draining`` fleet event
        while the run is live — the hook where a training loop arranges
        an early checkpoint (or hands control to ``elastic=True``, which
        re-meshes instead of restarting).  None = not subscribed.
    elastic: route ``TorchTrainer.fit()`` through the elastic worker loop
        (``ElasticityManager``) instead of the restart-on-failure
        backend executor (DESIGN.md §4n): node drains quiesce and re-form
        the surviving group without a restart.  The contract changes
        with it: ``train_loop_per_worker(config)`` must RETURN a program
        object with init_state / restore_state / gather_state / step
        (the ``ElasticSpec.build`` contract); it runs once per
        generation on every worker, after the generation's gloo domain
        is up.  The ``elastic_*`` fields are the manager's knobs;
        ``elastic_total_steps`` 0 reads
        ``train_loop_config["total_steps"]``.
    """

    use_distributed: Optional[bool] = None
    init_collective_group: bool = True
    drain_handler: Optional[Callable] = None
    elastic: bool = False
    elastic_total_steps: int = 0
    elastic_gather_every: int = 1
    elastic_min_workers: int = 1
    elastic_auto_rejoin: bool = True
    elastic_quiesce_timeout_s: float = 60.0
    elastic_timeout_s: float = 600.0

    def __post_init__(self):
        if self.use_distributed:
            raise NotImplementedError(
                "TorchConfig(use_distributed=True): torch.distributed "
                "over NCCL is the multi-GPU slice's (ROADMAP queue A, "
                "item 8)")

    @property
    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    # user-facing alias; the real group name is unique per run+attempt so
    # restarted groups never rendezvous against a dead attempt's KV keys
    GROUP = "train_default"

    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        import ray_tpu_torch
        ray_tpu_torch.get(worker_group.execute_async(
            _torch_worker_setup_by_rank, worker_group.num_workers,
            self.GROUP, backend_config.init_collective_group),
            timeout=backend_config.init_timeout_s)

    def on_training_start(self, worker_group,
                          backend_config: TorchConfig) -> None:
        if backend_config.drain_handler is not None:
            from ray_tpu_torch.elastic.events import FleetEventSubscriber
            self._drain_sub = FleetEventSubscriber(
                backend_config.drain_handler,
                kinds=("node_draining",)).start()

    def on_shutdown(self, worker_group, backend_config: TorchConfig) -> None:
        sub = getattr(self, "_drain_sub", None)
        if sub is not None:
            sub.stop()
            self._drain_sub = None


def _torch_worker_setup_by_rank(world, alias, init_col):
    # Executed via WorkerGroup.execute_async → same fn on every worker; the
    # rank is read from the session (set before backend hooks run).
    from ray_tpu_torch.train._internal.session import get_session
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import collective as col_mod
    if not (init_col and world > 1):
        return
    s = get_session()
    group = f"train_{s.run_id}_a{s.attempt}"
    if not col.is_group_initialized(group):
        col.init_collective_group(world, s.rank, "shm", group)
    col_mod._register_alias(alias, group)


def _free_port() -> int:
    """A port free at the time of the probe (bind-and-close; another
    process can take it before the coordinator binds it)."""
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
