"""Backend hooks: per-framework worker-group setup.

Reference: ``python/ray/train/backend.py`` + ``train/torch/config.py`` —
the reference's ``TorchConfig`` picks a master address and calls
``dist.init_process_group`` on every worker.  The port's ``TorchConfig``
is the counterpart of the JAX package's ``JaxConfig``: a group of more
than one worker joins the shm collective group (``train_default``), the
gradient-sync path of one host.  ``torch.distributed`` (NCCL), the
elastic path and drain subscriptions wait for their slices, and asking
for them raises ``NotImplementedError``.
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
    drain_handler: a driver callback for ``node_draining`` fleet events —
        Train's drain route comes with ``elastic/manager``; setting it
        raises.
    elastic: the elastic worker loop — waits for ``elastic/manager``;
        ``True`` raises.
    """

    use_distributed: Optional[bool] = None
    init_collective_group: bool = True
    drain_handler: Optional[Callable] = None
    elastic: bool = False

    def __post_init__(self):
        if self.use_distributed:
            raise NotImplementedError(
                "TorchConfig(use_distributed=True): torch.distributed "
                "over NCCL is the multi-GPU slice's (ROADMAP queue A, "
                "item 8)")
        if self.drain_handler is not None:
            raise NotImplementedError(
                "TorchConfig(drain_handler=...): Train's drain route comes "
                "with elastic/manager, not ported yet (ROADMAP queue A, "
                "item 7)")
        if self.elastic:
            raise NotImplementedError(
                "TorchConfig(elastic=True): the elastic worker loop needs "
                "elastic/manager, not ported yet (ROADMAP queue A, item 7)")

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
