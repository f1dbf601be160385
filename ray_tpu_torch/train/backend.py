"""Backend hooks: per-framework worker-group setup.

Reference: ``python/ray/train/backend.py`` + ``train/torch/config.py`` —
the reference's ``TorchConfig`` picks a master address and calls
``dist.init_process_group`` on every worker.  The port's ``TorchConfig``
is the counterpart of the JAX package's ``JaxConfig``: a group of more
than one worker joins the shm collective group (``train_default``), the
gradient-sync path of one host; ``drain_handler`` subscribes the driver
to ``node_draining`` fleet events while the run is live, and
``elastic=True`` routes ``TorchTrainer.fit`` through the elasticity
manager (``train/base_trainer.py``).  ``use_distributed=True`` joins the
workers to one ``torch.distributed`` domain (``parallel/multihost.py``,
the driver picking the coordinator) on each rank's device (its card; the
CPU when ``device="cpu"``), and ``train_default`` becomes the domain's
device group (``util/collective/collective_group/device_group.py``),
whose transport the ranks' placement chooses: NCCL where every rank has
a card of its own, pinned host buffers over gloo where ranks share one.
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
    use_distributed: with more than one worker, every rank joins one
        ``torch.distributed`` domain (the reference's
        ``dist.init_process_group``), and ``train_default`` is its device
        group (instead of the shm group).  Mesh programs
        (``spmd.build_train_program(mesh_config=...)``) run over it.
    device: the ranks' device under ``use_distributed``: None is the
        worker's card (a worker without one raises); ``"cpu"`` only when
        asked.
    coordinator_port: the port of the domain's rendezvous store, which
        the driver hosts (0: a free one the kernel picks).
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
    device: Optional[str] = None
    coordinator_port: int = 0
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
        if self.use_distributed and self.elastic:
            raise ValueError(
                "TorchConfig(use_distributed=True, elastic=True): the "
                "elastic route forms each generation's domain itself")

    @property
    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    # user-facing alias; the real group name is unique per run+attempt so
    # restarted groups never rendezvous against a dead attempt's KV keys
    GROUP = "train_default"

    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        import ray_tpu_torch
        world = worker_group.num_workers
        coord = None
        if backend_config.use_distributed and world > 1:
            # the driver hosts the domain's rendezvous store (port 0: the
            # kernel's free port, no probe to race), the ranks join it
            from datetime import timedelta

            import torch.distributed as dist
            self._store = dist.TCPStore(
                "127.0.0.1", backend_config.coordinator_port, None, True,
                timeout=timedelta(seconds=backend_config.init_timeout_s),
                wait_for_workers=False)
            coord = f"127.0.0.1:{self._store.port}"
        ray_tpu_torch.get(worker_group.execute_async(
            _torch_worker_setup_by_rank, world, self.GROUP,
            backend_config.init_collective_group, coord,
            backend_config.device, backend_config.init_timeout_s),
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
        if getattr(self, "_store", None) is not None:
            # leave the domain before the actors go (a force-killed group
            # skips this; the OS reaps), then close its store
            import ray_tpu_torch
            try:
                ray_tpu_torch.get(worker_group.execute_async(
                    _torch_worker_teardown), timeout=10)
            except Exception:  # noqa: BLE001 - workers may be dead
                pass
            self._store = None


def _torch_worker_setup_by_rank(world, alias, init_col, coord=None,
                                device=None, init_timeout_s=120.0):
    # Executed via WorkerGroup.execute_async → same fn on every worker; the
    # rank is read from the session (set before backend hooks run).
    from ray_tpu_torch.train._internal.session import get_session
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import collective as col_mod
    s = get_session()
    group = f"train_{s.run_id}_a{s.attempt}"
    if coord is not None:
        from datetime import timedelta

        import torch.distributed as dist

        from ray_tpu_torch.parallel import multihost
        if multihost.is_distributed():      # a restarted group's worker
            multihost.shutdown()
        host, port = coord.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, False,
                              timeout=timedelta(seconds=init_timeout_s))
        multihost.initialize(coord, world, s.rank, device=device,
                             init_timeout_s=init_timeout_s, store=store)
        if init_col:
            col.init_collective_group(world, s.rank, "device", group)
            col_mod._register_alias(alias, group)
        return
    if not (init_col and world > 1):
        return
    if not col.is_group_initialized(group):
        col.init_collective_group(world, s.rank, "shm", group)
    col_mod._register_alias(alias, group)


def _torch_worker_teardown():
    from ray_tpu_torch.parallel import multihost
    from ray_tpu_torch.util import collective as col
    for name in list(col.collective._groups):
        g = col.collective._groups.get(name)
        if getattr(g, "transport", None) is not None:
            col.destroy_collective_group(name)
    multihost.shutdown()


def _free_port() -> int:
    """A port free at the time of the probe (bind-and-close; another
    process can take it before the coordinator binds it)."""
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
