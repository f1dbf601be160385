"""Worker group: N train-worker actors placed by one placement group.

Reference: ``python/ray/train/_internal/worker_group.py``.  Workers are
plain actors exposing ``apply(fn, *a, **kw)``; the backend executor drives
them.  Worker i is placed in bundle i; a bundle with ``"GPU"`` makes its
actor a ``num_gpus`` actor, which the GCS spawns as a GPU worker that sees
the node's cards.  With a slice topology (``ScalingConfig(topology=)``)
the group is STRICT_PACK over one ICI domain, a bundle a host, so all
hosts of the slice are leased atomically, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.util.placement_group import (
    placement_group, remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy


@ray_tpu_torch.remote
class TrainWorkerActor:
    """One training worker process (reference: ``RayTrainWorker``)."""

    def apply(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        return fn(*args, **kwargs)


class WorkerGroup:
    """``placement_timeout_s`` bounds the wait for the placement group: a
    group the cluster cannot place (``use_gpu`` with no ``"GPU"``) fails
    with a ``GetTimeoutError`` that names its bundles, never runs
    elsewhere."""

    def __init__(self, scaling: ScalingConfig,
                 placement_timeout_s: Optional[float] = None):
        self.scaling = scaling
        self.num_workers = scaling.num_workers
        bundle = scaling.bundle()
        if bundle.get("GPU", 0.0) > 0:
            # every worker is an actor in its own GPU worker process
            nodes = len(ray_tpu_torch.nodes())
            cap = GLOBAL_CONFIG.gpu_workers_per_node * nodes
            if self.num_workers > cap:
                raise ValueError(
                    f"{self.num_workers} GPU workers need as many GPU "
                    f"worker processes, and the cluster spawns "
                    f"{cap} (gpu_workers_per_node="
                    f"{GLOBAL_CONFIG.gpu_workers_per_node} on {nodes} "
                    f"node(s)); init with _system_config="
                    f"{{'gpu_workers_per_node': {self.num_workers}}}")
        self.pg = placement_group([dict(bundle)
                                   for _ in range(self.num_workers)],
                                  strategy=scaling.placement_strategy)
        try:
            ray_tpu_torch.get(self.pg.ready(), timeout=placement_timeout_s)
        except GetTimeoutError:
            remove_placement_group(self.pg)
            raise GetTimeoutError(
                f"the train worker group's {self.num_workers} bundles of "
                f"{bundle} were not placed within {placement_timeout_s} s; "
                f"the cluster has {ray_tpu_torch.cluster_resources()}") \
                from None
        self.workers: List[Any] = []
        for i in range(self.num_workers):
            strategy = PlacementGroupSchedulingStrategy(
                placement_group=self.pg, placement_group_bundle_index=i)
            actor = TrainWorkerActor.options(
                num_cpus=bundle.get("CPU", 1.0),
                num_gpus=bundle.get("GPU", 0.0),
                scheduling_strategy=strategy,
            ).remote()
            self.workers.append(actor)
        ray_tpu_torch.get([w.__ray_ready__.remote() for w in self.workers],
                          timeout=placement_timeout_s)

    def execute_async(self, fn: Callable, *args: Any, **kwargs: Any) -> List[Any]:
        """Launch fn on every worker; returns refs (reference:
        ``WorkerGroup.execute_async``)."""
        return [w.apply.remote(fn, *args, **kwargs) for w in self.workers]

    def shutdown(self, force: bool = False) -> None:
        for w in self.workers:
            try:
                if force:
                    ray_tpu_torch.kill(w)
                else:
                    w.__ray_terminate__.remote()
            except Exception:  # noqa: BLE001 - already dead
                pass
        self.workers = []
        try:
            remove_placement_group(self.pg)
        except Exception:  # noqa: BLE001
            pass
