"""Run/scaling/failure/checkpoint configuration.

Reference: ``python/ray/air/config.py``.  ``ScalingConfig`` takes the
reference's ``use_gpu``: every worker's bundle then asks for CUDA cards
(``"GPU"``), one each unless ``resources_per_worker`` says otherwise.
Like the JAX package's, it can ask for a topology-shaped reservation
instead (``topology="v4-32"``): one worker a host of the slice, every
host's bundle holding its accelerators (``"GPU"``, where the reference
asks for ``"TPU"``), the group STRICT_PACK, so the slice is leased
atomically (``parallel/topology.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """How many workers and what each one holds.

    num_workers: data-parallel worker count, one actor each (one a host
        of the slice when ``topology`` is set: its hosts are leased
        together).
    use_gpu: every worker gets CUDA cards: ``resources_per_worker["GPU"]``
        of them, 1.0 by default (0.5 lets two workers share one card).
    resources_per_worker: resources per worker (``"CPU"`` defaults to 1).
    topology: slice topology string (e.g. "v4-8"); when set, the
        placement group is STRICT_PACK over one ICI domain, every worker
        holds a host's accelerators, and ``num_workers`` defaults to the
        slice's host count.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    topology: Optional[str] = None
    placement_strategy: str = "PACK"

    def __post_init__(self):
        if self.topology is not None:
            from ray_tpu_torch.parallel.topology import slice_spec
            topo = slice_spec(self.topology)
            self.use_gpu = True
            if self.num_workers in (0, 1) and topo.num_hosts > 1:
                self.num_workers = topo.num_hosts
            self.placement_strategy = "STRICT_PACK"

    @property
    def num_gpus_per_worker(self) -> float:
        if not self.use_gpu:
            return 0.0
        if self.topology is not None:
            from ray_tpu_torch.parallel.topology import slice_spec
            return float(slice_spec(self.topology).chips_per_host)
        return float((self.resources_per_worker or {}).get("GPU", 1.0))

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res["GPU"] = self.num_gpus_per_worker
        else:
            res.pop("GPU", None)
        return res

    def as_placement_group_factory(self):
        """A function that makes the worker group's placement group:
        ``num_workers`` bundles of ``bundle()``, by
        ``placement_strategy``."""
        from ray_tpu_torch.util.placement_group import placement_group
        bundles = [self.bundle() for _ in range(self.num_workers)]
        return lambda: placement_group(bundles,
                                       strategy=self.placement_strategy)


def _unread(config, **defaults) -> None:
    for name, default in defaults.items():
        if getattr(config, name) != default:
            raise NotImplementedError(
                f"{type(config).__name__}.{name} is not implemented: "
                f"nothing reads it (leave it at {default!r})")


@dataclass
class FailureConfig:
    """Reference: ``ray.air.FailureConfig`` — worker-group restarts from the
    last checkpoint, up to ``max_failures`` (-1 = unlimited)."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Reference: ``ray.air.CheckpointConfig`` — retention policy.

    ``checkpoint_frequency`` is read by Tune's class trainables.  The
    score fields keep the reference's signature, but neither package
    retains by score (``num_to_keep`` keeps the newest), so a value other
    than the default raises rather than being ignored."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0

    def __post_init__(self):
        _unread(self, checkpoint_score_attribute=None,
                checkpoint_score_order="max")


@dataclass
class RunConfig:
    """``stop`` is read by Tune.  ``verbose`` keeps the reference's
    signature; nothing in either package reads it, so a value other than
    the default raises rather than being ignored."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
    # Tune stop criteria: {"metric_or_time_attr": bound} — stop a trial
    # once attribute >= bound (reference: ``air.RunConfig(stop=...)``)
    stop: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        _unread(self, verbose=1)

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
