"""Autoscaler: demand-driven node scaling (reference:
``python/ray/autoscaler/``; SURVEY.md §2.3)."""

from ray_tpu_torch.autoscaler.autoscaler import (  # noqa: F401
    AutoscalerConfig, AutoscalerLoop, StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    FakeMultiNodeProvider, NodeProvider,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (  # noqa: F401
    get_nodes_to_launch, infeasible_shapes,
)
