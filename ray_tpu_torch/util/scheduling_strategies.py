"""Scheduling strategies (reference: ``python/ray/util/scheduling_strategies.py``)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def to_spec(self) -> dict:
        return {"type": "placement_group",
                "pg_id": self.placement_group.id,
                "bundle_index": self.placement_group_bundle_index}


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def to_spec(self) -> dict:
        return {"type": "node_affinity", "node_id": self.node_id,
                "soft": self.soft}


def strategy_to_spec(strategy) -> Optional[object]:
    if strategy is None or isinstance(strategy, str):
        return strategy
    return strategy.to_spec()
