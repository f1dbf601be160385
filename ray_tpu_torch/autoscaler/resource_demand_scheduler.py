"""Bin-packing: pending resource demand → nodes to launch.

Reference: ``python/ray/autoscaler/_private/resource_demand_scheduler.py``
(SURVEY.md §2.3) — the autoscaler packs the resource shapes of pending
tasks/actors/PG bundles onto hypothetical nodes of the configured node
types and launches the difference.  A demand shape may name a custom
resource (e.g. ``{"h100-8": 1}``) that only one node type offers, so
work of that shape scales the right pool.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

ResourceDict = Dict[str, float]


def _fits(avail: ResourceDict, shape: ResourceDict) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in shape.items() if v > 0)


def _consume(avail: ResourceDict, shape: ResourceDict) -> None:
    for k, v in shape.items():
        avail[k] = avail.get(k, 0.0) - v


def get_nodes_to_launch(
        node_types: Dict[str, dict],
        current_counts: Dict[str, int],
        demand: List[ResourceDict],
        max_total_nodes: int = 1000) -> Dict[str, int]:
    """Decide how many nodes of each type to launch.

    node_types: {type: {"resources": {...}, "min_workers": n,
                        "max_workers": n}}.
    current_counts: live nodes per type.  demand: pending resource shapes
    (one per queued task/actor/bundle).  Returns {type: count} to launch.
    """
    to_launch: Dict[str, int] = {}
    counts = dict(current_counts)
    pools: List[Tuple[str, ResourceDict]] = []  # launched-but-unfilled nodes

    # 1. honor min_workers — these fresh nodes join the packing pools so
    # step 2 places demand on them before launching extras
    for t, cfg in node_types.items():
        need = cfg.get("min_workers", 0) - counts.get(t, 0)
        if need > 0:
            to_launch[t] = to_launch.get(t, 0) + need
            counts[t] = counts.get(t, 0) + need
            for _ in range(need):
                pools.append((t, dict(cfg["resources"])))

    # 2. pack remaining demand onto (existing capacity is handled by the
    # caller passing only UNFULFILLED demand) hypothetical new nodes,
    # largest shapes first so big bundles don't fragment
    for shape in sorted(demand, key=lambda s: -sum(s.values())):
        placed = False
        for _, avail in pools:
            if _fits(avail, shape):
                _consume(avail, shape)
                placed = True
                break
        if placed:
            continue
        # launch the cheapest node type that fits the shape
        for t, cfg in sorted(node_types.items(),
                             key=lambda kv: sum(kv[1]["resources"].values())):
            res = cfg["resources"]
            if not _fits(dict(res), shape):
                continue
            if counts.get(t, 0) >= cfg.get("max_workers", max_total_nodes):
                continue
            if sum(counts.values()) >= max_total_nodes:
                break
            avail = dict(res)
            _consume(avail, shape)
            pools.append((t, avail))
            to_launch[t] = to_launch.get(t, 0) + 1
            counts[t] = counts.get(t, 0) + 1
            placed = True
            break
        # unplaceable shape (no type big enough): skipped — surfaced by the
        # autoscaler as infeasible
    return to_launch


def infeasible_shapes(node_types: Dict[str, dict],
                      demand: List[ResourceDict]) -> List[ResourceDict]:
    """Shapes no configured node type can ever satisfy."""
    out = []
    for shape in demand:
        if not any(_fits(dict(cfg["resources"]), shape)
                   for cfg in node_types.values()):
            out.append(shape)
    return out
