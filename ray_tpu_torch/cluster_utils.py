"""Multi-node test cluster fixture.

Reference: ``python/ray/cluster_utils.py`` (SURVEY.md §4) — the reference
starts multiple raylets as separate processes on one machine, each a logical
"node" with its own resources; tests exercise spillback scheduling, PG
spread, and node-failure recovery this way.  Here nodes are logical resource
views inside the single control plane, each with its own spawned worker
processes; ``remove_node`` kills that node's workers and marks its objects
lost, which drives the same recovery paths (lineage reconstruction, actor
restart, PG rescheduling).
"""

from __future__ import annotations

from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private import worker as _worker_mod


class NodeHandle:
    def __init__(self, node_id: str):
        self.node_id = node_id

    def __repr__(self) -> str:
        return f"NodeHandle({self.node_id[:8]})"


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None):
        self._nodes = []
        self.head_node: Optional[NodeHandle] = None
        if initialize_head:
            args = dict(head_node_args or {})
            ray_tpu_torch.init(num_cpus=args.pop("num_cpus", 1),
                         resources=args.pop("resources", None), **args)
            w = _worker_mod.global_worker()
            self.head_node = NodeHandle(w.node_id)
            self._nodes.append(self.head_node)

    def add_node(self, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> NodeHandle:
        """A logical node of ``num_cpus`` and ``num_gpus`` (the
        ``"GPU"`` resource; its GPU workers see the head's cards, as
        the head's own do)."""
        res = dict(resources or {})
        res["CPU"] = float(num_cpus)
        if num_gpus:
            res["GPU"] = float(num_gpus)
        w = _worker_mod.global_worker()
        resp = w.rpc("add_node", resources=res, labels=labels)
        node = NodeHandle(resp["node_id"])
        self._nodes.append(node)
        return node

    def drain_node(self, node: NodeHandle, deadline_s: float = 0.0,
                   reason: str = "preemption") -> None:
        """Provider-initiated preemption warning (DESIGN.md §4j): the
        node turns ``draining`` (no new placement; running work keeps
        going) and subscribers — the elasticity manager first among
        them — get the window to migrate before ``remove_node``."""
        w = _worker_mod.global_worker()
        w.rpc("node_draining", node_id=node.node_id,
              deadline_s=deadline_s, reason=reason)

    def remove_node(self, node: NodeHandle) -> None:
        w = _worker_mod.global_worker()
        w.rpc("remove_node", node_id=node.node_id)
        self._nodes = [n for n in self._nodes if n.node_id != node.node_id]

    def shutdown(self) -> None:
        ray_tpu_torch.shutdown()
