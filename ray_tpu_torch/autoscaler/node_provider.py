"""Node providers: the autoscaler's cloud abstraction.

Reference: ``python/ray/autoscaler/node_provider.py`` + provider plugins
(AWS/GCP/K8s/fake_multi_node; SURVEY.md §2.3).  A provider knows how to
create/terminate/list nodes of named *node types*; the autoscaler decides
how many of each.  Shipped providers:

- :class:`FakeMultiNodeProvider` — adds/removes logical nodes in a running
  cluster via the control-plane ``add_node``/``remove_node`` RPCs (the
  reference's ``fake_multi_node`` test provider).
- :class:`~ray_tpu_torch.autoscaler.kube.GkeGpuNodeProvider` — the real
  K8s REST provider (``autoscaler/kube.py``): GPU node pools via the
  apiserver, the GKE accelerator node selector and the ``nvidia.com/gpu``
  limit, e2e-tested against a fake apiserver
  (``tests/test_torch_autoscaler_kube.py``).

A logical node that declares ``GPU`` is a local node with cards: the
head's warm pool forks ``gpu_workers_per_node`` GPU workers for it.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

NODE_KIND_HEAD = "head"
NODE_KIND_WORKER = "worker"

TAG_NODE_KIND = "node-kind"
TAG_NODE_TYPE = "node-type"
TAG_NODE_STATUS = "node-status"

STATUS_UP_TO_DATE = "up-to-date"
STATUS_TERMINATED = "terminated"


class NodeProvider:
    """Interface; all methods operate on provider-native node ids."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def internal_ip(self, node_id: str) -> str:
        return "127.0.0.1"

    def drain_node(self, node_id: str, deadline_s: float = 0.0,
                   reason: str = "preemption") -> None:
        """Emit a provider-initiated preemption warning for ``node_id``
        (DESIGN.md §4j): the cluster node turns ``draining`` — no new
        placement, running work keeps going until ``terminate_node`` —
        and a ``node_draining`` fleet event reaches subscribers during
        the warning window.  Base implementation maps the provider node
        id through the ``ray-pod`` label the pod-based providers stamp;
        providers whose ids ARE cluster node ids override."""
        from ray_tpu_torch.elastic import events as fleet
        fleet.drain_node(label={"ray-pod": node_id},
                         deadline_s=deadline_s, reason=reason)


class FakeMultiNodeProvider(NodeProvider):
    """Logical nodes inside a live cluster (control-plane RPCs).

    ``node_config`` carries the resource dict for ``add_node`` (e.g.
    ``{"CPU": 4}`` or ``{"CPU": 8, "GPU": 1}``).
    """

    def __init__(self, provider_config: Dict[str, Any] = None,
                 cluster_name: str = "fake"):
        super().__init__(provider_config or {}, cluster_name)
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[str, str]] = {}  # node_id -> tags

    def _worker(self):
        from ray_tpu_torch._private import worker as worker_mod
        return worker_mod.global_worker()

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        with self._lock:
            out = []
            for nid, tags in self._nodes.items():
                if all(tags.get(k) == v for k, v in tag_filters.items()):
                    out.append(nid)
            return out

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes.get(node_id, {}))

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        created = []
        for _ in range(count):
            resp = self._worker().rpc(
                "add_node", resources=dict(node_config.get("resources", {})),
                labels={"autoscaler": "1",
                        "node_type": tags.get(TAG_NODE_TYPE, "")})
            nid = resp["node_id"]
            with self._lock:
                self._nodes[nid] = {**tags, TAG_NODE_STATUS: STATUS_UP_TO_DATE}
            created.append(nid)
        return created

    def terminate_node(self, node_id: str) -> None:
        self._worker().rpc("remove_node", node_id=node_id)
        with self._lock:
            self._nodes.pop(node_id, None)

    def drain_node(self, node_id: str, deadline_s: float = 0.0,
                   reason: str = "preemption") -> None:
        # logical-node ids ARE cluster node ids: signal directly
        self._worker().rpc("node_draining", node_id=node_id,
                           deadline_s=deadline_s, reason=reason)


def __getattr__(name):  # lazy: kube.py pulls in ssl/http only when used
    if name in ("KubernetesNodeProvider", "GkeGpuNodeProvider",
                "KubeClient"):
        from ray_tpu_torch.autoscaler import kube
        return getattr(kube, name)
    raise AttributeError(name)
