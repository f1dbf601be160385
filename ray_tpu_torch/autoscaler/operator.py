"""RayCluster operator: declarative cluster spec → pods, reconciled.

Reference: the KubeRay operator (SURVEY.md §2.6 deploy row) — a
controller that watches RayCluster custom resources and reconciles the
pod set: head + worker groups, each group with a replica count and a pod
shape.  Here the "CR" is a plain JSON/dict spec (file or GCS KV — no CRD
machinery needed to get the behavior), and the reconciler drives the
same KubernetesNodeProvider the autoscaler uses, so both controllers
speak one pod dialect:

    {"cluster_name": "demo",
     "worker_groups": [
        {"name": "cpu", "replicas": 2,
         "node_config": {"resources": {"CPU": 4}}},
        {"name": "h100", "replicas": 1,
         "node_config": {"resources": {"CPU": 8, "GPU": 1},
                          "gpu_accelerator": "nvidia-h100-80gb"}}]}

``autoscaling: {"min_replicas": .., "max_replicas": ..}`` on a group
delegates that group's replica count to the in-cluster autoscaler
(exactly the KubeRay split: the operator owns pod lifecycle, the
autoscaler owns the numbers).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import rtlog
from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_WORKER, TAG_NODE_KIND, TAG_NODE_TYPE)

logger = rtlog.get("operator")


class RayClusterOperator:
    """One reconcile target: a cluster spec against a pod provider."""

    def __init__(self, provider, spec: Optional[Dict[str, Any]] = None,
                 spec_path: Optional[str] = None):
        self.provider = provider
        self._spec = spec
        self.spec_path = spec_path
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ spec
    def spec(self) -> Dict[str, Any]:
        if self.spec_path:
            with open(self.spec_path) as f:
                return json.load(f)
        return dict(self._spec or {})

    def update_spec(self, spec: Dict[str, Any]) -> None:
        with self._lock:
            self._spec = spec
            # an explicit programmatic update overrides a file source —
            # silently preferring the stale file would make this a no-op
            self.spec_path = None

    # ------------------------------------------------------------- reconcile
    def _group_pods(self, group: str) -> List[str]:
        return self.provider.non_terminated_nodes({TAG_NODE_TYPE: group})

    def reconcile(self) -> Dict[str, Any]:
        """One pass: make each group's pod count match its spec.  Returns
        a report for logging/tests."""
        with self._lock:
            spec = self.spec()
        report: Dict[str, Any] = {"created": {}, "deleted": {},
                                  "groups": {}}
        seen_groups = set()
        for g in spec.get("worker_groups", []):
            name = g["name"]
            seen_groups.add(name)
            if g.get("autoscaling"):
                # the autoscaler owns this group's count (KubeRay split);
                # the operator only reports it
                report["groups"][name] = {
                    "managed_by": "autoscaler",
                    "current": len(self._group_pods(name))}
                continue
            want = int(g.get("replicas", 0))
            have = self._group_pods(name)
            if len(have) < want:
                ids = self.provider.create_node(
                    dict(g.get("node_config", {})),
                    {TAG_NODE_KIND: NODE_KIND_WORKER,
                     TAG_NODE_TYPE: name},
                    want - len(have))
                report["created"][name] = ids
                logger.info("group %s: created %d pods", name, len(ids))
            elif len(have) > want:
                # newest-first deletion (provider lists in creation order
                # for the fake; real K8s ordering is irrelevant — any
                # surplus pod is equivalent)
                victims = have[want:]
                for pod in victims:
                    self.provider.terminate_node(pod)
                report["deleted"][name] = victims
                logger.info("group %s: deleted %d pods", name, len(victims))
            report["groups"][name] = {
                "target": want,
                "current": len(self._group_pods(name))}
        # groups removed from the spec: drain their pods entirely
        for pod in self.provider.non_terminated_nodes({}):
            t = self.provider.node_tags(pod).get(TAG_NODE_TYPE, "")
            if t and t not in seen_groups:
                self.provider.terminate_node(pod)
                report["deleted"].setdefault(t, []).append(pod)
        return report

    def run(self, interval_s: float = 5.0,
            stop: Optional[threading.Event] = None) -> None:
        stop = stop or threading.Event()
        while not stop.is_set():
            try:
                self.reconcile()
            except Exception:  # noqa: BLE001 - a flaky API server pass
                # must not kill the operator
                logger.exception("reconcile pass failed")
            stop.wait(interval_s)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from ray_tpu_torch.autoscaler.kube import KubernetesNodeProvider

    ap = argparse.ArgumentParser(prog="ray_tpu_torch operator")
    ap.add_argument("--spec", required=True,
                    help="path to the cluster spec JSON (reconciled every "
                         "--interval; edit the file to scale)")
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument("--api-server", default=None)
    ap.add_argument("--namespace", default=None)
    ap.add_argument("--head-address", default=None,
                    help="HOST:PORT workers dial (default: "
                         "$RTT_HEAD_ADDRESS)")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    provider = KubernetesNodeProvider(
        {"api_server": args.api_server, "namespace": args.namespace,
         "head_address": args.head_address},
        cluster_name=spec.get("cluster_name", "ray-tpu-torch"))
    op = RayClusterOperator(provider, spec_path=args.spec)
    op.run(args.interval)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
