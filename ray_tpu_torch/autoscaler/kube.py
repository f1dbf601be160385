"""Minimal Kubernetes API client + pod-based node provider.

Reference: ``python/ray/autoscaler/_private/kuberay/node_provider.py`` and
the K8s provider plugin (SURVEY.md §2.3 autoscaler row) — the reference
speaks the Kubernetes REST API directly (create/list/delete pods with
label selectors) rather than shelling out to kubectl; so does this.

No kubernetes pip package (environment constraint): the client is a thin
JSON-over-HTTP layer on ``http.client`` with the standard in-cluster
auth discovery (``KUBERNETES_SERVICE_HOST`` + the mounted serviceaccount
token/CA) and explicit overrides for tests, which run it against an
in-tree fake API server (tests/test_torch_autoscaler_kube.py — the
reference's mock-provider pattern, SURVEY.md §4 ``test_autoscaler*.py``).

GPU awareness (GKE): a pod of a node type with cards carries the GKE
accelerator nodeSelector (``cloud.google.com/gke-accelerator``, e.g.
``nvidia-h100-80gb``) and an ``nvidia.com/gpu`` limit and request (the
NVIDIA device plugin's resource); the pod entrypoint runs the
``ray_tpu_torch`` node-agent with ``--num-gpus``, which gives its GPU
workers the pod's cards.  A GKE GPU pool has no topology selector.
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import time
import uuid
from typing import Any, Dict, List, Optional
from urllib.parse import quote

from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_WORKER, NodeProvider, STATUS_UP_TO_DATE, TAG_NODE_KIND,
    TAG_NODE_STATUS, TAG_NODE_TYPE,
)

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeApiError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"kubernetes api error {status}: {body[:300]}")
        self.status = status


class KubeClient:
    """JSON REST client for the few pod operations the provider needs."""

    def __init__(self, api_server: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_cert: Optional[str] = None,
                 namespace: Optional[str] = None,
                 insecure: bool = False):
        if api_server is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "no api_server configured and not running in-cluster "
                    "(KUBERNETES_SERVICE_HOST unset)")
            api_server = f"https://{host}:{port}"
        self.api_server = api_server.rstrip("/")
        if token is None and os.path.exists(f"{_SA_DIR}/token"):
            token = open(f"{_SA_DIR}/token").read().strip()
        self.token = token
        if ca_cert is None and os.path.exists(f"{_SA_DIR}/ca.crt"):
            ca_cert = f"{_SA_DIR}/ca.crt"
        self.ca_cert = ca_cert
        if namespace is None:
            ns_file = f"{_SA_DIR}/namespace"
            namespace = (open(ns_file).read().strip()
                         if os.path.exists(ns_file) else "default")
        self.namespace = namespace
        self.insecure = insecure

    # ------------------------------------------------------------- transport
    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        import http.client

        scheme, rest = self.api_server.split("://", 1)
        hostport = rest
        if scheme == "https":
            if not self.ca_cert and not self.insecure:
                # never silently downgrade: the request carries the bearer
                # token — an unverified endpoint could be a MITM capturing
                # cluster credentials
                raise ValueError(
                    "https api_server with no ca_cert: pass ca_cert=... "
                    "or explicitly opt in with insecure=True")
            ctx = ssl.create_default_context(
                cafile=self.ca_cert if self.ca_cert else None)
            if self.insecure:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            conn = http.client.HTTPSConnection(hostport, context=ctx,
                                               timeout=15)
        else:
            conn = http.client.HTTPConnection(hostport, timeout=15)
        try:
            headers = {"Accept": "application/json"}
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            payload = None
            if body is not None:
                payload = json.dumps(body)
                headers["Content-Type"] = "application/json"
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            data = resp.read().decode("utf-8", "replace")
            if resp.status >= 300:
                raise KubeApiError(resp.status, data)
            return json.loads(data) if data else {}
        finally:
            conn.close()

    # ------------------------------------------------------------------ pods
    def create_pod(self, manifest: dict) -> dict:
        return self._request(
            "POST", f"/api/v1/namespaces/{self.namespace}/pods", manifest)

    def list_pods(self, label_selector: str = "") -> List[dict]:
        path = f"/api/v1/namespaces/{self.namespace}/pods"
        if label_selector:
            path += f"?labelSelector={quote(label_selector)}"
        return self._request("GET", path).get("items", [])

    def get_pod(self, name: str) -> dict:
        return self._request(
            "GET", f"/api/v1/namespaces/{self.namespace}/pods/{name}")

    def delete_pod(self, name: str) -> None:
        try:
            self._request(
                "DELETE", f"/api/v1/namespaces/{self.namespace}/pods/{name}")
        except KubeApiError as e:
            if e.status != 404:
                raise


class KubernetesNodeProvider(NodeProvider):
    """Workers are pods; node ids are pod names.

    ``provider_config``:
      api_server/token/ca_cert/namespace/insecure — KubeClient wiring
        (all optional in-cluster);
      head_address — "host:port" the node-agent dials (required);
      image — container image (default: the head's own image via
        ``RTT_IMAGE``);
      auth_key_secret — name of the Secret holding ``RTT_AUTH_KEY``
        (optional: falls back to passing the env through).

    ``node_config`` (per node type):
      resources: {"CPU": n, "GPU": cards} — agent flags;
      gpu_accelerator: e.g. "nvidia-h100-80gb" → GKE nodeSelector;
      labels: extra ``--labels`` for the agent;
      pod_overrides: deep-merged into the generated pod spec.
    """

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "ray-tpu-torch"):
        super().__init__(provider_config or {}, cluster_name)
        cfg = self.provider_config
        self.kube = cfg.get("client") or KubeClient(
            api_server=cfg.get("api_server"), token=cfg.get("token"),
            ca_cert=cfg.get("ca_cert"), namespace=cfg.get("namespace"),
            insecure=bool(cfg.get("insecure")))
        self.head_address = cfg.get("head_address") or \
            os.environ.get("RTT_HEAD_ADDRESS", "")
        self.image = cfg.get("image") or os.environ.get(
            "RTT_IMAGE", "ray-tpu-torch:latest")

    # ------------------------------------------------------------- inventory
    def _selector(self) -> str:
        return f"ray-tpu-torch/cluster={self.cluster_name}," \
               f"ray-tpu-torch/kind={NODE_KIND_WORKER}"

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        out = []
        for pod in self.kube.list_pods(self._selector()):
            phase = (pod.get("status") or {}).get("phase", "Pending")
            if phase in ("Succeeded", "Failed"):
                continue
            if (pod.get("metadata") or {}).get("deletionTimestamp"):
                continue
            tags = self._tags_of(pod)
            if all(tags.get(k) == v for k, v in tag_filters.items()):
                out.append(pod["metadata"]["name"])
        return out

    @staticmethod
    def _tags_of(pod: dict) -> Dict[str, str]:
        labels = (pod.get("metadata") or {}).get("labels", {})
        tags = {TAG_NODE_KIND: labels.get("ray-tpu-torch/kind", ""),
                TAG_NODE_TYPE: labels.get("ray-tpu-torch/node-type", ""),
                TAG_NODE_STATUS: STATUS_UP_TO_DATE}
        return tags

    def node_tags(self, node_id: str) -> Dict[str, str]:
        try:
            return self._tags_of(self.kube.get_pod(node_id))
        except KubeApiError:
            return {}

    def internal_ip(self, node_id: str) -> str:
        try:
            return (self.kube.get_pod(node_id).get("status") or {}) \
                .get("podIP", "")
        except KubeApiError:
            return ""

    # -------------------------------------------------------------- lifecycle
    def _pod_manifest(self, node_config: Dict[str, Any],
                      tags: Dict[str, str]) -> dict:
        res = dict(node_config.get("resources", {}))
        cpus = res.get("CPU", 1)
        gpus = res.get("GPU", 0)
        name = f"{self.cluster_name}-worker-{uuid.uuid4().hex[:8]}"
        env = [
            {"name": "RTT_NUM_GPUS", "value": str(gpus)},
        ]
        # preemption warning plumbing (DESIGN.md §4j): with a grace
        # window configured, the pod's SIGTERM (kubelet eviction / spot
        # preemption notice) makes the agent report ``node_draining``
        # and keep serving until the deadline instead of dying silently
        grace = node_config.get("drain_grace_s",
                                self.provider_config.get("drain_grace_s"))
        if grace:
            env.append({"name": "RTT_DRAIN_GRACE_S", "value": str(grace)})
        if self.provider_config.get("auth_key_secret"):
            env.append({"name": "RTT_AUTH_KEY", "valueFrom": {
                "secretKeyRef": {
                    "name": self.provider_config["auth_key_secret"],
                    "key": "auth-key"}}})
        elif os.environ.get("RTT_AUTH_KEY"):
            env.append({"name": "RTT_AUTH_KEY",
                        "value": os.environ["RTT_AUTH_KEY"]})
        # ray-pod=<name> lets the autoscaler map the cluster node this
        # agent registers back to its pod for idle-based scale-down
        agent_labels = {"ray-pod": name,
                        **(node_config.get("labels") or {})}
        labels_flag = ",".join(f"{k}={v}" for k, v in agent_labels.items())
        args = ["-m", "ray_tpu_torch._private.node_agent",
                "--address", self.head_address,
                "--num-cpus", str(int(cpus))]
        if gpus:
            args += ["--num-gpus", str(gpus)]
        if labels_flag:
            args += ["--labels", labels_flag]
        container: Dict[str, Any] = {
            "name": "ray-tpu-torch-worker",
            "image": self.image,
            "command": ["python"],
            "args": args,
            "env": env,
            # the agent registers --num-cpus with the head; the SAME count
            # must be requested from Kubernetes or its bin-packing would
            # place pods onto cores that don't exist
            "resources": {"limits": {},
                          "requests": {"cpu": str(int(cpus))}},
        }
        node_selector: Dict[str, str] = {}
        if gpus:
            # GKE GPU node pools: the accelerator selector pins the pod to
            # hosts with the right card; nvidia.com/gpu is the device
            # plugin's resource (whole cards only)
            container["resources"]["limits"]["nvidia.com/gpu"] = int(gpus)
            container["resources"]["requests"]["nvidia.com/gpu"] = int(gpus)
            if node_config.get("gpu_accelerator"):
                node_selector["cloud.google.com/gke-accelerator"] = \
                    node_config["gpu_accelerator"]
        manifest: Dict[str, Any] = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "labels": {
                    "ray-tpu-torch/cluster": self.cluster_name,
                    "ray-tpu-torch/kind": tags.get(TAG_NODE_KIND,
                                             NODE_KIND_WORKER),
                    "ray-tpu-torch/node-type": tags.get(TAG_NODE_TYPE, ""),
                },
            },
            "spec": {
                "restartPolicy": "Never",
                "containers": [container],
                **({"nodeSelector": node_selector} if node_selector else {}),
            },
        }
        overrides = node_config.get("pod_overrides")
        if overrides:
            _deep_merge(manifest, overrides)
        return manifest

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        created = []
        for _ in range(count):
            pod = self.kube.create_pod(self._pod_manifest(node_config, tags))
            created.append(pod["metadata"]["name"])
        return created

    def terminate_node(self, node_id: str) -> None:
        self.kube.delete_pod(node_id)


class GkeGpuNodeProvider(KubernetesNodeProvider):
    """GKE flavor: identical pod mechanics; node types with cards are
    expected to carry ``gpu_accelerator`` (the GKE GPU node-pool
    selector, e.g. ``nvidia-h100-80gb``) so pods land on hosts with that
    card.  A pod's cards are whole: ``GPU`` in a node type's resources is
    rounded down to the ``nvidia.com/gpu`` count."""


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst
