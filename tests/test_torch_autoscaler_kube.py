"""The port's Kubernetes/GKE node provider against an in-tree fake API
server: the reference's ``tests/test_autoscaler_kube.py`` case by case.

The provider speaks the REAL Kubernetes REST dialect to a fake
kube-apiserver whose "kubelet" launches an actual ``ray_tpu_torch``
NodeAgent process per pod (from the repository root found from this
file), so the e2e path is: demand spike → autoscaler bin-packs →
provider creates a pod → the pod's agent joins the head with its labels
→ the placement group schedules onto it → idle → scale-down deletes the
pod.  A GPU node type's pod carries the ``nvidia.com/gpu`` limit and the
GKE accelerator selector.
"""

import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import pytest

import ray_tpu_torch
from conftest import time_scale
from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                 StandardAutoscaler)
from ray_tpu_torch.autoscaler.kube import (
    KubeClient, KubernetesNodeProvider, GkeGpuNodeProvider)
from ray_tpu_torch.util import state
from rtt_fixtures import REPO, restore_logger, session_root

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")


@pytest.fixture(scope="module", autouse=True)
def _logger():
    with restore_logger():
        yield


@pytest.fixture
def ray_start_regular(monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    with session_root(monkeypatch):
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=4, num_gpus=0)
        yield
        ray_tpu_torch.shutdown()


class FakeKubeApiServer:
    """The pod-CRUD subset of the Kubernetes API, plus a fake kubelet:
    created pods whose args target a ray_tpu_torch head actually run a
    NodeAgent subprocess (spawn_agents=True) so the node truly joins."""

    def __init__(self, spawn_agents: bool = False):
        self.pods = {}            # name -> manifest (+status)
        self.procs = {}           # name -> Popen
        self.lock = threading.Lock()
        self.spawn_agents = spawn_agents
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802 - quiet
                pass

            def _send(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                u = urlparse(self.path)
                parts = u.path.strip("/").split("/")
                # /api/v1/namespaces/{ns}/pods[/name]
                if len(parts) == 5 and parts[4] == "pods":
                    sel = parse_qs(u.query).get("labelSelector", [""])[0]
                    want = dict(kv.split("=", 1)
                                for kv in unquote(sel).split(",") if kv)
                    with outer.lock:
                        items = [p for p in outer.pods.values()
                                 if all(p["metadata"].get("labels", {})
                                        .get(k) == v
                                        for k, v in want.items())]
                    self._send(200, {"kind": "PodList", "items": items})
                elif len(parts) == 6 and parts[4] == "pods":
                    with outer.lock:
                        pod = outer.pods.get(parts[5])
                    if pod is None:
                        self._send(404, {"message": "not found"})
                    else:
                        self._send(200, pod)
                else:
                    self._send(404, {"message": "unknown path"})

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                manifest = json.loads(self.rfile.read(n))
                name = manifest["metadata"]["name"]
                manifest.setdefault("status", {})["phase"] = "Running"
                manifest["status"]["podIP"] = "127.0.0.1"
                with outer.lock:
                    outer.pods[name] = manifest
                if outer.spawn_agents:
                    outer._spawn_agent(name, manifest)
                self._send(201, manifest)

            def do_DELETE(self):  # noqa: N802
                parts = urlparse(self.path).path.strip("/").split("/")
                name = parts[5] if len(parts) == 6 else None
                with outer.lock:
                    pod = outer.pods.pop(name, None)
                    proc = outer.procs.pop(name, None)
                if proc is not None:
                    proc.terminate()
                if pod is None:
                    self._send(404, {"message": "not found"})
                else:
                    self._send(200, {"status": "Success"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def _spawn_agent(self, name, manifest):
        """The fake kubelet: run the pod's node-agent command locally."""
        c = manifest["spec"]["containers"][0]
        env = dict(os.environ)
        for e in c.get("env", []):
            if "value" in e:
                env[e["name"]] = e["value"]
        env.pop("RTT_SESSION_DIR", None)
        proc = subprocess.Popen(
            [sys.executable] + c["args"], env=env, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        self.procs[name] = proc

    def preempt(self, name):
        """Spot preemption warning: SIGTERM the pod's agent (the
        kubelet's eviction signal).  With RTT_DRAIN_GRACE_S in the pod
        env the agent reports ``node_draining`` and keeps serving until
        the deadline, then leaves cleanly on its own."""
        with self.lock:
            proc = self.procs.get(name)
        if proc is not None and proc.poll() is None:
            proc.terminate()

    def stop(self):
        for p in self.procs.values():
            p.terminate()
        self.httpd.shutdown()


@pytest.fixture
def fake_kube():
    srv = FakeKubeApiServer()
    yield srv
    srv.stop()


def _provider(srv, **cfg):
    client = KubeClient(api_server=f"http://127.0.0.1:{srv.port}",
                        namespace="default", token="test-token")
    return KubernetesNodeProvider(
        {"client": client, "head_address": cfg.pop("head_address", ""),
         "image": "ray-tpu-torch:test", **cfg}, cluster_name="t")


def test_pod_crud_and_tags(fake_kube):
    prov = _provider(fake_kube)
    ids = prov.create_node(
        {"resources": {"CPU": 2}}, {"node-kind": "worker",
                                    "node-type": "cpu"}, 2)
    assert len(ids) == 2
    live = prov.non_terminated_nodes({})
    assert sorted(live) == sorted(ids)
    assert prov.node_tags(ids[0])["node-type"] == "cpu"
    assert prov.non_terminated_nodes({"node-type": "cpu"}) == live
    assert prov.non_terminated_nodes({"node-type": "gpu"}) == []
    prov.terminate_node(ids[0])
    assert prov.non_terminated_nodes({}) == [ids[1]]


def test_gpu_pod_manifest_carries_gke_selectors(fake_kube):
    prov = GkeGpuNodeProvider(
        {"client": KubeClient(api_server=f"http://127.0.0.1:{fake_kube.port}",
                              token="t"),
         "head_address": "head:10001"}, cluster_name="t")
    [nid] = prov.create_node(
        {"resources": {"CPU": 8, "GPU": 4},
         "gpu_accelerator": "nvidia-h100-80gb"},
        {"node-kind": "worker", "node-type": "h100-4"}, 1)
    pod = fake_kube.pods[nid]
    sel = pod["spec"]["nodeSelector"]
    assert sel == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    res = pod["spec"]["containers"][0]["resources"]
    assert res["limits"]["nvidia.com/gpu"] == 4
    assert res["requests"]["nvidia.com/gpu"] == 4
    args = pod["spec"]["containers"][0]["args"]
    assert args[:2] == ["-m", "ray_tpu_torch._private.node_agent"]
    assert "--num-gpus" in args and "4" in args
    env = {e["name"]: e.get("value")
           for e in pod["spec"]["containers"][0]["env"]}
    assert env["RTT_NUM_GPUS"] == "4"
    # a CPU-only node type asks for no card and selects no pool
    [cpu] = prov.create_node({"resources": {"CPU": 2}},
                             {"node-kind": "worker", "node-type": "cpu"}, 1)
    pod = fake_kube.pods[cpu]
    assert "nodeSelector" not in pod["spec"]
    assert pod["spec"]["containers"][0]["resources"]["limits"] == {}
    assert "--num-gpus" not in pod["spec"]["containers"][0]["args"]


def test_e2e_scale_up_schedule_scale_down(ray_start_regular, monkeypatch):
    """Demand spike → provider pod → real agent joins with labels → PG
    schedules on it → idle → autoscaler terminates the pod."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.client import ClientProxyServer

    session = worker_mod.global_worker().session
    proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
    port = proxy._listener.address[1]
    monkeypatch.setenv("RTT_AUTH_KEY", session.auth_key().hex())
    srv = FakeKubeApiServer(spawn_agents=True)
    try:
        prov = _provider(srv, head_address=f"127.0.0.1:{port}")
        cfg = AutoscalerConfig(
            node_types={"kworker": {
                "resources": {"CPU": 1},
                "labels": {"pool": "kube"},
                "min_workers": 0, "max_workers": 2}},
            idle_timeout_s=3.0)
        # patch node_config passthrough: resources + labels ride create
        autoscaler = StandardAutoscaler(cfg, prov)

        # demand: a placement group needing a CPU the head can't give
        # (consume the head's CPUs with parked actors)
        @ray_tpu_torch.remote
        class Hog:
            def ping(self):
                return 1

        hogs = [Hog.options(num_cpus=1).remote()
                for _ in range(int(ray_tpu_torch.cluster_resources()
                                   .get("CPU", 2)))]
        for h in hogs:
            ray_tpu_torch.get(h.ping.remote(), timeout=60)

        from ray_tpu_torch.util.placement_group import placement_group
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert not pg.wait(timeout_seconds=1)

        report = autoscaler.update()
        assert report["launched"], report  # pod created
        assert srv.pods, "no pod created on the fake apiserver"

        # the fake kubelet ran a real agent: the node joins with labels
        deadline = time.time() + 90 * time_scale()
        joined = None
        while time.time() < deadline and joined is None:
            for n in state.list_nodes():
                if n["alive"] and n["labels"].get("agent") == "1" \
                        and n["labels"].get("pool") == "kube":
                    joined = n
            time.sleep(0.3)
        assert joined is not None, "agent pod never joined the cluster"

        assert pg.wait(timeout_seconds=60), "PG did not schedule on the pod"

        # release demand; after idle_timeout the pod is terminated
        from ray_tpu_torch.util.placement_group import remove_placement_group
        remove_placement_group(pg)
        deadline = time.time() + 60 * time_scale()
        while time.time() < deadline and srv.pods:
            autoscaler.update()
            time.sleep(1.0)
        assert not srv.pods, "idle pod was not scaled down"
    finally:
        srv.stop()
        proxy.stop()


def test_kube_preemption_drain_lifecycle(ray_start_regular, monkeypatch):
    """The provider emits ``node_draining`` (DESIGN.md §4j) and the pod
    agent honors the warning window: provider.drain_node maps the pod
    name to the cluster node via its ray-pod label and flips it to
    draining; SIGTERM with RTT_DRAIN_GRACE_S set makes the agent keep
    serving until the deadline, then leave cleanly — the node is
    removed without any head-side death detection."""
    from ray_tpu_torch import elastic
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.client import ClientProxyServer

    session = worker_mod.global_worker().session
    proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
    port = proxy._listener.address[1]
    monkeypatch.setenv("RTT_AUTH_KEY", session.auth_key().hex())
    srv = FakeKubeApiServer(spawn_agents=True)
    try:
        prov = _provider(srv, head_address=f"127.0.0.1:{port}",
                         drain_grace_s=2.0)
        [pod] = prov.create_node({"resources": {"CPU": 1}},
                                 {"node-kind": "worker",
                                  "node-type": "kworker"}, 1)
        # the manifest carries the grace env down to the agent
        env = {e["name"]: e.get("value")
               for e in srv.pods[pod]["spec"]["containers"][0]["env"]}
        assert env.get("RTT_DRAIN_GRACE_S") == "2.0"

        deadline = time.time() + 90 * time_scale()
        node = None
        while time.time() < deadline and node is None:
            for n in state.list_nodes():
                if n["alive"] and (n["labels"] or {}).get("ray-pod") == pod:
                    node = n
            time.sleep(0.3)
        assert node is not None, "agent pod never joined"

        seen = []
        sub = elastic.FleetEventSubscriber(seen.append,
                                          kinds=("node_draining",))
        sub.start(from_now=True)
        try:
            # provider-initiated warning, addressed by pod name
            prov.drain_node(pod, deadline_s=30.0, reason="spot")
            deadline = time.time() + 30 * time_scale()
            while time.time() < deadline and not seen:
                time.sleep(0.2)
            assert seen and seen[0]["node_id"] == node["node_id"]
            phases = {n["node_id"]: n["phase"] for n in state.list_nodes()}
            assert phases[node["node_id"]] == "draining"

            # the kubelet's eviction signal: agent self-reports (idempotent
            # against the provider's earlier warning), serves out the 2s
            # grace, then leaves cleanly -> node removed WITHOUT delete_pod
            srv.preempt(pod)
            deadline = time.time() + 60 * time_scale()
            while time.time() < deadline:
                alive = [n for n in state.list_nodes()
                         if n["node_id"] == node["node_id"] and n["alive"]]
                if not alive:
                    break
                time.sleep(0.3)
            assert not alive, "drained agent never left the cluster"
        finally:
            sub.stop()
    finally:
        srv.stop()
        proxy.stop()


def test_bin_packing_under_100_node_churn():
    """The bin-packing contract at fleet scale: a scripted
    100-node preemption trace plus a diurnal demand curve drive the
    REAL ``resource_demand_scheduler.get_nodes_to_launch`` loop (via
    the fleet simulator's SimAutoscaler) for two sim-hours — no demand
    may be stranded and no node may be double-placed, deterministically
    from the seed."""
    from ray_tpu_torch.elastic.fleet_sim import FleetSimulator
    from ray_tpu_torch.elastic.traces import (diurnal_demand_trace,
                                        synthetic_preemption_trace)

    def build():
        trace = synthetic_preemption_trace(
            11, duration_s=7200.0, n_slices=100,
            mean_interval_s=90.0, warning_s=30.0,
            unwarned_fraction=0.3,
            outage_every_s=2400.0, outage_len_s=180.0)
        demand = diurnal_demand_trace(
            11, duration_s=7200.0, base=30, amplitude=20,
            period_s=3600.0, burst_rate_per_hour=4.0,
            burst_extra=10, burst_len_s=300.0)
        return FleetSimulator(
            node_types={"host": {"resources": {"CPU": 8, "GPU": 8},
                                 "min_workers": 0, "max_workers": 100}},
            demand_shape={"CPU": 8, "GPU": 8},
            preemption=trace, demand=demand, job=None,
            tick_s=5.0, boot_delay_s=45.0, max_workers=100)

    r1 = build().run().to_dict()
    r2 = build().run().to_dict()
    assert r1 == r2, "churn run not deterministic from the seed"
    assert r1["preempted"] >= 40, r1["preempted"]
    assert r1["launched"] >= 60, r1["launched"]
    assert r1["max_unfulfilled"] > 0      # churn really backlogged it
    assert r1["stranded_demand"] == 0, r1
    assert r1["double_placements"] == 0, r1


# ------------------------------------------------------- operator (KubeRay)
def test_operator_reconciles_groups(fake_kube):
    """Declarative spec → pods: create to target, scale down, drop removed
    groups (the KubeRay-operator contract, SURVEY.md §2.6 deploy row)."""
    from ray_tpu_torch.autoscaler.operator import RayClusterOperator

    prov = _provider(fake_kube)
    spec = {"cluster_name": "t", "worker_groups": [
        {"name": "cpu", "replicas": 2,
         "node_config": {"resources": {"CPU": 2}}},
        {"name": "h100", "replicas": 1,
         "node_config": {"resources": {"CPU": 8, "GPU": 8},
                         "gpu_accelerator": "nvidia-h100-80gb"}}]}
    op = RayClusterOperator(prov, spec=spec)
    r1 = op.reconcile()
    assert len(r1["created"]["cpu"]) == 2
    assert len(r1["created"]["h100"]) == 1
    assert r1["groups"]["cpu"]["current"] == 2
    # GPU group pods carry the GKE selector
    pod = fake_kube.pods[r1["created"]["h100"][0]]
    assert pod["spec"]["nodeSelector"][
        "cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"

    # idempotent: a second pass changes nothing
    r2 = op.reconcile()
    assert not r2["created"] and not r2["deleted"]

    # scale down cpu to 1; remove the h100 group entirely
    op.update_spec({"cluster_name": "t", "worker_groups": [
        {"name": "cpu", "replicas": 1,
         "node_config": {"resources": {"CPU": 2}}}]})
    r3 = op.reconcile()
    assert len(r3["deleted"]["cpu"]) == 1
    assert len(r3["deleted"]["h100"]) == 1
    assert sorted(prov.node_tags(p)["node-type"]
                  for p in prov.non_terminated_nodes({})) == ["cpu"]


def test_operator_autoscaling_group_left_to_autoscaler(fake_kube):
    from ray_tpu_torch.autoscaler.operator import RayClusterOperator

    prov = _provider(fake_kube)
    op = RayClusterOperator(prov, spec={"cluster_name": "t",
        "worker_groups": [{"name": "elastic",
                           "autoscaling": {"min_replicas": 0,
                                           "max_replicas": 4},
                           "node_config": {"resources": {"CPU": 1}}}]})
    r = op.reconcile()
    assert r["groups"]["elastic"]["managed_by"] == "autoscaler"
    assert not r["created"]  # operator does not touch autoscaled groups
