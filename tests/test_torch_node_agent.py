"""The port's NodeAgent with its GPU slot, the client proxy and
``init("ray://")``, and ``cluster_utils`` / ``parse_labels`` against the
JAX package.

- A ``ray://`` client in another process drives tasks, an actor, ``put``
  and a large task result through ``ClientProxyServer`` (the reference's
  ``test_client_proxy_end_to_end`` in
  ``tests/test_workflow_dashboard_client.py``).
- An agent that declares ``--num-gpus 1`` runs one GPU worker and two
  plain ones.  With the plain workers idle, a ``num_gpus=1`` task and
  actor must still start in the GPU worker (``RTT_GPU_WORKER=1``, the
  card in its ``CUDA_VISIBLE_DEVICES``), over the node's raylet and
  with ``raylet_enabled=0``; plain tasks see no card.  Before the port's
  fix the raylet started any lease on any idle worker, and the head
  learnt a remote worker's capability only on a reattach, so a GPU task
  there never found a worker.
- ``parse_labels`` and a ``Cluster`` sequence give the JAX package's
  answers.

Agents run from the repository root found from this file.  The JAX
package is imported inside the parity tests only: the client's process
imports this module.
"""

import logging
import multiprocessing as mp
import os
import subprocess
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import node_agent as na
from ray_tpu_torch.util import state
from ray_tpu_torch.util.scheduling_strategies import \
    NodeAffinitySchedulingStrategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _logger():
    """``init`` stops the package logger's propagation: hand later
    modules the logger as it was."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    if rt.is_initialized():
        rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


@pytest.fixture
def head(monkeypatch):
    """A head that declares no card, so GPU work can only go to an
    agent."""
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=1, num_gpus=0)
    yield
    rt.shutdown()


# ------------------------------------------------------------ client proxy

def _client_driver(port, key_hex, q):
    import os
    os.environ["RTT_AUTH_KEY"] = key_hex  # shared out-of-band, like the
    # reference's client auth token
    import ray_tpu_torch as rt
    try:
        info = rt.init(address=f"ray://127.0.0.1:{port}")
        assert info["client"] and info["session_dir"] is None, info

        @rt.remote
        def double(x):
            return 2 * x

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        import numpy as np
        big = np.arange(300_000)          # forces fetch_object path
        ref = rt.put(big)
        got = rt.get(ref)
        task_out = rt.get(double.remote(21))
        c = Counter.remote()
        rt.get(c.add.remote(5))
        actor_out = rt.get(c.add.remote(7))

        # a large TASK RESULT lands on the cluster's shm/slab; the client
        # must fetch it through the proxy
        @rt.remote
        def make_big():
            import numpy as np
            return np.ones(200_000)
        big_sum = float(rt.get(make_big.remote()).sum())
        q.put(("ok", int(got.sum()), task_out, actor_out, big_sum))
    except Exception:  # noqa: BLE001
        import traceback
        q.put(("err", traceback.format_exc(), None, None, None))


def test_client_proxy_end_to_end(monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4, num_gpus=0)
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.client import ClientProxyServer

    session = worker_mod.global_worker().session
    proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
    port = proxy._listener.address[1]
    try:
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        p = ctx.Process(target=_client_driver,
                        args=(port, session.auth_key().hex(), q))
        p.start()
        status, a, b, c, d = q.get(timeout=120)
        p.join(timeout=30)
        assert status == "ok", a
        assert a == sum(range(300_000))
        assert b == 42
        assert c == 12
        assert d == 200_000.0
    finally:
        proxy.stop()
        rt.shutdown()


# ------------------------------------------------------ the agent's GPU slot

def _view():
    return (os.environ.get("RTT_GPU_WORKER"),
            os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid())


def _idle_on(node_id: str, raylet: bool) -> int:
    if raylet:
        rows = [r for r in state.list_raylets() if r["node_id"] == node_id]
        return rows[0]["stats"].get("idle", 0) if rows else 0
    return len([w for w in state.list_workers()
                if w["node_id"] == node_id and w["state"] == "idle"])


def _start_agent(mode: str, args: list, env_extra: dict):
    """A proxy on the head and an agent through it (``raylet`` or
    ``legacy`` mode); returns (proxy, agent, its node row) once the node
    is alive and, over the raylet, attached."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.client import ClientProxyServer

    session = worker_mod.global_worker().session
    proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
    env = dict(os.environ)
    env["RTT_AUTH_KEY"] = session.auth_key().hex()
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("RTT_SESSION_DIR", None)
    env.update(env_extra)
    if mode == "legacy":
        env["RTT_RAYLET_ENABLED"] = "0"
    agent = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.node_agent",
         "--address", f"127.0.0.1:{proxy._listener.address[1]}"] + args,
        env=env, cwd=REPO)
    deadline = time.time() + 60
    node = None
    while time.time() < deadline:
        node = next((n for n in state.list_nodes()
                     if n["labels"].get("agent") == "1"
                     and n["alive"]), None)
        if node is not None and (mode == "legacy" or any(
                r["attached"] for r in state.list_raylets())):
            break
        time.sleep(0.1)
    if node is None:
        agent.terminate()
        agent.wait(timeout=30)
        proxy.stop()
        raise AssertionError("agent node never registered")
    return proxy, agent, node


@pytest.mark.parametrize("mode", ["raylet", "legacy"])
def test_gpu_lease_starts_on_the_gpu_slot(head, mode):
    # the agent's list: it takes one
    proxy, agent, node = _start_agent(
        mode, ["--num-cpus", "2", "--num-gpus", "1"],
        {"CUDA_VISIBLE_DEVICES": "3,5", "RTT_NUM_GPUS": "0"})
    try:
        assert node["resources_total"]["GPU"] == 1.0
        assert bool(state.list_raylets()) == (mode == "raylet")
        nid = node["node_id"]
        pin = NodeAffinitySchedulingStrategy(nid, soft=False)

        @rt.remote(scheduling_strategy=pin)
        def plain():
            time.sleep(0.2)
            return _view()

        def all_idle():
            # the plain workers (two, or more with a replacement the
            # raylet forked while they were busy) and the GPU worker
            deadline = time.time() + 30
            while _idle_on(nid, mode == "raylet") < 3 \
                    and time.time() < deadline:
                time.sleep(0.1)
            assert _idle_on(nid, mode == "raylet") >= 3

        # booted: the head's own rule lets a plain task ride a GPU
        # worker while no plain one has attached yet
        all_idle()
        views = rt.get([plain.remote() for _ in range(4)], timeout=60)
        assert {v[:2] for v in views} == {(None, "")}, views
        # the planted condition: plain workers idle when the GPU leases
        # arrive
        all_idle()

        @rt.remote(num_gpus=1)
        def on_card():
            return _view()

        gpu, devices, task_pid = rt.get(on_card.remote(), timeout=30)
        assert (gpu, devices) == ("1", "3")
        assert task_pid not in {v[2] for v in views}

        @rt.remote(num_gpus=1, num_cpus=0)
        class OnCard:
            def view(self):
                return _view() + (rt.get_runtime_context().get_node_id(),)

        a = OnCard.remote()
        assert rt.get(a.view.remote(), timeout=30) == \
            ("1", "3", task_pid, nid)
        assert rt.get([plain.remote() for _ in range(2)], timeout=60)[0][:2] \
            == (None, "")
    finally:
        agent.terminate()
        agent.wait(timeout=30)
        proxy.stop()


@pytest.mark.parametrize("mode", ["raylet", "legacy"])
def test_agent_detects_cards_and_starts_the_heads_gpu_slots(monkeypatch,
                                                            mode):
    """With no ``--num-gpus`` the agent counts its cards (here
    ``RTT_NUM_GPUS``), and it starts as many GPU workers as the head's
    ``gpu_workers_per_node``: two ``num_gpus=0.5`` actors pinned to the
    node each get one."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=1, num_gpus=0,
            _system_config={"gpu_workers_per_node": 2})
    proxy = agent = None
    try:
        proxy, agent, node = _start_agent(
            mode, ["--num-cpus", "1"],
            {"RTT_NUM_GPUS": "1", "CUDA_VISIBLE_DEVICES": "4"})
        assert node["resources_total"]["GPU"] == 1.0
        pin = NodeAffinitySchedulingStrategy(node["node_id"], soft=False)

        @rt.remote(num_gpus=0.5, num_cpus=0, scheduling_strategy=pin)
        class Half:
            def view(self):
                return _view()

        halves = [Half.remote() for _ in range(2)]
        views = rt.get([h.view.remote() for h in halves], timeout=60)
        assert [v[:2] for v in views] == [("1", "4")] * 2, views
        assert views[0][2] != views[1][2]
    finally:
        if agent is not None:
            agent.terminate()
            agent.wait(timeout=30)
            proxy.stop()
        rt.shutdown()
        GLOBAL_CONFIG.reset()


def test_node_removed_when_its_join_conn_closes_before_attaching(head):
    """An agent killed between ``add_node`` and its attach (a SIGTERM
    while it starts) leaves only its join conn behind: the head removes
    the node when that conn closes."""
    from ray_tpu_torch._private import protocol
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.client import ClientProxyServer

    session = worker_mod.global_worker().session
    proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
    try:
        conn = protocol.tunnel_connect(
            "127.0.0.1", proxy._listener.address[1], "gcs")
        ch = protocol.RpcChannel(conn, negotiate=True)
        nid = ch.call("add_node", resources={"CPU": 1.0},
                      labels={"agent": "1"}, remote=True)["node_id"]

        def alive():
            return any(n["node_id"] == nid and n["alive"]
                       for n in state.list_nodes())

        assert alive()
        ch.close()
        deadline = time.time() + 10
        while alive() and time.time() < deadline:
            time.sleep(0.05)
        assert not alive(), "the unattached node outlived its join conn"
    finally:
        proxy.stop()


# ------------------------------------------------- parity with the JAX side

@pytest.mark.parametrize("spec", ["a=1,b=x y", "", "k=v,,k2= w ",
                                  "ici_domain", "=v", "a=1,b"])
def test_parse_labels_matches_reference(spec):
    from ray_tpu._private import node_agent as ref

    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(na.parse_labels) == run(ref.parse_labels)


def _spread_then_remove(pkg, cluster_cls, placement_group,
                        placement_group_table) -> tuple:
    cluster = cluster_cls(initialize_head=True,
                          head_node_args={"num_cpus": 2,
                                          **({"num_gpus": 0}
                                             if pkg is rt else {})})
    try:
        order = [cluster.head_node.node_id]
        nodes = [cluster.add_node(num_cpus=1) for _ in range(2)]
        order += [n.node_id for n in nodes]
        pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
        assert pg.wait(timeout_seconds=10)
        row = placement_group_table()[pg.id]
        placed = (row["state"], sorted(order.index(a)
                                       for a in row["assignment"]))
        cluster.remove_node(nodes[1])
        pg.wait(timeout_seconds=1)
        row = placement_group_table()[pg.id]
        after = (row["state"], sorted(order.index(a) if a in order else -1
                                      for a in row["assignment"] or ()))
        alive = sorted(order.index(n["node_id"]) for n in pkg.nodes()
                       if n["alive"])
        return placed, after, alive
    finally:
        cluster.shutdown()


def test_cluster_sequence_matches_reference(monkeypatch):
    import ray_tpu
    from ray_tpu.cluster_utils import Cluster as RefCluster
    from ray_tpu.util import placement_group as ref_pg

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import placement_group as pg

    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if rt.is_initialized():
        rt.shutdown()
    want = _spread_then_remove(ray_tpu, RefCluster, ref_pg.placement_group,
                               ref_pg.placement_group_table)
    got = _spread_then_remove(rt, Cluster, pg.placement_group,
                              pg.placement_group_table)
    assert got == want
    assert got == (("ready", [0, 1, 2]), want[1], [0, 1]), got
