"""The port's multi-node runtime on one host, held to the reference's
``tests/test_multihost.py``: a ``NodeAgent`` joins the head over TCP
through the client proxy (``python -m ray_tpu_torch._private.node_agent``)
and runs tasks and actors, large objects stream in chunks or move
host to host over the agents' data planes, and the node goes when its
agent exits.

The agent dials the head's client-proxy port on localhost here; the
transport is identical for a genuinely remote host (plus RTT_AUTH_KEY
sharing).  Agents run from the repository root found from this file,
with it on their ``PYTHONPATH``.  Functions and classes here are pickled
by value, so the agents' workers never import this module.
"""

import logging
import os
import subprocess
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
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


def agent_env(session, extra=None) -> dict:
    """An agent's environment: the session's key, this checkout first
    on the path, no session dir of the head's."""
    env = dict(os.environ)
    env["RTT_AUTH_KEY"] = session.auth_key().hex()
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("RTT_SESSION_DIR", None)
    env["RTT_NUM_GPUS"] = "0"   # a card-less host: nothing to detect
    env.update(extra or {})
    return env


def wait_agent_node(exclude=(), timeout=60) -> str:
    deadline = time.time() + timeout
    while time.time() < deadline:
        for n in state.list_nodes():
            if n["labels"].get("agent") == "1" and n["alive"] \
                    and n["node_id"] not in exclude:
                return n["node_id"]
        time.sleep(0.2)
    raise AssertionError("agent node never registered")


def _start_agent(num_cpus: int, exclude=()):
    """Start a proxy + node agent against the current head; returns
    (proxy, agent_proc, node_id).  ``exclude`` holds node ids of agents
    already running so multi-agent tests don't mistake an earlier agent's
    node for the new one."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.client import ClientProxyServer

    session = worker_mod.global_worker().session
    proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
    port = proxy._listener.address[1]
    agent = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.node_agent",
         "--address", f"127.0.0.1:{port}", "--num-cpus", str(num_cpus)],
        env=agent_env(session), cwd=REPO)
    return proxy, agent, wait_agent_node(exclude)


def _stop_agent(agent, proxy):
    agent.terminate()
    agent.wait(timeout=30)
    proxy.stop()


@pytest.fixture
def ray_start_2_cpus():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, num_gpus=0)
    yield
    rt.shutdown()


@pytest.fixture
def ray_start_regular():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4, num_gpus=0)
    yield
    rt.shutdown()


@pytest.fixture
def remote_node(ray_start_2_cpus):
    proxy, agent, node_id = _start_agent(num_cpus=2)
    try:
        yield node_id
    finally:
        _stop_agent(agent, proxy)


def test_tasks_run_on_remote_node(remote_node):
    pin = NodeAffinitySchedulingStrategy(remote_node)

    @rt.remote(scheduling_strategy=pin)
    def where():
        import os
        return os.getpid(), os.environ.get("RTT_PROXY_ADDR") is not None

    # wait for the agent's workers to come up
    deadline = time.time() + 60
    while time.time() < deadline:
        workers = [w for w in state.list_workers()
                   if w["node_id"] == remote_node and w["state"] != "dead"]
        if len(workers) >= 1:
            break
        time.sleep(0.2)

    pid, via_proxy = rt.get(where.remote(), timeout=60)
    assert via_proxy, "task did not run in a proxied remote worker"
    assert pid != os.getpid()

    # bigger payloads ride the control plane both ways
    @rt.remote(scheduling_strategy=pin)
    def crunch(arr):
        return arr * 2

    big = np.arange(200_000)
    out = rt.get(crunch.remote(big), timeout=60)
    assert int(out.sum()) == 2 * big.sum()


def test_actor_on_remote_node(remote_node):
    pin = NodeAffinitySchedulingStrategy(remote_node)

    @rt.remote(scheduling_strategy=pin)
    class Counter:
        def __init__(self, start):
            self.n = start
            self.pid = os.getpid()

        def add(self, k):
            self.n += k
            return self.n

        def where(self):
            return self.pid, os.environ.get("RTT_PROXY_ADDR") is not None

    c = Counter.remote(10)
    pid, via_proxy = rt.get(c.where.remote(), timeout=90)
    assert via_proxy, "actor did not run in a proxied remote worker"
    assert pid != os.getpid()
    # ordered pipelined calls over the tcp:// channel
    refs = [c.add.remote(1) for _ in range(20)]
    assert rt.get(refs[-1], timeout=60) == 30
    assert rt.get(refs, timeout=60) == list(range(11, 31))

    # numpy payloads through the control plane both ways
    @rt.remote(scheduling_strategy=pin)
    class Holder:
        def __init__(self):
            self.arr = None

        def set(self, a):
            self.arr = a
            return a.shape

        def total(self):
            return float(self.arr.sum())

    h = Holder.remote()
    big = np.arange(100_000).astype(np.float64)
    assert rt.get(h.set.remote(big), timeout=60) == big.shape
    assert rt.get(h.total.remote(), timeout=60) == float(big.sum())


def test_remote_actor_restart(remote_node):
    pin = NodeAffinitySchedulingStrategy(remote_node)

    # no max_task_retries: an in-flight die() would be resubmitted to the
    # restarted incarnation and kill it again (at-least-once semantics)
    @rt.remote(max_restarts=1, scheduling_strategy=pin)
    class Flaky:
        def pid(self):
            return os.getpid()

        def die(self):
            os._exit(1)

    f = Flaky.remote()
    pid1 = rt.get(f.pid.remote(), timeout=90)
    f.die.remote()
    # restarted actor (possibly on any node) answers again
    deadline = time.time() + 90
    pid2 = None
    while time.time() < deadline:
        try:
            pid2 = rt.get(f.pid.remote(), timeout=30)
            break
        except rt.exceptions.RayActorError:
            time.sleep(0.5)
    assert pid2 is not None and pid2 != pid1


def test_chunked_object_transfer(ray_start_2_cpus, monkeypatch):
    """Large args/returns stream in chunks over the control plane
    (reference: ObjectManager chunked transfer)."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    monkeypatch.setattr(GLOBAL_CONFIG, "transfer_chunk_bytes", 64 * 1024)
    monkeypatch.setenv("RTT_TRANSFER_CHUNK_BYTES", str(64 * 1024))
    proxy, agent, node_id = _start_agent(num_cpus=1)
    try:
        pin = NodeAffinitySchedulingStrategy(node_id)

        @rt.remote(scheduling_strategy=pin)
        def crunch(a):
            return a * 2  # big in, big out: chunked both directions

        big = np.arange(300_000, dtype=np.float64)  # 2.4MB → ~37 chunks
        ref = crunch.remote(big)
        out = rt.get(ref, timeout=90)
        np.testing.assert_array_equal(out, big * 2)

        # the big return is readable by a head-local task too
        @rt.remote
        def total(a):
            return float(a.sum())

        assert rt.get(total.remote(ref), timeout=60) == float((big * 2).sum())
    finally:
        _stop_agent(agent, proxy)


def test_remote_node_removed_on_agent_exit(ray_start_2_cpus):
    proxy, agent, nid = _start_agent(num_cpus=1)
    agent.terminate()
    agent.wait(timeout=30)
    deadline = time.time() + 30
    while time.time() < deadline:
        alive = [n for n in state.list_nodes()
                 if n["node_id"] == nid and n["alive"]]
        if not alive:
            break
        time.sleep(0.2)
    assert not alive, "remote node still alive after agent exit"
    proxy.stop()


def test_put_chunk_duplicate_does_not_seal_holes(ray_start_regular):
    """A retried/duplicated chunk must not double-count toward completion
    and seal a segment that still has holes (ObjectManager chunked-transfer
    semantics: completion = covered offsets, not cumulative bytes)."""
    head = rt._head
    oid = "putchunkdup0000000000000000000001"
    chunk = b"x" * 1024
    total = 3 * len(chunk)
    r = head._h_put_chunk({"object_id": oid, "offset": 0, "total": total,
                           "data": chunk})
    assert not r["done"]
    # duplicate of offset 0 (e.g. an uploader retry after a dropped reply)
    r = head._h_put_chunk({"object_id": oid, "offset": 0, "total": total,
                           "data": chunk})
    assert not r["done"]
    r = head._h_put_chunk({"object_id": oid, "offset": 1024, "total": total,
                           "data": chunk})
    assert not r["done"], "segment still has a hole at offset 2048"
    r = head._h_put_chunk({"object_id": oid, "offset": 2048, "total": total,
                           "data": chunk})
    assert r["done"]


def test_node_agent_label_parsing():
    """The ``--labels`` format (the reference's test also covers its GKE
    TPU metadata autodetection, which the port leaves out)."""
    from ray_tpu_torch._private import node_agent as na

    assert na.parse_labels("a=1,b=x y") == {"a": "1", "b": "x y"}
    assert na.parse_labels("") == {}
    assert not hasattr(na, "_detect_tpu_env")


def test_parse_labels_rejects_malformed():
    from ray_tpu_torch._private import node_agent as na
    with pytest.raises(ValueError):
        na.parse_labels("ici_domain")  # missing =v must fail fast
    with pytest.raises(ValueError):
        na.parse_labels("=v")


def test_p2p_object_transfer_bypasses_head(ray_start_2_cpus, monkeypatch):
    """A large object produced on agent host A is consumed on agent host B
    by pulling directly from A's data-plane listener — the head never
    stores or relays the bytes (reference: ObjectManager node-to-node
    chunked transfer; head relay is only the unreachable-peer fallback)."""
    from ray_tpu_torch._private import protocol
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    monkeypatch.setattr(GLOBAL_CONFIG, "transfer_chunk_bytes", 64 * 1024)
    monkeypatch.setenv("RTT_TRANSFER_CHUNK_BYTES", str(64 * 1024))
    proxy_a, agent_a, node_a = _start_agent(num_cpus=1)
    proxy_b, agent_b, node_b = _start_agent(num_cpus=1, exclude={node_a})
    try:
        pin_a = NodeAffinitySchedulingStrategy(node_a)
        pin_b = NodeAffinitySchedulingStrategy(node_b)

        @rt.remote(scheduling_strategy=pin_a)
        def produce():
            return np.arange(300_000, dtype=np.float64)  # 2.4MB

        ref = produce.remote()
        # object seals as remote-spooled on A, not uploaded to the head
        head = rt._head
        deadline = time.time() + 60
        while time.time() < deadline:
            meta = head.objects.get(str(ref.id))
            if meta is not None and meta.state == "ready":
                break
            time.sleep(0.2)
        meta = head.objects[str(ref.id)]
        assert meta.loc == "remote", meta.loc
        assert meta.node_id == node_a

        @rt.remote(scheduling_strategy=pin_b)
        def consume(a):
            return float(a.sum())

        expect = float(np.arange(300_000, dtype=np.float64).sum())
        assert rt.get(consume.remote(ref), timeout=90) == expect

        # bytes moved A→B directly: A's data plane served them...
        data_addr = head.nodes[node_a].data_addr
        host, port = protocol.parse_tcp_addr(data_addr)
        conn = protocol.connect_tcp(host, port, timeout=5)
        conn.send({"op": "stats"})
        stats = conn.recv()
        conn.close()
        assert stats["bytes_served"] >= 2_400_000, stats

        # ...and the head never staged or relayed them
        assert str(ref.id) not in head._staging
        assert meta.loc == "remote", "head pulled the object through itself"
        from ray_tpu_torch._private.shm_store import ShmObjectStore
        assert not ShmObjectStore.exists_in_shm(str(ref.id))

        # the driver (head host) reads it straight from A's data plane too
        np.testing.assert_array_equal(
            rt.get(ref, timeout=60), np.arange(300_000, dtype=np.float64))
        assert meta.loc == "remote"
    finally:
        for agent, proxy in ((agent_a, proxy_a), (agent_b, proxy_b)):
            _stop_agent(agent, proxy)


def test_p2p_head_relay_fallback(ray_start_2_cpus, monkeypatch):
    """When a puller cannot reach the holder, the head pulls the spooled
    object through itself once and serves it from its own store
    (reference: PullManager relay fallback)."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    monkeypatch.setattr(GLOBAL_CONFIG, "transfer_chunk_bytes", 64 * 1024)
    monkeypatch.setenv("RTT_TRANSFER_CHUNK_BYTES", str(64 * 1024))
    proxy, agent, node_id = _start_agent(num_cpus=1)
    try:
        pin = NodeAffinitySchedulingStrategy(node_id)

        @rt.remote(scheduling_strategy=pin)
        def produce():
            return np.arange(200_000, dtype=np.float64)  # 1.6MB

        ref = produce.remote()
        head = rt._head
        deadline = time.time() + 60
        while time.time() < deadline:
            meta = head.objects.get(str(ref.id))
            if meta is not None and meta.state == "ready":
                break
            time.sleep(0.2)
        assert head.objects[str(ref.id)].loc == "remote"

        # the head-relay path: resolve locally → pull-through from the
        # holder's data plane → object becomes head-local shm
        got = head._resolve_object_bytes(str(ref.id))
        assert got is not None and got[0] == "shm"
        assert head.objects[str(ref.id)].loc == "shm"
        np.testing.assert_array_equal(
            rt.get(ref, timeout=60), np.arange(200_000, dtype=np.float64))
    finally:
        _stop_agent(agent, proxy)
