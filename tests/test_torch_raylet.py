"""The port's per-node local schedulers (raylets, DESIGN.md §4i), held
to the reference's ``tests/test_raylet.py``: bulk lease grants, local
dispatch with lease handoff, owner-local release netting, mixed-version
fallback, and worker-death recovery through the lease channel.
(test_torch_multihost.py exercises the same agents for transfers /
actors / affinity — those ride the raylet path by default.)  Agents run
from the repository root found from this file; functions here are
pickled by value, so the agents' workers never import this module.
"""

import logging
import os
import signal
import subprocess
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.util import state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

AGENT_WRAPPER = r"""
import sys
import ray_tpu_torch._private.wire as w
cap = int(sys.argv[1])
if cap:
    # simulate an OLD build: wire ceiling below PROTO_RAYLET
    w.PROTO_MAX = cap
from ray_tpu_torch._private.node_agent import main
sys.exit(main(sys.argv[2:]))
"""


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


def _start_agent(num_cpus=2, proto_cap=0, extra_env=None):
    """Proxy + node agent against the in-process head; returns
    (proxy, agent_proc, node_id)."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.client import ClientProxyServer

    session = worker_mod.global_worker().session
    proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
    port = proxy._listener.address[1]
    env = dict(os.environ)
    env["RTT_AUTH_KEY"] = session.auth_key().hex()
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("RTT_SESSION_DIR", None)
    env["RTT_NUM_GPUS"] = "0"   # a card-less host: nothing to detect
    env.update(extra_env or {})
    agent = subprocess.Popen(
        [sys.executable, "-c", AGENT_WRAPPER, str(proto_cap),
         "--address", f"127.0.0.1:{port}", "--num-cpus", str(num_cpus)],
        env=env, cwd=REPO)
    deadline = time.time() + 60
    node_id = None
    while time.time() < deadline and node_id is None:
        for n in state.list_nodes():
            if n["labels"].get("agent") == "1" and n["alive"]:
                node_id = n["node_id"]
        time.sleep(0.2)
    assert node_id, "agent node never registered"
    return proxy, agent, node_id


def _stop_agent(agent, proxy):
    agent.terminate()
    agent.wait(timeout=30)
    proxy.stop()


def _wait_raylet_attached(timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rows = [r for r in state.list_raylets() if r["attached"]]
        if rows:
            return rows[0]
        time.sleep(0.2)
    raise AssertionError("raylet never attached")


def test_lease_grant_handoff_and_netting():
    """The core lease protocol: with a zero-CPU head, DEFAULT-strategy
    tasks are granted to the raylet in bulk, queued leases start by
    handoff (no head round-trip), worker releases net through the
    raylet, and status/debug surface the per-node scheduler state."""
    rt.init(num_cpus=0, num_gpus=0)
    proxy = agent = None
    try:
        proxy, agent, node_id = _start_agent(num_cpus=2)
        row = _wait_raylet_attached()
        assert row["node_id"] == node_id

        @rt.remote
        def work(i):
            time.sleep(0.005)
            # an owner-local put+drop: its release rides the raylet's
            # netting buffer, not a per-oneway head message
            r = rt.put(i)
            del r
            return i, os.environ.get("RTT_RAYLET_SOCK") is not None

        n = 60
        out = rt.get([work.remote(i) for i in range(n)], timeout=120)
        assert [o[0] for o in out] == list(range(n))
        assert all(o[1] for o in out), "tasks did not run on the raylet"

        deadline = time.time() + 15
        row = None
        while time.time() < deadline:
            row = state.list_raylets()[0]
            s = row["stats"]
            if s.get("done", 0) >= n and s.get("ref_ops_forwarded", 0) > 0:
                break
            time.sleep(0.3)
        s = row["stats"]
        assert s["granted"] >= n, row
        assert s["done"] >= n, row
        # with 2 workers and a 16-deep backlog the chain MUST hand off
        assert s["handoffs"] > 0, row
        assert s["ref_ops_netted"] > 0 and s["ref_ops_forwarded"] > 0, row

        # status + debug dump surface the scheduler state (satellite)
        summ = state.cluster_summary()
        assert summ["raylets"] and summ["raylets"][0]["attached"]
        dump = state._rpc("debug_dump", tail=5)
        assert dump["raylets"], dump
        # ...and the raylet's own flight-recorder ring (same-host
        # agents drop it in the head session's tmpfs dir)
        assert any(n.startswith("raylet_") for n in dump["procs"]), \
            sorted(dump["procs"])
    finally:
        if agent is not None:
            _stop_agent(agent, proxy)
        rt.shutdown()


def test_raylet_worker_kill_recovers_via_lease_channel():
    """SIGKILL a raylet-local worker mid-task: the raylet reports the
    death + failed lease upstream, the task retries, the pool respawns."""
    rt.init(num_cpus=0, num_gpus=0)
    proxy = agent = None
    try:
        proxy, agent, node_id = _start_agent(num_cpus=1)
        _wait_raylet_attached()

        @rt.remote(max_retries=-1)
        def slow(i):
            time.sleep(0.4)
            return i * 7

        refs = [slow.remote(i) for i in range(6)]
        time.sleep(0.8)  # let a lease start executing
        victims = [w for w in state.list_workers()
                   if w["node_id"] == node_id and w["pid"]
                   and w["state"] not in ("dead", "driver")]
        assert victims, state.list_workers()
        os.kill(victims[0]["pid"], signal.SIGKILL)
        assert rt.get(refs, timeout=120) == [i * 7 for i in range(6)]
        # the dead worker was reported through the lease channel and
        # reaped head-side (generous deadline: on a contended host the
        # raylet's death report can lag well behind the task retries)
        deadline = time.time() + 90
        while time.time() < deadline:
            dead = [w for w in state.list_workers()
                    if w["pid"] == victims[0]["pid"]
                    and w["state"] == "dead"]
            if dead:
                break
            time.sleep(0.3)
        assert dead, "killed raylet worker never marked dead at the GCS"
    finally:
        if agent is not None:
            _stop_agent(agent, proxy)
        rt.shutdown()


@pytest.mark.parametrize("direction", ["old_head", "old_agent"])
def test_mixed_version_falls_back_to_legacy(direction, monkeypatch):
    """Version fencing (acceptance): new agent ↔ old head negotiates
    below PROTO_RAYLET and falls back to the legacy direct-GCS pool;
    old agent ↔ new head never sends raylet_attach.  Both run the basic
    suite green with ZERO raylet frames on the wire (no attached raylet,
    tasks still dispatch through the worker-push path)."""
    from ray_tpu_torch._private import wire
    if direction == "old_head":
        # the in-process head (and its __proto_hello__ negotiation)
        # caps at v3 — the agent sees ver < PROTO_RAYLET.  Both the
        # module constant AND negotiate_version's bound default must
        # drop (a real old build has them consistent).
        cap = wire.PROTO_RAYLET - 1
        monkeypatch.setattr(wire, "PROTO_MAX", cap)
        monkeypatch.setattr(wire.negotiate_version, "__defaults__",
                            (cap,))
    rt.init(num_cpus=1, num_gpus=0)
    proxy = agent = None
    try:
        proxy, agent, node_id = _start_agent(
            num_cpus=1,
            proto_cap=(wire.PROTO_RAYLET - 1
                       if direction == "old_agent" else 0))
        assert state.list_raylets() == [], \
            "raylet attached across a version fence"

        from ray_tpu_torch.util.scheduling_strategies import \
            NodeAffinitySchedulingStrategy
        pin = NodeAffinitySchedulingStrategy(node_id)

        @rt.remote(scheduling_strategy=pin)
        def where(i):
            return i, os.environ.get("RTT_RAYLET_SOCK") is None

        out = rt.get([where.remote(i) for i in range(8)], timeout=90)
        assert [o[0] for o in out] == list(range(8))
        assert all(o[1] for o in out), \
            "legacy-mode workers saw a raylet socket"
        assert state.list_raylets() == []
    finally:
        if agent is not None:
            _stop_agent(agent, proxy)
        rt.shutdown()


def test_clean_shutdown_returns_leases():
    """Agent stop() mid-backlog: unstarted leases are RETURNED (not
    death-reclaimed) and re-dispatch elsewhere once capacity exists —
    the keepalive-dedup satellite's shutdown half."""
    rt.init(num_cpus=0, num_gpus=0)
    proxy = agent = None
    try:
        proxy, agent, node_id = _start_agent(num_cpus=1)
        _wait_raylet_attached()

        @rt.remote(max_retries=-1)
        def work(i):
            time.sleep(0.15)
            return i

        refs = [work.remote(i) for i in range(12)]
        time.sleep(1.0)  # leases granted, backlog queued at the raylet
        # clean SIGTERM → agent.stop() → raylet returns queued leases +
        # detaches; the node disappears without death detection
        _stop_agent(agent, proxy)
        agent = None
        # returned/reclaimed work re-queues; a fresh node absorbs it
        proxy, agent, node_id2 = _start_agent(num_cpus=1)
        assert node_id2 != node_id
        assert rt.get(refs, timeout=180) == list(range(12))
    finally:
        if agent is not None:
            _stop_agent(agent, proxy)
        rt.shutdown()
