"""The port's GCS fault tolerance, held to the reference's
``tests/test_gcs_fault_tolerance.py`` (itself after Ray's
``test_gcs_fault_tolerance.py`` — GCS restarts with Redis persistence,
raylets/workers reconnect).

Here: the head process snapshots durable tables (KV, functions, actors,
PGs) to ``<session>/gcs_state``; on ``kill -9`` of the head, worker
processes outlive it (actors keep serving direct calls), a new head
started over the same session dir restores the snapshot, and workers +
drivers reconnect/reattach.  Heads and agents run from the repository
root found from this file, with it on their ``PYTHONPATH``; functions
and classes here are pickled by value, so workers never import this
module.
"""

import logging
import os
import signal
import subprocess
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

_HEAD_SCRIPT = r"""
import signal, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch._private import worker as wm

session_dir = sys.argv[1] if sys.argv[1] != "-" else None
rt.init(num_cpus=2, num_gpus=0, _session_dir=session_dir)
print("SESSION:" + str(wm.global_worker().session.path), flush=True)
signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
while True:
    time.sleep(3600)
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


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("RTT_SESSION_DIR", None)
    env["RTT_NUM_GPUS"] = "0"   # a card-less host: nothing to detect
    return env


def _spawn_head(session_dir: str = "-") -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-c", _HEAD_SCRIPT, session_dir],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=REPO, env=_env())
    line = proc.stdout.readline()
    assert line.startswith("SESSION:"), f"head failed to start: {line!r}"
    return proc, line[len("SESSION:"):].strip()


def test_head_restart_while_raylet_holds_leases():
    """GCS fault tolerance × the raylet lease protocol (DESIGN.md §4i):
    kill -9 the head while a raylet holds a granted lease block.  The
    raylet must outlive it, rejoin the restarted head (re-add_node +
    raylet_attach + worker-roster re-announce) and re-report its ledger
    deltas (unsettled done entries, netted releases) on the new channel;
    in-flight work completes and fresh work lands on the re-joined node."""
    import subprocess as sp

    from ray_tpu_torch._private.session import Session
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.client import ClientProxyServer

    head1, session_dir = _spawn_head()
    proxy = agent = head2 = None
    try:
        rt.init(address=session_dir)
        root, name = os.path.split(session_dir)
        session = Session(root=root, name=name)
        # the proxy lives in THIS process: it survives the head kill and
        # relays the raylet's re-dials to the restarted head's socket
        proxy = ClientProxyServer(session, host="127.0.0.1", port=0)
        port = proxy._listener.address[1]
        env = _env()
        env["RTT_AUTH_KEY"] = session.auth_key().hex()
        agent = sp.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node_agent",
             "--address", f"127.0.0.1:{port}", "--num-cpus", "2"],
            env=env, cwd=REPO)

        def raylet_row(require_attached=True, timeout=60):
            deadline = time.time() + timeout
            while time.time() < deadline:
                try:
                    rows = [r for r in state.list_raylets()
                            if r["attached"] or not require_attached]
                except rt.exceptions.RayTpuError:
                    rows = []
                if rows:
                    return rows[0]
                time.sleep(0.3)
            raise AssertionError("raylet never attached")

        row1 = raylet_row()
        node1 = row1["node_id"]

        # retry_exceptions: a task whose put() RPC races the head's
        # downtime window surfaces a ConnectionError as an app error —
        # that attempt must retry, not seal
        @rt.remote(max_retries=-1, retry_exceptions=True)
        def work(i):
            time.sleep(0.4)
            # a put+drop leaves netted releases in the raylet's buffer
            # for the post-restart ledger-delta re-report
            r = rt.put(i)
            del r
            return i * 5

        refs = [work.remote(i) for i in range(10)]
        deadline = time.time() + 60
        while time.time() < deadline:
            if raylet_row()["held_leases"] > 0:
                break
            time.sleep(0.1)
        assert raylet_row()["held_leases"] > 0

        os.kill(head1.pid, signal.SIGKILL)
        head1.wait(timeout=10)
        time.sleep(0.5)
        head2, _ = _spawn_head(session_dir)

        # the raylet rejoins under a FRESH node id and re-reports
        row2 = raylet_row(timeout=90)
        assert row2["node_id"] != node1, "raylet did not re-join"

        # in-flight work completes across the restart (owner-based
        # resubmission + the raylet's done re-flush tolerate each other)
        assert rt.get(refs, timeout=240) == [i * 5 for i in range(10)]

        # the surviving workers were adopted onto the new node (roster
        # re-announce), and fresh pinned work runs there
        from ray_tpu_torch.util.scheduling_strategies import \
            NodeAffinitySchedulingStrategy
        pin = NodeAffinitySchedulingStrategy(row2["node_id"])

        @rt.remote(scheduling_strategy=pin, max_retries=-1)
        def where():
            return os.environ.get("RTT_RAYLET_SOCK") is not None

        assert rt.get(where.remote(), timeout=120)
        # and the re-attached raylet keeps reconciling (heartbeat stats
        # flow on the new channel)
        deadline = time.time() + 30
        ok = False
        while time.time() < deadline and not ok:
            s = raylet_row()["stats"]
            ok = s.get("done", 0) > 0
            time.sleep(0.3)
        assert ok, "re-attached raylet never settled a lease"
    finally:
        if agent is not None:
            agent.terminate()
            try:
                agent.wait(timeout=30)
            except sp.TimeoutExpired:
                agent.kill()
        if proxy is not None:
            proxy.stop()
        for hp in (head1, head2):
            if hp is not None and hp.poll() is None:
                hp.kill()
                hp.wait(timeout=10)
        rt.shutdown()


def test_gcs_restart_preserves_actors_pgs_and_objects():
    head1, session_dir = _spawn_head()
    try:
        rt.init(address=session_dir)

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

            def slow_add(self, k):
                time.sleep(6.0)
                self.n += k
                return self.n

        c = Counter.options(name="ft_counter", lifetime="detached").remote()
        assert rt.get(c.add.remote(5), timeout=60) == 5

        from ray_tpu_torch.util.placement_group import placement_group
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=30)

        from ray_tpu_torch.experimental import internal_kv
        internal_kv._internal_kv_put(b"ft_key", b"ft_value")

        big = np.arange(300_000, dtype=np.float64)  # 2.4MB → shm segment
        big_ref = rt.put(big)
        _ = rt.get(big_ref, timeout=30)

        # a call in flight across the crash: the actor's direct channel
        # is independent of the head, and the result must also land in
        # the restarted GCS (reattached task conn)
        slow_ref = c.slow_add.remote(3)
        pending = {}

        def pending_get():
            try:
                pending["value"] = rt.get(slow_ref, timeout=90)
            except Exception as e:  # noqa: BLE001
                pending["error"] = e

        t = threading.Thread(target=pending_get, daemon=True)
        t.start()
        time.sleep(0.5)

        os.kill(head1.pid, signal.SIGKILL)
        head1.wait(timeout=10)
        time.sleep(1.0)

        head2, _ = _spawn_head(session_dir)
        try:
            # named actor survives WITH STATE: the process outlived the
            # head and reattached (not a restart-from-scratch)
            h = rt.get_actor("ft_counter")
            deadline = time.time() + 60
            value = None
            while time.time() < deadline:
                try:
                    value = rt.get(h.add.remote(0), timeout=30)
                    break
                except rt.exceptions.RayTpuError:
                    time.sleep(0.5)
            assert value == 8, f"actor state lost across restart: {value}"

            # pending get completed with the slow call's result
            t.join(timeout=60)
            assert pending.get("value") == 8, pending

            # durable KV survived
            assert internal_kv._internal_kv_get(b"ft_key") == b"ft_value"

            # PG table restored (re-placed on the new head's node)
            from ray_tpu_torch.util import state
            pgs = state._rpc("pg_table")["pgs"]
            assert pg.id in pgs and pgs[pg.id]["state"] == "ready", pgs

            # pre-crash shm object still readable
            np.testing.assert_array_equal(
                rt.get(big_ref, timeout=30), big)

            # and the cluster still runs fresh work
            @rt.remote
            def f(x):
                return x * 2

            assert rt.get(f.remote(21), timeout=60) == 42

            # regression (r2 advisor): the reattach metadata must be
            # applied even though register_client already recreated the
            # WorkerState — the reattached ACTOR worker must be in state
            # "actor" (its main thread sits in serve_forever), never
            # "idle", or the scheduler would dispatch a plain task into
            # it that hangs forever
            workers = state._rpc("list_workers")["workers"]
            actor_workers = [w for w in workers if w["actor_id"]]
            assert actor_workers, workers
            assert all(w["state"] == "actor" for w in actor_workers), workers
        finally:
            # the detached actor's process outlives its head by design
            # and would wait for one forever: stop it with the head
            from ray_tpu_torch.util import state as st
            try:
                pids = [w["pid"] for w in st._rpc("list_workers")["workers"]
                        if w["actor_id"]]
            except Exception:  # noqa: BLE001 - the head is gone already
                pids = []
            head2.kill()
            head2.wait(timeout=10)
            for pid in pids:
                try:
                    os.kill(pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
    finally:
        if head1.poll() is None:
            head1.kill()
            head1.wait(timeout=10)
        rt.shutdown()
