"""The port's durable workflows (``ray_tpu_torch.workflow``) and
dashboard (``ray_tpu_torch.dashboard``) on its own runtime, held to the
reference's ``tests/test_workflow_dashboard_client.py`` (its 3 workflow
and 2 dashboard tests, every assertion kept; its client-proxy test is
mirrored in ``tests/test_torch_node_agent.py``).

Tests share one cluster at ``num_cpus=4`` (``cluster``); the fixture kills
the actors a test leaves.  Functions here are pickled by value, so
spawned workers never import this module (nor JAX through it).  Every
dashboard binds port 0, so the suite's parallel workers never collide.
"""

import json
import logging
import os
import sys
import urllib.request

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import workflow
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import worker as t_worker

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Stops the module's cluster and hands later modules the package
    logger as it was (``init`` stops its propagation)."""
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
def cluster(_shared, monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if not rt.is_initialized():
        rt.init(num_cpus=4, num_gpus=0)
    yield
    w = t_worker.global_worker()
    for a in w.rpc("list_actors")["actors"]:
        if a["state"] != "DEAD":
            rt.kill(rt.ActorHandle(a["actor_id"], {}))


# ---------------------------------------------------------------- workflows

def test_workflow_dag_runs(cluster, tmp_path):
    @workflow.step
    def double(x):
        return 2 * x

    @workflow.step
    def add(a, b):
        return a + b

    node = add.bind(double.bind(3), double.bind(4))
    out = workflow.run(node, workflow_id="wf1", storage=str(tmp_path))
    assert out == 14
    st = workflow.get_status("wf1", storage=str(tmp_path))
    assert st["status"] == "SUCCEEDED"
    assert set(st["steps"]) == {"double_0", "double_1", "add_0"}
    assert workflow.list_all(storage=str(tmp_path)) == [("wf1", "SUCCEEDED")]


def test_workflow_resume_skips_completed(cluster, tmp_path):
    marker = tmp_path / "exec_count"
    marker.write_text("0")

    @workflow.step
    def flaky(x):
        n = int(marker.read_text()) + 1
        marker.write_text(str(n))
        if x == "boom" and n < 3:
            raise RuntimeError("transient")
        return f"ok-{x}"

    @workflow.step
    def precious():
        # executed exactly once across run+resume (checkpointed)
        cnt = tmp_path / "precious_count"
        c = int(cnt.read_text()) + 1 if cnt.exists() else 1
        cnt.write_text(str(c))
        return c

    @workflow.step
    def combine(a, b):
        return (a, b)

    node = combine.bind(precious.bind(),
                        flaky.options(max_retries=0).bind("boom"))
    with pytest.raises(Exception):
        workflow.run(node, workflow_id="wf2", storage=str(tmp_path))
    assert workflow.get_status("wf2", storage=str(tmp_path))["status"] == "FAILED"

    # resume: precious loads from its checkpoint; flaky retried until ok
    marker.write_text("2")
    out = workflow.resume("wf2", node, storage=str(tmp_path))
    assert out == (1, "ok-boom")
    assert (tmp_path / "precious_count").read_text() == "1"
    assert workflow.get_status("wf2", storage=str(tmp_path))["status"] == \
        "SUCCEEDED"


def test_workflow_rerun_returns_cached(cluster, tmp_path):
    calls = tmp_path / "calls"
    calls.write_text("0")

    @workflow.step
    def once():
        calls.write_text(str(int(calls.read_text()) + 1))
        return 99

    node = once.bind()
    assert workflow.run(node, workflow_id="wf3", storage=str(tmp_path)) == 99
    assert workflow.run(node, workflow_id="wf3", storage=str(tmp_path)) == 99
    assert calls.read_text() == "1"


# ---------------------------------------------------------------- dashboard

def test_dashboard_endpoints(cluster):
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    @rt.remote
    class Probe:
        def ping(self):
            return 1

    p = Probe.remote()
    rt.get(p.ping.remote())

    srv = start_dashboard(port=0)  # ephemeral port
    port = srv.server_address[1]
    try:
        def fetch(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.read()

        summary = json.loads(fetch("/api/cluster_summary"))
        assert summary["nodes"] == 1
        actors = json.loads(fetch("/api/actors"))
        assert any(a["class_name"] == "Probe" for a in actors)
        assert b"ray_tpu" in fetch("/")
        assert b"# TYPE" in fetch("/metrics") or fetch("/metrics") == b"\n"
        assert json.loads(fetch("/api/nodes"))[0]["alive"]
    finally:
        stop_dashboard()


def test_dashboard_serves_logs(cluster):
    """SURVEY.md §5.5: the dashboard serves session logs; traversal
    outside the logs dir must 404."""
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    srv = start_dashboard(port=0)
    port = srv.server_address[1]
    try:
        # deterministic content (worker logs flush lazily): write a
        # probe file straight into the session logs dir
        from ray_tpu_torch._private import worker as wm
        logd = wm.global_worker().session.path / "logs"
        (logd / "probe.log").write_text("line1\nline2\nline3\n")
        import json as j
        logs = j.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/logs", timeout=10).read())
        assert any(e["name"] == "probe.log" and e["bytes"] > 0
                   for e in logs), logs
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/logs/probe.log?tail=2",
            timeout=10).read().decode()
        assert text == "line2\nline3\n", repr(text)
        # malformed tail is a client error, not a 500
        import urllib.error
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/logs/probe.log?tail=abc",
                timeout=10)
            raise AssertionError("bad tail accepted")
        except urllib.error.HTTPError as e:
            assert e.code == 400
        # path traversal must not escape the logs dir: send a LITERAL
        # ../ path over a raw socket (urllib would normalize the dot
        # segments away and never exercise the guard)
        import socket
        raw = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            raw.sendall(b"GET /api/logs/../descriptor.json HTTP/1.1\r\n"
                        b"Host: x\r\nConnection: close\r\n\r\n")
            resp = b""
            while True:
                chunk = raw.recv(4096)
                if not chunk:
                    break
                resp += chunk
        finally:
            raw.close()
        status = resp.split(b"\r\n", 1)[0]
        assert b"404" in status, status
        assert b"descriptor" not in resp.split(b"\r\n\r\n", 1)[-1]
    finally:
        stop_dashboard()
