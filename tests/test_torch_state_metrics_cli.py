"""The port's state API, metrics, timeline, microbenchmark and CLI
(SURVEY.md §2.3 state API, §5.1 tracing, §5.5 metrics, §4
microbenchmark): the reference's ``tests/test_state_metrics_cli.py``
case by case, the CLI through ``python -m ray_tpu_torch``.

Every head, in process or started by the CLI, runs with
``RTT_SESSION_DIR_ROOT`` in a short directory of the test's own, and
CLI subprocesses run from the repository root found from this file.
``start`` is also held to its own head when another session takes the
root's ``session_latest`` link while it waits (queue C, C24).
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import metrics as metrics_lib
from ray_tpu_torch.util import state
from rtt_fixtures import REPO, restore_logger, session_root

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")


@pytest.fixture(scope="module", autouse=True)
def _logger():
    with restore_logger():
        yield


@pytest.fixture
def own_root(monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    with session_root(monkeypatch) as d:
        yield d


@pytest.fixture
def ray_start_regular(own_root):
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------- state API

def test_list_and_summaries(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    ray_tpu_torch.get(a.ping.remote())
    ref = ray_tpu_torch.put(np.arange(100))

    nodes = state.list_nodes()
    assert len(nodes) == 1 and nodes[0]["alive"]
    actors = state.list_actors(state="ALIVE")
    assert len(actors) == 1 and actors[0]["class_name"] == "A"
    objs = state.list_objects()
    assert any(o["object_id"] == str(ref.id) for o in objs)
    workers = state.list_workers()
    assert len(workers) >= 1

    summ = state.cluster_summary()
    assert summ["nodes"] == 1
    assert summ["objects"]["count"] >= 1
    assert "CPU" in summ["resources_total"]

    mem = state.object_memory()
    assert sum(g["count"] for g in mem) >= 1


def test_object_memory_groups(ray_start_regular):
    small = ray_tpu_torch.put(b"x" * 1000)          # slab
    big = ray_tpu_torch.put(np.zeros(500_000))      # shm file plane (4MB)
    rows = state.object_memory(group_by="loc")
    locs = {r["loc"] for r in rows}
    assert "shm" in locs
    assert ("slab" in locs) or ("inline" in locs)
    del small, big


# ------------------------------------------------------------------ metrics

def test_metrics_counter_gauge_histogram():
    metrics_lib._reset_for_tests()
    c = metrics_lib.Counter("req_total", "requests", ("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2.0, tags={"route": "/a"})
    c.inc(tags={"route": "/b"})
    g = metrics_lib.Gauge("queue_len")
    g.set(7)
    h = metrics_lib.Histogram("latency_s", boundaries=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)

    snap = metrics_lib.registry_snapshot()
    assert snap["req_total"]["kind"] == "counter"
    series = {tuple(sorted(s["tags"].items())): s["value"]
              for s in snap["req_total"]["series"]}
    assert series[(("route", "/a"),)] == 3.0
    assert snap["latency_s"]["series"][0]["value"]["count"] == 3

    text = metrics_lib.prometheus_text()
    assert 'req_total{route="/a"} 3.0' in text
    assert "# TYPE latency_s histogram" in text
    assert 'latency_s_bucket{le="+Inf"} 3' in text
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        metrics_lib.Gauge("req_total")  # kind clash


def test_metrics_cluster_publish(ray_start_regular):
    metrics_lib._reset_for_tests()
    metrics_lib.Gauge("driver_gauge").set(1.0)
    metrics_lib.publish()

    @ray_tpu_torch.remote
    def worker_side():
        from ray_tpu_torch.util import metrics as m
        m._reset_for_tests()
        m.Counter("worker_counter").inc(5)
        m.publish()
        return True

    assert ray_tpu_torch.get(worker_side.remote())
    merged = metrics_lib.collect_cluster()
    assert "driver_gauge" in merged and "worker_counter" in merged


# ------------------------------------------------------------- TSDB history

def test_metrics_history_and_top_cli(own_root, capsys):
    """`ray_tpu_torch top` renders LIVE data from a real cluster: worker
    publishers feed the head TSDB, state.metrics_history() answers
    windowed queries over it, and one `top --once` frame shows the
    task-rate row computed from that history."""
    from conftest import time_scale

    ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                       _system_config={"metrics_export_period_s": 1.0})
    try:
        @ray_tpu_torch.remote
        def tick(x):
            return x + 1

        # spread the work over several publish cycles so the counter
        # history actually grows inside the TSDB window
        rate_rows = []
        deadline = time.monotonic() + 45 * time_scale()
        while time.monotonic() < deadline:
            ray_tpu_torch.get([tick.remote(i) for i in range(4)])
            rate_rows = state.metrics_history(
                'sum(rate(rtt_tasks_total[60s]))')
            if rate_rows and rate_rows[0]["value"] > 0:
                break
            time.sleep(1.0)
        assert rate_rows and rate_rows[0]["value"] > 0, rate_rows

        # range form: the sparkline feed has timestamped points (steps
        # that predate the history are simply absent, not zero-filled)
        end = time.time()
        rng = state.metrics_history('sum(rate(rtt_tasks_total[60s]))',
                                    start=end - 60, end=end, step=5)
        assert rng and rng[0]["points"]
        assert all(len(p) == 2 and end - 65 <= p[0] <= end + 5
                   for p in rng[0]["points"])

        # series listing carries the worker tag injected at ingest
        series = state.metrics_series("rtt_tasks_total")
        assert series and all(s["tags"].get("worker") for s in series)

        from ray_tpu_torch.scripts import cli
        rc = cli.main(["top", "--once"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "ray_tpu_torch top" in out and "tsdb" in out
        tasks_line = next(ln for ln in out.splitlines()
                          if ln.startswith("tasks"))
        assert float(tasks_line.split("/s")[0].split()[-1]) > 0
    finally:
        ray_tpu_torch.shutdown()
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        with GLOBAL_CONFIG._lock:
            GLOBAL_CONFIG._overrides.pop("metrics_export_period_s", None)


def test_dashboard_history_endpoint(ray_start_regular):
    """/metrics/history serves TSDB range queries as JSON (the UI's
    sparkline feed); bad input answers 400, not 500."""
    import urllib.error
    import urllib.parse
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    srv = start_dashboard(port=0)
    try:
        port = srv.server_address[1]
        expr = urllib.parse.quote("sum(rate(rtt_tasks_total[60s]))")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics/history?series={expr}"
                f"&window=120&step=15", timeout=30) as r:
            doc = json.loads(r.read())
        assert doc["expr"] == "sum(rate(rtt_tasks_total[60s]))"
        assert doc["window_s"] == 120.0 and "results" in doc
        for bad in ("/metrics/history",
                    "/metrics/history?series=rate(broken",
                    "/metrics/history?series=x&window=nan2",
                    "/metrics/history?series=x&step=0"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{bad}", timeout=30)
            assert ei.value.code == 400
    finally:
        stop_dashboard()


# ----------------------------------------------------------------- timeline

def test_timeline_chrome_trace(ray_start_regular, tmp_path):
    @ray_tpu_torch.remote
    def work():
        time.sleep(0.01)
        return 1

    ray_tpu_torch.get([work.remote() for _ in range(3)])
    out = tmp_path / "trace.json"
    deadline = time.time() + 10
    while True:
        # profile events are shipped asynchronously from workers; poll
        events = ray_tpu_torch.timeline(filename=str(out))
        if len(events) >= 3 or time.time() > deadline:
            break
        time.sleep(0.2)
    assert len(events) >= 3
    trace = json.loads(out.read_text())
    # chrome://tracing format: list of events with ph/ts/pid/name
    assert isinstance(trace, list) and trace
    assert {"name", "ph", "ts", "pid"} <= set(trace[0])


# ---------------------------------------------------------------------- CLI

def _cli(*argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "RTT_NUM_GPUS": "0"})


def _head_pids(root):
    """Head pids recorded in the session descriptors under ``root``."""
    pids = set()
    for p in Path(root).glob("session_*/session.json"):
        try:
            pid = json.loads(p.read_text()).get("head_pid")
        except (OSError, ValueError):
            continue
        if pid:
            pids.add(pid)
    return pids


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0] != "Z"


def _wait_gone(pid, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and _alive(pid):
        time.sleep(0.1)
    return not _alive(pid)


def _stop_all(root):
    for pid in _head_pids(root):
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            continue
        _wait_gone(pid)


def _started_pid(stdout):
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("head started: pid="))
    return int(line.split("pid=")[1].split()[0])


def test_cli_version():
    r = _cli("version")
    assert r.returncode == 0
    assert r.stdout.strip() == ray_tpu_torch.__version__


def test_cli_microbenchmark_quick(own_root):
    r = _cli("microbenchmark", "--quick", timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "tasks: submit+get throughput" in r.stdout
    assert "put: 8KB objects" in r.stdout


def test_cli_start_status_stop(own_root):
    try:
        r = _cli("start")
        assert r.returncode == 0, r.stderr[-2000:]
        pid = _started_pid(r.stdout)
        r2 = _cli("status", "--address", "auto")
        assert r2.returncode == 0, r2.stderr[-2000:]
        summary = json.loads(r2.stdout[r2.stdout.index("{"):])
        assert summary["nodes"] >= 1
        assert "fleet: nodes running=1" in r2.stdout
        r3 = _cli("stop")
        assert r3.returncode == 0, r3.stderr[-2000:]
        assert f"pid={pid}" in r3.stdout
        assert _wait_gone(pid), "head outlived stop"
    finally:
        _stop_all(own_root)


# ``start`` with another head taking the root's session_latest link after
# this start's head recorded itself and before the command reads it back
RACED_START = r"""
import json, os, subprocess, sys, time
from pathlib import Path

root = Path(os.environ["RTT_SESSION_DIR_ROOT"])
real_fork = os.fork


def fork():
    os.fork = real_fork
    pid = real_fork()
    if pid:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                json.loads(p.read_text() or "{}").get("head_pid") == pid
                for p in root.glob("session_*/session.json")):
            time.sleep(0.05)
        other = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "start",
             "--num-cpus", "1"], capture_output=True, text=True,
            timeout=120)
        sys.stderr.write("OTHER " + other.stdout)
    return pid


os.fork = fork
from ray_tpu_torch.scripts import cli
sys.exit(cli.main(["start", "--num-cpus", "1"]))
"""


def test_cli_start_waits_for_its_own_head(own_root):
    """Two ``start``s in one root each exit 0 naming their own head,
    though the second one's session took ``session_latest`` while the
    first waited; ``stop`` and ``status --address auto`` keep meaning
    the latest session, and both heads stop."""
    try:
        r = subprocess.run(
            [sys.executable, "-c", RACED_START], capture_output=True,
            text=True, timeout=240, cwd=REPO,
            env={**os.environ, "RTT_NUM_GPUS": "0"})
        assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
        first = _started_pid(r.stdout)
        other = _started_pid(r.stderr.split("OTHER ", 1)[1])
        assert first != other
        assert _head_pids(own_root) == {first, other}
        latest = json.loads(
            (Path(own_root) / "session_latest" / "session.json").read_text())
        assert latest["head_pid"] == other and latest["role"] == "head"
        assert _alive(first) and _alive(other)
        r2 = _cli("status", "--address", "auto")
        assert r2.returncode == 0, r2.stderr[-2000:]
        r3 = _cli("stop")
        assert r3.returncode == 0 and f"pid={other}" in r3.stdout, r3.stdout
        assert _wait_gone(other), "latest head outlived stop"
        assert _alive(first)
        os.kill(first, signal.SIGTERM)
        assert _wait_gone(first), "first head outlived SIGTERM"
    finally:
        _stop_all(own_root)


# a driver whose in-process init() made the root's latest session
DRIVER = r"""
import sys, time
import ray_tpu_torch
ray_tpu_torch.init(num_cpus=1, num_gpus=0)
print("READY", flush=True)
time.sleep(120)
"""


def test_cli_stop_spares_a_driver_session(own_root):
    """C27: ``stop`` in a root whose latest session is a driver's own
    (``init()`` in that process, no ``start`` head) names no head, exits
    non-zero, and leaves the driver alive."""
    drv = subprocess.Popen(
        [sys.executable, "-c", DRIVER], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=REPO,
        env={**os.environ, "RTT_NUM_GPUS": "0"})
    try:
        assert drv.stdout.readline().strip() == "READY"
        desc = json.loads(
            (Path(own_root) / "session_latest" / "session.json").read_text())
        assert desc["pid"] == drv.pid and "head_pid" not in desc
        r = _cli("stop")
        assert r.returncode != 0, r.stdout
        assert "no CLI head" in r.stdout
        time.sleep(1.0)
        assert drv.poll() is None and _alive(drv.pid), \
            "stop ended the driver"
    finally:
        drv.kill()
        drv.wait(timeout=30)


def test_stack_dump(ray_start_regular):
    """`ray_tpu_torch stack` analog: all-worker thread dumps (SURVEY.md
    §5.1)."""
    import time as _t

    from ray_tpu_torch._private import worker as _wm

    @ray_tpu_torch.remote
    def sleepy():
        _t.sleep(8)
        return 1

    ref = sleepy.remote()
    # poll until the task is actually ON a worker stack: under host
    # contention dispatch can take seconds, and a dump taken before the
    # task starts legitimately contains no 'sleepy' frame
    deadline = _t.monotonic() + 60
    joined = ""
    expected = 0
    while _t.monotonic() < deadline:
        resp = _wm.global_worker().rpc("stack")
        # expected==0 just means the worker pool hasn't spawned yet on a
        # loaded host — keep polling, don't assert mid-spawn
        expected = max(expected, resp["expected"])
        joined = "\n".join(resp["stacks"].values())
        if "sleepy" in joined or "sleep" in joined:
            break
        _t.sleep(0.3)
    assert expected >= 1
    assert "sleepy" in joined or "sleep" in joined
    ray_tpu_torch.cancel(ref)


def test_debug_stacks_cli(ray_start_regular, tmp_path, capsys):
    """`ray_tpu_torch debug stacks`: the same GCS stack fan-out as
    `ray_tpu_torch stack`, plus a machine-readable -o JSON form."""
    import time as _t

    from ray_tpu_torch._private import worker as _wm
    from ray_tpu_torch.scripts import cli

    @ray_tpu_torch.remote
    def sleepy_cli():
        _t.sleep(8)
        return 1

    ref = sleepy_cli.remote()
    # same poll-until-on-stack discipline as test_stack_dump above
    deadline = _t.monotonic() + 60
    while _t.monotonic() < deadline:
        resp = _wm.global_worker().rpc("stack")
        if resp["expected"] >= 1 and "sleepy_cli" in \
                "\n".join(resp["stacks"].values()):
            break
        _t.sleep(0.3)
    try:
        rc = cli.main(["debug", "stacks"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "===== worker " in out and "sleepy_cli" in out

        path = tmp_path / "stacks.json"
        rc = cli.main(["debug", "stacks", "-o", str(path)])
        capsys.readouterr()
        assert rc == 0
        doc = json.loads(path.read_text())
        assert doc["expected"] >= 1
        assert any("sleepy_cli" in text
                   for text in doc["stacks"].values())
    finally:
        ray_tpu_torch.cancel(ref)


def test_native_store_metrics_exported(ray_start_regular):
    """SURVEY.md §2.1 Stats row: the C++ slab store's own counters
    (shared-header hits/misses/allocs/fails) surface as cluster gauges."""
    import numpy as np

    from ray_tpu_torch.util import metrics

    refs = [ray_tpu_torch.put(np.zeros(20000)) for _ in range(3)]
    _ = ray_tpu_torch.get(refs)
    m = metrics.collect_cluster()
    native = {k: v["series"][0]["value"] for k, v in m.items()
              if k.startswith("rtt_native_store_")}
    assert native.get("rtt_native_store_allocs", 0) >= 3
    assert native.get("rtt_native_store_heap_size", 0) > 0
    # and they render as prometheus text
    text = metrics.prometheus_text(m)
    assert "rtt_native_store_allocs" in text


def test_device_memory_gauges(monkeypatch):
    """SURVEY.md §5.5: per-card memory gauges from the CUDA caching
    allocator, read only from a process whose torch already initialised
    CUDA (collecting metrics never imports torch or makes a context)."""
    import types

    class FakeCuda:
        initialised = True

        def is_initialized(self):
            return self.initialised

        def device_count(self):
            return 1

        def get_device_properties(self, i):
            return types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                                         total_memory=1000)

        def memory_allocated(self, i):
            return 123

        def max_memory_allocated(self, i):
            return 456

    cuda = FakeCuda()
    monkeypatch.setitem(sys.modules, "torch",
                        types.SimpleNamespace(cuda=cuda))
    out = metrics_lib.device_memory_gauges()
    s = out["rtt_device_hbm_bytes_in_use"]["series"][0]
    assert s["value"] == 123.0 and s["tags"]["device"] == "0"
    assert s["tags"]["kind"] == "NVIDIA H100 80GB HBM3"
    assert out["rtt_device_hbm_peak_bytes"]["series"][0]["value"] == 456.0
    assert out["rtt_device_hbm_bytes_limit"]["series"][0]["value"] == 1000.0

    # no CUDA context in this process: no gauges, and none is made
    cuda.initialised = False
    assert metrics_lib.device_memory_gauges() == {}
    # no torch imported at all: nothing is imported to find out
    monkeypatch.delitem(sys.modules, "torch")
    assert metrics_lib.device_memory_gauges() == {}
    assert "torch" not in sys.modules
