"""The port's autoscaler (SURVEY.md §2.3) and runtime_env
(working_dir / py_modules / pip), on the port's runtime.

The reference's ``tests/test_autoscaler_runtime_env.py`` case by case,
with ``TPU`` → ``GPU``: a logical node that declares ``GPU`` is a node
with cards, whose GPU worker the head's warm pool forks (on the CPU the
card is only declared).  Every head runs with ``RTT_SESSION_DIR_ROOT``
in a short directory of the test's own (``rtt_fixtures``).
"""

import os
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import (
    AutoscalerConfig, FakeMultiNodeProvider, StandardAutoscaler,
    get_nodes_to_launch, infeasible_shapes,
)
from rtt_fixtures import restore_logger, session_root

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _logger():
    with restore_logger():
        yield


def _start(monkeypatch, num_cpus):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=num_cpus, num_gpus=0)


@pytest.fixture
def ray_start_2_cpus(monkeypatch):
    with session_root(monkeypatch):
        _start(monkeypatch, 2)
        yield
        rt.shutdown()


@pytest.fixture
def ray_start_regular(monkeypatch):
    with session_root(monkeypatch):
        _start(monkeypatch, 4)
        yield
        rt.shutdown()


# ----------------------------------------------------- demand bin-packing

def test_get_nodes_to_launch_packs_shapes():
    types = {
        "cpu4": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 5},
        "gpu8": {"resources": {"GPU": 8}, "min_workers": 0, "max_workers": 2},
    }
    # 6 single-CPU tasks fit on two cpu4 nodes; one GPU shape needs gpu8
    demand = [{"CPU": 1}] * 6 + [{"GPU": 8}]
    out = get_nodes_to_launch(types, {}, demand)
    assert out == {"cpu4": 2, "gpu8": 1}

    # consolidation: if the GPU node type also carries CPUs, small CPU
    # shapes ride its spare capacity instead of forcing extra nodes
    types["gpu8"]["resources"] = {"CPU": 8, "GPU": 8}
    assert get_nodes_to_launch(types, {}, demand) == {"gpu8": 1}


def test_get_nodes_to_launch_honors_min_max():
    types = {"n": {"resources": {"CPU": 2}, "min_workers": 2,
                   "max_workers": 3}}
    out = get_nodes_to_launch(types, {}, [{"CPU": 2}] * 10)
    assert out == {"n": 3}  # 2 for min + 1 more up to max
    assert get_nodes_to_launch(types, {"n": 3}, [{"CPU": 2}] * 10) == {}


def test_infeasible_shapes():
    types = {"n": {"resources": {"CPU": 4}}}
    assert infeasible_shapes(types, [{"CPU": 2}, {"GPU": 1}]) == [{"GPU": 1}]


# ------------------------------------------------------ end-to-end scaling

def test_autoscaler_scales_up_for_pending_tasks(ray_start_2_cpus):
    """Pending GPU-shaped tasks drive the provider to add a GPU node,
    whose warm GPU worker then runs them."""
    provider = FakeMultiNodeProvider()
    config = AutoscalerConfig(node_types={
        "gpu_host": {"resources": {"CPU": 4, "GPU": 4},
                     "min_workers": 0, "max_workers": 2},
    }, idle_timeout_s=9999)
    scaler = StandardAutoscaler(config, provider)

    @rt.remote(num_gpus=2, num_cpus=0)
    def gpu_task():
        return os.environ.get("RTT_GPU_WORKER")

    refs = [gpu_task.remote() for _ in range(2)]
    time.sleep(0.3)  # let them land in the pending queue
    report = scaler.update()
    assert report["launched"].get("gpu_host"), report
    assert rt.get(refs, timeout=120) == ["1", "1"]
    assert not report["infeasible"]
    [nid] = report["launched"]["gpu_host"]
    labels = {n["node_id"]: n["labels"] for n in rt.nodes()}[nid]
    assert labels == {"autoscaler": "1", "node_type": "gpu_host"}


def test_autoscaler_scales_down_idle_nodes(ray_start_2_cpus):
    provider = FakeMultiNodeProvider()
    config = AutoscalerConfig(node_types={
        "w": {"resources": {"CPU": 2}, "min_workers": 1, "max_workers": 4},
    }, idle_timeout_s=0.0)
    scaler = StandardAutoscaler(config, provider)
    r1 = scaler.update()  # min_workers=1 launch
    assert sum(len(v) for v in r1["launched"].values()) == 1
    provider.create_node({"resources": {"CPU": 2}},
                         {"node-type": "w", "node-kind": "worker"}, 2)
    assert len(provider.non_terminated_nodes({})) == 3
    scaler.update()   # records idle
    scaler.update()
    # idle nodes reaped down to min_workers
    deadline = time.time() + 5
    while len(provider.non_terminated_nodes({})) > 1 \
            and time.time() < deadline:
        scaler.update()
        time.sleep(0.05)
    assert len(provider.non_terminated_nodes({})) == 1


def test_autoscaler_reports_infeasible(ray_start_2_cpus):
    provider = FakeMultiNodeProvider()
    config = AutoscalerConfig(node_types={
        "small": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 2},
    })
    scaler = StandardAutoscaler(config, provider)

    @rt.remote(resources={"FPGA": 1})
    def impossible():
        return 1

    ref = impossible.remote()
    time.sleep(0.3)
    report = scaler.update()
    assert {"FPGA": 1.0, "CPU": 1.0} in report["infeasible"] or \
        any("FPGA" in s for s in report["infeasible"])
    assert report["launched"] == {}
    del ref


# ---------------------------------------------------------- runtime_env

def test_runtime_env_validation(ray_start_regular):
    # conda is a supported plugin, but this host has no conda binary, so
    # submission fails with the validated-unsupported error; a truly
    # unknown key fails as unsupported
    @rt.remote(runtime_env={"conda": "myenv"})
    def f():
        return 1

    with pytest.raises(ValueError, match="validated-unsupported"):
        f.remote()

    @rt.remote(runtime_env={"docker_image": "x"})
    def g():
        return 1

    with pytest.raises(ValueError, match="unsupported runtime_env"):
        g.remote()


def test_runtime_env_working_dir(ray_start_regular, tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "data.txt").write_text("hello from working_dir")
    (proj / "helper.py").write_text("VALUE = 41\n")

    @rt.remote(runtime_env={"working_dir": str(proj)})
    def read():
        import helper  # importable: working_dir is on sys.path
        with open("data.txt") as fh:  # cwd is the working_dir
            return fh.read(), helper.VALUE + 1

    text, val = rt.get(read.remote(), timeout=120)
    assert text == "hello from working_dir"
    assert val == 42

    # a task WITHOUT the env must not see the working_dir
    @rt.remote
    def other():
        import os
        return os.path.exists("data.txt")

    assert rt.get(other.remote(), timeout=120) is False


def test_runtime_env_py_modules(ray_start_regular, tmp_path):
    mod = tmp_path / "mymod"
    (mod / "pkg").mkdir(parents=True)
    (mod / "pkg" / "__init__.py").write_text("NAME = 'pkg-from-env'\n")

    @rt.remote(runtime_env={"py_modules": [str(mod)]})
    def use():
        import pkg
        return pkg.NAME

    assert rt.get(use.remote(), timeout=120) == "pkg-from-env"


def test_runtime_env_actor_working_dir(ray_start_regular, tmp_path):
    proj = tmp_path / "aproj"
    proj.mkdir()
    (proj / "marker.txt").write_text("actor-env")

    @rt.remote(runtime_env={"working_dir": str(proj)})
    class A:
        def read(self):
            with open("marker.txt") as fh:
                return fh.read()

    a = A.remote()
    assert rt.get(a.read.remote(), timeout=120) == "actor-env"


def test_runtime_env_env_vars_still_work(ray_start_regular):
    @rt.remote(runtime_env={"env_vars": {"MY_RE_VAR": "yes"}})
    def f():
        return os.environ.get("MY_RE_VAR")

    assert rt.get(f.remote(), timeout=120) == "yes"


def test_runtime_env_missing_blob_fails_task_not_worker(ray_start_regular):
    """A broken runtime_env must error the task, not crash the worker."""
    @rt.remote(max_retries=0,
               runtime_env={"working_dir": "kv://runtime_env/deadbeef"})
    def f():
        return 1

    with pytest.raises(Exception):
        rt.get(f.remote(), timeout=60)

    # the pooled worker survives and runs the next task
    @rt.remote
    def g():
        return "alive"

    assert rt.get(g.remote(), timeout=60) == "alive"


# ------------------------------------------------------------ pip isolation

def _make_wheel(tmp_path, name="rtt_testpkg", version="1.0",
                body="MAGIC = 42\n"):
    """Minimal hand-built wheel (no network, no build backend needed)."""
    import zipfile

    whl = tmp_path / f"{name}-{version}-py3-none-any.whl"
    di = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", body)
        zf.writestr(f"{di}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\n"
                    f"Version: {version}\n")
        zf.writestr(f"{di}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: test\n"
                    "Root-Is-Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{di}/RECORD", "")
    return whl


def test_pip_runtime_env_isolated_venv(ray_start_regular, tmp_path):
    """A wheel installs (``--no-index``) into a per-env-hash venv; the
    task sees it, the worker pool stays clean, and the cached venv is
    reused."""
    whl = _make_wheel(tmp_path)

    @rt.remote(runtime_env={"pip": [str(whl)]})
    def with_env():
        import rtt_testpkg
        return rtt_testpkg.MAGIC, rtt_testpkg.__file__, os.getpid()

    @rt.remote
    def without_env():
        try:
            import rtt_testpkg  # noqa: F401
            return "POLLUTED"
        except ImportError:
            return "clean"

    magic, modfile, _ = rt.get(with_env.remote(), timeout=180)
    assert magic == 42
    assert "/runtime_env/venvs/" in modfile, modfile

    # the pooled workers must not see the package without the env
    for _ in range(4):
        assert rt.get(without_env.remote(), timeout=60) == "clean", \
            "venv leaked into the pooled worker"
    # cached venv reused: second env task is fast and yields the same env
    t0 = time.time()
    magic2, modfile2, _ = rt.get(with_env.remote(), timeout=60)
    assert magic2 == 42 and modfile2 == modfile
    assert time.time() - t0 < 30, "venv cache not reused"


def test_pip_runtime_env_bad_requirement_fails_loudly(ray_start_regular):
    @rt.remote(runtime_env={"pip": ["definitely-not-a-real-pkg==9.9"]})
    def f():
        return 1

    with pytest.raises(rt.exceptions.RayTaskError):
        rt.get(f.remote(), timeout=180)


# ------------------------------------- repairs of the port (queue C: C25, C26)

def test_no_second_launch_or_reap_while_the_gpu_worker_boots(ray_start_2_cpus):
    """C25: a pending GPU actor that fits a launched node's free
    resources waits for that node's GPU worker (which imports torch
    before it registers), not for capacity: the head nets it out of
    ``resource_demand`` and names the node in ``waiting_on``, so a loop
    reconciling every 0.2 s with a 0.5 s idle timeout launches exactly
    one node and never reaps it during the boot; once the actor is gone
    the node is reaped and its GPU worker with it."""
    from ray_tpu_torch._private.session import _pid_alive
    from ray_tpu_torch.autoscaler import AutoscalerLoop
    from ray_tpu_torch.util import state

    launches = []

    class Recording(FakeMultiNodeProvider):
        def create_node(self, node_config, tags, count):
            ids = super().create_node(node_config, tags, count)
            launches.extend(ids)
            return ids

    provider = Recording()
    scaler = StandardAutoscaler(AutoscalerConfig(node_types={
        "gpu": {"resources": {"CPU": 1, "GPU": 1}, "min_workers": 0,
                "max_workers": 3}}, idle_timeout_s=0.5), provider)

    @rt.remote(num_gpus=1)
    class Slow:
        def __init__(self):
            time.sleep(1.0)

        def where(self):
            return rt.get_runtime_context().get_node_id(), os.getpid()

    actor = Slow.remote()
    deadline = time.time() + 30
    while not launches and time.time() < deadline:
        scaler.update()
        time.sleep(0.2)
    assert len(launches) == 1, launches
    demand = rt._worker_mod.global_worker().rpc("resource_demand")
    assert demand["task_shapes"] == [] and demand["pg_bundles"] == []
    loop = AutoscalerLoop(scaler, interval_s=0.2)
    loop.start()
    try:
        nid, pid = rt.get(actor.where.remote(), timeout=120)
        assert launches == [nid]
        assert provider.non_terminated_nodes({}) == [nid]
        rt.kill(actor)
        deadline = time.time() + 10
        while provider.non_terminated_nodes({}) and time.time() < deadline:
            time.sleep(0.1)
        assert provider.non_terminated_nodes({}) == []
        assert launches == [nid]
        deadline = time.time() + 10
        while _pid_alive(pid) and time.time() < deadline:
            time.sleep(0.1)
        assert not _pid_alive(pid)
        assert not [w for w in state.list_workers()
                    if w["node_id"] == nid and w["state"] != "dead"]
    finally:
        loop.stop()


def test_resource_demand_nets_work_that_waits_for_a_worker(ray_start_2_cpus):
    """C25 at the head: pending work that fits a schedulable node's free
    resources is netted there (``waiting_on``), one shape per fit, and
    the rest stays demand; pinned work only nets on its node."""
    w = rt._worker_mod.global_worker()
    head = rt._head
    nid = w.rpc("add_node", resources={"CPU": 1, "FPGA": 2})["node_id"]
    specs = [{"num_cpus": 0, "resources": {"FPGA": 1}},
             {"num_cpus": 0, "resources": {"FPGA": 1}},
             {"num_cpus": 0, "resources": {"FPGA": 1}},
             {"num_cpus": 1, "scheduling_strategy": {
                 "type": "node_affinity", "node_id": head.head_node_id,
                 "soft": False}, "resources": {"FPGA": 1}}]
    with head.lock:
        saved = list(head.pending_tasks)
        head.pending_tasks.clear()
        head.pending_tasks.extend(specs)
    try:
        got = w.rpc("resource_demand")
    finally:
        with head.lock:
            head.pending_tasks.clear()
            head.pending_tasks.extend(saved)
        w.rpc("remove_node", node_id=nid)
    # two FPGA shapes fit the new node; the third and the one pinned to
    # the FPGA-less head need capacity
    assert got["waiting_on"] == [nid]
    assert got["task_shapes"] == [{"FPGA": 1.0}, {"CPU": 1.0, "FPGA": 1.0}]


def test_remove_node_stops_its_starting_gpu_worker(ray_start_2_cpus):
    """C26: removing a node while its warm GPU worker is still booting
    (forked, not yet registered) stops that worker too; before, it
    registered afterwards to no node and lived on."""
    from ray_tpu_torch._private.session import _pid_alive
    w = rt._worker_mod.global_worker()
    head = rt._head
    nid = w.rpc("add_node", resources={"CPU": 1, "GPU": 1})["node_id"]
    pid = None
    deadline = time.time() + 30
    while pid is None and time.time() < deadline:
        with head.lock:
            pid = next((x.pid for x in head.workers.values()
                        if x.node_id == nid and x.state == "starting"
                        and x.gpu_capable), None)
        time.sleep(0.01)
    assert pid is not None, "the node's GPU worker was never forked"
    w.rpc("remove_node", node_id=nid)
    deadline = time.time() + 10
    while _pid_alive(pid) and time.time() < deadline:
        time.sleep(0.05)
    assert not _pid_alive(pid)
    with head.lock:
        assert not [x for x in head.workers.values() if x.node_id == nid]
        assert nid not in head._gpu_fork_after
