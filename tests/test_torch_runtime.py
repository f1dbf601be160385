"""The port's runtime on one host (``ray_tpu_torch.init`` / tasks / actors
/ the shm object store), held to the reference's own core tests
(``tests/test_basic.py``, ``tests/test_actor.py``), plus what the port
adds: ``num_gpus`` routing, torch tensors in the object store, and byte
parity of the object and wire formats with the JAX package.

Tests that need no fresh cluster share one cluster at ``num_cpus=2``
(``cluster``); the fixture restarts it if a fresh-cluster test ran in
between.  Tests that leave a task running get their own
(``fresh_cluster``, the reference's ``ray_start_regular``).  Functions
and classes here are pickled by value, so spawned workers never import
this module (nor JAX through it).
"""

import gc
import logging
import os
import pickle
import sys
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import serialization as t_ser
from ray_tpu_torch._private import wire as t_wire
from ray_tpu_torch._private import worker as t_worker
from ray_tpu_torch.exceptions import (GetTimeoutError, RayActorError,
                                      RayTaskError, TaskCancelledError)

from ray_tpu._private import serialization as j_ser
from ray_tpu._private import wire as j_wire

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _stop():
    if rt.is_initialized():
        rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Wraps the module: stops its last cluster, and hands later test
    modules in this process the package logger as it was.  ``init``
    configures that logger for the process (its own stderr and file
    handlers, no propagation to the root, where pytest's caplog reads
    records)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    _stop()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


@pytest.fixture
def fresh_cluster(_shared):
    """The reference's ``ray_start_regular``: a cluster of this test's
    own, for tests that leave a task running (a cancel is best-effort,
    so a shared cluster could not count on getting its CPU back)."""
    _stop()
    rt.init(num_cpus=4)
    yield
    _stop()


@pytest.fixture
def cluster(_shared):
    if not rt.is_initialized():
        rt.init(num_cpus=2)
    yield
    # actors of one test must not hold workers into the next
    w = t_worker.global_worker()
    for a in w.rpc("list_actors")["actors"]:
        if a["state"] != "DEAD":
            rt.kill(rt.ActorHandle(a["actor_id"], {}))


# ------------------------------------------------------- fresh clusters
def test_slab_and_flight_rings_follow_the_shm_dir(monkeypatch, tmp_path):
    """The session's slab and flight-ring dir live in the store's shm
    directory (RTT_SHM_DIR), never at a fixed /dev/shm path."""
    from ray_tpu_torch._private import flight_recorder, shm_store
    from ray_tpu_torch._private.session import Session
    monkeypatch.setattr(shm_store, "_SHM_DIR", tmp_path)
    s = Session(root=str(tmp_path / "sessions"))
    assert s.slab_path().startswith(str(tmp_path / "rtt_slab_"))
    assert flight_recorder.flight_dir_for(s.path) == \
        tmp_path / "rtt_flight" / s.name


def test_modes_left_out_of_the_slice_raise_and_their_flags_are_gone():
    """The client mode and the autopilot wait for their modules; the
    flags that only they read are not offered."""
    from ray_tpu_torch._private import config as t_config
    _stop()
    with pytest.raises(NotImplementedError, match="client server"):
        rt.init("ray://127.0.0.1:10001")
    try:
        with pytest.raises(NotImplementedError, match="autopilot"):
            rt.init(num_cpus=1, _system_config={"autopilot_enabled": True})
    finally:
        t_config.GLOBAL_CONFIG.reset()
    assert not rt.is_initialized()
    gone = [k for k in t_config._DEFS
            if k.startswith(("autopilot_", "collective_", "elastic_"))]
    assert gone == ["autopilot_enabled"]


def test_gpu_task_routing_and_worker_capability(monkeypatch):
    """Tasks requesting GPUs run on GPU-capable workers (RTT_GPU_WORKER,
    the node's cards in CUDA_VISIBLE_DEVICES, taken from the parent's
    own list); plain tasks run on workers that see no card and have not
    imported torch.  Counterpart of test_basic.py's TPU routing test."""
    _stop()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,7")
    rt.init(num_cpus=2, num_gpus=2)
    try:
        assert rt.cluster_resources().get("GPU") == 2.0

        @rt.remote(num_gpus=1, num_cpus=0)
        def on_gpu_worker():
            return (os.environ.get("RTT_GPU_WORKER"),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        @rt.remote
        def on_cpu_worker():
            return (os.environ.get("RTT_GPU_WORKER"),
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "torch" in sys.modules)

        # plain worker exists first so the preference is observable
        assert rt.get(on_cpu_worker.remote(), timeout=60) == \
            (None, "", False)
        assert rt.get(on_gpu_worker.remote(), timeout=60) == ("1", "3,5")
        # with both kinds idle, CPU work prefers the plain worker
        assert rt.get(on_cpu_worker.remote(), timeout=60)[:2] == (None, "")
        with pytest.raises(ValueError, match="num_tpus"):
            rt.remote(num_tpus=1)(on_cpu_worker.func)
    finally:
        rt.shutdown()


def test_plain_actor_never_takes_a_gpu_worker(monkeypatch):
    """A GPU worker left idle by a num_gpus task may carry plain tasks,
    but a plain actor holds its worker for life: it must get a plain
    worker that sees no card (a use_gpu=False train worker on a GPU
    worker would train on the card unasked)."""
    _stop()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    rt.init(num_cpus=2, num_gpus=1)
    try:
        @rt.remote(num_gpus=1, num_cpus=0)
        def on_gpu_worker():
            return os.getpid()

        gpu_pid = rt.get(on_gpu_worker.remote(), timeout=60)

        @rt.remote(num_cpus=0)
        class Plain:
            def view(self):
                return (os.getpid(), os.environ.get("RTT_GPU_WORKER"),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        actors = [Plain.remote() for _ in range(3)]
        views = rt.get([a.view.remote() for a in actors], timeout=60)
        assert all(v[1:] == (None, "") for v in views), views
        assert gpu_pid not in {v[0] for v in views}
    finally:
        rt.shutdown()


def test_no_card_means_no_gpu_and_gpu_work_waits(monkeypatch):
    """Without a card (this CPU build) init reports no GPU, and a
    num_gpus=1 task stays pending instead of running on the CPU."""
    _stop()
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    rt.init(num_cpus=1)
    try:
        assert torch.cuda.device_count() == 0
        assert "GPU" not in rt.cluster_resources()

        @rt.remote(num_gpus=1)
        def needs_card():
            return "ran"

        ref = needs_card.remote()
        ready, pending = rt.wait([ref], num_returns=1, timeout=1.0)
        assert ready == [] and pending == [ref]
        rt.cancel(ref, force=True)
    finally:
        rt.shutdown()


# ------------------------------------------------------ test_basic.py
def test_put_get(cluster):
    ref = rt.put(42)
    assert rt.get(ref) == 42


def test_put_get_numpy_zero_copy(cluster):
    arr = np.arange(1_000_000, dtype=np.float32)
    ref = rt.put(arr)
    out = rt.get(ref)
    np.testing.assert_array_equal(arr, out)
    # large arrays come back as read-only views onto shm
    assert not out.flags.writeable


def test_simple_task(cluster):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def test_task_with_ref_arg(cluster):
    @rt.remote
    def double(x):
        return 2 * x

    r1 = double.remote(10)
    r2 = double.remote(r1)  # top-level ref resolved to value
    assert rt.get(r2) == 40


def test_task_kwargs_and_large_args(cluster):
    @rt.remote
    def f(a, b=None):
        return a.sum() + b

    big = np.ones(500_000, dtype=np.float64)
    assert rt.get(f.remote(big, b=5)) == 500_005.0


def test_num_returns(cluster):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def test_nested_tasks(cluster):
    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 10

    assert rt.get(outer.remote(1)) == 12


def test_task_error_propagates(cluster):
    @rt.remote
    def boom():
        raise ValueError("boom!")

    with pytest.raises(RayTaskError) as ei:
        rt.get(boom.remote())
    assert "boom!" in str(ei.value)


def test_error_propagates_through_deps(cluster):
    @rt.remote
    def boom():
        raise ValueError("origin")

    @rt.remote
    def use(x):
        return x

    with pytest.raises(RayTaskError) as ei:
        rt.get(use.remote(boom.remote()))
    assert "origin" in str(ei.value)


def test_wait(fresh_cluster):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=4)
    assert ready == [f]
    assert not_ready == [s]


def test_get_timeout(fresh_cluster):
    @rt.remote
    def slow():
        time.sleep(30)

    with pytest.raises(GetTimeoutError):
        rt.get(slow.remote(), timeout=0.5)


def test_options_override(cluster):
    @rt.remote
    def whoami():
        return "ok"

    assert rt.get(whoami.options(num_cpus=2, name="custom").remote()) == "ok"


def test_refs_inside_containers_stay_refs(cluster):
    @rt.remote
    def make():
        return 7

    @rt.remote
    def takes_list(refs):
        # nested refs arrive as refs, not values (reference semantics)
        assert all(isinstance(r, rt.ObjectRef) for r in refs)
        return rt.get(refs)

    refs = [make.remote() for _ in range(3)]
    assert rt.get(takes_list.remote(refs)) == [7, 7, 7]


def test_cluster_resources(cluster):
    total = rt.cluster_resources()
    assert total.get("CPU") == 2.0


def test_many_small_tasks(cluster):
    @rt.remote
    def sq(i):
        return i * i

    refs = [sq.remote(i) for i in range(50)]
    assert rt.get(refs) == [i * i for i in range(50)]


def test_feasible_task_behind_infeasible_backlog(cluster):
    """Liveness: a runnable task parked behind many permanently
    unplaceable specs still dispatches."""
    @rt.remote(resources={"no_such_resource": 1})
    def stuck():
        return "never"

    @rt.remote
    def runnable():
        return 42

    blocked = [stuck.remote() for _ in range(64)]
    assert rt.get(runnable.remote(), timeout=30) == 42
    for ref in blocked:
        rt.cancel(ref)


# ------------------------------------------------------ test_actor.py
@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, by=1):
        self.n += by
        return self.n

    def read(self):
        return self.n


def test_actor_basic(cluster):
    c = Counter.remote()
    assert rt.get(c.inc.remote()) == 1
    assert rt.get(c.inc.remote(5)) == 6
    assert rt.get(c.read.remote()) == 6


def test_actor_constructor_args(cluster):
    c = Counter.remote(start=100)
    assert rt.get(c.read.remote()) == 100


def test_actor_calls_ordered(cluster):
    c = Counter.remote()
    refs = [c.inc.remote() for _ in range(20)]
    assert rt.get(refs) == list(range(1, 21))


def test_actor_method_error(cluster):
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("nope")

        def ok(self):
            return "fine"

    b = Bad.remote()
    with pytest.raises(RayTaskError) as ei:
        rt.get(b.fail.remote())
    assert "nope" in str(ei.value)
    # actor survives method errors
    assert rt.get(b.ok.remote()) == "fine"


def test_actor_constructor_error(cluster):
    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("ctor boom")

        def m(self):
            return 1

    b = Broken.remote()
    with pytest.raises((RayTaskError, RayActorError)):
        rt.get(b.m.remote(), timeout=10)


def test_named_actor(cluster):
    Counter.options(name="global_counter").remote()
    h = rt.get_actor("global_counter")
    assert rt.get(h.inc.remote()) == 1
    h2 = rt.get_actor("global_counter")
    assert rt.get(h2.inc.remote()) == 2


def test_named_actor_duplicate_rejected(cluster):
    Counter.options(name="dup").remote()
    with pytest.raises(ValueError):
        Counter.options(name="dup").remote()


def test_get_if_exists(cluster):
    a = Counter.options(name="gie", get_if_exists=True).remote()
    rt.get(a.inc.remote())
    b = Counter.options(name="gie", get_if_exists=True).remote()
    assert rt.get(b.read.remote()) == 1


def test_kill_actor(cluster):
    c = Counter.remote()
    assert rt.get(c.inc.remote()) == 1
    rt.kill(c)
    with pytest.raises(RayActorError):
        rt.get(c.inc.remote(), timeout=15)


def test_actor_restart(cluster):
    @rt.remote(max_restarts=1, max_task_retries=1)
    class Crashy:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Crashy.remote()
    assert rt.get(c.inc.remote()) == 1
    rt.kill(c, no_restart=False)
    time.sleep(0.5)
    # restarted: state reset, calls work again
    assert rt.get(c.inc.remote(), timeout=30) == 1


def test_actor_restart_after_crash_method(cluster):
    @rt.remote(max_restarts=2, max_task_retries=1)
    class Crashy:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def die(self):
            import os
            os._exit(1)

    c = Crashy.remote()
    assert rt.get(c.inc.remote()) == 1
    c.die.remote()  # crashes; the retried call crashes the restart too
    time.sleep(1.0)
    assert rt.get(c.inc.remote(), timeout=60) == 1


def test_actor_no_restart_raises(cluster):
    @rt.remote
    class Fragile:
        def die(self):
            import os
            os._exit(1)

        def m(self):
            return 1

    f = Fragile.remote()
    assert rt.get(f.m.remote()) == 1
    f.die.remote()
    with pytest.raises(RayActorError):
        rt.get(f.m.remote(), timeout=15)


def test_pass_actor_handle(cluster):
    @rt.remote
    def use_counter(h):
        return rt.get(h.inc.remote(10))

    c = Counter.remote()
    assert rt.get(use_counter.remote(c)) == 10
    assert rt.get(c.read.remote()) == 10


def test_async_actor(cluster):
    @rt.remote(max_concurrency=4)
    class AsyncActor:
        async def slow_echo(self, x):
            import asyncio
            import time as _t
            start = _t.monotonic()
            await asyncio.sleep(0.2)
            return (x, start, _t.monotonic())

    a = AsyncActor.remote()
    refs = [a.slow_echo.remote(i) for i in range(4)]
    out = rt.get(refs, timeout=30)
    assert [o[0] for o in out] == [0, 1, 2, 3]
    # the four sleeps' execution intervals overlap iff they ran
    # concurrently, however slow dispatch was
    latest_start = max(o[1] for o in out)
    earliest_end = min(o[2] for o in out)
    assert latest_start < earliest_end, out


def test_exit_actor(cluster):
    @rt.remote(max_restarts=5)
    class Quitter:
        def quit(self):
            from ray_tpu_torch._private.actor_server import exit_actor
            exit_actor()

        def m(self):
            return 1

    q = Quitter.remote()
    assert rt.get(q.m.remote()) == 1
    q.quit.remote()
    # intentional exit: no restart even though max_restarts > 0
    with pytest.raises(RayActorError):
        rt.get(q.m.remote(), timeout=15)


def test_actor_large_payload(cluster):
    @rt.remote
    class Holder:
        def __init__(self):
            self.arr = None

        def store(self, arr):
            self.arr = arr
            return arr.nbytes

        def fetch(self):
            return self.arr

    h = Holder.remote()
    arr = np.random.default_rng(0).standard_normal(300_000)
    assert rt.get(h.store.remote(arr)) == arr.nbytes
    out = rt.get(h.fetch.remote())
    assert (out == arr).all()


def test_actor_pipelined_inline_burst_no_deadlock(cluster):
    """A pipelined burst of near-inline-max args and results completes:
    the caller's reply reader never parks behind a blocked send."""

    @rt.remote
    class Echo:
        def big(self, blob):
            return blob + b"!" * 50_000

    e = Echo.remote()
    blob = b"x" * 90_000          # inline_object_max_bytes is 100KB
    refs = [e.big.remote(blob) for _ in range(24)]   # pipelined burst
    out = rt.get(refs, timeout=120)
    assert all(o == blob + b"!" * 50_000 for o in out)


def test_actor_constructor_args_beyond_inline_size(cluster):
    """Constructor args above inline_object_max_bytes travel as an object
    the submitter releases right after create_actor: the GCS pins them
    for the actor's lifetime (a restart reads them again), so the actor
    starts (it stayed PENDING before, the args freed under it) — from
    the driver and from inside an actor, as Serve's controller creates
    replicas — and the object goes once the actor is dead."""
    w = t_worker.global_worker()

    def args_objects(lo, hi):
        return [o for o in w.rpc("list_objects")["objects"]
                if lo <= o["size"] < hi]

    class Holder:
        def __init__(self, arr):
            self.n = int(arr.sum())

        def n_(self):
            return self.n

    class Maker:
        def make(self, size):
            h = rt.remote(Holder).remote(np.ones(size, np.uint8))
            return rt.get(h.n_.remote(), timeout=60)

    h = rt.remote(Holder).remote(np.ones(400_000, np.uint8))
    assert rt.get(h.n_.remote(), timeout=60) == 400_000
    m = rt.remote(Maker).options(num_cpus=0).remote()
    assert rt.get(m.make.remote(300_000), timeout=90) == 300_000
    # h's payload (400 kB and its header) stays while h lives
    assert len(args_objects(400_000, 410_000)) == 1
    rt.kill(h)
    rt.kill(m)
    deadline = time.monotonic() + 30
    while args_objects(400_000, 410_000) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not args_objects(400_000, 410_000)


def test_actor_method_args_by_ref_outlive_the_callers_ref(cluster):
    """RLlib's pipelines pass weights (MBs, above the inline size) to
    actor methods as a ref and drop it at the next broadcast, while the
    call may still wait behind another: the call's args are pinned until
    it ends, so it reads the value it was given."""

    class Worker:
        def busy(self, s):
            time.sleep(s)
            return s

        def total(self, x):
            return float(np.asarray(x).sum())

    w = rt.remote(Worker).remote()
    rt.get(w.busy.remote(0), timeout=60)
    outs = []
    for i in range(4):
        ref = rt.put(np.full(1_000_000, i + 1.0, np.float32))    # 4 MB
        w.busy.remote(0.2)
        outs.append(w.total.remote(ref))
        del ref
        gc.collect()
        junk = [rt.put(np.zeros(1_000_000, np.float32)) for _ in range(4)]
        del junk
        gc.collect()
    assert rt.get(outs, timeout=60) == [1e6 * (i + 1) for i in range(4)]
    rt.kill(w)


def test_actor_result_ref_resolves_inside_another_actor(cluster):
    """Ape-X routes a rollout worker's result ref to a replay shard
    (``shard.add_batch.remote(ref)``): the shard resolves it, after the
    driver dropped its ref and never fetched the value."""

    class Producer:
        def make(self, v):
            return np.full(500_000, v, np.float32)

    class Shard:
        def __init__(self):
            self.seen = []

        def add(self, batch):
            self.seen.append(float(batch.sum()))
            return len(self.seen)

        def sums(self):
            return self.seen

    p = rt.remote(Producer).remote()
    s = rt.remote(Shard).options(num_cpus=0).remote()
    for v in (1.0, 2.0, 3.0):
        frag = p.make.remote(v)
        ready, _ = rt.wait([frag], num_returns=1, timeout=60)
        assert ready == [frag] and ready[0] is frag
        s.add.remote(frag)
        del frag, ready
        gc.collect()
    assert rt.get(s.sums.remote(), timeout=60) == [5e5, 1e6, 1.5e6]
    rt.kill(p)
    rt.kill(s)


# --------------------------------------------- cancel and the RPC channel
def test_rpc_channel_is_not_reused_after_an_interrupted_call(monkeypatch):
    """A call interrupted between a reply's header and its body (a task
    cancel's asynchronous exception) leaves the stream misaligned: the
    channel closes and the pool dials a fresh one instead of blocking on
    the next read."""
    import threading
    from multiprocessing import Pipe
    from ray_tpu_torch._private import protocol

    def connect():
        a, b = Pipe()

        def serve():
            try:
                while True:
                    msg, _ = t_wire.conn_recv(b)
                    t_wire.conn_send(b, {"rid": msg["rid"],
                                         "echo": msg.get("x")}, 0)
            except (EOFError, OSError):
                pass

        threading.Thread(target=serve, daemon=True).start()
        return a

    pool = protocol.RpcPool("unused", connect_fn=connect)
    assert pool.call("echo", x=1)["echo"] == 1
    ch = pool.channel()

    def interrupted(conn):
        raise TaskCancelledError("t")

    monkeypatch.setattr(t_wire, "conn_recv", interrupted)
    with pytest.raises(TaskCancelledError):
        pool.call("echo", x=2)
    monkeypatch.undo()
    assert ch.closed
    assert pool.call("echo", x=3)["echo"] == 3
    assert pool.channel() is not ch
    pool.close_all()


def test_cancel_raises_only_in_the_task_code():
    """A cancel that arrives before the task's own code runs (while the
    worker fetches the function or unpacks arguments) is held back and
    cancels the task when its code would start; one that arrives while
    the code runs raises there."""
    import threading
    from collections import OrderedDict
    from types import SimpleNamespace
    w = SimpleNamespace(_cancel_lock=threading.Lock(), _in_user_fn=False,
                        _cancel_pending=OrderedDict(),
                        _current_spec={"task_id": "t1"},
                        _exec_thread_id=threading.get_ident())
    t_worker.Worker._cancel_current(w, "t1")
    assert list(w._cancel_pending) == ["t1"]

    caught = []
    started = threading.Event()

    def task_code():
        with w._cancel_lock:
            w._exec_thread_id = threading.get_ident()
            w._current_spec = {"task_id": "t2"}
            w._in_user_fn = True
        started.set()
        try:
            for _ in range(400):
                time.sleep(0.005)
        except TaskCancelledError:
            caught.append("t2")

    th = threading.Thread(target=task_code)
    th.start()
    assert started.wait(10)
    t_worker.Worker._cancel_current(w, "t2")
    th.join(10)
    assert not th.is_alive() and caught == ["t2"]
    assert "t2" not in w._cancel_pending


# ------------------------------------------------- torch tensors
TENSORS = {
    "f32": lambda g: torch.randn(64, 33, generator=g),
    "bf16": lambda g: torch.randn(300, 1000, generator=g).to(torch.bfloat16),
    "i64": lambda g: torch.randint(-9, 9, (5, 7), generator=g),
    "u8": lambda g: torch.randint(0, 255, (40_000,), generator=g,
                                  dtype=torch.uint8),
    "f16_scalar": lambda g: torch.tensor(1.5, dtype=torch.float16),
    "f32_transposed": lambda g: torch.randn(6, 9, generator=g).t(),
}


def _bits(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    return t.view(torch.int16).numpy().tobytes() \
        if t.dtype == torch.bfloat16 else t.numpy().tobytes()


@pytest.mark.parametrize("kind", sorted(TENSORS))
def test_tensor_round_trips_bitwise_out_of_band(kind):
    """A CPU tensor (bf16 too) pickles its bytes out of band — the
    in-band stream stays small — and reads back bit for bit as a tensor
    over the stored buffer."""
    t = TENSORS[kind](torch.Generator().manual_seed(0))
    pickled, buffers, _ = t_ser.serialize(t)
    assert len(buffers) == 1
    assert len(pickled) < 400
    assert t_ser._raw_view(buffers[0]).nbytes == t.numel() * t.element_size()
    wire = memoryview(bytes(t_ser.to_wire_bytes(pickled, buffers)))
    out = t_ser.deserialize_from(wire)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == t.dtype and out.shape == t.shape
    assert _bits(out) == _bits(t)
    # zero-copy: the tensor's storage lies inside the stored buffer
    base = np.frombuffer(wire, np.uint8).ctypes.data
    assert base <= out.data_ptr() < base + wire.nbytes


def test_cuda_tensor_read_without_a_card_raises():
    """A CUDA tensor read in a process that sees no card raises, naming
    num_gpus, instead of landing on the CPU."""
    arr = torch.arange(6, dtype=torch.bfloat16).view(torch.int16).numpy()
    blob, _ = t_ser.serialize_to_bytes(_FakeCudaTensor(arr))
    with pytest.raises(RuntimeError, match="num_gpus"):
        t_ser.deserialize_from(memoryview(bytes(blob)))


class _FakeCudaTensor:
    """What a CUDA bf16 tensor reduces to (the card's side of the store)."""

    def __init__(self, arr, device="cuda:0"):
        self.arr, self.device = arr, device

    def __reduce__(self):
        return t_ser._rebuild_tensor, (self.arr, "bfloat16", self.device,
                                       False, False)


def test_cuda_tensor_index_beyond_the_visible_cards_raises(monkeypatch):
    """A tensor of cuda:1 read where one card is visible raises, naming
    num_gpus, instead of landing on cuda:0 or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    arr = torch.arange(6, dtype=torch.bfloat16).view(torch.int16).numpy()
    blob, _ = t_ser.serialize_to_bytes(_FakeCudaTensor(arr, "cuda:1"))
    with pytest.raises(RuntimeError, match="cuda:1.*num_gpus"):
        t_ser.deserialize_from(memoryview(bytes(blob)))


@pytest.mark.parametrize("parameter", [False, True])
@pytest.mark.parametrize("requires_grad", [False, True])
def test_tensor_keeps_requires_grad_and_parameter(parameter, requires_grad):
    """requires_grad and nn.Parameter survive the store as they survive
    torch's own pickling, and the bytes still go out of band."""
    t = torch.randn(32, 16, generator=torch.Generator().manual_seed(4))
    if parameter:
        t = torch.nn.Parameter(t, requires_grad=requires_grad)
    else:
        t.requires_grad_(requires_grad)
    pickled, buffers, _ = t_ser.serialize(t)
    assert len(buffers) == 1 and len(pickled) < 400
    out = t_ser.deserialize_from(
        memoryview(bytes(t_ser.to_wire_bytes(pickled, buffers))))
    torch_own = pickle.loads(pickle.dumps(t))
    assert type(out) is type(torch_own) is type(t)
    assert out.requires_grad == torch_own.requires_grad == requires_grad
    assert out.is_leaf
    assert _bits(out.detach()) == _bits(t.detach())


def test_views_of_one_storage_read_back_as_separate_tensors():
    """Each tensor ships its own bytes (as numpy views do): two views of
    one storage come back equal in value, over storages of their own."""
    base = torch.arange(24, dtype=torch.float32)
    a, b = base[:12].view(3, 4), base[6:]
    out_a, out_b = t_ser.deserialize_from(memoryview(bytes(
        t_ser.serialize_to_bytes((a, b))[0])))
    assert torch.equal(out_a, a) and torch.equal(out_b, b)
    assert out_a.untyped_storage().data_ptr() != \
        out_b.untyped_storage().data_ptr()


def test_tensors_through_the_store_and_tasks(cluster):
    g = torch.Generator().manual_seed(1)
    big = torch.randn(512, 1024, generator=g).to(torch.bfloat16)  # shm plane
    small = torch.randn(8, 8, generator=g)                          # inline
    for t in (big, small):
        assert _bits(rt.get(rt.put(t))) == _bits(t)

    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def make(seed):
        import torch
        return torch.randn(256, 256, generator=torch.Generator()
                           .manual_seed(seed)).to(torch.bfloat16)

    assert _bits(rt.get(double.remote(big))) == _bits(big * 2)
    want = torch.randn(256, 256, generator=torch.Generator()
                       .manual_seed(3)).to(torch.bfloat16)
    assert _bits(rt.get(make.remote(3))) == _bits(want)


# ---------------------------------------------- parity with ray_tpu
def _tree():
    rng = np.random.default_rng(0)
    return {"a": np.arange(10), "b": [rng.standard_normal((3, 4))
                                      .astype(np.float32), 1.5, "x"],
            "c": (np.zeros(300_000, np.int8), None, b"bytes"),
            "d": {"nested": np.asfortranarray(rng.standard_normal((5, 6)))}}


def test_object_format_is_the_reference_byte_for_byte():
    port, _ = t_ser.serialize_to_bytes(_tree())
    ref, _ = j_ser.serialize_to_bytes(_tree())
    assert bytes(port) == bytes(ref)
    out = j_ser.deserialize_from(memoryview(bytes(port)))
    np.testing.assert_array_equal(out["d"]["nested"], _tree()["d"]["nested"])


WIRE_MSGS = [
    {"kind": "submit_task", "task_id": "t" * 16, "n": 3, "x": 1.25,
     "ok": True, "none": None, "blob": b"\x00\x01" * 100,
     "deps": ["a", "b"], "nested": {"k": [1, 2, {"z": -7}]}},
    {"kind": "get_objects", "object_ids": [f"o{i}" for i in range(50)],
     "timeout": None},
    {"kind": "custom", "payload": {1, 2, 3}},     # pickle-only payload
]


@pytest.mark.parametrize("version", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("prefer_pickle", [False, True])
def test_wire_frames_decode_across_packages(version, prefer_pickle):
    for msg in WIRE_MSGS:
        for enc, dec in ((t_wire, j_wire), (j_wire, t_wire)):
            raw = enc.encode_frame(msg, version, prefer_pickle)
            obj, ver = dec.decode_frame(raw)
            assert obj == msg and ver == version
    assert t_wire.rtmsg_loads(j_wire.rtmsg_dumps(WIRE_MSGS[0])) == \
        WIRE_MSGS[0]
    assert j_wire.rtmsg_loads(t_wire.rtmsg_dumps(WIRE_MSGS[1])) == \
        WIRE_MSGS[1]
