"""The port's ``util`` extras on its own runtime — ``ActorPool``, the
distributed ``Queue``, the ``multiprocessing.Pool`` shim and the joblib
backend — held to the reference's ``tests/test_util_misc.py`` (all 18,
every assertion kept).

Tests share one cluster at ``num_cpus=4`` (``cluster``, the reference's
``ray_start_regular`` at its size); the fixture kills the actors a test
leaves, so none holds a worker into the next.  Functions and classes here
are pickled by value, so spawned workers never import this module (nor
JAX through it).
"""

import logging
import os
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import worker as t_worker
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _stop():
    if rt.is_initialized():
        rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Stops the module's cluster and hands later modules the package
    logger as it was (``init`` stops its propagation)."""
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
def cluster(_shared, monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if not rt.is_initialized():
        rt.init(num_cpus=4, num_gpus=0)
    yield
    w = t_worker.global_worker()
    for a in w.rpc("list_actors")["actors"]:
        if a["state"] != "DEAD":
            rt.kill(rt.ActorHandle(a["actor_id"], {}))


@rt.remote
class _Doubler:
    def double(self, x):
        return 2 * x

    def slow_double(self, x):
        time.sleep(0.05 * (3 - x))  # later values finish first
        return 2 * x


# ---------------------------------------------------------------- ActorPool

def test_actor_pool_map_ordered(cluster):
    pool = ActorPool([_Doubler.remote() for _ in range(2)])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [0, 2, 4, 6, 8, 10, 12, 14]


def test_actor_pool_unordered_and_reuse(cluster):
    pool = ActorPool([_Doubler.remote() for _ in range(2)])
    out = set(pool.map_unordered(lambda a, v: a.slow_double.remote(v),
                                 [0, 1, 2]))
    assert out == {0, 2, 4}
    # pool reusable after drain
    assert list(pool.map(lambda a, v: a.double.remote(v), [5])) == [10]


def test_actor_pool_submit_get_next(cluster):
    pool = ActorPool([_Doubler.remote()])
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)  # queued (1 actor)
    assert pool.has_next()
    assert pool.get_next() == 20
    assert pool.get_next() == 40
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()


def test_actor_pool_push_pop(cluster):
    a, b = _Doubler.remote(), _Doubler.remote()
    pool = ActorPool([a])
    assert pool.pop_idle() is not None
    assert not pool.has_free()
    pool.push(b)
    assert pool.has_free()


# -------------------------------------------------------------------- Queue

def test_queue_fifo(cluster):
    q = Queue()
    for i in range(5):
        q.put(i)
    assert q.qsize() == 5
    assert [q.get() for _ in range(5)] == [0, 1, 2, 3, 4]
    assert q.empty()


def test_queue_maxsize_and_nowait(cluster):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    assert q.full()
    with pytest.raises(Full):
        q.put_nowait(3)
    assert q.get_nowait() == 1
    with pytest.raises(Empty):
        Queue().get_nowait()


def test_queue_blocking_timeout(cluster):
    q = Queue()
    t0 = time.monotonic()
    with pytest.raises(Empty):
        q.get(timeout=0.3)
    assert time.monotonic() - t0 >= 0.25


def test_queue_cross_task(cluster):
    q = Queue()

    @rt.remote
    def producer(q):
        for i in range(3):
            q.put(i * 100)
        return True

    assert rt.get(producer.remote(q))
    assert [q.get(timeout=10) for _ in range(3)] == [0, 100, 200]


# ---------------------------------------------------- multiprocessing.Pool

def test_mp_pool_map(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool
    with Pool(processes=2) as p:
        assert p.map(lambda x: x * x, range(10)) == [x * x for x in range(10)]


def test_mp_pool_apply_starmap_imap(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool
    p = Pool(processes=2)
    assert p.apply(lambda a, b: a + b, (2, 3)) == 5
    ar = p.apply_async(lambda: 42)
    assert ar.get(timeout=30) == 42 and ar.ready()
    assert p.starmap(lambda a, b: a * b, [(1, 2), (3, 4)]) == [2, 12]
    assert list(p.imap(lambda x: -x, [1, 2, 3])) == [-1, -2, -3]
    assert set(p.imap_unordered(lambda x: -x, [1, 2, 3])) == {-1, -2, -3}
    p.close()
    p.join()
    with pytest.raises(ValueError):
        p.map(lambda x: x, [1])


# ------------------------------------------------------------------- joblib

def test_joblib_backend(cluster):
    joblib = pytest.importorskip("joblib")
    import ray_tpu_torch.util.joblib  # noqa: F401 - registers the backend
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = joblib.Parallel()(joblib.delayed(lambda x: x ** 2)(i)
                                for i in range(6))
    assert out == [0, 1, 4, 9, 16, 25]


def test_queue_many_parked_getters_no_deadlock(cluster):
    """More blocked gets than the actor's executor threads must not wedge
    the queue actor — parked gets live on the event loop, not threads."""
    q = Queue()
    getters = [q.get_async() for _ in range(25)]  # > max_concurrency=16
    time.sleep(0.2)
    for i in range(25):
        q.put(i)
    got = sorted(rt.get(getters, timeout=60))
    assert got == list(range(25))


def test_queue_async_refs_return_items(cluster):
    q = Queue()
    assert rt.get(q.put_async("x"), timeout=30) is True
    assert rt.get(q.get_async(), timeout=30) == "x"


def test_actor_pool_error_does_not_leak_actor(cluster):
    @rt.remote
    class F:
        def boom(self):
            raise ValueError("nope")

        def ok(self):
            return 1

    pool = ActorPool([F.remote()])
    pool.submit(lambda a, v: a.boom.remote(), None)
    with pytest.raises(Exception):
        pool.get_next()
    # actor must be back in the pool and usable
    pool.submit(lambda a, v: a.ok.remote(), None)
    assert pool.get_next() == 1


def test_actor_pool_get_next_timeout_keeps_state(cluster):
    @rt.remote
    class Slow:
        def f(self):
            time.sleep(1.0)
            return 7

    pool = ActorPool([Slow.remote()])
    pool.submit(lambda a, v: a.f.remote(), None)
    with pytest.raises(TimeoutError):
        pool.get_next(timeout=0.05)
    assert pool.get_next(timeout=30) == 7


def test_async_actor_exit_actor(cluster):
    """exit_actor() from an ASYNC method must reply and kill the actor."""
    from ray_tpu_torch._private.actor_server import exit_actor

    @rt.remote
    class A:
        async def stop(self):
            exit_actor()

        async def ping(self):
            return "pong"

    a = A.remote()
    assert rt.get(a.ping.remote()) == "pong"
    with pytest.raises(Exception):
        rt.get(a.stop.remote(), timeout=30)


def test_actor_pool_bad_submit_fn_keeps_actor(cluster):
    pool = ActorPool([_Doubler.remote()])
    with pytest.raises(AttributeError):
        pool.submit(lambda a, v: a.nonexistent.remote(v), 1)
    pool.submit(lambda a, v: a.double.remote(v), 4)
    assert pool.get_next() == 8


def test_async_actor_unpicklable_result_errors(cluster):
    """Unpicklable async results must reply with an error, not hang."""
    @rt.remote
    class A:
        async def bad(self):
            import threading
            return threading.Lock()  # unpicklable even by cloudpickle

        async def ok(self):
            return 5

    a = A.remote()
    assert rt.get(a.ok.remote(), timeout=30) == 5
    with pytest.raises(Exception):
        rt.get(a.bad.remote(), timeout=30)
    assert rt.get(a.ok.remote(), timeout=30) == 5
