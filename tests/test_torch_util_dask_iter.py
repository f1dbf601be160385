"""The port's dask scheduler (``ray_dask_get``, the dask graph protocol
with no ``dask`` package) and ``ParallelIterator`` on its own runtime,
held to the reference's ``tests/test_util_dask_iter.py`` (all 7, every
assertion kept).

Tests share one cluster at ``num_cpus=4`` (``cluster``); the fixture kills
the shard actors a test leaves.  Functions here are pickled by value, so
spawned workers never import this module (nor JAX through it).
"""

import logging
import os
import sys
from operator import add, mul

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import worker as t_worker
from ray_tpu_torch.util import iter as rit
from ray_tpu_torch.util.dask import ray_dask_get

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


def test_dask_graph_executes_with_shared_deps(cluster):
    dsk = {
        "a": 1,
        "b": (add, "a", 2),            # 3
        "c": (mul, "b", "b"),          # 9 — 'b' computed once, shared
        "d": (add, (mul, "b", 10), "c"),  # 39 (nested task)
    }
    assert ray_dask_get(dsk, "d") == 39
    assert ray_dask_get(dsk, ["b", "c", ["a", "d"]]) == [3, 9, [1, 39]]


def test_dask_graph_cycle_detected(cluster):
    with pytest.raises(ValueError, match="cycle|unresolvable"):
        ray_dask_get({"x": (add, "y", 1), "y": (add, "x", 1)}, "x")


def test_parallel_iterator_for_each_gather_sync(cluster):
    it = rit.from_range(20, num_shards=3).for_each(lambda x: x * 2)
    assert sorted(it.gather_sync()) == [x * 2 for x in range(20)]


def test_parallel_iterator_chain_and_async(cluster):
    it = (rit.from_items(list(range(30)), num_shards=2)
          .filter(lambda x: x % 2 == 0)
          .for_each(lambda x: x + 1)
          .batch(4))
    batches = list(it.gather_async())
    flat = [x for b in batches for x in b]
    assert sorted(flat) == [x + 1 for x in range(0, 30, 2)]
    assert all(len(b) <= 4 for b in batches)


def test_parallel_iterator_take_and_shards(cluster):
    it = rit.from_range(100, num_shards=4)
    assert it.num_shards() == 4
    assert len(it.take(10)) == 10
    assert sorted(it) == list(range(100))


def test_dask_tuple_keys(cluster):
    """Collection-style tuple keys (('x', i)) — the ubiquitous dask
    chunk-key shape — must resolve as dependencies."""
    dsk = {
        ("x", 0): (add, 1, 2),
        ("x", 1): (add, 10, 20),
        "total": (add, ("x", 0), ("x", 1)),
    }
    assert ray_dask_get(dsk, "total") == 33
    assert ray_dask_get(dsk, [("x", 0), ("x", 1)]) == [3, 30]


def test_dask_key_nested_in_literal_tuple(cluster):
    """A key hiding inside a plain (non-task) tuple arg must be
    substituted at execution, not shipped raw — _deps_of and ev() must
    walk tuples identically (r3 advisor finding)."""
    def first_plus(pair, z):
        return pair[0] + z

    dsk = {
        "a": (add, 1, 2),
        # ("a", 99) is NOT a key — a literal tuple containing the key "a"
        "out": (first_plus, ("a", 99), 10),
    }
    assert ray_dask_get(dsk, "out") == 13
