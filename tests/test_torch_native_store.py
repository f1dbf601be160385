"""The port's native slab store (``ray_tpu_torch.native``: the C++
shared-memory small-object data plane), a mirror of
``tests/test_native_store.py``: its 11 cases against ``SlabStore`` and
``load_slab_lib`` of the port.

Reference parity: plasma store tests (src/ray/object_manager/plasma/,
SURVEY.md §4 C++ unit tests) — create/seal/get/delete semantics, capacity,
eviction candidates, multi-process attach, crash recovery.  Each store
is a segment of its own (pid and a random suffix), so the cases run in
any order and beside each other under ``-n``; the spawned children
import only ``ray_tpu_torch.native`` (ctypes, no torch).
"""

import multiprocessing as mp
import os
import signal
import time
import uuid

import pytest

from ray_tpu_torch.native import SlabStore, load_slab_lib

pytestmark = pytest.mark.skipif(
    load_slab_lib() is None, reason="native slab store unavailable (no g++?)")


@pytest.fixture
def store():
    path = f"/dev/shm/rtt_test_slab_{os.getpid()}_{uuid.uuid4().hex[:6]}"
    s = SlabStore.create(path, capacity_bytes=1 << 20, max_objects=256)
    assert s is not None
    yield s
    s.close()
    assert not os.path.exists(path)


def test_put_get_roundtrip(store):
    assert store.put("a", b"hello")
    assert store.get("a") == b"hello"
    assert store.exists("a")
    assert store.get("missing") is None
    assert not store.exists("missing")


def test_duplicate_put_rejected(store):
    assert store.put("a", b"x")
    assert not store.put("a", b"y")
    assert store.get("a") == b"x"


def test_delete_and_reuse(store):
    assert store.put("a", b"x" * 1000)
    assert store.delete("a")
    assert store.get("a") is None
    assert store.put("a", b"y" * 1000)  # id reusable after delete
    assert store.get("a") == b"y" * 1000


def test_empty_object(store):
    assert store.put("empty", b"")
    assert store.get("empty") == b""


def test_capacity_full_then_free(store):
    # fill most of the 1MB heap with 64KB objects
    n = 0
    while store.put(f"o{n}", b"z" * 65536):
        n += 1
    assert 8 <= n <= 16
    assert not store.put("overflow", b"z" * 65536)
    # freeing makes room again (coalescing must reassemble blocks)
    for i in range(n):
        assert store.delete(f"o{i}")
    assert store.put("big", b"z" * (700 * 1024))  # needs coalesced space
    assert len(store.get("big")) == 700 * 1024


def test_fragmentation_coalescing(store):
    # interleaved alloc/free pattern: freed neighbors must merge
    for i in range(10):
        assert store.put(f"f{i}", bytes([i]) * 50000)
    for i in range(0, 10, 2):
        assert store.delete(f"f{i}")
    for i in range(1, 10, 2):
        assert store.delete(f"f{i}")
    assert store.put("whole", b"w" * 900000)


def test_stats(store):
    store.put("a", b"x" * 100)
    store.get("a")
    store.get("nope")
    st = store.stats()
    assert st["num_objects"] == 1
    assert st["used"] == 100
    assert st["hits"] >= 1 and st["misses"] >= 1


def test_lru_victims(store):
    for i in range(4):
        store.put(f"v{i}", b"x" * 1000)
    store.get("v0")  # touch → v0 becomes most-recent
    victims = store.lru_victims(need_bytes=2000)
    assert victims == ["v1", "v2"]


def _attacher(path, q):
    s = SlabStore.attach(path)
    q.put(s.get("shared") if s else None)
    if s:
        s.put("from_child", b"child-data")
        s.close()


def test_multiprocess_attach(store):
    store.put("shared", b"cross-process")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_attacher, args=(store.path, q))
    p.start()
    got = q.get(timeout=30)
    p.join(timeout=10)
    assert got == b"cross-process"
    assert store.get("from_child") == b"child-data"


def _crash_mid_write(path):
    s = SlabStore.attach(path)
    # zero-copy create without seal = a writer dying mid-put
    s._lib.rtt_create(s._h, b"halfdone", 1000)
    os.kill(os.getpid(), signal.SIGKILL)


def test_dead_writer_reaped(store):
    """An unsealed object from a crashed writer is reaped, not leaked."""
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_crash_mid_write, args=(store.path,))
    p.start()
    p.join(timeout=30)
    # unsealed objects are never visible to readers
    assert store.get("halfdone") is None
    # the daemon's worker-death hook frees the dead writer's allocation
    deadline = time.time() + 5
    while time.time() < deadline and store.stats()["num_objects"] != 0:
        store.reap_dead()
        time.sleep(0.05)
    assert store.stats()["num_objects"] == 0
    assert store.stats()["used"] == 0


def test_many_objects_hash_table(store):
    for i in range(200):
        assert store.put(f"key-{i:04d}", f"value-{i}".encode())
    for i in range(0, 200, 3):
        assert store.delete(f"key-{i:04d}")
    for i in range(200):
        expect = None if i % 3 == 0 else f"value-{i}".encode()
        assert store.get(f"key-{i:04d}") == expect
