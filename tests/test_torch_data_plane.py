"""The port's P2P data plane, held to the reference's
``tests/test_data_plane.py``: streamed zero-copy transfer, pooled
connections, parallel pulls, version negotiation, spool admission.

Unit-level against a live ``DataPlaneServer`` on loopback (the same
listener+HMAC stack the NodeAgent runs); the full multi-agent
integration paths live in tests/test_torch_multihost.py.
"""

import logging
import os
import threading
import time

import pytest

from ray_tpu_torch._private import data_plane as dp
from ray_tpu_torch._private import protocol, wire
from ray_tpu_torch._private.config import GLOBAL_CONFIG

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")


@pytest.fixture(scope="module", autouse=True)
def _logger():
    """``init`` stops the package logger's propagation: hand later
    modules the logger as it was."""
    from ray_tpu_torch._private import rtlog
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as rt
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4, num_gpus=0)
    yield
    rt.shutdown()


@pytest.fixture
def spool(tmp_path):
    return str(tmp_path / "spool")


@pytest.fixture
def server(spool):
    srv = dp.DataPlaneServer(spool, host="127.0.0.1",
                             advertise_host="127.0.0.1")
    yield srv
    srv.stop()


@pytest.fixture
def pool():
    p = dp.DataPlanePool()
    yield p
    p.close_all()


def _payload(n, seed=0):
    import numpy as np
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _wait_until(cond, timeout=5.0):
    """Serving counters land on the server thread AFTER the client's
    last byte arrives — poll briefly instead of asserting immediately."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


class _LegacySpoolServer:
    """Replica of the SEED data-plane protocol (request-per-chunk
    pickled dicts, no hello, no streaming) — a genuinely old holder for
    mixed-version tests, not a code-pathed flag on the new server."""

    def __init__(self, spool_dir):
        self.spool_dir = spool_dir
        self._listener = protocol.make_tcp_listener("127.0.0.1", 0)
        self.addr = f"tcp://127.0.0.1:{self._listener.address[1]}"
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True,
                         name="legacy-data-plane").start()

    def _accept(self):
        protocol.serve_accept_loop(self._listener, self._stop.is_set,
                                   self._serve, "legacy-data-plane-serve")

    def _serve(self, conn):
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                op = msg.get("op")
                path = dp.spool_path(self.spool_dir,
                                     msg.get("object_id", ""))
                try:
                    if op == "fetch_object":
                        conn.send({"size": path.stat().st_size})
                    elif op == "fetch_chunk":
                        with open(path, "rb") as f:
                            data = os.pread(f.fileno(), msg["length"],
                                            msg["offset"])
                        conn.send({"data": data})
                    elif op == "delete_object":
                        conn.send({})
                    else:
                        conn.send({"error": f"unknown op {op!r}"})
                except OSError:
                    conn.send({"error": "not found"})
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


# ------------------------------------------------------------ round trips
def test_streamed_pull_roundtrip(server, spool, pool):
    data = _payload(3_000_000)
    dp.write_spool(spool, "oid1", data)
    got = pool.pull(server.advertise_addr, "oid1", size=len(data))
    assert bytes(got) == data
    assert _wait_until(lambda: server.bytes_served >= len(data))
    assert server.objects_served >= 1


def test_streamed_pull_unknown_size(server, spool, pool):
    """size=None (meta without a size) single-streams off the ack."""
    data = _payload(500_000, seed=1)
    dp.write_spool(spool, "oid2", data)
    assert bytes(pool.pull(server.advertise_addr, "oid2")) == data


def test_inline_ack_fast_path(server, spool, pool, monkeypatch):
    """Ranges ≤ data_inline_pull_bytes ride the fetch_stream ack itself
    (one message round trip); the first byte above it streams frames."""
    def boom(self, conn, in_fd, offset, n, frame):
        raise AssertionError("small pull must not open a bulk stream")

    inline = GLOBAL_CONFIG.data_inline_pull_bytes
    small = _payload(inline, seed=20)
    big = _payload(inline + 1, seed=21)
    dp.write_spool(spool, "small", small)
    dp.write_spool(spool, "big1", big)
    monkeypatch.setattr(dp.DataPlaneServer, "_stream_raw", boom)
    got = pool.pull(server.advertise_addr, "small", size=inline)
    assert bytes(got) == small
    assert _wait_until(lambda: server.bytes_served == inline)
    monkeypatch.undo()
    got = pool.pull(server.advertise_addr, "big1", size=inline + 1)
    assert bytes(got) == big


def test_striped_parallel_pull(server, spool, pool, monkeypatch):
    monkeypatch.setattr(GLOBAL_CONFIG, "data_stripe_threshold_bytes",
                        1024 * 1024)
    data = _payload(20 * 1024 * 1024 + 12345, seed=2)  # odd size: bounds
    dp.write_spool(spool, "big", data)
    got = pool.pull(server.advertise_addr, "big", size=len(data))
    assert bytes(got) == data
    # striping opened parallel conns to the same holder
    assert pool.stats()["open"] >= 2
    # N stripes of one object count as ONE object served, all its bytes
    assert _wait_until(lambda: server.bytes_served == len(data))
    assert server.objects_served == 1


def test_multi_chunk_legacy_client_roundtrip(server, spool, monkeypatch):
    """A v0 puller (seed chunk protocol, no hello) against the new
    server: the old ops still answer chunk-by-chunk."""
    monkeypatch.setattr(GLOBAL_CONFIG, "transfer_chunk_bytes", 64 * 1024)
    data = _payload(300_000, seed=3)
    dp.write_spool(spool, "oid3", data)
    conn = protocol.connect_tcp(
        *protocol.parse_tcp_addr(server.advertise_addr), timeout=5.0)
    try:
        got = dp._pull_chunks(conn, "oid3")
        assert bytes(got) == data
        # multiple chunks actually flowed
        assert len(data) // (64 * 1024) >= 2
    finally:
        conn.close()


def test_mixed_version_legacy_server(spool, pool, monkeypatch):
    """New pool puller against a genuinely old holder: the hello gets
    unknown-op, the pool degrades to the chunk protocol (still pooled)."""
    monkeypatch.setattr(GLOBAL_CONFIG, "transfer_chunk_bytes", 64 * 1024)
    srv = _LegacySpoolServer(spool)
    try:
        os.makedirs(spool, exist_ok=True)
        data = _payload(256 * 1024, seed=4)
        dp.write_spool(spool, "oldie", data)
        assert bytes(pool.pull(srv.addr, "oldie", size=len(data))) == data
        # negotiated version cached as legacy
        assert pool._proto[srv.addr] == 0
        # second pull reuses the pooled conn on the chunk path
        assert bytes(pool.pull(srv.addr, "oldie", size=len(data))) == data
    finally:
        srv.stop()


def test_stale_v1_cache_downgrades_to_chunks(spool, pool, monkeypatch):
    """A cached-v1 address that now speaks v0 (holder restarted onto an
    older build): fetch_stream's unknown-op error downgrades the cache
    and the pull retries chunked on the SAME connection."""
    monkeypatch.setattr(GLOBAL_CONFIG, "transfer_chunk_bytes", 64 * 1024)
    srv = _LegacySpoolServer(spool)
    try:
        os.makedirs(spool, exist_ok=True)
        data = _payload(200_000, seed=5)
        dp.write_spool(spool, "o", data)
        pool.set_proto(srv.addr, 1)  # stale belief: peer speaks v1
        assert bytes(pool.pull(srv.addr, "o", size=len(data))) == data
        assert pool._proto[srv.addr] == 0
    finally:
        srv.stop()


def test_data_proto_hello_negotiation(server):
    conn = protocol.connect_tcp(
        *protocol.parse_tcp_addr(server.advertise_addr), timeout=5.0)
    try:
        conn.send({"op": "__proto_hello__",
                   "versions": [wire.DATA_PROTO_MIN, wire.DATA_PROTO_MAX]})
        assert conn.recv()["proto"] == wire.DATA_PROTO_MAX
        # a nonsense advertisement is rejected, conn stays usable
        conn.send({"op": "__proto_hello__", "versions": [-1]})
        assert "error" in conn.recv()
        conn.send({"op": "__proto_hello__", "versions": [0]})
        assert conn.recv()["proto"] == 0
    finally:
        conn.close()


# ------------------------------------------------------- pool lifecycle
def test_pool_reuses_connection(server, spool, pool):
    data = _payload(100_000, seed=6)
    dp.write_spool(spool, "r", data)
    for _ in range(5):
        assert bytes(pool.pull(server.advertise_addr, "r",
                               size=len(data))) == data
    # 5 pulls, ONE dial+HMAC handshake
    assert server.conns_accepted == 1
    assert pool.stats() == {"open": 1, "idle": 1}


def test_pool_invalidation_after_peer_death(server, spool, pool):
    data = _payload(50_000, seed=7)
    dp.write_spool(spool, "d", data)
    addr = server.advertise_addr
    assert bytes(pool.pull(addr, "d", size=len(data))) == data
    assert pool.stats()["open"] == 1
    server.stop()
    time.sleep(0.1)
    with pytest.raises((OSError, EOFError, ConnectionError)):
        pool.pull(addr, "d", size=len(data))
    # the broken conn was discarded and the address invalidated
    assert pool.stats() == {"open": 0, "idle": 0}
    assert addr not in pool._proto


def test_pool_lru_bound(server, spool, pool, monkeypatch):
    monkeypatch.setattr(GLOBAL_CONFIG, "data_pool_max_conns", 2)
    monkeypatch.setattr(GLOBAL_CONFIG, "data_stripe_threshold_bytes",
                        1024 * 1024)
    monkeypatch.setattr(GLOBAL_CONFIG, "data_stripe_streams", 4)
    data = _payload(33 * 1024 * 1024, seed=8)  # 33MB: 4-way stripes
    dp.write_spool(spool, "l", data)
    assert bytes(pool.pull(server.advertise_addr, "l",
                           size=len(data))) == data
    # the striped pull opened up to 4 conns; idles beyond the bound closed
    st = pool.stats()
    assert st["idle"] <= 2 and st["open"] == st["idle"]


def test_pull_miss_keeps_conn_pooled(server, spool, pool):
    data = _payload(10_000, seed=9)
    dp.write_spool(spool, "m", data)
    assert bytes(pool.pull(server.advertise_addr, "m",
                           size=len(data))) == data
    with pytest.raises(FileNotFoundError):
        pool.pull(server.advertise_addr, "never-spooled", size=10)
    # a clean miss must not burn the pooled connection
    assert pool.stats() == {"open": 1, "idle": 1}
    assert bytes(pool.pull(server.advertise_addr, "m",
                           size=len(data))) == data
    assert server.conns_accepted == 1


# ------------------------------------------------------------- races
def test_pull_racing_concurrent_delete(server, spool, pool, monkeypatch):
    """delete_object racing a pull: every pull either returns the full
    correct bytes (the server's open fd outlives the unlink) or raises a
    clean FileNotFoundError — never truncated data, never a hang."""
    monkeypatch.setattr(GLOBAL_CONFIG, "data_stream_frame_bytes",
                        64 * 1024)
    addr = server.advertise_addr
    data = _payload(2 * 1024 * 1024, seed=10)
    results = []

    def one_round(i):
        oid = f"race{i}"
        dp.write_spool(spool, oid, data)
        started = threading.Event()

        def puller():
            started.wait()
            try:
                got = pool.pull(addr, oid, size=len(data))
                results.append(bytes(got) == data)
            except FileNotFoundError:
                results.append("miss")

        t = threading.Thread(target=puller, daemon=True,
                             name="race-puller")
        t.start()
        started.set()
        pool.delete_batch(addr, [oid])
        t.join(30)
        assert not t.is_alive(), "pull hung against concurrent delete"

    for i in range(5):
        one_round(i)
    assert results and all(r is True or r == "miss" for r in results)


# ---------------------------------------------------------- spool writes
def test_concurrent_spool_admission_under_flock(spool):
    """N producers racing the admission check must never overshoot the
    capacity: the flock serializes scan+reserve, so exactly the writes
    that fit are admitted and the rest raise ObjectStoreFullError."""
    from ray_tpu_torch.exceptions import ObjectStoreFullError
    os.makedirs(spool, exist_ok=True)
    os.environ["RTT_SPOOL_CAPACITY_MB"] = "1"  # 1 MiB cap
    try:
        piece = b"y" * (300 * 1024)  # 300 KiB → at most 3 fit
        outcomes = []

        def write(i):
            try:
                dp.write_spool(spool, f"w{i}", piece)
                outcomes.append("ok")
            except ObjectStoreFullError:
                outcomes.append("full")

        threads = [threading.Thread(target=write, args=(i,), daemon=True,
                                    name="spool-writer") for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert outcomes.count("ok") == 3, outcomes
        used = sum(f.stat().st_size for f in os.scandir(spool)
                   if f.name != ".admission.lock")
        assert used <= 1024 * 1024
    finally:
        del os.environ["RTT_SPOOL_CAPACITY_MB"]


def test_write_spool_value_writev_layout(spool):
    """The writev producer path lays down byte-identical wire format to
    the in-memory assembler, and admission failures roll back cleanly."""
    import numpy as np
    from ray_tpu_torch._private.serialization import serialize, to_wire_bytes
    os.makedirs(spool, exist_ok=True)
    value = {"a": np.arange(70_000, dtype=np.float64),
             "b": np.asfortranarray(np.ones((100, 50), dtype=np.float32))}
    pickled, buffers, _ = serialize(value)
    expect = bytes(to_wire_bytes(pickled, buffers))
    n = dp.write_spool_value(spool, "wv", pickled, buffers)
    got = dp.spool_path(spool, "wv").read_bytes()
    assert n == len(expect) and got == expect
    # round-trips through deserialization
    from ray_tpu_torch._private.serialization import deserialize_from
    out = deserialize_from(memoryview(got))
    np.testing.assert_array_equal(out["a"], value["a"])
    np.testing.assert_array_equal(out["b"], value["b"])


def test_failed_spool_write_releases_reservation(spool):
    os.makedirs(spool, exist_ok=True)
    os.environ["RTT_SPOOL_CAPACITY_MB"] = "1"
    try:
        class Boom:
            def __len__(self):
                return 100 * 1024

            def __bytes__(self):
                raise RuntimeError("boom")
        # bytes-like that fails mid-write: file.write(Boom()) raises
        with pytest.raises(TypeError):
            dp.write_spool(spool, "boom", Boom())
        # the .tmp reservation is gone → the full capacity is available
        dp.write_spool(spool, "fine", b"z" * (900 * 1024))
    finally:
        del os.environ["RTT_SPOOL_CAPACITY_MB"]


# --------------------------------------------------- delete-path bounds
def test_delete_batch_bounded_on_dead_peer(pool):
    """A dead peer costs one dial timeout for the whole batch, not one
    per object (the seed redialed per remaining object: O(N x 3s))."""
    # a listener that accepts nothing: dial will fail fast (refused)
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # port now closed → connection refused immediately
    t0 = time.monotonic()
    pool.delete_batch(f"tcp://127.0.0.1:{port}",
                      [f"o{i}" for i in range(64)])
    assert time.monotonic() - t0 < 5.0


def test_delete_batch_bounded_on_dying_peer(spool):
    """A peer that answers the dial but kills every connection after one
    op is bounded by max_redials, not by the batch length (the seed paid
    a fresh dial per remaining object)."""
    dials = []

    class Dying:
        def __init__(self):
            self._listener = protocol.make_tcp_listener("127.0.0.1", 0)
            self.addr = f"tcp://127.0.0.1:{self._listener.address[1]}"
            self._stop = threading.Event()
            threading.Thread(target=self._accept, daemon=True,
                             name="dying-peer").start()

        def _accept(self):
            protocol.serve_accept_loop(self._listener, self._stop.is_set,
                                       self._serve, "dying-peer-serve")

        def _serve(self, conn):
            dials.append(1)
            try:
                msg = conn.recv()
                if msg.get("op") == "__proto_hello__":
                    conn.send({"proto": wire.DATA_PROTO_MAX})
                    conn.recv()  # the first delete op
            except (EOFError, OSError):
                pass
            conn.close()  # die mid-batch, every time

        def stop(self):
            self._stop.set()
            try:
                self._listener.close()
            except OSError:
                pass

    peer = Dying()
    try:
        pool = dp.DataPlanePool()
        pool.delete_batch(peer.addr, [f"o{i}" for i in range(200)],
                          max_redials=2)
        assert len(dials) <= 5  # initial dial + bounded redials
        pool.close_all()
    finally:
        peer.stop()


# ------------------------------------------------- relay fallback (worker)
def test_worker_relay_fallback_on_unreachable_holder(ray_start_regular):
    """A meta that names an unreachable holder must fall back to the
    head-relay path and still materialize the object."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    arr = np.arange(200_000, dtype=np.float64)
    ref = rt.put(arr)
    oid = str(ref.id)
    # closed port: the direct pull dials, fails, falls back to the head
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    meta = {"state": "ready", "loc": "remote", "addr": dead,
            "node_id": "not-this-node", "size": None}
    t0 = time.monotonic()
    out = w._materialize_value(oid, meta)
    assert time.monotonic() - t0 < 30
    np.testing.assert_array_equal(out, arr)


def test_server_stats_concurrent_pulls(server, spool, monkeypatch):
    """stats counters stay exact under N concurrent serving threads
    (the seed's unlocked += dropped updates)."""
    monkeypatch.setattr(GLOBAL_CONFIG, "data_stream_frame_bytes",
                        32 * 1024)
    monkeypatch.setattr(GLOBAL_CONFIG, "data_inline_pull_bytes", 0)
    data = _payload(128 * 1024, seed=11)
    n_threads, n_pulls = 4, 8
    for i in range(n_threads):
        dp.write_spool(spool, f"s{i}", data)
    pools = [dp.DataPlanePool() for _ in range(n_threads)]

    def hammer(k):
        for _ in range(n_pulls):
            got = pools[k].pull(server.advertise_addr, f"s{k}",
                                size=len(data))
            assert bytes(got) == data

    threads = [threading.Thread(target=hammer, args=(i,), daemon=True,
                                name="stats-hammer") for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for p in pools:
        p.close_all()
    assert _wait_until(
        lambda: server.objects_served == n_threads * n_pulls)
    assert server.bytes_served == n_threads * n_pulls * len(data)


def test_pull_buffer_cache_reuse_and_isolation(server, spool, pool):
    """A dropped pull buffer is recycled for the next large pull (pages
    stay faulted-in — the allocation cost is the dominant term of a
    large pull); a buffer the consumer still holds is NEVER reused."""
    n = 2 * 1024 * 1024
    a_bytes, b_bytes = _payload(n, seed=1), _payload(n, seed=2)
    dp.write_spool(spool, "a", a_bytes)
    dp.write_spool(spool, "b", b_bytes)
    addr = server.advertise_addr

    got_a = pool.pull(addr, "a", size=n)
    assert bytes(got_a) == a_bytes
    # consumer still holds got_a: the next pull must get its own buffer
    got_b = pool.pull(addr, "b", size=n)
    assert bytes(got_b) == b_bytes
    assert bytes(got_a) == a_bytes  # not clobbered by the second pull
    # drop both; the next pull recycles a cached buffer and the content
    # is exactly the new object's bytes
    del got_a, got_b
    got_a2 = pool.pull(addr, "a", size=n)
    assert bytes(got_a2) == a_bytes


def test_pull_buffer_cache_view_pins_buffer(server, spool, pool):
    """A live memoryview into a dropped pull buffer still pins it
    (views own a reference to the base object) — the cache must not
    hand the pages to a concurrent pull."""
    n = 2 * 1024 * 1024
    a_bytes, b_bytes = _payload(n, seed=3), _payload(n, seed=4)
    dp.write_spool(spool, "va", a_bytes)
    dp.write_spool(spool, "vb", b_bytes)
    addr = server.advertise_addr

    view = memoryview(pool.pull(addr, "va", size=n))  # buffer itself dropped
    got_b = pool.pull(addr, "vb", size=n)
    assert bytes(got_b) == b_bytes
    assert bytes(view) == a_bytes  # view intact: buffer was not recycled


def test_spool_fd_cache_serves_repeats_and_misses_after_delete(
        server, spool, pool):
    """Repeated streamed pulls ride the server's spool-fd cache; a
    delete invalidates the cached fd so later fetches miss instead of
    serving the unlinked inode."""
    data = _payload(256 * 1024, seed=5)
    dp.write_spool(spool, "fd1", data)
    addr = server.advertise_addr
    for _ in range(3):
        assert bytes(pool.pull(addr, "fd1", size=len(data))) == data
    pool.delete_batch(addr, ["fd1"])
    with pytest.raises(FileNotFoundError):
        pool.pull(addr, "fd1", size=len(data))
