"""Replicated GCS ledger: WAL + streaming replication + warm standby.

Reference analog: GCS fault tolerance via external Redis persistence +
reconnecting clients (SURVEY.md §5.3).  PR 8 made the GCS a *ledger*
raylets reconcile against across restarts; until this module its
durability was a debounced pickle snapshot (`gcs._persist_loop`, ~0.5s
crash window, no fsync) and recovery meant manually booting a new head
over the same session dir.  This module closes both gaps (DESIGN.md
§4l):

- **Write-ahead log.**  Every durable ledger mutation (KV puts/deletes,
  function exports, actor/named-actor/PG transitions, shm object-meta
  seals/deletes, driver registrations) is captured at the GCS handler
  layer as one idempotent table *op* and appended — crc-framed, fsynced
  in drain batches — to ``<session>/gcs_state/wal-<epoch>-<seq>.log``.
  A head restart replays the WAL tail on top of the newest good
  snapshot, so the crash window shrinks from the snapshot debounce to
  one drain batch.  Replay is idempotent by construction (every op is a
  keyed upsert/delete), a torn tail record is ignored, and a corrupt
  mid-file record quarantines the segment.
- **Warm standby.**  A :class:`StandbyHead` dials the primary's GCS
  socket, negotiates ``wire.PROTO_REPL`` and converts the connection
  into a one-way replication stream (``repl_attach``): first a full
  durable-state snapshot (``repl_snapshot``), then incremental
  ``repl_wal`` record batches the standby applies into live tables,
  periodic ``repl_heartbeat`` liveness, and ``repl_tsdb`` metric-ring
  deltas so the head's 48h memory survives it.  On primary death
  (stream EOF with the endpoint dead, or missed heartbeats) the standby
  *promotes*: it writes its tables as a snapshot, replays any WAL tail
  the dead primary fsynced but never streamed, and boots a real
  :class:`~ray_tpu_torch._private.gcs.GcsServer` over the session dir — the
  listener re-binds the same ``gcs.sock`` path, so raylets re-attach
  via the PR-8 path and clients/workers re-dial through their bounded-
  backoff reconnects with zero task loss.
- **Split-brain guard.**  Every head start claims the next *ledger
  epoch* in ``<session>/gcs_state/epoch`` (fsynced).  The primary's
  replication drain thread polls the file at the heartbeat cadence; the
  moment it observes a HIGHER epoch than its own it fences the server —
  a fenced GCS refuses every mutating RPC, so a promoted standby can
  never race a still-alive old primary for the ledger.

Locking (``REPL_LOCK_DAG`` in lock_watchdog.py; rtlint-enforced): the
hub's one no-block leaf ``_lock`` guards only the seq counter, the
record buffer, and the adoption queue — GCS handler threads append
under it in O(1) while holding GCS locks; all file I/O and every
standby send happen on the single ``gcs-repl`` drain thread with no
lock held.
"""

from __future__ import annotations

import binascii
import os
import pickle
import struct
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import lock_watchdog, protocol, rtlog, wire

logger = rtlog.get("replication")


class ReplUnsupported(ConnectionError):
    """The primary does not speak wire.PROTO_REPL."""

# WAL segment header: magic + u64 ledger epoch + u64 first record seq.
_WAL_MAGIC = b"RTWAL1\n\0"
_WAL_HDR = struct.Struct(">QQ")
# record framing: u32 payload length + u32 crc32(payload); payload is
# pickle.dumps((seq, op))
_REC_HDR = struct.Struct(">II")
_REC_MAX = 64 * 1024 * 1024  # a saner-than-u32 bound on one record


# --------------------------------------------------------------- ledger ops
# One op = one idempotent upsert/delete on the durable tables — the same
# set ``gcs._capture_durable_state`` snapshots.  Applying an op twice is
# identical to applying it once, which is what makes snapshot+WAL replay
# and at-least-once streaming safe without coordination:
#   ("kv", ns, key, value|None)         value None deletes
#   ("fn", fn_id, blob)
#   ("actor", actor_id, rec|None)       rec as snapshotted; None = gone
#   ("named", namespace, name, aid|None)
#   ("pg", pg_id, rec|None)
#   ("shm", oid, size|None)
#   ("driver", worker_id)


def new_ledger_state() -> Dict[str, Any]:
    """Empty durable-table state, shaped exactly like the snapshot dict
    ``gcs._capture_durable_state`` produces (minus the wal bookkeeping
    keys) so the two compare directly in the equivalence oracle."""
    return {"kv": {}, "functions": {}, "named_actors": {}, "actors": {},
            "pgs": {}, "shm_objects": {}, "driver_ids": set()}


def apply_op(state: Dict[str, Any], op: Tuple) -> None:
    """Apply one ledger op to a state dict (idempotent upsert/delete)."""
    kind = op[0]
    if kind == "kv":
        _, ns, key, value = op
        table = state["kv"].setdefault(ns, {})
        if value is None:
            table.pop(key, None)
            if not table:
                state["kv"].pop(ns, None)
        else:
            table[key] = value
    elif kind == "fn":
        state["functions"][op[1]] = op[2]
    elif kind == "actor":
        _, aid, rec = op
        if rec is None:
            state["actors"].pop(aid, None)
        else:
            state["actors"][aid] = rec
    elif kind == "named":
        _, ns, name, aid = op
        if aid is None:
            state["named_actors"].pop((ns, name), None)
        else:
            state["named_actors"][(ns, name)] = aid
    elif kind == "pg":
        _, pid, rec = op
        if rec is None:
            state["pgs"].pop(pid, None)
        else:
            state["pgs"][pid] = rec
    elif kind == "shm":
        _, oid, size = op
        if size is None:
            state["shm_objects"].pop(oid, None)
        else:
            state["shm_objects"][oid] = size
    elif kind == "driver":
        state["driver_ids"].add(op[1])
    else:
        raise ValueError(f"unknown ledger op kind {kind!r}")


# ------------------------------------------------------------ epoch fence
def gcs_state_dir(session_path) -> Path:
    return Path(session_path) / "gcs_state"


def _epoch_path(session_path) -> Path:
    return gcs_state_dir(session_path) / "epoch"


def read_epoch(session_path) -> int:
    try:
        return int(_epoch_path(session_path).read_text().strip() or 0)
    except (FileNotFoundError, ValueError):
        return 0


def claim_epoch(session_path) -> int:
    """Claim the next ledger epoch (fsynced tmp + rename so a crash can
    never leave a torn epoch file).  Called once per head start; any
    still-alive older head observes the bump and fences itself.

    The read-increment-write runs under an exclusive flock on a
    sidecar lock file: a standby auto-promoting at the same moment an
    operator manually boots a replacement head must NOT both claim the
    same epoch — equal epochs would fence neither (the guard fires
    only on a strictly higher value) and the two heads would interleave
    ledgers in one namespace."""
    import fcntl
    path = _epoch_path(session_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lock_fd = os.open(str(path.with_suffix(".lock")),
                      os.O_CREAT | os.O_RDWR, 0o600)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
        epoch = read_epoch(session_path) + 1
        tmp = path.with_suffix(".tmp")
        fd = os.open(str(tmp), os.O_CREAT | os.O_TRUNC | os.O_WRONLY,
                     0o600)
        try:
            os.write(fd, str(epoch).encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        _fsync_dir(path.parent)
        return epoch
    finally:
        os.close(lock_fd)  # releases the flock


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a rename into it survives a host crash."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ------------------------------------------------------- snapshot on disk
def write_snapshot_file(snapshot_path: Path, state: Dict[str, Any]) -> None:
    """Write the durable-state snapshot crash-safely: fsync the tmp file
    BEFORE the rename and the directory after it (os.replace alone can
    leave a zero-length "newest" snapshot after a host crash), and keep
    the previous generation as ``<name>.prev`` so a torn newest file
    degrades to stale-but-consistent instead of fresh-start."""
    snapshot_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = snapshot_path.with_suffix(".tmp")
    fd = os.open(str(tmp), os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o600)
    try:
        os.write(fd, pickle.dumps(state))
        os.fsync(fd)
    finally:
        os.close(fd)
    prev = snapshot_path.with_name(snapshot_path.name + ".prev")
    try:
        os.replace(snapshot_path, prev)  # demote the old generation
    except FileNotFoundError:
        pass
    os.replace(tmp, snapshot_path)
    _fsync_dir(snapshot_path.parent)


def _load_snapshot(path: Path) -> Optional[Dict[str, Any]]:
    try:
        raw = path.read_bytes()
        if not raw:
            raise ValueError("zero-length snapshot")
        state = pickle.loads(raw)
        if not isinstance(state, dict) or "kv" not in state:
            raise ValueError("snapshot missing durable tables")
        return state
    except FileNotFoundError:
        return None
    except Exception:  # noqa: BLE001 - torn/corrupt generation
        logger.exception("unreadable snapshot %s", path)
        return None


def load_durable_state(session_path,
                       snapshot_path: Optional[Path] = None
                       ) -> Optional[Dict[str, Any]]:
    """Newest consistent durable state: the newest readable snapshot
    generation (torn newest falls back to ``.prev`` instead of fresh
    start) plus the fsynced WAL tail of the snapshot's ledger epoch
    replayed on top (records with seq > the snapshot's ``wal_seq``).
    Returns None when no generation is readable (fresh start)."""
    if snapshot_path is None:
        snapshot_path = gcs_state_dir(session_path) / "snapshot.pkl"
    state = _load_snapshot(snapshot_path)
    if state is None:
        prev = snapshot_path.with_name(snapshot_path.name + ".prev")
        state = _load_snapshot(prev)
        if state is None:
            # no snapshot generation at all: a head that died before
            # its FIRST snapshot write.  Its WAL is genesis-complete
            # (rotation only ever deletes segments a successful
            # snapshot covered), so replay reconstructs everything.
            return _replay_genesis(session_path)
        logger.warning("newest snapshot unreadable; restored the "
                       "previous generation %s", prev)
    epoch = int(state.get("ledger_epoch") or 0)
    base_seq = int(state.get("wal_seq") or 0)
    applied = 0
    corrupt = False
    # The snapshot's own epoch tail first, then every HIGHER epoch
    # ascending: a successor head that restored this same state,
    # claimed epoch+k, served fsynced mutations, and died before its
    # FIRST snapshot write left its whole ledger delta only in its own
    # epoch's WAL.  Chaining is sound because each such successor's
    # boot state was exactly the replay reconstructed so far; a
    # higher-epoch log not starting at seq 1 contradicts that (its own
    # snapshot existed once and is lost) and stops the chain there.
    epochs = sorted({_segment_epoch(p) for p in wal_segments(session_path)
                     if _segment_epoch(p) >= epoch} | {epoch})
    for ep in epochs:
        if corrupt:
            break  # records past a corrupt region may depend on the gap
        segs = wal_segments(session_path, ep)
        if ep > epoch and segs:
            raw0 = segs[0].read_bytes()
            first_start = _WAL_HDR.unpack_from(raw0, len(_WAL_MAGIC))[1] \
                if len(raw0) >= len(_WAL_MAGIC) + _WAL_HDR.size else 1
            if first_start != 1:
                logger.error("epoch %d WAL starts at seq %d with no "
                             "epoch-%d snapshot: stopping the replay "
                             "chain here", ep, first_start, ep)
                break
        for seg in segs:
            records, clean = read_wal_records(seg)
            for seq, op in records:
                if ep == epoch and seq <= base_seq:
                    continue  # covered by the snapshot
                try:
                    apply_op(state, op)
                    applied += 1
                except Exception:  # noqa: BLE001 - one undecodable op
                    # must not discard the rest of the consistent prefix
                    logger.exception("WAL op replay failed (seq %d)",
                                     seq)
            if not clean:
                quarantine_wal(seg)
                corrupt = True
                break
    if applied:
        logger.info("replayed %d WAL record(s) on top of the snapshot",
                    applied)
    return state


def _replay_genesis(session_path) -> Optional[Dict[str, Any]]:
    """Durable state with NO readable snapshot generation: replay every
    epoch's WAL from empty, ascending.  Sound because (a) each head that
    found no snapshot restored exactly this replay of the epochs before
    it, so consecutive epochs' logs compose, and (b) rotation only
    deletes segments after a snapshot write SUCCEEDED — no snapshot on
    disk means no segment was ever dropped.  A first segment that does
    not start at seq 1 contradicts (b) (a snapshot existed and was
    lost): bail to fresh-start rather than restore a state with a
    silent hole."""
    by_epoch: Dict[int, List[Path]] = {}
    for seg in wal_segments(session_path):
        by_epoch.setdefault(_segment_epoch(seg), []).append(seg)
    if not by_epoch:
        return None
    state = new_ledger_state()
    last_epoch = 0
    last_seq = 0
    corrupt = False
    for epoch in sorted(by_epoch):
        if corrupt:
            break  # later epochs build on the gapped prefix: stop
        segs = by_epoch[epoch]
        raw0 = segs[0].read_bytes()
        first_start = _WAL_HDR.unpack_from(raw0, len(_WAL_MAGIC))[1] \
            if len(raw0) >= len(_WAL_MAGIC) + _WAL_HDR.size else 1
        if first_start != 1:
            logger.error("no snapshot but epoch %d WAL starts at seq "
                         "%d: a covered prefix was lost — refusing a "
                         "holey restore", epoch, first_start)
            return None
        for seg in segs:
            records, clean = read_wal_records(seg)
            for seq, op in records:
                try:
                    apply_op(state, op)
                except Exception:  # noqa: BLE001 - keep the prefix
                    logger.exception("WAL op replay failed (seq %d)",
                                     seq)
                last_seq = int(seq)
            last_epoch = epoch
            if not clean:
                quarantine_wal(seg)
                corrupt = True
                break
    state["ledger_epoch"] = last_epoch
    state["wal_seq"] = last_seq
    logger.info("restored durable state from genesis WAL replay "
                "(epoch %d, seq %d)", last_epoch, last_seq)
    return state


# ----------------------------------------------------------------- WAL files
def _segment_epoch(path: Path) -> int:
    """Ledger epoch encoded in a WAL segment's file name."""
    try:
        return int(path.name[4:-4].split("-")[0])
    except (ValueError, IndexError):
        return 0


def wal_segment_path(session_path, epoch: int, start_seq: int) -> Path:
    return gcs_state_dir(session_path) / f"wal-{epoch:08d}-{start_seq:012d}.log"


def wal_segments(session_path, epoch: Optional[int] = None) -> List[Path]:
    """WAL segment files (of one ledger epoch, or all), start-seq order."""
    out = []
    try:
        names = os.listdir(str(gcs_state_dir(session_path)))
    except FileNotFoundError:
        return []
    for name in names:
        if not (name.startswith("wal-") and name.endswith(".log")):
            continue
        parts = name[4:-4].split("-")
        if len(parts) != 2:
            continue
        try:
            e, s = int(parts[0]), int(parts[1])
        except ValueError:
            continue
        if epoch is None or e == epoch:
            out.append((e, s, gcs_state_dir(session_path) / name))
    out.sort()
    return [p for _, _, p in out]


def encode_wal_record(seq: int, op: Tuple) -> bytes:
    payload = pickle.dumps((seq, op), protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > _REC_MAX:
        # the READER treats length > _REC_MAX as corruption; an
        # unwritable-size record must fail HERE (the drain batch skips
        # it with a log, like an unpicklable op) — appending it would
        # quarantine the whole segment at the next replay
        raise ValueError(f"WAL record of {len(payload)} bytes exceeds "
                         f"the {_REC_MAX} byte bound")
    return _REC_HDR.pack(len(payload),
                         binascii.crc32(payload) & 0xFFFFFFFF) + payload


def read_wal_records(path: Path) -> Tuple[List[Tuple[int, Tuple]], bool]:
    """Decode one WAL segment → (records, clean).

    ``clean`` is False only for genuine CORRUPTION: a complete record
    whose crc fails, a bad header, or an impossible length.  A record
    truncated at EOF is a *torn tail* — the expected artifact of a crash
    mid-append — and stops the read silently (clean stays True).
    Decoding stops at the first bad record either way; the consistent
    prefix is all a replayer may trust."""
    records: List[Tuple[int, Tuple]] = []
    try:
        raw = path.read_bytes()
    except OSError:
        return records, False
    hdr_len = len(_WAL_MAGIC) + _WAL_HDR.size
    if len(raw) < hdr_len:
        # a header torn mid-write: an empty segment, not corruption
        return records, len(raw) == 0 or _WAL_MAGIC.startswith(raw[:8])
    if raw[:len(_WAL_MAGIC)] != _WAL_MAGIC:
        return records, False
    off = hdr_len
    n = len(raw)
    while off < n:
        if off + _REC_HDR.size > n:
            return records, True  # torn tail: header cut at EOF
        length, crc = _REC_HDR.unpack_from(raw, off)
        if length > _REC_MAX:
            return records, False
        if off + _REC_HDR.size + length > n:
            return records, True  # torn tail: payload cut at EOF
        payload = raw[off + _REC_HDR.size:off + _REC_HDR.size + length]
        if binascii.crc32(payload) & 0xFFFFFFFF != crc:
            return records, False  # complete record, bad crc: corrupt
        try:
            seq, op = pickle.loads(payload)
            records.append((int(seq), tuple(op)))
        except Exception:  # noqa: BLE001 - crc passed but undecodable
            return records, False
        off += _REC_HDR.size + length
    return records, True


def quarantine_wal(path: Path) -> Optional[Path]:
    """Move a corrupt WAL segment aside (kept for forensics, never
    replayed again)."""
    target = path.with_name(path.name + f".corrupt-{int(time.time())}")
    try:
        os.replace(path, target)
        logger.error("quarantined corrupt WAL segment %s -> %s",
                     path.name, target.name)
        return target
    except OSError:
        return None


# ------------------------------------------------------------------- the hub
class ReplicationHub:
    """Primary-side replication: WAL appends + standby streaming.

    Handler threads call :meth:`record` (O(1) buffer append under the
    no-block leaf ``_lock``, legal under any GCS lock); the single
    ``gcs-repl`` drain thread owns every file write, fsync, and standby
    send, plus heartbeats, TSDB-delta shipping, WAL rotation, and the
    split-brain epoch-fence poll."""

    def __init__(self, session_path, epoch: int,
                 snapshot_cb: Callable[[], Dict[str, Any]],
                 tsdb_export_cb: Optional[Callable[[], Any]] = None,
                 on_fenced: Optional[Callable[[int], None]] = None,
                 fsync: bool = True):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        self.session_path = Path(session_path)
        self.epoch = int(epoch)
        self._snapshot_cb = snapshot_cb
        self._tsdb_export_cb = tsdb_export_cb
        self._on_fenced = on_fenced
        self._fsync = fsync
        self._hb_period = max(0.05, GLOBAL_CONFIG.gcs_repl_heartbeat_s)
        self._tsdb_period = max(self._hb_period,
                                GLOBAL_CONFIG.gcs_repl_tsdb_interval_s)
        self._lock = threading.Lock()  # no-block leaf (REPL_LOCK_DAG)
        self._seq = 0                        # guarded by: _lock
        self._buf: List[Tuple[int, Tuple]] = []  # guarded by: _lock
        self._pending_conns: List = []       # guarded by: _lock
        self._rotate_to: Optional[int] = None  # guarded by: _lock
        self._records_total = 0              # guarded by: _lock
        # drain-thread-owned state (single owner, never locked):
        self._standbys: List = []
        self._segments: List[Tuple[int, int, Path]] = []  # (start, last, p)
        self._wal_fd: Optional[int] = None
        self._wal_start = 1
        self._wal_last = 0
        self._tsdb_cursor = 0.0
        self._last_tsdb = 0.0
        self.fenced = False
        self._stop = threading.Event()
        self._event = threading.Event()
        self._open_segment(1)
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="gcs-repl", daemon=True)
        self._thread.start()

    # ------------------------------------------------------- handler side
    def record(self, *op) -> int:
        """Append one ledger op (called by GCS handler threads, any GCS
        lock held — O(1), never blocks)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._buf.append((seq, tuple(op)))
            self._records_total += 1
        self._event.set()
        return seq

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def adopt_standby(self, conn) -> None:  # rtlint: owns(conn)
        """Hand an attached (``repl_attach``) connection to the drain
        thread, which bootstraps it with a snapshot and streams from
        there.  The hub owns the conn from here on."""
        with self._lock:
            self._pending_conns.append(conn)
        self._event.set()

    def rotate(self, covered_seq: int) -> None:
        """A durable snapshot covering records <= ``covered_seq`` was
        written: the drain thread rolls to a fresh segment and unlinks
        fully-covered ones."""
        with self._lock:
            self._rotate_to = max(covered_seq, self._rotate_to or 0)
        self._event.set()

    def info(self) -> Dict[str, Any]:
        with self._lock:
            return {"epoch": self.epoch, "seq": self._seq,
                    "records_total": self._records_total,
                    "standbys": len(self._standbys),
                    "fenced": self.fenced}

    def close(self) -> None:
        self._stop.set()
        self._event.set()
        self._thread.join(timeout=5.0)
        # the drain thread exited (or is wedged past the join timeout —
        # daemon, so it cannot outlive the process): discharge the fd
        # and every standby conn
        if self._wal_fd is not None:
            try:
                os.close(self._wal_fd)
            except OSError:
                pass
            self._wal_fd = None
        for conn in self._standbys:
            try:
                conn.close()
            except OSError:
                pass
        self._standbys = []
        with self._lock:
            pending, self._pending_conns = self._pending_conns, []
        for conn in pending:
            try:
                conn.close()
            except OSError:
                pass

    # --------------------------------------------------------- drain thread
    def _open_segment(self, start_seq: int) -> None:
        path = wal_segment_path(self.session_path, self.epoch, start_seq)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(str(path), os.O_CREAT | os.O_TRUNC | os.O_WRONLY,
                     0o600)
        # fd owned by the hub from here (close() discharges it) BEFORE
        # the header write, so a full-disk failure cannot strand it
        self._wal_fd = fd
        self._wal_path = path
        try:
            os.write(fd, _WAL_MAGIC + _WAL_HDR.pack(self.epoch, start_seq))
            if self._fsync:
                os.fsync(fd)
        except OSError:
            logger.exception("WAL segment header write failed")
        self._wal_start = start_seq
        self._wal_last = start_seq - 1

    def _drain_loop(self) -> None:
        last_hb = 0.0
        while not self._stop.is_set():
            with lock_watchdog.bounded_block("repl.hub_tick",
                                             bound=self._hb_period):
                self._event.wait(timeout=self._hb_period)
            self._event.clear()
            if self._stop.is_set():
                return
            try:
                with self._lock:
                    batch, self._buf = self._buf, []
                    pending, self._pending_conns = self._pending_conns, []
                    rotate_to, self._rotate_to = self._rotate_to, None
                if batch and not self.fenced:
                    # stream FIRST: standby freshness must not pay the
                    # WAL fsync's disk latency (a standby is itself a
                    # durability replica — it may legitimately hold
                    # records the local fsync hasn't confirmed yet)
                    self._send_all({"kind": "repl_wal", "rid": None,
                                    "epoch": self.epoch,
                                    "records": list(batch)})
                    self._write_batch(batch)
                # (a FENCED hub discards the batch: the promoted head's
                # snapshot is stamped with THIS epoch, so any record
                # this head appends post-fence would replay on top of
                # the new ledger at the next restore and diverge it)
                if rotate_to is not None:
                    self._do_rotate(rotate_to)
                for conn in pending:
                    if self.fenced:
                        # a stale snapshot must not bootstrap anyone
                        try:
                            conn.close()
                        except OSError:
                            pass
                        continue
                    self._bootstrap_standby(conn)
                now = time.monotonic()
                if now - last_hb >= self._hb_period:
                    last_hb = now
                    self._heartbeat_tick()
                if self._tsdb_export_cb is not None and \
                        now - self._last_tsdb >= self._tsdb_period:
                    self._last_tsdb = now
                    self._tsdb_tick()
            except Exception:  # noqa: BLE001 - the only drain thread:
                # an unexpected error must not end replication forever
                logger.exception("replication drain pass failed")

    def _write_batch(self, batch: List[Tuple[int, Tuple]]) -> None:
        if self._wal_fd is None:
            return
        chunks = []
        for seq, op in batch:
            try:
                chunks.append(encode_wal_record(seq, op))
            except Exception:  # noqa: BLE001 - an unpicklable op (user
                # payloads live inside kv values / actor specs) must not
                # poison the whole batch
                logger.exception("WAL encode failed (seq %d)", seq)
        if not chunks:
            return
        try:
            protocol.write_all(self._wal_fd, b"".join(chunks))
            if self._fsync:
                os.fsync(self._wal_fd)  # group commit: one fsync/batch
        except OSError:
            logger.exception("WAL append failed")
            return
        self._wal_last = batch[-1][0]
        self._count_metric(len(batch))

    @staticmethod
    def _count_metric(n: int) -> None:
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            if not GLOBAL_CONFIG.metrics_enabled:
                return
            from ray_tpu_torch.util import metrics_catalog as mcat
            mcat.get("rtt_gcs_wal_records_total").inc(n)
        except Exception:  # noqa: BLE001 - telemetry best-effort
            pass

    def _do_rotate(self, covered_seq: int) -> None:
        if self._wal_fd is None:
            return
        self._segments.append((self._wal_start, self._wal_last,
                               self._wal_path))
        try:
            os.close(self._wal_fd)
        except OSError:
            pass
        self._wal_fd = None
        self._open_segment(self._wal_last + 1)
        keep = []
        for start, last, path in self._segments:
            if last <= covered_seq:
                try:
                    os.unlink(str(path))
                except OSError:
                    pass
            else:
                keep.append((start, last, path))
        self._segments = keep

    def _bootstrap_standby(self, conn) -> None:
        """Snapshot + activate one adopted standby conn (drain thread).
        The capture callback takes GCS locks; this thread holds none.
        Records drained AFTER this point stream to the standby; any
        overlap with the captured state re-applies idempotently."""
        try:
            state = self._snapshot_cb()
            wire.conn_send(conn, {"kind": "repl_snapshot", "rid": None,
                                  "epoch": self.epoch,
                                  "wal_seq": int(state.get("wal_seq") or 0),
                                  "state": state}, wire.PROTO_REPL)
        except Exception:  # noqa: BLE001 - standby died mid-bootstrap
            logger.exception("standby bootstrap failed")
            try:
                conn.close()
            except OSError:
                pass
            return
        self._standbys.append(conn)
        self._set_standby_gauge()
        logger.info("standby attached (%d active)", len(self._standbys))

    def _send_all(self, msg: dict) -> None:
        dead = []
        for conn in self._standbys:
            try:
                wire.conn_send(conn, msg, wire.PROTO_REPL)
            except (OSError, ValueError, EOFError):
                dead.append(conn)
        for conn in dead:
            self._standbys.remove(conn)
            try:
                conn.close()
            except OSError:
                pass
        if dead:
            self._set_standby_gauge()
            logger.warning("standby disconnected (%d active)",
                           len(self._standbys))

    def standby_count(self) -> int:
        """Attached standbys right now.  ``_standbys`` is drain-thread-
        owned; this cross-thread ``len`` read (the autopilot's standby
        reflex, §4n) is a benign snapshot — at worst one attach/detach
        stale, which the next tick corrects."""
        return len(self._standbys)

    def _set_standby_gauge(self) -> None:
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            if not GLOBAL_CONFIG.metrics_enabled:
                return
            from ray_tpu_torch.util import metrics_catalog as mcat
            mcat.get("rtt_gcs_repl_standbys").set(len(self._standbys))
        except Exception:  # noqa: BLE001 - telemetry best-effort
            pass

    def _heartbeat_tick(self) -> None:
        if self._standbys:
            with self._lock:
                seq = self._seq
            self._send_all({"kind": "repl_heartbeat", "rid": None,
                            "epoch": self.epoch, "seq": seq})
        # split-brain fence: a HIGHER claimed epoch in the session dir
        # means a standby promoted over us — stop mutating the ledger
        if not self.fenced:
            seen = read_epoch(self.session_path)
            if seen > self.epoch:
                self.fenced = True
                logger.error("ledger epoch %d observed (own %d): this "
                             "head is fenced and refuses writes",
                             seen, self.epoch)
                if self._on_fenced is not None:
                    try:
                        self._on_fenced(seen)
                    except Exception:  # noqa: BLE001
                        logger.exception("fence callback failed")

    def _tsdb_tick(self) -> None:
        if not self._standbys:
            return
        try:
            dump, newest = self._tsdb_export_cb(self._tsdb_cursor)
        except Exception:  # noqa: BLE001 - telemetry best-effort
            logger.exception("tsdb export failed")
            return
        if not dump:
            return
        self._tsdb_cursor = newest
        self._send_all({"kind": "repl_tsdb", "rid": None,
                        "epoch": self.epoch, "series": dump})


# --------------------------------------------------------------- the standby
class StandbyHead:
    """Warm standby: stream the primary's ledger into live tables and
    promote to a serving :class:`GcsServer` the moment the primary dies.

    ``auto_promote`` (default True) promotes on stream loss with the
    endpoint verified dead (re-dial refused) or on missed heartbeats;
    :meth:`promote` forces it (e.g. planned head maintenance)."""

    def __init__(self, session, head_resources: Optional[dict] = None,
                 auto_promote: bool = True,
                 on_promote: Optional[Callable[[dict], None]] = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        self.session = session
        self.head_resources = dict(head_resources or {})
        self.auto_promote = auto_promote
        self.on_promote = on_promote
        self._timeout = max(0.2, GLOBAL_CONFIG.gcs_standby_timeout_s)
        self._lock = threading.Lock()  # no-block leaf (REPL_LOCK_DAG)
        self.state = new_ledger_state()      # guarded by: _lock
        self.applied_seq = 0                 # guarded by: _lock
        self.primary_epoch = 0               # guarded by: _lock
        self.synced = threading.Event()  # snapshot applied at least once
        self.promoted = None             # the GcsServer, once promoted
        self._promote_lock = threading.Lock()
        self._stop = threading.Event()
        self._conn = None
        # consecutive attaches dropped before any frame (stream-thread
        # owned): the no-hub-primary diagnostic counter
        self._attach_refused = 0
        self._unsynced_warned = False  # stream-thread owned
        self._tsdb = None
        if GLOBAL_CONFIG.metrics_enabled and GLOBAL_CONFIG.tsdb_enabled:
            from ray_tpu_torch.util.tsdb import TSDB
            self._tsdb = TSDB()
        self._thread = threading.Thread(target=self._stream_loop,
                                        name="standby-stream", daemon=True)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "StandbyHead":
        # pre-warm the promote path: the heavy imports (gcs + the
        # native store extension) load NOW, while the primary is
        # healthy, so promote() pays construction only — import time
        # must not sit inside the failover window
        try:
            from ray_tpu_torch._private import gcs as _gcs  # noqa: F401
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            if GLOBAL_CONFIG.use_native_store:
                from ray_tpu_torch.native import SlabStore  # noqa: F401
        except Exception:  # noqa: BLE001 - no native toolchain: the
            # promote path probes the same ladder and degrades the same
            pass
        self._thread.start()
        return self

    def shutdown(self) -> None:
        """Clean stop WITHOUT promoting (conn + thread discharged — the
        runtime resource oracle asserts this path leaks nothing)."""
        self._stop.set()
        conn = self._conn
        if conn is not None:
            protocol.shutdown_conn(conn)  # wake a blocked recv
        self._thread.join(timeout=5.0)
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def wait_synced(self, timeout: float = 30.0) -> bool:
        return self.synced.wait(timeout)

    def caught_up_to(self, seq: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.applied_seq >= seq and self.synced.is_set():
                    return True
            time.sleep(0.01)
        return False

    def _copy_state_locked(self) -> Dict[str, Any]:
        """_lock held: per-table deep-enough copy of the applied
        tables (inner dicts copied — the stream thread mutates them)."""
        return {
            "kv": {ns: dict(t) for ns, t in self.state["kv"].items()},
            "functions": dict(self.state["functions"]),
            "named_actors": dict(self.state["named_actors"]),
            "actors": {a: dict(r)
                       for a, r in self.state["actors"].items()},
            "pgs": {p: dict(r) for p, r in self.state["pgs"].items()},
            "shm_objects": dict(self.state["shm_objects"]),
            "driver_ids": set(self.state["driver_ids"]),
        }

    def snapshot_state(self) -> Dict[str, Any]:
        """Deep-enough copy of the applied tables (the equivalence
        oracle compares this against the primary's capture)."""
        with self._lock:
            return self._copy_state_locked()

    # ------------------------------------------------------------ streaming
    def _gcs_path(self) -> str:
        return self.session.socket_path("gcs.sock")

    def _dial(self, attach: bool = True):
        """One negotiated replication conn; raises on a dead endpoint
        (dial errors propagate) or :class:`ReplUnsupported` when the
        primary cannot speak the replication protocol.  ``attach=False``
        stops after version negotiation (liveness probe): the primary
        never sees a ``repl_attach``, so it does not capture + ship its
        whole durable state into a conn about to close."""
        conn = protocol.connect(self._gcs_path())
        try:
            ch = protocol.RpcChannel(conn)
            ver = ch.negotiate()
            if ver < wire.PROTO_REPL:
                raise ReplUnsupported(
                    f"primary speaks v{ver} < v{wire.PROTO_REPL}")
            if attach:
                wire.conn_send(conn, {"kind": "repl_attach", "rid": None},
                               ver)
            return conn
        except BaseException:
            try:
                conn.close()
            except OSError:
                pass
            raise

    def _stream_loop(self) -> None:
        # pre-snapshot record buffer: a repl_wal racing the bootstrap
        # snapshot ahead of it applies once the snapshot lands
        while not self._stop.is_set():
            try:
                conn = self._dial()
            except ReplUnsupported as e:
                logger.warning("cannot replicate: %s", e)
                if self._stop.wait(1.0):
                    return
                continue
            except (OSError, ConnectionError, EOFError, ValueError):
                if self._primary_down("dial refused"):
                    return
                continue
            self._conn = conn
            pre_buf: List[Tuple[int, Tuple]] = []
            have_snapshot = False
            saw_frame = False
            while not self._stop.is_set():
                try:
                    with lock_watchdog.bounded_block(
                            "repl.stream_poll", bound=self._timeout):
                        alive = conn.poll(self._timeout)
                    if not alive:
                        raise EOFError("replication heartbeat timeout")
                    # rtlint: blocks-ok(the poll gate above proved a
                    # frame is buffered — hub heartbeats every
                    # gcs_repl_heartbeat_s, so self._timeout bounds the
                    # poll and the recv drains without parking)
                    msg, _ = wire.conn_recv(conn)
                    saw_frame = True
                    self._attach_refused = 0
                except (EOFError, OSError, wire.WireError):
                    break
                kind = msg.get("kind")
                if kind == "repl_snapshot":
                    self._apply_snapshot(msg, pre_buf)
                    have_snapshot = True
                    pre_buf = []
                elif kind == "repl_wal":
                    if have_snapshot:
                        self._apply_records(msg.get("records", ()))
                    else:
                        pre_buf.extend(msg.get("records", ()))
                elif kind == "repl_tsdb":
                    if self._tsdb is not None:
                        self._tsdb.seed(msg.get("series", ()))
                elif kind == "repl_heartbeat":
                    pass  # poll-timeout reset is the liveness signal
                else:
                    logger.warning("unknown replication frame %r", kind)
            self._conn = None
            try:
                conn.close()
            except OSError:
                pass
            if self._stop.is_set():
                return
            if not saw_frame:
                # the server accepted the dial but dropped the conn
                # before ANY frame: it has no replication hub (e.g.
                # gcs_wal=False) — negotiation alone can't tell us.
                # Surface it loudly and back off instead of hot-looping
                # a dial the probe would keep calling "alive".
                self._attach_refused += 1
                if self._attach_refused == 3:
                    logger.error(
                        "primary repeatedly dropped repl_attach before "
                        "sending any frame — is it running with "
                        "gcs_wal=False?  Standing by without a stream "
                        "(will keep retrying slowly).")
                if self._stop.wait(2.0 if self._attach_refused >= 3
                                   else 0.2):
                    return
                continue
            if self._primary_down("stream EOF"):
                return

    def _apply_snapshot(self, msg: dict, pre_buf) -> None:
        state = msg.get("state") or {}
        with self._lock:
            self.state = new_ledger_state()
            for key in self.state:
                if key in state:
                    val = state[key]
                    self.state[key] = (set(val) if key == "driver_ids"
                                       else dict(val))
            self.applied_seq = int(msg.get("wal_seq") or 0)
            self.primary_epoch = int(msg.get("epoch") or 0)
            for seq, op in pre_buf:
                if seq > self.applied_seq:
                    try:
                        apply_op(self.state, tuple(op))
                    except Exception:  # noqa: BLE001
                        logger.exception("standby op apply failed")
                    self.applied_seq = max(self.applied_seq, int(seq))
        self.synced.set()
        logger.info("standby synced: epoch %d seq %d",
                    self.primary_epoch, self.applied_seq)

    def _apply_records(self, records) -> None:
        with self._lock:
            for seq, op in records:
                if seq <= self.applied_seq:
                    continue  # idempotent replay / duplicate delivery
                try:
                    apply_op(self.state, tuple(op))
                except Exception:  # noqa: BLE001 - one bad op must not
                    # desync the standby from the stream position
                    logger.exception("standby op apply failed")
                self.applied_seq = int(seq)

    def _probe_endpoint(self) -> bool:
        """True when the primary endpoint answers a negotiate (the probe
        conn is closed immediately; no ``repl_attach`` is sent)."""
        try:
            probe = self._dial(attach=False)
        except ReplUnsupported:
            return True  # alive, just can't replicate — not a death
        except (OSError, ConnectionError, EOFError, ValueError):
            return False
        try:
            return True
        finally:
            probe.close()

    def _primary_down(self, why: str) -> bool:
        """The stream broke.  Distinguish a transient break from primary
        death with one quick re-dial probe; promote (or keep retrying)
        accordingly.  Returns True when this thread should exit."""
        if not self.synced.is_set():
            # never synced: nothing to promote from — keep dialing (a
            # restarted primary lets us bootstrap; loudly, because an
            # operator who armed this standby believes failover works)
            if not self._unsynced_warned:
                self._unsynced_warned = True
                logger.warning(
                    "primary lost (%s) BEFORE the first snapshot sync: "
                    "nothing to promote from — waiting for an endpoint",
                    why)
            if self._stop.wait(0.2):
                return True
            return False
        alive = self._probe_endpoint()
        if alive:
            # endpoint alive (maybe a restarted primary): re-bootstrap
            # on a fresh conn by returning to the stream loop's dial
            if self._stop.wait(0.05):
                return True
            return False
        if not self.auto_promote:
            logger.warning("primary down (%s); auto-promote disabled",
                           why)
            return self._stop.wait(0.5)
        logger.warning("primary down (%s): promoting standby", why)
        try:
            self.promote()
        except Exception:  # noqa: BLE001 - a failed promote must be
            # loud; the operator can still boot a head manually
            logger.exception("standby promotion FAILED")
        return True

    # ------------------------------------------------------------- promote
    def promote(self):
        """Promote to a serving head: write the applied tables as the
        durable snapshot (ledger-epoch-stamped so the dead primary's
        fsynced-but-unstreamed WAL tail replays on top), then boot a
        real GcsServer over the session dir — it claims the next ledger
        epoch (fencing any still-alive old primary), re-binds
        ``gcs.sock``, and serves; raylets and clients re-attach through
        their normal reconnect paths."""
        with self._promote_lock:
            if self.promoted is not None:
                return self.promoted
            t0 = time.monotonic()
            # Per-table deep copy AND the stream cursor in ONE _lock
            # hold: the stream thread may still be applying records
            # (explicit promote with a live primary) — pickling shared
            # inner dicts outside the lock would race their mutation,
            # and a cursor read from a later hold could claim coverage
            # of records the copied tables don't contain.
            with self._lock:
                state = self._copy_state_locked()
                state["wal_seq"] = self.applied_seq
                state["ledger_epoch"] = self.primary_epoch
            snap = gcs_state_dir(self.session.path) / "snapshot.pkl"
            write_snapshot_file(snap, state)
            from ray_tpu_torch._private.gcs import GcsServer
            srv = GcsServer(self.session, self.head_resources)
            if self._tsdb is not None and srv._tsdb is not None:
                try:
                    dump, _ = self._tsdb.export_since(0.0)
                    srv._tsdb.seed(dump)
                except Exception:  # noqa: BLE001 - history is telemetry
                    logger.exception("tsdb handoff failed")
            self.promoted = srv
            took = time.monotonic() - t0
            logger.warning("standby promoted in %.0fms (epoch %d, seq "
                           "%d)", took * 1e3, srv.ledger_epoch,
                           state["wal_seq"])
            if self.on_promote is not None:
                try:
                    self.on_promote({"promote_s": took,
                                     "epoch": srv.ledger_epoch,
                                     "wal_seq": state["wal_seq"],
                                     "ts": time.time()})
                except Exception:  # noqa: BLE001
                    logger.exception("on_promote callback failed")
            return srv


# ------------------------------------------------------------------ CLI
def _main(argv=None) -> int:
    """``python -m ray_tpu_torch._private.replication --session DIR``: run a
    warm standby for an existing session; on primary death it promotes
    in-process and keeps serving until SIGTERM."""
    import argparse
    import json
    import signal
    import sys

    ap = argparse.ArgumentParser(prog="ray_tpu_torch-standby")
    ap.add_argument("--session", required=True,
                    help="session directory of the primary head")
    ap.add_argument("--num-cpus", type=float, default=0.0,
                    help="head CPU resource if promoted (0 = host cpus)")
    ap.add_argument("--timings", default="",
                    help="write promote timings JSON here on promotion")
    ap.add_argument("--no-auto-promote", action="store_true")
    args = ap.parse_args(argv)

    from ray_tpu_torch._private import resource_sanitizer
    from ray_tpu_torch._private.session import Session
    resource_sanitizer.maybe_install()
    # the warm standby samples itself too (DESIGN.md §4o): its history
    # becomes visible through the store the moment it promotes to head
    from ray_tpu_torch.util import profiler as profiler_mod
    profiler_mod.maybe_install("standby")
    root, name = os.path.split(os.path.abspath(args.session))
    session = Session(root=root, name=name)
    protocol.set_authkey(session.auth_key())
    resources = {"CPU": args.num_cpus} if args.num_cpus else {}

    def on_promote(rec: dict) -> None:
        if args.timings:
            tmp = args.timings + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, args.timings)

    standby = StandbyHead(session, head_resources=resources,
                          auto_promote=not args.no_auto_promote,
                          on_promote=on_promote).start()
    print("STANDBY_READY", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    synced_announced = False
    while not stop.wait(0.2):
        if not synced_announced and standby.synced.is_set():
            # the arm signal harnesses/operators wait for: before this
            # line a primary death has nothing to promote from
            synced_announced = True
            print("STANDBY_SYNCED", flush=True)
        if standby.promoted is None and not standby._thread.is_alive():
            # stream thread exited without promoting (failed promote or
            # never synced + stop): nothing left to do
            break
    if standby.promoted is not None:
        standby.promoted.shutdown()  # asserts sanitizer-clean
    else:
        standby.shutdown()
        resource_sanitizer.assert_clean_at_shutdown("standby-shutdown")
    return 0


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    raise SystemExit(_main())
