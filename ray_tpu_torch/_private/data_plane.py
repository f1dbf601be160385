"""Peer-to-peer object plane for multi-host clusters.

Reference: the ObjectManager's node↔node chunked transfer (PullManager /
PushManager, SURVEY.md §2.1) — data moves directly between the holder
host and the puller host; the head is only a *fallback relay* for hosts
that cannot reach each other (hub-spoke NAT topologies).

Mechanics here: each NodeAgent host keeps a **spool directory** of large
objects produced on that host (one file per object, written by the
producing worker — same host, plain file I/O) and runs a
``DataPlaneServer`` — a TCP listener (per-session HMAC auth, the same
handshake as every other socket) serving reads of those files.  The GCS
records ``loc="remote"`` + the holder node; consumers dial the holder's
advertised data address, falling back to the head relay when the dial
fails.

Transfer protocol (r7; negotiated per connection — DESIGN.md §4):

- **v1 streamed** (``fetch_stream``): ONE request.  Ranges at or below
  ``data_inline_pull_bytes`` come back inline in the ack itself — one
  message round trip, no frame-boundary syscalls (small pulls are
  syscall-bound, not copy-bound).  Above it, the server pushes the
  whole byte range as length-prefixed raw binary bulk frames
  (``wire.BULK_*``) — header ``write`` + ``os.sendfile`` from the spool
  file on a direct TCP connection, so the payload never enters
  userspace on the send side; the receiver ``recv_into``s straight into
  its pre-sized buffer.  A pull is one round trip plus line-rate
  streaming.  Through the head's message-pump relay, the same frames
  ride ``send_bytes`` messages (the pump re-frames Connection messages
  and would corrupt raw fd traffic).
- **v0 chunked** (``fetch_object`` / ``fetch_chunk``): the seed
  request-per-chunk pickled-dict protocol, kept verbatim for legacy
  peers.  A v1 puller discovers a v0 holder via the ``__proto_hello__``
  unknown-op error and degrades; a v0 puller never says hello and the
  server keeps speaking v0 to it.

Pulls go through a per-process :class:`DataPlanePool` — connections are
keyed by peer address, reused across pulls and deletes (no dial+HMAC
per object), LRU-bounded, and invalidated wholesale on a broken
connection (mirroring ``RpcPool.invalidate``).  Objects at or above
``data_stripe_threshold_bytes`` pull as N parallel range-striped
streams over pool connections.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from ray_tpu_torch._private import protocol, rtlog, wire
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.util import metrics_catalog as mcat

logger = rtlog.get("data-plane")


def spool_path(spool_dir: str, object_id: str) -> Path:
    return Path(spool_dir) / f"obj_{object_id}"


def spool_capacity_bytes() -> int:
    mb = int(os.environ.get("RTT_SPOOL_CAPACITY_MB", 0) or 0)
    if mb <= 0:
        mb = GLOBAL_CONFIG.object_store_memory_mb
    return mb * 1024 * 1024


def _admit_spool(spool_dir: str,
                 object_id: str, size: int):  # rtlint: returns(file)
    """Admission check + reservation for one spool write; returns the
    opened ``.tmp`` file (positioned at 0, reserved to ``size``).

    Admission-checked against the spool capacity (default: the object
    store capacity — an unbounded spool on a tmpfs-backed /tmp would
    OOM the host with no backpressure).  The scan is O(spooled files);
    spooled objects are large, so counts stay small.

    The scan + reservation run under a per-spool flock so N concurrent
    producers can't each pass the check and collectively overshoot the
    capacity; the reservation is an ftruncate of the .tmp file to full
    size, which later scanners count, so the bulk data copy itself
    happens outside the lock."""
    import fcntl

    cap = spool_capacity_bytes()
    path = spool_path(spool_dir, object_id)
    tmp = path.with_suffix(".tmp")
    with open(Path(spool_dir) / ".admission.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        used = 0
        now = time.time()
        try:
            with os.scandir(spool_dir) as it:
                for e in it:
                    if e.name == ".admission.lock":
                        continue
                    try:
                        st = e.stat()
                        if e.name.endswith(".tmp") and \
                                now - st.st_mtime > 300:
                            # orphaned reservation: a writer SIGKILLed
                            # mid-write (e.g. by the per-node OOM killer)
                            # never runs its cleanup — sweep it here or it
                            # counts against capacity forever
                            os.unlink(e.path)
                            continue
                        used += st.st_size
                    except OSError:
                        pass
        except OSError:
            pass
        if used + size > cap:
            from ray_tpu_torch.exceptions import ObjectStoreFullError
            raise ObjectStoreFullError(
                f"host spool full: {used + size} > {cap} bytes "
                f"(RTT_SPOOL_CAPACITY_MB to raise)")
        f = open(tmp, "wb")
        try:
            f.truncate(size)  # reserve while still under the lock
        except OSError:
            pass
    return f


def _seal_spool(spool_dir: str, object_id: str, f) -> None:  # rtlint: owns(f)
    import fcntl
    f.close()
    path = spool_path(spool_dir, object_id)
    # rename under the admission flock: a concurrent admission scan
    # racing a same-directory rename can observe the entry under
    # NEITHER name (POSIX readdir gives no atomicity across a rename)
    # and under-count the spool, over-admitting past capacity
    with open(Path(spool_dir) / ".admission.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        os.replace(path.with_suffix(".tmp"), path)


def _abort_spool(spool_dir: str, object_id: str, f) -> None:  # rtlint: owns(f)
    f.close()
    try:  # a failed write must not hold its reservation
        os.unlink(spool_path(spool_dir, object_id).with_suffix(".tmp"))
    except OSError:
        pass


def write_spool(spool_dir: str, object_id: str, wire_bytes) -> int:
    """Atomic admission-checked write of pre-assembled wire bytes."""
    size = len(wire_bytes)
    f = _admit_spool(spool_dir, object_id, size)
    try:
        f.write(wire_bytes)
        _seal_spool(spool_dir, object_id, f)
    except BaseException:
        _abort_spool(spool_dir, object_id, f)
        raise
    return size


def write_spool_value(spool_dir: str, object_id: str, pickled,
                      buffers) -> int:
    """Serialize straight into the spool file with writev — the
    producer-side single-copy path (``write_value_to_fd``): out-of-band
    buffers stream from their numpy backing into the page cache without
    first materializing the full wire bytes in this process's heap."""
    from ray_tpu_torch._private.serialization import (serialized_size,
                                                write_value_to_fd)
    size = serialized_size(pickled, buffers)
    f = _admit_spool(spool_dir, object_id, size)
    try:
        write_value_to_fd(f.fileno(), pickled, buffers)
        _seal_spool(spool_dir, object_id, f)
    except BaseException:
        _abort_spool(spool_dir, object_id, f)
        raise
    return size


class _SpoolFdCache:
    """Open spool-file fds kept hot across requests.

    Every streamed pull used to pay ``open`` + ``fstat`` + ``close`` on
    the spool file — three gofer round trips (~50 µs) on sandboxed
    kernels, a third of a warm small-pull.  Spool files are immutable
    once sealed (written as ``.tmp``, renamed into place), so the fd
    and size stay valid for the object's whole life.

    Each checkout returns a ``dup`` of the cached master fd (a pure
    fd-table operation — no path walk, no gofer), so an eviction or a
    ``delete_object`` closing the master never yanks the fd out from
    under an in-flight stream: the dup keeps the inode alive, matching
    the pull-racing-delete semantics of the uncached path."""

    def __init__(self, spool_dir: str, cap: int = 32):
        from collections import OrderedDict
        self._spool_dir = spool_dir
        self._cap = max(1, cap)
        self._lock = threading.Lock()
        # object_id -> (master fd, size), LRU order (oldest first)
        self._fds: Dict[str, tuple] = OrderedDict()  # guarded by: _lock

    def checkout(self, object_id: str):  # rtlint: returns(fd)
        """(dup'd fd, file size); the caller owns the dup and must
        close it.  Raises OSError/FileNotFoundError on a spool miss."""
        with self._lock:
            ent = self._fds.get(object_id)
            if ent is not None:
                self._fds.move_to_end(object_id)
                return os.dup(ent[0]), ent[1]
        mfd = os.open(spool_path(self._spool_dir, object_id), os.O_RDONLY)
        try:
            size = os.fstat(mfd).st_size
        except OSError:
            os.close(mfd)
            raise
        victims = []
        with self._lock:
            ent = self._fds.get(object_id)
            if ent is not None:
                # lost an insert race: keep the existing master
                self._fds.move_to_end(object_id)
                victims.append(mfd)
                dup, sz = os.dup(ent[0]), ent[1]
            else:
                self._fds[object_id] = (mfd, size)
                while len(self._fds) > self._cap:
                    _, (vfd, _) = self._fds.popitem(last=False)
                    victims.append(vfd)
                dup, sz = os.dup(mfd), size
        for v in victims:
            try:
                os.close(v)
            except OSError:
                pass
        return dup, sz

    def invalidate(self, object_id: str) -> None:
        with self._lock:
            ent = self._fds.pop(object_id, None)
        if ent is not None:
            try:
                os.close(ent[0])
            except OSError:
                pass

    def close_all(self) -> None:
        with self._lock:
            ents = list(self._fds.values())
            self._fds.clear()
        for fd, _ in ents:
            try:
                os.close(fd)
            except OSError:
                pass


class DataPlaneServer:
    """Serves reads of one host's object spool.

    Requests are framed-pickle messages (the seed wire format — both
    v0 and v1 peers speak it for control); bulk payload transport
    depends on the per-connection negotiated version:

      __proto_hello__: {versions} → {proto}       (v1 capability probe)
      fetch_object:  {object_id} → {size} | {error}
      fetch_chunk:   {object_id, offset, length} → {data}
      fetch_stream:  {object_id, offset, length, raw}
                       → {size, len, data} (range ≤ data_inline_pull_bytes)
                       | {size, len} then bulk frames (v1)
      delete_object: {object_id} → {}             (refcount hit zero)
      stats:         {} → {bytes_served, objects_served, conns_accepted}
    """

    def __init__(self, spool_dir: str, host: str = "0.0.0.0",
                 advertise_host: Optional[str] = None):
        self.spool_dir = spool_dir
        Path(spool_dir).mkdir(parents=True, exist_ok=True)
        self._listener = protocol.make_tcp_listener(host, 0)
        try:
            self.port = self._listener.address[1]
            self.advertise_addr = \
                f"tcp://{advertise_host or host}:{self.port}"
            # serving counters: one _serve thread per connection mutates
            # them, stats/tests read them — a bare += would drop updates
            self._stats_lock = threading.Lock()
            self.bytes_served = 0       # guarded by: _stats_lock
            self.objects_served = 0     # guarded by: _stats_lock
            self.conns_accepted = 0     # guarded by: _stats_lock
            self._conns: List = []      # guarded by: _stats_lock
            self._fd_cache = _SpoolFdCache(spool_dir)
            self._stop = threading.Event()
            threading.Thread(target=self._accept_loop, name="data-plane",
                             daemon=True).start()
        except BaseException:
            # a failed boot returns no server: close the bound port
            self._listener.close()
            raise

    def _accept_loop(self) -> None:
        protocol.serve_accept_loop(self._listener, self._stop.is_set,
                                   self._serve, "data-plane-serve")

    def _count_served(self, nbytes: int, obj: bool = False) -> None:
        """``obj=True`` counts one OBJECT served — the offset-0 request
        of a stream (full pull or first stripe) and the legacy
        ``fetch_object`` size probe.  Chunk and non-zero-offset stripe
        requests only add bytes, so ``objects_served`` stays an object
        count, not a request count."""
        with self._stats_lock:
            if obj:
                self.objects_served += 1
            self.bytes_served += nbytes
        if GLOBAL_CONFIG.metrics_enabled and nbytes:
            mcat.get("rtt_data_bytes_total").inc(nbytes,
                                                  tags={"dir": "out"})

    def _serve(self, conn) -> None:
        from ray_tpu_torch._private import flight_recorder
        protocol.tune_data_socket(conn)
        with self._stats_lock:
            self.conns_accepted += 1
            self._conns.append(conn)
        try:
            while not self._stop.is_set():
                try:
                    # rtlint: blocks-ok(parks between a puller's ops;
                    # peer death EOFs the conn — per-conn thread, peer
                    # liveness is the deadline)
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                op = msg.get("op")
                if flight_recorder.enabled():
                    flight_recorder.record(
                        "data_frame",
                        f"{op} {str(msg.get('object_id', ''))[:20]} "
                        f"off={msg.get('offset', 0)}")
                if op == "__proto_hello__":
                    try:
                        conn.send({"proto": wire.negotiate_version(
                            msg.get("versions") or [0],
                            wire.DATA_PROTO_MIN, wire.DATA_PROTO_MAX)})
                    except wire.ProtocolVersionError as e:
                        conn.send({"error": str(e)})
                    continue
                oid = msg.get("object_id", "")
                path = spool_path(self.spool_dir, oid)
                if op == "fetch_stream":
                    # handles its own errors: a mid-stream failure
                    # leaves the conn in an undefined framing state
                    if not self._serve_stream(conn, msg):
                        return
                    continue
                try:
                    if op == "fetch_object":
                        self._count_served(0, obj=True)
                        conn.send({"size": path.stat().st_size})
                    elif op == "fetch_chunk":
                        with open(path, "rb") as f:
                            data = os.pread(f.fileno(), msg["length"],
                                            msg["offset"])
                        self._count_served(len(data))
                        conn.send({"data": data})
                    elif op == "delete_object":
                        try:
                            os.unlink(path)
                        except FileNotFoundError:
                            pass
                        # in-flight streams keep their dup'd fd (the
                        # inode lives until they finish); fetches after
                        # this reply must miss
                        self._fd_cache.invalidate(oid)
                        conn.send({})
                    elif op == "stats":
                        with self._stats_lock:
                            st = {"bytes_served": self.bytes_served,
                                  "objects_served": self.objects_served,
                                  "conns_accepted": self.conns_accepted}
                        conn.send(st)
                    else:
                        conn.send({"error": f"unknown op {op!r}"})
                except FileNotFoundError:
                    conn.send({"error": "not found"})
                except OSError as e:
                    conn.send({"error": str(e)})
        finally:
            with self._stats_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            try:
                conn.close()
            except OSError:
                pass

    # ---------------------------------------------------------- streaming
    def _serve_stream(self, conn, msg: dict) -> bool:  # rtlint: replies
        """One fetch_stream: ack {size, len} then push bulk frames.

        Returns False when the connection is no longer in a known
        framing state (mid-stream socket/read failure) — the caller
        must close it.  Pre-stream misses reply {error} and keep the
        conn pooled."""
        from ray_tpu_torch.util import tracing
        offset = int(msg.get("offset", 0) or 0)
        length = msg.get("length")
        raw = bool(msg.get("raw", True))
        # wire-propagated span (DATA_PROTO_TRACE peers only): the serve
        # leg becomes a child of the puller's span, tagged bytes/path
        span = tracing.extract_wire_trace(msg)
        t0 = time.time()
        try:
            fd, size = self._fd_cache.checkout(msg.get("object_id", ""))
        except OSError:
            try:
                conn.send({"error": "not found"})
                return True
            except (OSError, ValueError):
                return False
        try:
            try:
                n = size - offset if length is None or length < 0 \
                    else min(int(length), size - offset)
                n = max(n, 0)
                if n <= GLOBAL_CONFIG.data_inline_pull_bytes:
                    # small-range fast path: payload rides the ack (one
                    # message RT, no frame-boundary syscalls — below
                    # ~100KB the pull is syscall-bound, not copy-bound);
                    # header + pickled body leave in ONE writev so the
                    # blocked puller wakes exactly once
                    data = os.pread(fd, n, offset)
                    if len(data) != n:
                        conn.send({"error": "short spool read"})
                        return True
                    protocol.send_msg_writev(
                        conn, {"size": size, "len": n, "data": data})
                    self._count_served(n, obj=offset == 0)
                    if span is not None:
                        tracing.emit_span(
                            "data.serve_stream", span, t0,
                            time.time() - t0, cat="data", bytes=n,
                            offset=offset, path="inline",
                            object_id=msg.get("object_id", ""))
                    return True
                conn.send({"size": size, "len": n})
                frame = max(64 * 1024, GLOBAL_CONFIG.data_stream_frame_bytes)
                if raw:
                    ok = self._stream_raw(conn, fd, offset, n, frame)
                else:
                    ok = self._stream_msgs(conn, fd, offset, n, frame)
            except (OSError, ValueError, EOFError):
                return False
        finally:
            try:
                os.close(fd)
            except OSError:
                pass
        if ok:
            self._count_served(n, obj=offset == 0)
            if span is not None:
                tracing.emit_span(
                    "data.serve_stream", span, t0, time.time() - t0,
                    cat="data", bytes=n, offset=offset,
                    path="raw" if raw else "relay",
                    object_id=msg.get("object_id", ""))
        return ok

    def _stream_raw(self, conn, in_fd: int, offset: int, n: int,
                    frame: int) -> bool:
        """Push ``n`` bytes as raw bulk frames on the socket fd:
        header write + ``os.sendfile`` from the spool file — the payload
        never enters userspace.  Falls back to pread+write when sendfile
        is unsupported for this fd pair."""
        out_fd = conn.fileno()
        use_sendfile = hasattr(os, "sendfile")
        sent = 0
        while sent < n:
            k = min(frame, n - sent)
            pos = offset + sent
            if not use_sendfile:
                # read BEFORE committing the frame header so a spool
                # read error can still surface as a recoverable ERR
                # frame instead of killing the pooled connection
                try:
                    data = os.pread(in_fd, k, pos)
                    if len(data) != k:
                        raise OSError(errno.EIO, "short spool read")
                except OSError as e:
                    err = str(e).encode("utf-8", "replace")
                    protocol.write_all(out_fd, wire.bulk_pack_header(
                        wire.BULK_ERR, len(err)) + err)
                    return True
                protocol.write_all(out_fd, wire.bulk_pack_header(
                    wire.BULK_DATA, k))
                protocol.write_all(out_fd, data)
                sent += k
                continue
            protocol.write_all(out_fd, wire.bulk_pack_header(
                wire.BULK_DATA, k))
            end = pos + k
            while pos < end:
                try:
                    m = os.sendfile(out_fd, in_fd, pos, end - pos)
                except OSError as e:
                    if e.errno in (errno.ENOSYS, errno.EINVAL) \
                            and pos == offset + sent:
                        # header already committed: deliver this frame
                        # by pread+write, then stop using sendfile
                        use_sendfile = False
                        data = os.pread(in_fd, end - pos, pos)
                        if len(data) != end - pos:
                            return False
                        protocol.write_all(out_fd, data)
                        m = len(data)
                    else:
                        raise
                if m <= 0:
                    raise OSError(errno.EIO, "sendfile stalled")
                pos += m
            sent += k
        protocol.write_all(out_fd, wire.bulk_pack_header(wire.BULK_END, 0))
        return True

    def _stream_msgs(self, conn, fd: int, offset: int, n: int,
                     frame: int) -> bool:
        """Proxy-safe streaming: each bulk frame rides one
        ``send_bytes`` message (the head's relay pump re-frames
        Connection messages; raw fd traffic would not survive it).
        Payloads are memoryview slices of the file's mmap — no pickle
        and no userspace staging copy."""
        if n == 0:
            return True
        import mmap
        mm = mmap.mmap(fd, 0, prot=mmap.PROT_READ)
        try:
            mv = memoryview(mm)
            sent = 0
            while sent < n:
                k = min(frame, n - sent)
                conn.send_bytes(mv[offset + sent:offset + sent + k])
                sent += k
        finally:
            try:
                mv.release()
            except (NameError, BufferError):
                pass
            mm.close()
        return True

    def delete_local(self, object_id: str) -> None:
        """Producer-side spool eviction: unlink + fd-cache invalidate,
        same semantics as the remote ``delete_object`` op (in-flight
        streams keep their dup'd fd; later fetches miss)."""
        try:
            os.unlink(spool_path(self.spool_dir, object_id))
        except FileNotFoundError:
            pass
        self._fd_cache.invalidate(object_id)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self._fd_cache.close_all()
        # force-close live serving conns: their threads sit in recv();
        # shutdown() interrupts the read AND sends FIN so pooled peer
        # conns observe the death instead of waiting on a dead socket
        with self._stats_lock:
            conns = list(self._conns)
        for c in conns:
            protocol.shutdown_conn(c)


# ---------------------------------------------------------------- client
class _StreamError(Exception):
    """Protocol breakage mid-stream: the connection framing state is
    unknown and the conn must be discarded."""


class _StreamMiss(Exception):
    """Server-signaled miss at a clean frame boundary: the object is
    gone but the connection is still usable."""


class _LegacyPeer(Exception):
    """The holder answered ``fetch_stream``/hello with unknown-op — it
    runs the v0 protocol (e.g. restarted onto an older build after we
    cached v1 for its address)."""


def _negotiate_data_proto(conn) -> int:
    """Client half of the data-plane ``__proto_hello__``; a legacy
    server replies unknown-op error → version 0."""
    conn.send({"op": "__proto_hello__",
               "versions": list(range(wire.DATA_PROTO_MIN,
                                      wire.DATA_PROTO_MAX + 1))})
    # rtlint: blocks-ok(hello handshake on a fresh dial: every server
    # version replies to the first frame (legacy = unknown-op error),
    # so the reply or EOF arrives within the peer's serve latency; the
    # fetch leader's 120s coalesce cap bounds the caller)
    resp = conn.recv()
    if resp.get("error"):
        return 0
    return int(resp.get("proto", 0))


_PULL_CACHE_MIN = 1024 * 1024


class _PullBufferCache:
    """Already-faulted receive buffers reused across streamed pulls.

    Materializing the destination pages — NOT the transfer — is the
    dominant cost of a large pull once streaming is in place:
    ``bytearray(64MB)`` memsets every page (~50 ms here, longer than
    the 64 MB transfer itself), and a lazily-faulted anonymous mmap
    pays the same bill as page faults inside ``recv_into`` (worse on
    virtualized kernels where each fault is a host round trip).  A
    buffer whose pages are already resident streams at line rate with
    ~zero allocation cost, so this cache keeps recent pull buffers
    and hands them back out.

    Reuse safety: ``pull`` returns the SAME object the cache retains,
    so a buffer is reusable only while the cache holds the sole
    reference — checked with ``sys.getrefcount`` under the lock.  Any
    consumer still holding the buffer (or any memoryview/numpy view
    into it — views own a reference to the base) inflates the count
    and the buffer is skipped; the moment the consumer drops it, the
    next pull recycles the hot pages.  The scan-and-return runs
    entirely under the lock and the returned value is referenced by
    the caller's frame continuously from loop variable to return, so
    two racing pulls can never be handed the same buffer.

    Buffers below ``_PULL_CACHE_MIN`` are plain fresh bytearrays (a
    small memset is cheaper than pinning pages); the cache itself is
    LRU-bounded by ``data_pull_buffer_cache_mb`` — eviction just drops
    the cache's reference, so an evicted in-use buffer lives on with
    its consumer, it merely stops being reusable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bufs: List = []  # LRU order, most-recent last; guarded by: _lock

    def alloc(self, n: int):
        """Writable bytes-like buffer of exactly ``n`` bytes."""
        if n < _PULL_CACHE_MIN:
            return bytearray(n)
        import sys
        with self._lock:
            for i in range(len(self._bufs) - 1, -1, -1):
                b = self._bufs[i]
                # 3 == our list + loop var + getrefcount's argument:
                # nobody outside this cache holds the buffer
                if len(b) >= n and sys.getrefcount(b) == 3:
                    del self._bufs[i]
                    self._bufs.append(b)
                    return memoryview(b)[:n] if len(b) > n else b
        import mmap
        # anonymous mmap over bytearray: no up-front zero-fill — first
        # use faults pages as recv_into streams through them
        buf = mmap.mmap(-1, n)
        cap = max(0, GLOBAL_CONFIG.data_pull_buffer_cache_mb) * 1024 * 1024
        if n <= cap:
            with self._lock:
                self._bufs.append(buf)
                total = sum(len(b) for b in self._bufs)
                while total > cap and len(self._bufs) > 1:
                    total -= len(self._bufs.pop(0))
        return buf

    def clear(self) -> None:
        with self._lock:
            self._bufs.clear()


def _pull_chunks(conn, object_id: str) -> bytearray:
    """v0 request-per-chunk pull (legacy holders; also the in-pool
    fallback when a cached-v1 address turns out to be v0)."""
    conn.send({"op": "fetch_object", "object_id": object_id})
    # rtlint: blocks-ok(request/reply on the v0 pull path: the holder
    # answers every op or EOFs; the fetch leader's 120s coalesce cap
    # (gcs._pull_remote_local) bounds the caller-visible wait)
    head = conn.recv()
    if "error" in head:
        raise FileNotFoundError(object_id)
    size = head["size"]
    chunk = GLOBAL_CONFIG.transfer_chunk_bytes
    buf = bytearray(size)
    off = 0
    while off < size:
        conn.send({"op": "fetch_chunk", "object_id": object_id,
                   "offset": off, "length": min(chunk, size - off)})
        # rtlint: blocks-ok(same request/reply contract and 120s
        # coalesce cap as the fetch_object head frame above)
        r = conn.recv()
        piece = r.get("data")
        if not piece:
            raise FileNotFoundError(object_id)
        buf[off:off + len(piece)] = piece
        off += len(piece)
    return buf


class _PoolConn:
    """One pooled data-plane connection (checked out by one thread at a
    time; the pool's lock never covers I/O on it)."""

    __slots__ = ("conn", "addr", "raw", "proto", "last_used")

    def __init__(self, conn, addr: str,
                 raw: bool, proto: int):  # rtlint: owns(conn)
        self.conn = conn
        self.addr = addr
        self.raw = raw          # direct fd (sendfile/recv_into legal)?
        self.proto = proto      # negotiated data-plane version
        self.last_used = time.monotonic()


def _default_dial(addr: str):
    """tcp:// dial with bulk tuning; (conn, raw=True)."""
    tcp = protocol.parse_tcp_addr(addr)
    if tcp is None:
        raise ConnectionError(f"not a tcp data address: {addr!r}")
    return protocol.connect_data(*tcp, timeout=3.0), True


class DataPlanePool:
    """Per-process pool of data-plane connections, keyed by peer
    address.  Repeated pulls and deletes to the same holder reuse one
    authenticated connection instead of paying dial+HMAC per object;
    a broken connection invalidates every pooled conn to that address
    (the peer likely died — mirrors ``RpcPool.invalidate``).  Idle
    connections beyond ``data_pool_max_conns`` close LRU-first."""

    def __init__(self, dial=None):
        self._dial = dial or _default_dial
        self._buffers = _PullBufferCache()
        self._lock = threading.Lock()
        self._idle: Dict[str, List[_PoolConn]] = {}  # guarded by: _lock
        self._open = 0                               # guarded by: _lock
        self._proto: Dict[str, int] = {}             # guarded by: _lock
        self._closed = False                         # guarded by: _lock

    # ------------------------------------------------------ conn lifecycle
    def _publish_open_locked(self) -> None:
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_data_pool_conns").set(self._open)

    def acquire(self, addr: str) -> _PoolConn:  # rtlint: returns(conn)
        with self._lock:
            lst = self._idle.get(addr)
            if lst:
                pc = lst.pop()
                if not lst:
                    del self._idle[addr]
                return pc
            known = self._proto.get(addr)
        conn, raw = self._dial(addr)
        try:
            proto = known if known is not None \
                else _negotiate_data_proto(conn)
        except (OSError, EOFError, ConnectionError):
            try:
                conn.close()
            except OSError:
                pass
            raise
        pc = _PoolConn(conn, addr, raw, proto)
        with self._lock:
            if known is None:
                self._proto[addr] = proto
            self._open += 1
            self._publish_open_locked()
        return pc

    def release(self, pc: _PoolConn) -> None:  # rtlint: owns(pc)
        """Return a healthy conn; evict LRU idles beyond the bound."""
        pc.last_used = time.monotonic()
        victims: List[_PoolConn] = []
        with self._lock:
            if self._closed:
                victims.append(pc)
                self._open -= 1
            else:
                self._idle.setdefault(pc.addr, []).append(pc)
                limit = max(1, GLOBAL_CONFIG.data_pool_max_conns)
                while sum(len(v) for v in self._idle.values()) > limit:
                    addr = min(self._idle,
                               key=lambda a: self._idle[a][0].last_used)
                    victims.append(self._idle[addr].pop(0))
                    if not self._idle[addr]:
                        del self._idle[addr]
                    self._open -= 1
            self._publish_open_locked()
        for v in victims:
            try:
                v.conn.close()
            except OSError:
                pass

    def discard(self, pc: _PoolConn) -> None:  # rtlint: owns(pc)
        """Drop a broken checked-out conn."""
        with self._lock:
            self._open -= 1
            self._publish_open_locked()
        try:
            pc.conn.close()
        except OSError:
            pass

    def invalidate(self, addr: str) -> None:
        """Close every idle conn to ``addr`` and forget its negotiated
        version — the reconnect primitive after a peer death."""
        with self._lock:
            victims = self._idle.pop(addr, [])
            self._proto.pop(addr, None)
            self._open -= len(victims)
            self._publish_open_locked()
        for v in victims:
            try:
                v.conn.close()
            except OSError:
                pass

    def set_proto(self, addr: str, proto: int) -> None:
        """Pre-seed a peer's data-plane version (the head learns it from
        node registration and skips the per-conn hello round trip)."""
        with self._lock:
            self._proto[addr] = int(proto)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"open": self._open,
                    "idle": sum(len(v) for v in self._idle.values())}

    def close_all(self) -> None:
        with self._lock:
            self._closed = True
            victims = [pc for lst in self._idle.values() for pc in lst]
            self._idle.clear()
            self._open -= len(victims)
            self._publish_open_locked()
        for v in victims:
            try:
                v.conn.close()
            except OSError:
                pass
        self._buffers.clear()

    # -------------------------------------------------------------- pulls
    def pull(self, addr: str, object_id: str,
             size: Optional[int] = None):
        """Fetch one object's wire bytes from the holder at ``addr``,
        as a writable bytes-like buffer (``bytearray``, or an
        anonymous ``mmap`` for large objects — see
        ``_alloc_pull_buffer``).

        v1 holders stream (range-striped in parallel above
        ``data_stripe_threshold_bytes`` when ``size`` is known); v0
        holders get the chunk protocol — still over a pooled conn, so
        even legacy pulls stop paying dial+HMAC per object."""
        t0 = time.monotonic()
        t0w = time.time()
        # the pull's child span is created BEFORE the transfer and
        # adopted for its duration, so the per-stream fetch_stream
        # requests carry ITS id — the holder's data.serve_stream spans
        # then nest under this data.pull node in the assembled tree
        from ray_tpu_torch.util import tracing
        span = tracing.current_span()
        pull_ctx = tok = None
        if span is not None and span.sampled:
            pull_ctx = tracing.child_span(span, "data.pull")
            tok = tracing.adopt(pull_ctx)
        try:
            buf = self._pull(addr, object_id, size)
        finally:
            if tok is not None:
                tracing.restore(tok)
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_data_pull_seconds").observe(
                time.monotonic() - t0, tags={"path": "direct"})
            mcat.get("rtt_data_bytes_total").inc(len(buf),
                                                  tags={"dir": "in"})
        if pull_ctx is not None:
            tracing.emit_ctx_span(pull_ctx, "data.pull", t0w,
                                  time.monotonic() - t0, cat="data",
                                  bytes=len(buf), path="direct",
                                  object_id=object_id)
        return buf

    def _pull(self, addr: str, object_id: str,
              size: Optional[int]):
        cfg = GLOBAL_CONFIG
        pc = self.acquire(addr)
        try:
            if pc.proto >= 1:
                streams = int(cfg.data_stripe_streams)
                if size is not None and streams > 1 \
                        and size >= cfg.data_stripe_threshold_bytes:
                    buf = self._pull_striped(pc, addr, object_id, size,
                                             streams)
                else:
                    buf = self._pull_stream(pc, object_id)
            else:
                buf = _pull_chunks(pc.conn, object_id)
        except _LegacyPeer:
            # cached-v1 address now speaks v0 (peer restarted older):
            # renegotiate down and retry chunked on the same conn
            with self._lock:
                self._proto[addr] = 0
            pc.proto = 0
            try:
                buf = _pull_chunks(pc.conn, object_id)
            except FileNotFoundError:
                self.release(pc)
                raise
            except BaseException:
                self.discard(pc)
                self.invalidate(addr)
                raise
            self.release(pc)
            return buf
        except _StreamMiss:
            self.release(pc)
            raise FileNotFoundError(object_id) from None
        except FileNotFoundError:
            self.release(pc)  # clean miss: conn still good
            raise
        except BaseException:
            self.discard(pc)
            self.invalidate(addr)
            raise
        self.release(pc)
        return buf

    def _pull_stream(self, pc: _PoolConn, object_id: str):
        msg = {"op": "fetch_stream", "object_id": object_id,
               "offset": 0, "length": -1, "raw": pc.raw}
        if pc.proto >= wire.DATA_PROTO_TRACE:
            from ray_tpu_torch.util import tracing
            tracing.attach_wire_trace(msg)
        pc.conn.send(msg)
        n, inline = self._read_stream_ack(pc, object_id, expect=None)
        if inline is not None:
            return bytearray(inline)
        buf = self._buffers.alloc(n)
        self._recv_stream(pc, memoryview(buf), n)
        return buf

    def _pull_striped(self, pc0: _PoolConn, addr: str, object_id: str,
                      size: int, streams: int):
        # each stripe should stay big enough to amortize its ack RTT
        k = min(streams, max(2, size // (8 * 1024 * 1024)))
        buf = self._buffers.alloc(size)
        mv = memoryview(buf)
        base = size // k
        bounds = [(i * base, base if i < k - 1 else size - (k - 1) * base)
                  for i in range(k)]
        errors: List[BaseException] = []
        # span context captured HERE: stripe threads are fresh threads,
        # the context variable does not follow them
        from ray_tpu_torch.util import tracing
        ctx = tracing.current_span()

        def run(off: int, ln: int, pc: Optional[_PoolConn]) -> None:
            mine = pc is None
            try:
                if mine:
                    # settled on every path, but the discharge is
                    # mine-correlated (release/discard run iff this
                    # stripe acquired) — correlation beyond the analyzer
                    # rtlint: resource-leak-ok(mine-correlated settle)
                    pc = self.acquire(addr)
                self._stream_range(pc, object_id, mv[off:off + ln],
                                   off, ln, ctx=ctx)
            except BaseException as e:  # noqa: BLE001 - joined below
                errors.append(e)
                if mine and pc is not None:
                    self.discard(pc)
            else:
                if mine:
                    self.release(pc)

        threads = [threading.Thread(target=run, args=(off, ln, None),
                                    daemon=True, name="data-stripe-pull")
                   for off, ln in bounds[1:]]
        for t in threads:
            t.start()
        run(bounds[0][0], bounds[0][1], pc0)
        for t in threads:
            # rtlint: blocks-ok(stripe workers run _stream_range, whose
            # every blocking op is EOF/reset-terminated; a dead holder
            # errors all stripes and the joins return — the 120s fetch
            # coalesce cap bounds the caller)
            t.join()
        if errors:
            raise errors[0]
        return buf

    def _stream_range(self, pc: _PoolConn, object_id: str,
                      view: memoryview, offset: int, length: int,
                      ctx=None) -> None:
        msg = {"op": "fetch_stream", "object_id": object_id,
               "offset": offset, "length": length, "raw": pc.raw}
        if pc.proto >= wire.DATA_PROTO_TRACE:
            from ray_tpu_torch.util import tracing
            tracing.attach_wire_trace(msg, ctx=ctx)
        pc.conn.send(msg)
        n, inline = self._read_stream_ack(pc, object_id, expect=length)
        if inline is not None:
            view[:n] = inline
            return
        self._recv_stream(pc, view[:n], n)

    def _read_stream_ack(self, pc: _PoolConn, object_id: str,
                         expect: Optional[int]):
        """(byte count, inline payload or None) from a fetch_stream ack
        — small ranges ride the ack itself, larger ones follow as bulk
        frames."""
        # rtlint: blocks-ok(ack for a just-sent fetch_stream: the
        # holder acks, errors, or EOFs; 120s fetch coalesce cap bounds
        # the caller-visible wait)
        head = pc.conn.recv()
        err = head.get("error")
        if err is not None:
            if "unknown op" in str(err):
                raise _LegacyPeer(err)
            raise FileNotFoundError(object_id)
        n = int(head["len"])
        if expect is not None and n != expect:
            # spool file changed size under a striped pull: sibling
            # stripes are already mid-flight against the old layout
            raise _StreamError(
                f"range ack {n} != requested {expect} for {object_id}")
        return n, head.get("data")

    def _recv_stream(self, pc: _PoolConn, view: memoryview,
                     n: int) -> None:
        if pc.raw:
            self._recv_stream_raw(pc.conn, view, n)
        else:
            self._recv_stream_msgs(pc.conn, view, n)

    @staticmethod
    def _recv_stream_raw(conn, view: memoryview, n: int) -> None:
        import socket as _socket
        hdr = bytearray(wire.BULK_HDR_LEN)
        hv = memoryview(hdr)
        got = 0
        # one socket wrapper for the whole stream: recv_exact_into's
        # MSG_WAITALL then drains each frame in a single syscall
        s = _socket.socket(fileno=conn.fileno())
        try:
            while True:
                # rtlint: blocks-ok(mid-stream read: the holder has
                # acked and is writing frames back-to-back; death mid-
                # stream resets the socket, 120s coalesce cap upstream)
                protocol.recv_exact_into(s, hv)
                kind, ln = wire.bulk_unpack_header(hdr)
                if kind == wire.BULK_DATA:
                    if got + ln > n:
                        raise _StreamError(
                            f"stream overrun ({got + ln} > {n})")
                    # rtlint: blocks-ok(same mid-stream contract as the
                    # header read above)
                    protocol.recv_exact_into(s, view[got:got + ln])
                    got += ln
                elif kind == wire.BULK_END:
                    break
                elif kind == wire.BULK_ERR:
                    eb = bytearray(ln)
                    # rtlint: blocks-ok(same mid-stream contract as the
                    # header read above)
                    protocol.recv_exact_into(s, memoryview(eb))
                    raise _StreamMiss(eb.decode("utf-8", "replace"))
                else:
                    raise _StreamError(f"bad bulk frame kind 0x{kind:02x}")
        finally:
            s.detach()  # fd ownership stays with the Connection
        if got != n:
            raise _StreamError(f"short stream ({got} of {n})")

    @staticmethod
    def _recv_stream_msgs(conn, view: memoryview, n: int) -> None:
        from multiprocessing.connection import BufferTooShort
        got = 0
        while got < n:
            try:
                # rtlint: blocks-ok(mid-stream read on the relay path —
                # same acked-stream contract as _recv_stream_raw, 120s
                # coalesce cap upstream)
                m = conn.recv_bytes_into(view, got)
            except BufferTooShort:
                raise _StreamError("stream overrun (relay)") from None
            if m == 0:
                raise _StreamMiss("stream aborted by holder")
            got += m

    # ------------------------------------------------------------ deletes
    def delete_batch(self, addr: str, object_ids,
                     max_redials: int = 2) -> None:
        """Best-effort spool delete of many objects over pooled
        connections.  A mid-batch hiccup drops only that object's delete
        and redials for the rest — but redials are BOUNDED: a peer that
        keeps dying (or a dead host whose dial times out) costs at most
        ``max_redials`` reconnect attempts for the whole batch, not one
        3s timeout per remaining object."""
        if not object_ids:
            return
        redials = 0
        pc: Optional[_PoolConn] = None
        try:
            for oid in object_ids:
                try:
                    if pc is None:
                        pc = self.acquire(addr)
                    pc.conn.send({"op": "delete_object", "object_id": oid})
                    pc.conn.recv()
                except (OSError, EOFError, ConnectionError):
                    if pc is None:
                        # the (re)dial itself failed: peer unreachable —
                        # drop the remaining deletes instead of paying a
                        # connect timeout per object
                        self.invalidate(addr)
                        return
                    self.discard(pc)
                    pc = None
                    redials += 1
                    if redials > max_redials:
                        self.invalidate(addr)
                        return  # repeatedly dying peer: give up on batch
        finally:
            if pc is not None:
                self.release(pc)
