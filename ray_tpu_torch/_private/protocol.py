"""Control-plane wire protocol.

Reference analog: the gRPC service layer (``src/ray/rpc/``, SURVEY.md §2.1).
We use unix-domain sockets via ``multiprocessing.connection`` with pickled
dict messages — the control plane carries only small metadata (task specs,
object metas); bulk data rides the shm object plane (``shm_store``).

Connections:
- **rpc**: client (driver/worker) → GCS, synchronous request/response.
  One connection per thread (thread-local) so concurrent driver threads
  (serve router, tune loop) don't serialize on one socket.
- **task**: GCS → worker push channel (execute_task / create_actor / stop);
  worker replies with one-way ``task_done`` events on the same socket.
- **actor**: caller → actor-worker direct channel for ordered method calls
  (reference: ``ActorTaskSubmitter`` direct gRPC, bypassing the raylet).
"""

from __future__ import annotations

import itertools
import os
import socket
import threading
import time
from multiprocessing.connection import Client, Connection, Listener
from typing import Any, Dict

# Per-session HMAC secret for every connection handshake.  Set from
# Session.auth_key() at process startup (init / worker_main); the fallback
# constant only exists for processes created before a session is known and
# is never accepted across the TCP proxy (the proxy process has the real
# key set).  Remote clients supply the key via RTT_AUTH_KEY.
_AUTHKEY = b"ray_tpu_torch"


def set_authkey(key: bytes) -> None:
    global _AUTHKEY
    _AUTHKEY = key


# request kinds are plain strings in msg["kind"]; responses echo msg["rid"].


# Accept backlog for cluster listeners.  multiprocessing.Listener's
# default is 1, and accept() runs the HMAC handshake inline — under a
# dial burst (worker churn: every worker opens rpc + task + ctl conns)
# the queue overflows and fresh connects die with EAGAIN.
_BACKLOG = 64


def make_listener(path: str) -> Listener:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    return Listener(address=path, family="AF_UNIX", authkey=_AUTHKEY,
                    backlog=_BACKLOG)


def serve_accept_loop(listener, should_stop, handle,
                      thread_name: str) -> None:
    """Accept connections until ``should_stop()``, spawning a named
    daemon thread running ``handle(conn)`` per connection.

    accept() runs the HMAC handshake INLINE, so a dialer dying
    mid-handshake (a worker SIGKILLed while booting, a half-open probe,
    a bad key) surfaces here as EOFError/ConnectionReset/
    AuthenticationError — a per-connection failure, NOT listener
    shutdown.  Treating it as shutdown bricks the control plane: with
    the accept thread dead no replacement peer can ever register (found
    via the chaos suite — respawned workers stuck in "starting" forever
    while the scheduler force-pumped into a full-but-dead pool).  Only
    ``should_stop()`` ends the loop; the sleep keeps a truly dead
    listener fd from spinning."""
    from multiprocessing import AuthenticationError
    while not should_stop():
        try:
            # rtlint: blocks-ok(parks until a peer dials; shutdown
            # closes the listener fd, which lands in the except arm and
            # exits via should_stop — the close IS the deadline)
            conn = listener.accept()
        except (OSError, EOFError, AuthenticationError):
            if should_stop():
                return
            time.sleep(0.01)
            continue
        threading.Thread(target=handle, args=(conn,), daemon=True,
                         name=thread_name).start()


def connect(path: str) -> Connection:
    """Unix-socket dial with a bounded retry on transient accept-queue
    overflow (EAGAIN on a unix connect = the listener's backlog is full,
    e.g. a worker-churn dial burst — not a dead head)."""
    deadline = None
    delay = 0.02
    while True:
        try:
            return Client(address=path, family="AF_UNIX", authkey=_AUTHKEY)
        except BlockingIOError:
            now = time.monotonic()
            if deadline is None:
                deadline = now + 5.0
            elif now > deadline:
                raise
            time.sleep(delay)
            delay = min(0.2, delay * 2)


def backoff_delays(cap: float = 0.25, base: float = 0.02):
    """Jittered exponential backoff delays (generator, never ends —
    the CALLER owns the deadline).  Jitter keeps a fleet of dialers
    hitting a recovering endpoint spread out instead of synchronized."""
    import random
    delay = base
    while True:
        yield delay * random.uniform(0.5, 1.5)
        delay = min(cap, delay * 2)


def connect_retry(path: str, deadline_s: float | None = None,
                  connect_fn=None) -> Connection:
    """GCS dial that treats a DEAD endpoint as a failover window, not an
    error: bounded jittered backoff on ConnectionRefusedError (stale
    socket file — the old head died) and FileNotFoundError (the
    promoted head hasn't re-bound the path yet), on top of connect()'s
    EAGAIN handling.  ``deadline_s`` defaults to the
    ``gcs_reconnect_deadline_s`` config; 0 fails fast (seed behavior).
    Also retries a ConnectionError raised by ``connect_fn`` itself when
    it mentions the proxy (a tunneled dial whose gcs.sock target is
    mid-failover)."""
    if deadline_s is None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        deadline_s = GLOBAL_CONFIG.gcs_reconnect_deadline_s
    fn = connect_fn or (lambda: connect(path))
    deadline = time.monotonic() + max(0.0, deadline_s)
    for delay in backoff_delays():
        try:
            return fn()
        except (ConnectionRefusedError, FileNotFoundError,
                ConnectionResetError) as e:
            if time.monotonic() + delay > deadline:
                raise
            _ = e
        except ConnectionError as e:
            # tunneled dials surface a dead gcs.sock as the proxy's
            # error reply; anything else (auth, version fence) is final
            if "client proxy" not in str(e) \
                    or time.monotonic() + delay > deadline:
                raise
        time.sleep(delay)
    raise ConnectionError("unreachable")  # pragma: no cover


def make_tcp_listener(host: str, port: int) -> Listener:
    """TCP listener for the client proxy (reference: Ray Client's gRPC
    endpoint ray://host:10001)."""
    return Listener(address=(host, port), family="AF_INET", authkey=_AUTHKEY,
                    backlog=_BACKLOG)


def connect_tcp(host: str, port: int,
                timeout: float | None = None) -> Connection:
    """TCP connect + HMAC handshake.  With ``timeout``, both the TCP
    connect and the handshake are bounded (SO_RCVTIMEO/SO_SNDTIMEO apply
    to the raw fd reads multiprocessing.Connection performs — a plain
    ``Client()`` would block for the OS SYN-retry window, minutes, when
    dialing an unreachable actor host).  The deadline is lifted once the
    handshake completes."""
    if timeout is None:
        return Client(address=(host, port), family="AF_INET", authkey=_AUTHKEY)
    import struct
    from multiprocessing.connection import answer_challenge, deliver_challenge
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        tv = struct.pack("ll", int(timeout), int((timeout % 1.0) * 1e6))
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
        sock.settimeout(None)  # blocking fd; the sockopts bound each syscall
        conn = Connection(sock.detach())
    except BaseException:
        sock.close()  # no-op after a successful detach
        raise
    try:
        answer_challenge(conn, _AUTHKEY)
        deliver_challenge(conn, _AUTHKEY)
        # handshake done — restore unbounded blocking I/O for normal
        # traffic.  The wrapper MUST detach even when setsockopt fails:
        # a GC'd undetached wrapper closes the fd out from under conn.
        s2 = socket.socket(fileno=conn.fileno())
        try:
            zero = struct.pack("ll", 0, 0)
            s2.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, zero)
            s2.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, zero)
        finally:
            s2.detach()
    except BaseException:
        conn.close()
        raise
    return conn


def tune_data_socket(conn: Connection) -> None:
    """Bulk-transfer socket tuning for a data-plane connection.

    TCP_NODELAY: the stream protocol writes a small frame header and
    then a large sendfile payload — Nagle would hold the header back
    waiting for an ACK and add an RTT per frame.  Bigger SO_RCVBUF /
    SO_SNDBUF keep line-rate streaming windows open on >1 Gb paths
    (the kernel may clamp to net.core.*mem_max; best effort).  No-op
    for non-TCP (unix-socket / proxied) connections."""
    try:
        s = socket.socket(fileno=conn.fileno())
    except OSError:
        return
    try:
        if s.family in (socket.AF_INET, socket.AF_INET6):
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
                try:
                    s.setsockopt(socket.SOL_SOCKET, opt, _DATA_SOCK_BUF)
                except OSError:
                    pass
    except OSError:
        pass
    finally:
        s.detach()  # fd ownership stays with the Connection


_DATA_SOCK_BUF = 4 * 1024 * 1024


def connect_data(host: str, port: int,
                 timeout: float | None = None) -> Connection:
    """Dial a peer's data-plane listener: bounded connect + handshake,
    then bulk-transfer socket tuning."""
    conn = connect_tcp(host, port, timeout=timeout)
    try:
        tune_data_socket(conn)
    except BaseException:
        conn.close()
        raise
    return conn


def recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from ``sock`` or raise EOFError — the raw-fd read
    half of the data plane's bulk-frame streaming.  ``MSG_WAITALL``
    lets the kernel fill the whole buffer in ONE syscall instead of one
    per socket-buffer drain (hundreds for a multi-MB frame — dominant
    on syscall-expensive sandboxed kernels); the loop covers the short
    returns the flag still permits (signals)."""
    got = 0
    n = len(view)
    while got < n:
        # rtlint: blocks-ok(mid-frame read: the sender has already
        # committed the bulk header, so bytes are in flight; peer death
        # surfaces as reset/EOF and aborts the pull, and the fetch
        # leader's coalesce deadline (gcs._pull_remote_local ev.wait
        # 120s) caps every follower's client-visible wait)
        r = sock.recv_into(view[got:], n - got, socket.MSG_WAITALL)
        if r <= 0:
            raise EOFError("connection closed mid-stream")
        got += r


def write_all(fd: int, data) -> None:
    """Write all of ``data`` (bytes-like) to ``fd``."""
    view = memoryview(data)
    while view.nbytes:
        n = os.write(fd, view)
        view = view[n:]


def writev_all(fd: int, parts) -> None:
    """Write every buffer in ``parts`` to ``fd`` with one ``writev``
    (short-write continuation included).  Gathering header+payload into
    a single syscall matters twice on the data plane: it halves the
    syscall count, and — the bigger win on loopback — the peer's
    blocking read wakes exactly once with the whole message buffered
    instead of waking on the header and blocking again for the body."""
    views = [memoryview(p) for p in parts if len(p)]
    while views:
        n = os.writev(fd, views)
        while n > 0:
            if n >= views[0].nbytes:
                n -= views[0].nbytes
                views.pop(0)
            else:
                views[0] = views[0][n:]
                n = 0


def send_msg_writev(conn: Connection, obj) -> None:
    """``conn.send(obj)`` with the length header and pickled body
    gathered into ONE writev.  ``Connection._send_bytes`` splits any
    message over 16 KB into two ``write()`` syscalls (header, then
    body); a blocking peer wakes on the header and blocks again for
    the body — a scheduler ping-pong worth hundreds of µs per message
    on syscall-expensive sandboxed kernels.  Wire bytes are identical
    to ``conn.send``, so either end may be a stock Connection."""
    import struct
    from multiprocessing.reduction import ForkingPickler
    buf = memoryview(ForkingPickler.dumps(obj))
    n = buf.nbytes
    if n > 0x7FFFFFFF:
        parts = [struct.pack("!i", -1), struct.pack("!Q", n), buf]
    else:
        parts = [struct.pack("!i", n), buf]
    writev_all(conn.fileno(), parts)


def parse_tcp_addr(addr: str):
    """'tcp://host:port' → (host, port) or None for unix paths."""
    if not addr.startswith("tcp://"):
        return None
    host, _, port = addr[len("tcp://"):].rpartition(":")
    return host, int(port)


def make_tcp_actor_listener() -> Listener:
    """Ephemeral-port TCP listener for an actor on a remote-agent host
    (its unix sockets are unreachable from other hosts)."""
    return Listener(address=("0.0.0.0", 0), family="AF_INET",
                    authkey=_AUTHKEY, backlog=_BACKLOG)


def connect_addr(addr: str, timeout: float | None = None) -> Connection:
    """Connect to a unix socket path or a tcp://host:port address."""
    tcp = parse_tcp_addr(addr)
    if tcp is not None:
        return connect_tcp(*tcp, timeout=timeout)
    return connect(addr)


def tunnel_connect(host: str, port: int, target: str) -> Connection:
    """Open a proxied connection to a cluster-local socket via the client
    proxy (single implementation of the {target}→{ok|error} handshake)."""
    from ray_tpu_torch._private import lock_watchdog as _lw
    conn = connect_tcp(host, port)
    try:
        conn.send({"target": target})
        # the proxy answers a {target} probe immediately or never (a
        # wedged head): gate the recv on a declared-bounded poll so the
        # dial fails fast instead of hanging the caller forever
        deadline = _lw.BLOCK_BOUNDS["protocol.tunnel_connect.handshake"]
        with _lw.bounded_block("protocol.tunnel_connect.handshake"):
            if not conn.poll(deadline):
                raise ConnectionError(
                    f"client proxy: no handshake reply in {deadline}s")
            # rtlint: blocks-ok(poll gate above proved a frame is
            # buffered; recv drains it without parking)
            resp = conn.recv()
    except BaseException:
        # a proxy that dies mid-handshake must not leak the dialed conn
        conn.close()
        raise
    if resp.get("error"):
        conn.close()
        raise ConnectionError(f"client proxy: {resp['error']}")
    return conn


def set_authkey_from_env() -> None:
    key = os.environ.get("RTT_AUTH_KEY")
    if key:
        set_authkey(bytes.fromhex(key))


class RpcChannel:
    """Synchronous request/response client over one Connection.

    ``negotiate=True`` performs the ``__proto_hello__`` exchange
    (``_private/wire.py``) right after construction: the channel then
    speaks the agreed frame version (rtmsg control codec at v2) instead of
    legacy raw pickle.  A version-fenced server (``proto_min_version``)
    raises ConnectionError here — version skew fails loudly at dial time,
    not as a mid-stream decode error.
    """

    _rid_counter = itertools.count(1)

    def __init__(self, conn: Connection,
                 negotiate: bool = False):  # rtlint: owns(conn)
        self._conn = conn
        self._lock = threading.Lock()
        self.closed = False
        self.version = 0  # legacy until negotiated
        if negotiate:
            try:
                self.negotiate()
            except BaseException:
                # the channel owns the conn from here on: a failed
                # negotiation (version fence, dead peer) must close it,
                # not strand it — the caller gets no channel back
                self.close()
                raise

    def negotiate(self) -> int:
        from ray_tpu_torch._private import wire
        try:
            resp = self.call("__proto_hello__",
                             versions=list(range(wire.PROTO_MIN,
                                                 wire.PROTO_MAX + 1)))
        except (ConnectionError, EOFError, OSError):
            # ConnectionError: the server's explicit version rejection
            # (proto_min_version fence) — or a genuinely dead conn.
            # Either way the dial must fail loudly.
            raise
        except Exception:  # noqa: BLE001 - pre-versioning server: unknown
            # rpc kind → server error reply.  Both ends speak legacy
            # pickle fine; degrade instead of refusing to connect.
            self.version = 0
            return 0
        self.version = int(resp.get("proto", 0))
        return self.version

    def call(self, kind: str, **fields: Any) -> Dict[str, Any]:
        from ray_tpu_torch._private import wire
        rid = next(self._rid_counter)
        msg = {"kind": kind, "rid": rid, **fields}
        if self.version >= wire.PROTO_TRACE:
            # wire-propagated span context (no-op unless the calling
            # thread holds a sampled span): the server adopts it for the
            # dispatch so its flight-recorder/timeline rows link back
            from ray_tpu_torch.util import tracing
            tracing.attach_wire_trace(msg)
        with self._lock:
            try:
                wire.conn_send(self._conn, msg, self.version)
                while True:
                    # rtlint: blocks-ok(request/reply wait: the server
                    # replies to every rid'd frame (rtlint's replies pass
                    # proves arm totality) or dies, and its death EOFs this
                    # recv; callers needing a tighter deadline run their
                    # own timer and close the channel)
                    resp, _ = wire.conn_recv(self._conn)
                    if resp.get("rid") == rid:
                        break
            except BaseException:
                # an interruption between a frame's header and its body
                # (a task cancel's asynchronous exception, a dead peer)
                # leaves the stream misaligned: the next read would take
                # body bytes for a length and block forever.  Never reuse
                # it; the pool dials a fresh channel.
                self.close()
                raise
        if resp.get("error") is not None:
            from ray_tpu_torch._private.serialization import loads_call
            raise loads_call(resp["error"])
        return resp

    def send_oneway(self, kind: str, **fields: Any) -> None:
        from ray_tpu_torch._private import wire
        msg = {"kind": kind, "rid": None, **fields}
        if self.version >= wire.PROTO_TRACE:
            from ray_tpu_torch.util import tracing
            tracing.attach_wire_trace(msg)
        with self._lock:
            wire.conn_send(self._conn, msg, self.version)

    def close(self) -> None:
        self.closed = True
        try:
            self._conn.close()
        except OSError:
            pass


class RpcPool:
    """Thread-local RpcChannel factory to a fixed socket path (or any
    custom ``connect_fn`` — the client proxy tunnels through TCP)."""

    def __init__(self, path: str, on_new=None, connect_fn=None):
        self._path = path
        self._on_new = on_new
        self._connect_fn = connect_fn or (lambda: connect(self._path))
        self._tls = threading.local()
        self._all = []
        self._lock = threading.Lock()

    def channel(self) -> RpcChannel:
        ch = getattr(self._tls, "ch", None)
        if ch is not None and ch.closed:    # broken mid-call (see call)
            self.invalidate()
            ch = None
        if ch is None:
            ch = RpcChannel(self._connect_fn(), negotiate=True)
            self._tls.ch = ch
            with self._lock:
                self._all.append(ch)
            if self._on_new is not None:
                self._on_new(ch)
        return ch

    def call(self, kind: str, **fields: Any) -> Dict[str, Any]:
        return self.channel().call(kind, **fields)

    def invalidate(self) -> None:
        """Drop this thread's (presumed-broken) channel so the next
        ``channel()`` dials a fresh connection — the reconnect primitive
        for GCS-restart fault tolerance."""
        ch = getattr(self._tls, "ch", None)
        if ch is None:
            return
        self._tls.ch = None
        with self._lock:
            try:
                self._all.remove(ch)
            except ValueError:
                pass
        ch.close()

    def close_all(self) -> None:
        with self._lock:
            chans, self._all = self._all, []
        for ch in chans:
            ch.close()


def shutdown_conn(conn: Connection) -> None:
    """Force-terminate a Connection even while another thread is blocked
    in recv() on it.  A bare ``close()`` only drops the fd-table entry;
    the blocked read keeps the kernel socket alive, so the peer never
    sees FIN and EOF never propagates (a relay that close()s a pair of
    pumped connections silently leaks the other direction).  shutdown()
    acts on the socket itself: it interrupts blocked reads and sends FIN.
    """
    try:
        s = socket.socket(fileno=conn.fileno())
    except OSError:
        return
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    finally:
        s.detach()  # fd ownership stays with the Connection


def hostname() -> str:
    return socket.gethostname()
