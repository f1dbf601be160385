"""Worker: the per-process runtime embedded in drivers and workers.

Reference: ``CoreWorker`` (``src/ray/core_worker/``, SURVEY.md §2.1) +
``python/ray/_private/worker.py``.  One ``Worker`` instance per process:

- drivers and task workers both embed it (the reference embeds CoreWorker in
  every process via Cython; ours is pure Python talking to the GCS over the
  control socket and to /dev/shm for data),
- task submission (``submit``) and the ordered direct actor-call path
  (``call_actor`` — reference ``ActorTaskSubmitter``: caller ⇄ actor socket,
  control plane not on the hot path),
- ``get``/``put``/``wait``/``release`` with zero-copy shm reads,
- the executor loop run by worker processes (``run_worker_loop``): normal
  tasks, actor instantiation, the actor method server.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import data_plane, protocol, rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import KIND_PUT, KIND_RETURN, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.serialization import (
    deserialize_from, dumps_call, loads_call, serialize_to_bytes,
)
from ray_tpu_torch._private.session import Session
from ray_tpu_torch._private.shm_store import ShmObjectStore, _seg_path
from ray_tpu_torch.util import metrics_catalog as mcat
from ray_tpu_torch.util import tracing
from ray_tpu_torch import exceptions as exc

logger = rtlog.get("worker")

_global_worker: Optional["Worker"] = None
_global_lock = threading.Lock()


def global_worker() -> "Worker":
    if _global_worker is None:
        raise exc.RayTpuError("ray_tpu_torch.init() has not been called")
    return _global_worker


def try_global_worker() -> Optional["Worker"]:
    return _global_worker


def set_global_worker(w: Optional["Worker"]) -> None:
    global _global_worker
    with _global_lock:
        _global_worker = w


def _dump_all_stacks() -> str:
    """All-thread stack snapshot of this process (``ray_tpu_torch stack``)."""
    import traceback
    out = []
    for tid, frame in sys._current_frames().items():
        name = next((t.name for t in threading.enumerate()
                     if t.ident == tid), "?")
        out.append(f"--- thread {name} ({tid}) ---\n"
                   + "".join(traceback.format_stack(frame)))
    return "\n".join(out)


def _counter():
    n = [0]
    lock = threading.Lock()

    def nxt() -> int:
        with lock:
            n[0] += 1
            return n[0]
    return nxt


def shm_write_wire(oid: str, wire: bytes, overwrite: bool = False) -> None:
    """Write pre-serialized wire bytes into the object's shm segment.

    The single shm-segment writer: ``put``, task returns, and actor results
    all go through here.  ``overwrite=True`` is for lineage reconstruction,
    which re-creates an object id whose segment may still exist.
    """
    import mmap
    # the store's own segment path: RTT_SHM_DIR is honoured everywhere
    path = str(_seg_path(oid))
    flags = os.O_CREAT | os.O_RDWR | (0 if overwrite else os.O_EXCL)
    fd = os.open(path, flags, 0o600)
    try:
        # exact final size up front: an overwrite (reconstruction) may be
        # SMALLER than the old segment — stale tail bytes would corrupt
        # size accounting (store.adopt) and reads
        os.ftruncate(fd, max(len(wire), 1))
        # write() over mmap-and-memcpy: fresh tmpfs pages fault once
        # in-kernel instead of once per user-space touch (~2x)
        mv = memoryview(wire)
        while mv.nbytes:
            mv = mv[os.write(fd, mv):]
    finally:
        os.close(fd)


def shm_write_value(oid: str, pickled: bytes, buffers, *,
                    overwrite: bool = False) -> int:
    """Serialize straight into the object's shm segment with writev —
    the single-copy write path for large objects (buffers → page cache,
    no intermediate wire bytearray).  Returns the segment size."""
    from ray_tpu_torch._private.serialization import write_value_to_fd
    # the store's own segment path: RTT_SHM_DIR is honoured everywhere
    path = str(_seg_path(oid))
    flags = os.O_CREAT | os.O_WRONLY | (0 if overwrite else os.O_EXCL)
    fd = os.open(path, flags, 0o600)
    try:
        if overwrite:
            os.ftruncate(fd, 0)
        return write_value_to_fd(fd, pickled, buffers)
    finally:
        os.close(fd)


class _TaskContext(threading.local):
    def __init__(self):
        self.task_id: Optional[str] = None
        self.in_task = False


class Worker:
    def __init__(self, session: Optional[Session], role: str,
                 node_id: Optional[str] = None,
                 proxy_addr: Optional[tuple] = None):
        self.session = session
        self.role = role
        self.worker_id = WorkerID.new()
        self.node_id = node_id
        self.proxy_addr = proxy_addr
        self.is_client = proxy_addr is not None
        # GCS dials ride a bounded jittered backoff on dead-endpoint
        # errors (protocol.connect_retry): a head failover window
        # (standby promoting, socket re-binding — DESIGN.md §4l)
        # surfaces as dial latency, not ConnectionRefusedError.
        if self.is_client:
            # remote-client mode (reference: Ray Client, SURVEY.md §2.3):
            # every connection tunnels through the TCP proxy; no local
            # data plane (see put/_materialize client branches)
            self.gcs_path = "gcs"
            self.pool = protocol.RpcPool(
                self.gcs_path, on_new=self._on_new_channel,
                connect_fn=lambda: protocol.connect_retry(
                    self.gcs_path,
                    connect_fn=lambda: self._tunnel("gcs")))
        else:
            self.gcs_path = session.socket_path("gcs.sock")
            self.pool = protocol.RpcPool(
                self.gcs_path, on_new=self._on_new_channel,
                connect_fn=lambda: protocol.connect_retry(self.gcs_path))
        self._put_seq = _counter()
        self._ret_seq = _counter()
        self._task_seq = _counter()
        self._call_seq = _counter()
        self._dedup_seq = _counter()
        self._fn_cache: Dict[str, Any] = {}
        self._exported: set = set()
        import weakref
        self._fn_id_cache: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        # guarded by: _local_lock
        self._local_values: "OrderedDict[str, bytes]" = OrderedDict()
        self._local_lock = threading.Lock()
        # signaled on every inline-result arrival AND on actor-channel
        # death: get() parks here for in-flight direct calls instead of
        # paying the GCS get_meta machinery (the reader thread loses the
        # race on small hosts, turning every serial actor RT into a full
        # control-plane round-trip — measured 2x the direct-path latency)
        self._local_cv = threading.Condition(self._local_lock)
        # guarded by: _actor_chan_lock
        self._actor_channels: Dict[str, "_ActorChannel"] = {}
        self._actor_chan_lock = threading.Lock()
        # in-flight chunked pulls                guarded by: _pull_lock
        self._pulls: Dict[str, dict] = {}
        self._pull_lock = threading.Lock()
        # Batched ObjectRef drops, buffered PER THREAD and flushed on the
        # owning thread's (thread-local) channel.  This preserves the exact
        # per-channel FIFO the unbatched code had — a release always lands
        # on the same channel as, and after, that thread's earlier submits,
        # so a pipelined `put(x); f.remote(r); del r` can never have its
        # decref overtake the submit on another connection and free the dep
        # before the GCS sees the task.  (Deferral only ever delays a
        # release — the safe direction.)  The registry exists so shutdown
        # can drain buffers of threads that went idle; RLock because
        # release() runs from __del__ and an in-lock allocation can
        # trigger cyclic GC that re-enters on the same thread.
        self._release_tls = threading.local()
        # guarded by: _release_lock
        self._release_bufs: Dict[int, List[str]] = {}
        self._release_lock = threading.RLock()
        # Client-side pin/release netting (actor-call return refs ONLY —
        # refs whose seal is concurrent with the pin, so the GCS's 10s
        # rc-0-at-seal grace covers the parked window): a pin buffers
        # here and a release of the same oid CANCELS it before either
        # becomes a message — the get-and-drop hot loop then sends no
        # refcount traffic at all.  Still-held pins are drained onto the
        # ordered submit stream by the flusher's idle tick within ~1s.
        # Guarded by _release_lock (same __del__ reentrancy rules as the
        # release buffers).
        # guarded by: _release_lock
        self._pending_pins: Dict[str, int] = {}
        # return-oid → (actor_id, call_id) for in-flight actor calls: a
        # result observed through ANY path (inline reply, GCS get) marks
        # the call complete, so a racing disconnect can't resubmit an
        # already-executed method (see _ActorChannel._on_disconnect)
        self._inflight_calls: Dict[str, Tuple[str, str]] = {}
        # Pipelined submit batching (reference: lease-cached submission +
        # the r2 release batching): specs buffer here and ship 64-to-a-
        # message.  Ordering contract: any release referencing a buffered
        # spec's deps must flush AFTER the spec — release paths call
        # _flush_submits() first.  Out-of-order put_object vs submit is
        # safe (the GCS promotes dep-waiters when the object arrives).
        # interleaved specs + releases          guarded by: _submit_lock
        self._submit_buf: List[Any] = []
        self._submit_lock = threading.Lock()
        # serializes pop→send in _drain_submits: without it two threads
        # (64-full caller vs flusher) could pop successive batches and
        # reach the wire in either order, letting a release overtake the
        # submit whose dep pin it retires.  Ordering: acquire BEFORE
        # _submit_lock, never the reverse.
        self._submit_send_lock = threading.Lock()
        self._submit_first: float = 0.0
        self._submit_flusher_on = False
        # event-driven flusher wakeup: set when something buffers, cleared
        # when the buffer drains — an idle process must not pay 500
        # scheduler wakeups/s for an empty-buffer poll loop (measured
        # contention on 1-2 core hosts)
        self._submit_pending = threading.Event()
        # revoked (task_id, dseq) pairs, insertion-ordered so overflow
        # evicts the OLDEST revocation (an arbitrary set.pop could evict
        # the pair a drop_queued just added, un-revoking it)
        self._dropped_ids: "OrderedDict[tuple, None]" = OrderedDict()
        self._oneway_chan: Optional[protocol.RpcChannel] = None
        self._oneway_init_lock = threading.Lock()
        # Owner-based lineage across head restarts (reference: TaskManager
        # lives in the OWNING worker): every submitted spec is retained
        # until one of its returns is observed terminal or its refs are
        # all released; on reconnect to a RESTARTED head (epoch change)
        # the owner resubmits the survivors — a head crash must not
        # strand a caller's get() forever.
        # guarded by: _owned_lock
        self._owned_specs: "OrderedDict[str, dict]" = OrderedDict()
        # return oid -> task_id                  guarded by: _owned_lock
        self._owned_by_ret: Dict[str, str] = {}
        # RLock: the cyclic GC may run an ObjectRef's __del__ on a thread
        # that holds it, and release() re-enters _untrack_owned_ret
        self._owned_lock = threading.RLock()
        self._gcs_epoch: Optional[str] = None
        self._pull_sem = threading.Semaphore(
            max(1, GLOBAL_CONFIG.transfer_max_inflight))
        # pooled data-plane connections for peer pulls (dial+HMAC paid
        # once per holder, not once per object); thread-safe internally
        self._data_pool = data_plane.DataPlanePool(dial=self._dial_data)
        # Raylet attachment (DESIGN.md §4i): spawned workers on a raylet
        # node dial the LOCAL per-node scheduler for their task/ctl
        # channels and route release oneways to it for netting, instead
        # of tunneling every frame to the head.  Absent env (no raylet
        # advertised — single-process tests, cluster_utils.Cluster,
        # legacy agents) → direct-GCS, byte-identical to before.
        self.raylet_sock = (os.environ.get("RTT_RAYLET_SOCK")
                            if role == "worker" else None)
        # a worker that sees the node's cards says so when it registers
        # and attaches: the head and a node's raylet start GPU work on
        # such workers alone
        self.gpu = role == "worker" and \
            os.environ.get("RTT_GPU_WORKER") == "1"
        self._raylet_ref_conn = None
        self._raylet_ref_lock = threading.Lock()
        self.ctx = _TaskContext()
        self._pid = os.getpid()  # cached: getpid is a real syscall per call
        self._ctl_down = True    # flipped by the ctl thread on attach
        self._task_conn = None
        self._task_conn_lock = threading.Lock()
        self._actor_announce: Optional[dict] = None  # set in _become_actor
        self._current_spec: Optional[dict] = None
        self._exec_thread_id: Optional[int] = None
        # a cancel raises in the exec thread only while the task's own
        # code runs; one that arrives earlier waits in _cancel_pending
        self._cancel_lock = threading.Lock()
        self._in_user_fn = False                       # guarded by: _cancel_lock
        self._cancel_pending: "OrderedDict[str, None]" = OrderedDict()  # guarded by: _cancel_lock
        self._stop = threading.Event()
        self._profile_events: List[dict] = []
        self._slab = None          # native slab store attachment (lazy)
        self._slab_tried = self.is_client  # clients have no local data plane
        # in the shm directory's session registry before this process
        # makes a segment (session.reap_orphan_segments)
        if session is not None and not self.is_client:
            session.register_process()
        # registration happens on first channel creation
        info = self.pool.call("register_client", role=role,
                              client_id=self.worker_id, pid=os.getpid(),
                              node_id=node_id, gpu=self.gpu)
        self.node_id = info["node_id"]
        if self._gcs_epoch is None:
            self._gcs_epoch = info.get("epoch")
        if session is not None and not self.is_client:
            # crash-surviving flight recorder (DESIGN.md §4h); in the
            # head==driver process the GCS already installed one and
            # this is a no-op (first installer of a session wins)
            from ray_tpu_torch._private import flight_recorder
            flight_recorder.maybe_install(session.path, role)
        if not self.is_client:
            # always-on sampling profiler (DESIGN.md §4o); same
            # first-installer-wins idempotence as the flight recorder,
            # deltas ride the metrics publisher below
            from ray_tpu_torch.util import profiler as profiler_mod
            profiler_mod.maybe_install(role)
        self._start_metrics_publisher()

    # ------------------------------------------------------ metrics publisher
    def _start_metrics_publisher(self) -> None:
        """Always-on telemetry (reference: the per-node metrics agent's
        export loop): a daemon thread pushes this process's metric
        registry to the GCS KV every ``metrics_export_period_s`` so
        `/metrics` and `ray_tpu_torch metrics` show live data with zero user
        wiring.  Off the task hot path by construction — one kv_put per
        period (>= 1s), nothing per task.  Clients skip it: they have no
        built-in instrumentation and every publish would tunnel through
        the head proxy."""
        if self.is_client or not GLOBAL_CONFIG.metrics_enabled:
            return
        threading.Thread(target=self._metrics_publish_loop,
                         name="metrics-publisher", daemon=True).start()

    def _metrics_publish_loop(self) -> None:
        import random

        from ray_tpu_torch.util import metrics as metrics_mod
        period = max(1.0, GLOBAL_CONFIG.metrics_export_period_s)
        err_logged = False
        # jittered: a fleet of workers forked together must not land
        # synchronized kv_puts on the head every period
        from ray_tpu_torch.util import profiler as profiler_mod
        while not self._stop.wait(period * random.uniform(0.75, 1.25)):
            try:
                metrics_mod.publish(self)
                # the profiler's folded-stack delta rides the same
                # cadence and connection (§4o) — one more kv_put per
                # period, nothing per task
                profiler_mod.publish(self)
                err_logged = False
            except Exception:  # noqa: BLE001 - head restarting / shutting
                # down: telemetry must never take a process with it; the
                # next cycle retries against the healed control plane.
                # Logged (once per failure streak) because the cause may
                # be PERSISTENT — e.g. a user metric whose tag value
                # json.dumps can't serialize — and a silently dark
                # process is undiagnosable.
                if self._stop.is_set():
                    return
                if not err_logged:
                    err_logged = True
                    logger.warning("metrics publish failed (will keep "
                                   "retrying every %.0fs)", period,
                                   exc_info=True)

    def _final_metrics_flush(self) -> None:
        """One last publish on clean shutdown so short-lived processes'
        series (e.g. a task worker that just finished) are visible."""
        if self.is_client or not GLOBAL_CONFIG.metrics_enabled:
            return
        try:
            from ray_tpu_torch.util import metrics as metrics_mod
            metrics_mod.publish(self)
        except Exception:  # noqa: BLE001 - control plane already gone
            pass
        try:
            from ray_tpu_torch.util import profiler as profiler_mod
            profiler_mod.publish(self)
        except Exception:  # noqa: BLE001 - control plane already gone
            pass

    # ------------------------------------------------------------- plumbing
    def _on_new_channel(self, ch: protocol.RpcChannel) -> None:
        # Every extra thread-local channel re-registers (idempotent server-side)
        if getattr(self, "node_id", None) is not None:
            info = ch.call("register_client", role=self.role,
                           client_id=self.worker_id,
                           pid=os.getpid(), node_id=self.node_id,
                           gpu=self.gpu)
            epoch = info.get("epoch")
            if self._gcs_epoch is None:
                self._gcs_epoch = epoch
            elif epoch is not None and epoch != self._gcs_epoch:
                # a DIFFERENT head: its task table died with the old one —
                # resubmit every owned in-flight spec (at-least-once; a
                # surviving worker's late result for the same task seals
                # the same return ids, which the seal path tolerates)
                self._gcs_epoch = epoch
                # the new head's per-worker dispatch sequences restart:
                # stale revocations must not swallow re-dispatched tasks
                self._dropped_ids.clear()
                self._resubmit_owned(ch)

    # Two-way RPC kinds that MUTATE server state: these carry a _dedup id
    # so the one post-reconnect retry is exactly-once against a still-live
    # GCS (channel broke after apply, before the reply).  Reads are
    # idempotent and excluded — caching their replies would pin bulk data
    # (fetch_chunk carries multi-MB payloads) on the head for no benefit.
    # One-way mutations (submit_task/add_refs/release*) are never retried
    # by this path and need no dedup.
    _DEDUP_KINDS = frozenset({
        "put_object", "put_chunk", "create_actor", "kill_actor",
        "export_function", "seal_errors", "kv_put", "kv_del",
        "pg_create", "pg_remove", "add_node", "remove_node"})

    def _local_server(self):
        """The GcsServer living in THIS process (head == driver), if it is
        the one this worker is attached to — the in-process dispatch
        short-circuit.  None for spawned workers, clients, and drivers
        attached to an external head."""
        if self.is_client:
            return None
        from ray_tpu_torch._private import gcs as gcs_mod
        srv = gcs_mod._INPROC_SERVER
        if srv is not None and not srv._shutdown and not srv._fenced \
                and srv.rpc_path == self.gcs_path:
            # _fenced: a promoted standby claimed the ledger (§4l) —
            # fall through to the socket path, which re-dials gcs.sock
            # and lands on the NEW head's re-bound listener
            return srv
        return None

    def rpc(self, kind: str, _reconnect: bool = True, **fields: Any) -> dict:
        # Two-way calls observe prior submits (FIFO illusion): flush the
        # submit batch first — e.g. a get_meta on a buffered task's return
        # must find the task registered.
        if self._submit_buf:
            self._flush_submits()
        srv = self._local_server()
        if srv is not None:
            return srv.local_call(
                kind, {"kind": kind, "client_id": self.worker_id, **fields})
        # Across a true GCS restart the dedup cache is empty and the retry
        # re-applies — the documented at-least-once contract for head
        # fault tolerance (fresh object table).  A counter suffices: the
        # server's dedup key is (client_id, id) and client ids are unique
        # per process (uuid4 here cost ~30µs per put on small hosts).
        if kind in self._DEDUP_KINDS:
            fields["_dedup"] = self._dedup_seq()
        try:
            return self.pool.call(kind, client_id=self.worker_id, **fields)
        except (EOFError, OSError, ConnectionError):
            # GCS conn lost (head crash/restart).  Reconnect with grace and
            # re-issue ONCE (reference: retryable gRPC clients + raylets
            # reconnecting to a restarted GCS).  _reconnect=False callers
            # (best-effort telemetry) must never drive the heal themselves:
            # a background pool.invalidate() can yank a channel the MAIN
            # thread's reconnect dance just re-established.  Remote-agent
            # WORKERS (is_client but role=worker) do heal: on a raylet
            # node the task conn is local and never notices a head
            # restart, so the tunneled rpc pool must reconnect on its
            # own — only interactive CLIENTS surface the break.
            if (self.is_client and self.role != "worker") \
                    or self._stop.is_set() or not _reconnect:
                raise
            self._reconnect_pool()
            return self.pool.call(kind, client_id=self.worker_id, **fields)

    def _reconnect_pool(self) -> None:
        """Re-dial the GCS socket until it answers or the grace expires.
        A fresh channel re-registers via the pool's on_new hook."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        deadline = time.monotonic() + GLOBAL_CONFIG.gcs_reconnect_timeout_s
        logger.warning("lost GCS connection; retrying for up to %.0fs",
                       GLOBAL_CONFIG.gcs_reconnect_timeout_s)
        while not self._stop.is_set():
            self.pool.invalidate()
            self._oneway_chan = None  # the ordered oneway channel too
            try:
                self.pool.channel()
                logger.info("reconnected to GCS")
                return
            except (EOFError, OSError, ConnectionError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.5)
        raise ConnectionError("worker stopping during GCS reconnect")

    def rpc_oneway(self, kind: str, **fields: Any) -> None:
        """One-way sends ride ONE shared channel (RpcChannel serializes
        sends internally), so every oneway in this process is globally
        FIFO at the server: a release can never overtake the submit whose
        dep pin it retires even when different threads (e.g. the submit
        flusher vs the GC) issue them.

        In-process head: apply inline instead (strictly program-ordered —
        stronger than the channel FIFO); handler errors are logged, not
        raised, matching the socket path's fire-and-forget contract."""
        srv = self._local_server()
        if srv is not None:
            try:
                srv.local_call(kind, {"kind": kind, "rid": None,
                                      "client_id": self.worker_id, **fields})
            except Exception:  # noqa: BLE001 - oneway: log like the server
                logger.exception("local one-way rpc %s failed", kind)
            return
        if self.raylet_sock is not None and kind in (
                "release", "release_batch"):
            # owner-local refcount batch (§4i): the raylet nets these and
            # reconciles to the GCS ledger asynchronously.  Releases only
            # — delaying a release is categorically safe (it can only
            # delay a free); pins keep their direct-channel ordering.
            if self._send_raylet_ref(kind, fields):
                return
            # raylet gone (node tearing down): fall through to direct
        ch = self._oneway_chan
        if ch is None:
            with self._oneway_init_lock:
                ch = self._oneway_chan
                if ch is None:
                    ch = protocol.RpcChannel(self.open_conn(self.gcs_path),
                                             negotiate=True)
                    self._oneway_chan = ch
        try:
            ch.send_oneway(kind, client_id=self.worker_id, **fields)
        except (OSError, ValueError, ConnectionError):
            self._oneway_chan = None  # re-dial on next use
            raise

    def _send_raylet_ref(self, kind: str, fields: dict) -> bool:
        """Ship one release oneway to the local raylet's netting buffer.
        Returns False (caller falls back to the direct channel) when the
        raylet socket is unreachable."""
        with self._raylet_ref_lock:
            conn = self._raylet_ref_conn
            try:
                if conn is None:
                    conn = protocol.connect(self.raylet_sock)
                    self._raylet_ref_conn = conn  # owned before any send
                    conn.send({"kind": "ref_chan",
                               "worker_id": self.worker_id})
                conn.send({"kind": kind, "client_id": self.worker_id,
                           **fields})
                return True
            except (OSError, ValueError, EOFError):
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
                self._raylet_ref_conn = None
                return False

    def _tunnel(self, target: str):
        """Open a proxied connection to a cluster-local unix socket."""
        return protocol.tunnel_connect(*self.proxy_addr, target)

    def open_conn(self, addr: str):
        """Connect to a cluster socket directly or via the client proxy.

        ``tcp://host:port`` addresses (actors on remote-agent hosts) are
        dialed directly with a bounded connect+handshake — an unreachable
        host must fail in seconds, not the OS SYN-retry window.  Proxied
        processes fall back to the head proxy dialing out on their behalf
        (hub-spoke topologies where sibling hosts can't reach each
        other); head-side callers have no such relay — an agent behind
        NAT can run tasks but its actors are only callable from hosts
        that can route to it (documented in DESIGN.md)."""
        tcp = protocol.parse_tcp_addr(addr)
        if self.is_client:
            if tcp is not None:
                try:
                    return protocol.connect_addr(addr, timeout=3.0)
                except (OSError, ConnectionError):
                    pass
            return self._tunnel(addr)
        if tcp is not None:
            return protocol.connect_addr(addr, timeout=3.0)
        if addr == self.gcs_path:
            # head socket: cover the failover re-bind window (§4l)
            return protocol.connect_retry(addr)
        return protocol.connect_addr(addr)

    def _dial_data(self, addr: str):
        """Data-plane dial for the connection pool: (conn, raw).

        ``raw=True`` only for a DIRECT tcp connection — bulk frames ride
        the socket fd itself (sendfile / recv_into).  A tunneled
        connection crosses the head proxy's message pump, which re-frames
        Connection messages, so bulk frames must ride ``send_bytes``
        messages there (same ladder as :meth:`open_conn`)."""
        tcp = protocol.parse_tcp_addr(addr)
        if tcp is not None:
            if self.is_client:
                try:
                    return protocol.connect_data(*tcp, timeout=3.0), True
                except (OSError, ConnectionError):
                    return self._tunnel(addr), False
            return protocol.connect_data(*tcp, timeout=3.0), True
        if self.is_client:
            return self._tunnel(addr), False
        return protocol.connect_addr(addr), False

    def _send_event(self, msg: dict) -> None:
        with self._task_conn_lock:
            if self._task_conn is not None:
                try:
                    self._task_conn.send(msg)
                except (OSError, ValueError):
                    pass

    @property
    def slab(self):
        """Attachment to the session's native slab store (None if absent)."""
        if not self._slab_tried:
            self._slab_tried = True
            if GLOBAL_CONFIG.use_native_store:
                from ray_tpu_torch.native import SlabStore
                self._slab = SlabStore.attach(self.session.slab_path())
        return self._slab

    def _write_wire(self, oid: str, wire: bytes, overwrite: bool = False) -> str:
        """Store wire bytes on the data plane; returns the loc recorded in the
        object's metadata.  Small → native slab (one futex + memcpy, no
        daemon traffic); large → own tmpfs segment (zero-copy mmap reads)."""
        slab = self.slab
        if slab is not None and len(wire) <= GLOBAL_CONFIG.slab_object_max_bytes:
            if overwrite:
                slab.delete(oid)  # reconstruction re-creates the id
            if slab.put(oid, wire):
                return "slab"
            # slab full / out of slots → fall through to file-per-object
        shm_write_wire(oid, wire, overwrite=overwrite)
        return "shm"

    # ------------------------------------------------------------ put / get
    def put(self, value: Any, _owner_kind: str = KIND_PUT) -> ObjectRef:
        from ray_tpu_torch._private.serialization import (serialize,
                                                    serialized_size,
                                                    to_wire_bytes)
        # deferred decrefs must land before allocating: a put loop that
        # drops its previous refs would otherwise fill the store with
        # garbage and force spills instead of deletes
        self._flush_releases()
        oid = ObjectID.make(self.worker_id, _owner_kind, self._put_seq())
        pickled, buffers, refs = serialize(value)
        size = serialized_size(pickled, buffers)
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_object_store_put_bytes").inc(size)
        contained = [str(r.id) for r in refs]
        slab = self.slab
        tiny = size <= GLOBAL_CONFIG.inline_object_max_bytes or \
            (self.is_client and size <= GLOBAL_CONFIG.transfer_chunk_bytes)
        wire_cache = []

        def wire():  # assemble at most once across the branch chain
            if not wire_cache:
                wire_cache.append(to_wire_bytes(pickled, buffers))
            return wire_cache[0]

        if self.is_client and not tiny:
            loc = self._spool_or_upload(str(oid), pickled, buffers)
            self.rpc("put_object", object_id=str(oid), loc=loc,
                     size=size, contained=contained, node_id=self.node_id)
        elif slab is not None and size <= GLOBAL_CONFIG.slab_object_max_bytes \
                and slab.put(str(oid), wire()):
            self.rpc("put_object", object_id=str(oid), loc="slab",
                     size=size, contained=contained, node_id=self.node_id)
        elif tiny:
            # no slab, or slab full/out of slots: tiny objects ride the RPC
            self.rpc("put_object", object_id=str(oid), loc="inline",
                     data=wire(),
                     size=size, contained=contained, node_id=self.node_id)
        else:
            # single-copy path: buffers stream straight into the segment
            shm_write_value(str(oid), pickled, buffers)
            self.rpc("put_object", object_id=str(oid), loc="shm", size=size,
                     contained=contained, node_id=self.node_id)
        return ObjectRef(str(oid), worker=self)

    def _materialize(self, oid: str, meta: dict) -> Any:
        value = self._materialize_value(oid, meta)
        # counted AFTER the bytes were actually obtained: a failed fetch
        # (or a slab-miss retry re-entering here) must not inflate the
        # counter with bytes that were never delivered
        if GLOBAL_CONFIG.metrics_enabled:
            size = meta.get("size") or (len(meta["data"])
                                        if meta.get("data") is not None else 0)
            if size:
                mcat.get("rtt_object_store_get_bytes").inc(size)
        return value

    def _materialize_value(self, oid: str, meta: dict) -> Any:
        if meta["state"] == "error":
            err = deserialize_from(memoryview(meta["data"]))
            raise err
        if meta["loc"] == "inline":
            return deserialize_from(memoryview(meta["data"]))
        if meta["loc"] == "remote":
            # spooled on a sibling host's data plane (P2P object plane)
            return deserialize_from(self._fetch_peer_object(oid, meta))
        if self.is_client and meta["loc"] in ("slab", "shm", "spilled"):
            return deserialize_from(self._fetch_remote_wire(oid))
        if meta["loc"] == "slab":
            slab = self.slab
            data = slab.get(oid) if slab is not None else None
            if data is None:
                # vanished between meta reply and read → same recovery path
                # as a lost tmpfs segment
                raise FileNotFoundError(oid)
            return deserialize_from(memoryview(data))
        mapped = ShmObjectStore.map_readonly(oid)
        return deserialize_from(mapped.buf)

    def _fetch_peer_object(self, oid: str, meta: dict) -> memoryview:
        """Read a remote-spooled object: same-host spool file directly,
        else dial the holder's data plane (direct, or through the head
        proxy for unreachable peers — open_conn's ladder), else fall back
        to the head relay, which pulls the object through itself
        (reference: PullManager direct-pull with relay fallback)."""
        spool = os.environ.get("RTT_SPOOL_DIR")
        if spool and meta.get("node_id") == self.node_id:
            try:
                return memoryview(
                    data_plane.spool_path(spool, oid).read_bytes())
            except OSError:
                pass  # spool lost locally: try the network paths
        addr = meta.get("addr")
        if addr:
            with self._pull_sem:
                try:
                    return memoryview(self._data_pool.pull(
                        addr, oid, size=meta.get("size")))
                except (OSError, EOFError, ConnectionError,
                        FileNotFoundError):
                    pass  # unreachable holder: head relay below
        t0 = time.monotonic()
        t0w = time.time()
        data = self._fetch_remote_wire(oid)
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_data_pull_seconds").observe(
                time.monotonic() - t0, tags={"path": "relay"})
        span = tracing.current_span()
        if span is not None and span.sampled:
            # relay-path leg of the request tree (the direct-pull span is
            # emitted inside DataPlanePool.pull, bytes/path tagged there)
            tracing.emit_span("data.pull", span, t0w,
                              time.monotonic() - t0, cat="data",
                              bytes=len(data), path="relay", object_id=oid)
        return data

    def _fetch_remote_wire(self, oid: str) -> memoryview:
        """Pull one object's wire bytes over the control plane (the
        cross-host data path).  Large objects stream in
        ``transfer_chunk_bytes`` pieces; concurrent pulls of the SAME
        object coalesce onto one in-flight transfer (reference:
        PullManager dedup), and ``transfer_max_inflight`` bounds how many
        chunked pulls run at once (bandwidth admission)."""
        with self._pull_lock:
            inflight = self._pulls.get(oid)
            if inflight is None:
                inflight = {"ev": threading.Event(), "wire": None, "err": None}
                self._pulls[oid] = inflight
                leader = True
            else:
                leader = False
        if not leader:
            inflight["ev"].wait()
            if inflight["err"] is not None:
                raise inflight["err"]
            return memoryview(inflight["wire"])
        try:
            wire = self._pull_object(oid)
            inflight["wire"] = wire
            return memoryview(wire)
        except BaseException as e:
            inflight["err"] = e
            raise
        finally:
            with self._pull_lock:
                self._pulls.pop(oid, None)
            inflight["ev"].set()

    def _pull_object(self, oid: str):
        resp = self.rpc("fetch_object", object_id=oid)
        data = resp.get("data")
        if data is not None:
            return data
        if not resp.get("chunked"):
            raise FileNotFoundError(oid)  # lost → reconstruction retry
        size = resp["size"]
        chunk = GLOBAL_CONFIG.transfer_chunk_bytes
        buf = bytearray(size)
        with self._pull_sem:
            off = 0
            while off < size:
                r = self.rpc("fetch_chunk", object_id=oid, offset=off,
                             length=min(chunk, size - off))
                piece = r.get("data")
                if not piece:
                    raise FileNotFoundError(oid)
                buf[off:off + len(piece)] = piece
                off += len(piece)
        return buf

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        oids = [str(r.id) for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        metas: Dict[str, dict] = {}
        missing = []
        with self._local_lock:
            for oid in oids:
                data = self._local_values.get(oid)
                if data is not None:
                    metas[oid] = {"state": "ready", "loc": "inline", "data": data}
                else:
                    missing.append(oid)
        if missing:
            missing = self._await_inline_results(missing, metas, deadline)
        if missing:
            metas.update(self._blocking_get_meta(missing, deadline))
        # any meta observed at a terminal state completes its actor call
        # (the inline reply may have died with the actor; see
        # _mark_call_done)
        if self._inflight_calls:
            for oid, meta in metas.items():
                if meta.get("state") in ("ready", "error"):
                    self._mark_call_done(oid)
        if self._owned_by_ret:
            # terminal returns release the owner-side lineage retention
            for oid, meta in metas.items():
                if meta.get("state") in ("ready", "error"):
                    self._untrack_owned_ret(oid)
        out = []
        for oid in oids:
            for attempt in range(3):
                try:
                    out.append(self._materialize(oid, metas[oid]))
                    break
                except FileNotFoundError:
                    # segment vanished between meta reply and mmap (loss or
                    # eviction race): re-resolve, which triggers
                    # reconstruction server-side
                    if attempt == 2:
                        raise exc.ObjectLostError(oid, "shm segment vanished")
                    metas.update(self._blocking_get_meta([oid], deadline))
        return out

    def _await_inline_results(self, missing: List[str], metas: dict,
                              deadline: Optional[float]) -> List[str]:
        """Direct-call fast path: when EVERY missing ref is the return of
        an in-flight actor call on a live direct channel, park on the
        inline-reply arrival instead of doing a GCS get_meta.

        The reply lands on the channel reader thread; on small hosts the
        reader reliably loses the race with the caller's get(), which then
        pays the full control-plane round-trip (waiter registration, seal
        event, reply encode) for a result that was already on its way —
        measured 2x the direct-path serial latency.  Falls back to the
        authoritative GCS path the moment any ref is not inline-eligible
        (big results arrive seal-only, dead channels seal errors there).
        Returns the refs still needing the GCS."""
        if self.ctx.in_task:
            # inside a task the GCS path is mandatory: it releases this
            # worker's CPU while blocked (task_blocked) so the scheduler
            # can run whatever the awaited call depends on — parking here
            # instead can deadlock a fully-occupied host
            return missing
        flushed = False
        while True:
            with self._local_cv:
                found = [o for o in missing if o in self._local_values]
                for o in found:
                    metas[o] = {"state": "ready", "loc": "inline",
                                "data": self._local_values[o]}
                if found:
                    missing = [o for o in missing
                               if o not in self._local_values]
                if not missing:
                    return []
            with self._actor_chan_lock:
                for oid in missing:
                    ent = self._inflight_calls.get(oid)
                    ch = self._actor_channels.get(ent[0]) if ent else None
                    if ch is None or ch.closed:
                        return missing  # not inline-eligible → GCS
            if not flushed:
                # this wait turned out to be a real block: deferred
                # decrefs must not pin store memory for a long actor
                # method (same contract as _blocking_get_meta) — but
                # only pay the flush once we actually block, not on the
                # already-arrived hot path
                flushed = True
                self._flush_releases()
                continue  # the flush may have taken a while: re-check
            with self._local_cv:
                if any(o in self._local_values for o in missing):
                    continue  # arrived between the two locks
                if deadline is not None \
                        and time.monotonic() >= deadline:
                    return missing  # GCS path raises GetTimeoutError
                # bounded slice: re-checks channel liveness/in-flight
                # membership above even on a missed notify
                self._local_cv.wait(0.05)

    def _blocking_get_meta(self, oids: List[str],
                           deadline: Optional[float]) -> dict:
        """get_meta RPC that (a) releases this task's CPU while blocked so
        dependency/reconstruction tasks can schedule, and (b) honors the
        caller's overall deadline across retries."""
        remaining = None
        if deadline is not None:
            remaining = max(0.0, deadline - time.monotonic())
        blocked = self.ctx.in_task
        if blocked:
            # fast path first: task args are usually already sealed, and
            # the task_blocked → CPU-release → pump → task_unblocked dance
            # for a get that never actually waits both over-dispatches the
            # scheduler (blocked workers don't count against the spawn
            # cap) and storms the pump (measured on the 100KB-arg loop)
            resp = self.rpc("get_meta", object_ids=oids, nonblock=True)
            if "metas" in resp:
                return resp["metas"]
            self._send_event({"kind": "task_blocked"})
        # deferred decrefs must land before a potentially-long block,
        # or they pin store memory for the whole wait
        self._flush_releases()
        try:
            resp = self.rpc("get_meta", object_ids=oids, timeout=remaining)
        finally:
            if blocked:
                self._send_event({"kind": "task_unblocked"})
        return resp["metas"]

    def get_one(self, ref: ObjectRef, timeout: Optional[float] = None) -> Any:
        return self.get([ref], timeout=timeout)[0]

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError(
                f"num_returns ({num_returns}) > number of refs ({len(refs)})")
        # flush-before-block invariant: buffered decrefs must not pin dead
        # objects for the duration of a possibly-indefinite wait
        self._flush_releases()
        by_id = {str(r.id): r for r in refs}
        with self._local_lock:
            local_ready = [oid for oid in by_id if oid in self._local_values]
        if len(local_ready) >= num_returns:
            ready_set = set(local_ready[:num_returns])
            return ([r for o, r in by_id.items() if o in ready_set],
                    [r for o, r in by_id.items() if o not in ready_set])
        resp = self.rpc("wait", object_ids=list(by_id), num_returns=num_returns,
                        timeout=timeout)
        ready = [by_id[o] for o in resp["ready"]]
        not_ready = [by_id[o] for o in resp["not_ready"]]
        return ready, not_ready

    def _release_buf(self) -> List[str]:
        buf = getattr(self._release_tls, "buf", None)
        if buf is None:
            buf = self._release_tls.buf = []
            with self._release_lock:
                stale = self._release_bufs.get(threading.get_ident())
                if stale:
                    # CPython reuses thread idents: adopt a dead thread's
                    # unflushed drops instead of orphaning them forever
                    buf.extend(stale)
                self._release_bufs[threading.get_ident()] = buf
        return buf

    def release(self, oid: str) -> None:
        """Drop one client reference (ObjectRef.__del__).

        Batched per thread: dropping N refs costs N/64 control-plane
        messages, not N (measured 0.3ms/message on the submit hot loop).
        Flushing on the dropping thread's own channel keeps the exact
        submit→release FIFO of the unbatched path — see the buffer's
        declaration comment for the ordering argument."""
        if self._stop.is_set():
            return
        if self._owned_by_ret:
            self._untrack_owned_ret(oid)  # owner dropped the return ref
        buf = self._release_buf()
        with self._release_lock:  # RLock: cyclic-GC re-entry safe
            n = self._pending_pins.get(oid)
            # net only for inline-cached (small) results: the pair then
            # costs zero messages and the object's 10s graceful-free
            # retention holds only bytes the control plane already
            # carried.  A BIG (non-inline) result must free promptly —
            # ship its pin onto the stream NOW (so this release can
            # never overtake it) and send the release normally.
            # _local_values membership is a GIL-atomic dict read; taking
            # _local_lock here could invert against a __del__ fired
            # inside cache_local.
            if n and oid in self._local_values:
                # cancels a not-yet-flushed pin: the pair nets to zero
                # messages (the actor-call get-and-drop hot loop)
                if n == 1:
                    del self._pending_pins[oid]
                else:
                    self._pending_pins[oid] = n - 1
                return
            if n:
                self._drain_pending_pins()  # re-entrant under _release_lock
            buf.append(oid)
            if len(buf) < 64:
                return
            batch = buf[:]
            del buf[:]
        # buffered submits pin deps these releases may drop: submits first
        if self._submit_buf:
            self._flush_submits()
        self.rpc_oneway("release_batch", object_ids=batch)

    def _flush_releases(self, all_threads: bool = False) -> None:
        """Drain THIS thread's release buffer (called before blocking
        waits and puts so deferred decrefs don't pin store memory).
        ``all_threads`` (shutdown only) drains every thread's buffer on
        the calling thread — cross-channel ordering no longer matters
        once nothing new can be submitted."""
        if self._submit_buf or (all_threads and self._pending_pins):
            # submits pin deps; they must land first.  Pins alone don't
            # gate a block (they only add protection; flusher tick covers
            # them) — except at shutdown, when this is the last chance.
            self._flush_submits()
        batches: List[List[str]] = []
        with self._release_lock:  # copy+clear must be atomic vs shutdown
            buf = getattr(self._release_tls, "buf", None)
            if buf:
                batches.append(buf[:])
                del buf[:]
            if all_threads:
                for b in self._release_bufs.values():
                    if b:
                        batches.append(b[:])
                        del b[:]
        for batch in batches:
            if self._stop.is_set():
                return
            try:
                self.rpc_oneway("release_batch", object_ids=batch)
            except (OSError, ConnectionError, EOFError):
                return

    def notify_borrow(self, oid: str) -> None:
        """Pin a borrowed (deserialized nested) ref for this client.  Rides
        the ordered submit stream (one buffered op, flushed within ~2ms —
        not a oneway message per borrow); its later release flushes the
        stream first, so the pin always applies before the unpin.  NOT
        routed through the netted-pin buffer: a borrowed object is
        usually long-sealed, so the rc-0-at-seal grace does not protect
        it — another holder's release during a parked pin's window would
        free the data (the netting path is only safe for refs whose seal
        is concurrent with the pin, i.e. actor-call returns)."""
        if not self._stop.is_set():
            self._buffer_stream_op(("ref", {"object_ids": [oid],
                                            "ledger": None}))

    def cache_local(self, oid: str, wire: bytes) -> None:
        with self._local_lock:
            self._local_values[oid] = wire
            while len(self._local_values) > 4096:
                self._local_values.popitem(last=False)
            self._local_cv.notify_all()

    def _wake_local_waiters(self) -> None:
        """Channel-death hook: get() waiters parked on in-flight direct
        calls must re-check (and fall back to the authoritative GCS)."""
        with self._local_lock:
            self._local_cv.notify_all()

    # --------------------------------------------------------------- export
    def export_callable(self, obj: Any) -> str:
        # Per-object fn_id cache: re-pickling the function on EVERY submit
        # dominated the task hot path (sha1-of-cloudpickle per call).  The
        # reference pins a RemoteFunction's pickle at first submission —
        # later closure-cell mutations intentionally do not re-export.
        try:
            cached = self._fn_id_cache.get(obj)
        except TypeError:  # unhashable callable (rare)
            cached = None
        if cached is not None:
            return cached
        blob = dumps_call(obj)
        fn_id = hashlib.sha1(blob).hexdigest()[:16]
        if fn_id not in self._exported:
            self.rpc("export_function", fn_id=fn_id, blob=blob)
            self._exported.add(fn_id)
        try:
            self._fn_id_cache[obj] = fn_id
        except TypeError:
            pass
        return fn_id

    def fetch_callable(self, fn_id: str) -> Any:
        fn = self._fn_cache.get(fn_id)
        if fn is None:
            resp = self.rpc("fetch_function", fn_id=fn_id)
            fn = loads_call(resp["blob"])
            self._fn_cache[fn_id] = fn
        return fn

    # ------------------------------------------------------- arg marshalling
    def _pack_args(self, args: tuple, kwargs: dict, batched: bool = False
                   ) -> Tuple[dict, List[str], List[str], List[str],
                              List[tuple]]:
        """Returns (fields, deps, borrows, transient_refs, pre_ops).
        ``batched``: the caller ships specs via the ordered submit batch,
        so big arg payloads become ("put", ...) pre-ops in that stream
        instead of a synchronous put round trip.

        Top-level ObjectRef args are passed by reference and resolved to
        values before execution (= deps).  Refs nested inside values stay
        refs (= borrows, pinned for the task's duration).  transient_refs
        are value-payload objects this call must release after the server
        has pinned them as deps (returned, not stored on self: concurrent
        submits from multiple threads must not release each other's refs).
        """
        layout = []
        values = []
        for a in args:
            if isinstance(a, ObjectRef):
                layout.append(("ref", str(a.id)))
            else:
                layout.append(("val", len(values)))
                values.append(a)
        klayout = {}
        for k, v in kwargs.items():
            if isinstance(v, ObjectRef):
                klayout[k] = ("ref", str(v.id))
            else:
                klayout[k] = ("val", len(values))
                values.append(v)
        if not values:
            # no by-value args: skip the serializer round trip entirely
            # (the no-arg task/actor-call hot path); _unpack_args yields
            # [] when values_blob is absent
            fields = {"arg_layout": layout, "kwarg_layout": klayout}
            deps = [oid for tag, oid in
                    [e for e in layout if e[0] == "ref"] +
                    [e for e in klayout.values() if e[0] == "ref"]]
            return fields, deps, [], [], []
        wire, refs = serialize_to_bytes(values)
        borrows = [str(r.id) for r in refs]
        deps = [oid for tag, oid in
                [e for e in layout if e[0] == "ref"] +
                [e for e in klayout.values() if e[0] == "ref"]]
        fields = {"arg_layout": layout, "kwarg_layout": klayout}
        transient: List[str] = []
        pre_ops: List[tuple] = []
        if len(wire) <= GLOBAL_CONFIG.inline_object_max_bytes:
            fields["values_blob"] = wire
        elif batched and not self.is_client:
            # big arg payloads ride the object plane, not the control
            # socket — single-copy: the already-serialized wire goes
            # straight to the slab/shm plane, and the put_object rides the
            # SAME ordered submit batch as the spec (transient=True: no
            # client ref to release later; the spec's dep pin — applied
            # later in the same batch — owns the lifetime).  The spec must
            # never overtake the put: a worker would park on the missing
            # arg, release its CPU, and the scheduler over-dispatches.
            oid = str(ObjectID.make(self.worker_id, KIND_PUT,
                                    self._put_seq()))
            loc = self._write_wire(oid, wire)
            pre_ops.append(("put", {
                "object_id": oid, "loc": loc, "size": len(wire),
                "contained": borrows, "transient": True,
                "node_id": self.node_id}))
            fields["values_ref"] = oid
            deps = deps + [oid]
        else:
            vref = self.put(values)
            fields["values_ref"] = str(vref.id)
            deps = deps + [str(vref.id)]
            vref._skip_release = True  # scheduler dep-hold takes over
            transient.append(str(vref.id))  # drop our ledger ref post-submit
        return fields, deps, borrows, transient, pre_ops

    def _unpack_args(self, spec: dict) -> Tuple[list, dict]:
        if "values_blob" in spec:
            values = deserialize_from(memoryview(spec["values_blob"]))
        elif "values_ref" in spec:
            # fast path: the arg payload was written to the same-host slab
            # by the submitter and is pinned by this task's dep — read it
            # directly, no get_meta round trip (the 100KB-arg hot loop)
            values = None
            slab = self.slab
            if slab is not None:
                wire = slab.get(spec["values_ref"])
                if wire is not None:
                    values = deserialize_from(memoryview(wire))
            if values is None:
                values = self.get_one(ObjectRef(spec["values_ref"],
                                                worker=self,
                                                skip_release=True))
        else:
            values = []
        ref_ids = [oid for tag, oid in spec["arg_layout"] if tag == "ref"] + \
                  [oid for tag, oid in spec["kwarg_layout"].values() if tag == "ref"]
        resolved = {}
        if ref_ids:
            vals = self.get([ObjectRef(o, worker=self, skip_release=True)
                             for o in ref_ids])
            resolved = dict(zip(ref_ids, vals))
        args = []
        for tag, v in spec["arg_layout"]:
            args.append(resolved[v] if tag == "ref" else values[v])
        kwargs = {}
        for k, (tag, v) in spec["kwarg_layout"].items():
            kwargs[k] = resolved[v] if tag == "ref" else values[v]
        return args, kwargs

    # ------------------------------------------------------------ submission
    def submit(self, fn: Any, args: tuple, kwargs: dict, *,
               num_returns: int = 1, num_cpus: float = 1,
               num_gpus: float = 0, resources: Optional[dict] = None,
               max_retries: Optional[int] = None, retry_exceptions: bool = False,
               scheduling_strategy: Any = None, name: Optional[str] = None,
               runtime_env: Optional[dict] = None) -> List[ObjectRef]:
        if runtime_env:
            from ray_tpu_torch._private import runtime_env as renv
            runtime_env = renv.prepare(runtime_env, self)
        fn_id = self.export_callable(fn)
        fields, deps, borrows, transient, pre_ops = self._pack_args(
            args, kwargs, batched=True)
        task_id = TaskID.new()
        return_ids = [str(ObjectID.make(self.worker_id, KIND_RETURN, self._ret_seq()))
                      for _ in range(num_returns)]
        spec = {
            "task_id": task_id, "fn_id": fn_id,
            "name": name or getattr(fn, "__name__", "task"),
            "owner": self.worker_id,
            "return_ids": return_ids, "num_returns": num_returns,
            "deps": deps, "borrows": borrows,
            "num_cpus": num_cpus, "num_gpus": num_gpus,
            "resources": resources or {},
            "max_retries": (GLOBAL_CONFIG.task_default_max_retries
                            if max_retries is None else max_retries),
            "retry_exceptions": retry_exceptions,
            "scheduling_strategy": scheduling_strategy,
            "runtime_env": runtime_env,
            **fields,
        }
        span = tracing.current_span()
        if span is not None and span.sampled:
            # OTel-style propagation: the task's span will parent to this
            # one in the timeline dump (reference: ray.util.tracing).
            # Head-based sampling: a sampled-out root propagates nothing.
            spec["trace_ctx"] = span.to_dict()
        # one-way submit: return ids are generated client-side, so there is
        # nothing to wait for — pipelined submissions instead of a control-
        # plane round trip per task (reference: lease-cached submission).
        # Specs batch 64-to-a-message (r3: per-message framing was the
        # measured residual of the task hot loop); transient releases ride
        # the same batch AFTER their spec so the dep pin wins the race.
        self._buffer_submit(spec, transient, pre_ops)
        return [ObjectRef(oid, worker=self) for oid in return_ids]

    def _track_owned(self, spec: dict) -> None:
        with self._owned_lock:
            self._owned_specs[spec["task_id"]] = spec
            for oid in spec["return_ids"]:
                self._owned_by_ret[oid] = spec["task_id"]
            while len(self._owned_specs) > 100_000:
                _, old = self._owned_specs.popitem(last=False)
                for oid in old["return_ids"]:
                    self._owned_by_ret.pop(oid, None)

    def _untrack_owned_ret(self, oid: str) -> None:
        """A return was observed terminal (or its ref released): the task
        no longer needs owner-side lineage."""
        with self._owned_lock:
            tid = self._owned_by_ret.pop(oid, None)
            if tid is None:
                return
            spec = self._owned_specs.get(tid)
            if spec is not None and not any(
                    r in self._owned_by_ret for r in spec["return_ids"]):
                # pop: a re-entry from the GC may have taken it already
                self._owned_specs.pop(tid, None)

    def _resubmit_owned(self, ch: protocol.RpcChannel) -> None:
        """Reconnected to a RESTARTED head: re-seal locally-held arg
        payloads (slab/shm segments survive the head) and resubmit every
        in-flight owned spec as one ordered batch."""
        with self._owned_lock:
            specs = [dict(s) for s in list(self._owned_specs.values())]
        if not specs:
            return
        logger.warning("head restart detected: resubmitting %d in-flight "
                       "owned tasks", len(specs))
        ops: List[tuple] = []
        sealed: set = set()
        for spec in specs:
            for k in [k for k in spec if k.startswith("_")]:
                spec.pop(k)
            for dep in list(spec.get("deps", ())):
                if dep in sealed or dep in self._owned_by_ret:
                    continue  # produced by another resubmitted task
                wire = None
                slab = self.slab
                if slab is not None:
                    wire = slab.get(dep)
                if wire is not None:
                    ops.append(("put", {"object_id": dep, "loc": "slab",
                                        "size": len(wire), "contained": [],
                                        "transient": True,
                                        "node_id": self.node_id}))
                    sealed.add(dep)
                elif _seg_path(dep).exists():
                    ops.append(("put", {
                        "object_id": dep, "loc": "shm",
                        "size": _seg_path(dep).stat().st_size,
                        "contained": [], "transient": True,
                        "node_id": self.node_id}))
                    sealed.add(dep)
            ops.append(("spec", spec))
        ch.send_oneway("submit_batch", client_id=self.worker_id, ops=ops)

    def _buffer_submit(self, spec: dict, releases: List[str],
                       pre_ops: Optional[List[tuple]] = None) -> None:
        if not self.is_client:
            self._track_owned(spec)
        entries = list(pre_ops or ()) + [("spec", spec)] + \
            [("rel", o) for o in releases]
        if self.is_client:
            # proxied clients: no background flusher thread (their submit
            # rate never needed batching) — ship immediately
            self._send_submit_batch(entries)
            return
        full = False
        with self._submit_lock:
            self._submit_buf.extend(entries)
            if not self._submit_first:
                self._submit_first = time.monotonic()
            self._submit_pending.set()
            full = len(self._submit_buf) >= 64
            if not full:
                self._ensure_flusher_locked()
        if full:
            self._drain_submits()

    def _flush_submits(self) -> None:
        self._drain_pending_pins()
        self._drain_submits()

    def _buffer_stream_op(self, op: tuple) -> None:
        """Queue one op on the ordered submit stream (flushed within ~2ms
        or before any two-way RPC).  Pin/unpin pairs for the same object
        MUST both ride this stream: a pin that buffers while its release
        goes out directly (socket oneway or the in-process inline path)
        applies in the wrong order and frees the object under the pin —
        the free-before-pin race."""
        if self.is_client:
            self.rpc_oneway("submit_batch", ops=[op])
            return
        full = False
        with self._submit_lock:
            self._submit_buf.append(op)
            if not self._submit_first:
                self._submit_first = time.monotonic()
            self._submit_pending.set()
            full = len(self._submit_buf) >= 64
            if not full:
                self._ensure_flusher_locked()
        if full:
            self._drain_submits()

    def _buffer_ref_add(self, object_ids: List[str],
                        ledger: Optional[str] = None) -> None:
        """Pin refs for this client.  Explicit-ledger pins (in-flight
        actor args) ride the ordered submit stream unchanged.  Client-
        ledger pins (actor-call returns) are NETTED: they sit in
        _pending_pins where a release of the same oid cancels them
        outright; survivors are flushed onto the stream by the flusher.
        Only safe for refs whose SEAL is concurrent with the pin: the
        seal-with-zero-refs window (actor seals before the pin — or the
        netted pair never arrives at all) is covered by the GCS's 10s
        graceful-free grace.  Long-sealed objects (borrows) must use the
        prompt stream path instead — see notify_borrow."""
        if ledger is not None or self.is_client:
            # clients have no flusher thread: ship immediately
            self._buffer_stream_op(("ref", {"object_ids": object_ids,
                                            "ledger": ledger}))
            return
        with self._release_lock:
            for oid in object_ids:
                self._pending_pins[oid] = self._pending_pins.get(oid, 0) + 1
        # deliberately NO flusher wakeup: a pin only ADDS protection, and
        # the GCS rc-0-at-seal grace is 10s — the flusher's idle 1s tick
        # drains survivors.  Waking it per call would put a drain (and a
        # GCS lock acquisition) back on the hot loop netting removed.
        with self._submit_lock:
            self._ensure_flusher_locked()

    def _drain_pending_pins(self) -> None:
        """Move surviving netted pins onto the ordered submit stream
        (direct buffer append — must not recurse into a drain).  The
        pop-and-append is atomic under _release_lock: a concurrent
        release() of the same oid either nets against the pin (runs
        before the pop) or finds the pin already in _submit_buf and
        flushes it first (runs after) — it can never slip between and
        ship ahead of the pin.  Lock order release_lock → submit_lock;
        nothing takes them in the reverse order."""
        with self._release_lock:
            if not self._pending_pins:
                return
            pins, self._pending_pins = self._pending_pins, {}
            oids = [oid for oid, n in pins.items() for _ in range(n)]
            with self._submit_lock:
                self._submit_buf.append(("ref", {"object_ids": oids,
                                                 "ledger": None}))
                if not self._submit_first:
                    self._submit_first = time.monotonic()
                self._submit_pending.set()

    def _ensure_flusher_locked(self) -> None:
        # _submit_lock held
        if not self._submit_flusher_on and not self.is_client:
            self._submit_flusher_on = True
            threading.Thread(target=self._submit_flusher,
                             name="submit-flusher", daemon=True).start()

    def _drain_submits(self) -> None:
        """Pop the whole buffer and ship it; on a transient channel break
        REQUEUE it at the front.  The head is still alive (no epoch
        change), so _resubmit_owned never fires — dropping the batch would
        lose submissions whose .remote() already returned, hanging their
        get() forever.  rpc_oneway drops the dead shared channel on error
        (its break classes: OSError/ValueError/ConnectionError), so the
        retry (the flusher's next pass) re-dials.  pop→send is atomic
        under _submit_send_lock so concurrent drains can't reorder
        batches on the wire OR interleave requeues out of order."""
        with self._submit_send_lock:
            with self._submit_lock:
                if not self._submit_buf:
                    return
                flush, self._submit_buf = self._submit_buf, []
                self._submit_first = 0.0
            try:
                self._send_submit_batch(flush)
            except (OSError, ValueError, ConnectionError, EOFError):
                # EOFError: the negotiated re-dial (RpcChannel negotiate)
                # recv()s mid-hello — a half-restarted head can EOF there
                with self._submit_lock:
                    self._submit_buf[:0] = flush
                    if not self._submit_first:
                        self._submit_first = time.monotonic()
                    self._submit_pending.set()
                    # ensure someone retries even if the flusher was
                    # never started (all-exact-64-batch history)
                    self._ensure_flusher_locked()

    def _send_submit_batch(self, entries: List[Any]) -> None:
        # ordered op stream: ("put", msg) | ("spec", spec) | ("rel", oid) —
        # the server applies them in sequence, so an arg-payload put always
        # lands before the spec that deps on it, and a transient release
        # always lands after the spec whose dep pin replaces it
        self.rpc_oneway("submit_batch", ops=entries)

    def _submit_flusher(self) -> None:
        """Ships a lone buffered submit within ~2ms: fire-and-forget tasks
        must not wait for a 64-deep batch that may never fill.  Parks on
        an event while the buffer is empty (zero wakeups when idle)."""
        while not self._stop.is_set():
            if not self._submit_pending.wait(timeout=1.0):
                # idle tick: drain netted-pin survivors (refs the caller
                # kept) — their only deadline is the GCS's 10s grace
                with self._release_lock:
                    pins = bool(self._pending_pins)
                if pins:
                    self._flush_submits()
                continue
            time.sleep(0.0015)  # let a burst coalesce into one batch
            with self._submit_lock:
                due = bool(self._submit_buf)
                if not due:
                    # nothing left: park until the next buffered item.  A
                    # concurrent buffer-er re-sets the event AFTER
                    # inserting, so this clear can never strand work.
                    self._submit_pending.clear()
            if due:
                self._flush_submits()

    # ---------------------------------------------------------- actor client
    def create_actor(self, cls: Any, args: tuple, kwargs: dict, *,
                     num_cpus: float = 1, num_gpus: float = 0,
                     resources: Optional[dict] = None,
                     hold_resources: bool = True,
                     max_restarts: int = 0, max_task_retries: int = 0,
                     max_concurrency: int = 1, name: Optional[str] = None,
                     namespace: str = "default", detached: bool = False,
                     get_if_exists: bool = False,
                     scheduling_strategy: Any = None,
                     runtime_env: Optional[dict] = None) -> dict:
        if runtime_env:
            from ray_tpu_torch._private import runtime_env as renv
            runtime_env = renv.prepare(runtime_env, self)
        class_blob_id = self.export_callable(cls)
        fields, deps, borrows, transient, _ = self._pack_args(args, kwargs)
        from ray_tpu_torch._private.ids import ActorID
        actor_id = ActorID.new()
        task_id = TaskID.new()
        method_meta = {
            m: {"num_returns": getattr(getattr(cls, m), "__ray_num_returns__", 1)}
            for m in dir(cls) if callable(getattr(cls, m, None))
            and not m.startswith("__")
        }
        spec = {
            "task_id": task_id, "actor_id": actor_id,
            "is_actor_creation": True,
            "hold_resources": hold_resources,
            "class_blob_id": class_blob_id,
            "class_name": getattr(cls, "__name__", "Actor"),
            "name": name, "namespace": namespace, "detached": detached,
            "get_if_exists": get_if_exists,
            "owner": self.worker_id,
            "return_ids": [], "num_returns": 0,
            "deps": deps, "borrows": borrows,
            "num_cpus": num_cpus, "num_gpus": num_gpus,
            "resources": resources or {},
            "max_restarts": max_restarts, "max_task_retries": max_task_retries,
            "max_concurrency": max_concurrency,
            "scheduling_strategy": scheduling_strategy,
            "runtime_env": runtime_env,
            "method_meta": method_meta,
            **fields,
        }
        resp = self.rpc("create_actor", spec=spec)
        for oid in transient:
            self.rpc_oneway("release", object_id=oid)
        return {"actor_id": resp["actor_id"], "method_meta": method_meta,
                "existing": resp.get("existing", False)}

    def _actor_channel(self, actor_id: str, max_task_retries: int) -> "_ActorChannel":
        with self._actor_chan_lock:
            ch = self._actor_channels.get(actor_id)
            if ch is None or ch.closed:
                ch = _ActorChannel(self, actor_id, max_task_retries)
                self._actor_channels[actor_id] = ch
            return ch

    def call_actor(self, actor_id: str, method: str, args: tuple, kwargs: dict, *,
                   num_returns: int = 1, max_task_retries: int = 0) -> List[ObjectRef]:
        fields, deps, borrows, transient, _ = self._pack_args(args, kwargs)
        call_id = f"{self.worker_id}:{self._call_seq()}"
        return_ids = [str(ObjectID.make(self.worker_id, KIND_RETURN, self._ret_seq()))
                      for _ in range(num_returns)]
        # return-id pins ride the buffered stream (their release is the
        # client's own ObjectRef.__del__ → same stream, ordered).  Arg
        # pins must NOT buffer: the actor's release_all for this call's
        # ledger races ahead of a deferred flush on a fast method (no
        # cross-channel ordering) and would pop the ledger before the pin
        # lands, leaking the args forever.  Sent BEFORE the call, the pin
        # is always in flight ahead of the actor's completion.
        self._buffer_ref_add(return_ids)
        hold = deps + borrows
        if hold:
            self.rpc_oneway("add_refs", object_ids=hold,
                            ledger=f"call:{call_id}")
        span = tracing.current_span()
        msg = {"kind": "call", "call_id": call_id, "method": method,
               "return_ids": return_ids, "num_returns": num_returns,
               "_retries_left": max_task_retries,
               "trace_ctx": (span.to_dict()
                             if span is not None and span.sampled
                             else None),
               "arg_ledger": f"call:{call_id}" if hold else None, **fields}
        ch = self._actor_channel(actor_id, max_task_retries)
        with self._actor_chan_lock:
            for oid in return_ids:
                self._inflight_calls[oid] = (actor_id, call_id)
        ch.send_call(msg)
        for oid in transient:
            # MUST follow the arg-pin "ref" op in stream order — a direct
            # oneway here applies before the buffered pin and frees the
            # arg payload under it (free-before-pin)
            self._buffer_stream_op(("rel", oid))
        return [ObjectRef(oid, worker=self) for oid in return_ids]

    def _mark_call_done(self, oid: str) -> None:
        """A return object materialized: the actor call that produced it
        completed — clear it from in-flight bookkeeping so a later
        disconnect never resubmits it (double execution on a restarted
        stateful actor)."""
        with self._actor_chan_lock:
            entry = self._inflight_calls.pop(oid, None)
            if entry is None:
                return
            actor_id, call_id = entry
            ch = self._actor_channels.get(actor_id)
        if ch is not None:
            ch.mark_done(call_id)

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        self.rpc("kill_actor", actor_id=actor_id, no_restart=no_restart)

    # -------------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        self._flush_releases(all_threads=True)
        # _stop first: with it set, rpc() raises instead of entering the
        # 30s reconnect grace — a dead head must not stall shutdown for a
        # best-effort telemetry flush
        self._stop.set()
        self._final_metrics_flush()
        from ray_tpu_torch._private import flight_recorder
        flight_recorder.record("shutdown", "clean worker shutdown")
        if self._local_server() is None:
            # pure worker/driver process: discharge the recorder mmap
            # now.  In a head==driver process the GCS still serves after
            # this worker closes — GcsServer.shutdown closes it (and
            # stops the shared sampler the same way).
            flight_recorder.close()
            from ray_tpu_torch.util import profiler as profiler_mod
            profiler_mod.close()
        with self._actor_chan_lock:
            for ch in self._actor_channels.values():
                ch.close()
            self._actor_channels.clear()
        with self._raylet_ref_lock:
            if self._raylet_ref_conn is not None:
                try:
                    self._raylet_ref_conn.close()
                except OSError:
                    pass
                self._raylet_ref_conn = None
        self._data_pool.close_all()
        self.pool.close_all()

    # ====================================================== executor (worker)
    def _reattach_task_conn(self):
        """After a GCS crash: re-dial, re-register, re-attach the push
        channel, and re-announce a live actor.  Returns the new conn or
        None when the grace window expires (then the worker exits)."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        deadline = time.monotonic() + GLOBAL_CONFIG.gcs_reconnect_timeout_s
        while not self._stop.is_set() and time.monotonic() < deadline:
            try:
                # order matters: register first (rebuilds WorkerState),
                # then attach the push conn, then re-announce the actor
                self._reconnect_pool()
                c = self.open_conn(self.gcs_path)
                c.send({"kind": "attach_task_conn",
                        "worker_id": self.worker_id,
                        "reattach": {
                            "pid": os.getpid(),
                            "node_id": self.node_id,
                            "gpu": self.gpu,
                            # declared up front so the GCS never marks an
                            # actor worker "idle" (its main thread sits in
                            # serve_forever and can't run plain tasks)
                            "actor_id": (self._actor_announce or
                                         {}).get("actor_id"),
                        }})
                with self._task_conn_lock:
                    self._task_conn = c
                if self._actor_announce is not None:
                    self._send_event({"kind": "actor_ready",
                                      "reattach": True,
                                      **self._actor_announce})
                self._open_ctl_conn()  # idempotent: the ctl thread
                # re-dials on its own; this only covers a never-started one
                logger.info("reattached task conn after GCS restart")
                return c
            except (EOFError, OSError, ConnectionError):
                time.sleep(0.5)
        return None

    def _dial_task_endpoint(self):
        """The push channel's server: the node's local raylet when one
        advertises (RTT_RAYLET_SOCK — a unix dial even for otherwise
        proxied remote workers), the GCS otherwise."""
        if self.raylet_sock is not None:
            return protocol.connect(self.raylet_sock)
        return self.open_conn(self.gcs_path)

    def run_worker_loop(self) -> None:
        """Main loop of a spawned worker process.

        Tasks execute directly on THIS thread, straight off the task-conn
        recv — no reader→executor queue handoff (two scheduler wakeups per
        task on small hosts, ~100-200µs measured).  Out-of-band control
        (cancel / drop_queued / dump_stack / stop_worker) rides a second
        ``ctl`` connection whose dedicated reader thread stays responsive
        while a task runs; the same kinds are still honored here when they
        arrive on the task conn (ctl-attach race fallback)."""
        conn = self._dial_task_endpoint()
        conn.send({"kind": "attach_task_conn", "worker_id": self.worker_id,
                   "gpu": self.gpu})
        with self._task_conn_lock:
            self._task_conn = conn
        self._open_ctl_conn()
        self._exec_thread_id = threading.get_ident()
        from collections import deque as _deque

        from ray_tpu_torch._private import flight_recorder
        lookahead: "_deque" = _deque()  # frames pre-read by the OOB drain
        while not self._stop.is_set():
            if lookahead:
                msg = lookahead.popleft()
            else:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    if self._stop.is_set():
                        break
                    if self.raylet_sock is not None:
                        # raylet gone = this node is being torn down (a
                        # dead raylet never restarts in place; a HEAD
                        # restart doesn't touch this local conn — the
                        # raylet heals upstream on its own).  Exit; the
                        # agent's pool loop forks replacements.
                        self._stop.set()
                        break
                    # head gone: outlive it and reattach (GCS fault
                    # tolerance) — actors keep serving direct calls the
                    # whole time; only the control-plane link heals.
                    conn = self._reattach_task_conn()
                    if conn is None:
                        self._stop.set()
                        break
                    continue
            kind = msg.get("kind")
            if flight_recorder.enabled():
                # execute_task receipt is recorded by _execute_task's
                # "exec" record itself (task id included) — recording
                # the frame too would double the hot path's record cost
                # for no extra forensics
                if kind != "execute_task":
                    flight_recorder.record("task_frame", str(kind))
            if kind == "execute_task":
                dseq = msg.get("dseq")
                self._execute_task(msg["spec"])
                # prepushed lease-inheriting batch (one dispatch message
                # carries the worker's whole pipeline): run back-to-back
                for spec in msg.get("queued", ()):
                    if self._stop.is_set():
                        break
                    if self._ctl_down:
                        # ctl channel unavailable: OOB frames (e.g. a
                        # drop_queued revoking THESE prepushed specs after
                        # a blocked-worker reclaim) fell back to this conn
                        # — service them before running the next spec, or
                        # a reclaimed spec also re-dispatched elsewhere
                        # would double-execute
                        self._drain_task_conn_oob(conn, lookahead)
                    if (spec["task_id"], dseq) in self._dropped_ids:
                        self._dropped_ids.pop((spec["task_id"], dseq), None)
                        continue
                    self._execute_task(spec)
            elif kind == "create_actor":
                if self._become_actor(msg["spec"]):
                    break  # serve_forever returned: the actor exited
                # creation failed: the GCS returns this worker to the
                # idle pool — keep serving plain tasks on this conn
            else:
                self._handle_oob(msg)
        self._final_metrics_flush()
        sys.exit(0)

    def _actor_conn_monitor(self) -> None:
        """Task-conn reader for ACTOR workers: the main thread parks in
        serve_forever, so this thread owns the control-plane link —
        notices head death (EOF → reattach + re-announce) and handles
        OOB kinds arriving on the task conn."""
        with self._task_conn_lock:
            conn = self._task_conn
        while not self._stop.is_set() and conn is not None:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                if self._stop.is_set():
                    return
                if self.raylet_sock is not None:
                    # node teardown (see run_worker_loop): stop serving
                    self._stop.set()
                    return
                conn = self._reattach_task_conn()
                if conn is None:
                    self._stop.set()
                    return
                continue
            try:
                self._handle_oob(msg)
            except Exception:  # noqa: BLE001 - monitor must keep serving
                logger.exception("actor conn message failed")

    def _drain_task_conn_oob(self, conn, lookahead) -> None:
        """Read any frames already queued on the task conn, handling OOB
        kinds inline and deferring work frames to ``lookahead`` (only
        used while the ctl channel is down — its fallback frames land
        here and must not wait behind a prepush batch)."""
        try:
            while conn.poll(0):
                m = conn.recv()
                if m.get("kind") in ("execute_task", "create_actor"):
                    lookahead.append(m)
                else:
                    self._handle_oob(m)
        except (OSError, EOFError):
            pass  # conn death is the main loop's recv to notice

    def _handle_oob(self, msg: dict) -> None:
        """Out-of-band control kinds (normally via the ctl conn; also
        honored on the task conn while idle)."""
        kind = msg.get("kind")
        if kind == "cancel":
            self._cancel_current(msg["task_id"])
        elif kind == "drop_queued":
            # the GCS revoked prepushed specs this worker holds but
            # hasn't started (pipeline reclaim, or cancel of a queued
            # spec).  Revocations are scoped by the DISPATCH sequence the
            # copy arrived under: a stale drop (the copy already ran
            # before the revocation landed) can then never poison a later
            # legitimate re-dispatch of the same task id to this worker.
            for t, d in msg["pairs"]:
                self._dropped_ids[(t, d)] = None
            while len(self._dropped_ids) > 1024:
                self._dropped_ids.popitem(last=False)
        elif kind == "dump_stack":
            # `ray_tpu_torch stack` (reference: py-spy attach): dump all
            # threads — works mid-task and inside actors (ctl thread)
            self._send_event({"kind": "stack_dump",
                              "text": _dump_all_stacks()})
        elif kind == "stop_worker":
            self._stop.set()
            srv = getattr(self, "_actor_server", None)
            if srv is not None:
                # actor worker: the main thread parks in serve_forever —
                # stop the server (mechanics only; the control plane
                # already holds the death reason + restart policy) so
                # the process actually exits and direct callers fail
                # over to the restarted incarnation
                srv.stop_serving()

    def _open_ctl_conn(self) -> None:
        """Start the out-of-band control channel thread (idempotent).
        The thread owns dialing AND re-dialing: a ctl-only connection
        failure must not permanently degrade mid-task cancel/stop to
        between-task delivery (the task conn stays the liveness signal;
        ctl is best-effort but self-healing)."""
        if getattr(self, "_ctl_thread_on", False):
            return
        self._ctl_thread_on = True
        threading.Thread(target=self._ctl_loop,
                         name="worker-ctl", daemon=True).start()

    def _ctl_loop(self) -> None:
        conn = None
        backoff = 0.5
        while not self._stop.is_set():
            if conn is None:
                try:
                    conn = self._dial_task_endpoint()
                    conn.send({"kind": "attach_worker_ctl",
                               "worker_id": self.worker_id})
                    self._ctl_down = False
                    backoff = 0.5
                except (OSError, EOFError, ConnectionError):
                    conn = None
                    self._ctl_down = True
                    if self._stop.wait(backoff):
                        return
                    backoff = min(10.0, backoff * 2)
                    continue
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                try:
                    conn.close()
                except OSError:
                    pass
                conn = None  # head restarting / conn broke: re-dial
                self._ctl_down = True
                if self._stop.wait(0.5):
                    return
                continue
            try:
                self._handle_oob(msg)
                if msg.get("kind") == "stop_worker":
                    # the main thread is parked in task-conn recv (or an
                    # actor's serve_forever): shut the task conn down so
                    # its recv raises and the loop observes _stop
                    with self._task_conn_lock:
                        if self._task_conn is not None:
                            protocol.shutdown_conn(self._task_conn)
                    return
            except Exception:  # noqa: BLE001 - control must keep serving
                logger.exception("ctl message failed: %s", msg.get("kind"))

    def _cancel_current(self, task_id: str) -> None:
        with self._cancel_lock:
            spec = self._current_spec
            if spec is None or spec.get("task_id") != task_id \
                    or not self._in_user_fn \
                    or self._exec_thread_id is None:
                # not (yet) in the task's own code: raising now could land
                # inside the runtime (mid-RPC, mid-frame) and wedge this
                # worker — the task is cancelled before its code starts
                self._cancel_pending[task_id] = None
                while len(self._cancel_pending) > 1024:
                    self._cancel_pending.popitem(last=False)
                return
            import ctypes
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(self._exec_thread_id),
                ctypes.py_object(exc.TaskCancelledError))

    def _serialize_result(self, value: Any) -> dict:
        from ray_tpu_torch._private.serialization import (serialize,
                                                    serialized_size,
                                                    to_wire_bytes)
        pickled, buffers, refs = serialize(value)
        size = serialized_size(pickled, buffers)
        contained = [str(r.id) for r in refs]
        if self.is_client:
            # no local data plane: small results inline on the control
            # plane; large ones spool locally (writev, no full-wire
            # staging copy) or stream to the head's store in chunks
            if size <= GLOBAL_CONFIG.transfer_chunk_bytes:
                return {"loc": "inline", "data": to_wire_bytes(pickled, buffers),
                        "size": size, "contained": contained}
            return {"loc": "upload", "parts": (pickled, buffers),
                    "size": size, "contained": contained}
        if size <= GLOBAL_CONFIG.inline_object_max_bytes:
            return {"loc": "inline", "data": to_wire_bytes(pickled, buffers),
                    "size": size, "contained": contained}
        # large: straight to the data plane, serialized in _store_results
        # (slab for mid-size, single-copy writev segment for big)
        return {"loc": "shm", "parts": (pickled, buffers), "size": size,
                "contained": contained}

    def _store_results(self, return_ids: List[str], value: Any,
                       num_returns: int) -> List[dict]:
        if num_returns == 0:
            return []
        values = [value] if num_returns == 1 else list(value)
        if num_returns > 1 and len(values) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{len(values)} values")
        out = []
        for oid, v in zip(return_ids, values):
            res = self._serialize_result(v)
            if res["loc"] == "shm":
                pickled, buffers = res.pop("parts")
                slab = self.slab
                if slab is not None and \
                        res["size"] <= GLOBAL_CONFIG.slab_object_max_bytes:
                    from ray_tpu_torch._private.serialization import to_wire_bytes
                    res["loc"] = self._write_wire(
                        oid, to_wire_bytes(pickled, buffers), overwrite=True)
                else:
                    shm_write_value(oid, pickled, buffers, overwrite=True)
            elif res["loc"] == "upload":
                pickled, buffers = res.pop("parts")
                res["loc"] = self._spool_or_upload(oid, pickled, buffers)
            out.append(res)
        return out

    def _spool_or_upload(self, oid: str, pickled, buffers) -> str:
        """Large bytes leaving a proxied worker: spool on THIS host's P2P
        data plane when an agent provides one (consumers pull from the
        holder directly; head relays only as fallback) — else stream to
        the head's store in chunks.  Returns the sealed loc.

        The spool write rides ``write_value_to_fd``'s writev path: the
        pickle head and out-of-band buffers stream straight from their
        backing memory into the spool file — the full wire bytes are
        never materialized in this process's heap.

        NOTE: remote-spooled objects currently do not survive a HEAD
        restart — agents exit on head loss (liveness watch), taking their
        spools with them; the GCS snapshot therefore indexes only
        head-local shm objects.  Agent reconnect (and with it spool
        survival) is the follow-on."""
        spool = os.environ.get("RTT_SPOOL_DIR")
        if spool:
            data_plane.write_spool_value(spool, oid, pickled, buffers)
            return "remote"
        from ray_tpu_torch._private.serialization import to_wire_bytes
        self._upload_wire(oid, to_wire_bytes(pickled, buffers))
        return "shm"  # now lives in the head's tmpfs plane

    def _upload_wire(self, oid: str, wire: bytes) -> None:
        """Stream large wire bytes to the head's store in chunks (the
        outbound half of cross-host transfer — reference: ObjectManager
        push; SURVEY.md §5.8 object plane)."""
        chunk = GLOBAL_CONFIG.transfer_chunk_bytes
        mv = memoryview(wire)
        total = len(wire)
        off = 0
        while True:
            piece = bytes(mv[off:off + chunk])
            resp = self.rpc("put_chunk", object_id=oid, offset=off,
                            total=total, data=piece)
            off += len(piece)
            if off >= total:
                if not resp.get("done"):
                    raise RuntimeError(f"chunked upload of {oid} incomplete")
                return

    def _apply_runtime_env(self, spec: dict):
        from ray_tpu_torch._private import runtime_env as renv
        return renv.apply(spec.get("runtime_env"), self)

    def _restore_runtime_env(self, saved: dict) -> None:
        from ray_tpu_torch._private import runtime_env as renv
        renv.restore(saved)

    def _execute_task(self, spec: dict) -> None:
        t0 = time.time()          # wall clock: timeline events
        t0m = time.monotonic()    # monotonic: latency metric (NTP-safe)
        with self._cancel_lock:
            self._current_spec = spec
            self._in_user_fn = False
        self.ctx.in_task = True
        self.ctx.task_id = spec["task_id"]
        from ray_tpu_torch._private import flight_recorder
        if flight_recorder.enabled():
            flight_recorder.record(
                "exec", f"{spec.get('name', 'task')} "
                        f"{spec['task_id'][:16]}")
        done: dict = {}  # terminal frame (for the flight record below)
        parent_span = tracing.SpanContext.from_dict(spec.get("trace_ctx"))
        task_span = None
        if parent_span is not None:
            task_span = tracing.SpanContext(
                parent_span.trace_id, tracing._new_id(),
                parent_span.span_id, spec.get("name", "task"))
            tracing._set_span(task_span)
        saved_env = {}
        try:
            # inside the try: a bad runtime_env (missing KV blob, corrupt
            # zip) must fail THIS task, not kill the pooled worker process
            saved_env = self._apply_runtime_env(spec)
            fn = self.fetch_callable(spec["fn_id"])
            args, kwargs = self._unpack_args(spec)
            container = (spec.get("runtime_env") or {}).get("container")
            with self._cancel_lock:
                if self._cancel_pending.pop(spec["task_id"], 0) is None:
                    raise exc.TaskCancelledError(spec["task_id"])
                self._in_user_fn = True
            try:
                if container:
                    # per-task exec prefix: the body runs inside the image
                    # (reference: container runtime-env plugin)
                    from ray_tpu_torch._private import runtime_env as renv
                    value = renv.run_in_container(container, fn, args,
                                                  kwargs, self)
                else:
                    value = fn(*args, **kwargs)
            finally:
                with self._cancel_lock:
                    self._in_user_fn = False
            results = self._store_results(spec["return_ids"], value,
                                          spec["num_returns"])
            done = {"kind": "task_done", "task_id": spec["task_id"],
                    "status": "ok", "results": results}
            self._attach_timeline_event(done, spec, t0, task_span)
            self._send_event(done)
        except Exception as e:  # noqa: BLE001
            err = e if isinstance(e, exc.RayTaskError) else \
                exc.RayTaskError.from_exception(spec.get("name", "task"), e)
            done = {"kind": "task_done", "task_id": spec["task_id"],
                    "status": "app_error",
                    "error": serialize_to_bytes(err)[0]}
            self._attach_timeline_event(done, spec, t0, task_span)
            self._send_event(done)
        finally:
            if flight_recorder.enabled():
                flight_recorder.record(
                    "task_done", f"{spec['task_id'][:16]} "
                                 f"{done.get('status', '?')}")
            self._restore_runtime_env(saved_env)
            self._current_spec = None
            self.ctx.in_task = False
            self.ctx.task_id = None
            if task_span is not None:
                tracing._set_span(None)
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_task_exec_seconds").observe(
                    time.monotonic() - t0m,
                    tags={"name": spec.get("name", "task")})

    def _attach_timeline_event(self, done_msg: dict, spec: dict, t0: float,
                               task_span) -> None:
        """Timeline profile event riding the task_done frame: one message
        per task instead of two (the separate profile_events oneway was a
        measured per-task head wakeup + handler on the serial hot path)."""
        if not GLOBAL_CONFIG.timeline_enabled:
            return
        ev = {"name": spec.get("name", "task"), "cat": "task",
              "ph": "X", "pid": self.node_id, "tid": self._pid,
              "ts": t0 * 1e6, "dur": (time.time() - t0) * 1e6}
        if task_span is not None:
            ev["args"] = task_span.to_dict()
        done_msg["events"] = [ev]

    # ------------------------------------------------------------ actor side
    def _become_actor(self, spec: dict) -> bool:
        """Instantiate the actor and serve its method calls.  Returns True
        when the actor served and exited (worker process is done), False
        when CREATION failed — the GCS puts this worker back in the idle
        pool, so the caller must return to the plain task loop."""
        from ray_tpu_torch._private.actor_server import ActorServer
        self._current_spec = spec
        try:
            if (spec.get("runtime_env") or {}).get("container"):
                raise exc.RayTpuError(
                    "runtime_env['container'] applies to tasks; "
                    "containerized actors are not supported")
            # actor-lifetime runtime env (never restored: process is dedicated)
            self._apply_runtime_env(spec)
            cls = self.fetch_callable(spec["class_blob_id"])
            args, kwargs = self._unpack_args(spec)
            instance = cls(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            err = exc.RayTaskError.from_exception(
                spec.get("class_name", "Actor") + ".__init__", e)
            self._send_event({"kind": "actor_ready", "actor_id": spec["actor_id"],
                              "status": "error",
                              "error": serialize_to_bytes(err)[0]})
            self._current_spec = None
            return False
        self._current_spec = None
        server = ActorServer(self, spec, instance)
        # stop_worker must be able to stop the serve loop too: a
        # proc-less (remote/raylet) actor worker has no head-side pid
        # to signal, so ray_tpu_torch.kill reaches it as an OOB ctl frame
        self._actor_server = server
        # kept for GCS-restart reattach: the actor re-announces itself to
        # a fresh head with the same id + addr (state intact)
        self._actor_announce = {"actor_id": spec["actor_id"],
                                "status": "ok", "addr": server.addr}
        self._send_event({"kind": "actor_ready", "actor_id": spec["actor_id"],
                          "status": "ok", "addr": server.addr})
        # the main thread parks in serve_forever below: hand the task conn
        # to a monitor thread (head-death reattach, OOB fallback)
        threading.Thread(target=self._actor_conn_monitor,
                         name="actor-conn-monitor", daemon=True).start()
        server.serve_forever()  # returns on exit_actor / stop
        self._stop.set()
        return True


class _ActorChannel:
    """Caller-side direct connection to one actor (pipelined, ordered)."""

    def __init__(self, worker: Worker, actor_id: str, max_task_retries: int):
        self.worker = worker
        self.actor_id = actor_id
        self.max_task_retries = max_task_retries
        self.closed = False
        self._lock = threading.Lock()
        # Sends serialize on their OWN lock: _read_loop must never park
        # behind a blocked conn.send while holding up reply draining.
        # With the actor executing serial calls on its connection-reader
        # thread (actor_server direct-exec), the actor stops recv'ing
        # during a method — if the caller ALSO stopped draining replies
        # (reader parked on the state lock a blocked sender holds), a
        # pipelined burst of ~100KB inline args/results could fill both
        # socket buffers and deadlock all three parties.  The caller
        # draining unconditionally breaks every such cycle: the actor's
        # reply send always completes, so its reader always resumes.
        self._send_lock = threading.Lock()
        self._outstanding: Dict[str, dict] = {}
        self._conn = None
        self._incarnation = -1
        self._connect(timeout=GLOBAL_CONFIG.actor_connect_timeout_s)

    def _connect(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while True:
            info = self.worker.rpc("get_actor_info", actor_id=self.actor_id,
                                   timeout=max(0.1, deadline - time.monotonic()))
            if info["state"] == "ALIVE":
                try:
                    self._conn = self.worker.open_conn(info["addr"])
                    break
                except (OSError, ConnectionError):
                    # stale address: the actor died but the control plane
                    # hasn't flipped its state yet — keep polling until
                    # RESTARTING/DEAD shows up or the deadline passes
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
                    continue
            if info["state"] == "DEAD":
                cerr = info.get("creation_error")
                if cerr is not None:
                    raise deserialize_from(memoryview(cerr))
                raise exc.RayActorError(self.actor_id,
                                        info.get("death_reason") or "actor died")
            if time.monotonic() > deadline:
                raise exc.GetTimeoutError(
                    f"actor {self.actor_id} not ready after {timeout}s")
            time.sleep(0.05)
        self._incarnation = info["incarnation"]
        threading.Thread(target=self._read_loop, args=(self._conn,),
                         name=f"actor-ch-{self.actor_id[:6]}", daemon=True).start()

    def mark_done(self, call_id: str) -> None:
        """The call's result was observed via the authoritative store —
        it must never be resubmitted."""
        with self._lock:
            self._outstanding.pop(call_id, None)

    def send_call(self, msg: dict) -> None:
        with self._lock:
            if self.closed:
                raise exc.RayActorError(self.actor_id, "channel closed")
            self._outstanding[msg["call_id"]] = msg
            conn = self._conn
        # the possibly-blocking socket write happens OUTSIDE the state
        # lock (see _send_lock comment in __init__); registered-but-
        # unsent calls are safe — a channel break resubmits outstanding
        with self._send_lock:
            try:
                conn.send(msg)
            except (OSError, ValueError):
                # reconnect path handles resubmission via _read_loop EOF
                pass

    def _read_loop(self, conn) -> None:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError, TypeError):
                # TypeError: close() from another thread nulls the handle
                # mid-recv — same meaning as EOF here
                break
            call_id = msg.get("call_id")
            with self._lock:
                self._outstanding.pop(call_id, None)
            # cache BEFORE clearing in-flight state: a get() parked on the
            # inline fast path (_await_inline_results) re-checks the cache
            # first and must find the value the moment it wakes
            for oid, res in zip(msg["return_ids"], msg.get("inline_results") or []):
                if res is not None:
                    self.worker.cache_local(oid, res)
            with self.worker._actor_chan_lock:
                for oid in msg["return_ids"]:
                    self.worker._inflight_calls.pop(oid, None)
            # non-inline (big) results: wake parked getters so they fall
            # through to the authoritative GCS path
            self.worker._wake_local_waiters()
        self._on_disconnect()

    def _on_disconnect(self) -> None:
        with self._lock:
            if self.closed:
                return
            pending = dict(self._outstanding)
            self._outstanding.clear()
        if not pending:
            with self._lock:
                self.closed = True
            return
        # The inline reply and the death can race: the actor seals results
        # with the GCS (authoritative) BEFORE replying, so a call whose
        # returns are already sealed COMPLETED — resubmitting it would
        # re-execute a finished method (observable with stateful actors).
        # Drop those from the pending set before applying retry budgets.
        done: set = set()
        try:
            oids = {oid: cid for cid, m in pending.items()
                    for oid in m["return_ids"]}
            metas = self.worker.rpc("peek_meta",
                                    object_ids=list(oids)).get("metas", {})
            sealed = {oid for oid, meta in metas.items()
                      if meta and meta.get("state") in ("ready", "error")}
            for cid, m in pending.items():
                if all(oid in sealed for oid in m["return_ids"]):
                    done.add(cid)
        except Exception:  # noqa: BLE001 - GCS unreachable: fall through
            pass           # to the retry budget (at-least-once)
        # actor died with calls in flight: per-call retry budget decides
        # resubmission vs sealing an error (reference: max_task_retries)
        resubmit, fail = {}, {}
        for call_id, msg in pending.items():
            if call_id in done:
                continue
            left = msg.get("_retries_left", 0)
            if left != 0:
                msg["_retries_left"] = left - 1 if left > 0 else -1
                msg["_resubmitted"] = True  # receiver re-checks the seal
                resubmit[call_id] = msg
            else:
                fail[call_id] = msg
        if resubmit:
            try:
                self._connect(timeout=60.0)
                with self._lock:
                    for call_id, msg in resubmit.items():
                        self._outstanding[call_id] = msg
                        try:
                            self._conn.send(msg)
                        except (OSError, ValueError):
                            break
            except (exc.RayTpuError, OSError) as e:
                fail.update(resubmit)
                with self._lock:
                    self.closed = True
        if fail:
            err_wire = serialize_to_bytes(
                exc.RayActorError(self.actor_id,
                                  "actor died with calls in flight"))[0]
            oids = [oid for msg in fail.values() for oid in msg["return_ids"]]
            try:
                self.worker.rpc("seal_errors", object_ids=oids, error=err_wire)
            except Exception:  # noqa: BLE001 - gcs also going down
                pass
        if not resubmit:
            with self._lock:
                self.closed = True
        # parked inline-fast-path getters must re-check channel liveness
        # (a closed channel routes them to the authoritative GCS path)
        self.worker._wake_local_waiters()

    def close(self) -> None:
        with self._lock:
            self.closed = True
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
        self.worker._wake_local_waiters()
