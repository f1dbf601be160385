"""Raylet: the per-node local scheduler (DESIGN.md §4i).

Reference analog: ``src/ray/raylet/`` — ``NodeManager`` +
``LocalTaskManager`` (SURVEY.md §2).  The GCS stays the cluster's
*ledger* (placement policy, resource accounting, object directory, actor
FSM, placement groups, fault recovery, autoscaler feed); the raylet owns
the node's *hot path*:

- **Bulk lease claims.**  The GCS grants blocks of task specs (each spec
  = one worker lease, resources debited on the ledger at grant) in ONE
  ``lease_grant`` frame per scheduling pump instead of one push per
  task.  Plain-CPU specs beyond the node's resource fit ride the same
  frame as *queued* leases (``_lease_q``): they hold no ledger
  resources and start either by inheriting a finishing same-shape
  task's claim (handoff — the ledger moves the claim) or directly on
  an idle worker (pool-bounded local CPU oversubscription; nothing is
  ever released that was not acquired, so the ledger self-corrects at
  settlement).
- **Local dispatch + lease reuse.**  Workers attach their task/ctl
  connections to the raylet's unix socket, not the head.  A finishing
  task hands its lease to a queued same-shape spec and the worker runs
  it immediately — no head round-trip; the GCS hears about the handoff
  in the next ``raylet_done_batch`` entry (``next_task_id``) and moves
  the claim on the ledger after the fact.
- **Owner-local refcount batches.**  Workers route ``release`` /
  ``release_batch`` oneways to the raylet, which NETS them per client
  ledger and reconciles to the GCS every
  ``raylet_reconcile_interval_s`` as one ``raylet_ref_batch``.  Only
  releases ride this path — delaying a release is categorically safe
  (it can only delay a free); pins keep their direct ordering.
- **One keepalive.**  The lease channel doubles as node liveness
  (``raylet_heartbeat`` carries local scheduler stats); its EOF makes
  the GCS reclaim every outstanding lease and remove the node.  A clean
  shutdown instead returns unstarted leases (``raylet_lease_return``)
  and detaches (``raylet_detach``) so nothing waits on death detection.

Every lease frame is version-fenced: the raylet only attaches after the
``__proto_hello__`` negotiates ``wire.PROTO_RAYLET``; against an older
head :class:`RayletUnsupported` makes the NodeAgent fall back to the
legacy direct-GCS worker pool, byte-identical on the wire.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ray_tpu_torch._private import lock_watchdog, protocol, rtlog, wire
from ray_tpu_torch._private.config import GLOBAL_CONFIG

logger = rtlog.get("raylet")


class RayletUnsupported(RuntimeError):
    """The head does not speak PROTO_RAYLET: run the legacy agent path."""


def _needs_gpu(spec: dict) -> bool:
    """Does this lease ask for a card?  A funded spec carries its claim
    (``_req``), a queued lease its shape (``_lease_shape``)."""
    req = spec.get("_req") or spec.get("_lease_shape") or {}
    return req.get("GPU", 0) > 0


class _Slot:
    """One local worker's scheduling state."""

    def __init__(self, worker_id: str, conn, gpu: bool):
        self.worker_id = worker_id
        self.conn = conn              # task push channel (raylet-owned)
        # the worker sees the node's cards (RTT_GPU_WORKER=1, said at
        # attach): GPU leases start here alone, other leases never do
        self.gpu = gpu
        self.conn_lock = threading.Lock()
        self.ctl_conn = None          # OOB channel (cancel / dump_stack)
        self.ctl_conn_lock = threading.Lock()
        self.state = "idle"           # idle|busy|actor|dead
        self.current: Optional[dict] = None
        self.blocked = False

    def push(self, msg: dict) -> bool:
        with self.conn_lock:
            if self.conn is None:
                return False
            try:
                self.conn.send(msg)
                return True
            except (OSError, ValueError):
                return False

    def push_ctl(self, msg: dict) -> bool:
        with self.ctl_conn_lock:
            conn = self.ctl_conn
            if conn is not None:
                try:
                    conn.send(msg)
                    return True
                except (OSError, ValueError):
                    self.ctl_conn = None
        return self.push(msg)


class Raylet:
    """Per-node local scheduler.  Owns the upstream lease channel (an
    already-negotiated >= PROTO_RAYLET connection handed over by the
    NodeAgent) and a local unix listener workers attach to."""

    def __init__(self, head, node_id: str, node_info: dict, sock_dir: str,
                 spawn_cb: Callable[[], None],
                 on_lost: Callable[[], None],
                 upstream_conn=None, upstream_version: int = 0):
        # rtlint: owns(upstream_conn)
        self.head = head
        self.node_id = node_id
        self._node_info = dict(node_info)  # add_node fields for re-join
        self._spawn_cb = spawn_cb
        self._on_lost = on_lost
        if upstream_conn is None:
            upstream_conn, upstream_version = self._dial_upstream()
        elif upstream_version < wire.PROTO_RAYLET:
            raise RayletUnsupported(
                f"head speaks v{upstream_version} < v{wire.PROTO_RAYLET}")
        self._proto = upstream_version
        # --- lock domains (rtlint: RAYLET_LOCK_DAG in lock_watchdog.py) ---
        # _lock guards the scheduler tables; worker pushes deliberately
        # ride it (bounded local-pipe sends, like the GCS's
        # task_conn_lock).  _up_lock serializes upstream channel sends
        # and is NEVER held together with _lock: flushers collect under
        # _lock, send under _up_lock.
        self._lock = threading.Lock()
        self._up_lock = threading.Lock()
        self._up_conn = upstream_conn    # guarded by: _up_lock
        self.sock_path = os.path.join(sock_dir, "raylet.sock")
        self._stop = threading.Event()
        self._queue: deque = deque()                 # guarded by: _lock
        self._slots: Dict[str, _Slot] = {}           # guarded by: _lock
        self._idle: deque = deque()                  # guarded by: _lock
        self._done_batch: List[dict] = []            # guarded by: _lock
        # local worker deaths awaiting upstream report (flushed with
        # the done batch so the death never races its failed spec)
        self._dead_reports: List[str] = []           # guarded by: _lock
        # client ledger -> oid -> pending release count
        self._ref_net: Dict[str, Dict[str, int]] = {}  # guarded by: _lock
        self._stats = {"granted": 0, "dispatched": 0, "done": 0,
                       "handoffs": 0, "ref_ops_netted": 0,
                       "ref_ops_forwarded": 0}       # guarded by: _lock
        self._spawned_extra = 0                      # guarded by: _lock
        self._last_reconcile = time.monotonic()      # guarded by: _lock
        self._done_event = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listener = protocol.make_listener(self.sock_path)
        try:
            self._send_up("raylet_attach", node_id=self.node_id)
            for target, name in ((self._upstream_loop, "raylet-upstream"),
                                 (self._accept_loop, "raylet-accept"),
                                 (self._done_flush_loop, "raylet-done-flush"),
                                 (self._reconcile_loop, "raylet-reconcile")):
                t = threading.Thread(target=target, name=name, daemon=True)
                t.start()
                self._threads.append(t)
        except BaseException:
            # a half-built raylet must strand neither the listener nor
            # the upstream conn (NodeAgent retries / falls back)
            self._listener.close()
            try:
                upstream_conn.close()
            except OSError:
                pass
            raise
        logger.info("raylet up for node %s (proto v%d, sock %s)",
                    node_id[:8], self._proto, self.sock_path)

    # ------------------------------------------------------------ upstream
    def _dial_upstream(self):
        """Fresh negotiated lease channel to the head (reconnects)."""
        conn = protocol.tunnel_connect(*self.head, "gcs")
        try:
            ch = protocol.RpcChannel(conn)
            ver = ch.negotiate()
        except BaseException:
            try:
                conn.close()
            except OSError:
                pass
            raise
        if ver < wire.PROTO_RAYLET:
            try:
                conn.close()
            except OSError:
                pass
            raise RayletUnsupported(
                f"head speaks v{ver} < v{wire.PROTO_RAYLET}")
        return conn, ver

    def _send_up(self, kind: str, **fields) -> None:
        msg = {"kind": kind, "rid": None, **fields}
        with self._up_lock:
            conn = self._up_conn
            if conn is None:
                raise OSError("upstream lease channel down")
            wire.conn_send(conn, msg, self._proto)

    def _send_up_safe(self, kind: str, **fields) -> bool:
        try:
            self._send_up(kind, **fields)
            return True
        except (OSError, ValueError, EOFError):
            return False

    def _upstream_loop(self) -> None:
        """Read GCS pushes; on EOF re-join the (possibly restarted) head
        — re-add the node, re-announce the worker roster, and let the
        flushers re-report unsettled results and un-reconciled refcount
        deltas (the ledger-delta half of GCS fault tolerance)."""
        while not self._stop.is_set():
            with self._up_lock:
                conn = self._up_conn
            if conn is None:
                if not self._reconnect_upstream():
                    return
                continue
            try:
                # rtlint: blocks-ok(parks until the head pushes; head
                # death EOFs the channel and the reconnect loop's
                # jittered backoff (cap 0.5s) is the re-dial deadline)
                msg, _ = wire.conn_recv(conn)
            except (EOFError, OSError, wire.WireError):
                if self._stop.is_set():
                    return
                with self._up_lock:
                    if self._up_conn is conn:
                        self._up_conn = None
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            try:
                self._handle_push(msg)
            except Exception:  # noqa: BLE001 - one bad frame must not
                # kill the only grant reader
                logger.exception("raylet push failed: %s", msg.get("kind"))

    def _reconnect_upstream(self) -> bool:
        """Re-join the head after a lease-channel EOF.  Returns False
        when the grace expires (the node is then torn down)."""
        from ray_tpu_torch._private import flight_recorder
        deadline = time.monotonic() + GLOBAL_CONFIG.gcs_reconnect_timeout_s
        logger.warning("lost lease channel to head; rejoining for up "
                       "to %.0fs", GLOBAL_CONFIG.gcs_reconnect_timeout_s)
        # jittered backoff (protocol.backoff_delays): a fleet of raylets
        # re-joining a promoted standby must not dial in lockstep
        delays = protocol.backoff_delays(cap=0.5, base=0.05)
        while not self._stop.is_set() and time.monotonic() < deadline:
            conn = None
            try:
                conn, ver = self._dial_upstream()
                ch = protocol.RpcChannel(conn)
                ch.version = ver
                resp = ch.call("add_node", **self._node_info)
                self.node_id = resp["node_id"]
                msg = {"kind": "raylet_attach", "rid": None,
                       "node_id": self.node_id}
                wire.conn_send(conn, msg, ver)
                with self._lock:
                    roster = [{"worker_id": wid, "gpu": s.gpu}
                              for wid, s in self._slots.items()
                              if s.state != "dead"]
                roster_msg = {"kind": "raylet_workers", "rid": None,
                              "node_id": self.node_id, "workers": roster}
                wire.conn_send(conn, roster_msg, ver)
                with self._up_lock:
                    self._up_conn = conn
                    self._proto = ver
                flight_recorder.record("raylet", "rejoined head as "
                                       + self.node_id[:8])
                logger.info("rejoined head as node %s; re-reporting "
                            "ledger deltas", self.node_id[:8])
                # unsettled results + netted refs re-flush on the new
                # channel (at-least-once, the documented FT contract)
                self._done_event.set()
                self._flush_refs()
                return True
            except RayletUnsupported:
                break  # a DOWNGRADED head: no lease protocol anymore
            except (OSError, EOFError, ConnectionError, Exception):  # noqa: BLE001
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
                with lock_watchdog.bounded_block(
                        "raylet.reconnect_backoff"):
                    stopped = self._stop.wait(next(delays))
                if stopped:
                    return False
        if not self._stop.is_set():
            logger.error("could not rejoin head; shutting down node")
            self._on_lost()
        return False

    # ------------------------------------------------------- GCS -> raylet
    def _handle_push(self, msg: dict) -> None:
        kind = msg.get("kind")
        from ray_tpu_torch._private import flight_recorder
        if flight_recorder.enabled() and kind != "lease_grant":
            flight_recorder.record("raylet_push", str(kind))
        if kind == "lease_grant":
            specs = msg.get("specs", ())
            if flight_recorder.enabled():
                flight_recorder.record("lease_grant", f"n={len(specs)}")
            with self._lock:
                self._stats["granted"] += len(specs)
                self._queue.extend(specs)
                self._dispatch_locked()
            self._maybe_spawn_extra()
        elif kind == "lease_revoke":
            ids = set(msg.get("task_ids", ()))
            run_cancel: List[tuple] = []
            with self._lock:
                self._queue = deque(s for s in self._queue
                                    if s["task_id"] not in ids)
                for s in self._slots.values():
                    if s.current is not None \
                            and s.current.get("task_id") in ids:
                        # capture the id UNDER the lock: a handoff may
                        # re-fill the slot before the ctl push, and the
                        # successor must not eat the cancel
                        run_cancel.append((s, s.current["task_id"]))
            for s, tid in run_cancel:
                s.push_ctl({"kind": "cancel", "task_id": tid})
        elif kind == "worker_ctl":
            with self._lock:
                slot = self._slots.get(msg.get("worker_id"))
            if slot is not None:
                slot.push_ctl(msg.get("msg", {}))
        elif kind == "raylet_stop":
            self._on_lost()

    # ------------------------------------------------------ local scheduler
    def _dispatch_locked(self) -> None:
        """_lock held.  Start leases on idle workers.  Funded specs
        first (their claims are on the ledger); queued ``_lease_q``
        specs may ALSO start on an idle worker — concurrency is bounded
        by the worker pool itself, so this is at most a bounded local
        CPU oversubscription on the ledger (the piggyback argument,
        node-scoped), and the settlement path self-corrects: an
        unfunded spec carries no ``_req``, so nothing is ever released
        that was not acquired.  Waiting for funding instead would idle
        a worker for a reconcile round-trip per chain break.

        A lease that asks for ``GPU`` starts only on the GPU slot and
        any other lease only on a plain one, as the head's
        ``_idle_worker_on`` matches its own workers: with no matching
        slot idle, the lease waits."""
        while self._idle and self._queue:
            kinds = {s.gpu for s in map(self._slots.get, self._idle)
                     if s is not None and s.state == "idle"}
            i = next((i for i, c in enumerate(self._queue)
                      if not c.get("_lease_q") and _needs_gpu(c) in kinds),
                     None)
            if i is None:  # a queued lease may start on a free worker
                i = next((i for i, c in enumerate(self._queue)
                          if _needs_gpu(c) in kinds), None)
            if i is None:
                return
            spec = self._queue[i]
            del self._queue[i]
            self._start_on_locked(self._pop_idle_locked(_needs_gpu(spec)),
                                  spec)

    def _pop_idle_locked(self, gpu: bool) -> _Slot:
        """_lock held.  The first idle slot of the wanted kind (one
        exists); stale ids ahead of it are dropped."""
        for wid in list(self._idle):
            slot = self._slots.get(wid)
            if slot is None or slot.state != "idle":
                self._idle.remove(wid)
            elif slot.gpu == gpu:
                self._idle.remove(wid)
                return slot
        raise AssertionError("no idle slot of the kind the lease needs")

    def _start_on_locked(self, slot: _Slot, spec: dict) -> None:
        """_lock held.  Push one spec to a worker (push rides _lock by
        design — a bounded local-pipe send, like GCS task pushes)."""
        slot.state = "busy"
        slot.current = spec
        self._stats["dispatched"] += 1
        kind = ("create_actor" if spec.get("is_actor_creation")
                else "execute_task")
        if not slot.push({"kind": kind, "spec": spec, "dseq": 0,
                          "queued": []}):
            self._worker_died_locked(slot)

    def _take_handoff_locked(self, spec: dict) -> Optional[dict]:
        """_lock held.  A queued lease that can inherit ``spec``'s claim
        (same resource shape — the GCS granted it against this chain).
        PG-funded specs never hand off: their claim lives on the PG
        bundle, not the node ledger."""
        req = spec.get("_req")
        if req is None or spec.get("_pg_claim") is not None:
            return None
        for _ in range(len(self._queue)):
            cand = self._queue.popleft()
            if cand.get("_lease_q") and cand.get("_lease_shape") == req:
                return cand
            self._queue.append(cand)
        return None

    def _maybe_spawn_extra(self) -> None:
        """Replacement workers while the pool is blocked in get() with
        leased work queued (reference: raylet spawns replacements for
        blocked workers — bounded, or nested task chains deadlock)."""
        with self._lock:
            # a replacement is a plain worker: only plain leases wait
            # for one, and only plain slots count as capacity
            if self._stop.is_set() or all(map(_needs_gpu, self._queue)):
                return
            free = any(s.state == "idle" and not s.gpu
                       for s in self._slots.values())
            unblocked_busy = any(s.state == "busy" and not s.blocked
                                 and not s.gpu
                                 for s in self._slots.values())
            if free or unblocked_busy:
                return
            if self._spawned_extra >= GLOBAL_CONFIG.raylet_spawn_headroom:
                return
            self._spawned_extra += 1
        try:
            self._spawn_cb()
        except Exception:  # noqa: BLE001 - spawn is best-effort
            logger.exception("replacement worker spawn failed")

    # ------------------------------------------------------ worker channel
    def _accept_loop(self) -> None:
        protocol.serve_accept_loop(self._listener,
                                   lambda: self._stop.is_set(),
                                   self._serve_conn, "raylet-serve-conn")

    def _serve_conn(self, conn) -> None:
        """One local connection: a worker's task channel, ctl channel, or
        refcount channel — decided by its first frame."""
        try:
            try:
                # rtlint: blocks-ok(a dialer writes its attach frame in
                # the same breath as the dial; one that dies first EOFs
                # here — worker liveness is the deadline)
                first = conn.recv()
            except (EOFError, OSError):
                return
            kind = first.get("kind")
            if kind == "attach_task_conn":
                self._worker_loop(first["worker_id"], conn,
                                  bool(first.get("gpu")))
                return  # _worker_loop owns + closes the conn
            if kind == "attach_worker_ctl":
                self._ctl_park(first["worker_id"], conn)
                return
            if kind == "ref_chan":
                self._ref_loop(conn)
                return
            logger.warning("unknown raylet attach kind %r", kind)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _ctl_park(self, worker_id: str, conn) -> None:
        with self._lock:
            slot = self._slots.get(worker_id)
            if slot is not None:
                with slot.ctl_conn_lock:
                    slot.ctl_conn = conn
        while not self._stop.is_set():
            try:
                # rtlint: blocks-ok(parks for the worker's lifetime;
                # worker death EOFs its ctl pipe — the monitored-process
                # exit IS the deadline, same contract as _worker_loop)
                conn.recv()
            except (EOFError, OSError):
                break
        with self._lock:
            slot = self._slots.get(worker_id)
        if slot is not None:
            with slot.ctl_conn_lock:
                if slot.ctl_conn is conn:
                    slot.ctl_conn = None

    def _ref_loop(self, conn) -> None:
        """Net release oneways from a local worker.  +N releases of one
        oid collapse to a count; the reconcile loop ships the batch."""
        while not self._stop.is_set():
            try:
                # rtlint: blocks-ok(parks between a local worker's
                # release oneways; worker death EOFs the pipe and the
                # reconcile loop settles whatever was already netted)
                msg = conn.recv()
            except (EOFError, OSError):
                return
            kind = msg.get("kind")
            client = msg.get("client_id")
            with self._lock:
                net = self._ref_net.setdefault(client, {})
                if kind == "release":
                    net[msg["object_id"]] = net.get(msg["object_id"], 0) + 1
                    self._stats["ref_ops_netted"] += 1
                elif kind == "release_batch":
                    oids = msg.get("object_ids", ())
                    for oid in oids:
                        net[oid] = net.get(oid, 0) + 1
                    # per-oid count, same unit as ref_ops_forwarded —
                    # the netted/forwarded ratio is the collapse factor
                    self._stats["ref_ops_netted"] += len(oids)
                else:
                    # anything else is a contract violation of the
                    # worker-side router; drop loudly rather than
                    # corrupt the ledger
                    logger.warning("non-release kind %r on ref channel",
                                   kind)

    def _worker_loop(self, worker_id: str, conn, gpu: bool) -> None:
        slot = _Slot(worker_id, conn, gpu)
        with self._lock:
            old = self._slots.get(worker_id)
            if old is not None and old.state != "dead":
                self._worker_died_locked(old)
            self._slots[worker_id] = slot
            self._idle.append(worker_id)
            self._dispatch_locked()
        logger.info("worker %s attached", worker_id[:8])
        while not self._stop.is_set():
            try:
                # rtlint: blocks-ok(parks between a local worker's task
                # events; worker death EOFs the pipe and the slot is
                # reaped below — process liveness is the deadline)
                msg = conn.recv()
            except (EOFError, OSError):
                break
            try:
                self._on_worker_event(slot, msg)
            except Exception:  # noqa: BLE001 - keep the channel alive
                logger.exception("worker event failed: %s", msg.get("kind"))
        with self._lock:
            if self._slots.get(worker_id) is slot and slot.state != "dead":
                self._worker_died_locked(slot)

    def _on_worker_event(self, slot: _Slot, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "task_done":
            self._on_task_done(slot, msg)
        elif kind == "task_blocked":
            with self._lock:
                slot.blocked = True
                spec = slot.current
            if spec is not None:
                self._send_up_safe("raylet_task_blocked",
                                   node_id=self.node_id,
                                   task_id=spec.get("task_id"))
            self._maybe_spawn_extra()
        elif kind == "task_unblocked":
            with self._lock:
                slot.blocked = False
                spec = slot.current
            if spec is not None:
                self._send_up_safe("raylet_task_unblocked",
                                   node_id=self.node_id,
                                   task_id=spec.get("task_id"))
        elif kind == "actor_ready":
            with self._lock:
                if msg.get("status") == "ok" or msg.get("reattach"):
                    slot.state = "actor"
                    slot.current = None
                else:
                    # creation failed: the worker returns to its task
                    # loop; give the slot back to the local pool
                    slot.state = "idle"
                    slot.current = None
                    self._idle.append(slot.worker_id)
                    self._dispatch_locked()
            self._send_up_safe("raylet_fwd", node_id=self.node_id,
                               worker_id=slot.worker_id, msg=msg)
        else:
            # actor_result / actor_exit / stack_dump / log /
            # profile_events: the GCS's worker-event machinery handles
            # these unchanged — forward verbatim
            self._send_up_safe("raylet_fwd", node_id=self.node_id,
                               worker_id=slot.worker_id, msg=msg)

    def _on_task_done(self, slot: _Slot, msg: dict) -> None:
        from ray_tpu_torch._private import flight_recorder
        with self._lock:
            spec = slot.current
            if spec is None or spec.get("task_id") != msg.get("task_id"):
                return
            slot.current = None
            entry = {"task_id": msg["task_id"], "status": msg["status"],
                     "results": msg.get("results"),
                     "error": msg.get("error"),
                     "events": msg.get("events"),
                     "return_ids": list(spec.get("return_ids", ()))}
            self._stats["done"] += 1
            # lease reuse: a queued same-shape spec inherits this claim
            # and starts NOW — zero head round-trips on the chain
            nxt = self._take_handoff_locked(spec)
            if nxt is not None:
                entry["next_task_id"] = nxt["task_id"]
                nxt.pop("_lease_q", None)
                nxt.pop("_lease_shape", None)
                nxt["_req"] = spec.get("_req")
                self._stats["handoffs"] += 1
                self._start_on_locked(slot, nxt)
            elif slot.state == "busy":
                slot.state = "idle"
                self._idle.append(slot.worker_id)
                self._dispatch_locked()
            self._done_batch.append(entry)
        if flight_recorder.enabled():
            flight_recorder.record(
                "raylet_done", f"{msg['task_id'][:16]} {msg['status']}"
                               f"{' handoff' if 'next_task_id' in entry else ''}")
        self._done_event.set()

    def _worker_died_locked(self, slot: _Slot) -> None:
        """_lock held.  Report the death + the running spec upstream;
        the NodeAgent's pool loop respawns the process."""
        if slot.state == "dead":
            return
        slot.state = "dead"
        with slot.conn_lock:
            slot.conn = None
        try:
            self._idle.remove(slot.worker_id)
        except ValueError:
            pass
        spec = slot.current
        slot.current = None
        if spec is not None:
            self._done_batch.append(
                {"task_id": spec["task_id"], "status": "worker_died",
                 "return_ids": list(spec.get("return_ids", ()))})
        # the death notice rides the done flusher (never sent under
        # _lock: upstream sends stay outside the scheduler's critical
        # section), AFTER the failed spec's entry so the head observes
        # them in causal order
        self._dead_reports.append(slot.worker_id)
        self._slots.pop(slot.worker_id, None)
        self._done_event.set()

    # --------------------------------------------------------- reconcilers
    def _done_flush_loop(self) -> None:
        """Ship completed leases upstream.  Drains IMMEDIATELY when the
        node is quiet (serial latency) and coalesces adaptively under
        load: once a drain carries several entries, the next drain
        waits a beat so settlement batches (and the head's per-batch
        lock acquisitions) grow instead of degenerating to one frame
        per task."""
        busy = False
        while not self._stop.is_set():
            with lock_watchdog.bounded_block("raylet.done_flush_tick"):
                self._done_event.wait(1.0)
            if self._stop.is_set():
                return
            if busy:
                time.sleep(0.005)  # coalesce window under load only
            self._done_event.clear()
            with self._lock:
                n = len(self._done_batch)
            busy = n >= 4
            self._flush_done()

    def _flush_done(self) -> None:
        with self._lock:
            if not self._done_batch and not self._dead_reports:
                return
            batch, self._done_batch = self._done_batch, []
            deaths, self._dead_reports = self._dead_reports, []
        ok = True
        if batch:
            ok = self._send_up_safe("raylet_done_batch",
                                    node_id=self.node_id, entries=batch)
        if ok:
            for wid in deaths:
                self._send_up_safe("raylet_worker_died",
                                   node_id=self.node_id, worker_id=wid)
        else:
            # channel down: retain for the post-reconnect re-flush
            with self._lock:
                self._done_batch[:0] = batch
                self._dead_reports[:0] = deaths

    def _flush_refs(self) -> None:
        with self._lock:
            if not any(self._ref_net.values()):
                self._last_reconcile = time.monotonic()
                return
            net, self._ref_net = self._ref_net, {}
        ops = []
        n_ops = 0
        for client, oids in net.items():
            object_ids = []
            for oid, cnt in oids.items():
                object_ids.extend([oid] * cnt)
                n_ops += cnt
            if object_ids:
                ops.append(["release_batch",
                            {"client_id": client, "object_ids": object_ids}])
        if not ops:
            return
        if self._send_up_safe("raylet_ref_batch", node_id=self.node_id,
                              ops=ops, netted=n_ops):
            with self._lock:
                self._stats["ref_ops_forwarded"] += n_ops
                self._last_reconcile = time.monotonic()
        else:
            with self._lock:  # merge back for the re-flush
                for client, oids in net.items():
                    cur = self._ref_net.setdefault(client, {})
                    for oid, cnt in oids.items():
                        cur[oid] = cur.get(oid, 0) + cnt

    def _reconcile_loop(self) -> None:
        period = max(0.05, GLOBAL_CONFIG.raylet_reconcile_interval_s)
        while not self._stop.wait(period):
            self._flush_refs()
            with self._lock:
                stats = dict(self._stats)
                stats["queued"] = len(self._queue)
                stats["idle"] = len(self._idle)
                stats["busy"] = sum(1 for s in self._slots.values()
                                    if s.state == "busy")
                stats["blocked"] = sum(1 for s in self._slots.values()
                                       if s.blocked)
                age = time.monotonic() - self._last_reconcile
            self._send_up_safe("raylet_heartbeat", node_id=self.node_id,
                               stats=stats, reconcile_age=age)

    # -------------------------------------------------------------- stop
    def stop(self) -> None:
        """Clean leave: flush every pending report, RETURN unstarted
        leases, and detach — the GCS reclaims nothing by death-detection
        (the satellite contract: shutdown hands the ledger back)."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._flush_done()
        self._flush_refs()
        with self._lock:
            queued = [s["task_id"] for s in self._queue]
            self._queue.clear()
        if queued:
            self._send_up_safe("raylet_lease_return",
                               node_id=self.node_id, task_ids=queued)
        self._send_up_safe("raylet_detach", node_id=self.node_id)
        with self._up_lock:
            conn, self._up_conn = self._up_conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            slots = list(self._slots.values())
            self._slots.clear()
        for s in slots:
            with s.conn_lock:
                conn, s.conn = s.conn, None
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            with s.ctl_conn_lock:
                ctl, s.ctl_conn = s.ctl_conn, None
            if ctl is not None:
                try:
                    ctl.close()
                except OSError:
                    pass
        logger.info("raylet stopped (returned %d queued leases)",
                    len(queued))
