"""GCS: the cluster control plane.

Reference: ``src/ray/gcs/gcs_server/`` + the raylet's ``ClusterTaskManager``
(SURVEY.md §2.1, §3).  One GCS per cluster, owning:

- node table + health (``GcsNodeManager`` analog),
- the object directory + centralized refcounting (deviation from the
  reference's owner-based protocol, documented in DESIGN.md — owner ids are
  embedded in ObjectIDs so a later migration to owner-based counting does not
  change the API),
- task scheduling: hybrid/spread/affinity policies + worker-pool management
  (the reference splits this between GCS and per-node raylets; on one host a
  single scheduler with per-"node" logical resource views is equivalent and
  is how the reference's own ``cluster_utils.Cluster`` tests behave),
- actor lifecycle FSM (``GcsActorManager``: PENDING→ALIVE→RESTARTING→DEAD),
- placement groups with PACK/SPREAD/STRICT_* and TPU-topology bundles
  (``GcsPlacementGroupManager``),
- function/class table, KV store, named actors, job table,
- lineage for object reconstruction (reference keeps lineage at owners'
  ``TaskManager``; centralized here).

Threading model: listener accept loop + one handler thread per connection +
a worker-process monitor thread.  Locking (see DESIGN.md §4c for the full
discipline): scheduler/node/worker/actor/PG state AND object-table
*mutation* live under ``self.lock`` (+``self.cv``); hot-kind *reads* run on
fast paths that never take it — ``_sealed`` is a lock-free read table of
terminal object metas, object waiters live under ``_waiter_lock``, the KV
plane under ``_kv_lock``, timeline events under ``_events_lock``, and
refcount oneways are coalesced per connection and applied in batches under
one global-lock acquisition (``_drain_ref_ops``).  Lock order is strictly
``lock → {_waiter_lock | _kv_lock | _events_lock}``; the leaf locks never
nest inside each other and never acquire the global lock.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from collections import OrderedDict, defaultdict, deque
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import protocol, rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.serialization import dumps_call
from ray_tpu_torch._private.session import Session, reap_orphan_segments
from ray_tpu_torch._private import shm_store
from ray_tpu_torch._private.shm_store import ShmObjectStore
from ray_tpu_torch.util import metrics_catalog as mcat
from ray_tpu_torch.util.metrics import is_metrics_key
from ray_tpu_torch.util.profiler import is_profile_key
from ray_tpu_torch import exceptions as exc

logger = rtlog.get("gcs")

# object meta states
PENDING, READY, ERROR = "pending", "ready", "error"
# actor states (reference FSM)
A_PENDING, A_ALIVE, A_RESTARTING, A_DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


class NodeState:
    def __init__(self, node_id: str, resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None):
        self.node_id = node_id
        self.resources_total = dict(resources)
        self.resources_avail = dict(resources)
        self.labels = labels or {}
        self.alive = True
        # lifecycle phase (DESIGN.md §4j): running -> draining (provider
        # preemption warning via ``node_draining``) -> terminating
        # (removal in progress).  Placement only targets ``running``
        # nodes; work already on a draining node keeps running until the
        # provider kills it.
        self.phase = "running"               # guarded by: lock
        self.drain_deadline: Optional[float] = None  # guarded by: lock
        self.drain_reason = ""               # guarded by: lock
        self.data_addr: Optional[str] = None  # P2P object-plane listener
        self.data_proto = 0  # holder's data-plane wire version (add_node)
        self.is_remote = False   # owned by a NodeAgent on another host:
        # the GCS cannot fork workers there (the agent owns the pool);
        # actors there listen on TCP and advertise tcp:// addresses
        self.workers: Set[str] = set()
        self.idle_workers: deque = deque()
        self.last_heartbeat = time.monotonic()
        # --- raylet lease channel (DESIGN.md §4i) ---
        # A node with a live raylet_conn is scheduled by GRANT: the pump
        # debits resources on this ledger and ships spec blocks down the
        # channel; the raylet dispatches locally and reports back in
        # batches.  leases_out is the ledger of granted-but-unsettled
        # specs — the unit of reclaim when the channel drops.
        self.raylet_conn = None          # guarded by: lock
        self.raylet_conn_lock = threading.Lock()
        self.raylet_proto = 0            # guarded by: lock
        self.raylet_epoch = 0            # guarded by: lock
        self.leases_out: Dict[str, dict] = {}   # guarded by: lock
        self.raylet_stats: dict = {}     # guarded by: lock
        self.raylet_reconcile_age = 0.0  # guarded by: lock

    def queued_lease_count(self) -> int:
        """Unfunded (``_lease_q``) leases outstanding on this node's
        raylet — the backlog-depth gate (lock held by callers)."""
        return sum(1 for s in self.leases_out.values()
                   if s.get("_lease_q"))

    def push_raylet(self, msg: dict) -> bool:
        """Push one lease frame to the node's raylet (wire-framed at the
        channel's negotiated version — never legacy pickle)."""
        from ray_tpu_torch._private import wire
        with self.raylet_conn_lock:
            if self.raylet_conn is None:
                return False
            try:
                wire.conn_send(self.raylet_conn, msg, self.raylet_proto)
                return True
            except (OSError, ValueError):
                return False

    def load(self) -> float:
        cpu_t = self.resources_total.get("CPU", 0.0)
        if cpu_t <= 0:
            return 1.0
        return 1.0 - self.resources_avail.get("CPU", 0.0) / cpu_t

    def schedulable(self) -> bool:
        """Placement eligibility: alive AND not draining/terminating —
        a node under a preemption warning keeps its running work but
        never receives new tasks/leases/bundles (DESIGN.md §4j)."""
        return self.alive and self.phase == "running"

    def fits(self, req: Dict[str, float]) -> bool:
        return all(self.resources_avail.get(k, 0.0) >= v - 1e-9
                   for k, v in req.items() if v > 0)

    def acquire(self, req: Dict[str, float]) -> None:
        for k, v in req.items():
            self.resources_avail[k] = self.resources_avail.get(k, 0.0) - v

    def release_res(self, req: Dict[str, float]) -> None:
        for k, v in req.items():
            self.resources_avail[k] = self.resources_avail.get(k, 0.0) + v


class WorkerState:
    def __init__(self, worker_id: str, node_id: str, pid: int):
        self.worker_id = worker_id
        self.node_id = node_id
        self.pid = pid
        self.proc: Optional[subprocess.Popen] = None
        self.state = "starting"  # starting|idle|busy|actor|dead
        self.gpu_capable = False # spawned with device access (sees the cards)
        self.task_conn = None    # Connection for pushes
        self.task_conn_lock = threading.Lock()
        # Out-of-band control channel (cancel / drop_queued / dump_stack /
        # stop_worker): with the worker executing tasks directly on its
        # task-conn reader thread (one fewer handoff per task), OOB
        # control must ride a second connection the worker's ctl thread
        # drains even mid-task.  Best-effort: absent (attach race,
        # reattach window) → fall back to the task conn.
        self.ctl_conn = None
        self.ctl_conn_lock = threading.Lock()
        self.blocked = False     # task currently parked in get() (CPU released)
        self.current_task: Optional[dict] = None
        # Lease pipelining (reference: lease reuse / worker lease caching):
        # same-shape tasks queue on the busy worker and ride its resource
        # lease; the worker's own task loop executes them in order, so the
        # per-task scheduler round trip overlaps with execution.
        self.pipeline: deque = deque()
        self.dseq = 0  # dispatch sequence for prepush revocation scoping
        self.actor_id: Optional[str] = None
        self.actor_addr: Optional[str] = None

    def push(self, msg: dict) -> bool:
        with self.task_conn_lock:
            if self.task_conn is None:
                return False
            try:
                self.task_conn.send(msg)
                return True
            except (OSError, ValueError):
                return False

    def push_ctl(self, msg: dict) -> bool:
        """Push an out-of-band control message (preferring the ctl conn so
        it is seen even while the worker's main thread executes a task)."""
        with self.ctl_conn_lock:
            conn = self.ctl_conn
            if conn is not None:
                try:
                    conn.send(msg)
                    return True
                except (OSError, ValueError):
                    self.ctl_conn = None
        return self.push(msg)


class ObjMeta:
    __slots__ = ("state", "loc", "data", "size", "node_id", "refcount",
                 "lineage_task", "contained", "has_producer")

    def __init__(self):
        self.state = PENDING
        self.loc = None          # inline|shm|spilled
        self.data: Optional[bytes] = None
        self.size = 0
        self.node_id: Optional[str] = None
        self.refcount = 0
        self.lineage_task: Optional[str] = None
        self.contained: List[str] = []  # refs nested inside the value
        # True while a submitted task's return is in flight: a PENDING
        # meta with a producer must survive refcount 0 (the seal is
        # coming); a PENDING meta WITHOUT one (resurrected by a stray
        # add_ref on a deleted object) must not leak forever — found by
        # the refcount fuzz (tests/test_protocol_sim.py).
        self.has_producer = False


class ActorState:
    def __init__(self, spec: dict):
        self.spec = spec
        self.actor_id = spec["actor_id"]
        self.state = A_PENDING
        self.worker_id: Optional[str] = None
        self.addr: Optional[str] = None
        self.restarts_left = spec.get("max_restarts", 0)
        self.name = spec.get("name")
        self.namespace = spec.get("namespace", "default")
        self.detached = spec.get("detached", False)
        self.death_reason: Optional[str] = None
        self.incarnation = 0


class PgState:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]], strategy: str,
                 name: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles              # requested resources per bundle
        self.strategy = strategy
        self.name = name
        self.state = PENDING                # pending|ready|removed
        self.assignment: List[Optional[str]] = [None] * len(bundles)  # node ids
        self.bundle_avail: List[Dict[str, float]] = [dict(b) for b in bundles]


# The GcsServer living in THIS process, if any (head == driver process).
# Worker.rpc short-circuits to it; see the note in GcsServer.__init__.
_INPROC_SERVER: Optional["GcsServer"] = None

# RPC kinds a FENCED head (a higher ledger epoch was claimed by a
# promoted standby — DESIGN.md §4l) still answers: pure reads that help
# an operator inspect the fenced process.  Everything else drops the
# connection so the caller's reconnect path re-dials the promoted head.
_FENCED_OK_KINDS = frozenset({
    "ping", "debug_dump", "timeline", "kv_get", "kv_mget", "kv_keys",
    "peek_meta", "pg_table", "list_nodes", "list_actors", "list_tasks",
    "list_objects", "list_workers", "cluster_resources", "store_stats",
    "metrics_query", "fleet_state", "fleet_events", "raylet_table",
    "resource_demand", "autopilot_status", "profile_query",
    "debug_incidents"})


class GcsServer:
    def __init__(self, session: Session, head_resources: Dict[str, float]):
        # Sanitizer first (RTT_RESOURCE_SANITIZER=1, §4f): every
        # acquisition below — shm maps, the listener, worker dials —
        # must be discharged by shutdown(), so tracking starts here
        from ray_tpu_torch._private import resource_sanitizer
        resource_sanitizer.maybe_install()
        self.session = session
        # Flight recorder (DESIGN.md §4h): crash-surviving mmap ring in
        # the session dir recording recent frames / dispatch decisions;
        # installed before any serve thread so nothing escapes it.
        from ray_tpu_torch._private import flight_recorder
        flight_recorder.maybe_install(session.path, "gcs")
        # Sampling profiler (DESIGN.md §4o): the head samples itself
        # too; its deltas skip the KV hop — the monitor loop drains
        # them straight into the ProfileStore below.
        from ray_tpu_torch.util import profiler as profiler_mod
        profiler_mod.maybe_install("gcs")
        self.store = ShmObjectStore(spill_dir=str(session.spill_dir))
        # this head's session joins the shm directory's registry before it
        # makes a segment, then the slabs and objects dead sessions left
        # there go (a head killed by a signal cannot unlink its own)
        session.register_process()
        reaped = reap_orphan_segments()
        if reaped:
            logger.info("reaped %d segment(s) of dead sessions: %s",
                        len(reaped), reaped[:8])
        # Native C++ slab store: the small-object data plane (workers attach
        # and read/write directly; the GCS owns lifecycle + refcount deletes).
        self.slab = None
        if GLOBAL_CONFIG.use_native_store:
            from ray_tpu_torch.native import SlabStore
            self.slab = SlabStore.create(
                session.slab_path(),
                GLOBAL_CONFIG.slab_memory_mb * 1024 * 1024)
        # --- lock domains (DESIGN.md §4c; DAG in lock_watchdog.py) ---
        # All six domain locks are created together, BEFORE any server
        # thread starts, so RTT_LOCK_WATCHDOG=1 can wrap the complete
        # set and assert the acquisition DAG at runtime (§4d).
        self.lock = threading.RLock()
        self.cv = threading.Condition(self.lock)
        # Object waiters under their own lock: seals (global lock held)
        # take it briefly to wake the exact blocked get/wait RPCs;
        # waiter registration/unregistration never touches the global
        # lock.  Lock order: self.lock -> _waiter_lock, never reversed.
        self._waiter_lock = threading.Lock()
        # KV plane (incl. the metrics receipt index) off the global lock:
        # per-process metrics publishers and config readers must not
        # contend with the scheduler.  Lock order: self.lock -> _kv_lock.
        self._kv_lock = threading.Lock()
        self._events_lock = threading.Lock()  # timeline event buffer
        self._dedup_lock = threading.Lock()   # reply-replay cache
        # remote-spool delete queue (leaf under the global lock: _decref
        # enqueues while holding it)
        self._peer_delete_lock = threading.Lock()
        # snapshot writer ordering lock — ABOVE the global lock in the
        # DAG (capture under lock, write file under persist only)
        self._persist_lock = threading.Lock()
        from ray_tpu_torch._private.lock_watchdog import watchdog_enabled, \
            wrap_gcs_locks
        if watchdog_enabled():
            wrap_gcs_locks(self)

        # Fast-path tables (GCS locking discipline, DESIGN.md §4c):
        # ``_sealed`` maps oid -> a reply-ready meta dict for objects in a
        # terminal state.  Written ONLY under self.lock (at seal / delete /
        # loss transitions), read LOCK-FREE (CPython dict reads are atomic
        # under the GIL) by get_meta/peek_meta/wait — the sealed-object
        # read path never touches the global lock.  Remote-spooled objects
        # appear only as markers (terminal-state visibility for the
        # waiter handshake and peek/wait); their replies need a live
        # node-table address lookup, so reads fall to the slow path.
        self._sealed: Dict[str, dict] = {}   # guarded by: lock (writes)

        self.nodes: Dict[str, NodeState] = {}          # guarded by: lock
        self.workers: Dict[str, WorkerState] = {}      # guarded by: lock
        self.objects: Dict[str, ObjMeta] = {}          # guarded by: lock
        # guarded by: lock
        self.client_refs: Dict[str, Dict[str, int]] = defaultdict(dict)
        self.pending_tasks: deque = deque()            # guarded by: lock
        # backlog composition by resource class (see _push_pending)
        # guarded by: lock
        self._pending_counts: Dict[str, int] = {
            "cpu": 0, "gpu": 0, "zero": 0, "special": 0}
        self.dep_waiting: Dict[str, List[dict]] = {}   # guarded by: lock
        # oid → waiter records for blocked get/wait RPCs: seals wake the
        # exact waiters instead of notify_all-storming every blocked call
        # into an O(oids) rescan (that was quadratic in batch gets)
        # guarded by: _waiter_lock
        self._object_waiters: Dict[str, List[dict]] = {}
        # `ray_tpu_torch stack` calls                          guarded by: lock
        self._stack_reqs: List[Dict[str, str]] = []
        self.infeasible_tasks: List[dict] = []         # guarded by: lock
        # task_id -> (worker, spec)                      guarded by: lock
        self.running: Dict[str, Tuple[str, dict]] = {}
        self.actors: Dict[str, ActorState] = {}        # guarded by: lock
        self.named_actors: Dict[Tuple[str, str], str] = {}  # guarded by: lock
        self.functions: Dict[str, bytes] = {}          # guarded by: lock
        # guarded by: _kv_lock
        self.kv: Dict[str, Dict[bytes, bytes]] = defaultdict(dict)
        self.pgs: Dict[str, PgState] = {}              # guarded by: lock
        self.lineage: Dict[str, dict] = {}             # guarded by: lock
        self.lineage_order: deque = deque(maxlen=20000)  # guarded by: lock
        # timeline events                        guarded by: _events_lock
        self.events: List[dict] = []
        # fleet lifecycle feed (DESIGN.md §4j): bounded ring of node
        # add/drain/remove + elastic re-mesh events, consumed by the
        # elasticity manager and `ray_tpu_torch status` through the
        # ``fleet_events`` cursor RPC          guarded by: _events_lock
        self._fleet_events: deque = deque(maxlen=512)
        self._fleet_event_seq = 0             # guarded by: _events_lock
        self._last_remesh: Optional[dict] = None  # guarded by: _events_lock
        self.dead_clients: Set[str] = set()            # guarded by: lock
        # in-flight chunked uploads                      guarded by: lock
        self._staging: Dict[str, dict] = {}
        # relay dedup                                    guarded by: lock
        self._remote_pulls: Dict[str, threading.Event] = {}
        # rc-0-at-seal grace                             guarded by: lock
        self._graceful_free: Dict[str, float] = {}
        self._last_metrics_sweep = 0.0        # dead-snapshot KV hygiene
        # head-side receipt time per __metrics__/ key: the sweep's grace
        # window must not trust publisher-host wall clocks (cross-host
        # skew > grace would reap a dying worker's final flush instantly)
        # guarded by: _kv_lock
        self._metrics_key_seen: Dict[str, float] = {}
        # __profile__/ receipts, same head-side receipt-time hygiene
        # guarded by: _kv_lock
        self._profile_key_seen: Dict[str, float] = {}
        # Metrics time-series store (DESIGN.md §4k): every __metrics__/
        # snapshot the KV plane already receives is ALSO ingested into
        # head-resident fixed-memory rings (zero new RPCs), queryable
        # via the metrics_query op and feeding the always-on straggler /
        # SLO-burn detectors (ticked by the monitor loop, anomalies into
        # the fleet-event feed).  The TSDB has its own leaf lock
        # (TSDB_LOCK_DAG) and is never called with a GCS lock held.
        self._tsdb = None
        self._detectors: List = []
        self._last_detector_check = 0.0
        # Ledger replication (DESIGN.md §4l): WAL + warm-standby hub,
        # created below once the durable tables are restored.  The
        # attribute exists from here so every _repl_record call site is
        # safe during __init__.  ``_fenced`` is flipped (only ever
        # False->True, by the hub's drain thread) when a HIGHER ledger
        # epoch appears in the session dir — a promoted standby owns
        # the ledger now; this head must drop mutating conns so their
        # clients re-dial the new endpoint.
        self._repl_hub = None
        self._fenced = False
        self.ledger_epoch = 0
        if GLOBAL_CONFIG.metrics_enabled and GLOBAL_CONFIG.tsdb_enabled:
            from ray_tpu_torch.util.metrics_catalog import SLO_RULES
            from ray_tpu_torch.util.tsdb import (SloBurnAlerter,
                                           StragglerDetector, TSDB)
            self._tsdb = TSDB(
                max_series=GLOBAL_CONFIG.tsdb_max_series,
                raw_slots=GLOBAL_CONFIG.tsdb_raw_samples)
            self._detectors = [
                StragglerDetector(
                    self._tsdb,
                    window_s=GLOBAL_CONFIG.tsdb_straggler_window_s,
                    ratio=GLOBAL_CONFIG.tsdb_straggler_ratio),
                SloBurnAlerter(self._tsdb, SLO_RULES)]
        # Profiling plane (DESIGN.md §4o): every __profile__/ receipt
        # the KV plane already gets is handed to the head-resident
        # windowed ProfileStore (fixed memory; history survives the
        # publisher's death).  Answered by the profile_query op; the
        # store has its own leaf lock (PROFILER_LOCK_DAG) and is never
        # called with a GCS lock held.
        self._profile_store = None
        self._last_profile_flush = 0.0        # monitor thread only
        if GLOBAL_CONFIG.profiler_enabled:
            from ray_tpu_torch.util.profiler import ProfileStore
            self._profile_store = ProfileStore()
        # Incident capture (§4o): node_id -> (capture time, bundle id).
        # Both writers (the detector pass and the autopilot's actuator
        # callback) run on the monitor thread, so this dedup ledger is
        # single-threaded — monitor thread only, no lock.
        self._incident_recent: Dict[str, Tuple[float, str]] = {}
        # Fleet autopilot (DESIGN.md §4n): the reflex arc turning the
        # detectors' fleet events + TSDB history into bounded
        # remediation actions.  Ticked from the monitor loop; reads the
        # fleet-event ring through its own cursor; actuates through the
        # internal drain/undrain paths and whatever autoscaler attaches
        # itself via AutoscalerLoop.  Off by default (autopilot_enabled).
        self._autopilot = None
        self._autopilot_cursor = 0
        self._last_autopilot = 0.0
        if GLOBAL_CONFIG.autopilot_enabled:
            from ray_tpu_torch.elastic.autopilot import (Autopilot,
                                                         AutopilotConfig,
                                                         GcsActuator)
            self._autopilot = Autopilot(
                AutopilotConfig.from_global_config(), GcsActuator(self))
        # reply cache for client-supplied request ids: makes the worker's
        # one post-reconnect retry exactly-once against a still-live GCS
        # (non-idempotent mutations must not double-apply when only the
        # channel broke, not the server)
        # guarded by: _dedup_lock
        self._dedup_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        # guarded by: _dedup_lock
        self._dedup_pending: Dict[tuple, threading.Event] = {}
        # Ledgers already torn down by release_all (lock held): a pin for
        # a closed call ledger arriving LATE (cross-channel race — the
        # caller's add_refs coalescing in flight while the actor's
        # release_all lands) must be dropped, not applied; an orphaned
        # ledger entry would pin its objects forever.
        # guarded by: lock
        self._closed_ledgers: "OrderedDict[str, None]" = OrderedDict()
        # remote-spool deletions, batched per holder node (see _decref);
        # the drain thread starts below, after _shutdown exists
        # guarded by: _peer_delete_lock
        self._peer_delete_q: Dict[str, List[str]] = defaultdict(list)
        self._peer_delete_event = threading.Event()
        # pooled data-plane conns to holder nodes (relay pull-throughs +
        # spool deletes reuse one dial+HMAC per holder); internal lock,
        # never held together with any GCS lock
        from ray_tpu_torch._private.data_plane import DataPlanePool
        self._data_pool = DataPlanePool()
        self.driver_ids: Set[str] = set()              # guarded by: lock
        self.log_sink = None                              # callable(line)
        self._shutdown = False
        self._spawn_counter = 0
        # warm GPU pool back-off (_top_up_gpu_workers), per node: GPU
        # workers that died in a row before registering, and the
        # monotonic time before which none is forked there again
        self._gpu_boot_failures: Dict[str, int] = {}    # guarded by: lock
        self._gpu_fork_after: Dict[str, float] = {}     # guarded by: lock
        threading.Thread(target=self._peer_delete_loop, daemon=True,
                         name="gcs-peer-delete").start()

        # server incarnation id: clients detect a true head RESTART (vs a
        # transient channel break) by comparing this across reconnects, and
        # resubmit their in-flight owned tasks (owner-based lineage — the
        # reference keeps task lineage in the owning worker's TaskManager)
        import uuid as _uuid
        self.epoch = _uuid.uuid4().hex

        self.head_node_id = NodeID.new()
        self.add_node_internal(self.head_node_id, head_resources, is_head=True)
        # Warm worker pool (reference: RAY_prestart_worker_first_driver /
        # worker-pool prestart): fork N plain workers NOW so the first
        # tasks — and Serve replica scale-ups (SURVEY.md §7.3 TPU cold
        # starts) — skip the worker-process boot (~10s on 1-core hosts,
        # measured in serve_bench_r04.json).  Under the lock: the peer-
        # delete and persist threads are already running, and
        # _spawn_worker mutates the worker table (rtlint unguarded).
        with self.lock:
            for _ in range(int(GLOBAL_CONFIG.prestart_workers or 0)):
                self._spawn_worker(self.head_node_id)

        # GCS fault tolerance (reference: GCS restart w/ Redis persistence,
        # SURVEY.md §5.3): durable tables snapshot to <session>/gcs_state;
        # a head started over a session dir that has one restores them and
        # gives surviving worker processes a grace window to reattach.
        self._snapshot_path = session.path / "gcs_state" / "snapshot.pkl"
        # (_persist_lock is created with the other lock domains above so
        # the watchdog wrap covers it)
        self._persist_event = threading.Event()
        self._prev_snapshot_wal_seq = 0  # guarded by: _persist_lock
        self._restored_at: Optional[float] = None
        if GLOBAL_CONFIG.gcs_snapshot:
            try:
                if self._restore_durable():
                    self._restored_at = time.monotonic()
            except Exception:  # noqa: BLE001 - corrupt snapshot: fresh start
                logger.exception("failed to restore GCS snapshot; "
                                 "starting fresh")
        if GLOBAL_CONFIG.gcs_snapshot:
            # Claim the next ledger epoch (fsynced): any still-alive
            # older head observes the bump at its fence poll and stops
            # mutating — the split-brain guard (DESIGN.md §4l).
            from ray_tpu_torch._private import replication
            self.ledger_epoch = replication.claim_epoch(session.path)
            if GLOBAL_CONFIG.gcs_wal:
                # WAL + warm-standby replication hub: handler threads
                # record durable mutations (O(1) buffer append); the
                # hub's drain thread owns fsync, streaming, rotation,
                # and the epoch-fence poll.
                tsdb_cb = None
                if self._tsdb is not None:
                    tsdb_cb = self._tsdb.export_since
                self._repl_hub = replication.ReplicationHub(
                    session.path, self.ledger_epoch,
                    snapshot_cb=self._capture_durable_state,
                    tsdb_export_cb=tsdb_cb,
                    on_fenced=self._on_fenced,
                    fsync=GLOBAL_CONFIG.gcs_wal_fsync)
            threading.Thread(target=self._persist_loop, name="gcs-persist",
                             daemon=True).start()

        self.rpc_path = session.socket_path("gcs.sock")
        self._listener = protocol.make_listener(self.rpc_path)
        self._threads: List[threading.Thread] = []
        try:
            t = threading.Thread(target=self._accept_loop,
                                 name="gcs-accept", daemon=True)
            t.start()
            self._threads.append(t)
            m = threading.Thread(target=self._monitor_loop,
                                 name="gcs-monitor", daemon=True)
            m.start()
            self._threads.append(m)
        except BaseException:
            # a failed boot returns no server object: the bound socket
            # file must not survive it (the next head would unlink a
            # listener it does not own)
            self._listener.close()
            raise
        # In-process dispatch short-circuit (reference analog: core_worker
        # short-circuiting its local raylet/plasma): a driver whose head
        # lives in ITS OWN process skips the socket + serve-thread wakeup
        # per RPC — Worker.rpc consults this global, guarded by rpc_path.
        global _INPROC_SERVER
        _INPROC_SERVER = self

    # ----------------------------------------------------- fault tolerance
    def _persist_durable(self) -> None:
        """Mark the durable tables dirty; a dedicated writer thread
        snapshots them shortly after (debounced).  Mutating handlers call
        this — cheap enough for any path, including ones holding the cv
        lock — and the crash window is bounded by the debounce interval."""
        if not GLOBAL_CONFIG.gcs_snapshot:
            return
        self._persist_event.set()

    def _persist_loop(self) -> None:
        while not self._shutdown:
            if not self._persist_event.wait(timeout=0.5):
                continue
            time.sleep(0.05)  # coalesce bursts of mutations
            self._persist_event.clear()
            if self._fenced:
                # a promoted standby owns the ledger: this head must
                # never clobber the new head's snapshot generations
                continue
            try:
                self._write_snapshot()
            except Exception:  # noqa: BLE001 - keep serving; retry next tick
                logger.exception("GCS snapshot write failed")
                self._persist_event.set()

    def _on_fenced(self, seen_epoch: int) -> None:
        """Hub drain thread: a higher ledger epoch appeared in the
        session dir — refuse mutations from here on (see _serve_conn /
        local_call; mutating conns are dropped so clients re-dial the
        promoted head's re-bound socket)."""
        self._fenced = True

    def _repl_record(self, *op) -> None:
        """Record one durable ledger mutation into the replication WAL
        (no-op without the hub; O(1) buffer append — legal under any
        GCS lock, see REPL_LOCK_DAG)."""
        hub = self._repl_hub
        if hub is not None:
            hub.record(*op)

    def _repl_actor_locked(self, a: "ActorState") -> None:
        """Lock held.  Record an actor's durable projection after any
        FSM transition — the same shape the snapshot captures (DEAD
        actors are absent from snapshots, so DEAD records a delete,
        which also keeps the standby's tables == the capture)."""
        if a.state == A_DEAD:
            # a dead actor never restarts: drop the pin on its
            # constructor's args (taken in _h_create_actor)
            self._release_deps(a.spec)
        if self._repl_hub is None:
            return
        if a.state == A_DEAD:
            self._repl_hub.record("actor", a.actor_id, None)
        else:
            self._repl_hub.record(
                "actor", a.actor_id,
                {"spec": {k: v for k, v in a.spec.items()
                          if not k.startswith("_")},
                 "state": a.state, "restarts_left": a.restarts_left,
                 "incarnation": a.incarnation})

    def _capture_durable_state(self) -> dict:
        """Capture the durable tables under lock + _kv_lock (reference:
        the GCS tables Redis persists — actors, PGs, KV, function
        exports).  The WAL position is read INSIDE the critical section:
        every record with seq <= wal_seq is reflected in the captured
        tables, and replaying any later (or overlapping) record on top
        is idempotent — the snapshot+WAL equivalence contract the
        standby and restart paths both lean on."""
        with self.lock, self._kv_lock:
            state = {
                # __metrics__/ snapshots are ephemeral telemetry: a
                # restored head must not resurrect dead workers'
                # series, and busy-cluster snapshots must not grow by
                # one metrics payload per worker
                # empty namespaces pruned: apply_op prunes a namespace
                # when its last key is deleted (and a metrics-only one
                # would capture as {}), so the capture must too or the
                # snapshot+WAL == capture equivalence oracle diverges
                "kv": {ns: flt for ns, t in self.kv.items()
                       if (flt := {k: v for k, v in t.items()
                                   if not is_metrics_key(k)
                                   and not is_profile_key(k)})},
                "functions": dict(self.functions),
                "named_actors": dict(self.named_actors),
                "actors": {
                    aid: {"spec": {k: v for k, v in a.spec.items()
                                   if not k.startswith("_")},
                          "state": a.state,
                          "restarts_left": a.restarts_left,
                          "incarnation": a.incarnation}
                    for aid, a in self.actors.items()
                    if a.state != A_DEAD},
                "pgs": {pid: {"bundles": p.bundles,
                              "strategy": p.strategy, "name": p.name}
                        for pid, p in self.pgs.items()
                        if p.state != "removed"},
                "shm_objects": {
                    oid: m.size for oid, m in self.objects.items()
                    if m.loc == "shm" and m.state == READY},
                "driver_ids": set(self.driver_ids),
                "ledger_epoch": self.ledger_epoch,
                "wal_seq": (self._repl_hub.seq()
                            if self._repl_hub is not None else 0),
            }
        return state

    def _write_snapshot(self) -> None:
        """Capture + write under one ordering lock so a slow writer can
        never clobber a newer snapshot with stale state.  The write is
        crash-safe (fsync tmp + dir, previous generation kept — see
        replication.write_snapshot_file) and rotates the WAL: records
        covered by this snapshot are no longer needed for replay."""
        from ray_tpu_torch._private import replication
        with self._persist_lock:
            state = self._capture_durable_state()
            replication.write_snapshot_file(self._snapshot_path, state)
            # Rotate the WAL one GENERATION behind: segments are only
            # deleted once covered by the PREVIOUS snapshot too, so the
            # .prev fallback (torn-newest restore) always finds the WAL
            # tail that bridges it forward.
            covered, self._prev_snapshot_wal_seq = \
                self._prev_snapshot_wal_seq, state["wal_seq"]
        if self._repl_hub is not None:
            self._repl_hub.rotate(covered)

    def _restore_durable(self) -> bool:
        """Rebuild durable tables from the newest consistent durable
        state: the newest readable snapshot generation (a torn newest
        falls back to the previous one) plus the fsynced WAL tail
        replayed on top (replication.load_durable_state).  Returns True
        when anything was restored.  Actors come back RESTARTING: their
        processes may still be alive (workers outlive the head and
        reconnect — see worker.run_worker_loop); if one doesn't
        reattach within gcs_restore_grace_s the normal restart path
        (max_restarts) takes over.

        Everything is parsed into temporaries FIRST, then applied — a
        malformed/old-format snapshot must fail before mutating any
        table, or restored actors would sit RESTARTING forever with no
        grace timer running."""
        from ray_tpu_torch._private import replication
        state = replication.load_durable_state(
            self.session.path, snapshot_path=self._snapshot_path)
        if state is None:
            return False
        restored_actors = []
        for aid, rec in state["actors"].items():
            a = ActorState(rec["spec"])
            a.state = A_RESTARTING
            a.restarts_left = rec["restarts_left"]
            a.incarnation = rec["incarnation"]
            restored_actors.append((aid, a))
        restored_pgs = [
            (pid, PgState(pid, rec["bundles"], rec["strategy"],
                          rec["name"]))
            for pid, rec in state["pgs"].items()]
        # strip metrics keys defensively: current snapshots never contain
        # them, but a pre-exemption snapshot must not resurrect dead
        # publishers' series (and such keys would be invisible to the
        # sweep's receipt index)
        kv_tables = {ns: {k: v for k, v in t.items()
                          if not is_metrics_key(k)
                          and not is_profile_key(k)}
                     for ns, t in state["kv"].items()}
        functions = dict(state["functions"])
        named = dict(state["named_actors"])
        # only segments this snapshot knows about — a host-global scan
        # would adopt (and later evict/delete) segments belonging to
        # OTHER live sessions on the same /dev/shm
        from ray_tpu_torch._private.shm_store import _seg_path
        shm_objects = []
        for oid, size in state.get("shm_objects", {}).items():
            try:
                if _seg_path(oid).stat().st_size >= 1:
                    shm_objects.append((oid, size))
            except OSError:
                continue

        logger.info("restoring GCS state from %s (%d actors, %d pgs, "
                    "%d shm objects)", self._snapshot_path,
                    len(restored_actors), len(restored_pgs),
                    len(shm_objects))
        with self.cv:
            with self._kv_lock:
                for ns, table in kv_tables.items():
                    self.kv[ns].update(table)
            self.functions.update(functions)
            self.named_actors.update(named)
            for aid, a in restored_actors:
                self.actors[aid] = a
            from ray_tpu_torch._private.pg_scheduler import schedule_bundles
            for pid, pg in restored_pgs:
                # old node ids are gone; re-place on the current nodes
                # (more re-placements happen lazily in _h_pg_wait as
                # nodes rejoin)
                assignment = schedule_bundles(
                    [n for n in self.nodes.values() if n.schedulable()],
                    pg.bundles, pg.strategy)
                if assignment is not None:
                    for i, node_id in enumerate(assignment):
                        self.nodes[node_id].acquire(pg.bundles[i])
                        pg.assignment[i] = node_id
                    pg.state = READY
                self.pgs[pid] = pg
            for oid, size in shm_objects:
                self.store.adopt(oid, size)
                meta = self.objects.get(oid)
                if meta is None:
                    meta = self.objects[oid] = ObjMeta()
                meta.state = READY
                meta.loc = "shm"
                meta.size = size
                self._publish_sealed_locked(oid, READY, "shm", None, size)
        return True

    def _restore_grace_check(self) -> None:
        """After the reattach grace window, push restored actors whose
        worker never came back through the normal death/restart path."""
        if self._restored_at is None:
            return
        if time.monotonic() - self._restored_at \
                < GLOBAL_CONFIG.gcs_restore_grace_s:
            return
        self._restored_at = None
        stranded = []
        with self.cv:
            for a in self.actors.values():
                if a.state == A_RESTARTING and a.worker_id is None and \
                        not any(w.actor_id == a.actor_id
                                for w in self.workers.values()):
                    stranded.append(a.actor_id)
        for aid in stranded:
            with self.cv:
                a = self.actors.get(aid)
                if a is None or a.state != A_RESTARTING \
                        or a.worker_id is not None:
                    continue
                logger.info("restored actor %s did not reattach; routing "
                            "through the restart path", aid)
                # the normal death path enforces max_restarts (budget
                # decrement, A_DEAD + named-table cleanup when exhausted)
                self._actor_worker_died(aid)
        if stranded:
            self._pump()

    # ------------------------------------------------------------------ nodes
    def add_node_internal(self, node_id: str, resources: Dict[str, float],
                          is_head: bool = False,
                          labels: Optional[Dict[str, str]] = None,
                          remote: bool = False,
                          data_addr: Optional[str] = None,
                          data_proto: int = 0) -> str:
        if data_addr and data_proto:
            # pre-seed the agent's advertised data-plane version so the
            # head's pooled conns skip the per-conn hello round trip
            self._data_pool.set_proto(data_addr, data_proto)
        with self.cv:
            res = dict(resources)
            res.setdefault("CPU", float(os.cpu_count() or 4) if is_head else 1.0)
            node = NodeState(node_id, res, labels)
            node.is_remote = remote
            node.data_addr = data_addr
            node.data_proto = int(data_proto or 0)
            # node-id resource enables NodeAffinity via plain resource matching
            node.resources_total[f"node:{node_id}"] = 1.0
            node.resources_avail[f"node:{node_id}"] = 1.0
            self.nodes[node_id] = node
            self.cv.notify_all()
        self._fleet_event("node_added", node_id,
                          labels=dict(labels or {}))
        return node_id

    def remove_node_internal(self, node_id: str) -> None:
        """Cluster fixture: simulate node failure (SURVEY.md §4 Cluster.remove_node)."""
        with self.cv:
            node = self.nodes.get(node_id)
            if node is None:
                return
            node.alive = False
            was_draining = node.phase == "draining"
            node.phase = "terminating"
            # raylet node: reclaim the outstanding lease ledger FIRST so
            # granted work re-queues before the workers are declared dead
            self._reclaim_raylet_leases_locked(node)
            with node.raylet_conn_lock:
                node.raylet_conn = None
            workers = [self.workers[w] for w in list(node.workers)]
            # and the ones forked for it that have not registered yet (a
            # GPU worker still importing torch): nothing else would stop
            # them, and one that registers later joins no node
            workers += [w for w in self.workers.values()
                        if w.node_id == node_id and w.state == "starting"
                        and w.proc is not None and w not in workers]
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
        with self.cv:
            for w in workers:
                self._handle_worker_death(w)
            # objects whose primary copy lived there are lost → reconstruction
            for oid, meta in self.objects.items():
                if meta.node_id == node_id and meta.state == READY and meta.loc != "inline":
                    self._mark_object_lost(oid, meta)
            del self.nodes[node_id]
            # the killed boots were no failure of the node's: it is gone
            self._gpu_boot_failures.pop(node_id, None)
            self._gpu_fork_after.pop(node_id, None)
            self.cv.notify_all()
        self._fleet_event("node_removed", node_id,
                          was_draining=was_draining)
        self._pump()

    # ---------------------------------------------------------------- objects
    def _get_or_create_meta(self, oid: str) -> ObjMeta:
        meta = self.objects.get(oid)
        if meta is None:
            meta = ObjMeta()
            self.objects[oid] = meta
        return meta

    def _publish_sealed_locked(self, oid: str, state: str, loc: str,
                               data: Optional[bytes], size: int) -> None:
        """Lock held.  Publish a terminal meta to the lock-free read
        table — the ONE place the reply-entry shape is built, so the
        fast path can never drift from the slow-path reply.  Remote-
        spooled objects get a MARKER entry: it makes the seal visible to
        the register-then-recheck waiter handshake and to peek/wait
        (terminal-state checks), but _read_sealed_fast refuses to serve
        it (the reply needs a live node-table address lookup, so those
        reads stay on the slow path)."""
        self._sealed[oid] = {"state": state, "loc": loc, "data": data,
                             "size": size}

    def _seal_object(self, oid: str, loc: str, data: Optional[bytes], size: int,
                     node_id: Optional[str], contained: List[str],
                     lineage_task: Optional[str] = None) -> None:
        meta = self._get_or_create_meta(oid)
        meta.state = READY
        meta.has_producer = False
        meta.loc = loc
        meta.data = data
        meta.size = size
        meta.node_id = node_id
        meta.contained = contained
        # publish to the lock-free read table BEFORE waking waiters: a
        # reader that observes the wake must find the entry
        self._publish_sealed_locked(oid, READY, loc, data, size)
        self._promote_dep_waiters(oid)
        self._notify_object_waiters(oid)
        if lineage_task:
            meta.lineage_task = lineage_task
        for c in contained:
            cm = self._get_or_create_meta(c)
            cm.refcount += 1  # the container holds a ref on nested objects
        if loc == "shm":
            # segment survives a head crash; keep the snapshot's shm index
            # current so a restarted head re-adopts it (just sets an event)
            self._repl_record("shm", oid, size)
            self._persist_durable()
        if meta.refcount <= 0:
            # Sealed with zero refs — e.g. an actor result whose caller
            # died mid-call: nothing will ever release it.  Free after a
            # grace period, NOT now: (a) the caller's add_refs oneway may
            # still be in flight on another channel (no cross-channel
            # ordering) and will rescue it, and (b) a just-woken getter
            # needs a moment to read/mmap (unlink under a live mmap is
            # safe by store design, so late frees cannot corrupt reads).
            self._graceful_free[oid] = time.monotonic()

    def _seal_error(self, oid: str, err_bytes: bytes) -> None:
        meta = self._get_or_create_meta(oid)
        meta.state = ERROR
        meta.has_producer = False
        meta.loc = "inline"
        meta.data = err_bytes
        self._publish_sealed_locked(oid, ERROR, "inline", err_bytes, 0)
        self._promote_dep_waiters(oid, errored=True)
        self._notify_object_waiters(oid)

    def _mark_object_lost(self, oid: str, meta: ObjMeta) -> None:
        self._sealed.pop(oid, None)  # no longer readable without the lock
        if meta.loc == "shm":
            # no longer a restorable segment: drop it from the durable
            # shm index so a promoted/restarted head won't re-adopt it
            self._repl_record("shm", oid, None)
        if meta.lineage_task and meta.lineage_task in self.lineage:
            meta.state = PENDING
            meta.has_producer = True  # the reconstruction below is the
            # producer; without this a zero-ref decref would zombie-delete
            # the meta out from under it
            meta.data = None
            spec = dict(self.lineage[meta.lineage_task])
            spec["is_reconstruction"] = True
            logger.info("reconstructing %s via task %s", oid, spec["task_id"])
            self._push_pending(spec)
        else:
            owner_dead = oid[:16] in self.dead_clients
            e = exc.OwnerDiedError(oid) if owner_dead else exc.ObjectLostError(oid)
            from ray_tpu_torch._private.serialization import serialize_to_bytes
            meta.state = ERROR
            meta.loc = "inline"
            meta.data = serialize_to_bytes(e)[0]
            self._publish_sealed_locked(oid, ERROR, "inline", meta.data, 0)
            # terminal transition outside _seal_error: wake dep-parked
            # specs and object waiters here too
            self._promote_dep_waiters(oid, errored=True)
            self._notify_object_waiters(oid)

    def _decref(self, oid: str, n: int = 1) -> None:
        meta = self.objects.get(oid)
        if meta is None:
            return
        meta.refcount -= n
        if meta.refcount <= 0 and meta.state == PENDING \
                and not meta.has_producer:
            # zombie: zero refs, nothing will ever seal it — drop the
            # entry (no data to free; a late seal re-creates it cleanly)
            del self.objects[oid]
            return
        if meta.refcount <= 0 and meta.state != PENDING:
            self._sealed.pop(oid, None)  # unpublish BEFORE freeing data
            for c in meta.contained:
                self._decref(c)
            if meta.loc in ("shm", "spilled"):
                self.store.delete_object(oid)
                self._repl_record("shm", oid, None)
            elif meta.loc == "slab" and self.slab is not None:
                self.slab.delete(oid)
            elif meta.loc == "remote":
                node = self.nodes.get(meta.node_id)
                if node is not None and node.data_addr:
                    # batched per holder on one background worker: a bulk
                    # release of N remote objects must not fork N threads
                    # each paying a TCP connect (mirrors the debounced
                    # snapshot writer's shape)
                    with self._peer_delete_lock:
                        self._peer_delete_q[node.data_addr].append(oid)
                    self._peer_delete_event.set()
            del self.objects[oid]

    def _peer_delete_loop(self) -> None:
        """Drain queued remote-spool deletions, one connection per holder
        per drain (reference: ObjectManager frees remote copies without a
        per-object connection storm).  Holders drain concurrently so one
        dead/unreachable host's 3s connect timeout can't head-of-line
        block frees on healthy nodes; batches for addresses no live node
        advertises are dropped (the agent's shutdown rmtree already freed
        that spool)."""
        while not self._shutdown:
            self._peer_delete_event.wait(1.0)
            if self._shutdown:
                return
            try:
                self._peer_delete_event.clear()
                with self._peer_delete_lock:
                    if not self._peer_delete_q:
                        continue
                    batches = dict(self._peer_delete_q)
                    self._peer_delete_q.clear()
                with self.lock:
                    live = {n.data_addr for n in self.nodes.values()
                            if n.alive and n.data_addr}
                threads = [threading.Thread(
                    target=self._data_pool.delete_batch,
                    args=(addr, oids), daemon=True,
                    name="gcs-peer-delete-batch")
                           for addr, oids in batches.items() if addr in live]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(10.0)
            except Exception:  # noqa: BLE001 - the only drain thread:
                # an unexpected error (e.g. thread exhaustion) must not
                # kill it, or remote spools leak forever
                logger.exception("peer-delete drain pass failed")

    # ------------------------------------------------------------- scheduling
    def _task_resources(self, spec: dict) -> Dict[str, float]:
        req = dict(spec.get("resources") or {})
        req["CPU"] = float(spec.get("num_cpus", 1))
        if spec.get("num_gpus"):
            req["GPU"] = float(spec["num_gpus"])
        return {k: v for k, v in req.items() if v > 0}

    def _deps_status(self, spec: dict) -> str:
        """ready | waiting | error:<oid>"""
        for dep in spec.get("deps", ()):
            meta = self.objects.get(dep)
            if meta is None or meta.state == PENDING:
                return "waiting"
            if meta.state == ERROR:
                return f"error:{dep}"
        return "ready"

    def _pick_node(self, spec: dict, req: Dict[str, float]) -> Optional[NodeState]:
        strategy = spec.get("scheduling_strategy") or "DEFAULT"
        alive = [n for n in self.nodes.values() if n.schedulable()]
        if isinstance(strategy, dict) and strategy.get("type") == "node_affinity":
            node = self.nodes.get(strategy["node_id"])
            if node is not None and node.schedulable() and node.fits(req):
                return node
            if strategy.get("soft"):
                strategy = "DEFAULT"
            else:
                return None
        if isinstance(strategy, dict) and strategy.get("type") == "placement_group":
            return None  # handled by _pick_pg_node
        fitting = [n for n in alive if n.fits(req)]
        if not fitting:
            return None
        if strategy == "SPREAD":
            fitting.sort(key=lambda n: n.load())
            return fitting[0]
        # hybrid (reference hybrid_policy): pack onto low-index nodes until the
        # spread threshold, then least-loaded.
        thresh = GLOBAL_CONFIG.scheduler_spread_threshold
        for n in fitting:
            if n.load() < thresh:
                return n
        fitting.sort(key=lambda n: n.load())
        return fitting[0]

    def _pick_pg_node(self, spec: dict, req: Dict[str, float]):
        st = spec["scheduling_strategy"]
        pg = self.pgs.get(st["pg_id"])
        if pg is None or pg.state != READY:
            return None, None
        idxs = [st["bundle_index"]] if st.get("bundle_index", -1) >= 0 \
            else range(len(pg.bundles))
        for i in idxs:
            avail = pg.bundle_avail[i]
            if all(avail.get(k, 0.0) >= v - 1e-9 for k, v in req.items()):
                node = self.nodes.get(pg.assignment[i])
                if node is not None and node.alive:
                    return node, (pg, i)
        return None, None

    def _piggyback_worker(self, node: NodeState, req: Dict[str, float],
                          need_gpu: bool) -> Optional[WorkerState]:
        """A busy worker on ``node`` whose running lease matches ``req``
        and whose pipeline has room (lock held)."""
        depth = GLOBAL_CONFIG.worker_pipeline_depth
        if depth <= 0:
            return None
        for wid in node.workers:
            w = self.workers.get(wid)
            if (w is None or w.state != "busy" or w.blocked
                    or w.actor_id is not None
                    or w.gpu_capable != need_gpu
                    or len(w.pipeline) >= depth):
                continue
            cur = w.current_task
            if (cur is None or cur.get("is_actor_creation")
                    or cur.get("_pg_claim") is not None):
                continue
            if cur.get("_req") != req:
                continue
            return w
        return None

    def _idle_worker_on(self, node: NodeState,
                        need_gpu: bool = False) -> Optional[WorkerState]:
        """Pop an idle worker matching the device requirement.  GPU work
        only runs on GPU-capable workers (spawned with device access);
        CPU work never rides a GPU-capable one: the warm pool keeps those
        for the cards, and a CPU actor would hold a process that sees the
        cards for its lifetime, though it asked for none."""
        skipped = []
        found = None
        while node.idle_workers:
            wid = node.idle_workers.popleft()
            w = self.workers.get(wid)
            if w is None or w.state != "idle":
                continue
            if need_gpu != w.gpu_capable:
                skipped.append(wid)
                continue
            found = w
            break
        node.idle_workers.extendleft(reversed(skipped))
        return found

    def _spawn_worker(self, node_id: str, gpu: bool = False) -> None:
        """Fork a new worker process for a node (reference: WorkerPool pop/fork)."""
        self._spawn_counter += 1
        env = dict(os.environ)
        env.update(GLOBAL_CONFIG.to_env())
        env["RTT_SESSION_DIR"] = str(self.session.path)
        env["RTT_NODE_ID"] = node_id
        # the segment directory this process resolved, not whatever the
        # environment says now: workers and head must map the same files
        env["RTT_SHM_DIR"] = str(shm_store._SHM_DIR)
        if gpu:
            # GPU-capable worker: sees the node's cards (forked by the
            # warm pool, or by the pump for GPU work that finds fewer).
            env["RTT_GPU_WORKER"] = "1"
            env["CUDA_VISIBLE_DEVICES"] = self._node_cuda_devices(node_id)
        else:
            # Plain workers never see a card: no CUDA context in every
            # spawned process, and no quiet CPU fallback for device work.
            env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env, cwd=os.getcwd(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        w = WorkerState(WorkerID(f"spawn{self._spawn_counter:06d}"), node_id, proc.pid)
        w.proc = proc
        w.gpu_capable = gpu
        # registered properly once the process connects; keep it for monitor
        self.workers[w.worker_id] = w

    def _top_up_gpu_workers(self) -> None:
        """Lock held.  The warm GPU pool: fork GPU workers until every
        local node with cards has ``gpu_workers_per_node`` (a GPU actor's
        boot then skips the process start and the torch import, which the
        worker does before it registers).  Called from the monitor loop,
        so the pool is filled at start and refilled after each exit.  A
        node whose GPU workers die before registering (no usable torch,
        an OOM kill) backs off 1, 2, 4 ... 30 s between forks; a restored
        head waits out the reattach window, where the old ones return."""
        if self._shutdown or self._restored_at is not None:
            return
        now = time.monotonic()
        for node in list(self.nodes.values()):
            if not node.alive or node.is_remote or \
                    node.resources_total.get("GPU", 0) <= 0 or \
                    now < self._gpu_fork_after.get(node.node_id, 0.0):
                continue
            while self._count_node_workers(node, gpu=True) < \
                    GLOBAL_CONFIG.gpu_workers_per_node:
                self._spawn_worker(node.node_id, gpu=True)

    def _node_cuda_devices(self, node_id: str) -> str:
        """The node's cards as a CUDA_VISIBLE_DEVICES value (the rule
        the NodeAgent's GPU slots follow too)."""
        from ray_tpu_torch._private.gpus import cuda_visible_devices
        node = self.nodes.get(node_id)
        return cuda_visible_devices(
            node.resources_total.get("GPU", 0) if node else 0)

    def _count_node_workers(self, node: NodeState, include_starting=True,
                            gpu: Optional[bool] = None) -> int:
        """Workers counted against the spawn cap (optionally filtered by
        device capability — GPU and plain workers have separate caps, or a
        cap full of the wrong kind would starve the other forever).

        Blocked workers (parked in get(), CPU released) don't count — else
        nested task chains deadlock once the cap's worth of workers are all
        blocked waiting on children (reference: raylet spawns replacement
        workers for blocked ones).
        """
        n = 0
        for wid in list(self.workers):
            w = self.workers[wid]
            if gpu is not None and w.gpu_capable != gpu:
                continue
            if w.node_id == node.node_id and not w.blocked and w.state in (
                    ("starting",) if include_starting else ()) + ("idle", "busy"):
                n += 1
        return n

    def _pump(self, force: bool = False) -> None:
        """Try to dispatch pending work. Call with lock NOT held.
        ``force`` bypasses the capacity pre-check (periodic safety pump)."""
        with self.cv:
            self._pump_locked(force=force)

    def _raylet_backlog_room_locked(self) -> bool:
        """Lock held.  Any raylet with queued-lease headroom?"""
        depth = GLOBAL_CONFIG.raylet_lease_backlog
        if depth <= 0:
            return False
        for node in self.nodes.values():
            if node.schedulable() and node.raylet_conn is not None \
                    and node.queued_lease_count() < depth:
                return True
        return False

    # Consecutive unplaceable specs tolerated per scan before giving up
    # until the next pump.  Without a cutoff, a deep backlog makes every
    # pump O(backlog) and the scheduler O(n^2) under pipelined one-way
    # submission (reference analog: ClusterTaskManager keeps separate
    # schedule/dispatch/waiting queues instead of rescanning one list).
    _PUMP_MISS_CAP = 32

    def _park_on_deps(self, spec: dict) -> None:
        """Lock held.  Move a dep-waiting spec off the scan queue; it is
        promoted back by _promote_dep_waiters when its deps seal."""
        waits = set()
        for dep in spec.get("deps", ()):
            m = self.objects.get(dep)
            if m is None or m.state == PENDING:
                waits.add(dep)
        if not waits:
            self._push_pending(spec)   # raced: deps arrived already
            return
        spec["_waiting_deps"] = waits
        for dep in waits:
            self.dep_waiting.setdefault(dep, []).append(spec)

    def _promote_dep_waiters(self, oid: str, errored: bool = False) -> None:
        """Lock held.  A dep sealed (ok or error): wake parked specs."""
        specs = self.dep_waiting.pop(oid, None)
        if not specs:
            return
        for spec in specs:
            waits = spec.get("_waiting_deps")
            if waits is not None:
                waits.discard(oid)
            if spec.get("cancelled") or spec.get("_dep_failed"):
                continue
            if errored:
                spec["_dep_failed"] = True
                self._fail_task_with_dep_error(spec, oid)
            elif not waits:
                spec.pop("_waiting_deps", None)
                self._push_pending(spec)

    @staticmethod
    def _spec_class(spec: dict) -> str:
        """cpu | gpu | zero | special — the resource gate in
        _dispatch_capacity is exact only for the plain-CPU and GPU
        classes; zero-CPU and special (PG/affinity/custom-resource)
        specs bypass it (they dispatch on dimensions the cheap check
        doesn't model)."""
        st = spec.get("scheduling_strategy")
        if isinstance(st, dict) or spec.get("resources"):
            return "special"
        if spec.get("num_gpus"):
            return "gpu"
        if float(spec.get("num_cpus", 1)) <= 0:
            return "zero"
        return "cpu"

    def _push_pending(self, spec: dict) -> None:
        """Lock held.  All pending-queue traffic goes through these
        helpers so _dispatch_capacity can know, in O(1), what the backlog
        is waiting for (a fruitless O(backlog) scan per pipelined submit
        was the measured control-plane bottleneck).  A spec returning to
        the global queue is no longer held by any worker: strip the
        prepush mark or a later pipeline pop would skip its push and
        strand it."""
        spec.pop("_prepushed", None)
        spec.pop("_dseq", None)
        # setdefault: a pump-miss requeue continues the same wait; only a
        # spec that actually DISPATCHED (stamp popped by
        # _observe_queue_latency) restarts the clock on re-entry (retry,
        # worker-death reschedule, actor restart)
        spec.setdefault("_enqueued_at", time.monotonic())
        self._pending_counts[self._spec_class(spec)] += 1
        self.pending_tasks.append(spec)

    def _push_pending_left(self, spec: dict) -> None:
        spec.pop("_prepushed", None)
        spec.pop("_dseq", None)
        # setdefault: a scan-skip requeue (_take_matching_pending's
        # non-matches) continues the same wait.  A requeue AFTER an
        # observed dispatch that never executed (handoff push to a
        # freshly-dead worker) restarts the clock — one logical wait
        # then shows as two shorter samples, an accepted bias during
        # worker churn (the alternative, carrying un-observation state,
        # isn't worth it for a histogram).
        spec.setdefault("_enqueued_at", time.monotonic())
        self._pending_counts[self._spec_class(spec)] += 1
        self.pending_tasks.appendleft(spec)

    def _observe_queue_latency(self, spec: dict, tier: str = "gcs") -> None:
        """A spec is leaving the scheduler queue for a worker: record the
        submit->dispatch wait (rtt_task_queue_seconds).  pop: a retried
        or resubmitted spec re-enters the queue and re-measures.
        ``tier`` names which scheduler tier took the dispatch ("gcs"
        direct, or "raylet:<node>" for a lease grant) — carried on the
        sched: span so traces show who placed the task."""
        t = spec.pop("_enqueued_at", None)
        if t is None:
            return
        wait = time.monotonic() - t
        name = spec.get("name") or spec.get("class_name") or "task"
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_task_queue_seconds").observe(
                wait, tags={"name": name})
        tc = spec.get("trace_ctx")
        if tc and GLOBAL_CONFIG.timeline_enabled:
            # GCS leg of the request tree: one span for the scheduler
            # queue wait (submit -> dispatch), child of the submitter's
            # span, on the dedicated "gcs" timeline row.  Appended to
            # the event buffer directly — this runs under self.lock and
            # lock -> _events_lock is a legal DAG edge; an RPC here
            # would be blocking work under the global lock.
            from ray_tpu_torch.util import tracing as _tracing
            ev = _tracing.span_event(
                f"sched:{name}", _tracing.SpanContext.from_dict(tc),
                t0=time.time() - wait, dur=wait, cat="sched",
                pid="gcs", tid=0, task_id=spec.get("task_id"),
                tier=tier)
            if ev is not None:
                with self._events_lock:
                    self.events.append(ev)

    def _pop_pending(self) -> dict:
        spec = self.pending_tasks.popleft()
        self._pending_counts[self._spec_class(spec)] -= 1
        return spec

    def _fleet_event(self, kind: str, node_id: Optional[str] = None,
                     **detail) -> None:
        """Append one fleet lifecycle event (node_added / node_draining /
        node_removed / remesh) to the bounded feed (DESIGN.md §4j).
        Callable with or without the global lock held — lock ->
        _events_lock is a legal DAG edge and the feed has its own leaf
        lock."""
        with self._events_lock:
            self._fleet_event_seq += 1
            self._fleet_events.append({
                "seq": self._fleet_event_seq, "ts": time.time(),
                "kind": kind, "node_id": node_id, **detail})

    def _dispatch_capacity(self) -> bool:
        """Lock held.  Cheap over-approximation of "could anything dispatch
        right now?" — when False, the scan below is guaranteed fruitless
        for the cpu/gpu spec classes (no free resources, or no idle
        worker / spawn headroom / piggyback room), so the pump returns
        without touching the backlog.  zero-CPU and special specs bypass
        the resource gate.  Every event that CREATES capacity (task_done,
        worker death/idle, node add, PG ready, resource release) already
        triggers its own pump, and the monitor loop force-pumps every
        0.5s as a predicate-bug safety net."""
        pc = self._pending_counts
        # resource gate: scan misses come from node.fits() — skip the scan
        # when the backlog's resource classes have no free resources
        if not (pc["special"] or pc["zero"]):
            # > 0, not >= 1: fits() admits fractional requests (0.5-CPU
            # actors), so any sliver of free CPU makes the scan worthwhile
            cpu_ok = pc["cpu"] and any(
                n.schedulable() and n.resources_avail.get("CPU", 0) > 0
                for n in self.nodes.values())
            gpu_ok = pc["gpu"] and any(
                n.schedulable() and n.resources_avail.get("GPU", 0) > 0
                for n in self.nodes.values())
            if not (cpu_ok or gpu_ok):
                # a raylet's queued-lease backlog can still absorb
                # plain-CPU specs even with zero free resources
                if not (pc["cpu"] and self._raylet_backlog_room_locked()):
                    return False
        return self._worker_capacity(
            starting_is_capacity=False, piggyback_is_capacity=True,
            count_pending_actors=True,
            gpu_headroom=bool(pc["gpu"] or pc["special"]))

    def _worker_capacity(self, *, starting_is_capacity: bool,
                         piggyback_is_capacity: bool,
                         count_pending_actors: bool,
                         gpu_headroom: bool) -> bool:
        """Lock held.  The ONE worker/node capacity scan, parameterized by
        what counts as capacity (pump gate vs prepush gate — their rules
        differ but the tallies must not drift)."""
        depth = GLOBAL_CONFIG.worker_pipeline_depth
        counts: Dict[str, List[int]] = {}
        for node in self.nodes.values():
            if node.schedulable() and node.idle_workers:
                return True
            if node.schedulable() and node.raylet_conn is not None:
                # raylet nodes schedule by grant: free ledger resources
                # (or backlog room, when queuing counts as capacity) ARE
                # dispatch capacity — no head-side idle worker needed
                if node.resources_avail.get("CPU", 0) > 0:
                    return True
                if gpu_headroom and node.resources_avail.get("GPU", 0) > 0:
                    return True
                if piggyback_is_capacity \
                        and GLOBAL_CONFIG.raylet_lease_backlog > 0 \
                        and node.queued_lease_count() \
                        < GLOBAL_CONFIG.raylet_lease_backlog:
                    return True
        for w in self.workers.values():
            if w.blocked or w.state == "dead":
                continue
            if w.state == "starting" and starting_is_capacity:
                # a slot is about to open: booting workers count against
                # the spawn cap but ARE imminent parallel capacity
                return True
            if w.state in ("starting", "idle", "busy"):
                c = counts.setdefault(w.node_id, [0, 0])
                c[1 if w.gpu_capable else 0] += 1
            if (piggyback_is_capacity and w.state == "busy"
                    and w.actor_id is None and len(w.pipeline) < depth):
                return True  # piggyback room
        pending_actors = 0
        if count_pending_actors:
            pending_actors = sum(1 for a in self.actors.values()
                                 if a.state in (A_PENDING, A_RESTARTING))
        for node in self.nodes.values():
            if not node.alive or node.is_remote:
                continue
            c = counts.get(node.node_id, [0, 0])
            cap = GLOBAL_CONFIG.num_workers_per_node or \
                int(max(1, node.resources_total.get("CPU", 1)))
            if c[0] < cap + pending_actors:
                return True
            if gpu_headroom and c[1] < GLOBAL_CONFIG.gpu_workers_per_node:
                return True
        return False

    def _pump_locked(self, force: bool = False) -> None:
        if not force and self.pending_tasks and not self._dispatch_capacity():
            self.cv.notify_all()
            return
        # Lease grants buffered per raylet node for this whole pump and
        # flushed as ONE lease_grant frame each (bulk claims, §4i) — the
        # try/finally covers the capacity early-returns below.
        grants: Dict[str, List[dict]] = {}
        try:
            self._pump_scan_locked(force, grants)
        finally:
            self._flush_lease_grants_locked(grants)

    def _pump_scan_locked(self, force: bool,
                          grants: Dict[str, List[dict]]) -> None:
        # The miss budget is for the WHOLE pump (not per pass): a typical
        # capacity event frees room for one task — one dispatch plus a
        # bounded tail of unplaceable specs, not O(backlog) rescans.
        misses = 0
        progressed = True
        while progressed:
            progressed = False
            for _ in range(len(self.pending_tasks)):
                # prepush (_take_matching_pending) consumes from the same
                # deque mid-scan: the range() above is only an upper bound
                if misses >= self._PUMP_MISS_CAP or not self.pending_tasks:
                    break
                spec = self._pop_pending()
                if spec.get("cancelled"):
                    continue
                status = self._deps_status(spec)
                if status.startswith("error:"):
                    dep = status.split(":", 1)[1]
                    self._fail_task_with_dep_error(spec, dep)
                    progressed = True
                    continue
                if status == "waiting":
                    self._park_on_deps(spec)
                    continue
                req = self._task_resources(spec)
                st = spec.get("scheduling_strategy")
                pg_claim = None
                if isinstance(st, dict) and st.get("type") == "placement_group":
                    node, pg_claim = self._pick_pg_node(spec, req)
                else:
                    node = self._pick_node(spec, req)
                if node is None:
                    if self._grant_backlog_locked(spec, req, grants):
                        # queued lease on a raylet whose running chain it
                        # can inherit — leaves the head's queue NOW
                        progressed = True
                        misses = 0
                        continue
                    self._push_pending(spec)
                    misses += 1
                    continue
                if node.raylet_conn is not None:
                    # raylet node (§4i): debit the ledger and GRANT; the
                    # raylet owns intra-node worker assignment.  Buffered
                    # — one lease_grant frame per node per pump.
                    if pg_claim is not None:
                        pg, i = pg_claim
                        for k, v in req.items():
                            pg.bundle_avail[i][k] = \
                                pg.bundle_avail[i].get(k, 0.0) - v
                        spec["_pg_claim"] = (pg.pg_id, i)
                    else:
                        node.acquire(req)
                    spec["_req"] = req
                    spec["_node"] = node.node_id
                    spec["_started_at"] = time.monotonic()
                    self._observe_queue_latency(
                        spec, tier=f"raylet:{node.node_id[:8]}")
                    node.leases_out[spec["task_id"]] = spec
                    self.running[spec["task_id"]] = (
                        f"raylet:{node.node_id[:8]}", spec)
                    grants.setdefault(node.node_id, []).append(spec)
                    progressed = True
                    misses = 0
                    continue
                need_gpu = req.get("GPU", 0) > 0
                worker = self._idle_worker_on(node, need_gpu)
                if worker is None:
                    spawned = False
                    if node.is_remote:
                        # the NodeAgent owns that host's worker pool; wait
                        # for one of its workers to go idle
                        pass
                    elif need_gpu:
                        # GPU workers have their own cap: concurrent CUDA
                        # inits would fight over the same chips, so one
                        # device-holding worker per node (its actor/tasks
                        # own all the node's declared chips)
                        if self._count_node_workers(node, gpu=True) < \
                                GLOBAL_CONFIG.gpu_workers_per_node and \
                                time.monotonic() >= self._gpu_fork_after.get(
                                    node.node_id, 0.0):
                            self._spawn_worker(node.node_id, gpu=True)
                            spawned = True
                    else:
                        # plain cap = node CPU count (min 1)
                        cap = int(max(1, node.resources_total.get("CPU", 1)))
                        cap = GLOBAL_CONFIG.num_workers_per_node or cap
                        if self._count_node_workers(node, gpu=False) < cap + len(
                                [a for a in self.actors.values()
                                 if a.state in (A_PENDING, A_RESTARTING)]):
                            self._spawn_worker(node.node_id, gpu=False)
                            spawned = True
                    # lease piggyback is the LAST resort: only once the
                    # pool is at its cap AND nothing is mid-spawn — queuing
                    # onto a busy worker while capacity exists (or is
                    # coming up) would serialize work the scheduler should
                    # parallelize (e.g. concurrent long-running trials)
                    starting = any(
                        ws.state == "starting"
                        and ws.gpu_capable == need_gpu
                        and ws.node_id == node.node_id
                        for ws in self.workers.values())
                    if not spawned and not starting and pg_claim is None \
                            and not spec.get("is_actor_creation"):
                        tgt = self._piggyback_worker(node, req, need_gpu)
                        if tgt is not None:
                            # leaving the queue for a worker's pipeline:
                            # observe now, or a later retry would inherit
                            # the stale stamp and record submit-to-
                            # SECOND-dispatch as queue wait
                            self._observe_queue_latency(spec)
                            tgt.pipeline.append(spec)
                            progressed = True
                            misses = 0
                            continue
                    self._push_pending(spec)
                    misses += 1
                    continue
                # dispatch
                if pg_claim is not None:
                    pg, i = pg_claim
                    for k, v in req.items():
                        pg.bundle_avail[i][k] = pg.bundle_avail[i].get(k, 0.0) - v
                    spec["_pg_claim"] = (pg.pg_id, i)
                else:
                    node.acquire(req)
                spec["_req"] = req
                spec["_node"] = node.node_id
                spec["_started_at"] = time.monotonic()
                self._observe_queue_latency(spec)
                worker.state = "busy"
                worker.current_task = spec
                self.running[spec["task_id"]] = (worker.worker_id, spec)
                kind = ("create_actor" if spec.get("is_actor_creation")
                        else "execute_task")
                # prepush: same-shape dep-ready backlog rides THIS dispatch
                # message and inherits the lease task-by-task — no push,
                # no pump, no scan per follow-on task (reference: leased
                # workers stay saturated without re-entering the scheduler)
                queued: List[dict] = []
                if kind == "execute_task" and not worker.pipeline \
                        and self._spec_class(spec) == "cpu" \
                        and self._pending_counts["cpu"] \
                        and not self._parallel_capacity():
                    depth = GLOBAL_CONFIG.worker_pipeline_depth
                    worker.dseq += 1
                    while len(queued) < depth:
                        extra = self._take_matching_pending(req)
                        if extra is None:
                            break
                        extra["_prepushed"] = True
                        extra["_dseq"] = worker.dseq
                        queued.append(extra)
                    worker.pipeline.extend(queued)
                from ray_tpu_torch._private import flight_recorder
                if flight_recorder.enabled():
                    flight_recorder.record(
                        "dispatch",
                        f"{spec['task_id'][:16]}->{worker.worker_id[:8]} "
                        f"{kind} queued={len(queued)}")
                if not worker.push({"kind": kind, "spec": spec,
                                    "dseq": worker.dseq,
                                    "queued": queued}):
                    # push failed: worker died between idle and now
                    self._handle_worker_death(worker)
                    self._push_pending(spec)
                    continue
                progressed = True
                misses = 0
                # this dispatch may have consumed the last capacity: stop
                # scanning instead of burning the miss budget on a backlog
                # that can no longer place anything
                if not force and self.pending_tasks and \
                        not self._dispatch_capacity():
                    self.cv.notify_all()
                    return
            self.cv.notify_all()

    def _grant_backlog_locked(self, spec: dict, req: Dict[str, float],
                              grants: Dict[str, List[dict]]) -> bool:
        """Lock held.  No node fits the spec right now: queue it as an
        unfunded lease (``_lease_q``) on the raylet with the shallowest
        local queue, bounded by ``raylet_lease_backlog`` per node — the
        node-scoped generalization of worker_pipeline_depth.  The
        raylet starts queued leases on idle workers (pool-bounded local
        CPU oversubscription of the ledger) or by inheriting a
        finishing same-shape task's claim; the fund/return frames
        reconcile the accounting either way.  Only prepush-safe
        plain-CPU specs ride this (same constraints as
        _take_matching_pending)."""
        depth = GLOBAL_CONFIG.raylet_lease_backlog
        if depth <= 0:
            return False
        if (self._spec_class(spec) != "cpu"
                or spec.get("is_actor_creation")
                or (spec.get("scheduling_strategy") or "DEFAULT") != "DEFAULT"
                or spec.get("runtime_env")):
            return False
        best = None
        best_q = depth
        for node in self.nodes.values():
            if not node.schedulable() or node.raylet_conn is None:
                continue
            queued = node.queued_lease_count()
            if queued < best_q:
                best, best_q = node, queued
        if best is None:
            return False
        node = best
        spec["_lease_q"] = True
        # shape marker ONLY (the raylet matches handoffs / the head
        # funds on it); never _req — a queued lease holds no funded
        # claim, and _release_task_resources must no-op on it
        spec["_lease_shape"] = dict(req)
        self._observe_queue_latency(
            spec, tier=f"raylet:{node.node_id[:8]}")
        node.leases_out[spec["task_id"]] = spec
        self.running[spec["task_id"]] = (
            f"raylet:{node.node_id[:8]}", spec)
        grants.setdefault(node.node_id, []).append(spec)
        return True

    def _flush_lease_grants_locked(self,
                                   grants: Dict[str, List[dict]]) -> None:
        """Lock held.  Ship this pump's grant buffers, one frame per
        raylet (push rides lock → raylet_conn_lock, a legal DAG edge
        like worker task pushes).  A push failure means the channel died
        between pick and flush: undo the ledger and requeue."""
        if not grants:
            return
        from ray_tpu_torch._private import flight_recorder
        for node_id, specs in grants.items():
            node = self.nodes.get(node_id)
            ok = node is not None and node.push_raylet(
                {"kind": "lease_grant", "rid": None,
                 "epoch": node.raylet_epoch, "specs": specs})
            if flight_recorder.enabled():
                flight_recorder.record(
                    "lease_grant",
                    f"{node_id[:8]} n={len(specs)} ok={ok}")
            if ok:
                if GLOBAL_CONFIG.metrics_enabled:
                    mcat.get("rtt_raylet_leases_total").inc(
                        len(specs), tags={"event": "granted"})
                continue
            for spec in specs:
                if node is not None:
                    node.leases_out.pop(spec["task_id"], None)
                self.running.pop(spec["task_id"], None)
                self._release_task_resources(spec)
                spec.pop("_lease_q", None)
                spec.pop("_lease_shape", None)
                self._push_pending_left(spec)
        grants.clear()

    def _release_task_resources(self, spec: dict) -> None:
        req = spec.pop("_req", None)
        node_id = spec.pop("_node", None)
        pg_claim = spec.pop("_pg_claim", None)
        if spec.pop("_cpu_released", None) and req:
            req = dict(req)
            req.pop("CPU", None)  # already released at task_blocked time
        if pg_claim is not None:
            pg, i = self.pgs.get(pg_claim[0]), pg_claim[1]
            if pg is not None:
                for k, v in (req or {}).items():
                    pg.bundle_avail[i][k] = pg.bundle_avail[i].get(k, 0.0) + v
        elif req and node_id in self.nodes:
            self.nodes[node_id].release_res(req)

    def _release_deps(self, spec: dict) -> None:
        """Drop the scheduler's hold on arg objects once the task is terminal."""
        if spec.get("_deps_released"):
            return
        spec["_deps_released"] = True
        for dep in list(spec.get("deps", ())) + list(spec.get("borrows", ())):
            self._decref(dep)

    @staticmethod
    def _count_task_terminal(state: str) -> None:
        """rtt_tasks_total: counted HERE (the one authority on terminal
        task states) so worker- and owner-side views can never double
        count."""
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_tasks_total").inc(tags={"state": state})

    def _fail_task_with_dep_error(self, spec: dict, dep_oid: str) -> None:
        dep_meta = self.objects[dep_oid]
        self._count_task_terminal("dep_error")
        for oid in spec["return_ids"]:
            self._seal_error(oid, dep_meta.data)
        if spec.get("is_actor_creation"):
            # surface the dep error as the actor's creation error
            a = self.actors.get(spec["actor_id"])
            if a is not None and a.state != A_DEAD:
                a.state = A_DEAD
                a.death_reason = "actor constructor dependency failed"
                a.spec["_creation_error"] = dep_meta.data
                if a.name:
                    self.named_actors.pop((a.namespace, a.name), None)
                    self._repl_record("named", a.namespace, a.name, None)
                self._repl_actor_locked(a)
        else:
            self._release_deps(spec)

    def _fail_task(self, spec: dict, err: BaseException) -> None:
        from ray_tpu_torch._private.serialization import serialize_to_bytes
        # user-initiated cancellation is not a system failure — it must
        # not move an operator's sys_error alert rate
        self._count_task_terminal(
            "cancelled" if isinstance(err, exc.TaskCancelledError)
            else "sys_error")
        data = serialize_to_bytes(err)[0]
        for oid in spec["return_ids"]:
            self._seal_error(oid, data)
        self._release_deps(spec)

    # ------------------------------------------------------------- worker mgmt
    def _handle_worker_death(self, w: WorkerState) -> None:
        """Lock held. Failure handling per SURVEY.md §5.3."""
        if w.state == "dead":
            return
        logger.info("worker death %s pid=%s node=%s state=%s actor=%s task=%s",
                    w.worker_id, w.pid, (w.node_id or "")[:8], w.state,
                    w.actor_id, (w.current_task or {}).get("task_id"))
        if w.state == "starting" and w.proc is not None:
            # forked here and never registered: nothing refers to it, so
            # it leaves the table (a worker that cannot boot must not
            # grow it forever)
            self.workers.pop(w.worker_id, None)
            if w.gpu_capable:
                n = self._gpu_boot_failures.get(w.node_id, 0) + 1
                self._gpu_boot_failures[w.node_id] = n
                delay = min(2.0 ** (n - 1), 30.0)
                self._gpu_fork_after[w.node_id] = time.monotonic() + delay
                logger.warning(
                    "GPU worker pid=%s died before registering (%d in a "
                    "row on node %s); next fork in %.0f s", w.pid, n,
                    (w.node_id or "")[:8], delay)
        w.state = "dead"
        self.dead_clients.add(w.worker_id)
        if self.slab is not None and not self._shutdown:
            self.slab.reap_dead()  # free half-written slab objects it left
        node = self.nodes.get(w.node_id)
        if node is not None:
            node.workers.discard(w.worker_id)
        # release refs held by this client; close its ledger so a late
        # coalesced add_ref can't resurrect it as a forever-pinned orphan
        self._close_ledger_locked(w.worker_id)
        for oid, n in self.client_refs.pop(w.worker_id, {}).items():
            self._decref(oid, n)
        spec = w.current_task
        w.current_task = None
        # queued (never-started) pipeline tasks just reschedule — no retry
        # budget consumed
        while w.pipeline:
            qspec = w.pipeline.popleft()
            if not qspec.get("cancelled"):
                self._push_pending_left(qspec)
        if w.actor_id is not None:
            self._actor_worker_died(w.actor_id)
        elif spec is not None and spec.get("is_actor_creation"):
            # died mid-__init__, before actor_ready assigned w.actor_id:
            # route through the actor FSM so max_restarts is honored
            self._release_task_resources(spec)
            self.running.pop(spec["task_id"], None)
            a = self.actors.get(spec["actor_id"])
            if a is not None:
                a.death_reason = "worker died during actor creation"
                self._actor_worker_died(a.actor_id)
            spec = None
        if spec is not None:
            self._release_task_resources(spec)
            self.running.pop(spec["task_id"], None)
            retries = spec.get("max_retries", GLOBAL_CONFIG.task_default_max_retries)
            attempts = spec.get("attempt", 0)
            oom = spec.pop("_oom_killed", False)
            if not spec.get("is_actor_creation") and (retries < 0 or attempts < retries):
                spec = dict(spec)
                spec["attempt"] = attempts + 1
                logger.info("retrying task %s (attempt %d)%s",
                            spec["task_id"], spec["attempt"],
                            " after OOM kill" if oom else "")
                self._push_pending(spec)
            elif not spec.get("is_actor_creation"):
                if oom:
                    self._fail_task(spec, exc.OutOfMemoryError(
                        f"task {spec.get('name', spec['task_id'])} killed "
                        f"by the memory monitor: node memory usage "
                        f"exceeded the configured threshold "
                        f"(RTT_MEMORY_USAGE_THRESHOLD)"))
                else:
                    self._fail_task(spec, exc.WorkerCrashedError(
                        f"worker {w.worker_id} (pid {w.pid}) died running "
                        f"{spec.get('name', spec['task_id'])}"))
        self.cv.notify_all()

    def _actor_worker_died(self, actor_id: str) -> None:
        a = self.actors.get(actor_id)
        if a is None or a.state == A_DEAD:
            return
        # actor-creation resources are held for the actor's lifetime;
        # give them back now that the process is gone
        self._release_task_resources(a.spec)
        if a.restarts_left != 0 and not a.spec.get("_killed"):
            a.restarts_left = max(-1, a.restarts_left - 1) if a.restarts_left > 0 else -1
            a.state = A_RESTARTING
            a.incarnation += 1
            a.addr = None
            a.worker_id = None
            respec = {k: v for k, v in a.spec.items() if not k.startswith("_")}
            respec["attempt"] = respec.get("attempt", 0) + 1
            a.spec = respec
            self._push_pending(respec)
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_actor_restarts_total").inc(
                    tags={"class": respec.get("class_name", "Actor")})
            logger.info("restarting actor %s (incarnation %d)", actor_id, a.incarnation)
        else:
            a.state = A_DEAD
            a.death_reason = a.death_reason or "worker died"
            if a.name:
                self.named_actors.pop((a.namespace, a.name), None)
                self._repl_record("named", a.namespace, a.name, None)
        self._repl_actor_locked(a)
        # restarts_left / liveness changed: keep the snapshot current so a
        # head restart doesn't resurrect a dead actor or reset its budget
        # (just sets the writer thread's event; safe under cv)
        self._persist_durable()

    def _sweep_dead_metrics(self) -> None:
        """Bound the ``__metrics__/`` KV plane without needing a reader:
        collect_cluster() reaps on scrape, but an unscraped cluster
        churning workers must not accumulate one snapshot per dead
        process forever.  Dead publishers' snapshots survive the same
        grace window the collector honors (their shutdown flush stays
        readable), then go.  Ages by HEAD-side receipt time
        (_metrics_key_seen), not the payload's publisher-host wall clock
        — cross-host skew larger than the grace must not reap a dying
        worker's final flush instantly."""
        from ray_tpu_torch.util.metrics import DEAD_SNAPSHOT_GRACE_S
        with self.lock:
            live = {w.worker_id for w in self.workers.values()
                    if w.state != "dead"}
        with self._kv_lock:
            ns = self.kv.get("default")
            if not ns:
                return
            now = time.monotonic()
            # iterate the receipt index, not the namespace: the sweep
            # must cost O(#publishers), not an O(|kv|) scan under the
            # global lock every minute (every metrics key passes through
            # _h_kv_put, and restores strip the prefix, so the index is
            # complete)
            for key, seen in list(self._metrics_key_seen.items()):
                if key.split("/", 1)[1] in live:
                    continue
                if now - seen > DEAD_SNAPSHOT_GRACE_S:
                    ns.pop(key, None)
                    self._metrics_key_seen.pop(key, None)
            # __profile__/ receipts get the same KV hygiene; the
            # ProfileStore's windowed HISTORY for the dead process
            # stays queryable (bounded by its own rings) — only the
            # raw KV payload is reaped
            for key, seen in list(self._profile_key_seen.items()):
                if key.split("/", 1)[1] in live:
                    continue
                if now - seen > DEAD_SNAPSHOT_GRACE_S:
                    ns.pop(key, None)
                    self._profile_key_seen.pop(key, None)

    def _monitor_loop(self) -> None:
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor
        mem_monitor = MemoryMonitor(self)
        last_pump = 0.0
        while not self._shutdown:
            time.sleep(0.1)
            self._restore_grace_check()
            mem_monitor.maybe_kill(time.monotonic())
            # free rc-0-at-seal objects whose grace expired with no
            # add_refs having landed (see _seal_object)
            if self._graceful_free:
                now = time.monotonic()
                with self.cv:
                    for oid in [o for o, t in self._graceful_free.items()
                                if now - t > 10.0]:
                        self._graceful_free.pop(oid, None)
                        meta = self.objects.get(oid)
                        if meta is not None and meta.refcount <= 0 \
                                and meta.state != PENDING:
                            self._decref(oid, 0)
            # unconditional periodic pump: the _PUMP_MISS_CAP scan cutoff
            # plus queue rotation means a placeable spec deep behind
            # unplaceable ones is only reached across several pumps — and
            # with nothing running there may be no event to trigger one
            now = time.monotonic()
            if now - last_pump > 0.5 and self.pending_tasks:
                last_pump = now
                self._pump(force=True)  # liveness even if the capacity
                # predicate is ever wrong for an exotic spec shape
            dead: List[WorkerState] = []
            with self.lock:
                for w in self.workers.values():
                    if w.proc is not None and w.state != "dead" and w.proc.poll() is not None:
                        dead.append(w)
            if dead:
                with self.cv:
                    for w in dead:
                        logger.warning("worker %s pid=%s exited", w.worker_id, w.pid)
                        self._handle_worker_death(w)
                self._pump()
            with self.lock:
                self._top_up_gpu_workers()
            # reap dead publishers' stale metrics snapshots server-side:
            # collect_cluster() reaps on read, but a cluster nobody
            # scrapes must not accumulate one KV snapshot per dead
            # process forever (they are excluded from durable
            # persistence, so nothing else bounds them)
            now = time.monotonic()
            if now - self._last_metrics_sweep > 60.0:
                self._last_metrics_sweep = now
                try:
                    self._sweep_dead_metrics()
                except Exception:  # noqa: BLE001 - telemetry hygiene only
                    logger.exception("metrics snapshot sweep failed")
            # the head's OWN profiler delta skips the KV hop: drain the
            # local sampler straight into the store on the same cadence
            # workers publish at (§4o)
            if self._profile_store is not None and \
                    now - self._last_profile_flush > \
                    max(1.0, GLOBAL_CONFIG.metrics_export_period_s):
                self._last_profile_flush = now
                try:
                    from ray_tpu_torch.util import profiler as profiler_mod
                    payload = profiler_mod.local_payload(
                        node_id=self.head_node_id)
                    if payload is not None:
                        self._profile_store.ingest("__head__", payload)
                except Exception:  # noqa: BLE001 - telemetry best-effort
                    logger.exception("head profile flush failed")
            # anomaly detectors over the TSDB (§4k): straggler skew +
            # SLO burn rate, results into the fleet-event feed
            if self._detectors and now - self._last_detector_check > \
                    GLOBAL_CONFIG.tsdb_detector_interval_s:
                self._last_detector_check = now
                try:
                    self._run_detectors()
                except Exception:  # noqa: BLE001 - telemetry best-effort
                    logger.exception("anomaly detectors failed")
            # fleet autopilot reflex pass (§4n): feed the fleet events
            # since the last pass through the reflex engine, then tick
            # its periodic work (undrain, forecast, standby).  No GCS
            # lock is held here; the actuator takes what it documents.
            if self._autopilot is not None and \
                    now - self._last_autopilot > \
                    GLOBAL_CONFIG.autopilot_interval_s:
                self._last_autopilot = now
                try:
                    self._tick_autopilot()
                except Exception:  # noqa: BLE001 - reflexes must not
                    logger.exception("autopilot tick failed")  # kill GCS
            # purge chunked uploads abandoned by a dead uploader
            with self.lock:
                now = time.time()
                for oid in [o for o, st in self._staging.items()
                            if now - st["ts"] > 300]:
                    st = self._staging.pop(oid)
                    try:
                        os.close(st["fd"])
                    except OSError:
                        pass
                    from ray_tpu_torch._private.shm_store import _seg_path
                    try:
                        os.unlink(str(_seg_path(oid)))
                    except OSError:
                        pass

    # -------------------------------------------------------------- rpc server
    def _accept_loop(self) -> None:
        protocol.serve_accept_loop(self._listener,
                                   lambda: self._shutdown,
                                   self._serve_conn, "gcs-serve-conn")

    def _serve_conn(self, conn) -> None:
        from ray_tpu_torch._private import flight_recorder, wire
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.util import tracing as _tracing
        client_id: Optional[str] = None
        ver = 0  # negotiated wire version for THIS connection
        # Codec mirroring: a peer that sends rtmsg frames may not speak
        # pickle at all (the C client, any polyglot worker) — its replies
        # must come back rtmsg even for hot kinds.  Pickle-speaking peers
        # keep the C-speed pickle reply on hot kinds.
        peer_rtmsg = False
        # Per-connection refcount coalescing queue: consecutive
        # refcount-plane oneways (add_ref/add_refs/release/release_batch/
        # release_all) buffer here and apply as ONE batch under ONE
        # global-lock acquisition the moment the connection goes quiet or
        # a non-refcount frame arrives (stream order preserved) — instead
        # of one lock acquisition per oneway.
        ref_buf: List[Tuple[str, dict]] = []
        # a remote node added over this conn, until the conn becomes its
        # liveness channel: an agent that dies between add_node and its
        # attach (a SIGTERM at startup) leaves no other trace of its end
        joined: Optional[str] = None
        try:
            while not self._shutdown:
                try:
                    if ref_buf and not conn.poll(0.0):
                        # connection went quiet mid-burst: apply now (a
                        # lone release must not wait for a next frame)
                        self._drain_ref_ops(ref_buf)
                    # rtlint: blocks-ok(parks between a client's rpcs;
                    # client death EOFs the channel and the finally arm
                    # drains buffered ref ops — peer liveness is the
                    # deadline, per-conn thread so nothing else stalls)
                    msg, seen_ver, seen_codec = wire.conn_recv_ex(conn)
                    peer_rtmsg = seen_codec == wire._CODEC_RTMSG
                except (EOFError, OSError):
                    break
                except wire.WireError as e:
                    logger.warning("undecodable frame: %s", e)
                    break
                kind = msg.get("kind")
                rid = msg.get("rid")
                if flight_recorder.enabled():
                    flight_recorder.record(
                        "frame", f"{kind} rid={rid} "
                                 f"client={str(client_id)[:8]}")
                # wire-propagated span context: pop the optional trace
                # field BEFORE any dispatch path (handlers never see an
                # alien key); adopted only around the dispatch below so
                # it cannot leak onto this thread's next frame.  The
                # field only arrives on >= PROTO_TRACE conns.
                _ctx = _tracing.extract_wire_trace(msg)
                if rid is None and kind in wire.REF_KINDS and \
                        (ver > 0 or GLOBAL_CONFIG.proto_min_version == 0):
                    # (legacy peers on a version-fenced server fall
                    # through so the fence below still rejects them)
                    ref_buf.append((kind, msg))
                    if len(ref_buf) < 256:
                        continue  # poll-gated drain at loop top
                    self._drain_ref_ops(ref_buf)
                    continue
                if ref_buf:
                    # a non-refcount frame follows buffered refcount ops:
                    # apply them first (per-connection FIFO)
                    self._drain_ref_ops(ref_buf)
                if kind == "__proto_hello__":
                    # version negotiation (wire.py): reply at the agreed
                    # version; every later frame on this conn rides it
                    try:
                        ver = wire.negotiate_version(
                            msg.get("versions", [0]),
                            GLOBAL_CONFIG.proto_min_version)
                        reply = {"rid": rid, "error": None, "proto": ver}
                    except wire.ProtocolVersionError as e:
                        reply = {"rid": rid, "error": dumps_call(
                            ConnectionError(str(e)))}
                    try:
                        wire.conn_send(conn, reply, ver)
                    except (OSError, ValueError):
                        break
                    continue
                if kind == "attach_task_conn":
                    self._attach_task_conn(msg["worker_id"], conn,
                                           msg.get("reattach"))
                    return  # this thread becomes the push-channel reader
                if kind == "attach_worker_ctl":
                    self._attach_worker_ctl(msg["worker_id"], conn)
                    return  # thread parks until the worker disconnects
                if kind == "agent_attach":
                    joined = None  # the attach owns the node's liveness
                    self._attach_agent_conn(msg["node_id"], conn)
                    return  # thread parks until the agent disconnects
                if kind == "raylet_attach":
                    # lease channel (DESIGN.md §4i): version-fenced — a
                    # conn that never negotiated >= PROTO_RAYLET cannot
                    # carry lease frames (old peers never see them)
                    if ver < wire.PROTO_RAYLET:
                        break
                    joined = None
                    self._attach_raylet_conn(msg["node_id"], conn, ver)
                    return  # thread becomes the lease-channel reader
                if kind == "repl_attach":
                    # warm-standby replication stream (DESIGN.md §4l):
                    # version-fenced like the lease channel; the hub's
                    # drain thread owns the conn from here (snapshot
                    # bootstrap + WAL streaming + heartbeats)
                    if ver < wire.PROTO_REPL or self._repl_hub is None:
                        break
                    self._repl_hub.adopt_standby(conn)
                    conn = None  # ownership transferred to the hub's
                    return       # drain thread; finally must not close
                if self._fenced and kind not in _FENCED_OK_KINDS:
                    # a promoted standby owns the ledger (higher epoch
                    # seen): drop the conn instead of erroring the call
                    # — the client's reconnect path re-dials gcs.sock,
                    # which the new head re-bound (DESIGN.md §4l)
                    logger.warning("fenced head dropping %s conn "
                                   "(client %s)", kind,
                                   str(client_id)[:8])
                    break
                if seen_ver == 0 and ver == 0 \
                        and GLOBAL_CONFIG.proto_min_version > 0:
                    # un-negotiated legacy peer on a version-fenced server.
                    # (attach kinds above are exempt: they are one-shot
                    # messages that CONVERT the conn into a server-push
                    # channel — in-cluster senders from this same build,
                    # not the cross-version clients the fence is for)
                    err = dumps_call(ConnectionError(
                        f"wire protocol >= v"
                        f"{GLOBAL_CONFIG.proto_min_version} required "
                        f"(send __proto_hello__)"))
                    try:
                        wire.conn_send(conn, {"rid": rid, "error": err}, 0)
                    except (OSError, ValueError):
                        pass
                    break
                if client_id is None and "client_id" in msg:
                    client_id = msg["client_id"]
                dedup = msg.get("_dedup")
                key = (msg.get("client_id"), dedup) if dedup else None
                if key is not None:
                    replay = self._dedup_begin(key)
                    if replay is not None:
                        # retry of an already-applied mutation (channel
                        # broke after apply, before the reply): replay the
                        # recorded reply, don't double-apply
                        if rid is not None:
                            try:
                                wire.conn_send(conn, {"rid": rid, **replay},
                                               ver, kind in wire._HOT_KINDS
                                               and not peer_rtmsg)
                            except (OSError, ValueError):
                                break
                        continue
                reply = None
                try:
                    if _ctx is None:
                        resp = self._dispatch(kind, msg)
                    else:
                        _tok = _tracing.adopt(_ctx)
                        try:
                            resp = self._dispatch(kind, msg)
                        finally:
                            _tracing.restore(_tok)
                    reply = {"error": None, **(resp or {})}
                except Exception as e:  # noqa: BLE001 - report to caller
                    try:
                        reply = {"error": dumps_call(e)}
                    except Exception:  # noqa: BLE001 - unpicklable error
                        reply = {"error": dumps_call(
                            exc.RaySystemError(repr(e)))}
                    if rid is None:
                        logger.exception("one-way rpc %s failed", kind)
                finally:
                    if key is not None:
                        self._dedup_commit(key, reply)
                if kind == "add_node" and msg.get("remote") \
                        and reply.get("node_id"):
                    joined = reply["node_id"]
                if rid is not None:
                    try:
                        wire.conn_send(conn, {"rid": rid, **reply}, ver,
                                       kind in wire._HOT_KINDS
                                       and not peer_rtmsg)
                    except (OSError, ValueError):
                        break
        finally:
            if joined is not None and not self._shutdown:
                logger.warning("node %s closed its join conn before "
                               "attaching; removing node", joined)
                try:
                    self.remove_node_internal(joined)
                    self._pump()
                except Exception:  # noqa: BLE001 - teardown path
                    logger.exception("unattached node removal failed")
            # a client that flushed releases and closed must not lose them
            try:
                self._drain_ref_ops(ref_buf)
            except Exception:  # noqa: BLE001 - shutdown path
                logger.exception("final ref-op drain failed")
            try:
                if conn is not None:  # None: handed off to the repl hub
                    conn.close()
            except OSError:
                pass

    def _dedup_begin(self, key) -> Optional[dict]:
        """Returns the recorded reply for a retried mutation, or None when
        this thread should apply it.  The pending marker makes lookup
        atomic with apply: a retry arriving while the original dispatch is
        still blocked (e.g. on gcs.lock) must WAIT for its outcome, not
        miss the cache and double-apply."""
        while True:
            with self._dedup_lock:
                cached = self._dedup_cache.get(key)
                if cached is not None:
                    return cached
                ev = self._dedup_pending.get(key)
                if ev is None:
                    self._dedup_pending[key] = threading.Event()
                    return None
            from ray_tpu_torch._private import lock_watchdog
            with lock_watchdog.bounded_block("gcs.dedup_wait"):
                won = ev.wait(30.0)
            if not won:
                # original thread wedged: degrade to at-least-once rather
                # than hanging the retry forever
                return None

    def _dedup_commit(self, key, reply: Optional[dict]) -> None:
        with self._dedup_lock:
            if reply is not None:
                self._dedup_cache[key] = reply
                while len(self._dedup_cache) > 8192:
                    self._dedup_cache.popitem(last=False)
            ev = self._dedup_pending.pop(key, None)
        if ev is not None:
            ev.set()

    def _attach_agent_conn(self, node_id: str, conn) -> None:
        """Park on the NodeAgent's control connection; its EOF means the
        agent (and its host) is gone — remove the node so pinned work
        fails over instead of queueing against a ghost forever."""
        logger.info("node agent attached for node %s", node_id[:8])
        while not self._shutdown:
            try:
                # rtlint: blocks-ok(parks for the agent's lifetime; the
                # EOF on agent/host death is the signal this loop exists
                # to catch — it triggers node removal below)
                conn.recv()
            except (EOFError, OSError):
                break
        if not self._shutdown:
            logger.warning("node agent for %s disconnected; removing node",
                           node_id[:8])
            try:
                self.remove_node_internal(node_id)
            except Exception:  # noqa: BLE001
                logger.exception("agent node removal failed")

    def _push_worker_ctl(self, w: WorkerState, msg: dict) -> bool:
        """Push an OOB control frame to a worker, routing via its node's
        raylet (``worker_ctl``) when the worker's channels attach there
        instead of here (raylet nodes own their workers' task/ctl conns)."""
        if w.push_ctl(msg):
            return True
        node = self.nodes.get(w.node_id)
        if node is not None and node.raylet_conn is not None:
            return node.push_raylet({"kind": "worker_ctl", "rid": None,
                                     "worker_id": w.worker_id,
                                     "msg": msg})
        return False

    # ------------------------------------------------- raylet lease channel
    def _attach_raylet_conn(self, node_id: str, conn, ver: int) -> None:
        """Serve one node's raylet lease channel (DESIGN.md §4i).  The
        conn is bidirectional: the pump pushes ``lease_grant`` blocks
        down it (push_raylet), and this thread reads the raylet's
        batched reports.  It is ALSO the node's one liveness path — EOF
        reclaims every outstanding lease and removes the node."""
        from ray_tpu_torch._private import flight_recorder, wire
        with self.cv:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                conn.close()
                return
            node.raylet_epoch += 1
            node.raylet_proto = ver
            with node.raylet_conn_lock:
                node.raylet_conn = conn
            node.last_heartbeat = time.monotonic()
            self.cv.notify_all()
        logger.info("raylet attached for node %s (proto v%d)",
                    node_id[:8], ver)
        self._pump()
        detached = False
        while not self._shutdown:
            try:
                # rtlint: blocks-ok(parks between raylet pushes; raylet
                # heartbeats every beat so silence longer than the
                # monitor's dead-node threshold ends in EOF/removal)
                msg, _ = wire.conn_recv(conn)
            except (EOFError, OSError, wire.WireError):
                break
            kind = msg.get("kind")
            if self._fenced:
                # a promoted standby owns the ledger: raylet reports
                # mutate actor/lease/object state, so the fence must
                # cover this channel too — drop it; the raylet's
                # upstream-EOF path re-dials gcs.sock, which the new
                # head re-bound (DESIGN.md §4l)
                logger.warning("fenced head dropping raylet channel "
                               "(node %s, frame %s)", node_id[:8], kind)
                break
            if flight_recorder.enabled():
                flight_recorder.record("raylet_frame",
                                       f"{kind} node={node_id[:8]}")
            try:
                if kind == "raylet_done_batch":
                    self._on_raylet_done_batch(node_id, msg)
                elif kind == "raylet_ref_batch":
                    self._on_raylet_ref_batch(msg)
                elif kind == "raylet_fwd":
                    self._on_raylet_fwd(node_id, msg)
                elif kind == "raylet_worker_died":
                    self._on_raylet_worker_died(msg)
                elif kind == "raylet_task_blocked":
                    self._on_raylet_blocked(node_id, msg, blocked=True)
                elif kind == "raylet_task_unblocked":
                    self._on_raylet_blocked(node_id, msg, blocked=False)
                elif kind == "raylet_heartbeat":
                    self._on_raylet_heartbeat(node_id, msg)
                elif kind == "raylet_lease_return":
                    self._on_raylet_lease_return(node_id, msg)
                elif kind == "raylet_workers":
                    self._on_raylet_workers(node_id, msg)
                elif kind == "raylet_detach":
                    detached = True
                    break
                else:
                    logger.warning("unknown raylet frame %r", kind)
            except Exception:  # noqa: BLE001 - one bad report must not
                # tear down the whole node's lease channel
                logger.exception("raylet frame failed: %s", kind)
        with self.lock:
            node = self.nodes.get(node_id)
            if node is not None:
                with node.raylet_conn_lock:
                    if node.raylet_conn is conn:
                        node.raylet_conn = None
        try:
            conn.close()
        except OSError:
            pass
        if not self._shutdown:
            log = logger.info if detached else logger.warning
            log("raylet for node %s %s; reclaiming leases and removing "
                "node", node_id[:8],
                "detached" if detached else "disconnected")
            try:
                # remove_node_internal reclaims outstanding leases first
                self.remove_node_internal(node_id)
            except Exception:  # noqa: BLE001
                logger.exception("raylet node removal failed")
            self._pump()

    def _reclaim_raylet_leases_locked(self, node: NodeState) -> None:
        """Lock held.  The node's lease channel is gone: queued leases
        (never started) re-queue free; funded leases may have been
        mid-execution, so they consume a retry attempt — the same
        contract as worker death.  Net resources return to zero."""
        leases, node.leases_out = node.leases_out, {}
        reclaimed = 0
        for tid, spec in leases.items():
            self.running.pop(tid, None)
            reclaimed += 1
            if spec.get("is_actor_creation"):
                a = self.actors.get(spec.get("actor_id"))
                if a is not None and a.state == A_ALIVE:
                    continue  # settled via actor_ready; nothing to undo
                if a is not None:
                    a.death_reason = "raylet died during actor creation"
                    # _actor_worker_died releases the creation resources
                    self._actor_worker_died(a.actor_id)
                continue
            self._release_task_resources(spec)
            if spec.get("cancelled"):
                continue
            if spec.pop("_lease_q", None):
                spec.pop("_lease_shape", None)
                self._push_pending_left(spec)  # never started: free requeue
                continue
            retries = spec.get("max_retries",
                               GLOBAL_CONFIG.task_default_max_retries)
            attempts = spec.get("attempt", 0)
            if retries < 0 or attempts < retries:
                spec2 = dict(spec)
                spec2["attempt"] = attempts + 1
                self._push_pending(spec2)
            else:
                self._fail_task(spec, exc.WorkerCrashedError(
                    f"raylet on node {node.node_id[:8]} died running "
                    f"{spec.get('name', spec['task_id'])}"))
        if reclaimed and GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_raylet_leases_total").inc(
                reclaimed, tags={"event": "reclaimed"})

    def _finish_task_ok_locked(self, spec: dict, results, w_node_id) -> None:
        """Lock held.  Seal a completed task's returns + lineage — the
        ONE ok-settlement path, shared by the direct worker channel
        (_on_task_done) and the raylet done batch."""
        for oid, res in zip(spec["return_ids"], results):
            meta = self._get_or_create_meta(oid)
            if meta.refcount <= 0 and not spec.get("is_reconstruction"):
                meta.refcount += 1  # owner's initial reference
            if res["loc"] == "shm":
                self.store.adopt(oid, res.get("size", 0))
            self._seal_object(
                oid, res["loc"], res.get("data"), res.get("size", 0),
                spec.get("_node") or w_node_id, res.get("contained", []),
                lineage_task=spec["task_id"])
        self.lineage[spec["task_id"]] = {
            k: v for k, v in spec.items() if not k.startswith("_")}
        self.lineage_order.append(spec["task_id"])
        if len(self.lineage) > self.lineage_order.maxlen:
            live = set(self.lineage_order)
            for tid in [t for t in self.lineage if t not in live]:
                self.lineage.pop(tid, None)
        self._release_deps(spec)
        self._count_task_terminal("ok")

    def _on_raylet_done_batch(self, node_id: str, msg: dict) -> None:
        """Apply one batch of lease settlements under ONE global-lock
        acquisition (the raylet-side analog of _drain_ref_ops)."""
        evs: List[dict] = []
        for entry in msg.get("entries", ()):
            if entry.get("events"):
                evs.extend(entry["events"])
        if evs:
            with self._events_lock:
                self.events.extend(evs)
        t0 = time.monotonic()
        done = handoffs = 0
        with self.cv:
            node = self.nodes.get(node_id)
            if node is None:
                return
            for entry in msg.get("entries", ()):
                self._apply_raylet_done_locked(node, entry)
                done += 1
                if entry.get("next_task_id"):
                    handoffs += 1
            self.cv.notify_all()
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_gcs_hot_handler_seconds").observe(
                time.monotonic() - t0, tags={"kind": "raylet_done_batch"})
            mcat.get("rtt_raylet_leases_total").inc(
                done, tags={"event": "done"})
            if handoffs:
                mcat.get("rtt_raylet_leases_total").inc(
                    handoffs, tags={"event": "handoff"})
        if self.pending_tasks:
            self._pump()

    def _apply_raylet_done_locked(self, node: NodeState,
                                  entry: dict) -> None:
        tid = entry["task_id"]
        status = entry.get("status")
        spec = node.leases_out.pop(tid, None)
        if spec is None:
            # unknown lease: this head restarted between grant and done
            # (or a reclaim raced the report).  The return ids in the
            # entry are authoritative — adopt the results so the value
            # is not lost; a resubmitted copy double-sealing the same
            # ids is tolerated by the seal path.
            if status == "ok":
                for oid, res in zip(entry.get("return_ids", ()),
                                    entry.get("results") or ()):
                    meta = self._get_or_create_meta(oid)
                    if meta.refcount <= 0:
                        meta.refcount += 1
                    if res["loc"] == "shm":
                        self.store.adopt(oid, res.get("size", 0))
                    self._seal_object(
                        oid, res["loc"], res.get("data"),
                        res.get("size", 0),
                        node.node_id if res["loc"] == "remote" else None,
                        res.get("contained", []))
            return
        self.running.pop(tid, None)
        # lease handoff: the raylet already started next_task_id on this
        # claim (reference: lease reuse) — MOVE it on the ledger instead
        # of release-then-reacquire
        nxt = None
        ntid = entry.get("next_task_id")
        if ntid is not None:
            nxt = node.leases_out.get(ntid)
        if nxt is not None and not nxt.get("cancelled") \
                and "_req" in spec and "_pg_claim" not in spec \
                and nxt.pop("_lease_q", None):
            # move the claim — but NEVER from a placement-group-funded
            # spec: its claim lives on the PG bundle, not the node
            # ledger, and a plain inheritor would release against the
            # wrong pool
            nxt.pop("_lease_shape", None)
            nxt["_req"] = spec.pop("_req")
            nxt["_node"] = spec.pop("_node", None)
            nxt["_started_at"] = time.monotonic()
        else:
            self._release_task_resources(spec)
        if status == "ok":
            self._finish_task_ok_locked(spec, entry.get("results") or [],
                                        node.node_id)
        elif status == "app_error":
            retries = spec.get("max_retries", 0) \
                if spec.get("retry_exceptions") else 0
            # retries < 0 = infinite (same contract as system retries)
            if retries and (retries < 0
                            or spec.get("attempt", 0) < retries):
                spec2 = dict(spec)
                spec2["attempt"] = spec.get("attempt", 0) + 1
                self._push_pending(spec2)
            else:
                for oid in spec["return_ids"]:
                    self._seal_error(oid, entry["error"])
                self._release_deps(spec)
                self._count_task_terminal("app_error")
        elif status == "worker_died":
            retries = spec.get("max_retries",
                               GLOBAL_CONFIG.task_default_max_retries)
            attempts = spec.get("attempt", 0)
            if spec.get("cancelled"):
                pass  # cancel raced the death: already settled
            elif retries < 0 or attempts < retries:
                spec2 = dict(spec)
                spec2["attempt"] = attempts + 1
                self._push_pending(spec2)
            else:
                self._fail_task(spec, exc.WorkerCrashedError(
                    f"worker on node {node.node_id[:8]} died running "
                    f"{spec.get('name', spec['task_id'])}"))

    def _on_raylet_ref_batch(self, msg: dict) -> None:
        """Apply a raylet's netted owner-local release deltas through
        the same single-acquisition batch path as connection-coalesced
        ref oneways (_drain_ref_ops → _apply_ref_op_locked)."""
        ops = [(str(k), dict(m)) for k, m in msg.get("ops", ())]
        n = int(msg.get("netted") or len(ops))
        self._drain_ref_ops(ops)
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_raylet_ref_ops_total").inc(
                n, tags={"path": "reconciled"})

    def _on_raylet_fwd(self, node_id: str, msg: dict) -> None:
        inner = msg.get("msg") or {}
        self._handle_worker_event(msg.get("worker_id"), inner)
        if inner.get("kind") == "actor_ready" and not inner.get("reattach"):
            # settle the creation lease on the SAME thread as the actor
            # linkage: a raylet death in between must never reclaim (and
            # re-run) a creation whose actor is already ALIVE/DEAD
            with self.cv:
                node = self.nodes.get(node_id)
                a = self.actors.get(inner.get("actor_id"))
                if node is not None and a is not None:
                    tid = a.spec.get("task_id")
                    node.leases_out.pop(tid, None)

    def _on_raylet_worker_died(self, msg: dict) -> None:
        with self.cv:
            w = self.workers.get(msg.get("worker_id"))
            if w is not None:
                self._handle_worker_death(w)
        self._pump()

    def _on_raylet_blocked(self, node_id: str, msg: dict,
                           blocked: bool) -> None:
        """A leased task parked in (or returned from) get() on a raylet
        node: credit/debit the CPU exactly like the direct-worker
        task_blocked path, keyed by the lease ledger instead of
        WorkerState.current_task."""
        with self.cv:
            node = self.nodes.get(node_id)
            if node is None:
                return
            spec = node.leases_out.get(msg.get("task_id"))
            if spec is None:
                return
            cpu = (spec.get("_req") or {}).get("CPU", 0)
            if not cpu:
                return
            pg_claim = spec.get("_pg_claim")
            if blocked and not spec.get("_cpu_released"):
                spec["_cpu_released"] = True
                if pg_claim is not None:
                    pg = self.pgs.get(pg_claim[0])
                    if pg is not None:
                        avail = pg.bundle_avail[pg_claim[1]]
                        avail["CPU"] = avail.get("CPU", 0.0) + cpu
                else:
                    node.release_res({"CPU": cpu})
                self.cv.notify_all()
            elif not blocked and spec.pop("_cpu_released", None):
                if pg_claim is not None:
                    pg = self.pgs.get(pg_claim[0])
                    if pg is not None:
                        avail = pg.bundle_avail[pg_claim[1]]
                        avail["CPU"] = avail.get("CPU", 0.0) - cpu
                else:
                    node.acquire({"CPU": cpu})
        if blocked:
            self._pump()

    def _on_raylet_heartbeat(self, node_id: str, msg: dict) -> None:
        stats = dict(msg.get("stats") or {})
        age = float(msg.get("reconcile_age") or 0.0)
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None:
                return
            node.last_heartbeat = time.monotonic()
            node.raylet_stats = stats
            node.raylet_reconcile_age = age
        if GLOBAL_CONFIG.metrics_enabled:
            sid = node_id[:8]
            mcat.get("rtt_raylet_queue_depth").set(
                float(stats.get("queued", 0)), tags={"node": sid})
            mcat.get("rtt_raylet_reconcile_age_seconds").set(
                age, tags={"node": sid})

    def _on_raylet_lease_return(self, node_id: str, msg: dict) -> None:
        """A raylet handing back leases it never started (idle shedding
        / clean shutdown): requeue them with no retry consumed."""
        returned = 0
        with self.cv:
            node = self.nodes.get(node_id)
            if node is None:
                return
            for tid in msg.get("task_ids", ()):
                spec = node.leases_out.pop(tid, None)
                if spec is None:
                    continue
                self.running.pop(tid, None)
                self._release_task_resources(spec)
                spec.pop("_lease_q", None)
                spec.pop("_lease_shape", None)
                if not spec.get("cancelled"):
                    self._push_pending_left(spec)
                    returned += 1
            self.cv.notify_all()
        if returned and GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_raylet_leases_total").inc(
                returned, tags={"event": "returned"})
        self._pump()

    def _on_raylet_workers(self, node_id: str, msg: dict) -> None:
        """Post-head-restart roster re-announce: adopt the raylet's
        surviving workers onto its NEW node id (their own register_client
        reconnects may have parked them on the head node)."""
        with self.cv:
            node = self.nodes.get(node_id)
            if node is None:
                return
            for went in msg.get("workers", ()):
                wid = went.get("worker_id")
                if not wid:
                    continue
                w = self.workers.get(wid)
                if w is None:
                    w = WorkerState(wid, node_id, went.get("pid", 0))
                    self.workers[wid] = w
                    w.gpu_capable = bool(went.get("gpu"))
                else:
                    old = self.nodes.get(w.node_id)
                    if old is not None and old is not node:
                        old.workers.discard(wid)
                    w.node_id = node_id
                node.workers.add(wid)
            self.cv.notify_all()

    def _attach_worker_ctl(self, worker_id: str, conn) -> None:
        """Register a worker's out-of-band control connection (cancel /
        drop_queued / dump_stack / stop_worker reach the worker even while
        its main thread executes a task).  Best-effort: EOF here is NOT a
        death signal (the task conn is the liveness channel) — just clear
        the registration so push_ctl falls back to the task conn."""
        with self.cv:
            w = self.workers.get(worker_id)
            if w is None:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            with w.ctl_conn_lock:
                w.ctl_conn = conn
        while not self._shutdown:
            try:
                conn.recv()
            except (EOFError, OSError):
                break
        with self.lock:
            w = self.workers.get(worker_id)
        if w is not None:
            with w.ctl_conn_lock:
                if w.ctl_conn is conn:
                    w.ctl_conn = None
        try:
            conn.close()
        except OSError:
            pass

    def _attach_task_conn(self, worker_id: str, conn,
                          reattach: Optional[dict] = None) -> None:
        with self.cv:
            w = self.workers.get(worker_id)
            if w is None and reattach is not None:
                # surviving worker of a crashed head reconnecting
                # (GCS fault tolerance): rebuild its WorkerState.  Its
                # recorded node is gone with the old head — adopt it onto
                # this head's node.  proc stays None: liveness is this
                # conn's EOF (same as remote-agent workers).
                node_id = reattach.get("node_id")
                if node_id not in self.nodes:
                    node_id = self.head_node_id
                w = WorkerState(worker_id, node_id, reattach.get("pid", 0))
                self.workers[worker_id] = w
                node = self.nodes.get(node_id)
                if node is not None:
                    node.workers.add(worker_id)
            if w is None:
                conn.close()
                return
            if reattach is not None:
                # The WorkerState usually ALREADY exists here: the worker's
                # _reconnect_pool() re-registered it (state "starting")
                # before this attach arrived.  Apply the reattach metadata
                # unconditionally — before the starting→idle transition
                # below — or an actor worker would be marked idle and the
                # scheduler would dispatch a plain task into a process
                # blocked in serve_forever (and gpu_capable would be lost).
                w.gpu_capable = w.gpu_capable or bool(reattach.get("gpu"))
                if reattach.get("actor_id"):
                    # actor worker: its main thread sits in serve_forever —
                    # it must never enter the idle pool.  The follow-up
                    # actor_ready(reattach) event completes the actor
                    # linkage (addr, resources, ALIVE).
                    w.state = "actor"
                    w.actor_id = reattach["actor_id"]
                    node = self.nodes.get(w.node_id)
                    if node is not None and worker_id in node.idle_workers:
                        node.idle_workers.remove(worker_id)
                logger.info("worker %s reattached after GCS restart",
                            worker_id[:8])
            w.task_conn = conn
            if w.state == "starting":
                w.state = "idle"
                node = self.nodes.get(w.node_id)
                if node is not None:
                    node.idle_workers.append(worker_id)
            self.cv.notify_all()
        self._pump()
        # reader loop for one-way worker events
        while not self._shutdown:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            try:
                self._handle_worker_event(worker_id, msg)
            except Exception:
                logger.exception("worker event failed: %s", msg.get("kind"))
        logger.debug("task conn EOF for worker %s", worker_id)
        with self.cv:
            w = self.workers.get(worker_id)
            if w is not None and w.proc is None:
                # proc-less worker (in-process driver, or remote-agent
                # worker the head never forked): conn EOF IS the death
                # signal — there is no local pid to poll
                self._handle_worker_death(w)
        self._pump()

    # ----------------------------------------------------------- worker events
    def _handle_worker_event(self, worker_id: str, msg: dict) -> None:
        kind = msg["kind"]
        if kind == "task_done":
            self._on_task_done(worker_id, msg)
        elif kind == "actor_ready":
            self._on_actor_ready(worker_id, msg)
        elif kind == "actor_result":
            # actor method results sealed by the actor's worker
            t0 = time.monotonic()
            with self.cv:
                w = self.workers.get(worker_id)
                for oid, res in zip(msg["return_ids"], msg["results"]):
                    meta = self._get_or_create_meta(oid)
                    if res["loc"] == "error":
                        self._seal_error(oid, res["data"])
                    else:
                        if res["loc"] == "shm":
                            self.store.adopt(oid, res.get("size", 0))
                        # remote-spooled results are pinned to the holder
                        # node (P2P pulls resolve its data addr; node loss
                        # routes them to reconstruction)
                        self._seal_object(
                            oid, res["loc"], res.get("data"),
                            res.get("size", 0),
                            (w.node_id if w is not None
                             and res["loc"] == "remote" else None),
                            res.get("contained", []))
                        if res["loc"] == "remote" and w is None:
                            # holder unknown (worker record already
                            # reaped): a READY remote object with no
                            # node resolves nowhere and node-loss scans
                            # never reclaim it — mark lost NOW
                            self._mark_object_lost(
                                oid, self.objects[oid])
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_gcs_hot_handler_seconds").observe(
                    time.monotonic() - t0, tags={"kind": "actor_result"})
            if self.pending_tasks:
                self._pump()  # tasks may be dep-waiting on these objects
        elif kind == "task_blocked":
            # reference: raylet releases the CPU while a task blocks in get().
            # Credit whichever pool the CPU was claimed from: the PG bundle
            # for placement-group tasks, the node otherwise.
            with self.cv:
                w = self.workers.get(worker_id)
                if w is not None and w.current_task is not None:
                    w.blocked = True
                    # a blocked worker can't drain its pipeline (and its
                    # queued tasks could even be what it blocks ON) —
                    # give them back to the scheduler; the worker must
                    # drop its prepushed copies or a respawned-elsewhere
                    # spec would also run here after the unblock
                    dropped = [(s["task_id"], s.get("_dseq"))
                               for s in w.pipeline if s.get("_prepushed")]
                    while w.pipeline:
                        self._push_pending_left(w.pipeline.pop())
                    if dropped:
                        w.push_ctl({"kind": "drop_queued", "pairs": dropped})
                    spec = w.current_task
                    cpu = (spec.get("_req") or {}).get("CPU", 0)
                    if cpu and not spec.get("_cpu_released"):
                        spec["_cpu_released"] = True
                        pg_claim = spec.get("_pg_claim")
                        if pg_claim is not None:
                            pg = self.pgs.get(pg_claim[0])
                            if pg is not None:
                                avail = pg.bundle_avail[pg_claim[1]]
                                avail["CPU"] = avail.get("CPU", 0.0) + cpu
                        else:
                            node = self.nodes.get(w.node_id)
                            if node is not None:
                                node.release_res({"CPU": cpu})
                        self.cv.notify_all()
            self._pump()
        elif kind == "task_unblocked":
            with self.cv:
                w = self.workers.get(worker_id)
                if w is not None:
                    w.blocked = False
                if w is not None and w.current_task is not None \
                        and w.current_task.pop("_cpu_released", None):
                    spec = w.current_task
                    cpu = (spec.get("_req") or {}).get("CPU", 0)
                    pg_claim = spec.get("_pg_claim")
                    if pg_claim is not None:
                        pg = self.pgs.get(pg_claim[0])
                        if pg is not None:
                            avail = pg.bundle_avail[pg_claim[1]]
                            avail["CPU"] = avail.get("CPU", 0.0) - cpu
                    else:
                        node = self.nodes.get(w.node_id)
                        if node is not None:
                            node.acquire({"CPU": cpu})
        elif kind == "actor_exit":
            with self.cv:
                a = self.actors.get(msg["actor_id"])
                if a is not None:
                    a.spec["_killed"] = True  # intentional exit → no restart
                    a.death_reason = "exit_actor"
        elif kind == "stack_dump":
            with self.cv:
                for req in self._stack_reqs:
                    req[worker_id] = msg["text"]
                self.cv.notify_all()
        elif kind == "log" and self.log_sink is not None:
            self.log_sink(msg["line"])
        elif kind == "profile_events":
            with self._events_lock:
                self.events.extend(msg["events"])

    def _parallel_capacity(self) -> bool:
        """Lock held.  Could another INDEPENDENT execution slot take work
        right now (idle worker, booting worker, or spawn headroom — NOT
        piggyback room)?  Prepush/refill must never serialize onto one
        lease work that could run concurrently elsewhere (e.g. two Tune
        trials).  Shares the scan with _dispatch_capacity."""
        return self._worker_capacity(starting_is_capacity=True,
                                     piggyback_is_capacity=False,
                                     count_pending_actors=False,
                                     gpu_headroom=False)

    def _take_matching_pending(self, req) -> Optional[dict]:
        """Lock held.  Pop the first dep-ready plain-CPU spec whose
        resource shape matches ``req`` (lease inheritance candidates);
        bounded probe so a mismatched backlog costs O(1)."""
        if req is None:
            return None
        skipped = []
        found = None
        for _ in range(min(8, len(self.pending_tasks))):
            spec = self._pop_pending()
            if spec.get("cancelled"):
                continue
            if (self._spec_class(spec) == "cpu"
                    and not spec.get("is_actor_creation")
                    and (spec.get("scheduling_strategy") or "DEFAULT")
                    == "DEFAULT"
                    and not spec.get("runtime_env")
                    and self._task_resources(spec) == req
                    and self._deps_status(spec) == "ready"):
                found = spec
                break
            skipped.append(spec)
        for spec in reversed(skipped):
            self._push_pending_left(spec)
        if found is not None:
            # lease inheritance / prepush: the spec leaves the queue here
            self._observe_queue_latency(found)
        return found

    def _on_task_done(self, worker_id: str, msg: dict) -> None:
        evs = msg.get("events")
        if evs:
            # timeline events ride the task_done frame (one message per
            # task, not two); buffered under their own lock
            with self._events_lock:
                self.events.extend(evs)
        t0 = time.monotonic()
        with self.cv:
            lock_waited = time.monotonic() - t0
            w = self.workers.get(worker_id)
            spec = w.current_task if w else None
            if spec is None or spec["task_id"] != msg["task_id"]:
                return
            self.running.pop(spec["task_id"], None)
            # lease handoff: a queued same-shape task inherits this task's
            # resource claim instead of release-then-reacquire (and skips
            # the pump scan entirely — the worker stays saturated)
            nxt = None
            while w.pipeline:
                cand = w.pipeline.popleft()
                if not cand.get("cancelled"):
                    nxt = cand
                    break
            if nxt is None and not w.blocked and w.state == "busy" \
                    and w.actor_id is None and "_req" in spec \
                    and not spec.get("is_actor_creation") \
                    and self._pending_counts["cpu"]:
                # refill from the backlog while the lease is still alive
                # (reference: lease reuse — the raylet keeps a leased
                # worker saturated without re-running the scheduler)
                nxt = self._take_matching_pending(spec["_req"])
            if nxt is not None and "_req" in spec:
                nxt["_req"] = spec.pop("_req")
                nxt["_node"] = spec.pop("_node")
            refill_queued: List[dict] = []
            if nxt is not None and not nxt.get("_prepushed") \
                    and not w.pipeline and self._pending_counts["cpu"] \
                    and not self._parallel_capacity():
                # refill the pipeline too, and ship it WITH nxt's push
                # below (prepushed) — one message re-saturates the worker
                depth = GLOBAL_CONFIG.worker_pipeline_depth
                w.dseq += 1
                while len(refill_queued) < depth:
                    extra = self._take_matching_pending(nxt["_req"])
                    if extra is None:
                        break
                    extra["_prepushed"] = True
                    extra["_dseq"] = w.dseq
                    refill_queued.append(extra)
                w.pipeline.extend(refill_queued)
            self._release_task_resources(spec)
            w.current_task = None
            w.blocked = False
            # store results
            if msg["status"] == "ok":
                self._finish_task_ok_locked(spec, msg["results"], w.node_id)
            elif msg["status"] == "app_error":
                retries = spec.get("max_retries", 0) if spec.get("retry_exceptions") \
                    else 0
                # retries < 0 = infinite (same contract as system retries)
                if retries and (retries < 0
                                or spec.get("attempt", 0) < retries):
                    spec2 = dict(spec)
                    spec2["attempt"] = spec.get("attempt", 0) + 1
                    self._push_pending(spec2)
                else:
                    for oid in spec["return_ids"]:
                        self._seal_error(oid, msg["error"])
                    self._release_deps(spec)
                    self._count_task_terminal("app_error")
            # next leased task, or worker back to pool
            if nxt is not None and w.state == "busy" \
                    and nxt.pop("_prepushed", None):
                # the worker already holds this spec (prepushed with the
                # dispatch message) and is running it right now
                w.current_task = nxt
                self.running[nxt["task_id"]] = (worker_id, nxt)
            elif nxt is not None and w.state == "busy":
                w.current_task = nxt
                self.running[nxt["task_id"]] = (worker_id, nxt)
                if not w.push({"kind": "execute_task", "spec": nxt,
                               "dseq": w.dseq,
                               "queued": refill_queued}):
                    # worker died between done and handoff: the task never
                    # STARTED — reschedule it without consuming its retry
                    # budget (same invariant as the queued pipeline)
                    self.running.pop(nxt["task_id"], None)
                    w.current_task = None
                    self._release_task_resources(nxt)
                    self._push_pending_left(nxt)
                    self._handle_worker_death(w)
            elif w.state == "busy":
                w.state = "idle"
                node = self.nodes.get(w.node_id)
                if node is not None and node.alive:
                    node.idle_workers.append(worker_id)
            self.cv.notify_all()
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_gcs_lock_wait_seconds").set(
                lock_waited, tags={"lock": "global"})
            mcat.get("rtt_gcs_hot_handler_seconds").observe(
                time.monotonic() - t0, tags={"kind": "task_done"})
        if self.pending_tasks:
            # nothing queued → nothing the freed capacity could dispatch;
            # skip the scan (len() is GIL-atomic, no lock needed)
            self._pump()

    def _on_actor_ready(self, worker_id: str, msg: dict) -> None:
        with self.cv:
            a = self.actors.get(msg["actor_id"])
            w = self.workers.get(worker_id)
            if a is None or w is None:
                return
            if msg.get("reattach"):
                # surviving actor re-announcing to a restarted head: no
                # creation task to settle, no resources were acquired on
                # this GCS — re-acquire the actor-lifetime hold so the
                # node's accounting matches reality, then go ALIVE.
                if a.state == A_DEAD:
                    return
                a.state = A_ALIVE
                a.worker_id = worker_id
                a.addr = msg["addr"]
                w.state = "actor"
                w.actor_id = a.actor_id
                if a.spec.get("hold_resources", True):
                    req = self._task_resources(a.spec)
                    node = self.nodes.get(w.node_id)
                    if req and node is not None:
                        node.acquire(req)
                        a.spec["_req"] = req
                        a.spec["_node"] = w.node_id
                self._repl_actor_locked(a)
                self.cv.notify_all()
                return
            self.running.pop(a.spec["task_id"], None)
            if msg["status"] == "ok":
                # creation task reached its terminal state: count it, or
                # the ok/error ratio under-reports actor-heavy workloads
                self._count_task_terminal("ok")
                a.state = A_ALIVE
                a.worker_id = worker_id
                a.addr = msg["addr"]
                w.state = "actor"
                w.actor_id = a.actor_id
                w.current_task = None
                if a.spec.get("hold_resources", True):
                    # explicit num_cpus/num_gpus/resources are held for
                    # the actor's lifetime (released in _actor_worker_died)
                    pass
                else:
                    # reference default-actor semantics: 1 CPU for
                    # creation scheduling, 0 held while alive
                    self._release_task_resources(a.spec)
                self._repl_actor_locked(a)
            else:
                spec = w.current_task
                w.current_task = None
                if spec is None:
                    # raylet-dispatched creation: the GCS never tracked a
                    # current_task — the creation claim lives on the
                    # actor spec (same dict the lease granted)
                    spec = a.spec
                if spec is not None:
                    self._release_task_resources(spec)
                w.state = "idle"
                node = self.nodes.get(w.node_id)
                if node is not None and node.raylet_conn is None:
                    # raylet workers never enter the head's idle pool —
                    # the raylet owns their local scheduling
                    node.idle_workers.append(worker_id)
                a.state = A_DEAD
                a.death_reason = "creation failed"
                a.spec["_creation_error"] = msg.get("error")
                if a.name:
                    self.named_actors.pop((a.namespace, a.name), None)
                    self._repl_record("named", a.namespace, a.name, None)
                self._repl_actor_locked(a)
            self.cv.notify_all()
        self._pump()

    # ---------------------------------------------------------------- dispatch
    def _dispatch(self, kind: str, msg: dict) -> Optional[dict]:
        handler = getattr(self, f"_h_{kind}", None)
        if handler is None:
            raise exc.RaySystemError(f"unknown rpc kind: {kind}")
        return handler(msg)

    def local_call(self, kind: str, msg: dict) -> dict:
        """In-process RPC: dispatch directly on the caller's thread.

        Used by a driver whose head lives in its own process
        (``_INPROC_SERVER``): no socket, no serve-thread wakeup, no frame
        codec — the dominant costs of the serial round-trip on small
        hosts.  Handler exceptions propagate to the caller directly
        (the socket path's dumps_call/loads_call round-trip preserves
        type anyway); no dedup ids are needed because there is no channel
        to break mid-reply."""
        if self._shutdown:
            raise ConnectionError("GCS is shut down")
        if self._fenced and kind not in _FENCED_OK_KINDS:
            # same contract as the socket path's conn drop: the caller's
            # reconnect machinery re-dials and reaches the promoted head
            raise ConnectionError(
                "GCS fenced: a newer ledger epoch was claimed by a "
                "promoted standby")
        resp = self._dispatch(kind, msg)
        return {"error": None, **(resp or {})}

    # --- registration
    def _h_register_client(self, msg: dict) -> dict:
        with self.cv:
            wid = msg["client_id"]
            # a re-registering client (transient conn break, reattach) is
            # alive again: its ledger must accept pins (worker death
            # closed it against late stragglers)
            self._closed_ledgers.pop(wid, None)
            node_id = msg.get("node_id") or self.head_node_id
            if node_id not in self.nodes:
                # stale node id from before a head restart: adopt onto
                # this head's node (GCS fault tolerance reconnects)
                node_id = self.head_node_id
            role = msg["role"]
            existing = self.workers.get(wid)
            if existing is not None:  # extra thread-local channel re-registering
                return {"node_id": existing.node_id,
                        "head_node_id": self.head_node_id,
                        "epoch": self.epoch,
                        "store_capacity": self.store.capacity}
            if role == "worker":
                # find the placeholder created at spawn time by pid, else create
                w = None
                for cand in self.workers.values():
                    # node_id must match too: a remote-agent worker can
                    # collide on pid with a local placeholder (separate
                    # pid namespaces across hosts)
                    if cand.proc is not None and cand.proc.pid == msg["pid"] \
                            and cand.state == "starting" \
                            and cand.node_id == node_id:
                        w = cand
                        break
                if w is None:
                    w = WorkerState(wid, node_id, msg["pid"])
                    self.workers[wid] = w
                    # a remote node's worker: only it knows whether it
                    # sees the cards (its NodeAgent spawned it)
                    w.gpu_capable = bool(msg.get("gpu"))
                else:
                    # rekey to the worker's self-chosen id
                    del self.workers[w.worker_id]
                    w.worker_id = wid
                    self.workers[wid] = w
                    if w.gpu_capable:  # the node's GPU workers boot again
                        self._gpu_boot_failures.pop(w.node_id, None)
                        self._gpu_fork_after.pop(w.node_id, None)
                node = self.nodes.get(w.node_id)
                if node is not None:
                    node.workers.add(wid)
            else:  # driver
                w = WorkerState(wid, node_id, msg["pid"])
                w.state = "driver"
                self.workers[wid] = w
                self.driver_ids.add(wid)
                self._repl_record("driver", wid)
            self.cv.notify_all()
            return {"node_id": w.node_id, "head_node_id": self.head_node_id,
                    "epoch": self.epoch,
                    "store_capacity": self.store.capacity}

    # --- objects
    def _h_put_object(self, msg: dict) -> dict:
        t0 = time.monotonic()
        with self.cv:
            self._apply_put_locked(msg["client_id"], msg)
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_gcs_hot_handler_seconds").observe(
                time.monotonic() - t0, tags={"kind": "put_object"})
        if self.pending_tasks:
            self._pump()  # a dep-parked task may have been promoted
        return {}

    def _h_peek_meta(self, msg: dict) -> dict:
        """Non-blocking state snapshot (actor-channel reconnect dedup:
        'did this call's returns already seal?').  Sealed objects answer
        lock-free; only unsealed ones fall back to the global lock."""
        out = {}
        misses = []
        sealed = self._sealed
        for oid in msg["object_ids"]:
            e = sealed.get(oid)
            if e is not None:
                out[oid] = {"state": e["state"]}
            else:
                misses.append(oid)
        if misses:
            with self.lock:
                for oid in misses:
                    m = self.objects.get(oid)
                    out[oid] = None if m is None else {"state": m.state}
        return {"metas": out}

    def _notify_object_waiters(self, oid: str) -> None:
        """An object reached a terminal state — wake the exact get/wait
        RPCs blocked on it.  Takes only ``_waiter_lock`` (callers hold the
        global lock; readers never do)."""
        with self._waiter_lock:
            lst = self._object_waiters.pop(oid, None)
            if not lst:
                return
            for waiter in lst:
                if oid in waiter["left"]:
                    waiter["left"].discard(oid)
                    waiter["done"] = waiter.get("done", 0) + 1
                    need = waiter.get("need")
                    if (need is None and not waiter["left"]) or \
                            (need is not None and waiter["done"] >= need):
                        waiter["ev"].set()

    def _register_waiter(self, waiter: dict, oids) -> None:
        """Park ``waiter`` on each oid, then self-service any that sealed
        in the registration gap: seals publish to ``_sealed`` BEFORE
        notifying, so an entry present after registration means the
        notify may already have run without us."""
        with self._waiter_lock:
            for oid in oids:
                waiter["left"].add(oid)
                self._object_waiters.setdefault(oid, []).append(waiter)
        sealed = self._sealed
        hit = [oid for oid in oids if oid in sealed]
        if hit:
            with self._waiter_lock:
                for oid in hit:
                    self._waiter_discard_locked(waiter, oid)

    def _waiter_discard_locked(self, waiter: dict, oid: str) -> None:
        """_waiter_lock held: one oid went terminal and this thread saw it
        directly (no notify) — mirror _notify_object_waiters for it."""
        if oid not in waiter["left"]:
            return
        waiter["left"].discard(oid)
        waiter["done"] = waiter.get("done", 0) + 1
        need = waiter.get("need")
        if (need is None and not waiter["left"]) or \
                (need is not None and waiter["done"] >= need):
            waiter["ev"].set()
        lst = self._object_waiters.get(oid)
        if lst is not None:
            try:
                lst.remove(waiter)
            except ValueError:
                pass
            if not lst:
                del self._object_waiters[oid]

    def _unregister_waiter(self, waiter: dict) -> None:
        """Drop a waiter's remaining registry entries (takes _waiter_lock)."""
        with self._waiter_lock:
            for oid in list(waiter["left"]):
                lst = self._object_waiters.get(oid)
                if lst is not None:
                    try:
                        lst.remove(waiter)
                    except ValueError:
                        pass
                    if not lst:
                        del self._object_waiters[oid]

    def _scan_pending(self, oids, verify_fs: bool) -> List[str]:
        """Lock held: returns the oids still PENDING.  With ``verify_fs``,
        READY objects are checked against the filesystem (the truth, not
        our bookkeeping — a segment can vanish under us) and lost ones are
        routed to reconstruction.  Pending objects whose owner died with
        no lineage are sealed with OwnerDiedError here."""
        missing_lost = []
        pending = []
        for oid in oids:
            meta = self.objects.get(oid)
            if meta is None or meta.state == PENDING:
                pending.append(oid)
            elif verify_fs and meta.state == READY and \
                    meta.loc in ("shm", "spilled"):
                self.store.restore(oid)
                if not ShmObjectStore.exists_in_shm(oid):
                    missing_lost.append((oid, meta))
            elif verify_fs and meta.state == READY and meta.loc == "slab":
                if self.slab is None or not self.slab.exists(oid):
                    missing_lost.append((oid, meta))
        for oid, meta in missing_lost:
            # purge stale store bookkeeping first: the segment is gone,
            # but _sealed/_used may still account for it, which would
            # corrupt capacity tracking and crash later evictions
            self.store.delete_object(oid)
            self._mark_object_lost(oid, meta)
            if meta.state == PENDING:
                pending.append(oid)
        if missing_lost:
            self._pump_locked()
        for oid in pending:
            if oid[:16] in self.dead_clients:
                meta = self._get_or_create_meta(oid)
                if meta.state == PENDING and not (
                        meta.lineage_task and meta.lineage_task in self.lineage):
                    self._mark_object_lost(oid, meta)
        return [oid for oid in pending
                if (m := self.objects.get(oid)) is None or m.state == PENDING]

    def _read_sealed_fast(self, oids) -> Optional[dict]:
        """Lock-free read of terminal object metas from ``_sealed``.
        Returns the reply dict, or None when any oid is missing from the
        table (pending / remote / deleted) or fails the data-plane
        presence check (lost segment → the slow path routes it to
        reconstruction).  Never touches the global lock; the store and
        slab are their own lock domains."""
        sealed = self._sealed
        out = {}
        for oid in oids:
            e = sealed.get(oid)
            if e is None or e["loc"] == "remote":
                # remote marker: terminal for peek/wait/waiter purposes,
                # but the reply needs an addr lookup — slow path
                return None
            out[oid] = e
        for oid, e in out.items():
            loc = e["loc"]
            if loc in ("shm", "spilled"):
                self.store.restore(oid)
                if not ShmObjectStore.exists_in_shm(oid):
                    return None
                self.store.touch(oid)
            elif loc == "slab":
                if self.slab is None or not self.slab.exists(oid):
                    return None
        return out

    def _h_get_meta(self, msg: dict) -> dict:
        oids = msg["object_ids"]
        t0 = time.monotonic()
        # Hot path: every oid already sealed — reply without the global
        # lock (the common case for task args and post-completion gets).
        fast = self._read_sealed_fast(oids)
        if fast is not None:
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_gcs_hot_handler_seconds").observe(
                    time.monotonic() - t0, tags={"kind": "get_meta_fast"})
            return {"metas": fast}
        deadline = None if msg.get("timeout") is None \
            else time.monotonic() + msg["timeout"]
        ev = threading.Event()
        waiter = {"left": set(), "ev": ev, "need": None}
        with self.cv:
            pending = self._scan_pending(oids, verify_fs=True)
        if GLOBAL_CONFIG.metrics_enabled:
            # outside the lock: metric updates must not lengthen the
            # global critical section (same rule as the other handlers)
            mcat.get("rtt_gcs_hot_handler_seconds").observe(
                time.monotonic() - t0, tags={"kind": "get_meta_scan"})
        if pending and msg.get("nonblock"):
            # fast-path probe (see Worker._blocking_get_meta): the
            # caller avoids the task_blocked CPU-release dance when
            # everything is already sealed
            return {"pending": sorted(pending)}
        if pending:
            # registration is OUTSIDE the global lock; _register_waiter's
            # sealed-table re-check closes the scan→register gap
            self._register_waiter(waiter, pending)
        try:
            while True:
                with self._waiter_lock:
                    if not waiter["left"]:
                        break
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    with self._waiter_lock:
                        left = sorted(waiter["left"])[:3]
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {left}...")
                # rtlint: blocks-ok(get_meta IS a client-blocking rpc:
                # the per-conn dispatch thread stalls only its own
                # caller; slices capped at 1s and the caller's deadline
                # bounds the loop)
                ev.wait(timeout=min(1.0, remaining)
                        if remaining is not None else 1.0)
                ev.clear()
                with self._waiter_lock:
                    left_now = list(waiter["left"])
                if not left_now:
                    break
                # periodic sweep for state changes with no seal event
                # (owner death, lost segments under reconstruction)
                with self.cv:
                    self._scan_pending(left_now, verify_fs=False)
                    terminal = [o for o in left_now
                                if (m := self.objects.get(o)) is not None
                                and m.state != PENDING]
                if terminal:
                    with self._waiter_lock:
                        for oid in terminal:
                            self._waiter_discard_locked(waiter, oid)
        finally:
            self._unregister_waiter(waiter)
        fast = self._read_sealed_fast(oids)
        if fast is not None:
            return {"metas": fast}
        with self.cv:
            out = {}
            for oid in oids:
                meta = self.objects[oid]
                self.store.touch(oid)
                entry = {"state": meta.state, "loc": meta.loc,
                         "data": meta.data, "size": meta.size}
                if meta.loc == "remote":
                    node = self.nodes.get(meta.node_id)
                    entry["node_id"] = meta.node_id
                    entry["addr"] = node.data_addr if node else None
                out[oid] = entry
            return {"metas": out}

    def _h_wait(self, msg: dict) -> dict:
        oids = msg["object_ids"]
        num_returns = msg["num_returns"]
        # lock-free fast path: enough terminal objects in the sealed table
        sealed = self._sealed
        ready = [o for o in oids if o in sealed]
        if len(ready) >= num_returns:
            ready_set = set(ready[:num_returns])
            return {"ready": [o for o in oids if o in ready_set],
                    "not_ready": [o for o in oids if o not in ready_set]}
        deadline = None if msg.get("timeout") is None \
            else time.monotonic() + msg["timeout"]
        ev = threading.Event()
        waiter = None

        def ready_now():
            return [o for o in oids
                    if (m := self.objects.get(o)) is not None
                    and m.state != PENDING]

        with self.lock:
            ready = ready_now()
        if len(ready) < num_returns:
            pend = [o for o in oids if o not in set(ready)]
            waiter = {"left": set(), "ev": ev,
                      "need": num_returns - len(ready), "done": 0}
            # sealed-table re-check inside closes the check→register gap
            self._register_waiter(waiter, pend)
        try:
            while len(ready) < num_returns:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                # rtlint: blocks-ok(wait() IS a client-blocking rpc:
                # stalls only its own caller's per-conn thread; slices
                # capped at 0.5s and the wire-carried timeout bounds
                # the loop)
                ev.wait(timeout=min(0.5, remaining)
                        if remaining is not None else 0.5)
                ev.clear()
                with self.lock:
                    ready = ready_now()
        finally:
            if waiter is not None:
                self._unregister_waiter(waiter)
        ready_set = set(ready[:num_returns])
        return {"ready": [o for o in oids if o in ready_set],
                "not_ready": [o for o in oids if o not in ready_set]}

    def _add_refs_locked(self, ledger: str, object_ids) -> None:
        """Lock held — the ONE copy of ref-pinning (used by the add_refs
        RPC and the submit-stream 'ref' op; the two must not drift).
        Pins for a ledger release_all already tore down are dropped (the
        late-pin race; see _closed_ledgers)."""
        if ledger in self._closed_ledgers:
            return
        refs = self.client_refs[ledger]
        for oid in object_ids:
            self._get_or_create_meta(oid).refcount += 1
            refs[oid] = refs.get(oid, 0) + 1

    def _close_ledger_locked(self, ledger: str) -> None:
        self._closed_ledgers[ledger] = None
        while len(self._closed_ledgers) > 4096:
            self._closed_ledgers.popitem(last=False)

    def _apply_ref_op_locked(self, kind: str, msg: dict) -> None:
        """Lock held — apply one refcount-plane op.  The single dispatch
        point for the coalesced drain, the per-kind handlers, and the
        in-process short circuit, so semantics cannot drift."""
        if kind == "add_ref":
            self._add_refs_locked(msg.get("ledger") or msg["client_id"],
                                  (msg["object_id"],))
        elif kind == "add_refs":
            self._add_refs_locked(msg.get("ledger") or msg["client_id"],
                                  msg["object_ids"])
        elif kind == "release":
            self._apply_release_locked(msg["client_id"], msg["object_id"])
        elif kind == "release_batch":
            for oid in msg["object_ids"]:
                self._apply_release_locked(msg["client_id"], oid)
        elif kind == "release_all":
            ledger = msg["ledger"]
            self._close_ledger_locked(ledger)
            for oid, n in self.client_refs.pop(ledger, {}).items():
                self._decref(oid, n)

    def _drain_ref_ops(self, batch: List[Tuple[str, dict]]) -> None:
        """Apply a connection's coalesced refcount oneways under ONE
        global-lock acquisition, preserving their arrival order (the
        per-connection FIFO is the ordering contract pins/releases rely
        on; coalescing only ever delays application, never reorders)."""
        if not batch:
            return
        t0 = time.monotonic()
        with self.cv:
            waited = time.monotonic() - t0
            for kind, msg in batch:
                self._apply_ref_op_locked(kind, msg)
            self.cv.notify_all()
        if GLOBAL_CONFIG.metrics_enabled:
            # metric updates AFTER releasing: they take the metric's own
            # lock and must not lengthen the global critical section
            mcat.get("rtt_gcs_lock_wait_seconds").set(
                waited, tags={"lock": "global"})
            mcat.get("rtt_gcs_hot_handler_seconds").observe(
                time.monotonic() - t0, tags={"kind": "ref_drain"})
            mcat.get("rtt_gcs_ref_ops_total").inc(
                len(batch), tags={"path": "coalesced"})
        batch.clear()

    def _count_inline_ref_op(self) -> None:
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_gcs_ref_ops_total").inc(tags={"path": "inline"})

    def _h_add_ref(self, msg: dict) -> dict:
        with self.cv:
            self._apply_ref_op_locked("add_ref", msg)
        self._count_inline_ref_op()
        return {}

    def _h_add_refs(self, msg: dict) -> dict:
        with self.cv:
            self._apply_ref_op_locked("add_refs", msg)
        self._count_inline_ref_op()
        return {}

    def _h_release_batch(self, msg: dict) -> dict:
        """Batched ObjectRef drops (one lock acquisition + one message for
        up to 64 decrefs — the submit hot loop's GC traffic)."""
        with self.cv:
            self._apply_ref_op_locked("release_batch", msg)
        self._count_inline_ref_op()
        return {}

    def _h_release_all(self, msg: dict) -> dict:
        """Release every ref under a transient ledger (in-flight actor args)."""
        with self.cv:
            self._apply_ref_op_locked("release_all", msg)
            self.cv.notify_all()
        self._count_inline_ref_op()
        return {}

    def _h_seal_errors(self, msg: dict) -> dict:
        with self.cv:
            for oid in msg["object_ids"]:
                meta = self._get_or_create_meta(oid)
                if meta.state == PENDING:
                    self._seal_error(oid, msg["error"])
        if self.pending_tasks:
            self._pump()
        return {}

    def _h_release(self, msg: dict) -> dict:
        return self._h_release_batch(
            {"client_id": msg["client_id"],
             "object_ids": (msg["object_id"],)})

    def _h_free_objects(self, msg: dict) -> dict:
        with self.cv:
            for oid in msg["object_ids"]:
                self._sealed.pop(oid, None)
                meta = self.objects.pop(oid, None)
                if meta is not None and meta.loc in ("shm", "spilled"):
                    self.store.delete_object(oid)
                    self._repl_record("shm", oid, None)
                elif meta is not None and meta.loc == "slab" \
                        and self.slab is not None:
                    self.slab.delete(oid)
            self.cv.notify_all()
        return {}

    # --- tasks
    def _register_spec_locked(self, spec: dict) -> None:
        """Lock held.  Pin returns + deps/borrows and enqueue the spec —
        the ONE copy of submit registration (unbatched handler and the
        batched op stream both call here; refcount rules must not drift
        between them)."""
        refs = self.client_refs[spec["owner"]]
        for oid in spec["return_ids"]:
            meta = self._get_or_create_meta(oid)
            meta.refcount += 1
            meta.has_producer = True
            refs[oid] = refs.get(oid, 0) + 1
        # pin args (top-level refs) and borrows (refs nested in values)
        # until the task reaches a terminal state
        for dep in list(spec.get("deps", ())) + list(spec.get("borrows", ())):
            meta = self._get_or_create_meta(dep)
            meta.refcount += 1
        self._push_pending(spec)

    def _apply_put_locked(self, client_id, msg: dict) -> None:
        """Lock held.  The ONE copy of object-publication bookkeeping."""
        oid = msg["object_id"]
        meta = self._get_or_create_meta(oid)
        if not msg.get("transient"):
            meta.refcount += 1  # the putting client's reference
            self.client_refs[client_id][oid] = \
                self.client_refs[client_id].get(oid, 0) + 1
        # transient: a task-arg payload — no client ref at all; the
        # submit's dep pin (same batch or rc-0-at-seal grace) owns it
        if msg["loc"] == "shm":
            self.store.adopt(oid, msg.get("size", 0))
        self._seal_object(oid, msg["loc"], msg.get("data"),
                          msg.get("size", 0), msg.get("node_id"),
                          msg.get("contained", []))

    def _apply_release_locked(self, client_id, oid: str) -> None:
        """Lock held.  The ONE copy of a single client-ref release."""
        refs = self.client_refs.get(client_id, {})
        if refs.get(oid, 0) > 0:
            refs[oid] -= 1
            if refs[oid] == 0:
                del refs[oid]
            self._decref(oid)

    def _h_submit_task(self, msg: dict) -> dict:
        spec = msg["spec"]
        try:
            with self.cv:
                self._register_spec_locked(spec)
        except Exception as e:  # noqa: BLE001 - submit is one-way: a lost
            # error would strand the caller's get() forever; seal the
            # returns with it instead
            with self.cv:
                self._fail_task(spec, e)
            raise
        # _pump_locked's capacity pre-check makes a no-capacity pump O(1);
        # no submit-site heuristic needed.
        if self.pending_tasks:
            self._pump()
        return {}

    def _h_submit_batch(self, msg: dict) -> dict:
        """Batched pipelined submission (r3): an ORDERED op stream — up to
        64 ("put", putmsg) / ("spec", spec) / ("rel", oid) entries in ONE
        message and ONE pump.  In-order application gives the same FIFO
        the unbatched path had: an arg-payload put lands before the spec
        that deps on it; a transient release lands after the spec whose
        dep pin replaces it."""
        client_id = msg.get("client_id")
        t0 = time.monotonic()
        with self.cv:
            lock_waited = time.monotonic() - t0
            for kind, payload in msg["ops"]:
                if kind == "spec":
                    try:
                        self._register_spec_locked(payload)
                    except Exception as e:  # noqa: BLE001 - see
                        # _h_submit_task: a lost error strands the getter
                        self._fail_task(payload, e)
                elif kind == "put":
                    try:
                        self._apply_put_locked(client_id, payload)
                    except Exception as e:  # noqa: BLE001 - one bad op
                        # must not discard the rest of the ordered stream,
                        # and a silently-lost put error would strand every
                        # getter (put is one-way; the ref already exists):
                        # seal the object WITH the error so parked specs
                        # and direct get()s wake with it
                        logger.exception("submit_batch: put %s failed",
                                         payload.get("object_id"))
                        oid = payload.get("object_id")
                        if oid:
                            from ray_tpu_torch._private.serialization import \
                                serialize_to_bytes
                            self._seal_error(oid, serialize_to_bytes(e)[0])
                elif kind == "rel":
                    try:
                        self._apply_release_locked(client_id, payload)
                    except Exception:  # noqa: BLE001
                        logger.exception("submit_batch: release %s failed",
                                         payload)
                elif kind == "ref":
                    # batched add_refs riding the ordered stream (actor-
                    # call return pins — saves a per-call oneway on the
                    # direct-call hot path); MUST precede any later "rel"
                    # of the same oid, which stream order gives
                    try:
                        self._add_refs_locked(
                            payload.get("ledger") or client_id,
                            payload["object_ids"])
                    except Exception:  # noqa: BLE001
                        logger.exception("submit_batch: ref op failed")
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_gcs_lock_wait_seconds").set(
                lock_waited, tags={"lock": "global"})
            mcat.get("rtt_gcs_hot_handler_seconds").observe(
                time.monotonic() - t0, tags={"kind": "submit_batch"})
        if self.pending_tasks:
            self._pump()
        return {}

    def _iter_queued_specs(self):
        """Lock held: every not-yet-dispatched spec — the scan queue plus
        dep-parked specs (each parked spec yielded once)."""
        yield from self.pending_tasks
        for w in self.workers.values():
            yield from w.pipeline
        seen = set()
        for specs in self.dep_waiting.values():
            for spec in specs:
                sid = id(spec)
                if sid not in seen:
                    seen.add(sid)
                    yield spec

    def _h_find_task_of_object(self, msg: dict) -> dict:
        oid = msg["object_id"]
        with self.lock:
            for spec in self._iter_queued_specs():
                if oid in spec["return_ids"]:
                    return {"task_id": spec["task_id"]}
            for wid, spec in self.running.values():
                if oid in spec["return_ids"]:
                    return {"task_id": spec["task_id"]}
            meta = self.objects.get(oid)
            if meta is not None and meta.lineage_task:
                return {"task_id": meta.lineage_task}
        raise ValueError(f"no task found for object {oid}")

    def _h_cancel_task(self, msg: dict) -> dict:
        tid = msg["task_id"]
        with self.cv:
            for spec in self._iter_queued_specs():
                if spec["task_id"] == tid:
                    spec["cancelled"] = True
                    self._fail_task(spec, exc.TaskCancelledError(tid))
                    if spec.get("_prepushed"):
                        # a worker already holds a copy of this spec
                        # (prepushed pipeline): revoke that COPY (skip-
                        # once) — a plain cancel would only target the
                        # running task, and a sticky flag would break a
                        # later legitimate re-dispatch
                        for w in self.workers.values():
                            if spec in w.pipeline:
                                w.push_ctl({"kind": "drop_queued",
                                        "pairs": [(tid,
                                                   spec.get("_dseq"))]})
                                break
                    self.cv.notify_all()
                    return {"cancelled": "pending"}
            entry = self.running.get(tid)
            if entry is not None:
                wid, spec = entry
                if wid.startswith("raylet:"):
                    # leased to a raylet: revoke there.  A queued lease
                    # never started — settle it here and now; a running
                    # one gets the in-worker cancel via the raylet.
                    node = None
                    for n in self.nodes.values():
                        if tid in n.leases_out:
                            node = n
                            break
                    spec["cancelled"] = True
                    if node is not None and spec.get("_lease_q"):
                        node.leases_out.pop(tid, None)
                        self.running.pop(tid, None)
                        self._fail_task(spec, exc.TaskCancelledError(tid))
                        node.push_raylet({"kind": "lease_revoke",
                                          "rid": None, "task_ids": [tid]})
                        self.cv.notify_all()
                        return {"cancelled": "pending"}
                    if node is not None:
                        node.push_raylet({"kind": "lease_revoke",
                                          "rid": None, "task_ids": [tid]})
                    return {"cancelled": "signalled"}
                w = self.workers.get(wid)
                if msg.get("force"):
                    if w is not None and w.proc is not None:
                        w.proc.kill()
                    return {"cancelled": "killed"}
                if w is not None:
                    w.push_ctl({"kind": "cancel", "task_id": tid})
                return {"cancelled": "signalled"}
        return {"cancelled": "not_found"}

    # --- actors
    def _h_create_actor(self, msg: dict) -> dict:
        spec = msg["spec"]
        a = ActorState(spec)
        with self.cv:
            if a.name:
                key = (a.namespace, a.name)
                if key in self.named_actors:
                    existing = self.actors.get(self.named_actors[key])
                    if existing is not None and existing.state != A_DEAD:
                        if spec.get("get_if_exists"):
                            return {"actor_id": existing.actor_id, "existing": True}
                        raise ValueError(
                            f"actor name {a.name!r} already taken in "
                            f"namespace {a.namespace!r}")
                self.named_actors[key] = a.actor_id
            self.actors[a.actor_id] = a
            # pin the constructor's args for the actor's lifetime, as a
            # task's are pinned until it ends: the submitter releases its
            # own ref to a by-value payload right after this call, and a
            # restart reads the args again (released at DEAD, in
            # _repl_actor_locked)
            for dep in list(spec.get("deps", ())) + \
                    list(spec.get("borrows", ())):
                self._get_or_create_meta(dep).refcount += 1
            self._push_pending(spec)
            if a.name:
                self._repl_record("named", a.namespace, a.name,
                                  a.actor_id)
            self._repl_actor_locked(a)
        self._persist_durable()
        self._pump()
        return {"actor_id": a.actor_id, "existing": False}

    def _h_get_actor_info(self, msg: dict) -> dict:
        deadline = None if msg.get("timeout") is None \
            else time.monotonic() + msg["timeout"]
        with self.cv:
            while True:
                a = self.actors.get(msg["actor_id"])
                if a is None:
                    raise ValueError(f"unknown actor {msg['actor_id']}")
                if a.state == A_ALIVE:
                    return {"state": a.state, "addr": a.addr,
                            "incarnation": a.incarnation}
                if a.state == A_DEAD:
                    return {"state": a.state, "addr": None,
                            "death_reason": a.death_reason,
                            "creation_error": a.spec.get("_creation_error"),
                            "incarnation": a.incarnation}
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return {"state": a.state, "addr": None,
                            "incarnation": a.incarnation}
                self.cv.wait(timeout=min(0.5, remaining) if remaining else 0.5)

    def _h_get_actor_by_name(self, msg: dict) -> dict:
        with self.cv:
            aid = self.named_actors.get((msg.get("namespace", "default"), msg["name"]))
            if aid is None:
                raise ValueError(f"no actor named {msg['name']!r}")
            a = self.actors[aid]
            return {"actor_id": aid, "class_blob_id": a.spec.get("class_blob_id"),
                    "method_meta": a.spec.get("method_meta")}

    def _h_kill_actor(self, msg: dict) -> dict:
        with self.cv:
            a = self.actors.get(msg["actor_id"])
            if a is None:
                return {}
            if msg.get("no_restart", True):
                a.spec["_killed"] = True
                a.restarts_left = 0
            a.death_reason = "ray_tpu_torch.kill"
            self._repl_actor_locked(a)  # restart budget zeroed
            w = self.workers.get(a.worker_id) if a.worker_id else None
        if w is not None and w.proc is not None:
            try:
                w.proc.kill()
            except OSError:
                pass
        elif w is not None:
            self._push_worker_ctl(w, {"kind": "stop_worker"})
        with self.cv:
            if a.state in (A_PENDING, A_RESTARTING) and msg.get("no_restart", True):
                # not yet running anywhere: cancel the pending creation
                for spec in self._iter_queued_specs():
                    if spec.get("actor_id") == a.actor_id:
                        spec["cancelled"] = True
                a.state = A_DEAD
                if a.name:
                    self.named_actors.pop((a.namespace, a.name), None)
                    self._repl_record("named", a.namespace, a.name, None)
                self._repl_actor_locked(a)
            self.cv.notify_all()
        self._persist_durable()
        return {}

    # --- functions / kv
    def _h_export_function(self, msg: dict) -> dict:
        with self.lock:
            new = msg["fn_id"] not in self.functions
            self.functions.setdefault(msg["fn_id"], msg["blob"])
            if new:
                self._repl_record("fn", msg["fn_id"], msg["blob"])
        if new:
            self._persist_durable()
        return {}

    def _h_fetch_function(self, msg: dict) -> dict:
        deadline = time.monotonic() + 30
        with self.cv:
            while msg["fn_id"] not in self.functions:
                if time.monotonic() > deadline:
                    raise exc.RaySystemError(f"function {msg['fn_id']} not exported")
                self.cv.wait(timeout=0.5)
            return {"blob": self.functions[msg["fn_id"]]}

    def _h_kv_put(self, msg: dict) -> dict:
        metrics_key = is_metrics_key(msg["key"])
        profile_key = is_profile_key(msg["key"])
        if metrics_key and \
                (msg.get("namespace", "default") != "default"
                 or msg["key"] != f"__metrics__/{msg.get('client_id')}"):
            # reserved prefix IN EVERY NAMESPACE: metrics snapshots are
            # non-durable (the persistence filter is namespace-blind) and
            # swept ~2min after their publisher dies — silently vacuuming
            # a USER's key that happened to collide would be data loss.
            # Each process may only write its own snapshot key, and only
            # in the default namespace the publisher/sweep operate on.
            raise ValueError(
                "the '__metrics__/' KV prefix is reserved for metric "
                "snapshot publishing (ephemeral, auto-reaped); store "
                "application data under a different key")
        if profile_key and \
                (msg.get("namespace", "default") != "default"
                 or msg["key"] != f"__profile__/{msg.get('client_id')}"):
            # same reservation contract as __metrics__/ above
            raise ValueError(
                "the '__profile__/' KV prefix is reserved for profiler "
                "delta publishing (ephemeral, auto-reaped); store "
                "application data under a different key")
        telemetry_key = metrics_key or profile_key
        with self._kv_lock:
            ns = self.kv[msg.get("namespace", "default")]
            existed = msg["key"] in ns
            if not (msg.get("overwrite", True) is False and existed):
                ns[msg["key"]] = msg["value"]
                if not telemetry_key:
                    # WAL capture inside the critical section so two
                    # racing puts of one key record in table order
                    # (O(1) buffer append; telemetry keys are ephemeral
                    # and excluded from the durable set)
                    self._repl_record("kv",
                                      msg.get("namespace", "default"),
                                      msg["key"], msg["value"])
            if metrics_key:
                # receipt index shares _kv_lock with the sweep (rtlint
                # unguarded: a bare-dict update raced the sweep's
                # iterate+pop)
                self._metrics_key_seen[msg["key"]] = time.monotonic()
            elif profile_key:
                self._profile_key_seen[msg["key"]] = time.monotonic()
        if metrics_key and self._tsdb is not None:
            # history ingest rides the receipt the KV plane already has
            # (zero new RPCs) — OUTSIDE _kv_lock (json parse + ring
            # writes belong under the TSDB's own leaf lock, not a
            # no-block KV critical section); never fails the put
            try:
                self._tsdb.ingest(msg["key"].split("/", 1)[1],
                                  msg["value"])
            except Exception:  # noqa: BLE001 - telemetry best-effort
                logger.exception("tsdb ingest failed")
        if profile_key and self._profile_store is not None:
            # same receipt-riding ingest, into the profile window rings
            # — OUTSIDE _kv_lock (parse + merge under the store's own
            # leaf), and never fails the put
            try:
                self._profile_store.ingest(msg["key"].split("/", 1)[1],
                                           msg["value"])
            except Exception:  # noqa: BLE001 - telemetry best-effort
                logger.exception("profile ingest failed")
        if not telemetry_key:
            # telemetry snapshots are ephemeral by design (re-published
            # every period, reaped when the publisher dies) — every
            # process's publisher dirtying the durable snapshot each
            # cycle would turn steady-state idle into constant disk churn
            self._persist_durable()
        return {"existed": existed}

    def _h_kv_get(self, msg: dict) -> dict:
        with self._kv_lock:
            return {"value": self.kv[msg.get("namespace", "default")].get(msg["key"])}

    def _h_kv_del(self, msg: dict) -> dict:
        metrics_key = is_metrics_key(msg["key"])
        profile_key = is_profile_key(msg["key"])
        with self._kv_lock:
            existed = self.kv[msg.get("namespace", "default")].pop(msg["key"], None)
            if existed is not None and metrics_key:
                self._metrics_key_seen.pop(msg["key"], None)
            elif existed is not None and profile_key:
                self._profile_key_seen.pop(msg["key"], None)
            elif existed is not None:
                self._repl_record("kv", msg.get("namespace", "default"),
                                  msg["key"], None)
        if existed is not None and not (metrics_key or profile_key):
            # same ephemeral-telemetry exemption as _h_kv_put: metrics
            # keys are excluded from the snapshot, so reaping one must
            # not rewrite the durable state for nothing
            self._persist_durable()
        return {"deleted": existed is not None}

    def _h_kv_mget(self, msg: dict) -> dict:
        """Batched prefix read: every (key, value) under a prefix in ONE
        round trip.  The metrics collector scrapes N publishers'
        snapshots per /metrics hit — N serial kv_get RPCs would make
        scrape latency and head load linear in fleet size."""
        pref = msg["prefix"]
        with self._kv_lock:
            ns = self.kv[msg.get("namespace", "default")]
            return {"entries": {k: v for k, v in ns.items()
                                if isinstance(k, type(pref))
                                and k.startswith(pref)}}

    def _h_kv_keys(self, msg: dict) -> dict:
        with self._kv_lock:
            ns = self.kv[msg.get("namespace", "default")]
            prefix = msg.get("prefix", b"")
            return {"keys": [k for k in ns if k.startswith(prefix)]}

    # --- placement groups
    def _h_pg_create(self, msg: dict) -> dict:
        from ray_tpu_torch._private.pg_scheduler import schedule_bundles
        pg = PgState(msg["pg_id"], msg["bundles"], msg["strategy"], msg.get("name", ""))
        with self.cv:
            assignment = schedule_bundles(
                [n for n in self.nodes.values() if n.schedulable()],
                pg.bundles, pg.strategy)
            if assignment is not None:
                for i, node_id in enumerate(assignment):
                    self.nodes[node_id].acquire(pg.bundles[i])
                    pg.assignment[i] = node_id
                pg.state = READY
            self.pgs[pg.pg_id] = pg
            self._repl_record("pg", pg.pg_id,
                              {"bundles": pg.bundles,
                               "strategy": pg.strategy, "name": pg.name})
            self.cv.notify_all()
        self._persist_durable()
        return {"state": pg.state}

    def _h_pg_wait(self, msg: dict) -> dict:
        from ray_tpu_torch._private.pg_scheduler import schedule_bundles
        deadline = None if msg.get("timeout") is None \
            else time.monotonic() + msg["timeout"]
        with self.cv:
            while True:
                pg = self.pgs.get(msg["pg_id"])
                if pg is None:
                    raise ValueError("placement group removed")
                if pg.state == READY:
                    return {"ready": True, "assignment": pg.assignment}
                # retry scheduling (nodes may have joined)
                assignment = schedule_bundles(
                    [n for n in self.nodes.values() if n.schedulable()],
                    pg.bundles, pg.strategy)
                if assignment is not None:
                    for i, node_id in enumerate(assignment):
                        self.nodes[node_id].acquire(pg.bundles[i])
                        pg.assignment[i] = node_id
                    pg.state = READY
                    self.cv.notify_all()
                    continue
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return {"ready": False, "assignment": None}
                self.cv.wait(timeout=min(0.5, remaining) if remaining else 0.5)

    def _h_pg_remove(self, msg: dict) -> dict:
        with self.cv:
            pg = self.pgs.pop(msg["pg_id"], None)
            if pg is not None and pg.state == READY:
                for i, node_id in enumerate(pg.assignment):
                    node = self.nodes.get(node_id)
                    if node is not None:
                        node.release_res(pg.bundles[i])
            if pg is not None:
                self._repl_record("pg", msg["pg_id"], None)
            self.cv.notify_all()
        self._persist_durable()
        self._pump()
        return {}

    def _h_pg_table(self, msg: dict) -> dict:
        with self.lock:
            return {"pgs": {pid: {"state": pg.state, "strategy": pg.strategy,
                                  "bundles": pg.bundles,
                                  "assignment": pg.assignment}
                            for pid, pg in self.pgs.items()}}

    # --- cluster / state API
    def _h_add_node(self, msg: dict) -> dict:
        nid = self.add_node_internal(NodeID.new(), msg["resources"],
                                     labels=msg.get("labels"),
                                     remote=bool(msg.get("remote")),
                                     data_addr=msg.get("data_addr"),
                                     data_proto=int(msg.get("data_proto")
                                                    or 0))
        self._pump()
        # session name: same-host raylets drop their flight-recorder
        # rings into this session's tmpfs dir so `debug dump` sees them;
        # gpu_workers_per_node: an agent starts as many GPU workers as
        # this head would on a node of its own
        return {"node_id": nid, "session": self.session.path.name,
                "gpu_workers_per_node": GLOBAL_CONFIG.gpu_workers_per_node}

    def _h_raylet_table(self, msg: dict) -> dict:
        """Per-node local-scheduler state for `ray_tpu_torch status` and
        `debug dump`: held leases, local queue depth, reconcile age."""
        with self.lock:
            rows = []
            for n in self.nodes.values():
                if n.raylet_conn is None and not n.raylet_stats:
                    continue
                rows.append({
                    "node_id": n.node_id,
                    "alive": n.alive,
                    "attached": n.raylet_conn is not None,
                    "held_leases": len(n.leases_out),
                    "queued_leases": n.queued_lease_count(),
                    "last_reconcile_age_s": round(
                        n.raylet_reconcile_age, 3),
                    "stats": dict(n.raylet_stats),
                })
            return {"raylets": rows}

    def _h_remove_node(self, msg: dict) -> dict:
        self.remove_node_internal(msg["node_id"])
        return {}

    # ------------------------------------------------- fleet elasticity (§4j)
    def _h_node_draining(self, msg: dict) -> dict:
        """Provider-initiated preemption warning: mark the node draining
        so placement avoids it, and publish a fleet event the elasticity
        manager / train backend subscribers react to.  The node is
        addressed by id, or by a label match (``label={"ray-pod": name}``
        — the Kubernetes provider only knows pod names)."""
        deadline_s = float(msg.get("deadline_s") or 0.0)
        sel = msg.get("label") or {}
        node_id = msg.get("node_id") or ""
        if sel:
            with self.cv:
                # label fallback also covers a stale/unknown node_id —
                # the Kubernetes provider only reliably knows pod names
                if node_id not in self.nodes:
                    for n in self.nodes.values():
                        if all(n.labels.get(k) == v
                               for k, v in sel.items()):
                            node_id = n.node_id
                            break
        ok = self.drain_node_internal(
            node_id, deadline_s=deadline_s,
            reason=str(msg.get("reason") or "preemption"))
        return {"ok": ok, "node_id": node_id if ok else None}

    def drain_node_internal(self, node_id: str, deadline_s: float = 0.0,
                            reason: str = "preemption",
                            only_if_running: bool = False) -> bool:
        """Mark one node draining (placement avoids it; work already
        there keeps running) and publish the ``node_draining`` fleet
        event.  Shared by the RPC handler above and the autopilot's
        straggler reflex (§4n) — remediation drains ride the exact path
        provider warnings do, so every subscriber reacts the same way.
        ``only_if_running`` (the autopilot) refuses a node that is
        already draining: claiming a provider-drained node would let a
        later autopilot undrain cancel the provider's preemption
        warning — the autopilot only owns drains it issued."""
        with self.cv:
            node = self.nodes.get(node_id or "")
            if node is None or not node.alive:
                return False
            already = node.phase == "draining"
            if only_if_running and node.phase != "running":
                return False
            node.phase = "draining"
            node.drain_reason = reason
            if deadline_s > 0:
                node.drain_deadline = time.monotonic() + deadline_s
            self.cv.notify_all()
        if not already:
            self._fleet_event("node_draining", node.node_id,
                              reason=reason, deadline_s=deadline_s)
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_elastic_node_draining_total").inc(
                    tags={"reason": reason})
        return True

    def undrain_node_internal(self, node_id: str,
                              only_reason: Optional[str] = None) -> bool:
        """Return a drained node to the schedulable pool (the autopilot's
        recovery path: the straggler signal cleared, the host is healthy
        again).  Publishes ``node_undrained`` and re-pumps so backlogged
        work can land on the restored capacity.  ``only_reason`` (the
        autopilot passes "straggler") refuses when the CURRENT drain
        reason differs — a provider preemption warning that superseded
        the remediation drain must not be cancelled by the autopilot's
        recovery timer."""
        with self.cv:
            node = self.nodes.get(node_id or "")
            if node is None or not node.alive or node.phase != "draining":
                return False
            if only_reason is not None and node.drain_reason != only_reason:
                return False
            node.phase = "running"
            node.drain_reason = ""
            node.drain_deadline = None
            self.cv.notify_all()
        self._fleet_event("node_undrained", node_id)
        self._pump()
        return True

    def _h_metrics_query(self, msg: dict) -> dict:
        """Query the head TSDB (DESIGN.md §4k): ``op`` selects instant
        ``query`` (default), ``query_range`` (sparkline feed), ``series``
        (metadata listing), or ``stats``.  Runs entirely off the GCS
        locks — the store has its own leaf lock."""
        if self._tsdb is None:
            return {"results": [], "disabled": True}
        op = msg.get("op", "query")
        if op == "stats":
            return {"stats": self._tsdb.stats()}
        if op == "series":
            return {"series": self._tsdb.list_series(msg.get("match"))}
        if op == "query_range":
            return {"results": self._tsdb.query_range(
                msg["expr"], start=msg.get("start"), end=msg.get("end"),
                step=msg.get("step"))}
        if op == "forecast":
            return {"results": self._tsdb.forecast(
                msg["expr"], float(msg.get("horizon_s") or 0.0),
                period_s=float(msg.get("period_s") or 86400.0),
                smooth_s=float(msg.get("smooth_s") or 600.0),
                now=msg.get("at"))}
        return {"results": self._tsdb.query(msg["expr"],
                                            at=msg.get("at"))}

    def _h_profile_query(self, msg: dict) -> dict:
        """Query the head ProfileStore (DESIGN.md §4o): ``op`` selects
        window aggregate ``profile`` (default; optional proc/node
        filter), ``diff`` (recent window A vs the baseline window B
        immediately before it), or ``stats``.  Runs entirely off the
        GCS locks — the store has its own leaf lock."""
        if self._profile_store is None:
            return {"samples": 0, "stacks": {}, "procs": [],
                    "disabled": True}
        op = msg.get("op", "profile")
        if op == "stats":
            return {"stats": self._profile_store.stats()}
        if op == "diff":
            return self._profile_store.diff(
                float(msg.get("window_a") or 300.0),
                float(msg.get("window_b") or 300.0),
                proc=msg.get("proc"))
        return self._profile_store.profile(
            window_s=float(msg.get("window_s") or 300.0),
            proc=msg.get("proc"), node_id=msg.get("node_id"))

    def _run_detectors(self) -> None:
        """Monitor-loop tick: run the TSDB anomaly detectors and emit
        what they find into the fleet-event feed (§4j), the flight
        recorder (§4h), and the anomaly counter.  No GCS lock is held
        while the detectors read the store; the worker→node map is
        snapshotted under the global lock FIRST so nothing nests."""
        found: List[dict] = []
        for det in self._detectors:
            found.extend(det.check())
        if not found:
            return
        with self.lock:
            node_of = {w.worker_id: w.node_id
                       for w in self.workers.values()}
        from ray_tpu_torch._private import flight_recorder
        for ev in found:
            kind = ev.pop("kind")
            node_id = node_of.get(ev.get("worker"))
            # post-mortem capture (§4o): bundle the offending node's
            # hot stacks + rings BEFORE anyone reacts — by the time a
            # human looks, the autopilot may already have drained it
            iid = self._capture_incident(kind, node_id, detail=ev)
            if iid is not None:
                ev = dict(ev, incident=iid)
            self._fleet_event(kind, node_id, **ev)
            if flight_recorder.enabled():
                flight_recorder.record(
                    "anomaly", f"{kind} " + " ".join(
                        f"{k}={v}" for k, v in sorted(ev.items())))
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_anomaly_events_total").inc(
                    tags={"kind": kind})
            logger.warning("anomaly detected: %s %s", kind, ev)

    def _tick_autopilot(self) -> None:
        """One autopilot reflex pass (monitor loop, §4n): hand the
        reflex engine every fleet event it has not seen (cursor over
        the same ring ``fleet_events`` serves, read head-side without
        an RPC), then tick."""
        with self._events_lock:
            events = [dict(e) for e in self._fleet_events
                      if e["seq"] > self._autopilot_cursor]
            self._autopilot_cursor = self._fleet_event_seq
        for ev in events:
            self._autopilot.observe(ev)
        self._autopilot.tick()

    def _capture_incident(self, kind: str, node_id: Optional[str],
                          detail: Optional[dict] = None) -> Optional[str]:
        """Write one bounded post-mortem bundle into
        ``<session>/incidents/<ts>_<kind>_<node8>/`` (DESIGN.md §4o):
        the offending node's recent profile window, an all-worker stack
        dump, the flight-recorder ring tails, and TSDB sparkline data
        around the event.  Monitor thread only (the detector pass and
        the autopilot's actuator callback both run there): one bundle
        per node per ``incident_dedup_s`` — a refire or the drain that
        follows reuses the existing id, so the bundle is written
        exactly once per episode.  Returns the bundle id (or None when
        the profiling plane is disabled / capture failed)."""
        if self._profile_store is None:
            return None
        now = time.monotonic()
        dedup_key = node_id or "cluster"
        prev = self._incident_recent.get(dedup_key)
        if prev is not None and \
                now - prev[0] < GLOBAL_CONFIG.incident_dedup_s:
            return prev[1]
        ts = time.time()
        iid = (time.strftime("%Y%m%d_%H%M%S", time.localtime(ts))
               + f"_{kind}_{(node_id or 'cluster')[:8]}")
        root = os.path.join(str(self.session.path), "incidents")
        inc_dir = os.path.join(root, iid)
        try:
            os.makedirs(inc_dir, exist_ok=True)
            bundle: Dict[str, dict] = {
                "meta.json": {"id": iid, "kind": kind,
                              "node_id": node_id, "ts": ts,
                              "detail": detail or {}}}
            # the node's last profile windows; cluster-wide fallback
            # when the node published nothing yet (short-lived victim)
            prof = self._profile_store.profile(window_s=600.0,
                                               node_id=node_id)
            if node_id is not None and not prof["samples"]:
                prof = self._profile_store.profile(window_s=600.0)
            bundle["profile.json"] = prof
            try:
                bundle["stacks.json"] = self._h_stack({"timeout": 2.0})
            except Exception:  # noqa: BLE001 - best-effort layer
                bundle["stacks.json"] = {"stacks": {}, "expected": 0}
            from ray_tpu_torch._private import flight_recorder
            try:
                bundle["flight.json"] = flight_recorder.collect(
                    self.session.path, tail=200)
            except Exception:  # noqa: BLE001 - best-effort layer
                bundle["flight.json"] = {}
            spark: Dict[str, list] = {}
            if self._tsdb is not None:
                for expr in (
                        "sum(rate(rtt_tasks_total[60s]))",
                        "quantile_over_time(0.99, "
                        "rtt_train_step_seconds[2m])"):
                    try:
                        spark[expr] = self._tsdb.query_range(
                            expr, start=ts - 600.0, end=ts, step=10.0)
                    except Exception:  # noqa: BLE001 - sparkline only
                        spark[expr] = []
            bundle["tsdb.json"] = spark
            for name, doc in bundle.items():
                with open(os.path.join(inc_dir, name), "w") as f:
                    json.dump(doc, f, indent=2, default=str)
        except Exception:  # noqa: BLE001 - capture must not kill GCS
            logger.exception("incident capture failed (%s, %s)",
                             kind, node_id)
            shutil.rmtree(inc_dir, ignore_errors=True)
            return None
        self._incident_recent[dedup_key] = (now, iid)
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_incidents_total").inc(tags={"kind": kind})
        logger.warning("incident bundle captured: %s", iid)
        # bounded disk: evict the oldest bundles past incident_max
        # (ids sort by their timestamp prefix)
        try:
            dirs = sorted(d for d in os.listdir(root)
                          if os.path.isdir(os.path.join(root, d)))
            while len(dirs) > max(1, GLOBAL_CONFIG.incident_max):
                shutil.rmtree(os.path.join(root, dirs.pop(0)),
                              ignore_errors=True)
        except OSError:
            pass
        return iid

    def _h_debug_incidents(self, msg: dict) -> dict:
        """List captured incident bundles (id + meta), or with ``id``
        fetch one bundle's files (`ray_tpu_torch debug incidents`)."""
        root = os.path.join(str(self.session.path), "incidents")
        iid = msg.get("id")
        if iid:
            if os.sep in iid or iid.startswith("."):
                raise ValueError(f"bad incident id {iid!r}")
            d = os.path.join(root, iid)
            if not os.path.isdir(d):
                return {"error": f"no incident {iid!r}"}
            files: Dict[str, str] = {}
            for name in sorted(os.listdir(d)):
                try:
                    with open(os.path.join(d, name), "rb") as f:
                        files[name] = f.read(4 * 1024 * 1024) \
                            .decode("utf-8", "replace")
                except OSError:
                    continue
            return {"id": iid, "files": files}
        out: List[dict] = []
        if os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                rec = {"id": name}
                try:
                    with open(os.path.join(root, name,
                                           "meta.json")) as f:
                        rec.update(json.load(f))
                except (OSError, ValueError):
                    pass
                out.append(rec)
        return {"incidents": out}

    def _h_autopilot_status(self, msg: dict) -> dict:
        """The autopilot's bounded action history + reflex counters
        (§4n) — what `ray_tpu_torch status` and the chaos tests read to
        assert the loop acted (and, just as important, that it did NOT
        act more than its rate limits allow)."""
        if self._autopilot is None:
            return {"enabled": False, "actions": [], "stats": {}}
        return {"enabled": True,
                "actions": self._autopilot.actions(
                    int(msg.get("limit") or 50)),
                "stats": self._autopilot.stats()}

    def _h_fleet_events(self, msg: dict) -> dict:
        """Cursor read of the fleet lifecycle feed: events with
        seq > ``since`` (bounded ring — a lagging subscriber may miss
        events and should reconcile against list_nodes)."""
        since = int(msg.get("since") or 0)
        with self._events_lock:
            events = [dict(e) for e in self._fleet_events
                      if e["seq"] > since]
            seq = self._fleet_event_seq
        return {"events": events, "seq": seq}

    def _h_elastic_event(self, msg: dict) -> dict:
        """The elasticity manager reports a re-mesh (or restart, or
        join) so `ray_tpu_torch status` / the dashboard can show the last
        transition without reaching into the manager's process."""
        rec = {"ts": time.time(),
               "group": msg.get("group"),
               "action": msg.get("action"),   # remesh | join | restart
               "generation": msg.get("generation"),
               "world_size": msg.get("world_size"),
               "detail": msg.get("detail") or {}}
        with self._events_lock:
            self._last_remesh = rec
        self._fleet_event("remesh", None, **{k: v for k, v in rec.items()
                                             if k != "ts"})
        return {}

    def _h_fleet_state(self, msg: dict) -> dict:
        """One-call fleet rollup for `ray_tpu_torch status` / state.py:
        nodes by lifecycle phase, the current demand backlog, and the last
        elastic re-mesh event (DESIGN.md §4j)."""
        demand = self._h_resource_demand({})
        now = time.monotonic()
        with self.lock:
            phases: Dict[str, int] = {}
            draining = []
            for n in self.nodes.values():
                phase = n.phase if n.alive else "terminating"
                phases[phase] = phases.get(phase, 0) + 1
                if phase == "draining":
                    draining.append({
                        "node_id": n.node_id,
                        "reason": n.drain_reason,
                        "deadline_in_s": (
                            round(n.drain_deadline - now, 3)
                            if n.drain_deadline else None)})
        with self._events_lock:
            last_remesh = dict(self._last_remesh) \
                if self._last_remesh else None
            seq = self._fleet_event_seq
        backlog = demand["task_shapes"] + demand["pg_bundles"]
        return {"phases": phases, "draining": draining,
                "demand_backlog": backlog,
                "demand_backlog_count": len(backlog),
                "last_remesh": last_remesh, "event_seq": seq}

    def _h_pick_oom_victim(self, msg: dict) -> dict:
        """A NodeAgent reports local memory pressure; the head picks the
        newest plain-task worker ON THAT NODE (policy stays central, the
        kill stays local to the pid's own namespace — reference: per-node
        MemoryMonitor inside the raylet).  The task is NOT marked here:
        the agent verifies the pid is one it owns and still alive, then
        calls confirm_oom_kill immediately before killing — a skipped kill
        (stale head view, already-exited proc) must not mislabel a later
        unrelated death as OOM."""
        from ray_tpu_torch._private.memory_monitor import pick_oom_victim
        victim = pick_oom_victim(self, node_id=msg["node_id"])
        if victim is None:
            return {"pid": None, "worker_id": None}
        w, spec = victim
        logger.warning(
            "node %s reports memory pressure (%.0f%%): designating newest "
            "task %s (worker %s pid=%s) for OOM kill",
            msg["node_id"][:8], 100 * msg.get("frac", 0),
            spec.get("name", spec["task_id"]), w.worker_id[:8], w.pid)
        return {"pid": w.pid, "worker_id": w.worker_id,
                "task_id": spec["task_id"]}

    def _h_confirm_oom_kill(self, msg: dict) -> dict:
        """The agent is about to kill this pid: mark the worker's current
        task so its death surfaces as a retriable OutOfMemoryError.  The
        task_id must still match the pick — the picked task may have
        completed and the pooled worker started an unrelated one during
        the pick→confirm window; that task must not be doomed as OOM."""
        with self.lock:
            w = self.workers.get(msg["worker_id"])
            if w is not None and w.pid == msg["pid"] \
                    and w.current_task is not None \
                    and w.current_task.get("task_id") == msg.get("task_id"):
                w.current_task["_oom_killed"] = True
                return {"ok": True}
        return {"ok": False}

    def _h_cluster_resources(self, msg: dict) -> dict:
        with self.lock:
            total: Dict[str, float] = defaultdict(float)
            avail: Dict[str, float] = defaultdict(float)
            for n in self.nodes.values():
                if not n.alive:
                    continue
                for k, v in n.resources_total.items():
                    total[k] += v
                for k, v in n.resources_avail.items():
                    avail[k] += v
            return {"total": dict(total), "available": dict(avail)}

    def _h_list_nodes(self, msg: dict) -> dict:
        with self.lock:
            return {"nodes": [{
                "node_id": n.node_id, "alive": n.alive,
                "phase": n.phase if n.alive else "terminating",
                "resources_total": n.resources_total,
                "resources_available": n.resources_avail,
                "num_workers": len(n.workers), "labels": n.labels,
            } for n in self.nodes.values()]}

    def _h_list_actors(self, msg: dict) -> dict:
        with self.lock:
            return {"actors": [{
                "actor_id": a.actor_id, "state": a.state, "name": a.name,
                "class_name": a.spec.get("class_name"),
                "node_id": (self.workers[a.worker_id].node_id
                            if a.worker_id in self.workers else None),
                "pid": (self.workers[a.worker_id].pid
                        if a.worker_id in self.workers else None),
            } for a in self.actors.values()]}

    def _h_list_tasks(self, msg: dict) -> dict:
        with self.lock:
            out = []
            for wid, spec in self.running.values():
                out.append({"task_id": spec["task_id"], "name": spec.get("name"),
                            "state": "RUNNING", "worker_id": wid})
            for spec in self.pending_tasks:
                out.append({"task_id": spec["task_id"], "name": spec.get("name"),
                            "state": "PENDING_SCHEDULING", "worker_id": None})
            seen = {id(sp) for sp in self.pending_tasks}
            for specs in self.dep_waiting.values():
                for spec in specs:
                    if id(spec) not in seen:
                        seen.add(id(spec))
                        out.append({"task_id": spec["task_id"],
                                    "name": spec.get("name"),
                                    "state": "PENDING_ARGS",
                                    "worker_id": None})
            return {"tasks": out}

    def _h_list_objects(self, msg: dict) -> dict:
        with self.lock:
            return {"objects": [{
                "object_id": oid, "state": m.state, "loc": m.loc,
                "size": m.size, "refcount": m.refcount,
            } for oid, m in self.objects.items()]}

    def _h_list_workers(self, msg: dict) -> dict:
        with self.lock:
            return {"workers": [{
                "worker_id": w.worker_id, "node_id": w.node_id, "pid": w.pid,
                "state": w.state, "actor_id": w.actor_id,
                "gpu": w.gpu_capable,
            } for w in self.workers.values()]}

    def _h_resource_demand(self, msg: dict) -> dict:
        """Unfulfilled resource shapes for the autoscaler: dep-ready pending
        tasks/actor creations that lack capacity, plus unplaced PG bundles
        (reference: autoscaler load_metrics fed by the GCS resource view).

        A pending spec that fits what a schedulable node has free waits
        for a worker there (a GPU worker importing torch, say), not for
        capacity: it is netted against that node's free resources, in
        pending order, and the node is listed in ``waiting_on``.  An
        autoscaler then neither launches another node for it nor reaps
        that node as idle while the worker boots."""
        with self.lock:
            free = {nid: dict(n.resources_avail)
                    for nid, n in self.nodes.items() if n.schedulable()}
            waiting = set()
            shapes = []
            for spec in self.pending_tasks:
                if self._deps_status(spec) != "ready":
                    continue
                req = self._task_resources(spec)
                nid = self._free_node_for(spec, req, free)
                if nid is None:
                    shapes.append(req)
                else:
                    waiting.add(nid)
            for spec in self.infeasible_tasks:
                shapes.append(self._task_resources(spec))
            bundles = []
            for pg in self.pgs.values():
                if pg.state == PENDING:
                    for i, b in enumerate(pg.bundles):
                        if pg.assignment[i] is None:
                            bundles.append(dict(b))
            return {"task_shapes": shapes, "pg_bundles": bundles,
                    "waiting_on": sorted(waiting)}

    def _free_node_for(self, spec: dict, req: Dict[str, float],
                       free: Dict[str, Dict[str, float]]) -> Optional[str]:
        """Lock held.  The node whose entry in ``free`` holds ``req`` for
        this spec's strategy (consumed there), else None.  Work bound to a
        placement group stays demand, as the reference counts it."""
        strategy = spec.get("scheduling_strategy") or "DEFAULT"
        if isinstance(strategy, dict) and \
                strategy.get("type") == "placement_group":
            return None
        candidates = list(free)
        if isinstance(strategy, dict) and \
                strategy.get("type") == "node_affinity":
            pinned = [strategy["node_id"]] if strategy["node_id"] in free \
                else []
            candidates = pinned + ([n for n in candidates if n not in pinned]
                                   if strategy.get("soft") else [])
        for nid in candidates:
            avail = free[nid]
            if all(avail.get(k, 0.0) >= v - 1e-9 for k, v in req.items()):
                for k, v in req.items():
                    avail[k] = avail.get(k, 0.0) - v
                return nid
        return None

    def _resolve_object_bytes(self, oid: str):
        """One object-resolution ladder for the cross-host data path:
        → ("inline", bytes) | ("slab", bytes) | ("shm", Path) | None."""
        with self.lock:
            meta = self.objects.get(oid)
            if meta is None or meta.state != READY:
                return None
            loc, data = meta.loc, meta.data
        if loc == "remote":
            # head acting as the RELAY FALLBACK for a puller that cannot
            # reach the holder host (hub-spoke): pull the spool copy into
            # the local store once, then serve it like any shm object
            if not self._pull_remote_local(oid):
                return None
            with self.lock:
                meta = self.objects.get(oid)
                if meta is None or meta.state != READY:
                    return None
                loc, data = meta.loc, meta.data
        if loc == "inline":
            return ("inline", data)
        if loc == "slab":
            blob = self.slab.get(oid) if self.slab else None
            return None if blob is None else ("slab", blob)
        self.store.restore(oid)
        from ray_tpu_torch._private.shm_store import _seg_path
        return ("shm", _seg_path(oid))

    def _pull_remote_local(self, oid: str) -> bool:
        """Pull a remote-spooled object into the head's shm store
        (concurrent pulls of the same oid coalesce — reference:
        PullManager dedup)."""
        with self.lock:
            meta = self.objects.get(oid)
            if meta is None or meta.loc != "remote":
                return meta is not None and meta.state == READY
            node = self.nodes.get(meta.node_id)
            addr = node.data_addr if node else None
            ev = self._remote_pulls.get(oid)
            leader = ev is None
            if leader:
                ev = self._remote_pulls[oid] = threading.Event()
        if not leader:
            # rtlint: blocks-ok(follower of a coalesced remote pull:
            # parks its own caller only, 120s literal cap, and the
            # leader settles or times out the shared event first)
            ev.wait(timeout=120)
            with self.lock:
                m = self.objects.get(oid)
                return m is not None and m.state == READY \
                    and m.loc != "remote"
        try:
            if addr is None:
                return False
            from ray_tpu_torch._private.shm_store import _seg_path
            if protocol.parse_tcp_addr(addr) is None:
                return False
            with self.lock:
                m = self.objects.get(oid)
                size = m.size if m is not None else None
            wire = self._data_pool.pull(addr, oid, size=size)
            seg = _seg_path(oid)
            tmp = seg.with_name(seg.name + ".pull")
            tmp.write_bytes(wire)
            os.replace(tmp, seg)
            with self.cv:
                self.store.adopt(oid, len(wire))
                meta = self.objects.get(oid)
                if meta is not None:
                    meta.loc = "shm"
                    meta.size = len(wire)
                    meta.node_id = self.head_node_id
                    if meta.state == READY:
                        self._publish_sealed_locked(oid, READY, "shm", None,
                                                    len(wire))
            # the head owns the object now — drop the holder's spool copy
            # or relay-fallback traffic accumulates dead files on A
            threading.Thread(target=self._data_pool.delete_batch,
                             args=(addr, [oid]),
                             daemon=True, name="gcs-peer-delete-one").start()
            return True
        except (OSError, EOFError, FileNotFoundError, ConnectionError):
            return False
        finally:
            with self.lock:
                self._remote_pulls.pop(oid, None)
            ev.set()

    def _h_fetch_object(self, msg: dict) -> dict:
        """Object bytes through the control plane — the cross-host data
        path (a remote host cannot mmap this machine's /dev/shm).  Objects
        above ``transfer_chunk_bytes`` answer ``{"chunked": True, size}``;
        the caller then streams ``fetch_chunk`` requests (reference:
        ObjectManager chunked transfer, SURVEY.md §2.1) so the control
        plane never carries one monolithic multi-hundred-MB message."""
        chunk = GLOBAL_CONFIG.transfer_chunk_bytes
        got = self._resolve_object_bytes(msg["object_id"])
        if got is None:
            return {"data": None}
        loc, payload = got
        try:
            if loc == "shm":
                size = payload.stat().st_size
                if size > chunk:
                    return {"chunked": True, "size": size}
                return {"data": payload.read_bytes()}
        except (FileNotFoundError, OSError):
            return {"data": None}
        if loc != "inline" and len(payload) > chunk:
            return {"chunked": True, "size": len(payload)}
        return {"data": payload}

    def _h_put_chunk(self, msg: dict) -> dict:
        """One chunk of a large object being uploaded from a remote host
        (the inbound half of chunked transfer: remote task/actor results
        and remote ``put``s).  Chunks pwrite straight into the object's
        tmpfs segment at their offset — the daemon never holds the whole
        object in its heap (that would defeat the point of chunking).
        The uploader references the sealed segment with loc="shm"."""
        oid, off, total = msg["object_id"], msg["offset"], msg["total"]
        data = msg["data"]
        if total > self.store.capacity:
            raise ValueError(
                f"chunked upload of {total} bytes exceeds store capacity "
                f"{self.store.capacity}")
        from ray_tpu_torch._private.shm_store import _seg_path
        with self.lock:
            st = self._staging.get(oid)
            if st is None:
                fd = os.open(str(_seg_path(oid)),
                             os.O_CREAT | os.O_RDWR, 0o600)
                try:
                    os.ftruncate(fd, max(total, 1))
                except OSError:
                    # ENOSPC on a full tmpfs: the fd must not outlive
                    # the failed reservation (one leaked fd per retried
                    # upload chunk adds up to EMFILE on a busy head)
                    os.close(fd)
                    raise
                st = {"fd": fd, "offsets": set(), "got": 0,
                      "ts": time.time()}
                self._staging[oid] = st
            os.pwrite(st["fd"], data, off)
            # Completion tracks *covered offsets*, not cumulative bytes: a
            # retried/duplicated chunk must not double-count and seal a
            # segment that still has holes.
            if off not in st["offsets"]:
                st["offsets"].add(off)
                st["got"] += len(data)
            st["ts"] = time.time()
            done = st["got"] >= total
            if done:
                os.close(st["fd"])
                self._staging.pop(oid, None)
        return {"done": done}

    def _h_fetch_chunk(self, msg: dict) -> dict:
        """One chunk of a large object (offset/length pread — stateless,
        so retries and concurrent pullers need no server-side sessions)."""
        offset, length = msg["offset"], msg["length"]
        got = self._resolve_object_bytes(msg["object_id"])
        if got is None:
            return {"data": None}
        loc, payload = got
        if loc == "shm":
            try:
                with open(payload, "rb") as f:
                    return {"data": os.pread(f.fileno(), length, offset)}
            except (FileNotFoundError, OSError):
                return {"data": None}
        return {"data": bytes(memoryview(payload)[offset:offset + length])}

    def _h_store_stats(self, msg: dict) -> dict:
        return {"stats": self.store.stats()}

    def _h_ingest_events(self, msg: dict) -> dict:
        """Timeline events from processes with no task conn (drivers):
        span traces, merged device traces (util/tracing.py)."""
        with self._events_lock:
            self.events.extend(msg["events"])
        return {}

    def _h_timeline(self, msg: dict) -> dict:
        with self._events_lock:
            return {"events": list(self.events)}

    def _h_stack(self, msg: dict) -> dict:
        """Stack dumps from every live worker (reference: ``ray stack``
        via py-spy; here an in-process all-threads snapshot).  Each call
        collects into its own request record (concurrent calls don't
        clobber each other), waits on the cv (no polling), and only
        counts workers whose dump request was actually delivered."""
        collected: Dict[str, str] = {}
        with self.cv:
            self._stack_reqs.append(collected)
            targets = [w for w in self.workers.values()
                       if (w.state in ("idle", "busy", "actor")
                           and w.task_conn is not None)
                       or (w.state in ("starting", "actor")
                           and self.nodes.get(w.node_id) is not None
                           and self.nodes[w.node_id].raylet_conn
                           is not None)]
        try:
            targets = [w for w in targets
                       if self._push_worker_ctl(w, {"kind": "dump_stack"})]
            deadline = time.time() + float(msg.get("timeout", 3.0))
            with self.cv:
                while len(collected) < len(targets):
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        break
                    self.cv.wait(timeout=min(0.5, remaining))
        finally:
            with self.cv:
                try:
                    self._stack_reqs.remove(collected)
                except ValueError:
                    pass
        return {"stacks": dict(collected), "expected": len(targets)}

    def _h_debug_dump(self, msg: dict) -> dict:
        """Flight-recorder dump for every process of this session
        (`ray_tpu_torch debug dump`).  Rings are shared-mmap files in the
        session dir, so dead (SIGKILLed) processes' recent frames read
        exactly like live ones — no cooperation needed."""
        from ray_tpu_torch._private import flight_recorder
        return {"procs": flight_recorder.collect(
            self.session.path, tail=int(msg.get("tail", 200))),
            "raylets": self._h_raylet_table({})["raylets"]}

    def _h_ping(self, msg: dict) -> dict:
        return {"pong": True, "time": time.time()}

    # ------------------------------------------------------------------ close
    def shutdown(self) -> None:
        global _INPROC_SERVER
        if _INPROC_SERVER is self:
            _INPROC_SERVER = None
        self._shutdown = True
        if self._autopilot is not None:
            # stop the supervised standby FIRST: a clean cluster stop
            # must not leave a warm standby to promote over the corpse
            try:
                self._autopilot.actuator.shutdown()
            except Exception:  # noqa: BLE001 - child already gone
                logger.debug("autopilot shutdown failed", exc_info=True)
        with self.cv:
            # tell attached raylets to tear their nodes down cleanly
            for n in self.nodes.values():
                if n.raylet_conn is not None:
                    n.push_raylet({"kind": "raylet_stop", "rid": None})
            procs = [w.proc for w in self.workers.values() if w.proc is not None]
            # proc-less workers (reattached after a head restart) have no
            # pid here to signal — tell them to stop so they don't sit in
            # the GCS-reconnect grace loop after a CLEAN shutdown
            for w in self.workers.values():
                if w.proc is None and w.state not in ("driver", "dead"):
                    try:
                        self._push_worker_ctl(w, {"kind": "stop_worker"})
                    except Exception:  # noqa: BLE001 - already gone
                        pass
            self.cv.notify_all()
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + 2
        for p in procs:
            try:
                p.wait(timeout=max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
        try:
            self._listener.close()
        except OSError:
            pass
        self._data_pool.close_all()
        if self._repl_hub is not None:
            # discharge the WAL fd and every standby conn (the runtime
            # resource oracle asserts this below)
            self._repl_hub.close()
        self.store.shutdown()
        if self.slab is not None:
            self.slab.close()
        self.session.unregister()
        # discharge the flight recorder's mmap (the ring FILE stays —
        # it is the crash artifact); must precede the leak assert below
        from ray_tpu_torch._private import flight_recorder
        flight_recorder.close()
        # stop the head's sampling profiler thread (daemon, but a clean
        # shutdown joins it so no sampler races interpreter teardown)
        from ray_tpu_torch.util import profiler as profiler_mod
        profiler_mod.close()
        # leak oracle: a CLEAN head shutdown must leave zero net
        # tracked resources (the driver's Worker.shutdown ran first —
        # __init__.shutdown() orders worker before head)
        from ray_tpu_torch._private import resource_sanitizer
        resource_sanitizer.assert_clean_at_shutdown("gcs-shutdown")
