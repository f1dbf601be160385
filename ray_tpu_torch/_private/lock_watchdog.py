"""Canonical lock-order DAGs + an opt-in runtime lock-order watchdog.

DESIGN.md §4c documents the GCS locking discipline in prose; this module
is its machine-readable form and the ONE source of truth for lock order:

- ``tools/rtlint`` (the static analyzer, DESIGN.md §4d) imports
  ``GCS_LOCK_DAG`` / ``WORKER_LOCK_DAG`` and fails the build on any
  acquisition edge in ``gcs.py`` / ``worker.py`` outside them;
- ``RTT_LOCK_WATCHDOG=1`` wraps the live GCS locks in
  :class:`WatchdogLock`, which records actual acquisition stacks and
  asserts the SAME DAG at runtime — the chaos suite's dynamic oracle for
  the static rules (tests/test_gcs_locking.py).

An acquisition of ``inner`` while holding ``outer`` is legal iff
``inner`` is reachable from ``outer`` in the DAG (or ``outer == inner``:
RLock reentry cannot deadlock).  Leaf locks have empty successor sets —
nothing may be acquired under them.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Set, Tuple

# GcsServer lock domains (DESIGN.md §4c).  Canonical names are the
# attribute names, with ``cv`` folded into ``lock`` (the Condition wraps
# the same RLock).  ``task_conn_lock``/``ctl_conn_lock`` are per-
# WorkerState but are acquired by GCS threads holding the global lock
# (worker pushes happen inside the scheduler's critical section).
GCS_LOCK_DAG: Dict[str, Set[str]] = {
    "_persist_lock": {"lock"},   # snapshot writer: capture under the
    #                              global lock, write under persist only
    "lock": {"_waiter_lock", "_kv_lock", "_events_lock",
             "_peer_delete_lock", "task_conn_lock", "ctl_conn_lock",
             "raylet_conn_lock"},
    "_waiter_lock": set(),
    "_kv_lock": set(),
    "_events_lock": set(),
    "_dedup_lock": set(),
    "_peer_delete_lock": set(),
    "task_conn_lock": set(),
    "ctl_conn_lock": set(),
    # per-NodeState raylet lease-channel push lock: lease_grant /
    # lease_revoke pushes ride the scheduler's critical section exactly
    # like worker task pushes (bounded local-pipe sends, §4c)
    "raylet_conn_lock": set(),
}

# Leaf locks whose critical sections must stay O(dict op): calling a
# blocking primitive (socket send/recv, condition wait, sleep, file I/O)
# while holding one is an rtlint error.  ``_persist_lock`` is excluded
# by design — it IS the snapshot writer's file-I/O ordering lock — and
# the conn locks are excluded because pushes deliberately ride them
# (bounded local-pipe sends, documented in §4c).
GCS_NOBLOCK_LOCKS: Set[str] = {
    "_waiter_lock", "_kv_lock", "_events_lock", "_dedup_lock",
    "_peer_delete_lock"}

# Condition → underlying-lock aliases: ``with self.cv`` acquires
# ``lock``; ``cv.wait()`` releases it (so a wait is only "blocking while
# holding X" for the OTHER locks held at that point).
GCS_CV_ALIASES: Dict[str, str] = {"cv": "lock"}

# Worker (client-side) lock domains — see the declaration comments in
# worker.py for the ordering arguments.
WORKER_LOCK_DAG: Dict[str, Set[str]] = {
    "_release_lock": {"_submit_lock"},       # _drain_pending_pins
    # _drain_submits pop→send, and the send may first-dial the shared
    # oneway channel (rpc_oneway's lazy init) while serialized; the
    # raylet release route sits on the same rpc_oneway path (the
    # submit_batch kind never takes it, but the helper edge must be legal)
    "_submit_send_lock": {"_submit_lock", "_oneway_init_lock",
                          "_raylet_ref_lock"},
    "_submit_lock": set(),
    "_local_lock": set(),
    "_actor_chan_lock": set(),
    "_pull_lock": set(),
    "_owned_lock": set(),
    "_oneway_init_lock": set(),
    "_task_conn_lock": set(),
    # local-raylet release routing (one conn, lazily dialed + sent
    # under this lock; a bounded unix-pipe send by design)
    "_raylet_ref_lock": set(),
    # a leaf: guards _in_user_fn / _cancel_pending, the handoff between
    # a cancel arriving on the control thread and the exec thread
    # entering or leaving user code; held for a flag flip or a dict op,
    # with no other lock taken inside (the async raise into the exec
    # thread happens under it and takes no lock)
    "_cancel_lock": set(),
}

WORKER_NOBLOCK_LOCKS: Set[str] = {
    "_release_lock", "_submit_lock", "_local_lock", "_owned_lock",
    "_pull_lock"}

WORKER_CV_ALIASES: Dict[str, str] = {"_local_cv": "_local_lock"}

# Data-plane (data_plane.py) lock domains — all leaves, one per class:
# the server's serving-counter lock and the connection pool's table
# lock.  Neither is ever held across I/O or together with another lock
# (conn dial/close and frame streaming happen strictly outside them).
DATA_PLANE_LOCK_DAG: Dict[str, Set[str]] = {
    "_stats_lock": set(),
    "_lock": set(),
}

DATA_PLANE_CV_ALIASES: Dict[str, str] = {}

# Shm object store (shm_store.py): one lock guards the accounting
# tables (_sealed/_unsealed/_spilled/_used).  Spill file moves happen
# under it by design (eviction must be atomic with the accounting), so
# it is not a no-block leaf.
SHM_STORE_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": set(),
}

SHM_STORE_CV_ALIASES: Dict[str, str] = {}

# serve/llm paged KV cache (kv_cache.py): one leaf lock guards the
# allocator tables (free list, block tables, fills, refcounts).  Pool
# byte writes (scatter/write_token) are engine-loop-owned and happen
# OUTSIDE it by design — the lock protects placement, not payload.
LLM_KV_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": set(),
}

LLM_KV_CV_ALIASES: Dict[str, str] = {}

# serve/llm engine (engine.py): one leaf lock guards the cross-thread
# handoff state (inbox/attached queues, per-request stream registry).
# Scheduler and cache-payload state are engine-loop-owned (no lock);
# the cache's own leaf lock is never taken while holding this one.
LLM_ENGINE_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": set(),
}

LLM_ENGINE_CV_ALIASES: Dict[str, str] = {}

# Raylet (raylet.py, DESIGN.md §4i): ``_lock`` guards the local
# scheduler tables (queue, slots, done batch, ref nets, stats); worker
# pushes deliberately ride it through the per-slot conn locks (bounded
# local-pipe sends, the same §4c argument as GCS task pushes).
# ``_up_lock`` serializes upstream lease-channel sends and is a leaf:
# flushers collect under _lock, send under _up_lock, never nested.
RAYLET_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": {"conn_lock", "ctl_conn_lock"},
    "_up_lock": set(),
    "conn_lock": set(),
    "ctl_conn_lock": set(),
}

RAYLET_CV_ALIASES: Dict[str, str] = {}

# Fleet elasticity (elastic/, DESIGN.md §4j): the event subscriber's
# ``_cursor_lock`` is a no-block leaf guarding the feed cursor shared
# between the polling thread and inline poll_once callers; the RPC and
# subscriber callbacks run strictly outside it.  The manager itself is
# single-writer by design (transitions happen only on the fit thread)
# and holds no locks.
ELASTIC_LOCK_DAG: Dict[str, Set[str]] = {
    "_cursor_lock": set(),
}

ELASTIC_NOBLOCK_LOCKS: Set[str] = {"_cursor_lock"}

ELASTIC_CV_ALIASES: Dict[str, str] = {}

# GCS replication (replication.py, DESIGN.md §4l): both classes keep
# ONE no-block leaf lock.  The hub's ``_lock`` guards the WAL seq
# counter, the record buffer, and the standby adoption queue — GCS
# handler threads append under it in O(1) while holding GCS locks (the
# cross-domain edge mirrors lock -> _events_lock); every file write,
# fsync, and standby send happens on the single drain thread with no
# lock held.  The standby's ``_lock`` guards the applied tables +
# stream cursor; the stream recv and the promote file I/O run outside
# it (snapshot_state copies the tables out under it).
REPL_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": set(),
    "_promote_lock": {"_lock"},  # promote copies the tables under _lock
}

REPL_NOBLOCK_LOCKS: Set[str] = {"_lock"}

REPL_CV_ALIASES: Dict[str, str] = {}

# Fleet autopilot (elastic/autopilot.py, DESIGN.md §4n): one no-block
# leaf lock guards the bounded action history + per-(kind,outcome)
# counters shared between the ticking GCS monitor thread and
# ``autopilot_status`` RPC readers.  Every other piece of reflex state
# (rate window, per-node cooldown ledger, prewarm set) is single-writer
# — only the tick thread touches it — and actuator calls (which may
# take GCS locks) run with NO autopilot lock held.
AUTOPILOT_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": set(),
}

AUTOPILOT_NOBLOCK_LOCKS: Set[str] = {"_lock"}

AUTOPILOT_CV_ALIASES: Dict[str, str] = {}

# Metrics TSDB (util/tsdb.py, DESIGN.md §4k): one no-block leaf lock
# guards the series table, rings, and ingest counters.  Critical
# sections are O(dict/ring op); queries copy samples out under it and
# evaluate outside; the GCS calls ingest/query with NONE of its own
# locks held (the ingest hook in _h_kv_put runs after _kv_lock is
# released, the detector tick runs lock-free in the monitor loop).
TSDB_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": set(),
}

TSDB_NOBLOCK_LOCKS: Set[str] = {"_lock"}

TSDB_CV_ALIASES: Dict[str, str] = {}

# Profiling plane (util/profiler.py, DESIGN.md §4o): one no-block leaf
# lock guards BOTH halves — the sampler's folded-stack delta table
# (written by the sampling daemon, swapped out by the publisher) and
# the head ProfileStore's per-process window rings (written at receipt
# time, copied out by profile_query readers).  Critical sections are
# O(dict op); stack folding, JSON parsing, merging and diffing all run
# outside the leaf.
PROFILER_LOCK_DAG: Dict[str, Set[str]] = {
    "_lock": set(),
}

PROFILER_NOBLOCK_LOCKS: Set[str] = {"_lock"}

PROFILER_CV_ALIASES: Dict[str, str] = {}


def reachable(dag: Dict[str, Set[str]]) -> Dict[str, Set[str]]:
    """Transitive closure: lock → every lock legally acquirable under it."""
    closure: Dict[str, Set[str]] = {}
    for start in dag:
        seen: Set[str] = set()
        stack = list(dag.get(start, ()))
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(dag.get(n, ()))
        closure[start] = seen
    return closure


class LockOrderViolation(RuntimeError):
    """A thread acquired locks in an order outside the documented DAG."""


class WatchdogState:
    """Shared per-server watchdog bookkeeping (one per wrapped GcsServer)."""

    def __init__(self, dag: Dict[str, Set[str]]):
        self.dag = dag
        self.reach = reachable(dag)
        self._tls = threading.local()
        self._mu = threading.Lock()
        # (outer, inner) acquisition edges actually observed at runtime
        self.edges: Set[Tuple[str, str]] = set()
        # lock name → stack of the most recent acquisition (diagnostics)
        self.last_stacks: Dict[str, List[str]] = {}
        self.violations: List[str] = []

    def held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def on_acquire(self, name: str) -> None:
        """Validate ``name`` against every lock this thread holds; raise
        on a DAG violation (recording both stacks first)."""
        held = self.held()
        if name in held:
            return  # RLock reentry: cannot deadlock, records no edge
        bad = [h for h in held if name not in self.reach.get(h, set())]
        stack = traceback.format_stack()[:-2]
        with self._mu:
            for h in held:
                self.edges.add((h, name))
            self.last_stacks[name] = stack
            if bad:
                prior = self.last_stacks.get(bad[0], [])
                msg = (f"lock order violation: acquiring {name!r} while "
                       f"holding {held!r} (edge {bad[0]!r} -> {name!r} is "
                       f"outside the documented DAG)\n--- acquiring "
                       f"thread stack ---\n{''.join(stack)}--- last "
                       f"{bad[0]!r} acquisition ---\n{''.join(prior)}")
                self.violations.append(msg)
        if bad:
            raise LockOrderViolation(msg)

    def push(self, name: str) -> None:
        self.held().append(name)

    def pop(self, name: str) -> None:
        held = self.held()
        # release order may differ from acquire order (with-block nesting
        # guarantees LIFO, but .release() forms need not) — remove the
        # innermost matching entry
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def pop_all(self, name: str) -> int:
        """Remove every entry for ``name`` (Condition._release_save on an
        RLock releases all recursion levels at once)."""
        held = self.held()
        n = len(held)
        held[:] = [h for h in held if h != name]
        return n - len(held)


class WatchdogLock:
    """Wrap a Lock/RLock: assert DAG order on acquire, track held state.

    Forwards ``_release_save`` / ``_acquire_restore`` / ``_is_owned`` so
    ``threading.Condition`` (cv.wait) keeps working on a wrapped RLock —
    a wait fully releases the lock (held-state popped) and restores it
    on wake (pushed back).
    """

    def __init__(self, inner, name: str, state: WatchdogState):
        self._inner = inner
        self.name = name
        self._state = state

    # Contended acquires above this land in the flight recorder: a
    # post-mortem ring then shows WHICH lock the process was starving
    # on in its final seconds (DESIGN.md §4h).
    SLOW_WAIT_S = 0.05

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._state.on_acquire(self.name)
        import time as _time
        # fold this thread under a synthetic ``waiting:<lock>`` frame in
        # the sampling profiler for the duration of the inner acquire —
        # lock contention then shows up in flames (DESIGN.md §4o)
        from ray_tpu_torch.util import profiler as _profiler
        _profiler.note_lock_wait(self.name)
        t0 = _time.monotonic()
        try:
            got = self._inner.acquire(blocking, timeout)
        finally:
            _profiler.clear_lock_wait()
        waited = _time.monotonic() - t0
        if waited > self.SLOW_WAIT_S:
            from ray_tpu_torch._private import flight_recorder
            if flight_recorder.enabled():
                flight_recorder.record(
                    "lockwait", f"{self.name} {waited * 1e3:.1f}ms")
        if got:
            self._state.push(self.name)
        return got

    def release(self) -> None:
        self._state.pop(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # --- threading.Condition integration -------------------------------
    def _release_save(self):
        n = self._state.pop_all(self.name)
        return (self._inner._release_save(), n)

    def _acquire_restore(self, saved) -> None:
        inner_state, n = saved
        self._inner._acquire_restore(inner_state)
        for _ in range(n):
            self._state.push(self.name)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def watchdog_enabled() -> bool:
    return os.environ.get("RTT_LOCK_WATCHDOG") == "1"


def wrap_gcs_locks(srv) -> WatchdogState:
    """Wrap a GcsServer's lock domains in watchdog locks (call right
    after the locks are created, BEFORE any server thread starts).  The
    Condition is rebuilt around the wrapped global lock so cv.wait
    releases/restores through the watchdog."""
    state = WatchdogState(GCS_LOCK_DAG)
    srv.lock = WatchdogLock(srv.lock, "lock", state)
    srv.cv = threading.Condition(srv.lock)
    for attr in ("_waiter_lock", "_kv_lock", "_events_lock",
                 "_dedup_lock", "_persist_lock", "_peer_delete_lock"):
        setattr(srv, attr, WatchdogLock(getattr(srv, attr),
                                        attr, state))
    srv._lock_watchdog = state
    return state


# ======================================================================
# Blocking-flow policy (DESIGN.md §4p) — the machine-readable side of
# tools/rtlint's ``blocking`` pass, mirroring how the lock DAGs above
# back the ``locks`` pass.  Three tables:
#
# - ``REACTOR_SAFE``: functions the item-1 reactor will call inline on
#   the event loop.  rtlint proves each is TRANSITIVELY non-blocking
#   over the whole in-repo call graph (rule ``block-reactor``) — seeded
#   with the wire codec, frame parse, and the shm ``_sealed``-table
#   read paths, and grown as handlers are made reactor-ready.
# - ``BLOCK_BOUNDS``: every site wrapped in :func:`bounded_block`
#   declares its worst-case bound (seconds) here.  rtlint asserts the
#   call sites and this table agree exactly (``block-bound-undeclared``
#   / ``block-bound-dead``), and the runtime oracle below asserts the
#   declared bound actually holds under the chaos suite.
# - the per-context *allowed blocking classes* live in
#   ``tools/rtlint/blocking.py`` next to the context list (they
#   parameterize the analysis, not the runtime).

# Dotted as ``module.func`` / ``module.Class.method`` relative to
# ray_tpu_torch/_private (the reactor core lives there).
REACTOR_SAFE: Set[str] = {
    # wire codec + frame parse: encode/decode must run inline on the
    # reactor between readiness callbacks
    "wire.rtmsg_dumps",
    "wire.rtmsg_loads",
    "wire.encode_frame",
    "wire.decode_frame",
    "wire.decode_frame_ex",
    "wire.bulk_pack_header",
    "wire.bulk_unpack_header",
    "wire.negotiate_version",
    # shm ``_sealed``-table read paths: O(dict op) under leaf locks,
    # safe to answer from the loop (get_meta/peek fast path)
    "shm_store.ShmObjectStore.location",
    "shm_store.ShmObjectStore.touch",
    "shm_store.ShmObjectStore.stats",
    "shm_store.ShmObjectStore.exists_in_shm",
}

# site name -> worst-case block duration in seconds.  A site's bound is
# the DECLARED contract: the static pass pins each ``bounded_block``
# call to exactly one row here, and ``RTT_BLOCK_WATCHDOG=1``
# raises :class:`BlockBoundViolation` when a wrapped site overruns
# ``bound * RTT_BLOCK_WATCHDOG_SLACK``.  Keep bounds honest-worst-
# case (timeout argument + scheduling slop), not aspirational.
BLOCK_BOUNDS: Dict[str, float] = {
    # protocol.tunnel_connect: bounded handshake poll before the first
    # recv (proxy answers immediately; 30s covers a GC-pausing head)
    "protocol.tunnel_connect.handshake": 30.0,
    # gcs._dedup_begin: winner-completion wait for a duplicate two-way
    # mutation (ev.wait(30.0) literal)
    "gcs.dedup_wait": 30.0,
    # raylet._reconnect_upstream: one jittered backoff sleep
    # (backoff_delays cap=0.5 base=0.05; 1s absorbs jitter + scheduler
    # lag)
    "raylet.reconnect_backoff": 1.0,
    # raylet._done_flush_loop: batch-coalescing tick (wait(1.0) literal)
    "raylet.done_flush_tick": 1.0,
    # replication hub ticker: _event.wait(hb_period); dynamic bound
    # passed at the site, this row is the config-default ceiling
    "repl.hub_tick": 60.0,
    # standby stream poll: conn.poll(gcs_standby_timeout_s) — a poll
    # overrun means heartbeats stopped AND the poll itself wedged
    "repl.stream_poll": 60.0,
}


class BlockBoundViolation(RuntimeError):
    """A statically-declared-bounded blocking site overran its bound."""


def block_watchdog_enabled() -> bool:
    return os.environ.get("RTT_BLOCK_WATCHDOG") == "1"


def _block_slack() -> float:
    try:
        return float(os.environ.get("RTT_BLOCK_WATCHDOG_SLACK",
                                    "1.5"))
    except ValueError:
        return 1.5


# site -> [count, total_s, max_s]; guarded by: _BLOCK_STATS_LOCK
_BLOCK_STATS: Dict[str, List[float]] = {}
_BLOCK_STATS_LOCK = threading.Lock()


def block_stats() -> Dict[str, Tuple[int, float, float]]:
    """{site: (count, total_s, max_s)} observed since the last reset."""
    with _BLOCK_STATS_LOCK:
        return {k: (int(v[0]), v[1], v[2])
                for k, v in _BLOCK_STATS.items()}


def reset_block_stats() -> None:
    with _BLOCK_STATS_LOCK:
        _BLOCK_STATS.clear()


# ======================================================================
# XLA hygiene policy (DESIGN.md §4q) — the machine-readable side of
# tools/rtlint's ``jaxlint`` passes, and the declared contract the
# ``RTT_XLA_WATCHDOG=1`` runtime oracle (xla_watchdog.py) enforces.
# Same identity discipline as REACTOR_SAFE / BLOCK_BOUNDS above: the
# static passes parse THESE tables, the runtime oracle imports them,
# so neither can drift.

# Step paths: the compute-plane functions that make up a steady-state
# step — the train step body, the LLM prefill/decode programs and the
# engine's batching step, and the decomposed-collective ring bodies.
# Quals are ``module:qualname`` over the jaxlint call-graph scope
# (module key = file stem, nested defs dotted — same scheme as the
# blocking pass).  jaxlint proves each is transitively free of host
# syncs (``host-sync``) and scans everything reachable from them for
# retrace hazards (``retrace-*``).
STEP_PATHS: Set[str] = {
    # the one-jit distributed train step (forward+backward+optimizer)
    "spmd:build_train_program._step",
    # LLM serving programs (bucketed jits) + the engine batching step
    "gpt2:forward_prefill",
    "gpt2:forward_decode",
    "llama:forward_prefill",
    "llama:forward_decode",
    "engine:LLMEngine.step",
    # decomposed collective-matmul rings + the KV ring (§4m): a host
    # sync inside a ring body would serialize the whole ring
    "collective_matmul:all_gather_matmul",
    "collective_matmul:matmul_reduce_scatter",
    "ring_attention:ring_attention",
}

# Donating callables: bound name of a ``jax.jit(..., donate_argnums=)``
# result -> the argnums that are ALWAYS donated.  jaxlint checks the
# jit sites against this map both directions (``donate-undeclared`` /
# ``donate-dead``), diffs literal donate_argnums against it
# (``donate-drift``), and flags any read of a donated binding after a
# call to the named callable (``donate-use-after``).  ``step_fn``
# donates the whole TrainState (argnum 0) — params AND both Adam
# moments alias their outputs; the optional ``donate_batch`` argnum is
# deliberately NOT declared (callers that enable it feed fresh batches
# and the static rule covers the unconditional donation only).
DONATED: Dict[str, Tuple[int, ...]] = {
    "step_fn": (0,),
}

# compile_budget site -> declared steady-state compile ceiling (count
# of distinct XLA programs one region owner may build).  The runtime
# oracle raises :class:`XlaHygieneViolation` (xla_watchdog.py) when a
# site's owner exceeds ``budget + RTT_XLA_WATCHDOG_WARMUP``;
# jaxlint pins each ``compile_budget("<site>")`` call to exactly one
# row here (``compile-budget-undeclared`` / ``compile-budget-dead``).
# Keep ceilings honest: the bucket-table length for the bucketed LLM
# programs (a site override passes the live ``len(buckets)``), one
# program for the train step.
COMPILE_BUDGETS: Dict[str, int] = {
    # spmd.build_train_program: one program per SpmdProgram, ever —
    # shapes are pinned by the batch sharding, a second compile in
    # steady state means a retrace hazard escaped jaxlint
    "train.step": 1,
    # model_runner: one program per declared length/batch bucket
    # (site override passes len(cfg.prefill_len_buckets) /
    # len(cfg.decode_batch_buckets); these rows are the config-default
    # ceilings)
    "llm.prefill": 6,
    "llm.decode": 5,
}


class bounded_block:
    """Context manager wrapping one declared-bounded blocking site.

    ``with lw.bounded_block("gcs.dedup_wait"): ev.wait(30.0)``

    Zero-cost no-op unless ``RTT_BLOCK_WATCHDOG=1``.  When enabled:
    folds the blocked thread under a synthetic ``waiting:block:<site>``
    frame in the sampling profiler (same namespace as lock waits,
    DESIGN.md §4o), records the actual duration, and raises
    :class:`BlockBoundViolation` on exit if the site overran its
    declared bound times the slack factor.  ``bound=`` overrides the
    table's default for sites whose timeout is config-driven; the table
    row is still mandatory (it is the declared ceiling).
    """

    __slots__ = ("site", "bound", "_t0", "_armed")

    def __init__(self, site: str, bound: float = None):
        self.site = site
        self.bound = bound
        self._armed = block_watchdog_enabled()
        self._t0 = 0.0

    def __enter__(self):
        if not self._armed:
            return self
        if self.site not in BLOCK_BOUNDS:
            raise BlockBoundViolation(
                f"blocking site {self.site!r} is not declared in "
                f"lock_watchdog.BLOCK_BOUNDS (rtlint: "
                f"block-bound-undeclared)")
        import time as _time
        from ray_tpu_torch.util import profiler as _profiler
        _profiler.note_lock_wait(f"block:{self.site}")
        self._t0 = _time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._armed:
            return False
        import time as _time
        from ray_tpu_torch.util import profiler as _profiler
        waited = _time.monotonic() - self._t0
        _profiler.clear_lock_wait()
        with _BLOCK_STATS_LOCK:
            st = _BLOCK_STATS.setdefault(self.site, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += waited
            st[2] = max(st[2], waited)
        eff = BLOCK_BOUNDS[self.site] if self.bound is None \
            else float(self.bound)
        if waited > eff * _block_slack() and exc_type is None:
            from ray_tpu_torch._private import flight_recorder
            if flight_recorder.enabled():
                flight_recorder.record(
                    "blockwait",
                    f"{self.site} {waited:.3f}s > bound {eff:.3f}s")
            raise BlockBoundViolation(
                f"declared-bounded site {self.site!r} blocked for "
                f"{waited:.3f}s, over its declared bound {eff:.3f}s "
                f"(x{_block_slack()} slack)")
        return False
