"""Runtime flag registry for ray_tpu_torch.

TPU-native analog of the reference's ``RayConfig`` (reference:
``src/ray/common/ray_config_def.h`` — one macro per flag, env-overridable via
``RAY_<NAME>``; see SURVEY.md §5.6).  Here every flag is declared once in
``_FLAG_DEFS`` and is overridable via the environment variable
``RTT_<NAME>`` (uppercased).  ``ray_tpu_torch.init(_system_config={...})`` merges a
dict on top, mirroring the reference's ``_system_config`` JSON passthrough.

Design difference from the reference: there is no separate native flag
registry — the C++ components read their few knobs through their ctypes init
call, so this single Python registry is the source of truth for both worlds.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_ENV_PREFIX = "RTT_"


@dataclass(frozen=True)
class _FlagDef:
    name: str
    default: Any
    type: Callable[[str], Any]
    doc: str


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _flag(name: str, default: Any, doc: str) -> _FlagDef:
    if isinstance(default, bool):
        typ: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        typ = int
    elif isinstance(default, float):
        typ = float
    else:
        typ = str
    return _FlagDef(name, default, typ, doc)


# One entry per runtime knob.  Keep alphabetized within section.
_FLAG_DEFS = [
    # --- session / logging ---------------------------------------------------
    _flag("log_level", "INFO", "Root log level for ray_tpu_torch processes."),
    _flag("log_to_driver", True, "Ship worker stdout/stderr lines to the driver."),
    # NOT /tmp/ray_tpu_torch: a directory named exactly like the package would
    # shadow the import for any process with cwd=/tmp.
    _flag("session_dir_root", "/tmp/rtt_sessions", "Root for session_* directories."),
    # --- object store --------------------------------------------------------
    _flag("object_store_memory_mb", 2048, "Shared-memory object store capacity."),
    _flag("inline_object_max_bytes", 100 * 1024,
          "Objects <= this are inlined in the control plane (in-memory store) "
          "instead of shared memory (reference: core worker memory store)."),
    _flag("object_spill_dir", "", "Directory for spilled objects ('' = <session>/spill)."),
    _flag("object_store_eviction", True,
          "LRU-evict sealed unreferenced objects to disk when full."),
    _flag("use_native_store", True, "Use the C++ shm store if the extension builds."),
    _flag("slab_memory_mb", 512, "Capacity of the native slab store (small-object plane)."),
    _flag("slab_object_max_bytes", 1024 * 1024,
          "Objects <= this go through the C++ slab store; larger ones get "
          "their own tmpfs segment (zero-copy mmap reads)."),
    _flag("memory_usage_threshold", 0.95,
          "Node memory fraction above which the memory monitor kills the "
          "newest running task's worker (reference: MemoryMonitor OOM "
          "killing; 1.0 disables)."),
    _flag("memory_monitor_interval_s", 1.0,
          "How often the memory monitor samples node usage."),
    _flag("gcs_snapshot", True,
          "Persist durable GCS tables (KV, functions, actors, placement "
          "groups) to <session>/gcs_state so a restarted head recovers "
          "them (reference: GCS fault tolerance via Redis persistence)."),
    _flag("gcs_reconnect_timeout_s", 30.0,
          "How long workers and drivers retry reconnecting to a dead GCS "
          "socket before giving up (reference: raylets reconnecting to a "
          "restarted GCS)."),
    _flag("gcs_reconnect_deadline_s", 5.0,
          "Per-dial bounded jittered backoff when the GCS endpoint is "
          "DEAD (connection refused / socket file missing) — a head "
          "failover window surfaces as latency instead of "
          "ConnectionRefusedError.  0 fails fast (seed behavior)."),
    _flag("gcs_wal", True,
          "Write-ahead log of durable ledger mutations (fsynced in "
          "drain batches) under <session>/gcs_state, replayed on top "
          "of the newest snapshot at head restart and streamed to "
          "attached warm standbys (DESIGN.md §4l).  Requires "
          "gcs_snapshot."),
    _flag("gcs_wal_fsync", True,
          "fsync each WAL drain batch (group commit).  Disabling "
          "trades the host-crash guarantee for lower write latency; "
          "process-crash durability is unaffected."),
    _flag("gcs_repl_heartbeat_s", 0.2,
          "Replication heartbeat / epoch-fence poll period on the "
          "primary's replication drain thread."),
    _flag("gcs_repl_tsdb_interval_s", 2.0,
          "How often the primary ships head-TSDB ring deltas to "
          "attached standbys (history handoff; telemetry-grade, "
          "best-effort)."),
    _flag("gcs_standby_timeout_s", 1.0,
          "A standby promotes after this long without any replication "
          "frame (heartbeats arrive every gcs_repl_heartbeat_s), or "
          "immediately on stream EOF with the endpoint verified dead."),
    _flag("gcs_restore_grace_s", 8.0,
          "After a restored-head start, how long restored actors may wait "
          "for their surviving worker process to reattach before the "
          "normal restart path (max_restarts) takes over."),
    _flag("transfer_chunk_bytes", 4 * 1024 * 1024,
          "Cross-host object transfers stream in chunks of this size "
          "(reference: ObjectManager chunked transfer) instead of one "
          "monolithic control-plane message."),
    _flag("transfer_max_inflight", 2,
          "Concurrent chunked pulls per process; further pulls queue "
          "(reference: PullManager bandwidth admission)."),
    _flag("data_stream_frame_bytes", 8 * 1024 * 1024,
          "Payload bytes per bulk frame on a streamed peer pull "
          "(fetch_stream).  Frames only bound how often a mid-stream "
          "error can surface — there is no per-frame round trip."),
    _flag("data_inline_pull_bytes", 128 * 1024,
          "Streamed pulls at or below this ride the fetch_stream ack "
          "itself (one message round trip, no bulk frames) — below "
          "~100KB the pull is syscall-bound, not copy-bound, so one "
          "pickled copy beats four frame-boundary syscalls."),
    _flag("data_stripe_threshold_bytes", 32 * 1024 * 1024,
          "Peer pulls of objects >= this open N parallel range-striped "
          "streams over pooled connections (data_stripe_streams); "
          "smaller objects ride one stream."),
    _flag("data_stripe_streams", 4,
          "Parallel range streams per striped peer pull (>=2; 1 "
          "disables striping)."),
    _flag("data_pool_max_conns", 16,
          "Per-process data-plane connection pool bound: idle "
          "connections beyond this are closed LRU-first (in-use "
          "connections are never reclaimed)."),
    _flag("data_pull_buffer_cache_mb", 256,
          "Per-process cap on cached streamed-pull receive buffers "
          "(already-faulted pages reused across pulls — allocation + "
          "page-fault cost otherwise rivals the transfer itself for "
          "large objects).  0 disables caching."),
    # --- scheduler / workers -------------------------------------------------
    _flag("num_workers_per_node", 0, "Size of worker pool (0 = num_cpus)."),
    _flag("prestart_workers", 0,
          "Plain workers forked eagerly at head start (warm pool: Serve "
          "scale-ups and first tasks skip the worker boot; reference: "
          "prestart_worker_first_driver)."),
    _flag("worker_register_timeout_s", 30.0, "Timeout for a spawned worker to register."),
    _flag("actor_connect_timeout_s", 60.0,
          "Caller-side wait for a pending actor to come ALIVE before its "
          "first method call fails (a saturated host spawning a large "
          "fleet can need more; RTT_ACTOR_CONNECT_TIMEOUT_S)."),
    _flag("worker_lease_cache", True, "Reuse leased idle workers for same-shape tasks."),
    _flag("worker_pipeline_depth", 4,
          "Same-shape tasks queued on a busy worker's lease (scheduler-"
          "side; dispatched back-to-back on task completion without a "
          "pump scan).  0 disables (reference: lease reuse)."),
    _flag("scheduler_spread_threshold", 0.5,
          "Hybrid policy: prefer local until local load exceeds this fraction."),
    # --- raylet (per-node local scheduler, DESIGN.md §4i) --------------------
    _flag("raylet_enabled", True,
          "Promote each NodeAgent into a raylet: a per-node local "
          "scheduler that claims worker leases from the GCS in bulk, "
          "dispatches intra-node tasks without a head round-trip, and "
          "reconciles refcounts/results asynchronously (reference: "
          "src/ray/raylet NodeManager + LocalTaskManager).  Requires the "
          "head to speak wire proto >= PROTO_RAYLET; older heads fall "
          "back to the legacy direct-GCS worker pool automatically."),
    _flag("raylet_lease_backlog", 16,
          "Queued lease depth per raylet node: plain-CPU specs granted "
          "beyond the node's resource fit, queued locally and started "
          "by same-shape lease handoff or on an idle worker "
          "(node-scoped generalization of worker_pipeline_depth; "
          "concurrency stays bounded by the worker pool).  0 disables "
          "oversubscribed grants."),
    _flag("raylet_reconcile_interval_s", 0.2,
          "How often a raylet flushes its netted owner-local refcount "
          "deltas and scheduler stats to the GCS ledger.  Task results "
          "are NOT held to this cadence (the done flusher drains "
          "immediately when idle and batches only under load)."),
    _flag("raylet_spawn_headroom", 4,
          "Extra replacement workers a raylet may fork beyond its base "
          "pool while workers are blocked in get() with leased work "
          "queued (reference: raylet replacement workers for blocked "
          "ones; bounds nested-task deadlock avoidance)."),
    _flag("health_check_period_s", 1.0, "Control-plane node health check period."),
    _flag("health_check_timeout_s", 10.0, "Node declared dead after this long w/o heartbeat."),
    # --- tasks / actors ------------------------------------------------------
    _flag("task_default_max_retries", 3, "Default max_retries for tasks (-1 = infinite)."),
    _flag("actor_default_max_restarts", 0, "Default max_restarts for actors."),
    # --- GPU ----------------------------------------------------------------
    _flag("gpu_workers_per_node", 1,
          "Device-holding worker processes per node (one process holds "
          "the card; raise only with per-worker card partitioning "
          "through CUDA_VISIBLE_DEVICES).  The head keeps each local "
          "node with cards at this many, warm: forked at start and after "
          "each exit, torch imported before they register."),
    # --- wire protocol -------------------------------------------------------
    _flag("proto_min_version", 0,
          "Minimum control-plane wire version the GCS accepts (0 = legacy "
          "raw-pickle peers allowed).  Raising it makes the server reject "
          "__proto_hello__ from older clients AND legacy frames — the "
          "version-skew guard the reference gets from protobuf/gRPC "
          "(src/ray/protobuf/).  See _private/wire.py."),
    # --- metrics / tracing ---------------------------------------------------
    _flag("metrics_enabled", True,
          "Always-on metrics plane: every non-client ray_tpu_torch process runs "
          "a background publisher thread pushing its metric registry "
          "snapshot to the GCS KV, so `/metrics` and `ray_tpu_torch metrics` "
          "show live built-in series with zero user wiring.  False "
          "disables both the publisher and built-in instrumentation "
          "(metrics.publish() still works manually)."),
    _flag("metrics_export_period_s", 5.0,
          "Background metrics publisher period (jittered per cycle; "
          "clamped to >= 1s so publishing stays off the task hot path)."),
    _flag("timeline_enabled", True, "Record profile events for `ray_tpu_torch timeline`."),
    _flag("tsdb_enabled", True,
          "Head-resident metrics time-series store (DESIGN.md §4k): the "
          "GCS ingests every __metrics__/ snapshot it already receives "
          "into fixed-memory ring buffers with a downsampling ladder, "
          "queryable via the metrics_query op / state.metrics_history() "
          "/ `ray_tpu_torch top` / the dashboard history endpoint, and feeds "
          "the always-on straggler + SLO burn-rate detectors.  Requires "
          "metrics_enabled."),
    _flag("tsdb_max_series", 4096,
          "Global series bound of the head TSDB (beyond it new series "
          "are dropped and counted, never grown — fixed memory)."),
    _flag("tsdb_raw_samples", 360,
          "Raw-rung ring slots per series (one per received publish; "
          "~30min of history at the 5s default export period before "
          "queries fall to the 30s/300s downsampled rungs)."),
    _flag("tsdb_detector_interval_s", 5.0,
          "How often the GCS monitor loop runs the TSDB anomaly "
          "detectors (train straggler skew + SLO burn rate)."),
    _flag("tsdb_straggler_window_s", 30.0,
          "Straggler detector sliding window: per-rank mean step time "
          "(Δsum/Δcount of rtt_train_step_seconds) is compared to the "
          "group median over this window."),
    _flag("tsdb_straggler_ratio", 1.75,
          "A rank is a straggler when its window-mean step time "
          "exceeds this multiple of the group median (fires a "
          "'straggler' fleet event tagged with the rank's node)."),
    _flag("profiler_enabled", True,
          "Always-on sampling profiler (DESIGN.md §4o): every non-client "
          "process runs one jittered daemon thread at profiler_hz "
          "walking sys._current_frames() into a bounded folded-stack "
          "table; deltas ride the metrics-publisher cadence under the "
          "reserved __profile__/ KV prefix into the head ProfileStore, "
          "queryable via profile_query / state.profile() / "
          "`ray_tpu_torch profile` / the dashboard /profile/flame endpoint."),
    _flag("profiler_hz", 10.0,
          "Sampling frequency of the always-on profiler (jittered per "
          "cycle; ~10Hz keeps the floor overhead under the 5% "
          "prof_bench bound while still resolving 100ms hot spots)."),
    _flag("profiler_max_stacks", 512,
          "Distinct folded stacks kept per publish window; beyond it "
          "new stacks fold into one '(overflow)' bucket (fixed "
          "memory, never grown)."),
    _flag("incident_max", 32,
          "Incident bundles kept under <session>/incidents/; beyond it "
          "the oldest bundle directories are evicted (bounded disk)."),
    _flag("incident_dedup_s", 300.0,
          "One incident bundle per node per this window: detector "
          "refires and the autopilot drain that follows them reuse the "
          "existing bundle id instead of capturing again."),
    # --- fleet autopilot (DESIGN.md §4n) -------------------------------------
    _flag("autopilot_enabled", False,
          "Head-side supervision loop closing the observability -> "
          "actuation gap (DESIGN.md §4n): straggler fleet events drain "
          "the offending host, drain warnings pre-warm replacement "
          "capacity, and the 48h TSDB demand history feeds a diurnal "
          "forecast to the autoscaler.  Every action is rate-limited, "
          "hysteresis-guarded, and emitted as a fleet event + "
          "rtt_autopilot_actions_total sample."),
    _flag("autopilot_interval_s", 1.0,
          "How often the GCS monitor loop runs an autopilot reflex pass "
          "(event intake + periodic work)."),
    _flag("autopilot_drain_window_s", 300.0,
          "Autopilot drain rate-limit window: at most "
          "autopilot_max_drains_per_window remediation drains are "
          "issued per window, cluster-wide (a noisy detector must "
          "never cause a drain storm)."),
    _flag("autopilot_max_drains_per_window", 1,
          "Remediation drains the autopilot may issue per "
          "autopilot_drain_window_s."),
    _flag("autopilot_node_cooldown_s", 600.0,
          "Per-node relapse window: a node that stragglers again "
          "within this long of being returned to the pool is drained "
          "again IMMEDIATELY and permanently (the host is genuinely "
          "sick; operator/autoscaler replacement owns it).  Past the "
          "window the node starts fresh and a new drain is ordinary "
          "and recoverable."),
    _flag("autopilot_undrain_after_s", 120.0,
          "A straggler-drained node returns to the schedulable pool "
          "after this long without a fresh straggler signal (see "
          "autopilot_node_cooldown_s for what a relapse costs it)."),
    _flag("autopilot_prewarm", True,
          "Reflex 2: a node_draining warning pre-warms a replacement "
          "through the attached autoscaler DURING the warning window "
          "(the pre-warmed node is reserved against the incoming loss "
          "in _net_pending_capacity, so it is never double-launched)."),
    _flag("autopilot_forecast", True,
          "Reflex 3: feed the autoscaler a lead-time demand signal from "
          "a seasonal-naive forecast over the TSDB demand history, so "
          "it scales ahead of the diurnal curve instead of behind it."),
    _flag("autopilot_forecast_interval_s", 30.0,
          "How often the forecast reflex re-evaluates (two TSDB ladder "
          "scans + a demand scan per evaluation; the diurnal signal "
          "moves over minutes, not monitor ticks)."),
    _flag("autopilot_forecast_horizon_s", 120.0,
          "Forecast lead time (roughly node boot delay + one reconcile "
          "period: capacity requested now is ready when the predicted "
          "demand arrives)."),
    _flag("autopilot_forecast_period_s", 86400.0,
          "Seasonal period of the demand forecast (diurnal by "
          "default; the TSDB's 48h long rung holds two periods)."),
    _flag("autopilot_standby", True,
          "Reflex 4 (with autopilot_enabled): keep one warm GCS "
          "standby attached — launch `python -m "
          "ray_tpu_torch._private.replication` when rtt_gcs_repl_standbys "
          "== 0, re-launch on standby death, and emit an "
          "unprotected_head fleet event while the head is "
          "unreplicated.  Requires gcs_wal."),
    _flag("autopilot_standby_backoff_s", 5.0,
          "Minimum seconds between autopilot standby (re)launch "
          "attempts."),
    _flag("elastic_state_inline_max_bytes", 4 * 1024 * 1024,
          "Elastic gathered-state checkpoints at or below this ride "
          "the GCS KV inline (head-durable, restart-safe).  Larger "
          "states are published to the object plane and pulled "
          "peer-to-peer over the streaming data plane instead of "
          "through the head (the KV holds only the ObjectRef; the "
          "manager adopts a borrow so the blob outlives the "
          "publishing worker)."),
    _flag("trace_sample_rate", 0.01,
          "Head-based sampling rate for automatically-rooted request "
          "traces (e.g. one Serve HTTP request = one candidate root). "
          "Explicit tracing.trace() spans are always sampled; children "
          "inherit the root's decision, so a sampled-out request costs "
          "one random() call cluster-wide.  0 disables auto roots."),
    _flag("flight_recorder_enabled", True,
          "Always-on per-process flight recorder: a fixed-size mmap ring "
          "buffer in the session dir recording recent wire frames, "
          "scheduler decisions, lock-watchdog waits, and engine "
          "iterations.  Crash-surviving by construction (the ring file "
          "outlives a SIGKILLed process); read it with "
          "`ray_tpu_torch debug dump`."),
    _flag("flight_recorder_slots", 2048,
          "Ring-buffer capacity (records) per process; older records are "
          "overwritten in place (fixed memory, no growth)."),
]

_DEFS: Dict[str, _FlagDef] = {d.name: d for d in _FLAG_DEFS}


class RayTpuConfig:
    """Resolved config: defaults < env (RTT_*) < _system_config dict."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._overrides: Dict[str, Any] = {}

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        d = _DEFS.get(name)
        if d is None:
            raise AttributeError(f"unknown ray_tpu_torch config flag: {name!r}")
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            return d.type(env)
        return d.default

    def apply_system_config(self, system_config: Optional[Dict[str, Any]]) -> None:
        if not system_config:
            return
        with self._lock:
            for k, v in system_config.items():
                if k not in _DEFS:
                    raise ValueError(f"unknown _system_config key: {k!r}")
                self._overrides[k] = v

    def snapshot(self) -> Dict[str, Any]:
        """Full resolved view (for propagation to child processes / debugging)."""
        return {name: getattr(self, name) for name in _DEFS}

    def to_env(self) -> Dict[str, str]:
        """Encode the resolved config as RTT_* env vars for child processes."""
        out = {}
        for name, val in self.snapshot().items():
            out[_ENV_PREFIX + name.upper()] = (
                json.dumps(val) if isinstance(val, bool) else str(val)
            )
        return out

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()


GLOBAL_CONFIG = RayTpuConfig()
