"""Catalog of every built-in ``rtt_*`` metric.

One declaration per built-in series (name, kind, tags, buckets, emitting
process) so the worker, GCS, Serve, and Train layers share definitions
instead of re-declaring strings — the same role ``ray_config_def.h``
plays for flags.  Layers obtain instances through :func:`get`, which is a
registry hit on the warm path (thanks to ``Metric`` merge-on-reregister)
and re-creates the instance after a test registry reset.

``tools/check_metrics_catalog.py`` (wired into ``make lint``) statically
verifies that every ``Counter(``/``Gauge(``/``Histogram(`` instantiation
of an ``rtt_*`` name in the tree — and every ``mcat.get(...)`` call —
names an entry declared here, so the catalog stays honest as layers grow.

One documented exception: the ``rtt_native_store_*`` gauge family is
synthesized at collect time from whatever stats the C++ slab store's
shared header exposes (``SlabStore.stats()`` keys — hits/misses/allocs/
fails/used/...), so its exact member names live in native code, not
here, and the static check cannot cover them.

README.md § Observability renders this catalog for operators.
"""

from __future__ import annotations

from typing import Dict

from ray_tpu_torch.util import metrics as _metrics

# Latency buckets biased toward the sub-second range where task dispatch
# and serve requests live, with a long tail for slow train steps.
LATENCY_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Microsecond-scale buckets for control-plane handler CPU (a hot-kind
# handler at its floor runs in tens of µs; the ms range is the
# contention tail we watch for).
HOT_HANDLER_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                       0.005, 0.01, 0.05, 0.25, 1.0)

# name -> {kind, description, tag_keys, buckets?, emitted_by}
# ``emitted_by`` is documentation: which process's registry carries the
# series (collect_cluster adds the disambiguating ``worker`` tag).
CATALOG: Dict[str, dict] = {
    # --- core task lifecycle ------------------------------------------------
    "rtt_task_queue_seconds": dict(
        kind="histogram", tag_keys=("name",), buckets=LATENCY_BUCKETS,
        description="Time a task spec waited in the scheduler queue "
                    "(submit/retry enqueue -> dispatch to a worker)",
        emitted_by="head (GCS)"),
    "rtt_task_exec_seconds": dict(
        kind="histogram", tag_keys=("name",), buckets=LATENCY_BUCKETS,
        description="Task / actor-method body execution time on the worker "
                    "(arg unpack through result store)",
        emitted_by="worker"),
    "rtt_tasks_total": dict(
        kind="counter", tag_keys=("state",),
        description="Tasks reaching a terminal state "
                    "(ok | app_error | sys_error | dep_error | cancelled)",
        emitted_by="head (GCS)"),
    "rtt_object_store_put_bytes": dict(
        kind="counter", tag_keys=(),
        description="Serialized bytes written to the object store by "
                    "ray_tpu_torch.put() in this process",
        emitted_by="every worker/driver"),
    "rtt_object_store_get_bytes": dict(
        kind="counter", tag_keys=(),
        description="Serialized bytes materialized from the object store "
                    "by ray_tpu_torch.get() in this process",
        emitted_by="every worker/driver"),
    "rtt_actor_restarts_total": dict(
        kind="counter", tag_keys=("class",),
        description="Actor restarts triggered by worker death "
                    "(max_restarts budget consumed)",
        emitted_by="head (GCS)"),
    # --- control-plane fast path (GCS hot kinds) ----------------------------
    "rtt_gcs_hot_handler_seconds": dict(
        kind="histogram", tag_keys=("kind",), buckets=HOT_HANDLER_BUCKETS,
        description="GCS hot-kind handler time (get_meta_fast = lock-free "
                    "sealed read; get_meta_scan = slow-path scan; "
                    "submit_batch / task_done / actor_result / put_object "
                    "= apply under the global lock; ref_drain = one "
                    "coalesced refcount batch)",
        emitted_by="head (GCS)"),
    "rtt_gcs_lock_wait_seconds": dict(
        kind="gauge", tag_keys=("lock",),
        description="Last observed wait to acquire a GCS lock on an "
                    "instrumented hot path (contention probe, not a "
                    "cumulative meter)",
        emitted_by="head (GCS)"),
    "rtt_gcs_ref_ops_total": dict(
        kind="counter", tag_keys=("path",),
        description="Refcount-plane ops applied, by path: 'coalesced' = "
                    "batched per-connection drain (one lock acquisition "
                    "per batch), 'inline' = per-call handler (in-process "
                    "short circuit / direct RPC)",
        emitted_by="head (GCS)"),
    # --- raylet lease plane (raylet.py / gcs.py, DESIGN.md §4i) -------------
    "rtt_raylet_leases_total": dict(
        kind="counter", tag_keys=("event",),
        description="Worker-lease ledger events: 'granted' (specs shipped "
                    "to a raylet in lease_grant blocks), 'done' (settled "
                    "by raylet_done_batch), 'handoff' (lease inherited by "
                    "a queued same-shape task with no head round-trip), "
                    "'returned' (unstarted leases handed back), "
                    "'reclaimed' (raylet death/detach reclaim)",
        emitted_by="head (GCS)"),
    "rtt_raylet_ref_ops_total": dict(
        kind="counter", tag_keys=("path",),
        description="Owner-local refcount releases applied through raylet "
                    "reconciliation ('reconciled' = netted worker releases "
                    "shipped in raylet_ref_batch frames)",
        emitted_by="head (GCS)"),
    "rtt_raylet_queue_depth": dict(
        kind="gauge", tag_keys=("node",),
        description="Local scheduler queue depth per raylet node "
                    "(granted-but-undispatched leases; from "
                    "raylet_heartbeat)",
        emitted_by="head (GCS)"),
    "rtt_raylet_reconcile_age_seconds": dict(
        kind="gauge", tag_keys=("node",),
        description="Seconds since a raylet last reconciled its netted "
                    "refcount deltas to the GCS ledger (from "
                    "raylet_heartbeat)",
        emitted_by="head (GCS)"),
    # --- P2P object plane (data_plane.py) -----------------------------------
    "rtt_data_pull_seconds": dict(
        kind="histogram", tag_keys=("path",), buckets=LATENCY_BUCKETS,
        description="End-to-end peer-object pull time: 'direct' = "
                    "streamed/chunked pull from the holder's data plane "
                    "(pooled conns), 'relay' = head pull-through fallback "
                    "for unreachable holders",
        emitted_by="every puller (worker/driver/head)"),
    "rtt_data_bytes_total": dict(
        kind="counter", tag_keys=("dir",),
        description="Data-plane bulk bytes moved by this process: "
                    "'in' = pulled from peers, 'out' = served from the "
                    "local spool",
        emitted_by="pullers ('in') and data-plane servers ('out')"),
    "rtt_data_pool_conns": dict(
        kind="gauge", tag_keys=(),
        description="Open data-plane connections held by this process's "
                    "connection pool (idle + checked out)",
        emitted_by="every process with a DataPlanePool"),
    # --- serve data plane ---------------------------------------------------
    # ``group`` label convention: cross-layer series that belong to one
    # logical workload stamp its name as ``group`` — train series use the
    # elastic training-group name, serve/LLM series use the deployment
    # key (stamped at the proxy/handle call sites and, for the engine's
    # rtt_llm_* family, via per-replica-process ``set_default_tags``).
    # One selector ({group="X"}) then follows a workload across every
    # layer, and group-aware detectors (straggler cohorts) never mix
    # concurrent workloads.
    "rtt_serve_requests_total": dict(
        kind="counter", tag_keys=("deployment", "code", "group"),
        description="HTTP requests completed by the Serve proxy, by "
                    "deployment key and status code",
        emitted_by="serve proxy"),
    "rtt_serve_errors_total": dict(
        kind="counter", tag_keys=("deployment", "group"),
        description="Serve requests that ended in a 5xx response",
        emitted_by="serve proxy"),
    "rtt_serve_request_latency_seconds": dict(
        kind="histogram", tag_keys=("deployment", "group"),
        buckets=LATENCY_BUCKETS,
        description="End-to-end Serve request latency at the proxy "
                    "(replica assignment + execution; time-to-first-byte "
                    "for streaming responses)",
        emitted_by="serve proxy"),
    "rtt_serve_replica_queue_depth": dict(
        kind="gauge", tag_keys=("deployment", "group"),
        description="Requests held in a router's assign() waiting for a "
                    "free replica (max_ongoing_requests backpressure)",
        emitted_by="every process with a router (proxy/driver)"),
    "rtt_serve_ongoing_requests": dict(
        kind="gauge", tag_keys=("deployment", "replica", "group"),
        description="Requests currently executing inside a replica",
        emitted_by="serve replica"),
    "rtt_serve_autoscaler_desired_replicas": dict(
        kind="gauge", tag_keys=("deployment", "group"),
        description="Autoscaler target replica count after the current "
                    "decision tick (equals num_replicas when autoscaling "
                    "is off)",
        emitted_by="serve controller"),
    # --- serve.llm continuous-batching engine -------------------------------
    "rtt_llm_sequences": dict(
        kind="gauge", tag_keys=("model", "state", "group"),
        description="Sequences inside an LLM engine by state "
                    "(running = in the decode batch, waiting = queued "
                    "for prefill admission, incl. preempted)",
        emitted_by="llm replica"),
    "rtt_llm_kv_blocks": dict(
        kind="gauge", tag_keys=("model", "state", "group"),
        description="Paged KV cache blocks by state (used | free) in "
                    "an engine's shm block pool",
        emitted_by="llm replica"),
    "rtt_llm_batch_occupancy": dict(
        kind="gauge", tag_keys=("model", "group"),
        description="Decode batch occupancy: running sequences / "
                    "max_num_seqs after the last scheduler iteration",
        emitted_by="llm replica"),
    "rtt_llm_preemptions_total": dict(
        kind="counter", tag_keys=("model", "group"),
        description="Sequences evicted under KV cache pressure "
                    "(blocks freed, re-prefilled later)",
        emitted_by="llm replica"),
    "rtt_llm_ttft_seconds": dict(
        kind="histogram", tag_keys=("model", "group"), buckets=LATENCY_BUCKETS,
        description="Time to first token: request submission to the "
                    "first sampled token (queueing + prefill)",
        emitted_by="llm replica"),
    "rtt_llm_tpot_seconds": dict(
        kind="histogram", tag_keys=("model", "group"), buckets=LATENCY_BUCKETS,
        description="Time per output token after the first (decode "
                    "cadence), observed once per finished sequence",
        emitted_by="llm replica"),
    "rtt_llm_tokens_total": dict(
        kind="counter", tag_keys=("model", "phase", "group"),
        description="Tokens processed by an LLM engine: 'prefill' = "
                    "prompt tokens prefilled, 'decode' = tokens "
                    "generated by decode iterations",
        emitted_by="llm replica"),
    # --- head TSDB / anomaly detection (DESIGN.md §4k) ----------------------
    "rtt_tsdb_series": dict(
        kind="gauge", tag_keys=(),
        description="Time series held by the head-resident metrics "
                    "TSDB (bounded by tsdb_max_series)",
        emitted_by="head (GCS)"),
    "rtt_tsdb_samples_total": dict(
        kind="counter", tag_keys=(),
        description="Samples ingested into the head TSDB from "
                    "__metrics__/ snapshot receipts",
        emitted_by="head (GCS)"),
    # --- continuous profiling / incident capture (DESIGN.md §4o) ------------
    "rtt_profile_samples_total": dict(
        kind="counter", tag_keys=(),
        description="Stack samples taken by this process's always-on "
                    "sampling profiler and shipped to the head in "
                    "__profile__/ deltas",
        emitted_by="every non-client process (profiler_enabled)"),
    "rtt_profile_stacks": dict(
        kind="gauge", tag_keys=(),
        description="Distinct folded stacks in the last published "
                    "profile delta (bounded by profiler_max_stacks; an "
                    "'(overflow)' bucket absorbs the tail)",
        emitted_by="every non-client process (profiler_enabled)"),
    "rtt_profile_publish_seconds": dict(
        kind="histogram", tag_keys=(), buckets=HOT_HANDLER_BUCKETS,
        description="Wall time to fold + serialize + ship one profile "
                    "delta on the metrics-publisher cadence (the "
                    "profiler's own overhead meter)",
        emitted_by="every non-client process (profiler_enabled)"),
    "rtt_incidents_total": dict(
        kind="counter", tag_keys=("kind",),
        description="Post-mortem incident bundles captured by the head "
                    "on anomaly events (straggler | slo_burn), after "
                    "incident_dedup_s dedup — each bundle lands in "
                    "<session>/incidents/<id>/",
        emitted_by="head (GCS)"),
    # --- GCS replication / head fault tolerance (DESIGN.md §4l) -------------
    "rtt_gcs_wal_records_total": dict(
        kind="counter", tag_keys=(),
        description="Durable ledger mutations appended to the GCS "
                    "write-ahead log (fsynced in drain batches, "
                    "streamed to attached warm standbys)",
        emitted_by="head (GCS)"),
    "rtt_gcs_repl_standbys": dict(
        kind="gauge", tag_keys=(),
        description="Warm standby heads currently attached to the "
                    "replication stream (0 = a head failure falls back "
                    "to snapshot+WAL restart over the session dir)",
        emitted_by="head (GCS)"),
    "rtt_anomaly_events_total": dict(
        kind="counter", tag_keys=("kind",),
        description="Anomalies emitted into the fleet-event feed by the "
                    "always-on detectors ('straggler' = per-rank train "
                    "step-time skew vs the group median; 'slo_burn' = "
                    "multi-window SLO error-budget burn)",
        emitted_by="head (GCS)"),
    # --- request tracing / flight recorder ----------------------------------
    "rtt_trace_spans_total": dict(
        kind="counter", tag_keys=("cat",),
        description="Timeline span events emitted by this process, by "
                    "category (span | task | actor_task | sched | data | "
                    "llm | serve | device)",
        emitted_by="every traced process"),
    "rtt_trace_sampled_total": dict(
        kind="counter", tag_keys=("decision",),
        description="Head-based sampling decisions at auto-rooted "
                    "request traces (sampled | dropped) — explicit "
                    "tracing.trace() roots are always sampled and not "
                    "counted here",
        emitted_by="request-root processes (serve proxy)"),
    "rtt_trace_flight_records_total": dict(
        kind="counter", tag_keys=(),
        description="Flight-recorder ring records written by this "
                    "process (amortized count; the ring itself is "
                    "fixed-size and overwrites in place)",
        emitted_by="every process with a flight recorder"),
    # --- train --------------------------------------------------------------
    # --- fleet elasticity (DESIGN.md §4j) -----------------------------------
    "rtt_elastic_node_draining_total": dict(
        kind="counter", tag_keys=("reason",),
        description="Provider-initiated preemption warnings received "
                    "(node_draining events marking a node unschedulable)",
        emitted_by="head (GCS)"),
    "rtt_elastic_remesh_total": dict(
        kind="counter", tag_keys=("action",),
        description="Elastic train-group transitions driven by the "
                    "elasticity manager (remesh = survivors re-form "
                    "without a cold start; restart = full-group cold "
                    "start from the last gathered state; join = a "
                    "restored slice attached to the running group)",
        emitted_by="driver (elasticity manager)"),
    "rtt_elastic_remesh_seconds": dict(
        kind="histogram", tag_keys=("action",), buckets=LATENCY_BUCKETS,
        description="Quiesce -> resume wall time of one elastic "
                    "transition (training paused, processes alive)",
        emitted_by="driver (elasticity manager)"),
    "rtt_elastic_generation": dict(
        kind="gauge", tag_keys=("group",),
        description="Current mesh generation of an elastic train group "
                    "(bumps on every re-mesh/restart/join)",
        emitted_by="driver (elasticity manager)"),
    "rtt_elastic_goodput_steps_per_s": dict(
        kind="gauge", tag_keys=("group",),
        description="Useful (first-time) train steps per wall-second "
                    "across the run so far, re-runs excluded",
        emitted_by="driver (elasticity manager)"),
    "rtt_autoscaler_demand_backlog": dict(
        kind="gauge", tag_keys=(),
        description="Unfulfilled resource shapes (tasks + PG bundles) "
                    "seen by the last autoscaler reconcile pass",
        emitted_by="driver (autoscaler)"),
    "rtt_autoscaler_nodes": dict(
        kind="gauge", tag_keys=("phase",),
        description="Provider nodes by lifecycle phase (pending / "
                    "running / draining) at the last reconcile pass",
        emitted_by="driver (autoscaler)"),
    "rtt_autoscaler_decisions_total": dict(
        kind="counter", tag_keys=("action",),
        description="Autoscaler reconcile decisions (launch | terminate)",
        emitted_by="driver (autoscaler)"),
    "rtt_autoscaler_forecast_slots": dict(
        kind="gauge", tag_keys=(),
        description="Lead-time demand floor the autopilot's diurnal "
                    "forecast is currently feeding the autoscaler "
                    "(extra shapes packed ahead of the measured "
                    "backlog; DESIGN.md §4n)",
        emitted_by="driver (autoscaler)"),
    "rtt_autopilot_actions_total": dict(
        kind="counter", tag_keys=("kind", "outcome"),
        description="Autopilot remediation actions (kind: drain | "
                    "undrain | prewarm | forecast | standby_launch; "
                    "outcome: applied | skipped | error) — every "
                    "reflex firing, including the ones the rate "
                    "limits and vetoes suppressed (DESIGN.md §4n)",
        emitted_by="head (GCS)"),
    "rtt_train_step_seconds": dict(
        kind="histogram", tag_keys=("rank", "group"),
        buckets=LATENCY_BUCKETS,
        description="Wall time between consecutive train.report() calls "
                    "on a training worker (one reported step).  Elastic "
                    "worker loops additionally stamp their training "
                    "group — the straggler detector cohorts its median "
                    "by this tag so concurrent jobs never read each "
                    "other as sick",
        emitted_by="train worker"),
    "rtt_train_throughput_steps_per_s": dict(
        kind="gauge", tag_keys=("rank",),
        description="Instantaneous training throughput (1 / last step "
                    "duration) per worker rank",
        emitted_by="train worker"),
    "rtt_train_mfu": dict(
        kind="gauge", tag_keys=("rank",),
        description="Model-FLOPs utilization reported by the training "
                    "loop (train.report key 'mfu'): model FLOP/s over "
                    "the chip's peak — the overlap-scheduled step's "
                    "headline number, fleet-visible via ray_tpu_torch top",
        emitted_by="train worker"),
    "rtt_train_overlap_exposed_ms": dict(
        kind="gauge", tag_keys=("rank",),
        description="Exposed (compute-unhidden) collective ms per train "
                    "step reported by the training loop (train.report "
                    "key 'overlap_exposed_ms', from bench-style device-"
                    "trace accounting) — the number the decomposed "
                    "collective matmuls drive toward zero",
        emitted_by="train worker"),
    # --- synthesized at collect time (documented here; no instantiation) ----
    "rtt_device_hbm_bytes_in_use": dict(
        kind="gauge", tag_keys=("device", "kind"),
        description="Device bytes currently allocated (CUDA allocator)",
        emitted_by="driver collect (device_memory_gauges)"),
    "rtt_device_hbm_peak_bytes": dict(
        kind="gauge", tag_keys=("device", "kind"),
        description="Peak device bytes allocated (CUDA allocator)",
        emitted_by="driver collect (device_memory_gauges)"),
    "rtt_device_hbm_bytes_limit": dict(
        kind="gauge", tag_keys=("device", "kind"),
        description="Device memory capacity (CUDA device properties)",
        emitted_by="driver collect (device_memory_gauges)"),
}


# --------------------------------------------------------------- SLO rules
# Burn-rate alerting rules over the latency histograms above, consumed
# by ``tsdb.SloBurnAlerter`` (always-on, ticked by the GCS monitor
# loop).  Declared HERE — next to the series they reference — so the
# rtlint metrics pass (``metric-slo-rule``) can statically prove every
# rule names a live cataloged histogram whose bucket ladder covers the
# threshold; a rule over a dead or re-bucketed series fails the build,
# not the 3am page.
#
# Shape: windows = ((long_s, short_s, burn_factor), ...) — an alert
# fires when the error-budget burn rate (fraction of observations
# slower than threshold_s, divided by 1 - objective) exceeds
# burn_factor on BOTH windows (long filters blips, short proves the
# burn is still live).  Factors follow the SRE-workbook ladder: 14.4x
# on the fast page window (budget gone in ~2h at that rate).
SLO_RULES: tuple = (
    dict(name="llm_ttft", series="rtt_llm_ttft_seconds",
         threshold_s=2.5, objective=0.99,
         windows=((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))),
    dict(name="llm_tpot", series="rtt_llm_tpot_seconds",
         threshold_s=0.25, objective=0.99,
         windows=((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))),
    dict(name="serve_latency", series="rtt_serve_request_latency_seconds",
         threshold_s=1.0, objective=0.999,
         windows=((3600.0, 300.0, 14.4),)),
)


# resolved-instance cache: get() runs on hot paths (inside the GCS
# scheduler lock, per Serve request) — the warm path must be two dict
# lookups, not a _REGISTRY_LOCK acquisition.  Invalidated by registry
# generation (bumped in metrics._reset_for_tests); races are benign
# (worst case one redundant rebuild that merges into the same instance).
_CACHE: Dict[str, "_metrics.Metric"] = {}
_CACHE_GEN = [-1]


def get(name: str) -> "_metrics.Metric":
    """The shared instance of a cataloged built-in metric.

    Warm path = a local cache hit (no shared lock); after
    ``_reset_for_tests()`` the generation bump drops the cache and the
    next call re-registers a fresh instance from the catalog spec."""
    gen = _metrics._REGISTRY_GEN[0]
    if gen != _CACHE_GEN[0]:
        _CACHE.clear()
        _CACHE_GEN[0] = gen
    inst = _CACHE.get(name)
    if inst is not None:
        return inst
    try:
        spec = CATALOG[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not a cataloged built-in metric — declare it in "
            f"ray_tpu_torch/util/metrics_catalog.py") from None
    kind = spec["kind"]
    if kind == "counter":
        inst = _metrics.Counter(name, spec["description"],
                                spec.get("tag_keys", ()))
    elif kind == "gauge":
        inst = _metrics.Gauge(name, spec["description"],
                              spec.get("tag_keys", ()))
    else:
        inst = _metrics.Histogram(
            name, spec["description"],
            spec.get("buckets", _metrics.DEFAULT_BUCKETS),
            spec.get("tag_keys", ()))
    _CACHE[name] = inst
    return inst
