"""Cluster state API: ``list_*`` / ``summarize_*`` / ``object_memory``.

Reference: ``python/ray/util/state/`` (SURVEY.md §2.3) — ``ray list tasks``,
``ray list actors``, ``ray summary``, ``ray memory``.  The data comes from
the GCS's live tables over the normal control-plane RPC; no side channel.
"""

from __future__ import annotations

from collections import Counter as _Counter
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as _worker_mod


def _rpc(kind: str, **kw) -> dict:
    return _worker_mod.global_worker().rpc(kind, **kw)


# ------------------------------------------------------------------ list_*
def list_nodes() -> List[dict]:
    return _rpc("list_nodes")["nodes"]


def list_actors(state: Optional[str] = None) -> List[dict]:
    actors = _rpc("list_actors")["actors"]
    return [a for a in actors if state is None or a["state"] == state]


def list_tasks(state: Optional[str] = None) -> List[dict]:
    tasks = _rpc("list_tasks")["tasks"]
    return [t for t in tasks if state is None or t["state"] == state]


def list_objects() -> List[dict]:
    return _rpc("list_objects")["objects"]


def list_workers() -> List[dict]:
    return _rpc("list_workers")["workers"]


def list_placement_groups() -> List[dict]:
    pgs = _rpc("pg_table")["pgs"]
    return [{"pg_id": pid, **info} for pid, info in pgs.items()]


# --------------------------------------------------------------- summaries
def summarize_tasks() -> Dict[str, int]:
    return dict(_Counter(t["state"] for t in list_tasks()))


def summarize_actors() -> Dict[str, int]:
    return dict(_Counter(a["state"] for a in list_actors()))


def summarize_objects() -> Dict[str, Any]:
    objs = list_objects()
    by_loc = _Counter(o["loc"] for o in objs if o["loc"])
    return {
        "count": len(objs),
        "total_bytes": sum(o["size"] or 0 for o in objs),
        "by_loc": dict(by_loc),
        "store": _rpc("store_stats")["stats"],
    }


def list_raylets() -> List[dict]:
    """Per-node local-scheduler state (held leases, local queue depth,
    last-reconcile age) for nodes running a raylet (DESIGN.md §4i)."""
    return _rpc("raylet_table")["raylets"]


def fleet_state() -> Dict[str, Any]:
    """Fleet elasticity rollup (DESIGN.md §4j): nodes by lifecycle phase
    (pending / running / draining / terminating), the current demand
    backlog, and the last elastic re-mesh event."""
    resp = _rpc("fleet_state")
    resp.pop("error", None)
    return resp


def metrics_history(expr: str, start: Optional[float] = None,
                    end: Optional[float] = None,
                    step: Optional[float] = None,
                    at: Optional[float] = None) -> List[dict]:
    """Query the head-resident metrics TSDB (DESIGN.md §4k).

    Instant form (default): ``metrics_history('rate(rtt_tasks_total'
    '{state="ok"}[60s])')`` → ``[{"tags": {...}, "value": float}]``,
    evaluated at ``at`` (default: now).  Range form (any of
    start/end/step given): the expression evaluated at each step →
    ``[{"tags": {...}, "points": [[ts, value], ...]}]``.  Supported
    syntax: label matchers (``=``, ``!=``, ``=~``), ``rate()``,
    ``increase()``, ``avg/min/max_over_time()``,
    ``quantile_over_time(q, ...)``, and ``sum/avg/max/min [by (...)]``
    aggregation — see README § Observability."""
    if start is not None or end is not None or step is not None:
        return _rpc("metrics_query", op="query_range", expr=expr,
                    start=start, end=end, step=step)["results"]
    return _rpc("metrics_query", expr=expr, at=at)["results"]


def metrics_forecast(expr: str, horizon_s: float,
                     period_s: float = 86400.0, smooth_s: float = 600.0,
                     at: Optional[float] = None) -> List[dict]:
    """Seasonal-naive forecast over the TSDB's 48h rungs (DESIGN.md
    §4n): the predicted value of each matching gauge series at ``now +
    horizon_s``, read one ``period_s`` earlier from the ladder — the
    autopilot's lead-time demand signal, exposed for operators too."""
    return _rpc("metrics_query", op="forecast", expr=expr,
                horizon_s=horizon_s, period_s=period_s,
                smooth_s=smooth_s, at=at)["results"]


def autopilot_status(limit: int = 50) -> Dict[str, Any]:
    """The autopilot's recent remediation actions + reflex counters
    (DESIGN.md §4n): ``{"enabled": bool, "actions": [...], "stats":
    {...}}`` — every drain / prewarm / forecast / standby action with
    its outcome (applied | skipped | error) and reason."""
    resp = _rpc("autopilot_status", limit=limit)
    resp.pop("error", None)
    return resp


def profile(window_s: float = 300.0, proc: Optional[str] = None,
            node_id: Optional[str] = None) -> Dict[str, Any]:
    """Query the head-resident continuous-profiling store (DESIGN.md
    §4o): the merged folded-stack histogram over the trailing
    ``window_s`` seconds — ``{"samples": int, "stacks": {folded:
    count}, "procs": [...], "window_s": float}``.  ``proc`` narrows to
    one publisher (worker id or ``role:pid``); ``node_id`` narrows to
    one node.  History for dead processes stays queryable until the
    store's window rolls past it."""
    return _rpc("profile_query", window_s=window_s, proc=proc,
                node_id=node_id)


def profile_diff(window_a: float = 300.0, window_b: float = 300.0,
                 proc: Optional[str] = None) -> Dict[str, Any]:
    """Differential flame query (DESIGN.md §4o): window A = the
    trailing ``window_a`` seconds, window B = the ``window_b`` seconds
    before it.  Returns per-stack sample-fraction deltas (``diff``,
    positive = hotter now) alongside the raw A/B histograms — the
    "what changed" view for regressions."""
    return _rpc("profile_query", op="diff", window_a=window_a,
                window_b=window_b, proc=proc)


def metrics_series(match: Optional[str] = None) -> List[dict]:
    """List the TSDB's series (name, kind, tags, newest-sample age);
    ``match`` filters with selector syntax (``name{label="v"}``)."""
    return _rpc("metrics_query", op="series", match=match)["series"]


def cluster_summary() -> Dict[str, Any]:
    """One-call rollup used by `ray_tpu_torch status`."""
    res = _rpc("cluster_resources")
    return {
        "nodes": len([n for n in list_nodes() if n["alive"]]),
        "resources_total": res["total"],
        "resources_available": res["available"],
        "tasks": summarize_tasks(),
        "actors": summarize_actors(),
        "objects": summarize_objects(),
        "raylets": list_raylets(),
        "fleet": fleet_state(),
    }


# ----------------------------------------------------------- object memory
def object_memory(group_by: str = "loc") -> List[dict]:
    """The `ray memory` equivalent: who holds object bytes, grouped."""
    objs = list_objects()
    groups: Dict[str, dict] = {}
    for o in objs:
        key = str(o.get(group_by))
        g = groups.setdefault(key, {group_by: key, "count": 0, "bytes": 0,
                                    "pinned_refs": 0})
        g["count"] += 1
        g["bytes"] += o["size"] or 0
        g["pinned_refs"] += o["refcount"]
    return sorted(groups.values(), key=lambda g: -g["bytes"])
