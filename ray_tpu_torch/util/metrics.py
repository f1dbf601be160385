"""Application-level metrics: Counter / Gauge / Histogram with tags.

Reference: ``ray.util.metrics`` (``python/ray/util/metrics.py``; SURVEY.md
§5.5) — user code registers metrics that flow to each node's metrics agent
and out a Prometheus endpoint.  Here the registry lives in-process and
publishes snapshots into the GCS KV (``__metrics__/<worker>``) so the driver
— or the dashboard-lite HTTP endpoint — can aggregate cluster-wide without a
sidecar agent; ``prometheus_text()`` renders the standard exposition format.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Metric"] = {}
# bumped on registry reset so caches of resolved instances (the catalog's
# warm path) know to drop stale references
_REGISTRY_GEN = [0]

# The GCS KV prefix under which every process's publisher writes its
# snapshot.  One spelling, shared by the publisher, the collector, and
# the GCS's persistence/sweep exemptions (gcs.py).
METRICS_KV_PREFIX = "__metrics__/"


def is_metrics_key(key) -> bool:
    """Is this KV key an ephemeral metrics snapshot?  (keys may be str
    or bytes depending on the caller)"""
    if isinstance(key, bytes):
        return key.startswith(METRICS_KV_PREFIX.encode())
    return isinstance(key, str) and key.startswith(METRICS_KV_PREFIX)

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   50.0, 100.0)

# Per-metric series-cardinality cap.  Tag values can be user-controlled
# (task names via .options(name=...), deployment keys): without a bound,
# a driver submitting uniquely-named tasks grows the registry — and the
# publisher's per-cycle kv_put payload — forever.  The tagset that would
# exceed the cap folds into one {"overflow": "true"} series so totals
# stay correct even when labels saturate.
MAX_SERIES_PER_METRIC = 1000
_OVERFLOW_KEY = (("overflow", "true"),)


def _tag_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    """Base: named metric with default tags and per-tagset series.

    Same-name same-kind construction returns THE registered instance
    (series merge) instead of silently replacing the registry entry —
    two modules declaring the same counter share one series, and the
    catalog accessor (``metrics_catalog.get``) is a cheap registry hit
    on the warm path.  Same name with a different kind still raises."""

    kind = "untyped"
    # class-level fallbacks: a registered-but-not-yet-__init__'d instance
    # (another thread won the __new__ race a moment ago) must already be
    # safe to snapshot/update
    description = ""
    tag_keys: Tuple[str, ...] = ()

    def __new__(cls, name: str, *args: Any, **kwargs: Any) -> "Metric":
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        with _REGISTRY_LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None:
                if existing.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}")
                return existing
            inst = super().__new__(cls)
            # essential state under the registry lock: the instance is
            # visible to other threads the moment it lands in _REGISTRY
            inst.name = name
            inst._default_tags = {}
            inst._lock = threading.Lock()
            inst._series = {}
            _REGISTRY[name] = inst
        return inst

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if getattr(self, "_initialized", False):
            return  # merged into the already-registered instance
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._initialized = True

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _resolve_tags(self, tags: Optional[Dict[str, str]]):
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return _tag_key(merged)

    def _admit_key(self, k):
        """Lock held.  Cardinality gate: an unseen tagset beyond the cap
        folds into the shared overflow series instead of growing the
        registry (and every publish payload) without bound."""
        if k in self._series or len(self._series) < MAX_SERIES_PER_METRIC:
            return k
        return _OVERFLOW_KEY

    def remove_series(self, tags: Optional[Dict[str, str]] = None) -> bool:
        """Drop one tagset's series — called when the tagged entity (a
        deployment, a replica) is deleted, so a long-lived process stops
        republishing its last value forever.  Returns True if present."""
        with self._lock:
            return self._series.pop(self._resolve_tags(tags), None) is not None

    # -- snapshot / exposition ----------------------------------------------
    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{"tags": dict(k), "value": self._render(v)}
                    for k, v in self._series.items()]

    def _render(self, v):
        return v


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = self._resolve_tags(tags)
        with self._lock:
            k = self._admit_key(k)
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        k = self._resolve_tags(tags)
        with self._lock:
            self._series[self._admit_key(k)] = float(value)


class Histogram(Metric):
    kind = "histogram"
    boundaries = tuple(DEFAULT_BUCKETS)  # pre-__init__ visibility (see base)

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = DEFAULT_BUCKETS,
                 tag_keys: Sequence[str] = ()):
        if getattr(self, "_initialized", False):
            return  # merged: the first registration's boundaries stand
        self.boundaries = tuple(sorted(boundaries))
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        k = self._resolve_tags(tags)
        with self._lock:
            k = self._admit_key(k)
            series = self._series.get(k)
            if series is None:
                series = {"counts": [0] * (len(self.boundaries) + 1),
                          "sum": 0.0, "count": 0}
                self._series[k] = series
            idx = bisect.bisect_left(self.boundaries, value)
            series["counts"][idx] += 1
            series["sum"] += value
            series["count"] += 1

    def _render(self, v):
        return {"buckets": dict(zip([str(b) for b in self.boundaries]
                                    + ["+Inf"], v["counts"])),
                "sum": v["sum"], "count": v["count"]}


# ---------------------------------------------------------------- exposition
def registry_snapshot() -> Dict[str, dict]:
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    return {m.name: {"kind": m.kind, "description": m.description,
                     "series": m.snapshot()} for m in metrics}


def _esc_label(v: Any) -> str:
    """Escape a label value per the Prometheus text-format spec:
    backslash, double quote, and line feed would otherwise emit invalid
    exposition text (unparseable by any strict scraper)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(v: str) -> str:
    """HELP text escaping: backslash and line feed (spec)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_tags(tags: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_esc_label(v)}"' for k, v in sorted(tags.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(snapshot: Optional[Dict[str, dict]] = None) -> str:
    """Render a snapshot in the Prometheus exposition format."""
    snap = snapshot if snapshot is not None else registry_snapshot()
    out: List[str] = []
    for name, m in sorted(snap.items()):
        if m["description"]:
            out.append(f"# HELP {name} {_esc_help(m['description'])}")
        out.append(f"# TYPE {name} {m['kind']}")
        for s in m["series"]:
            tags, v = s["tags"], s["value"]
            if m["kind"] == "histogram":
                acc = 0
                for b, c in v["buckets"].items():
                    acc += c
                    le = 'le="%s"' % b
                    out.append(f"{name}_bucket{_fmt_tags(tags, le)} {acc}")
                out.append(f"{name}_sum{_fmt_tags(tags)} {v['sum']}")
                out.append(f"{name}_count{_fmt_tags(tags)} {v['count']}")
            else:
                out.append(f"{name}{_fmt_tags(tags)} {v}")
    return "\n".join(out) + "\n"


# ------------------------------------------------------------- cluster push
def publish(worker=None) -> None:
    """Publish this process's metrics snapshot to the GCS KV."""
    import json

    from ray_tpu_torch._private import worker as worker_mod
    w = worker or worker_mod.try_global_worker()
    if w is None:
        return
    # _reconnect=False: publishing is periodic best-effort — during a head
    # restart it must fail fast and let the owning threads heal the pool,
    # not fight them for it (the next cycle publishes to the healed head)
    w.rpc("kv_put", _reconnect=False,
          key=METRICS_KV_PREFIX + w.worker_id,
          value=json.dumps({"ts": time.time(),
                            "snapshot": registry_snapshot()}).encode())


# How long a DEAD publisher's final snapshot stays visible before the
# collector reaps it.  Short-lived processes (a train worker that ran a
# quick loop, a task worker that exited) flush once on clean shutdown —
# without a grace window their series would vanish the instant the worker
# died, i.e. exactly when an operator wants to read them.
DEAD_SNAPSHOT_GRACE_S = 120.0


def collect_cluster() -> Dict[str, dict]:
    """Merge every live process's published snapshot (driver-side).

    Each series gains a ``worker`` tag so identical name+tags from two
    processes stay distinct samples (duplicate labels are invalid
    Prometheus); dead workers' snapshots stay visible for
    ``DEAD_SNAPSHOT_GRACE_S`` after their last publish (the shutdown
    flush), then are reaped.  (Reader-side aging uses the payload's
    publisher wall clock — adequate for the common single-host driver;
    the GCS's own sweep ages by head receipt time and is the
    authoritative skew-proof bound.)

    One ``kv_mget`` round trip fetches every publisher's snapshot —
    scrape cost does not grow a head RPC per worker.
    """
    import json

    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod.global_worker()
    live = {wk["worker_id"] for wk in w.rpc("list_workers")["workers"]
            if wk["state"] != "dead"}
    entries = w.rpc("kv_mget", prefix=METRICS_KV_PREFIX)["entries"]
    merged: Dict[str, dict] = {}
    now = time.time()
    for key, raw in sorted(entries.items()):
        wid = key.split("/", 1)[1]
        if not raw:
            if wid not in live:
                w.rpc("kv_del", key=key)  # dead publisher, empty payload
            continue
        try:
            payload = json.loads(raw)
            payload["snapshot"]
        except Exception:  # noqa: BLE001 - one corrupt payload must not
            # take down the whole cluster scrape; reap it (a live
            # publisher rewrites its key next cycle anyway)
            w.rpc("kv_del", key=key)
            continue
        if wid not in live and \
                now - payload.get("ts", 0) > DEAD_SNAPSHOT_GRACE_S:
            w.rpc("kv_del", key=key)  # reap dead publishers' stale snapshots
            continue
        snap = payload["snapshot"]
        for name, m in snap.items():
            dst = merged.setdefault(name, {"kind": m["kind"],
                                           "description": m["description"],
                                           "series": []})
            for s in m["series"]:
                dst["series"].append(
                    {"tags": {**s["tags"], "worker": wid},
                     "value": s["value"]})
    # native slab-store counters (reference: src/ray/stats/ metrics in the
    # plasma/raylet process — SURVEY.md §2.1 Stats row): the C++ store
    # keeps hits/misses/allocs/fails in its shared header; surface them as
    # first-class gauges so `ray_tpu_torch metrics` / Prometheus see the native
    # data plane, not just Python-side registries.
    # (the slab is per-HOST shared state — one series tagged with the
    # collecting node, not one per worker; remote agent hosts use spools,
    # not slabs, so this meters the head-host store)
    slab = w.slab
    if slab is not None:
        try:
            for name, val in slab.stats().items():
                merged[f"rtt_native_store_{name}"] = {
                    "kind": "gauge",
                    "description": f"native slab store {name} (head host)",
                    "series": [{"tags": {"node": str(w.node_id)[:8]},
                                "value": float(val)}]}
        except Exception:  # noqa: BLE001 - store detached mid-collect
            pass
    merged.update(device_memory_gauges())
    return merged


def device_memory_gauges() -> Dict[str, dict]:
    """Per-card memory gauges from the CUDA caching allocator (SURVEY.md
    §5.5 rebuild note: per-device memory on the dashboard).

    Best-effort by design: only reads devices when torch is ALREADY
    imported and has initialised CUDA in this process (collecting metrics
    must never pay a torch import or create a CUDA context).  The
    allocator's counts cover this process's tensors, not other processes
    on the same card.
    """
    import sys as _sys
    torch_mod = _sys.modules.get("torch")
    if torch_mod is None:
        return {}
    try:
        if not torch_mod.cuda.is_initialized():
            return {}
    except AttributeError:  # a partial import: skip, never init
        return {}
    out: Dict[str, dict] = {}
    try:
        cuda = torch_mod.cuda
        for i in range(cuda.device_count()):
            props = cuda.get_device_properties(i)
            for mname, desc, value in (
                    ("rtt_device_hbm_bytes_in_use",
                     "device bytes currently allocated (CUDA allocator)",
                     cuda.memory_allocated(i)),
                    ("rtt_device_hbm_peak_bytes",
                     "peak device bytes allocated (CUDA allocator)",
                     cuda.max_memory_allocated(i)),
                    ("rtt_device_hbm_bytes_limit",
                     "device memory capacity (CUDA device properties)",
                     props.total_memory)):
                dst = out.setdefault(mname, {"kind": "gauge",
                                             "description": desc,
                                             "series": []})
                dst["series"].append(
                    {"tags": {"device": str(i), "kind": props.name},
                     "value": float(value)})
    except Exception:  # noqa: BLE001 - context torn down mid-collect
        return out
    return out


def _reset_for_tests() -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
        _REGISTRY_GEN[0] += 1
