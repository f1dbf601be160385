"""Head-resident, fixed-memory metrics time-series store (DESIGN.md §4k).

The metrics plane (§4b) publishes per-process registry snapshots into
the GCS KV (``__metrics__/<worker>``); until this module the head threw
each snapshot's history away on the next publish, so nothing could
answer "what was the task rate five minutes ago" or "which rank's step
time is drifting".  :class:`TSDB` is the Prometheus/Monarch-shaped layer
built on top of that existing receipt path — the GCS hands every
snapshot it already receives to :meth:`TSDB.ingest` (zero new RPCs; see
``gcs._h_kv_put``), and the store keeps a bounded ring of samples per
series behind a query engine (``rate()`` / ``increase()`` /
``*_over_time()`` / ``quantile_over_time()`` with label matchers)
exposed via the ``metrics_query`` GCS op, ``state.metrics_history()``,
the dashboard's ``/metrics/history`` endpoint, and ``ray_tpu_torch top``.

Memory model (all bounds are fixed at construction):

- One :class:`Series` per (metric name, tagset incl. the publisher's
  ``worker`` tag).  Series count is bounded twice: per-metric by the
  §4b publisher-side cardinality cap, and globally by ``max_series``
  (beyond it new series are dropped and counted, never grown).
- Per series, a three-rung downsampling ladder of fixed-size rings:
  every received sample lands in the *raw* ring (one slot per publish,
  ~30min at the 5s default export period), and rolls up into the *mid*
  (30s resolution, ~4h) and *long* (300s resolution, ~48h) rings by
  last-sample-wins within a resolution bucket — correct for cumulative
  values (counters, histogram states) and honest for gauges (the rung
  you query tells you its resolution).  A query picks the finest rung
  that still covers the window's start.
- Counter and gauge samples are one float; histogram samples keep the
  full cumulative state ``(bucket counts, sum, count)`` so windowed
  quantiles and SLO burn rates come from *bucket deltas*, not guesses.

Timestamps are head receipt wall-clock (one clock for every series —
publisher clocks never skew a window), mirroring the §4b sweep's
receipt-time discipline.

Query syntax (the subset ``ray_tpu_torch top`` and the detectors need)::

    rtt_raylet_queue_depth                      latest value per series
    rtt_tasks_total{state="ok"}                 label matchers (= != =~)
    rate(rtt_tasks_total[60s])                  per-second increase
    increase(rtt_llm_tokens_total{phase="decode"}[5m])
    avg_over_time(rtt_llm_batch_occupancy[2m])  also min_/max_
    quantile_over_time(0.99, rtt_llm_ttft_seconds[5m])
    sum(rate(rtt_tasks_total[60s]))             whole-cluster scalars
    sum by (rank) (increase(rtt_train_step_seconds[1m]))

On top of the store run two always-on detectors (driven by the GCS
monitor loop, results emitted into the §4j fleet-event feed and the
§4h flight recorder): :class:`StragglerDetector` (per-rank train step
time vs the group median over a sliding window) and
:class:`SloBurnAlerter` (multi-window error-budget burn rates over the
latency histograms named by ``metrics_catalog.SLO_RULES``).

Locking: one leaf lock (``TSDB_LOCK_DAG`` in lock_watchdog.py) guards
the series table and rings; queries copy sample lists out under it and
evaluate outside.  Never acquired together with any GCS lock — the GCS
calls in with none of its own locks held.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TSDB", "Series", "StragglerDetector", "SloBurnAlerter",
    "QueryError", "parse_duration",
]

# Downsampling ladder: (resolution seconds, ring slots).  Rung 0 is the
# raw ring — one slot per received sample, resolution 0 meaning "as
# published".  Coverage at the 5s default export period: raw ~30min,
# mid 4h, long 48h.  DESIGN.md §4k discusses the sizing.
RAW_SLOTS_DEFAULT = 360
LADDER: Tuple[Tuple[float, int], ...] = ((30.0, 480), (300.0, 576))

# Hard ceiling on evaluation points per range query: the instant
# evaluation is pure Python on a GCS handler thread, so the step count
# — caller-controlled, possibly straight off a dashboard URL — must be
# bounded (a 60-point sparkline is the intended scale).
MAX_RANGE_STEPS = 2000

# A bare (windowless) selector answers with the newest sample no older
# than this — the §4b grace window, so a just-dead worker's final flush
# still reads as "current" exactly as long as the collector shows it.
STALENESS_S = 120.0

# Series that stop receiving samples are dropped once their newest
# sample ages past the longest rung's coverage — history survives the
# publisher by hours (the whole point), not forever (fixed memory).
IDLE_PRUNE_S = LADDER[-1][0] * LADDER[-1][1]


class QueryError(ValueError):
    """Malformed expression handed to :meth:`TSDB.query`."""


# --------------------------------------------------------------------- rings
class _Ring:
    """Fixed-capacity (ts, value) ring with last-wins resolution buckets.

    ``res == 0`` appends every sample (raw rung); ``res > 0`` overwrites
    the newest slot while the sample falls in the same ``ts // res``
    bucket (cumulative values downsample losslessly this way — the
    bucket keeps its final state)."""

    __slots__ = ("res", "cap", "_ts", "_val", "_n", "_head")

    def __init__(self, res: float, cap: int):
        self.res = res
        self.cap = cap
        self._ts: List[float] = [0.0] * cap
        self._val: List[Any] = [None] * cap
        self._n = 0          # filled slots
        self._head = 0       # next write index

    def add(self, ts: float, val: Any) -> None:
        if self.res > 0 and self._n:
            last_i = (self._head - 1) % self.cap
            if int(self._ts[last_i] // self.res) == int(ts // self.res):
                self._ts[last_i] = ts
                self._val[last_i] = val
                return
        self._ts[self._head] = ts
        self._val[self._head] = val
        self._head = (self._head + 1) % self.cap
        self._n = min(self._n + 1, self.cap)

    def oldest_ts(self) -> Optional[float]:
        if not self._n:
            return None
        return self._ts[(self._head - self._n) % self.cap]

    def newest_ts(self) -> Optional[float]:
        if not self._n:
            return None
        return self._ts[(self._head - 1) % self.cap]

    def samples(self, start: float, end: float) -> List[Tuple[float, Any]]:
        """(ts, value) pairs with start <= ts <= end, oldest first."""
        out: List[Tuple[float, Any]] = []
        base = (self._head - self._n) % self.cap
        for k in range(self._n):
            i = (base + k) % self.cap
            ts = self._ts[i]
            if start <= ts <= end:
                out.append((ts, self._val[i]))
        return out


class Series:
    """One (name, tagset) series: kind, boundaries, and its ring ladder."""

    __slots__ = ("name", "kind", "tags", "boundaries", "rings", "last_ts")

    def __init__(self, name: str, kind: str, tags: Dict[str, str],
                 boundaries: Optional[Tuple[str, ...]], raw_slots: int):
        self.name = name
        self.kind = kind
        self.tags = dict(tags)
        # histogram bucket upper bounds as published ("0.005"... "+Inf")
        self.boundaries = boundaries
        self.rings = [_Ring(0.0, raw_slots)] + \
            [_Ring(res, cap) for res, cap in LADDER]
        self.last_ts = 0.0

    def add(self, ts: float, val: Any) -> None:
        self.last_ts = ts
        for r in self.rings:
            r.add(ts, val)

    def window(self, start: float, end: float) -> List[Tuple[float, Any]]:
        """Samples over [start, end] from the finest rung covering start
        (falling back to coarser rungs when raw has already wrapped).
        When history is shorter than the window, every rung holds the
        full history — use the finest that reaches back furthest."""
        best = None
        best_oldest = None
        for r in self.rings:
            oldest = r.oldest_ts()
            if oldest is None:
                continue
            if oldest <= start:
                return r.samples(start, end)
            if best_oldest is None or oldest < best_oldest:
                best, best_oldest = r, oldest
        return best.samples(start, end) if best is not None else []


# --------------------------------------------------------------- expressions
_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)$")
_DUR_UNIT = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration(text: str) -> float:
    m = _DUR_RE.match(text.strip())
    if not m:
        raise QueryError(f"bad duration {text!r} (want e.g. 30s, 5m, 1h)")
    return float(m.group(1)) * _DUR_UNIT[m.group(2)]


# the matcher block ends at the first '}' OUTSIDE a quoted value —
# =~ regexes legitimately contain braces ({n} quantifiers), so the
# block body admits quoted strings with any escaped content
_SELECTOR_RE = re.compile(
    r"^\s*(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<matchers>(?:[^}"]|"(?:[^"\\]|\\.)*")*)\})?'
    r"(?:\[(?P<window>[^\]]+)\])?\s*$")
_MATCHER_RE = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*(=~|!=|=)\s*"((?:[^"\\]|\\.)*)"\s*')
_FUNC_RE = re.compile(
    r"^\s*(?P<fn>rate|increase|avg_over_time|min_over_time|max_over_time"
    r"|quantile_over_time)\s*\((?P<args>.*)\)\s*$", re.S)
_AGG_RE = re.compile(
    r"^\s*(?P<agg>sum|avg|max|min)\s*"
    r"(?:by\s*\(\s*(?P<by>[a-zA-Z0-9_,\s]*)\)\s*)?"
    r"\((?P<inner>.*)\)\s*$", re.S)

_OVER_TIME_FNS = ("avg_over_time", "min_over_time", "max_over_time")


class _Selector:
    def __init__(self, name: str, matchers: List[Tuple[str, str, str]],
                 window_s: Optional[float]):
        self.name = name
        self.matchers = matchers
        self.window_s = window_s

    def matches(self, tags: Dict[str, str]) -> bool:
        for key, op, val in self.matchers:
            got = tags.get(key, "")
            if op == "=" and got != val:
                return False
            if op == "!=" and got == val:
                return False
            if op == "=~" and re.fullmatch(val, got) is None:
                return False
        return True


def _parse_selector(text: str) -> _Selector:
    m = _SELECTOR_RE.match(text)
    if not m:
        raise QueryError(f"bad selector {text!r}")
    matchers: List[Tuple[str, str, str]] = []
    raw = m.group("matchers")
    if raw:
        pos = 0
        while pos < len(raw):
            mm = _MATCHER_RE.match(raw, pos)
            if not mm:
                raise QueryError(f"bad label matcher at {raw[pos:]!r}")
            val = mm.group(3).replace('\\"', '"').replace("\\\\", "\\")
            if mm.group(2) == "=~":
                # validate at parse time: a broken regex must be a
                # QueryError (the caller's 400), not a re.error at
                # match time that only fires once a series exists
                try:
                    re.compile(val)
                except re.error as exc:
                    raise QueryError(
                        f"bad =~ regex {val!r}: {exc}") from None
            matchers.append((mm.group(1), mm.group(2), val))
            pos = mm.end()
            if pos < len(raw):
                if raw[pos] != ",":
                    raise QueryError(f"expected ',' at {raw[pos:]!r}")
                pos += 1
    window = m.group("window")
    return _Selector(m.group("name"), matchers,
                     parse_duration(window) if window else None)


class _Expr:
    """Parsed query: optional aggregator over an optional function over
    one selector."""

    def __init__(self, fn: Optional[str], q: Optional[float],
                 sel: _Selector, agg: Optional[str],
                 by: Optional[Tuple[str, ...]]):
        self.fn = fn
        self.q = q
        self.sel = sel
        self.agg = agg
        self.by = by


def _parse_expr(text: str) -> _Expr:
    agg = by = None
    m = _AGG_RE.match(text)
    if m and m.group("inner").count("(") == m.group("inner").count(")"):
        agg = m.group("agg")
        if m.group("by") is not None:
            by = tuple(p.strip() for p in m.group("by").split(",")
                       if p.strip())
        text = m.group("inner")
    fn = q = None
    m = _FUNC_RE.match(text)
    if m:
        fn = m.group("fn")
        args = m.group("args").strip()
        if fn == "quantile_over_time":
            if "," not in args:
                raise QueryError("quantile_over_time(q, selector[window])")
            q_text, args = args.split(",", 1)
            try:
                q = float(q_text)
            except ValueError:
                raise QueryError(f"bad quantile {q_text!r}") from None
            if not 0.0 <= q <= 1.0:
                raise QueryError(f"quantile {q} outside [0, 1]")
        text = args
    sel = _parse_selector(text)
    if fn is not None and sel.window_s is None:
        raise QueryError(f"{fn}() needs a [window] on its selector")
    if fn is None and sel.window_s is not None:
        raise QueryError("a bare selector takes no [window] "
                         "(wrap it in rate()/increase()/*_over_time())")
    return _Expr(fn, q, sel, agg, by)


# ------------------------------------------------------------ sample algebra
def _scalar_of(kind: str, val: Any) -> float:
    """Instant value of one sample (histograms read as their count)."""
    if kind == "histogram":
        return float(val[2])
    return float(val)


def _counter_delta(first: float, rest: Iterable[float]) -> float:
    """Increase over a sample run with reset detection: a drop means
    the publisher restarted — each monotone run contributes its own
    growth (the post-reset value counts from zero)."""
    total = 0.0
    prev = first
    for v in rest:
        if v < prev:
            total += prev - first
            first = 0.0 if v >= 0 else v
        prev = v
    return total + (prev - first)


def _hist_delta(first, last) -> Tuple[List[float], float, float]:
    """Bucket-wise increase of a cumulative histogram state; a count
    reset restarts the window from zero (the post-reset state IS the
    increase since the reset)."""
    fc, fs, fn = first
    lc, ls, ln = last
    if ln < fn or len(lc) != len(fc):
        return list(lc), float(ls), float(ln)
    return [lc[i] - fc[i] for i in range(len(lc))], ls - fs, ln - fn


def _bucket_quantile(q: float, boundaries: Tuple[str, ...],
                     counts: List[float]) -> Optional[float]:
    """Prometheus-style histogram_quantile over per-bucket increases.

    ``boundaries`` are the finite upper bounds as strings (the "+Inf"
    bucket is counts[-1]); linear interpolation inside the hit bucket,
    with the +Inf bucket clamping to the highest finite bound."""
    total = sum(counts)
    if total <= 0:
        return None
    bounds = [float(b) for b in boundaries]
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c > 0:
            if i >= len(bounds):              # +Inf bucket
                return bounds[-1] if bounds else None
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * (target - (cum - c)) / c
    return bounds[-1] if bounds else None


def _empirical_quantile(q: float, values: List[float]) -> float:
    """Gauge-sample quantile: sorted values, linear interpolation at
    rank ``q * (n - 1)``."""
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = q * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


def _eval_samples(e: _Expr, rec: dict, now: float) -> Optional[float]:
    """One series' instant value for a parsed expression, from the
    window samples copied out under the store lock."""
    kind, samples = rec["kind"], rec["samples"]
    if e.fn is None:
        # bare selector: newest sample within the staleness window
        return _scalar_of(kind, samples[-1][1]) if samples else None
    if e.fn in ("rate", "increase"):
        if len(samples) < 2:
            return None
        span = samples[-1][0] - samples[0][0]
        if kind == "histogram":
            # rate()/increase() of a histogram = its observation count
            # (reset-aware over the scalar count sequence)
            delta = _counter_delta(
                samples[0][1][2], (v[2] for _, v in samples[1:]))
        else:
            delta = _counter_delta(samples[0][1],
                                   (v for _, v in samples[1:]))
        if e.fn == "increase":
            return delta
        return delta / span if span > 0 else None
    if e.fn in _OVER_TIME_FNS:
        vals = [_scalar_of(kind, v) for _, v in samples]
        if not vals:
            return None
        if e.fn == "avg_over_time":
            return sum(vals) / len(vals)
        return max(vals) if e.fn == "max_over_time" else min(vals)
    if e.fn == "quantile_over_time":
        if kind == "histogram":
            if len(samples) < 2 or rec["boundaries"] is None:
                return None
            counts, _, _ = _hist_delta(samples[0][1], samples[-1][1])
            return _bucket_quantile(e.q, rec["boundaries"], counts)
        vals = [float(v) for _, v in samples]
        if not vals:
            return None
        return _empirical_quantile(e.q, vals)
    raise QueryError(f"unhandled function {e.fn!r}")


# ----------------------------------------------------------------------- TSDB
class TSDB:
    """The store: ingest snapshots, answer instant + range queries."""

    def __init__(self, max_series: int = 4096,
                 raw_slots: int = RAW_SLOTS_DEFAULT,
                 clock: Callable[[], float] = time.time):
        self.max_series = int(max_series)
        self.raw_slots = max(16, int(raw_slots))
        self._clock = clock
        # one leaf lock (TSDB_LOCK_DAG): series table + rings + counters;
        # O(dict/ring op) critical sections only — queries copy samples
        # out under it and evaluate outside
        self._lock = threading.Lock()
        # (name, sorted tag tuple) -> Series     guarded by: _lock
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           Series] = {}
        # name -> its Series list: queries select by metric name first,
        # and a full-table scan per query would be O(tsdb_max_series)
        # under the lock on a GCS handler thread
        # guarded by: _lock
        self._by_name: Dict[str, List[Series]] = {}
        self._samples_total = 0                # guarded by: _lock
        self._dropped_series = 0               # guarded by: _lock
        self._last_prune = 0.0                 # guarded by: _lock

    # ------------------------------------------------------------- ingest
    def ingest(self, worker_id: str, payload: Any,
               now: Optional[float] = None) -> int:
        """One publisher snapshot (the raw ``__metrics__/`` KV bytes, or
        the decoded dict) into the rings.  Timestamped with head receipt
        time.  Returns samples stored; never raises on malformed input
        (telemetry must not take down the KV handler)."""
        try:
            if isinstance(payload, (bytes, bytearray)):
                payload = json.loads(payload)
            snapshot = payload["snapshot"]
        except Exception:  # noqa: BLE001 - corrupt snapshot: skip whole
            return 0
        stored = 0
        with self._lock:
            # stamped INSIDE the lock: export_since's cursor is a single
            # global high-water mark, so store order must match timestamp
            # order — a sample stamped before the lock could land BEHIND
            # an already-exported newest and be skipped forever
            ts = self._clock() if now is None else now
            for name, m in snapshot.items():
                kind = m.get("kind", "untyped")
                for s in m.get("series", ()):
                    try:
                        tags = dict(s["tags"])
                        tags["worker"] = worker_id
                        val = self._pack(kind, s["value"])
                    except Exception:  # noqa: BLE001 - one bad series
                        continue
                    key = (name, tuple(sorted(tags.items())))
                    ser = self._series.get(key)
                    if ser is None:
                        if len(self._series) >= self.max_series:
                            self._dropped_series += 1
                            continue
                        ser = Series(name, kind, tags,
                                     self._boundaries(kind, s["value"]),
                                     self.raw_slots)
                        self._series[key] = ser
                        self._by_name.setdefault(name, []).append(ser)
                    ser.add(ts, val)
                    stored += 1
            self._samples_total += stored
            nseries = len(self._series)
            if ts - self._last_prune > 300.0:
                self._last_prune = ts
                for key in [k for k, ser in self._series.items()
                            if ts - ser.last_ts > IDLE_PRUNE_S]:
                    ser = self._series.pop(key)
                    peers = self._by_name.get(key[0])
                    if peers is not None:
                        peers[:] = [s for s in peers if s is not ser]
                        if not peers:
                            del self._by_name[key[0]]
        self._publish_self_stats(nseries, stored)
        return stored

    @staticmethod
    def _pack(kind: str, value: Any):
        if kind == "histogram":
            # cumulative state: (per-bucket counts in bound order incl.
            # +Inf, sum, count) — windowed quantiles need the buckets
            return (tuple(value["buckets"].values()),
                    float(value["sum"]), float(value["count"]))
        return float(value)

    @staticmethod
    def _boundaries(kind: str, value: Any) -> Optional[Tuple[str, ...]]:
        if kind != "histogram":
            return None
        return tuple(b for b in value["buckets"] if b != "+Inf")

    def _publish_self_stats(self, nseries: int, stored: int) -> None:
        """Registry-side mirror of the store's own health (cataloged
        rtt_tsdb_* series; outside _lock — metric locks are theirs)."""
        if not stored:
            return
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            if not GLOBAL_CONFIG.metrics_enabled:
                return
            from ray_tpu_torch.util import metrics_catalog as mcat
            mcat.get("rtt_tsdb_series").set(nseries)
            mcat.get("rtt_tsdb_samples_total").inc(stored)
        except Exception:  # noqa: BLE001 - telemetry best-effort
            pass

    # --------------------------------------------------- replication export
    def export_since(self, since_ts: float) -> Tuple[List[dict], float]:
        """Raw-ring samples strictly newer than ``since_ts``, per
        series — the GCS replication hub ships these deltas to warm
        standbys (DESIGN.md §4l) so the head's metric history survives
        a failover.  Returns ``(dump, newest_ts)``; feed ``newest_ts``
        back as the next cursor.  Copies out under the leaf lock; cost
        scales with NEW samples, not store size, once the cursor
        advances."""
        out: List[dict] = []
        newest = since_ts
        with self._lock:
            for ser in self._series.values():
                if ser.last_ts <= since_ts:
                    continue
                samples = [(ts, v) for ts, v in
                           ser.rings[0].samples(since_ts, ser.last_ts)
                           if ts > since_ts]
                if not samples:
                    continue
                newest = max(newest, samples[-1][0])
                out.append({"name": ser.name, "kind": ser.kind,
                            "tags": dict(ser.tags),
                            "boundaries": ser.boundaries,
                            "samples": samples})
        return out, newest

    def seed(self, dump: Iterable[dict]) -> int:
        """Inverse of :meth:`export_since`: adopt exported samples into
        this store (a promoted standby inheriting the dead primary's
        history).  Samples route through ``Series.add`` so every ladder
        rung populates; per-series monotonicity (``ts > last_ts``)
        makes overlapping deltas idempotent; ``max_series`` is honored
        exactly like ingest."""
        added = 0
        with self._lock:
            for rec in dump:
                try:
                    name = rec["name"]
                    tags = dict(rec["tags"])
                    samples = rec.get("samples") or ()
                except Exception:  # noqa: BLE001 - one malformed record
                    continue
                key = (name, tuple(sorted(tags.items())))
                ser = self._series.get(key)
                if ser is None:
                    if len(self._series) >= self.max_series:
                        self._dropped_series += 1
                        continue
                    bounds = rec.get("boundaries")
                    ser = Series(name, rec.get("kind", "untyped"), tags,
                                 tuple(bounds) if bounds else None,
                                 self.raw_slots)
                    self._series[key] = ser
                    self._by_name.setdefault(name, []).append(ser)
                for ts, val in samples:
                    ts = float(ts)
                    if ts > ser.last_ts:
                        ser.add(ts, tuple(val)
                                if isinstance(val, list) else val)
                        added += 1
            self._samples_total += added
        return added

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"series": len(self._series),
                    "samples_total": self._samples_total,
                    "dropped_series": self._dropped_series,
                    "max_series": self.max_series}

    def list_series(self, match: Optional[str] = None) -> List[dict]:
        """Series metadata (name, kind, tags, newest sample age)."""
        sel = _parse_selector(match) if match else None
        now = self._clock()
        out = []
        with self._lock:
            for ser in self._series.values():
                if sel is not None and (ser.name != sel.name
                                        or not sel.matches(ser.tags)):
                    continue
                out.append({"name": ser.name, "kind": ser.kind,
                            "tags": dict(ser.tags),
                            "age_s": round(now - ser.last_ts, 3)})
        out.sort(key=lambda d: (d["name"], sorted(d["tags"].items())))
        return out

    # ------------------------------------------------------------- querying
    def _collect(self, sel: _Selector, start: float,
                 end: float) -> List[dict]:
        """Copy matching series' metadata + window samples out under the
        lock (rings mutate under ingest; evaluation happens outside).
        Name-indexed: cost scales with the metric's own tagsets, not
        the whole store."""
        out = []
        with self._lock:
            for ser in self._by_name.get(sel.name, ()):
                if not sel.matches(ser.tags):
                    continue
                out.append({"kind": ser.kind, "tags": dict(ser.tags),
                            "boundaries": ser.boundaries,
                            "samples": ser.window(start, end)})
        return out

    def query(self, expr: str, at: Optional[float] = None) -> List[dict]:
        """Instant query: ``[{"tags": {...}, "value": float}, ...]``.
        Series with no data in the window are omitted."""
        e = _parse_expr(expr)
        now = self._clock() if at is None else at
        window = e.sel.window_s if e.fn is not None else STALENESS_S
        rows: List[dict] = []
        for rec in self._collect(e.sel, now - window, now):
            v = _eval_samples(e, rec, now)
            if v is not None:
                rows.append({"tags": rec["tags"], "value": v})
        if e.agg is not None:
            rows = self._aggregate(e, rows)
        rows.sort(key=lambda r: sorted(r["tags"].items()))
        return rows

    def query_range(self, expr: str, start: Optional[float] = None,
                    end: Optional[float] = None,
                    step: Optional[float] = None) -> List[dict]:
        """Range query: the instant expression evaluated at each step —
        ``[{"tags": {...}, "points": [[ts, value], ...]}, ...]`` (the
        dashboard's sparkline feed).

        One parse and ONE locked collection cover the whole range (the
        rung is chosen once, for the earliest step's window); each step
        then evaluates over a bisected slice — a 60-point sparkline
        costs the store one lock acquisition, not sixty."""
        import bisect

        e = _parse_expr(expr)
        now = self._clock()
        end = now if end is None else float(end)
        start = end - 600.0 if start is None else float(start)
        if step is None:
            step = max((end - start) / 60.0, 1e-9)
        else:
            # caller-supplied (possibly straight off a URL): a zero /
            # negative step would spin this loop forever on a GCS
            # handler thread, and a microscopic one is the same DoS in
            # disguise — bound the step count, not just the sign
            step = float(step)
            if not step > 0:
                raise QueryError(f"step must be > 0 (got {step})")
            if (end - start) / step > MAX_RANGE_STEPS:
                raise QueryError(
                    f"range has more than {MAX_RANGE_STEPS} steps "
                    f"(span {end - start:.0f}s / step {step}s) — "
                    f"raise the step or narrow the range")
        window = e.sel.window_s if e.fn is not None else STALENESS_S
        recs = self._collect(e.sel, start - window, end)
        out: Dict[Tuple[Tuple[str, str], ...], dict] = {}
        ts = start
        while ts <= end + 1e-9:
            rows: List[dict] = []
            for rec in recs:
                samples = rec["samples"]
                lo = bisect.bisect_left(samples, ts - window,
                                        key=lambda s: s[0])
                hi = bisect.bisect_right(samples, ts,
                                         key=lambda s: s[0])
                v = _eval_samples(
                    e, {"kind": rec["kind"],
                        "boundaries": rec["boundaries"],
                        "samples": samples[lo:hi]}, ts)
                if v is not None:
                    rows.append({"tags": rec["tags"], "value": v})
            if e.agg is not None:
                rows = self._aggregate(e, rows)
            for row in rows:
                key = tuple(sorted(row["tags"].items()))
                dst = out.setdefault(key, {"tags": row["tags"],
                                           "points": []})
                dst["points"].append([round(ts, 3), row["value"]])
            ts += step
        return sorted(out.values(),
                      key=lambda r: sorted(r["tags"].items()))

    @staticmethod
    def _aggregate(e: _Expr, rows: List[dict]) -> List[dict]:
        groups: Dict[Tuple[Tuple[str, str], ...], List[float]] = {}
        for r in rows:
            key = tuple((k, r["tags"].get(k, "")) for k in (e.by or ()))
            groups.setdefault(key, []).append(r["value"])
        out = []
        for key, vals in groups.items():
            if e.agg == "sum":
                v = sum(vals)
            elif e.agg == "avg":
                v = sum(vals) / len(vals)
            elif e.agg == "max":
                v = max(vals)
            else:
                v = min(vals)
            out.append({"tags": dict(key), "value": v})
        return out

    # ----------------------------------------------------- detector helpers
    def windowed_mean_per_series(self, name: str, window_s: float,
                                 now: Optional[float] = None,
                                 min_count: int = 1) -> List[dict]:
        """Per-series histogram window mean (Δsum / Δcount) — the
        straggler detector's statistic.  Series with fewer than
        ``min_count`` new observations in the window are omitted."""
        now = self._clock() if now is None else now
        sel = _parse_selector(name)
        out = []
        for rec in self._collect(sel, now - window_s, now):
            samples = rec["samples"]
            if rec["kind"] != "histogram" or len(samples) < 2:
                continue
            _, dsum, dcount = _hist_delta(samples[0][1], samples[-1][1])
            if dcount < min_count or dcount <= 0:
                continue
            out.append({"tags": rec["tags"],
                        "mean": dsum / dcount, "count": dcount})
        return out

    def forecast(self, expr: str, horizon_s: float,
                 period_s: float = 86400.0, smooth_s: float = 600.0,
                 now: Optional[float] = None) -> List[dict]:
        """Seasonal-naive forecast: the predicted value of each matching
        series at ``now + horizon_s`` is its mean over the ``smooth_s``
        window ending one season earlier (``now + horizon_s -
        period_s``) — yesterday's value at the hour we are scaling for,
        read from whichever ladder rung still covers it (the 48h long
        rung holds two diurnal periods).  Cold start (no samples near
        the seasonal anchor yet) falls back to the mean over the most
        recent ``smooth_s``, i.e. "no better guess than now" — the
        autopilot's forecast reflex then never *withholds* capacity it
        would have requested reactively.

        Gauge (and untyped) series only — a forecast of a cumulative
        counter or histogram is not a level, so those are omitted.  Returns
        rows shaped like :meth:`query`, each with ``value`` (the
        prediction) and ``seasonal`` (False on the cold-start
        fallback)."""
        if horizon_s < 0:
            raise QueryError(f"horizon_s must be >= 0 (got {horizon_s})")
        if period_s <= 0:
            raise QueryError(f"period_s must be > 0 (got {period_s})")
        now = self._clock() if now is None else now
        sel = _parse_selector(expr)
        if sel.window_s is not None:
            raise QueryError("forecast() takes a bare selector "
                             "(no [window])")
        anchor = now + horizon_s - period_s
        rows: List[dict] = []
        for rec in self._collect(sel, anchor - smooth_s, now):
            if rec["kind"] not in ("gauge", "untyped"):
                continue    # counters/histograms: cumulative, not a level
            seasonal = [float(v) for ts, v in rec["samples"]
                        if anchor - smooth_s <= ts <= anchor]
            if seasonal:
                rows.append({"tags": rec["tags"],
                             "value": sum(seasonal) / len(seasonal),
                             "seasonal": True})
                continue
            recent = [float(v) for ts, v in rec["samples"]
                      if ts >= now - smooth_s]
            if recent:
                rows.append({"tags": rec["tags"],
                             "value": sum(recent) / len(recent),
                             "seasonal": False})
        rows.sort(key=lambda r: sorted(r["tags"].items()))
        return rows

    def burn_rate(self, series: str, threshold_s: float, objective: float,
                  window_s: float, now: Optional[float] = None
                  ) -> Optional[float]:
        """Error-budget burn over a window, aggregated across every
        tagset of ``series``: fraction of observations slower than
        ``threshold_s`` (by bucket deltas, threshold rounded UP to the
        next bucket bound) divided by the budget ``1 - objective``.
        1.0 = burning exactly at budget; None = no observations."""
        now = self._clock() if now is None else now
        sel = _parse_selector(series)
        bad = total = 0.0
        for rec in self._collect(sel, now - window_s, now):
            samples = rec["samples"]
            if rec["kind"] != "histogram" or rec["boundaries"] is None \
                    or len(samples) < 2:
                continue
            counts, _, dcount = _hist_delta(samples[0][1], samples[-1][1])
            if dcount <= 0:
                continue
            # cumulative count at the first bound >= threshold: every
            # observation provably <= threshold
            ok = 0.0
            for i, b in enumerate(rec["boundaries"]):
                ok += counts[i]
                if float(b) >= threshold_s:
                    break
            else:
                ok = dcount  # threshold above every finite bound
            bad += max(dcount - ok, 0.0)
            total += dcount
        if total <= 0:
            return None
        budget = max(1.0 - objective, 1e-9)
        return (bad / total) / budget


# ------------------------------------------------------------------ detectors
class StragglerDetector:
    """Per-rank train step-time skew vs the group median.

    Over a sliding ``window_s``, each ``rtt_train_step_seconds`` series
    (one per rank per worker process) yields a window-mean step time
    (Δsum/Δcount).  Series are COHORTED by their ``group`` tag before
    comparison (the elastic worker loop stamps its training group;
    untagged session runs form their own cohort): ranks are only
    stragglers relative to THEIR job's median — two concurrent jobs
    with different step times must not read each other as sick, and a
    cross-job median would misdirect the autopilot's drains.  Within a
    cohort of >= ``min_ranks`` active ranks, any rank whose mean
    exceeds ``ratio`` x the cohort median is a straggler — reported
    once per ``cooldown_s`` (default: the window) so a persistently
    slow rank doesn't flood the fleet-event feed.  The event carries
    the worker id; the GCS tags on the node id so the elasticity
    manager can drain the slow host."""

    SERIES = "rtt_train_step_seconds"

    def __init__(self, tsdb: TSDB, window_s: float = 30.0,
                 ratio: float = 1.75, min_steps: int = 3,
                 min_ranks: int = 3, cooldown_s: Optional[float] = None):
        self.tsdb = tsdb
        self.window_s = float(window_s)
        self.ratio = float(ratio)
        self.min_steps = int(min_steps)
        self.min_ranks = int(min_ranks)
        self.cooldown_s = self.window_s if cooldown_s is None \
            else float(cooldown_s)
        self._last_fired: Dict[Tuple[str, str], float] = {}

    def check(self, now: Optional[float] = None) -> List[dict]:
        now = self.tsdb._clock() if now is None else now
        # cooldown entries older than their window suppress nothing —
        # drop them, or worker churn grows this dict for the head's
        # lifetime (the store's fixed-memory contract applies here too)
        self._last_fired = {k: t for k, t in self._last_fired.items()
                            if now - t < self.cooldown_s}
        rows = self.tsdb.windowed_mean_per_series(
            self.SERIES, self.window_s, now=now, min_count=self.min_steps)
        cohorts: Dict[str, List[dict]] = {}
        for r in rows:
            cohorts.setdefault(r["tags"].get("group", ""), []).append(r)
        out: List[dict] = []
        for group, members in sorted(cohorts.items()):
            if len(members) < self.min_ranks:
                continue
            means = sorted(r["mean"] for r in members)
            mid = len(means) // 2
            median = means[mid] if len(means) % 2 \
                else (means[mid - 1] + means[mid]) / 2.0
            if median <= 0:
                continue
            for r in members:
                if r["mean"] <= self.ratio * median:
                    continue
                key = (r["tags"].get("rank", "?"),
                       r["tags"].get("worker", "?"))
                fired = self._last_fired.get(key, 0.0)
                if now - fired < self.cooldown_s:
                    continue
                self._last_fired[key] = now
                ev = {
                    "kind": "straggler",
                    "rank": key[0], "worker": key[1],
                    "mean_step_s": round(r["mean"], 6),
                    "median_step_s": round(median, 6),
                    "skew_ratio": round(r["mean"] / median, 3),
                    "steps": r["count"], "window_s": self.window_s}
                if group:
                    ev["group"] = group
                out.append(ev)
        return out


class SloBurnAlerter:
    """Multi-window error-budget burn alerts over latency histograms.

    Rules come from ``metrics_catalog.SLO_RULES`` (declared next to the
    series they reference so rtlint's metrics pass can prove each rule
    names a live cataloged histogram).  Classic multi-window gating: an
    alert fires only when BOTH the long and the short window burn above
    ``factor`` x budget — long filters blips, short proves it is still
    happening.  One alert per rule per ``cooldown`` (the short window)."""

    def __init__(self, tsdb: TSDB, rules: Iterable[dict]):
        self.tsdb = tsdb
        self.rules = tuple(rules)
        self._last_fired: Dict[Tuple[str, int], float] = {}

    def check(self, now: Optional[float] = None) -> List[dict]:
        now = self.tsdb._clock() if now is None else now
        out: List[dict] = []
        for rule in self.rules:
            for wi, (long_s, short_s, factor) in enumerate(rule["windows"]):
                long_burn = self.tsdb.burn_rate(
                    rule["series"], rule["threshold_s"], rule["objective"],
                    long_s, now=now)
                if long_burn is None or long_burn <= factor:
                    continue
                short_burn = self.tsdb.burn_rate(
                    rule["series"], rule["threshold_s"], rule["objective"],
                    short_s, now=now)
                if short_burn is None or short_burn <= factor:
                    continue
                key = (rule["name"], wi)
                if now - self._last_fired.get(key, 0.0) < short_s:
                    continue
                self._last_fired[key] = now
                out.append({
                    "kind": "slo_burn", "rule": rule["name"],
                    "series": rule["series"],
                    "threshold_s": rule["threshold_s"],
                    "objective": rule["objective"],
                    "burn_long": round(long_burn, 3),
                    "burn_short": round(short_burn, 3),
                    "factor": factor,
                    "window_long_s": long_s, "window_short_s": short_s})
        return out
