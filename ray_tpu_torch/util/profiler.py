"""Always-on sampling profiler + head-side profile store (DESIGN.md §4o).

Two halves:

- **Sampler** (one per non-client process): a jittered daemon thread at
  ``profiler_hz`` walks ``sys._current_frames()`` and folds every
  thread's stack into a bounded aggregate table ("folded" =
  root-to-leaf ``file:func`` labels joined with ``;`` — the flamegraph
  wire format).  A thread currently blocked inside a
  ``WatchdogLock.acquire`` is folded under a synthetic
  ``waiting:<lock>`` leaf frame so lock contention is visible in
  flames.  Deltas ride the §4b metrics-publisher cadence as JSON under
  the reserved ``__profile__/<worker_id>`` KV prefix (same
  reject-foreign-writes / strip-at-snapshot treatment as
  ``__metrics__/``).

- **ProfileStore** (head-resident): fixed-memory windowed receipts —
  per publishing process a bounded deque of ``(ts, folded-delta)``
  windows plus role/pid/node metadata.  History SURVIVES process death
  (windows are pruned only by ring capacity and idle age — the PR 10
  SIGKILL-churn contract), so a post-mortem can still ask what a dead
  worker was doing.  Cluster merges and window diffs are computed at
  query time from copies taken under the store's one no-block leaf
  ``_lock`` (PROFILER_LOCK_DAG).

Plus the dependency-free inline-SVG flamegraph writer behind
``ray_tpu_torch profile --flame`` and the dashboard ``/profile/flame``
endpoint.
"""

from __future__ import annotations

import collections
import json
import os
import random
import sys
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.util.tsdb import QueryError

PROFILE_KV_PREFIX = "__profile__/"

# one folded bucket absorbs everything past profiler_max_stacks so the
# table stays bounded no matter how polymorphic the workload is
OVERFLOW_KEY = "(overflow)"

MAX_FRAMES = 48          # deepest stack kept per sample (leafward wins)


def is_profile_key(key) -> bool:
    """True for keys under the reserved ``__profile__/`` prefix."""
    if isinstance(key, bytes):
        return key.startswith(b"__profile__/")
    return isinstance(key, str) and key.startswith(PROFILE_KV_PREFIX)


# --------------------------------------------------------------- lock waits
# thread ident -> lock name, written by WatchdogLock.acquire around its
# inner blocking acquire.  Single-key dict ops are GIL-atomic; readers
# (the sampler) tolerate torn iteration by copying.
_WAITING: Dict[int, str] = {}


def note_lock_wait(name: str) -> None:
    _WAITING[threading.get_ident()] = name


def clear_lock_wait() -> None:
    _WAITING.pop(threading.get_ident(), None)


# ------------------------------------------------------------------ sampler
class Sampler:
    """The in-process half: sample, fold, hand off deltas."""

    def __init__(self, role: str, hz: float, max_stacks: int):
        self.role = role
        self._period = 1.0 / max(0.5, float(hz))
        self._max_stacks = max(16, int(max_stacks))
        self._lock = threading.Lock()
        self._table: Dict[str, int] = {}     # guarded by: _lock
        self._samples = 0                    # guarded by: _lock
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"rtt-profiler-{role}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        # jittered so a fleet of samplers never beats in phase with the
        # workload (the same 0.75-1.25 spread the metrics publisher uses)
        while not self._stop.wait(self._period * random.uniform(0.75, 1.25)):
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 - sampling must never hurt
                pass

    def _sample_once(self) -> None:
        frames = sys._current_frames()
        me = threading.get_ident()
        waiting = dict(_WAITING)
        folded: List[str] = []
        for tid, frame in frames.items():
            if tid == me:
                continue
            parts: List[str] = []
            f = frame
            while f is not None and len(parts) < MAX_FRAMES:
                code = f.f_code
                parts.append(os.path.basename(code.co_filename)
                             + ":" + code.co_name)
                f = f.f_back
            parts.reverse()
            lock = waiting.get(tid)
            if lock:
                parts.append("waiting:" + lock)
            folded.append(";".join(parts))
        del frames
        with self._lock:
            self._samples += len(folded)
            for key in folded:
                cur = self._table.get(key)
                if cur is not None:
                    self._table[key] = cur + 1
                elif len(self._table) < self._max_stacks:
                    self._table[key] = 1
                else:
                    self._table[OVERFLOW_KEY] = \
                        self._table.get(OVERFLOW_KEY, 0) + 1

    def take_delta(self) -> Optional[dict]:
        """Swap out and return the aggregate since the last call."""
        with self._lock:
            if not self._samples:
                return None
            table, n = self._table, self._samples
            self._table, self._samples = {}, 0
        return {"samples": n, "stacks": table}

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


_SAMPLER: Optional[Sampler] = None
_install_lock = threading.Lock()


def maybe_install(role: str) -> Optional[Sampler]:
    """Start the process sampler once (first role wins), config-gated."""
    global _SAMPLER
    if not GLOBAL_CONFIG.profiler_enabled:
        return None
    with _install_lock:
        if _SAMPLER is None:
            _SAMPLER = Sampler(role, GLOBAL_CONFIG.profiler_hz,
                               GLOBAL_CONFIG.profiler_max_stacks)
        return _SAMPLER


def installed() -> Optional[Sampler]:
    return _SAMPLER


def close() -> None:
    """Stop and discharge the process sampler (idempotent)."""
    global _SAMPLER
    with _install_lock:
        s, _SAMPLER = _SAMPLER, None
    if s is not None:
        s.stop()


def local_payload(node_id: Optional[str] = None) -> Optional[dict]:
    """Drain the local sampler into a wire payload without the KV hop
    (the GCS head ingests its own samples directly)."""
    s = _SAMPLER
    if s is None:
        return None
    delta = s.take_delta()
    if delta is None:
        return None
    return {"ts": time.time(), "role": s.role, "pid": os.getpid(),
            "node_id": node_id, **delta}


def publish(worker=None) -> bool:
    """Ship the delta since the last publish to the head's KV plane.

    Piggybacks on the metrics publisher's cadence and connection; a
    failed put just drops one (lossy-by-design) sampling window.
    """
    s = _SAMPLER
    if s is None:
        return False
    if worker is None:
        from ray_tpu_torch._private.worker import global_worker
        worker = global_worker()
    delta = s.take_delta()
    if delta is None:
        return False
    from ray_tpu_torch.util import metrics_catalog as mcat
    t0 = time.perf_counter()
    payload = {"ts": time.time(), "role": s.role, "pid": os.getpid(),
               "node_id": getattr(worker, "node_id", None), **delta}
    worker.rpc("kv_put", _reconnect=False,
               key=PROFILE_KV_PREFIX + worker.worker_id,
               value=json.dumps(payload).encode())
    mcat.get("rtt_profile_samples_total").inc(delta["samples"])
    mcat.get("rtt_profile_stacks").set(float(len(delta["stacks"])))
    mcat.get("rtt_profile_publish_seconds").observe(
        time.perf_counter() - t0)
    return True


# ------------------------------------------------------------ profile store
class _Proc:
    __slots__ = ("role", "pid", "node_id", "last_ts", "windows")

    def __init__(self, role, pid, node_id):
        self.role = role
        self.pid = pid
        self.node_id = node_id
        self.last_ts = 0.0
        # (ts, samples, stacks) — stacks dicts are frozen after ingest
        self.windows = collections.deque(
            maxlen=ProfileStore.WINDOWS_PER_PROC)

    def key(self) -> str:
        return f"{self.role}:{self.pid}"


def _merge(into: Dict[str, int], stacks: Dict[str, int]) -> None:
    for k, v in stacks.items():
        into[k] = into.get(k, 0) + int(v)


class ProfileStore:
    """Head-side fixed-memory windowed folded-stack aggregates."""

    WINDOWS_PER_PROC = 60     # ~1h at the 60s publish cadence
    MAX_PROCS = 128           # churned-through dead procs beyond this
    IDLE_PRUNE_S = 3600.0     # are evicted oldest-first / past idle age

    def __init__(self, clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._procs: Dict[str, _Proc] = {}   # guarded by: _lock

    def ingest(self, worker_id: str, value) -> bool:
        """One ``__profile__/`` receipt (bytes or dict) -> the rings."""
        try:
            payload = value if isinstance(value, dict) \
                else json.loads(value)
            stacks = payload["stacks"]
            samples = int(payload["samples"])
            ts = float(payload.get("ts") or self._clock())
            if not isinstance(stacks, dict) or samples <= 0:
                return False
            stacks = {str(k): int(v) for k, v in stacks.items()}
        except (KeyError, TypeError, ValueError):
            return False
        role = str(payload.get("role") or "worker")
        pid = int(payload.get("pid") or 0)
        node_id = payload.get("node_id")
        now = self._clock()
        evict: List[_Proc] = []
        with self._lock:
            p = self._procs.get(worker_id)
            if p is None:
                p = self._procs[worker_id] = _Proc(role, pid, node_id)
            p.role, p.pid = role, pid
            if node_id:
                p.node_id = node_id
            p.last_ts = max(p.last_ts, ts)
            p.windows.append((ts, samples, stacks))
            if len(self._procs) > self.MAX_PROCS:
                victim = min(self._procs, key=lambda k:
                             self._procs[k].last_ts)
                evict.append(self._procs.pop(victim))
            for k in [k for k, q in self._procs.items()
                      if now - q.last_ts > self.IDLE_PRUNE_S]:
                evict.append(self._procs.pop(k))
        del evict
        return True

    def _copy_windows(self, since: float, until: float, proc=None,
                      node_id=None):
        """Window refs + proc meta, copied out under the leaf."""
        out = []
        meta = []
        with self._lock:
            for wid, p in self._procs.items():
                if proc is not None and proc not in (wid, p.key()):
                    continue
                if node_id is not None and p.node_id != node_id:
                    continue
                wins = [w for w in p.windows if since <= w[0] <= until]
                meta.append({"proc": p.key(), "worker_id": wid,
                             "role": p.role, "pid": p.pid,
                             "node_id": p.node_id, "last_ts": p.last_ts,
                             "windows": len(wins)})
                out.extend(wins)
        return out, meta

    def _aggregate(self, since: float, until: float, proc=None,
                   node_id=None) -> dict:
        wins, meta = self._copy_windows(since, until, proc, node_id)
        merged: Dict[str, int] = {}
        samples = 0
        for _, n, stacks in wins:
            samples += n
            _merge(merged, stacks)
        return {"samples": samples, "stacks": merged, "procs": meta}

    def profile(self, window_s: float = 300.0, proc=None,
                node_id=None) -> dict:
        if not (window_s > 0):
            raise QueryError(f"bad window_s {window_s!r}")
        now = self._clock()
        out = self._aggregate(now - float(window_s), now, proc, node_id)
        out["window_s"] = float(window_s)
        return out

    def diff(self, window_a: float, window_b: float, proc=None) -> dict:
        """Recent window A = [now-a, now] vs baseline B of length b
        immediately before it; ``diff`` is A's per-sample fraction
        minus B's for every stack in either."""
        if not (window_a > 0 and window_b > 0):
            raise QueryError(
                f"bad diff windows {window_a!r}/{window_b!r}")
        now = self._clock()
        a = self._aggregate(now - window_a, now, proc)
        b = self._aggregate(now - window_a - window_b,
                            now - window_a, proc)
        diff: Dict[str, float] = {}
        na, nb = max(1, a["samples"]), max(1, b["samples"])
        for k in set(a["stacks"]) | set(b["stacks"]):
            diff[k] = round(a["stacks"].get(k, 0) / na
                            - b["stacks"].get(k, 0) / nb, 6)
        return {"window_a_s": float(window_a),
                "window_b_s": float(window_b),
                "a": {"samples": a["samples"], "stacks": a["stacks"]},
                "b": {"samples": b["samples"], "stacks": b["stacks"]},
                "diff": diff}

    def stats(self) -> dict:
        with self._lock:
            return {"procs": len(self._procs),
                    "windows": sum(len(p.windows)
                                   for p in self._procs.values())}


# ------------------------------------------------------------ presentation
def parse_duration(text) -> float:
    """``'90'``/``'90s'``/``'5m'``/``'2h'`` -> seconds (QueryError on
    junk) — the CLI/dashboard window grammar."""
    if isinstance(text, (int, float)) and not isinstance(text, bool):
        val = float(text)
    else:
        s = str(text).strip().lower()
        mult = 1.0
        if s.endswith(("s", "m", "h")):
            mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[s[-1]]
            s = s[:-1]
        try:
            val = float(s) * mult
        except ValueError:
            raise QueryError(f"bad duration {text!r}") from None
    if not (val > 0) or val != val:
        raise QueryError(f"bad duration {text!r}")
    return val


def folded_text(stacks: Dict[str, int]) -> str:
    """Brendan Gregg folded format, heaviest first."""
    rows = sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
    return "\n".join(f"{k} {v}" for k, v in rows)


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _color(name: str) -> str:
    # deterministic warm palette keyed on the frame label; the
    # synthetic lock-wait frames render cold blue so contention pops
    if name.startswith("waiting:"):
        return "rgb(90,130,210)"
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) & 0xFFFFFF
    return (f"rgb({205 + (h % 50)},"
            f"{80 + ((h >> 8) % 100)},{(h >> 16) % 60})")


def render_flame_svg(stacks: Dict[str, int],
                     title: str = "ray_tpu_torch flame",
                     width: int = 1200) -> str:
    """Dependency-free flamegraph: folded aggregate -> inline SVG."""
    root: dict = {"c": {}, "v": 0}
    for folded, count in stacks.items():
        if not folded:
            continue
        root["v"] += count
        node = root
        for part in folded.split(";"):
            node = node["c"].setdefault(part, {"c": {}, "v": 0})
            node["v"] += count
    total = root["v"]
    row_h, font = 16, 11
    rects: List[str] = []

    def emit(name, node, x, y, w):
        if w < 0.5:
            return
        pct = 100.0 * node["v"] / total
        label = _esc(name)
        rects.append(
            f'<g><title>{label} ({node["v"]} samples, {pct:.1f}%)'
            f'</title><rect x="{x:.1f}" y="{y}" width="{w:.1f}" '
            f'height="{row_h - 1}" fill="{_color(name)}" rx="1"/>'
            + (f'<text x="{x + 2:.1f}" y="{y + row_h - 5}" '
               f'font-size="{font}" font-family="monospace" '
               f'fill="#fff">{label[:max(1, int(w / 7))]}</text>'
               if w > 20 else "") + "</g>")
        cx = x
        for cname in sorted(node["c"]):
            child = node["c"][cname]
            cw = w * child["v"] / node["v"]
            emit(cname, child, cx, y + row_h, cw)
            cx += cw

    def depth(node):
        return 1 + max((depth(c) for c in node["c"].values()),
                       default=0)

    if total <= 0:
        height = 2 * row_h + 24
        body = (f'<text x="8" y="{row_h + 30}" font-size="{font + 1}" '
                f'font-family="monospace">no samples in window</text>')
    else:
        height = (depth(root) + 1) * row_h + 24
        emit("all", root, 0.0, 24, float(width))
        body = "".join(rects)
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" viewBox="0 0 {width} {height}">'
            f'<rect width="100%" height="100%" fill="#fbf6ee"/>'
            f'<text x="8" y="16" font-size="{font + 2}" '
            f'font-family="monospace" font-weight="bold">'
            f'{_esc(title)} — {total} samples</text>{body}</svg>')
