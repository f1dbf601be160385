"""Memory monitor: kill tasks under node memory pressure.

Reference: ``MemoryMonitor`` (``src/ray/util/``, wired into the raylet —
SURVEY.md §2.1 Util row): when a node's memory usage crosses a threshold,
the worker running the most-recently-started retriable task is killed and
the task fails with an OOM error that counts against ``max_retries`` —
preferring a targeted, retriable kill over the kernel OOM killer taking
out the raylet or an actor.

Policy here (matching the reference's task-killing policy shape):
- usage = used/total from cgroup v2 (``memory.current``/``memory.max``)
  when限 bounded, else ``/proc/meminfo`` (MemTotal - MemAvailable).
- above ``memory_usage_threshold`` → kill the LAST-STARTED running task's
  worker (newest-first: it has made the least progress and is likeliest
  part of the pressure spike); actors are never chosen (reference
  behavior: workers running retriable work first).
- the killed task is failed with ``OutOfMemoryError`` (retriable if the
  task has retries left — at-least-once, like any worker death).
"""

from __future__ import annotations

import os
from typing import Tuple

from ray_tpu_torch._private import rtlog

logger = rtlog.get("memory-monitor")

_CGROUP = "/sys/fs/cgroup"


def node_memory_usage() -> Tuple[int, int]:
    """(used_bytes, total_bytes) — cgroup v2 when memory-limited, else
    system-wide from /proc/meminfo."""
    try:
        raw_max = open(os.path.join(_CGROUP, "memory.max")).read().strip()
        if raw_max != "max":
            used = int(open(os.path.join(_CGROUP,
                                         "memory.current")).read())
            return used, int(raw_max)
    except (OSError, ValueError):
        pass
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        return 0, 0
    return max(0, total - avail), total


def _pid_is_local_worker(pid: int) -> bool:
    """True only when ``pid`` is a ray_tpu_torch worker process on THIS host —
    the proof required before os.kill'ing a pid the head didn't spawn."""
    if not pid:
        return False
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"ray_tpu_torch._private.worker_main" in f.read()
    except OSError:
        return False


def pick_oom_victim(gcs, node_id=None, require_proc=False):
    """Newest-started plain task worker (never actors, never the driver),
    optionally restricted to one node / to head-spawned (proc-backed)
    workers.  Shared by the head-local monitor and the per-node agent
    path (reference: MemoryMonitor runs per-node inside the raylet)."""
    with gcs.lock:
        candidates = []
        for w in gcs.workers.values():
            if w.state != "busy" or w.current_task is None:
                continue
            if node_id is not None and w.node_id != node_id:
                continue
            if require_proc and w.proc is None:
                continue
            spec = w.current_task
            if spec.get("is_actor_creation"):
                continue
            candidates.append((spec.get("_started_at", 0.0), w, spec))
        if not candidates:
            return None
        candidates.sort(key=lambda c: c[0])
        _, w, spec = candidates[-1]
        return w, spec


class MemoryMonitor:
    """Periodic check invoked from the GCS monitor loop.

    Scope: the HEAD machine only.  The usage signal below is read from
    this host's cgroup//proc/meminfo, so eligible victims are workers the
    head itself spawned (``w.proc is not None``) — plus proc-less workers
    on the head node whose pid is VERIFIED to be a local worker process
    (reattached survivors of a GCS restart; ``_pid_is_local_worker``).
    A proc-less WorkerState can otherwise belong to a remote NodeAgent
    whose pid lives in another host's pid namespace; ``os.kill`` on it
    from here would hit an arbitrary unrelated local process.  Remote
    hosts run their own monitor inside the NodeAgent (node_agent.py),
    which measures local pressure and kills pids it owns, with victim
    policy still decided here via the ``pick_oom_victim`` RPC."""

    def __init__(self, gcs):
        self.gcs = gcs
        self._last_check = 0.0
        self.kills = 0

    def maybe_kill(self, now: float) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        threshold = GLOBAL_CONFIG.memory_usage_threshold
        if threshold >= 1.0 or threshold <= 0:
            return  # disabled
        if now - self._last_check < GLOBAL_CONFIG.memory_monitor_interval_s:
            return
        self._last_check = now
        used, total = node_memory_usage()
        if not total or used / total < threshold:
            return
        victim = pick_oom_victim(self.gcs, require_proc=True)
        if victim is None:
            # Workers that reattached after a GCS restart are proc-less
            # but still local to this host: their pid is killable IF we
            # can prove it is really one of our worker processes (guards
            # against remote-agent pids from another host's namespace,
            # which reattach may have adopted onto the head node).
            victim = pick_oom_victim(self.gcs,
                                     node_id=self.gcs.head_node_id)
            if victim is not None and not _pid_is_local_worker(
                    victim[0].pid):
                victim = None
        if victim is None:
            logger.warning(
                "memory pressure %.0f%% above threshold %.0f%% but no "
                "killable head-local task worker (actors are exempt; "
                "remote workers are their agent's responsibility)",
                100 * used / total, 100 * threshold)
            return
        w, spec = victim
        logger.warning(
            "node memory %.0f%% >= %.0f%%: killing newest task %s "
            "(worker %s pid=%s) — reference MemoryMonitor policy",
            100 * used / total, 100 * threshold,
            spec.get("name", spec["task_id"]), w.worker_id[:8], w.pid)
        self.kills += 1
        spec["_oom_killed"] = True
        try:
            if w.proc is not None:
                w.proc.kill()
            else:  # verified-local reattached worker (see above)
                os.kill(w.pid, 9)
        except OSError:
            pass
        # death handling (retry bookkeeping, resource release, respawn)
        # rides the normal worker-death path via the monitor loop

    def _pick_victim(self):
        """Back-compat shim for tests: head-side victim policy."""
        return pick_oom_victim(self.gcs, require_proc=True)
