"""Goodput accounting: useful train steps per wall-second.

The chaos suite's contract upgrade (DESIGN.md §4j): surviving a
preemption is not enough — the metric is how many FIRST-TIME steps the
job completes per wall-second across the disruption.  A step re-run
after a restart-from-checkpoint (the work since the last gathered state
is recomputed) counts as waste, not progress; an elastic re-mesh avoids
the recompute entirely and pays only the quiesce → re-init pause.

The tracker is clock-agnostic (pass ``ts``) so the fleet simulator can
drive it on simulated time and a live training loop on wall time.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class GoodputTracker:
    def __init__(self, t0: Optional[float] = None):
        self._t0 = time.monotonic() if t0 is None else t0
        self._last_ts = self._t0
        self._max_step = -1        # highest step index ever completed
        self.useful_steps = 0      # first-time completions
        self.wasted_steps = 0      # re-runs after a restart
        self.pauses = 0            # recovery pauses recorded
        self.paused_s = 0.0        # time attributed to recovery

    def record_step(self, step: int, ts: Optional[float] = None) -> bool:
        """Record one completed step; returns True when it was useful
        (first-time) progress, False for a post-restart re-run."""
        self._last_ts = time.monotonic() if ts is None else ts
        if step > self._max_step:
            self._max_step = step
            self.useful_steps += 1
            return True
        self.wasted_steps += 1
        return False

    def add_progress(self, useful: float = 0.0, wasted: float = 0.0,
                     ts: Optional[float] = None) -> None:
        """Bulk accounting for the fleet simulator: fractional step
        credit accrued over a tick (useful = first-time progress,
        wasted = recompute of checkpoint-lost work)."""
        self._last_ts = time.monotonic() if ts is None else ts
        self.useful_steps += useful
        self.wasted_steps += wasted

    def record_pause(self, seconds: float) -> None:
        """Attribute recovery downtime (quiesce->resume, or cold-start)."""
        self.pauses += 1
        self.paused_s += max(seconds, 0.0)

    def wall_s(self, now: Optional[float] = None) -> float:
        now = self._last_ts if now is None else now
        return max(now - self._t0, 1e-9)

    def goodput(self, now: Optional[float] = None) -> float:
        """Useful steps per wall-second, disruptions included."""
        return self.useful_steps / self.wall_s(now)

    def summary(self, now: Optional[float] = None) -> Dict[str, float]:
        return {
            "useful_steps": self.useful_steps,
            "wasted_steps": self.wasted_steps,
            "wall_s": round(self.wall_s(now), 6),
            "goodput_steps_per_s": round(self.goodput(now), 6),
            "pauses": self.pauses,
            "paused_s": round(self.paused_s, 6),
        }
