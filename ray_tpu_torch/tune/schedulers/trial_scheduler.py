"""Scheduler interface.

Reference: ``python/ray/tune/schedulers/trial_scheduler.py`` — schedulers
see every streamed result and answer CONTINUE/STOP (+ optional
clone-from directives for PBT).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"

    def set_metric(self, metric: Optional[str], mode: Optional[str]) -> None:
        if getattr(self, "metric", None) is None:
            self.metric = metric
        if getattr(self, "mode", None) is None:
            self.mode = mode or "max"

    def on_trial_result(self, controller, trial, result: Dict[str, Any]) -> str:
        return self.CONTINUE

    def on_trial_complete(self, controller, trial,
                          result: Optional[Dict[str, Any]]) -> None:
        pass

    def choose_trial_to_run(self, controller):
        """Default: FIFO over pending trials."""
        for t in controller.trials:
            if t.status == "PENDING":
                return t
        return None


class FIFOScheduler(TrialScheduler):
    pass
