"""Trial state.

Reference: ``python/ray/tune/experiment/trial.py`` — one hyperparameter
configuration's lifecycle: PENDING → RUNNING → TERMINATED | ERROR.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Set


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.id = trial_id
        self.config = config
        self.status = "PENDING"
        self.ref = None                     # running task ref
        # KV report channel — unique per process+launch so a re-run of a
        # same-named experiment can never see a stale stop flag
        self.run_id = f"{trial_id}_{uuid.uuid4().hex[:6]}"
        self.metrics_history: List[Dict[str, Any]] = []
        self.latest_checkpoint_path: Optional[str] = None
        self.restore_path: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.rungs_hit: Set[int] = set()    # ASHA bookkeeping
        self.clone_count = 0
        self.pending_clone: Optional[Dict[str, Any]] = None
        self.seen_iters: Set[int] = set()
        self.all_seen_iters: Set[int] = set()  # across clone relaunches
        self.stop_requested = False

    @property
    def last_result(self) -> Optional[Dict[str, Any]]:
        return self.metrics_history[-1] if self.metrics_history else None

    def prepare_clone(self, config: Dict[str, Any], ckpt: str) -> None:
        self.pending_clone = {"config": config, "ckpt": ckpt}

    def relaunch_as_clone(self) -> None:
        spec = self.pending_clone
        self.pending_clone = None
        self.clone_count += 1
        self.config = spec["config"]
        self.restore_path = spec["ckpt"]
        self.run_id = f"{self.id}_c{self.clone_count}_{uuid.uuid4().hex[:6]}"
        self.status = "PENDING"
        self.ref = None
        self.all_seen_iters |= self.seen_iters
        self.seen_iters = set()
        self.stop_requested = False

    def __repr__(self) -> str:
        return f"Trial({self.id}, {self.status})"
