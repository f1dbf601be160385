"""Per-worker training session.

Reference: ``python/ray/train/_internal/session.py`` — the
thread-local a worker's ``train_loop_per_worker`` talks to:
``train.report(metrics, checkpoint=)`` streams results back to the driver;
``train.get_checkpoint()`` hands the restore point after a failure;
``train.get_context()`` exposes rank/world info.

Transport: reports go through the GCS KV (namespace "train") under
``<run_id>/r/<iteration>/<rank>``; the driver polls (reference: a result
queue polled by the trainable).  Checkpoints are persisted worker-side to
the run's storage path (shared filesystem contract, like the reference's
shared ``storage_path``) and only the path travels through the KV.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.train._checkpoint import Checkpoint

NAMESPACE = "train"


class SessionStopped(Exception):
    """Raised by report() when the controller set this run's stop flag —
    the cooperative early-stop used by Tune schedulers (ASHA/PBT/stop
    criteria).  Trial wrappers catch it and exit cleanly."""

_session: Optional["_TrainSession"] = None
_lock = threading.Lock()


class TrainContext:
    """Reference: ``ray.train.get_context()`` — rank/world introspection."""

    def __init__(self, session: "_TrainSession"):
        self._s = session

    def get_world_size(self) -> int:
        return self._s.world_size

    def get_world_rank(self) -> int:
        return self._s.rank

    def get_local_rank(self) -> int:
        return self._s.local_rank

    def get_local_world_size(self) -> int:
        return self._s.local_world_size

    def get_node_rank(self) -> int:
        return self._s.node_rank

    def get_trial_name(self) -> str:
        return self._s.run_name

    def get_experiment_name(self) -> str:
        return self._s.run_name

    def get_storage_path(self) -> str:
        return self._s.storage_dir

    def get_mesh_config(self):
        """The trainer's ``mesh_config`` (None when it gave none): the
        layout a loop builds its mesh program with."""
        return self._s.mesh_config


class _TrainSession:
    def __init__(self, run_id: str, run_name: str, rank: int, world_size: int,
                 storage_dir: str, restore_checkpoint: Optional[Checkpoint],
                 local_rank: Optional[int] = None,
                 local_world_size: Optional[int] = None, node_rank: int = 0,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 attempt: int = 0, start_iteration: int = 0,
                 sync_report: bool = False, mesh_config: Any = None):
        self.run_id = run_id
        self.mesh_config = mesh_config
        self.run_name = run_name
        self.rank = rank
        self.world_size = world_size
        self.storage_dir = storage_dir
        self.restore_checkpoint = restore_checkpoint
        self.local_rank = rank if local_rank is None else local_rank
        self.local_world_size = (world_size if local_world_size is None
                                 else local_world_size)
        self.node_rank = node_rank
        self.dataset_shards = dataset_shards or {}
        self.attempt = attempt
        self.iteration = start_iteration
        # sync_report: block in report() until the controller consumed the
        # report (deleted the key).  Tune trials use this so scheduler
        # decisions (ASHA/PBT stops) are deterministic — the reference's
        # function-API report blocks on the trial executor the same way.
        self.sync_report = sync_report
        # step telemetry: report()-to-report() interval == one step
        self._last_report_mono = time.monotonic()
        self._last_report_wall = time.time()
        self._reported_once = False

    def _observe_step(self, metrics: Optional[Dict[str, Any]] = None) -> None:
        """Per-worker step telemetry: ``rtt_train_step_seconds`` +
        instantaneous throughput gauge (plus ``rtt_train_mfu`` /
        ``rtt_train_overlap_exposed_ms`` when the loop reports them),
        plus a ``train.step`` span on the
        cluster timeline so a slow step shows WHERE it went next to the
        device trace rows (tracing.profile_device).

        The FIRST interval of a session covers user setup — data loading,
        model init, the first step's kernel build and warm-up — not a steady-state step;
        it is kept out of the histogram (one 90s sample would dominate a
        0.5s/step run's sum) and emitted as its own honestly-named span."""
        now_mono, now_wall = time.monotonic(), time.time()
        step_s = now_mono - self._last_report_mono
        wall_t0 = self._last_report_wall
        self._last_report_mono = now_mono
        self._last_report_wall = now_wall
        first = not self._reported_once
        self._reported_once = True
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.util import metrics_catalog as mcat
        from ray_tpu_torch.util import tracing
        if GLOBAL_CONFIG.metrics_enabled and not first:
            rank = str(self.rank)
            # the run name cohorts a straggler detector's median: this
            # run's ranks are only compared among themselves
            mcat.get("rtt_train_step_seconds").observe(
                step_s, tags={"rank": rank,
                              "group": str(self.run_name or "")})
            if step_s > 0:
                mcat.get("rtt_train_throughput_steps_per_s").set(
                    1.0 / step_s, tags={"rank": rank})
            # Overlap-scheduled-step telemetry: training loops that
            # measure MFU / exposed-collective time (bench.py-style
            # accounting) report them as plain metric keys and the
            # session republishes them as fleet-visible gauges.
            metrics = metrics or {}
            if isinstance(metrics.get("mfu"), (int, float)):
                mcat.get("rtt_train_mfu").set(
                    float(metrics["mfu"]), tags={"rank": rank})
            if isinstance(metrics.get("overlap_exposed_ms"), (int, float)):
                mcat.get("rtt_train_overlap_exposed_ms").set(
                    float(metrics["overlap_exposed_ms"]),
                    tags={"rank": rank})
        span = tracing.current_span()
        name = ("train.setup_to_first_report" if first
                else f"train.step[{self.iteration}]")
        tracing._emit([{
            "name": name, "cat": "span",
            "ph": "X", "pid": tracing._host_pid(),
            "tid": threading.get_ident() % 100000,
            "ts": wall_t0 * 1e6, "dur": step_s * 1e6,
            "args": {**(span.to_dict() if span else {}),
                     "rank": self.rank, "iteration": self.iteration}}])

    # ------------------------------------------------------------ transport
    def _kv_put(self, key: str, value: bytes) -> None:
        internal_kv._internal_kv_put(key, value, namespace=NAMESPACE)

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self.iteration += 1
        self._observe_step(metrics)
        ckpt_path = None
        if checkpoint is not None:
            # attempt in the name: a restarted attempt must never collide
            # with (and retention must never delete) a prior attempt's dirs
            ckpt_path = os.path.join(
                self.storage_dir,
                f"checkpoint_a{self.attempt}_{self.iteration:06d}",
                f"rank_{self.rank}" if self.world_size > 1 else "")
            ckpt_path = ckpt_path.rstrip(os.sep)
            checkpoint.to_directory(ckpt_path)
        payload = pickle.dumps(
            {"metrics": dict(metrics), "checkpoint_path": ckpt_path,
             "iteration": self.iteration})
        key = f"{self.run_id}/r/{self.iteration}/{self.rank}"
        self._kv_put(key, payload)
        if self.sync_report:
            # Tune path only: block until the controller consumed the
            # report, then honor its stop decision.  Plain Train runs skip
            # both RPCs — nothing ever sets their stop flag.
            poll = 0.0005
            while internal_kv._internal_kv_get(key,
                                               namespace=NAMESPACE) is not None:
                time.sleep(poll)
                poll = min(poll * 2, 0.01)
            if internal_kv._internal_kv_get(f"{self.run_id}/ctl/stop",
                                            namespace=NAMESPACE) is not None:
                raise SessionStopped(self.run_id)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.restore_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        return self.dataset_shards.get(name)


# ----------------------------------------------------------------- public
def init_session(**kwargs) -> None:
    global _session
    with _lock:
        _session = _TrainSession(**kwargs)


def shutdown_session() -> None:
    global _session
    with _lock:
        _session = None


def get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active — ray_tpu_torch.train.report()/"
            "get_context() must be called inside train_loop_per_worker")
    return _session


def try_session() -> Optional[_TrainSession]:
    return _session
