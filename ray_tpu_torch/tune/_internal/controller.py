"""TuneController: the experiment event loop.

Reference: ``python/ray/tune/execution/tune_controller.py`` (older:
``trial_runner.py``): each trial is a remote execution;
the controller polls streamed results, consults the scheduler
(ASHA/PBT/median) for CONTINUE/STOP, enforces stop criteria, launches
pending trials up to the concurrency cap, and persists experiment state.

Trials run as framework TASKS (not long-lived actors): the trial wrapper
installs a train session (world_size=1) so ``tune.report`` shares the
Train report transport; early-stop is the session's cooperative stop flag
— schedulers never hard-kill a trial mid-step.

A trial task runs in a plain worker, which sees no card
(``CUDA_VISIBLE_DEVICES=""``): a trial reaches the card only through
what it launches, a ``TorchTrainer`` with ``use_gpu`` or a ``num_gpus``
actor, and the trial function owns that actor's lifetime (kill it in a
``finally``, so a trial stopped by ``SessionStopped`` frees its share).
"""

from __future__ import annotations

import base64
import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.train._internal.session import NAMESPACE
from ray_tpu_torch.tune.schedulers.trial_scheduler import (FIFOScheduler,
                                                     TrialScheduler)
from ray_tpu_torch.tune.trial import Trial

_POLL = 0.02


@ray_tpu_torch.remote
def _trial_task(run_id: str, fn_blob: bytes, config: Dict[str, Any],
                storage_dir: str, restore_path: Optional[str],
                start_iteration: int = 0, ckpt_freq: int = 0) -> None:
    """The trial wrapper (runs in a worker process)."""
    import inspect

    import cloudpickle

    from ray_tpu_torch.train._checkpoint import Checkpoint
    from ray_tpu_torch.train._internal import session as sess
    from ray_tpu_torch.train._internal.session import SessionStopped
    from ray_tpu_torch.tune.trainable import Trainable

    restore = (Checkpoint.from_directory(restore_path)
               if restore_path and os.path.isdir(restore_path) else None)
    os.makedirs(storage_dir, exist_ok=True)
    sess.init_session(run_id=run_id, run_name=run_id, rank=0, world_size=1,
                      storage_dir=storage_dir, restore_checkpoint=restore,
                      sync_report=True, start_iteration=start_iteration)
    try:
        obj = cloudpickle.loads(fn_blob)
        if inspect.isclass(obj) and issubclass(obj, Trainable):
            obj(config)._train_loop(ckpt_freq)
        else:
            result = obj(config)
            if isinstance(result, dict):
                sess.get_session().report(result)
    except SessionStopped:
        pass
    finally:
        sess.shutdown_session()


class TuneController:
    def __init__(self, trainable: Any, trials: List[Trial], *,
                 scheduler: Optional[TrialScheduler] = None,
                 searcher: Any = None,
                 metric: Optional[str] = None, mode: str = "max",
                 stop: Optional[Dict[str, Any]] = None,
                 max_concurrent: int = 4, storage_root: str = "",
                 experiment_name: str = "", checkpoint_config: Any = None):
        import cloudpickle
        self.fn_blob = cloudpickle.dumps(trainable)
        self.trials = trials
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_metric(metric, mode)
        self.metric = metric
        self.mode = mode
        self.stop = stop or {}
        self.max_concurrent = max_concurrent
        self.storage_root = storage_root
        self.experiment_name = experiment_name
        self.checkpoint_config = checkpoint_config
        self._last_state_save = 0.0
        os.makedirs(self.exp_dir, exist_ok=True)
        # Persist immediately: an experiment interrupted before any trial
        # completes must still be restorable.
        self._save_experiment_state()

    @property
    def exp_dir(self) -> str:
        return os.path.join(self.storage_root, self.experiment_name)

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.id == trial_id:
                return t
        return None

    def request_clone(self, trial: Trial, config: Dict[str, Any],
                      ckpt: str) -> None:
        trial.prepare_clone(config, ckpt)

    # ------------------------------------------------------------ transport
    def _request_stop(self, trial: Trial) -> None:
        if not trial.stop_requested:
            internal_kv._internal_kv_put(f"{trial.run_id}/ctl/stop", b"1",
                                         namespace=NAMESPACE)
            trial.stop_requested = True

    def _drain_reports(self, trial: Trial) -> None:
        """Process every queued report: record → scheduler decision →
        (maybe) set stop flag → ONLY THEN delete the key.  The reporter
        blocks on key deletion (sync_report), so a STOP decision is always
        visible to it at the next line it executes."""
        prefix = f"{trial.run_id}/r/"
        for k in sorted(internal_kv._internal_kv_list(prefix,
                                                      namespace=NAMESPACE),
                        key=lambda k: int(k.rsplit("/", 2)[1])):
            it = int(k.rsplit("/", 2)[1])
            if it in trial.seen_iters:
                continue
            blob = internal_kv._internal_kv_get(k, namespace=NAMESPACE)
            if blob is None:
                continue
            payload = pickle.loads(blob)
            trial.seen_iters.add(it)
            metrics = dict(payload["metrics"])
            metrics["training_iteration"] = it
            metrics["trial_id"] = trial.id
            if payload.get("checkpoint_path"):
                trial.latest_checkpoint_path = payload["checkpoint_path"]
                self._apply_checkpoint_retention(trial)
            trial.metrics_history.append(metrics)
            if self.searcher is not None:
                self.searcher.on_trial_result(trial.id, metrics)
            decision = self.scheduler.on_trial_result(self, trial, metrics)
            if decision == TrialScheduler.STOP or \
                    self._hit_stop_criteria(metrics):
                self._request_stop(trial)
            internal_kv._internal_kv_del(k, namespace=NAMESPACE)

    # ---------------------------------------------------------------- loop
    def _launch(self, trial: Trial) -> None:
        if trial.config is None and self.searcher is not None:
            trial.config = self.searcher.suggest(trial.id)
        storage = os.path.join(self.exp_dir, trial.id)
        # Clones/restores continue the iteration numbering (stop criteria
        # stay run-global).  When resuming from a checkpoint older than the
        # last report (checkpoint_frequency > 1), restart numbering at the
        # checkpoint's iteration so the gap is re-trained rather than
        # silently skipped.
        start_it = (max(trial.seen_iters | trial.all_seen_iters)
                    if (trial.seen_iters or trial.all_seen_iters) else 0)
        ckpt_it = _checkpoint_iteration(trial.restore_path)
        if ckpt_it is not None and ckpt_it < start_it:
            start_it = ckpt_it
            trial.metrics_history = [
                m for m in trial.metrics_history
                if m.get("training_iteration", 0) <= ckpt_it]
        ckpt_freq = getattr(self.checkpoint_config, "checkpoint_frequency",
                            0) or 0
        trial.ref = _trial_task.remote(trial.run_id, self.fn_blob,
                                       trial.config, storage,
                                       trial.restore_path, start_it,
                                       ckpt_freq)
        trial.status = "RUNNING"

    def _apply_checkpoint_retention(self, trial: Trial) -> None:
        """Keep only the newest ``num_to_keep`` checkpoint dirs of a trial
        (reference: ``CheckpointConfig.num_to_keep``)."""
        keep = getattr(self.checkpoint_config, "num_to_keep", None)
        if not keep or not trial.latest_checkpoint_path:
            return
        # Never delete a dir some trial still needs: its latest, a pending
        # PBT clone's donor checkpoint, or a restore point.
        pinned = set()
        for t in self.trials:
            pinned.add(t.latest_checkpoint_path)
            pinned.add(t.restore_path)
            if t.pending_clone is not None:
                pinned.add(t.pending_clone.get("ckpt"))
        trial_dir = os.path.dirname(trial.latest_checkpoint_path)
        try:
            ckpts = sorted(
                d for d in os.listdir(trial_dir)
                if d.startswith("checkpoint_")
                and os.path.isdir(os.path.join(trial_dir, d)))
        except OSError:
            return
        for d in ckpts[:-keep]:
            path = os.path.join(trial_dir, d)
            if path not in pinned:
                shutil.rmtree(path, ignore_errors=True)

    def _hit_stop_criteria(self, metrics: Dict[str, Any]) -> bool:
        # reference semantics: stop once attribute >= bound
        return any(metrics.get(k) is not None and metrics[k] >= bound
                   for k, bound in self.stop.items())

    def run(self) -> None:
        while True:
            running = [t for t in self.trials if t.status == "RUNNING"]
            # launch up to the cap (scheduler picks order)
            while len(running) < self.max_concurrent:
                nxt = self.scheduler.choose_trial_to_run(self)
                if nxt is None:
                    break
                self._launch(nxt)
                running.append(nxt)
            if not running:
                break

            for trial in running:
                self._drain_reports(trial)
                done, _ = ray_tpu_torch.wait([trial.ref], num_returns=1,
                                       timeout=0)
                if not done:
                    continue
                self._drain_reports(trial)  # final sweep
                try:
                    ray_tpu_torch.get(trial.ref)
                    trial.status = "TERMINATED"
                except (exc.RayTaskError, exc.RayActorError,
                        exc.ObjectLostError) as e:
                    trial.status = "ERROR"
                    trial.error = e
                self.scheduler.on_trial_complete(self, trial,
                                                 trial.last_result)
                if self.searcher is not None:
                    self.searcher.on_trial_complete(trial.id,
                                                    trial.last_result)
                # reclaim this launch's control/report keys
                internal_kv._internal_kv_del(f"{trial.run_id}/ctl/stop",
                                             namespace=NAMESPACE)
                if trial.pending_clone is not None:
                    trial.relaunch_as_clone()
                self._save_experiment_state()
            if time.monotonic() - self._last_state_save > 2.0:
                self._save_experiment_state()
            time.sleep(_POLL)
        self._save_experiment_state()

    # ------------------------------------------------------------- persist
    def _save_experiment_state(self) -> None:
        import cloudpickle
        self._last_state_save = time.monotonic()

        def b64(obj):
            try:
                return base64.b64encode(cloudpickle.dumps(obj)).decode()
            except Exception:  # noqa: BLE001 - unpicklable user object
                return None

        state_path = os.path.join(self.exp_dir, "experiment_state.json")
        # Merge with any prior state file: a restored run's controller only
        # holds the re-run trials, but previously TERMINATED trials must
        # stay discoverable.
        prior_trials = {}
        if os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    prior_trials = {t["id"]: t
                                    for t in json.load(f).get("trials", [])}
            except (OSError, ValueError):
                prior_trials = {}
        for t in self.trials:
            prior_trials[t.id] = {
                "id": t.id, "config": _jsonable(t.config),
                "status": t.status,
                "metrics_history": _jsonable(t.metrics_history),
                "latest_checkpoint_path": t.latest_checkpoint_path,
                "rungs_hit": sorted(t.rungs_hit),
            }
        state = {
            "experiment_name": self.experiment_name,
            "metric": self.metric,
            "mode": self.mode,
            "stop": _jsonable(self.stop),
            "scheduler_b64": b64(self.scheduler),
            "checkpoint_config_b64": b64(self.checkpoint_config),
            "trials": list(prior_trials.values()),
        }
        with open(state_path, "w") as f:
            json.dump(state, f, indent=1)


def _checkpoint_iteration(path: Optional[str]) -> Optional[int]:
    """Parse the iteration out of a ``checkpoint_a{N}_{IIIIII}`` dir name."""
    if not path:
        return None
    try:
        return int(os.path.basename(path.rstrip("/")).rsplit("_", 1)[1])
    except (IndexError, ValueError):
        return None


def _jsonable(x: Any) -> Any:
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        if isinstance(x, dict):
            return {str(k): _jsonable(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [_jsonable(v) for v in x]
        return repr(x)
