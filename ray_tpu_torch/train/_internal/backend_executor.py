"""Backend executor: drives the worker group through a training run.

Reference: ``python/ray/train/_internal/backend_executor.py``: start the
placement group and workers, run backend hooks, run
``train_loop_per_worker`` on every worker, poll streamed results, restart
the group from the last checkpoint on worker failure (``FailureConfig``).
"""

from __future__ import annotations

import os
import pickle
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig, RunConfig,
                                ScalingConfig)
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.session import NAMESPACE
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.util import tracing

_POLL = 0.02


def _run_train_fn(run_id: str, run_name: str, rank: int, world_size: int,
                  storage_dir: str, restore_ckpt_path: Optional[str],
                  train_fn_blob: bytes,
                  config: Dict[str, Any],
                  dataset_shard_blobs: Optional[Dict[str, Any]],
                  attempt: int = 0, start_iteration: int = 0,
                  mesh_config: Any = None) -> Any:
    """Runs inside each worker actor."""
    import cloudpickle

    from ray_tpu_torch.train._internal import session as sess

    restore = None
    if restore_ckpt_path:
        # per-rank shards live under rank_<r>/ for multi-worker runs; fall
        # back to rank_0's (a worker the saved run did not have) or the base
        for cand in (os.path.join(restore_ckpt_path, f"rank_{rank}"),
                     os.path.join(restore_ckpt_path, "rank_0"),
                     restore_ckpt_path):
            if os.path.isdir(cand):
                restore = Checkpoint.from_directory(cand)
                break
    shards = {}
    if dataset_shard_blobs:
        shards = {k: cloudpickle.loads(v)
                  for k, v in dataset_shard_blobs.items()}
    sess.init_session(run_id=run_id, run_name=run_name, rank=rank,
                      world_size=world_size, storage_dir=storage_dir,
                      restore_checkpoint=restore, dataset_shards=shards, attempt=attempt,
                      start_iteration=start_iteration, mesh_config=mesh_config)
    try:
        train_fn = cloudpickle.loads(train_fn_blob)
        import inspect
        takes_config = len(inspect.signature(train_fn).parameters) >= 1
        return train_fn(config) if takes_config else train_fn()
    finally:
        sess.shutdown_session()


def _setup_session_only(run_id, run_name, rank, world_size, storage_dir,
                        attempt) -> None:
    """Pre-backend-hook session so hooks can read rank/attempt info."""
    from ray_tpu_torch.train._internal import session as sess
    sess.init_session(run_id=run_id, run_name=run_name, rank=rank,
                      world_size=world_size, storage_dir=storage_dir,
                      restore_checkpoint=None, attempt=attempt)


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig, scaling: ScalingConfig,
                 run_config: Optional[RunConfig] = None,
                 mesh_config: Any = None):
        self.backend_config = backend_config
        self.mesh_config = mesh_config
        self.backend = backend_config.backend_cls()
        self.scaling = scaling
        self.run_config = run_config or RunConfig()
        self.run_id = uuid.uuid4().hex[:12]
        self.run_name = self.run_config.name or f"train_{self.run_id}"
        self.storage_dir = os.path.join(
            self.run_config.resolved_storage_path(), self.run_name)
        os.makedirs(self.storage_dir, exist_ok=True)
        self.worker_group: Optional[WorkerGroup] = None
        self.attempt = 0

    # ------------------------------------------------------------ lifecycle
    def start(self, restore_rank_info: bool = True) -> None:
        self.worker_group = WorkerGroup(
            self.scaling, self.backend_config.init_timeout_s)
        wg = self.worker_group
        # per-rank session bootstrap (ranks differ per worker → per-rank call)
        ray_tpu_torch.get([
            w.apply.remote(_setup_session_only, self.run_id, self.run_name,
                           i, wg.num_workers, self.storage_dir,
                           self.attempt)
            for i, w in enumerate(wg.workers)])
        # spans make slow backend bring-up (collective bootstrap) visible
        # on the timeline next to the train.step spans the session emits
        # per report
        with tracing.trace("train.backend_setup"):
            self.backend.on_start(wg, self.backend_config)
            self.backend.on_training_start(wg, self.backend_config)

    def shutdown(self, force: bool = False) -> None:
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group,
                                         self.backend_config)
            except Exception:  # noqa: BLE001
                pass
            self.worker_group.shutdown(force=force)
            self.worker_group = None

    # -------------------------------------------------------------- results
    def _kv(self, kind: str, **kw):
        return ray_tpu_torch._private.worker.global_worker().rpc(
            kind, namespace=NAMESPACE, **kw)

    def _poll_reports(self, seen: set) -> List[Dict]:
        """Collect complete iterations (all ranks reported) in order."""
        keys = self._kv("kv_keys", prefix=f"{self.run_id}/r/")["keys"]
        by_iter: Dict[int, List[str]] = {}
        for k in keys:
            parts = k.split("/")
            by_iter.setdefault(int(parts[2]), []).append(k)
        out = []
        for it in sorted(by_iter):
            if it in seen or len(by_iter[it]) < self.scaling.num_workers:
                continue
            ranks = {}
            for k in by_iter[it]:
                payload = pickle.loads(self._kv("kv_get", key=k)["value"])
                ranks[int(k.split("/")[3])] = payload
                self._kv("kv_del", key=k)
            seen.add(it)
            out.append({"iteration": it, "ranks": ranks})
        return out

    # ---------------------------------------------------------------- run
    def run(self, train_fn: Callable, config: Optional[Dict] = None,
            datasets: Optional[Dict[str, Any]] = None) -> Result:
        import cloudpickle
        fn_blob = cloudpickle.dumps(train_fn)
        failure = self.run_config.failure_config or FailureConfig()
        ckpt_cfg = self.run_config.checkpoint_config or CheckpointConfig()
        failures = 0
        latest_ckpt_path: Optional[str] = None
        history: List[Dict[str, Any]] = []
        checkpoints: List[tuple] = []  # (path, metrics)

        while True:
            if self.worker_group is None:
                self.start()
            wg = self.worker_group
            shard_blobs = self._split_datasets(datasets, wg.num_workers)
            refs = [
                w.apply.remote(_run_train_fn, self.run_id, self.run_name, i,
                               wg.num_workers, self.storage_dir,
                               latest_ckpt_path, fn_blob,
                               dict(config or {}),
                               shard_blobs[i] if shard_blobs else None,
                               self.attempt, len(history), self.mesh_config)
                for i, w in enumerate(wg.workers)]
            seen: set = set()
            error: Optional[BaseException] = None
            try:
                pending = list(refs)
                while pending:
                    done, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                                 timeout=_POLL)
                    for batch in self._poll_reports(seen):
                        self._record(batch, history, checkpoints, ckpt_cfg)
                    for d in done:
                        ray_tpu_torch.get(d)  # raises on worker failure
            except (exc.RayActorError, exc.RayTaskError,
                    exc.ObjectLostError) as e:
                error = e
            # final sweep for reports that landed before the refs resolved
            for batch in self._poll_reports(seen):
                self._record(batch, history, checkpoints, ckpt_cfg)
            if checkpoints:
                latest_ckpt_path = checkpoints[-1][0]

            if error is None:
                return self._result(history, checkpoints, None)
            failures += 1
            if failure.max_failures != -1 and failures > failure.max_failures:
                return self._result(history, checkpoints, error)
            # restart from the last checkpoint (the worker group is the
            # failure domain).  Clear the dead attempt's leftover report
            # keys so they are not replayed.
            self.shutdown(force=True)
            self.attempt += 1
            for k in self._kv("kv_keys", prefix=f"{self.run_id}/r/")["keys"]:
                self._kv("kv_del", key=k)

    def _record(self, batch: Dict, history: List, checkpoints: List,
                ckpt_cfg: CheckpointConfig) -> None:
        rank0 = batch["ranks"].get(0) or next(iter(batch["ranks"].values()))
        metrics = dict(rank0["metrics"])
        metrics["training_iteration"] = batch["iteration"]
        history.append(metrics)
        if rank0.get("checkpoint_path"):
            base = rank0["checkpoint_path"]
            # multi-worker: rank dirs live under checkpoint_%06d/
            if os.path.basename(base).startswith("rank_"):
                base = os.path.dirname(base)
            checkpoints.append((base, metrics))
            self._enforce_retention(checkpoints, ckpt_cfg)

    def _enforce_retention(self, checkpoints: List,
                           ckpt_cfg: CheckpointConfig) -> None:
        keep = ckpt_cfg.num_to_keep
        if not keep or len(checkpoints) <= keep:
            return
        import shutil
        for path, _ in checkpoints[:-keep]:
            shutil.rmtree(path, ignore_errors=True)
        del checkpoints[:-keep]

    def _result(self, history, checkpoints, error) -> Result:
        last_ckpt = (Checkpoint.from_directory(self._rank0_dir(
            checkpoints[-1][0])) if checkpoints else None)
        best = [(Checkpoint.from_directory(self._rank0_dir(p)), m)
                for p, m in checkpoints]
        return Result(metrics=history[-1] if history else None,
                      checkpoint=last_ckpt, path=self.storage_dir,
                      error=error, metrics_history=history,
                      best_checkpoints=best)

    def _rank0_dir(self, base: str) -> str:
        r0 = os.path.join(base, "rank_0")
        return r0 if os.path.isdir(r0) else base

    def _split_datasets(self, datasets, n: int):
        if not datasets:
            return None
        import cloudpickle
        out: List[Dict[str, bytes]] = [dict() for _ in range(n)]
        for name, ds in datasets.items():
            split = getattr(ds, "split", None)
            shards = ds.split(n) if callable(split) else [ds] * n
            for i in range(n):
                out[i][name] = cloudpickle.dumps(shards[i])
        return out
