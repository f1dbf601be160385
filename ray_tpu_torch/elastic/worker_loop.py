"""Worker-side elastic train loop: quiesce → re-mesh → re-shard → resume.

One ``TrainWorkerActor.apply`` call runs this loop for the actor's whole
life across every generation of the group.  Per generation the worker:

1. waits for a plan (``gen``, rank-ordered member list, coordinator
   address) in the ``elastic`` KV namespace;
2. joins the generation's gloo domain (``parallel/multihost.py``) and
   builds the user program over it (``spec.build``);
3. restores state — survivors re-shard their IN-PROCESS gathered host
   state via ``prog.restore_state`` (``put_global`` semantics); fresh
   processes (a rejoining node's worker, or a restart) pull the last
   gathered checkpoint from the KV instead;
4. steps until done or signalled.  The control signal is read from the
   KV by rank 0 ONLY and broadcast in-band to every rank
   (``multihost.broadcast_one_to_all``) so all ranks take the same branch
   at the same step — a rank-divergent stop would strand peers inside a
   collective;
5. on quiesce: gathers state to host on every rank, rank 0 publishes it,
   then EVERY member of the old domain — including the ranks about to be
   drained — leaves with ``multihost.shutdown()`` (the coordinated leave
   is what the ``node_draining`` advance warning buys: an unwarned
   SIGKILL breaks the survivors' collectives, which is the restart
   fallback) and acks.  Survivors loop back to (1); drained members
   return.

The surviving processes NEVER restart: a re-mesh costs one quiesce +
re-init + host→device re-shard, not an actor cold start.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import rtlog

logger = rtlog.get("elastic")

KV_NAMESPACE = "elastic"

# control signals broadcast from rank 0 (0 = keep stepping)
_SIG_STOP = -1


@dataclass
class ElasticSpec:
    """What the elastic workers run.

    ``build()`` executes on every worker AFTER the generation's domain
    is up, and returns a program object with four methods::

        init_state() -> state                  # fresh start (gen 0)
        restore_state(host_state) -> state     # host tree -> this rank
        gather_state(state) -> host_state      # full host copy, every rank
        step(state, i) -> (state, metrics)     # one train step

    ``gather_state`` must return the SAME global value on every rank
    (the ``multihost.gather_to_host`` contract) — it is the gathered
    checkpoint a re-mesh re-shards from.  ``gather_every`` is the
    checkpoint cadence: steps since the last gather are recomputed after
    an unwarned loss (never after a warned re-mesh, which always gathers
    at the quiesce boundary).
    """

    build: Callable[[], Any]
    total_steps: int
    gather_every: int = 1
    init_timeout_s: float = 120.0
    report_metrics: bool = True


# --------------------------------------------------------------------- KV
class ElasticKv:
    """The coordination keys one elastic group shares (namespace
    ``elastic``, prefix ``<group>/``): plan, quiesce intent, acks,
    gathered state, per-step reports, stop flag."""

    def __init__(self, group: str):
        self.group = group
        # newest object-plane state ref published from THIS process
        # (rank 0 keeps the blob alive until the next gather replaces
        # it; the manager holds its own borrow via peek_state_record).
        # _maybe_stale_ref: a "stateref" record may exist in the KV
        # (True at start — a restarted publisher cannot know); cleared
        # after the first inline-publish delete so the gather-every-
        # step hot path pays ONE delete RPC, not one per step
        self._state_ref: Optional[Any] = None
        self._maybe_stale_ref = True
        # the newest put_state / get_state: {"bytes", "s", "via"} (via
        # "kv" inline or "object" plane), kept in the generation records
        self.last_transfer: Optional[Dict[str, Any]] = None

    # -- raw ops (work from driver and worker processes alike)
    def _put(self, key: str, value: bytes) -> None:
        from ray_tpu_torch.experimental import internal_kv as kv
        kv._internal_kv_put(f"{self.group}/{key}", value,
                            namespace=KV_NAMESPACE)

    def _get(self, key: str) -> Optional[bytes]:
        from ray_tpu_torch.experimental import internal_kv as kv
        return kv._internal_kv_get(f"{self.group}/{key}",
                                   namespace=KV_NAMESPACE)

    def _del(self, key: str) -> None:
        from ray_tpu_torch.experimental import internal_kv as kv
        kv._internal_kv_del(f"{self.group}/{key}", namespace=KV_NAMESPACE)

    def _list(self, prefix: str) -> List[str]:
        from ray_tpu_torch.experimental import internal_kv as kv
        return kv._internal_kv_list(f"{self.group}/{prefix}",
                                    namespace=KV_NAMESPACE)

    # -- plan / quiesce / ack
    def put_plan(self, plan: dict) -> None:
        self._put("plan", pickle.dumps(plan, protocol=5))

    def get_plan(self) -> Optional[dict]:
        blob = self._get("plan")
        return pickle.loads(blob) if blob else None

    def put_quiesce(self, gen: int) -> None:
        self._put("quiesce", pickle.dumps({"gen": gen}))

    def clear_quiesce(self) -> None:
        """Retract a quiesce intent (a failed transition must not leave
        the stale key to ambush workers that haven't seen it yet)."""
        self._del("quiesce")

    def peek_quiesce(self) -> Optional[dict]:
        blob = self._get("quiesce")
        return pickle.loads(blob) if blob else None

    def ack(self, gen: int, worker_id: str) -> None:
        self._put(f"ack/{gen}/{worker_id}", b"1")

    def acked(self, gen: int) -> List[str]:
        prefix = f"{self.group}/ack/{gen}/"
        return [k[len(prefix):] for k in self._list(f"ack/{gen}/")]

    def put_stop(self) -> None:
        self._put("stop", b"1")

    def stopped(self) -> bool:
        return self._get("stop") is not None

    # -- gathered state (the checkpoint a re-mesh re-shards from).
    # Small states ride the KV inline (head-durable, one hop, crash-
    # safe); states above ``elastic_state_inline_max_bytes`` are
    # published to the object plane and pulled PEER-TO-PEER over the
    # streaming data plane — a multi-GB gathered state never transits
    # the head.  The object holds the record itself, so its arrays ride
    # out of band: one copy into the segment on publish, none out of it
    # on a pull on the same host.  The KV then holds only a small record
    # with the ObjectRef; the publisher keeps the newest ref alive
    # in-process and the manager adopts a borrow (``peek_state_record``)
    # so the blob outlives the publishing worker across restarts.  The
    # durability trade: an unwarned loss of BOTH the publisher's node
    # and the manager loses the blob where the inline path would have
    # survived.
    def put_state(self, host_state: Any, step: int, gen: int) -> None:
        import cloudpickle
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.serialization import (serialize,
                                                          serialized_size)
        t0 = time.perf_counter()
        record = {"step": step, "gen": gen, "state": host_state}
        size = serialized_size(*serialize(record)[:2])
        if size <= GLOBAL_CONFIG.elastic_state_inline_max_bytes:
            blob = cloudpickle.dumps(record, protocol=5)
            self._put("state", blob)
            if self._maybe_stale_ref:
                self._del("stateref")    # no object to adopt anymore
                self._maybe_stale_ref = False
            self._state_ref = None       # inline copy supersedes the ref
            self._transferred(len(blob), t0, "kv")
            return
        import ray_tpu_torch
        ref = ray_tpu_torch.put(record)
        rec = pickle.dumps({"step": step, "gen": gen, "ref": ref},
                           protocol=5)
        self._put("state", rec)
        # duplicate SMALL record under its own key: the manager's
        # adoption poll reads only this (absent for inline states), so
        # it never ships a multi-MB inline checkpoint over the KV just
        # to discover there is nothing to adopt
        self._put("stateref", rec)
        self._maybe_stale_ref = True
        # hold the NEWEST ref until the next publish replaces it — a
        # put's refcount follows the local handle, and the KV stores
        # bytes, not a borrow
        self._state_ref = ref
        self._transferred(size, t0, "object")

    def _transferred(self, nbytes: int, t0: float, via: str) -> None:
        self.last_transfer = {"bytes": nbytes, "via": via,
                              "s": time.perf_counter() - t0}

    def peek_state_record(self) -> Optional[dict]:
        """The object-plane state record WITHOUT resolving the blob
        (None when the newest checkpoint is inline) — unpickling
        registers a borrow on the embedded ref, which is exactly why
        the manager calls this: holding the returned record keeps an
        object-plane checkpoint alive across worker restarts."""
        blob = self._get("stateref")
        return pickle.loads(blob) if blob else None

    def get_state(self) -> Optional[dict]:
        """The newest gathered checkpoint, or None.  An object-plane
        record whose blob is gone (owner node + every borrow lost —
        the documented durability trade) degrades to None with a loud
        log: the group restarts from scratch instead of wedging on an
        unfetchable ref."""
        t0 = time.perf_counter()
        blob = self._get("state")
        if blob is None:
            return None
        rec = pickle.loads(blob)
        if "ref" not in rec:
            self._transferred(len(blob), t0, "kv")
            return rec
        import ray_tpu_torch
        from ray_tpu_torch._private.serialization import (serialize,
                                                          serialized_size)
        try:
            out = ray_tpu_torch.get(rec["ref"])    # streamed peer pull
        except Exception:  # noqa: BLE001 - blob lost with its holders
            logger.error(
                "elastic[%s] gathered checkpoint (step %s) lost from "
                "the object plane — its holder died before the manager "
                "adopted a borrow; restarting from scratch",
                self.group, rec.get("step"), exc_info=True)
            return None
        self._transferred(serialized_size(*serialize(out)[:2]), t0,
                          "object")
        return out

    # -- per-step reports (rank 0): the manager polls + deletes
    def report(self, step: int, gen: int, metrics: Dict[str, Any]) -> None:
        self._put(f"r/{step}", pickle.dumps(
            {"step": step, "gen": gen, "ts": time.time(),
             "metrics": metrics}))

    def poll_reports(self) -> List[dict]:
        out = []
        for key in sorted(self._list("r/")):
            blob = self._get(key[len(f"{self.group}/"):])
            if blob is None:
                continue
            out.append(pickle.loads(blob))
            self._del(key[len(f"{self.group}/"):])
        return sorted(out, key=lambda r: r["step"])

    def clear(self) -> None:
        for key in self._list(""):
            self._del(key[len(f"{self.group}/"):])


# -------------------------------------------------------------- the loop
def elastic_worker_loop(group: str, worker_id: str, spec_blob: bytes,
                        min_gen: int = 0) -> dict:
    """Entry point run via ``TrainWorkerActor.apply`` — one call spans
    every generation this worker participates in.  ``min_gen`` is the
    first plan generation this worker may act on (0 for founders; the
    join/restart generation for workers spawned later, so they ignore
    the stale pre-join plan).  Returns the worker's participation
    record (the no-cold-start evidence the tests assert): pid, and
    per-generation {gen, rank, world, start/end step, cold}."""
    import cloudpickle

    spec: ElasticSpec = cloudpickle.loads(spec_blob)
    kv = ElasticKv(group)
    from ray_tpu_torch.parallel import multihost

    pid = os.getpid()
    generations: List[dict] = []
    host_state: Optional[Any] = None   # survivor's in-RAM gathered state
    host_step = 0

    while True:
        plan = _wait_for_plan(kv, worker_id, min_gen, spec.init_timeout_s)
        if plan is None:           # excluded from the current plan
            return _result(worker_id, pid, generations, drained=True)
        gen, members = plan["gen"], plan["members"]
        rank, world = members.index(worker_id), len(members)
        if world > 1:
            multihost.initialize(plan["coordinator"], world, rank,
                                 init_timeout_s=spec.init_timeout_s)
        prog = spec.build()
        cold = not generations     # first generation in THIS process
        pulled = None
        if host_state is None:
            blob = kv.get_state()
            if blob is not None:
                host_state, host_step = blob["state"], blob["step"]
                pulled = kv.last_transfer
        if host_state is None:
            state, step = prog.init_state(), 0
        else:
            state, step = prog.restore_state(host_state), host_step
        # "pulled": the checkpoint this process fetched to start from;
        # "published": rank 0's state publishes in this generation
        grec = {"gen": gen, "rank": rank, "world": world, "pid": pid,
                "start_step": step, "end_step": step, "cold": cold,
                "pulled": pulled, "published": []}
        generations.append(grec)
        logger.info("elastic[%s] %s gen=%d rank=%d/%d from step %d "
                    "(%s)", group, worker_id[:8], gen, rank, world, step,
                    "cold" if cold else "re-meshed")

        # per-rank step-time histogram: the straggler detector reads
        # rtt_train_step_seconds, so an elastic run is node-tagged and
        # autopilot-drainable exactly like a TorchTrainer session run.
        # The group tag cohorts the comparison — this job's ranks are
        # only ever measured against THIS job's median, never against
        # an unrelated (faster or slower) run sharing the cluster
        step_hist = None
        if spec.report_metrics:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            if GLOBAL_CONFIG.metrics_enabled:
                from ray_tpu_torch.util import metrics_catalog as mcat
                step_hist = mcat.get("rtt_train_step_seconds")

        target_gen = None
        while step < spec.total_steps:
            t_step = time.monotonic()
            state, metrics = prog.step(state, step)
            if step_hist is not None:
                step_hist.observe(time.monotonic() - t_step,
                                  tags={"rank": str(rank),
                                        "group": group})
            step += 1
            if step % spec.gather_every == 0 or step == spec.total_steps:
                host_state, host_step = prog.gather_state(state), step
                if rank == 0:
                    # the KV copy is what an UNWARNED loss restarts
                    # from — publish at the gather cadence, not just at
                    # quiesce, or a SIGKILL rolls back to the last
                    # planned transition instead of the last checkpoint
                    kv.put_state(host_state, host_step, gen)
                    grec["published"].append(
                        dict(kv.last_transfer, step=host_step))
            if rank == 0 and spec.report_metrics:
                kv.report(step - 1, gen, _plain_metrics(metrics))
            sig = 0
            if rank == 0:
                q = kv.peek_quiesce()
                if q and q["gen"] > gen:
                    sig = q["gen"]
                elif kv.stopped():
                    sig = _SIG_STOP
            sig = int(multihost.broadcast_one_to_all(sig))
            if sig:
                target_gen = sig
                break
        grec["end_step"] = step

        # quiesce: the state published here IS the checkpoint the next
        # generation re-shards from — gather at the boundary if the
        # cadence left it stale
        if host_step < step:
            host_state, host_step = prog.gather_state(state), step
        # (unless the cadence just published this very step's state)
        if rank == 0 and target_gen != _SIG_STOP and not (
                grec["published"]
                and grec["published"][-1]["step"] == host_step):
            kv.put_state(host_state, host_step, gen)
            grec["published"].append(dict(kv.last_transfer, step=host_step))
        state = prog = None   # drop device refs before the domain goes
        multihost.shutdown()
        if target_gen is None or target_gen == _SIG_STOP:
            return _result(worker_id, pid, generations,
                           drained=target_gen == _SIG_STOP,
                           completed=target_gen is None)
        # clean leave done: tell the manager this member is out of the
        # old domain (it publishes the new plan once everyone acked)
        kv.ack(target_gen, worker_id)
        min_gen = target_gen


def _plain_metrics(metrics: Any) -> Dict[str, Any]:
    out = {}
    for k, v in (metrics or {}).items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out


def _wait_for_plan(kv: ElasticKv, worker_id: str, min_gen: int,
                   timeout_s: float) -> Optional[dict]:
    """Block until a plan with gen >= min_gen exists.  Returns None when
    that plan excludes this worker (drained), or raises on timeout (the
    manager sees the actor error and falls back to a restart)."""
    deadline = time.monotonic() + max(timeout_s, 1.0)
    while time.monotonic() < deadline:
        plan = kv.get_plan()
        if plan is not None and plan["gen"] >= min_gen:
            if worker_id in plan["members"]:
                return plan
            return None        # explicitly planned out -> drained
        time.sleep(0.05)
    raise TimeoutError(
        f"elastic worker {worker_id[:8]} saw no plan >= gen {min_gen} "
        f"in {timeout_s:.0f}s")


def _result(worker_id: str, pid: int, generations: List[dict], *,
            drained: bool = False, completed: bool = False) -> dict:
    return {"worker_id": worker_id, "pid": pid,
            "generations": generations, "drained": drained,
            "completed": completed}
