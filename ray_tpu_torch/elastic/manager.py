"""Elasticity manager: the head-side controller of DESIGN.md §4j (port
of ``ray_tpu/elastic/manager.py``).

Owns one elastic train group end to end: spawns the worker actors
(one per schedulable node — the node is the elasticity unit), publishes
generation plans, watches the GCS fleet-event feed, and drives the
three transitions:

- **re-mesh** (warned preemption / ``node_draining``): quiesce at a step
  boundary → every old-domain rank leaves cleanly → survivors
  re-initialize at the new world size and re-shard from the gathered
  state.  Surviving processes stay alive — no cold start.
- **join** (scale-up / a drained node's capacity restored): same quiesce
  cycle with the new worker included in the next plan; only the joiner
  pays a cold start.
- **restart** (unwarned SIGKILL): the survivors' collectives fail with
  their peer; the manager force-kills the remains, respawns a fresh
  group, and resumes from the last gathered state in the KV — the
  restart-from-checkpoint baseline behavior, kept as the fallback.

Workers are the port's ``TrainWorkerActor``s; a ``"GPU"`` share in
``resources_per_worker`` makes each one a ``num_gpus`` actor, which the
GCS places in a GPU worker process (one that sees the card) on the
picked node.  Progress is accounted by
:class:`~ray_tpu_torch.elastic.goodput.GoodputTracker` (useful steps per
wall-second, re-runs excluded) and every transition is reported to the
GCS (``elastic_event``) so ``ray_tpu_torch status`` shows the last
re-mesh cluster-wide.
"""

from __future__ import annotations

import socket
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.elastic import events as fleet
from ray_tpu_torch.elastic.goodput import GoodputTracker
from ray_tpu_torch.elastic.worker_loop import (ElasticKv, ElasticSpec,
                                               elastic_worker_loop)
from ray_tpu_torch.util import metrics_catalog as mcat

logger = rtlog.get("elastic")


@dataclass
class ElasticConfig:
    """Manager knobs.

    num_workers: TARGET world size — the group runs degraded below it
        after preemptions and re-grows on scale-up.
    min_workers: below this the manager stops re-meshing smaller and
        waits for capacity (a restart can still re-form at >= min).
    cpus_per_worker: actor resource request.
    spread: place at most one worker per node (the node failure-domain
        model; requires enough schedulable nodes) — node affinity rides
        the ``node:<id>`` resource.
    auto_rejoin: scale back up automatically when capacity appears.
    poll_s: manager reconcile period.
    """

    num_workers: int = 2
    min_workers: int = 1
    cpus_per_worker: float = 1.0
    # extra per-worker resource claims (a GPU share, custom resources)
    # — scheduled alongside cpus_per_worker so elastic workers account
    # for devices exactly like BackendExecutor workers do
    resources_per_worker: Optional[Dict[str, float]] = None
    spread: bool = True
    auto_rejoin: bool = True
    poll_s: float = 0.1
    group: Optional[str] = None
    quiesce_timeout_s: float = 60.0
    max_restarts: int = 4


@dataclass
class ElasticResult:
    history: List[dict] = field(default_factory=list)
    worker_results: List[dict] = field(default_factory=list)
    transitions: List[dict] = field(default_factory=list)
    goodput: Dict[str, Any] = field(default_factory=dict)
    error: Optional[BaseException] = None

    @property
    def generations(self) -> int:
        return max((t["generation"] for t in self.transitions), default=0)


class _Member:
    """One live worker actor of the group."""

    def __init__(self, worker_id: str, actor: Any, node_id: str):
        self.worker_id = worker_id
        self.actor = actor
        self.node_id = node_id
        self.ref: Any = None           # the running loop's result ref

    def __repr__(self) -> str:
        return f"_Member({self.worker_id[:8]}@{self.node_id[:8]})"


class ElasticityManager:
    def __init__(self, spec: ElasticSpec, config: ElasticConfig):
        import cloudpickle
        self.spec = spec
        self.config = config
        self.group = config.group or f"eg_{uuid.uuid4().hex[:8]}"
        self._spec_blob = cloudpickle.dumps(spec)
        self.kv = ElasticKv(self.group)
        self.goodput = GoodputTracker()
        self._gen = -1
        self._members: List[_Member] = []
        self._leavers: List[_Member] = []
        self._completing = False
        self._force_restart = False
        self._drained_nodes: set = set()
        self._transitions: List[dict] = []
        self._history: List[dict] = []
        self._worker_results: List[dict] = []
        self._restarts = 0
        # adopted object-plane state record (§4n): unpickling the KV
        # record borrows the embedded ObjectRef, so holding it here
        # keeps a large gathered checkpoint alive across worker
        # restarts (the publishing rank's own ref dies with it).  The
        # raw bytes are cached so an unchanged record is not
        # re-borrowed every poll.
        self._state_rec: Optional[dict] = None
        self._state_raw: Optional[bytes] = None
        self._events = fleet.FleetEventSubscriber(
            self._on_fleet_event,
            kinds=("node_draining", "node_added", "node_removed",
                   "node_undrained"))

    # ------------------------------------------------------------ lifecycle
    def fit(self, timeout_s: float = 600.0) -> ElasticResult:
        """Run the group to completion (or failure-budget exhaustion)."""
        deadline = time.monotonic() + timeout_s
        error: Optional[BaseException] = None
        self.kv.clear()
        try:
            self._start_group(cold=True)
            # the subscriber is polled INLINE from this loop (no thread):
            # transitions mutate manager state, and one writer beats a
            # lock discipline
            while time.monotonic() < deadline:
                self._collect_reports()
                self._events.poll_once()
                done = self._reap_members()
                if done is None and self._force_restart:
                    # a transition failed in a way that may have split
                    # the domain (some members quiesced, some not):
                    # recover deterministically instead of waiting for
                    # worker timeouts to surface as actor errors
                    done = False
                if done is not None:
                    self._force_restart = False
                    if done:            # completed cleanly
                        break
                    # hard failure -> restart fallback
                    self._restarts += 1
                    if self._restarts > self.config.max_restarts:
                        error = RuntimeError(
                            f"elastic group {self.group}: restart budget "
                            f"({self.config.max_restarts}) exhausted")
                        break
                    self._restart_group()
                time.sleep(self.config.poll_s)
            else:
                error = TimeoutError(
                    f"elastic group {self.group} did not finish in "
                    f"{timeout_s:.0f}s")
        except BaseException as e:  # noqa: BLE001 - surface in the result
            error = e
        finally:
            # the head may be the thing that died: the final sweep and
            # teardown must not raise out of fit() past the actor kills
            try:
                self._collect_reports()
            except Exception:  # noqa: BLE001
                logger.debug("final report sweep failed", exc_info=True)
            self._teardown()
        return ElasticResult(
            history=self._history, worker_results=self._worker_results,
            transitions=list(self._transitions),
            goodput=self.goodput.summary(now=time.monotonic()),
            error=error)

    # ------------------------------------------------------------- spawning
    def _pick_nodes(self, count: int, exclude: set) -> List[dict]:
        from ray_tpu_torch.util import state
        need = dict(self.config.resources_per_worker or {})
        need.pop("CPU", None)
        nodes = [n for n in state.list_nodes()
                 if n["alive"] and n["phase"] == "running"
                 and n["node_id"] not in exclude
                 and all(n["resources_available"].get(k, 0.0) >= v
                         for k, v in need.items())]
        nodes.sort(key=lambda n: -n["resources_available"].get("CPU", 0.0))
        if self.config.spread:
            return nodes[:count]
        return [nodes[i % len(nodes)] for i in range(count)] if nodes else []

    def _spawn_member(self, node: dict) -> _Member:
        from ray_tpu_torch.train._internal.worker_group import \
            TrainWorkerActor
        worker_id = f"ew_{uuid.uuid4().hex[:8]}"
        res = dict(self.config.resources_per_worker or {})
        res.pop("CPU", None)   # CPU rides cpus_per_worker
        # a GPU share makes a num_gpus actor: a GPU worker process that
        # sees the node's cards
        gpus = float(res.pop("GPU", 0.0))
        if self.config.spread:
            # node-affinity via the node-id resource: the worker IS the
            # node's representative, so it must live on that node
            res[f"node:{node['node_id']}"] = 0.001
        actor = TrainWorkerActor.options(
            num_cpus=self.config.cpus_per_worker, num_gpus=gpus,
            resources=res or None).remote()
        member = _Member(worker_id, actor, node["node_id"])
        return member

    def _launch_loops(self, members: List[_Member], min_gen: int) -> None:
        for m in members:
            if m.ref is None:
                m.ref = m.actor.apply.remote(
                    elastic_worker_loop, self.group, m.worker_id,
                    self._spec_blob, min_gen)

    def _start_group(self, cold: bool) -> None:
        want = self.config.num_workers
        nodes = self._pick_nodes(want, exclude=self._drained_nodes)
        if len(nodes) < self.config.min_workers:
            raise RuntimeError(
                f"elastic group {self.group}: only {len(nodes)} "
                f"schedulable node(s) for min_workers="
                f"{self.config.min_workers}")
        self._members = [self._spawn_member(n) for n in nodes[:want]]
        self._gen += 1
        self._launch_loops(self._members, self._gen)
        self._publish_plan()
        self._record_transition("start" if cold else "restart")

    def _publish_plan(self) -> None:
        plan = {"gen": self._gen,
                "members": [m.worker_id for m in self._members],
                "coordinator": f"{_host_ip()}:{_free_port()}"}
        self.kv.put_plan(plan)
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_elastic_generation").set(
                float(self._gen), tags={"group": self.group})

    # ----------------------------------------------------------- transitions
    def _remesh(self, action: str,
                exclude_workers: Optional[set] = None,
                joiners: Optional[List[_Member]] = None) -> bool:
        """One quiesce → re-plan cycle.  Returns False when the quiesce
        acks did not all arrive (a member died mid-drain) — the caller
        falls back to the restart path."""
        t0 = time.monotonic()
        old = list(self._members)
        survivors = [m for m in old
                     if m.worker_id not in (exclude_workers or set())]
        new_members = survivors + list(joiners or [])
        if not survivors:
            return False               # nothing survives -> restart path
        target = self._gen + 1
        self.kv.put_quiesce(target)
        deadline = time.monotonic() + self.config.quiesce_timeout_s
        need = {m.worker_id for m in old}
        while time.monotonic() < deadline:
            if need.issubset(set(self.kv.acked(target))):
                break
            # a member dying mid-quiesce dooms the clean leave
            if self._any_member_failed(old):
                return self._abandon_quiesce()
            time.sleep(0.02)
        else:
            return self._abandon_quiesce()
        self._gen = target
        self._leavers.extend(m for m in old if m not in new_members)
        self._members = new_members
        self._launch_loops(self._members, self._gen)
        self._publish_plan()
        # leavers observe the new plan, return "drained", and are reaped
        # by _reap_leavers; their actors die with them
        dur = time.monotonic() - t0
        self.goodput.record_pause(dur)
        self._record_transition(action, duration_s=dur)
        return True

    def _abandon_quiesce(self) -> bool:
        """A transition could not complete: retract the quiesce intent
        (workers that haven't seen it must not walk into a plan that
        will never come) and schedule a deterministic restart — members
        that DID ack are already out of the old domain, so the group
        state is split and only a restart reconciles it."""
        try:
            self.kv.clear_quiesce()
        except Exception:  # noqa: BLE001 - head trouble; restart anyway
            pass
        self._force_restart = True
        return False

    def _restart_group(self) -> None:
        """Unwarned loss: kill what remains, respawn fresh, resume from
        the last gathered state (the KV checkpoint)."""
        t0 = time.monotonic()
        for m in self._members + self._leavers:
            try:
                ray_tpu_torch.kill(m.actor)
            except Exception:  # noqa: BLE001 - already dead
                pass
        self._members = []
        self._leavers = []
        # stale quiesce intent must not immediately re-trigger on the
        # fresh group: the new plan's gen supersedes it
        self._start_group(cold=False)
        self.goodput.record_pause(time.monotonic() - t0)

    def _record_transition(self, action: str, **extra) -> None:
        rec = {"action": action, "generation": self._gen,
               "world_size": len(self._members),
               "ts": time.time(), **extra}
        self._transitions.append(rec)
        logger.info("elastic[%s] %s -> gen=%d world=%d", self.group,
                    action, self._gen, len(self._members))
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_elastic_remesh_total").inc(
                tags={"action": action})
            if "duration_s" in extra:
                mcat.get("rtt_elastic_remesh_seconds").observe(
                    extra["duration_s"], tags={"action": action})
        try:
            _worker_mod.global_worker().rpc(
                "elastic_event", group=self.group, action=action,
                generation=self._gen,
                world_size=len(self._members),
                detail={k: v for k, v in extra.items()})
        except Exception:  # noqa: BLE001 - status surface is best-effort
            logger.debug("elastic_event report failed", exc_info=True)

    # ------------------------------------------------------------- reconcile
    def _on_fleet_event(self, ev: dict) -> None:
        kind, node_id = ev.get("kind"), ev.get("node_id")
        if self._completing:
            return     # the group is finishing; no more transitions
        if kind == "node_draining":
            victims = {m.worker_id for m in self._members
                       if m.node_id == node_id}
            if not victims:
                return
            self._drained_nodes.add(node_id)
            survivors = len(self._members) - len(victims)
            logger.info("elastic[%s] node %s draining (%d member(s) "
                        "affected)", self.group, node_id[:8], len(victims))
            if survivors >= self.config.min_workers:
                if not self._remesh("remesh", exclude_workers=victims):
                    # quiesce failed (member died under us): the reap
                    # pass will notice the errors and restart
                    logger.warning("elastic[%s] quiesce failed; falling "
                                   "back to restart", self.group)
        elif kind == "node_removed":
            self._drained_nodes.discard(node_id)
        elif kind == "node_undrained":
            # the autopilot returned a drained node to the pool (§4n):
            # it is schedulable again, so a degraded group may re-grow
            # onto it exactly like a fresh node
            self._drained_nodes.discard(node_id)
            if self.config.auto_rejoin:
                self._maybe_scale_up()
        elif kind == "node_added" and self.config.auto_rejoin:
            self._maybe_scale_up()

    def _maybe_scale_up(self) -> None:
        want = self.config.num_workers - len(self._members)
        if want <= 0:
            return
        taken = {m.node_id for m in self._members}
        nodes = self._pick_nodes(want, exclude=taken | self._drained_nodes)
        if not nodes:
            return
        joiners = [self._spawn_member(n) for n in nodes[:want]]
        # joiners only act on the NEXT generation's plan
        self._launch_loops(joiners, self._gen + 1)
        if not self._remesh("join", joiners=joiners):
            for j in joiners:
                try:
                    ray_tpu_torch.kill(j.actor)
                except Exception:  # noqa: BLE001
                    pass

    def _any_member_failed(self, members: List[_Member]) -> bool:
        """True when a member died hard — OR when every loop already
        returned (the group completed while the quiesce was in flight);
        either way the caller must abandon the transition."""
        refs = [m.ref for m in members if m.ref is not None]
        done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        for d in done:
            try:
                ray_tpu_torch.get(d)
            except (exc.RayActorError, exc.RayTaskError,
                    exc.ObjectLostError):
                return True
        return bool(refs) and len(done) == len(refs)

    def _reap_leavers(self) -> None:
        """Drained members return their record once they observe the
        plan that excludes them; collect it and drop the actor."""
        still: List[_Member] = []
        for m in self._leavers:
            done, _ = ray_tpu_torch.wait([m.ref], num_returns=1, timeout=0)
            if not done:
                still.append(m)
                continue
            try:
                self._worker_results.append(ray_tpu_torch.get(m.ref))
            except (exc.RayActorError, exc.RayTaskError,
                    exc.ObjectLostError):
                pass               # died on the way out; nothing to keep
            try:
                ray_tpu_torch.kill(m.actor)
            except Exception:  # noqa: BLE001
                pass
        self._leavers = still

    def _reap_members(self) -> Optional[bool]:
        """Harvest finished loops.  Returns True when the whole group
        completed, False when a member failed hard (restart needed),
        None while still running."""
        self._reap_leavers()
        failed = False
        for m in self._members:
            if m.ref is None:
                continue           # already reported completion
            done, _ = ray_tpu_torch.wait([m.ref], num_returns=1, timeout=0)
            if not done:
                continue
            try:
                res = ray_tpu_torch.get(m.ref)
            except (exc.RayActorError, exc.RayTaskError,
                    exc.ObjectLostError) as e:
                logger.warning("elastic[%s] member %r failed: %s",
                               self.group, m, e)
                failed = True
                continue
            self._worker_results.append(res)
            # a clean return mid-run can only be "completed" (drained
            # members moved to _leavers before their plan excluded them)
            m.ref = None
            self._completing = True
        if failed:
            return False
        if self._members and all(m.ref is None for m in self._members):
            return True
        return None

    def _collect_reports(self) -> None:
        for rec in self.kv.poll_reports():
            useful = self.goodput.record_step(rec["step"])
            rec["useful"] = useful
            self._history.append(rec)
        # adopt the object-plane checkpoint record every pass: the
        # ``stateref`` key is tiny (absent for inline states), and
        # adopting at poll cadence keeps the publisher-died-before-
        # adoption window at ~poll_s.  Only a CHANGED record is
        # unpickled (and thereby borrowed) — the old borrow is dropped
        # when _state_rec is replaced.
        try:
            import pickle
            raw = self.kv._get("stateref")
            if raw is None:
                # the checkpoint reverted to inline (or was cleared):
                # release the superseded blob's borrow — the adopted
                # ref must not pin a replaced multi-GB object
                self._state_rec = None
                self._state_raw = None
            elif raw != self._state_raw:
                self._state_raw = raw
                self._state_rec = pickle.loads(raw)
        except Exception:  # noqa: BLE001 - adoption is best-effort
            logger.debug("state-record adoption failed", exc_info=True)
        if GLOBAL_CONFIG.metrics_enabled and self._history:
            mcat.get("rtt_elastic_goodput_steps_per_s").set(
                self.goodput.goodput(now=time.monotonic()),
                tags={"group": self.group})

    def _teardown(self) -> None:
        try:
            self.kv.put_stop()
        except Exception:  # noqa: BLE001 - head gone; kills still matter
            pass
        for m in self._members + self._leavers:
            try:
                ray_tpu_torch.kill(m.actor)
            except Exception:  # noqa: BLE001
                pass
        self._members = []
        self._leavers = []
        self._state_rec = None   # release the adopted checkpoint borrow
        try:
            # every worker is gone: drop the group's coordination keys
            # (plan/state/reports) so runs don't accrete in the GCS KV
            self.kv.clear()
        except Exception:  # noqa: BLE001 - head may be shutting down
            pass


# the coordinator-port allocation is shared with the train backend so a
# fix there (e.g. around the pick-then-rebind race) applies here too
from ray_tpu_torch.train.backend import _free_port  # noqa: E402


def _host_ip() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
