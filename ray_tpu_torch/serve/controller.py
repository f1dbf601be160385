"""ServeController: deployment state machine + replica autoscaler.

Reference: ``python/ray/serve/_private/controller.py`` (SURVEY.md §3.6):
a detached named actor that owns the desired/actual replica sets, runs a
control loop that (a) reconciles replica counts, (b) marks replicas ready
once their ``__init__`` finished, (c) health-checks live replicas,
(d) gracefully drains downscaled replicas, and (e) runs the autoscaling
policy over handle-reported ongoing-request metrics.

The control loop runs on a thread inside the controller actor; all external
interaction is via actor calls (``max_concurrency > 1`` so stats reports
never queue behind a slow deploy).

Port of ``ray_tpu/serve/controller.py``.  What the card adds: a replica's
``ray_actor_options`` reach the runtime unchanged, so ``num_gpus`` places
it in a GPU worker process that sees the card, and every such replica
holds a process of its own.  A deployment the cluster can never place —
a resource no node has, or more GPU replicas than the GPU worker
processes the cluster spawns (``gpu_workers_per_node``) — fails at deploy
with a message naming what is missing, and one whose replicas fail in
``__init__`` (a model built for the card in a worker that sees none)
fails after ``_MAX_START_FAILURES`` starts in a row; ``status()`` carries
either message and ``serve.run`` raises it.

The runtime's first call on an actor blocks until the actor is alive
(its ``__init__`` done, up to ``actor_connect_timeout_s`` a try), so a
replica's readiness probe runs on a thread of its own
(``_await_ready``), and only a ready replica is asked to drain: the
control loop never waits on a replica's ``__init__`` (a model's load on
the card), and replicas start side by side.
"""

from __future__ import annotations

import math
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.serve._replica import Replica
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.util import metrics_catalog as mcat

logger = rtlog.get("serve.controller")

_STATS_TTL_S = 10.0
# replica starts in a row that may fail in __init__ before the deployment
# is marked failed (reference Ray Serve: the constructor retry count)
_MAX_START_FAILURES = 3


class _ReplicaState:
    def __init__(self, tag: str, actor_name: str, handle, ready_ref):
        self.tag = tag
        self.actor_name = actor_name
        self.handle = handle
        self.ready_ref = ready_ref          # Future; None once ready
        self.health_ref = None
        self.started_at = time.monotonic()


class _DeploymentState:
    def __init__(self, key: str, payload: dict):
        self.key = key
        self.payload = payload              # user_cls, init_args/kwargs
        self.config: DeploymentConfig = payload["config"]
        self.target = self.config.initial_target()
        self.replicas: Dict[str, _ReplicaState] = {}
        self.ready: Dict[str, _ReplicaState] = {}
        self.draining: List[tuple] = []     # (kill_at, _ReplicaState)
        self.version = 0
        self.up_since: Optional[float] = None
        self.down_since: Optional[float] = None
        self.message = ""                   # last start failure, if any
        self.failed = False                 # no replica is started
        self.start_failures = 0             # in a row


def _replica_ask(config: DeploymentConfig) -> Dict[str, float]:
    """The resources one replica holds, as the runtime names them."""
    opts = config.ray_actor_options or {}
    ask = {"CPU": float(opts.get("num_cpus", 1) or 0),
           "GPU": float(opts.get("num_gpus") or 0)}
    ask.update({k: float(v) for k, v in (opts.get("resources") or {}).items()})
    return {k: v for k, v in ask.items() if v > 0}


def _max_replicas(config: DeploymentConfig) -> int:
    ac = config.autoscaling_config
    return ac.max_replicas if ac is not None else config.num_replicas


class ServeController:
    def __init__(self):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._routes: Dict[str, str] = {}        # route_prefix -> ingress key
        self._apps: Dict[str, dict] = {}         # app -> {ingress, deployments}
        self._stats: Dict[tuple, tuple] = {}     # (router, dep) -> (ts, n)
        self._http_address: Optional[tuple] = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        threading.Thread(target=self._control_loop, name="serve-control",
                         daemon=True).start()

    # ----------------------------------------------------------------- deploy
    def deploy_application(self, app_name: str, route_prefix: str,
                           deployments: List[dict], ingress: str) -> bool:
        """deployments: [{name, user_cls, init_args, init_kwargs, config}]."""
        with self._lock:
            keys = []
            for d in deployments:
                key = f"{app_name}#{d['name']}"
                keys.append(key)
                existing = self._deployments.get(key)
                if existing is None:
                    self._deployments[key] = _DeploymentState(key, d)
                else:
                    # Redeploy: replace code/config, restart replicas.
                    existing.payload = d
                    existing.config = d["config"]
                    existing.target = d["config"].initial_target()
                    for rs in list(existing.replicas.values()):
                        self._retire(existing, rs, now=time.monotonic())
                    existing.version += 1
                    existing.message, existing.failed = "", False
                    existing.start_failures = 0
            # Drop deployments removed from the app.
            old = self._apps.get(app_name, {}).get("deployments", [])
            for stale in set(old) - set(keys):
                self._delete_deployment(stale)
            ingress_key = f"{app_name}#{ingress}"
            old_ingress = self._apps.get(app_name, {}).get("ingress")
            self._apps[app_name] = {"ingress": ingress_key,
                                    "deployments": keys}
            # Drop stale prefixes from earlier deploys of this app before
            # (re)registering — a route_prefix change must not leave the
            # old URL serving.
            self._routes = {p: k for p, k in self._routes.items()
                            if k not in (ingress_key, old_ingress)}
            if route_prefix is not None:
                self._routes[route_prefix] = ingress_key
            self._check_placeable([self._deployments[k] for k in keys])
        return True

    def _check_placeable(self, new: List[_DeploymentState]) -> None:
        """Fail the deployments of ``new`` that the cluster can never
        place: a replica asking for more of a resource than the cluster
        holds, or GPU replicas beyond the GPU worker processes the cluster
        spawns (one process a GPU replica, ``gpu_workers_per_node`` a
        node).  Each gets a message naming the resource or the flag."""
        total = ray_tpu_torch.cluster_resources()
        for st in new:
            for res, n in _replica_ask(st.config).items():
                if total.get(res, 0.0) < n:
                    st.failed = True
                    st.message = (
                        f"deployment {st.key} asks for {n:g} {res!r} a "
                        f"replica and the cluster has "
                        f"{total.get(res, 0.0):g} {res!r} "
                        f"(cluster resources {total})")
        gpu = [st for st in self._deployments.values()
               if not st.failed and _replica_ask(st.config).get("GPU")]
        demand = sum(_max_replicas(st.config) for st in gpu)
        nodes = len(ray_tpu_torch.nodes())
        cap = GLOBAL_CONFIG.gpu_workers_per_node * nodes
        if demand > cap:
            for st in new:
                if st in gpu and not st.failed:
                    st.failed = True
                    st.message = (
                        f"GPU replicas of every deployment may number "
                        f"{demand}, each in a GPU worker process of its "
                        f"own, and the cluster spawns {cap} "
                        f"(gpu_workers_per_node="
                        f"{GLOBAL_CONFIG.gpu_workers_per_node} on {nodes} "
                        f"node(s)); init with _system_config="
                        f"{{'gpu_workers_per_node': {demand}}}")
        for st in new:
            if st.failed:
                logger.error("deployment %s failed: %s", st.key, st.message)

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            app = self._apps.pop(app_name, None)
            if app is None:
                return False
            for key in app["deployments"]:
                self._delete_deployment(key)
            self._routes = {p: k for p, k in self._routes.items()
                            if k != app["ingress"]}
        return True

    def _delete_deployment(self, key: str) -> None:
        st = self._deployments.pop(key, None)
        if st is None:
            return
        # drop the deployment's gauge series: _autoscale_tick never runs
        # for it again, so the last value would otherwise be republished
        # by this long-lived controller forever (phantom deployment
        # "wanting" replicas on the dashboard)
        mcat.get("rtt_serve_autoscaler_desired_replicas").remove_series(
            tags={"deployment": key, "group": key})
        now = time.monotonic()
        for rs in list(st.replicas.values()):
            self._retire(st, rs, now, grace=0.0)
        self._drain_tick(st, now=now + 1e9, orphan=True)

    # ------------------------------------------------------------------ reads
    def get_deployment_targets(self, dep_key: str) -> Optional[dict]:
        with self._lock:
            st = self._deployments.get(dep_key)
            if st is None:
                return None
            return {"version": st.version,
                    "replicas": {t: r.actor_name for t, r in st.ready.items()},
                    "max_ongoing": st.config.max_ongoing_requests}

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._routes)

    def get_app_ingress(self, app_name: str) -> Optional[str]:
        with self._lock:
            app = self._apps.get(app_name)
            return app["ingress"] if app else None

    def status(self) -> dict:
        with self._lock:
            return {k: {"target": st.target,
                        "ready": len(st.ready),
                        "starting": len(st.replicas) - len(st.ready),
                        "draining": len(st.draining),
                        "failed": st.failed, "message": st.message}
                    for k, st in self._deployments.items()}

    def set_http_address(self, host: str, port: int) -> bool:
        with self._lock:
            self._http_address = (host, port)
        return True

    def get_http_address(self) -> Optional[tuple]:
        with self._lock:
            return self._http_address

    def set_grpc_address(self, host: str, port: int) -> bool:
        with self._lock:
            self._grpc_address = (host, port)
        return True

    def get_grpc_address(self) -> Optional[tuple]:
        with self._lock:
            return getattr(self, "_grpc_address", None)

    def list_app_ingress(self) -> Dict[str, str]:
        """app name → ingress DEPLOYMENT name (grpc proxy routing)."""
        with self._lock:
            return {app: meta["ingress"].split("#", 1)[1]
                    for app, meta in self._apps.items()}

    def ingress_has_method(self, dep_key: str, name: str) -> bool:
        """Does the deployment's user class define a public method
        ``name``?  (grpc proxy: map ``/Pkg.Svc/Method`` onto it.)"""
        with self._lock:
            st = self._deployments.get(dep_key)
            if st is None:
                return False
            cls = st.payload.get("user_cls")
        return callable(getattr(cls, name, None)) and not name.startswith("_")

    # ------------------------------------------------------------------ stats
    def report_handle_stats(self, router_id: str, dep_key: str,
                            ongoing: int) -> None:
        with self._lock:
            self._stats[(router_id, dep_key)] = (time.monotonic(), ongoing)

    def _total_ongoing(self, dep_key: str, now: float) -> int:
        total = 0
        for (rid, key), (ts, n) in list(self._stats.items()):
            if key != dep_key:
                continue
            if now - ts > _STATS_TTL_S:
                del self._stats[(rid, key)]
                continue
            total += n
        return total

    # ----------------------------------------------------------- control loop
    def _control_loop(self) -> None:
        while not self._stop.wait(0.2):
            try:
                with self._lock:
                    states = list(self._deployments.values())
                now = time.monotonic()
                for st in states:
                    with self._lock:
                        self._autoscale_tick(st, now)
                        self._reconcile_tick(st, now)
                    self._readiness_tick(st)
                    self._health_tick(st, now)
                    self._drain_tick(st, now)
            except Exception:  # noqa: BLE001
                if not ray_tpu_torch.is_initialized():
                    return
                logger.exception("serve control loop error")

    def _autoscale_tick(self, st: _DeploymentState, now: float) -> None:
        try:
            self._do_autoscale_tick(st, now)
        finally:
            if GLOBAL_CONFIG.metrics_enabled:
                # the decision gauge makes scaling behavior inspectable:
                # target-vs-ready divergence on the dashboard IS the
                # autoscaler acting (or stuck)
                mcat.get("rtt_serve_autoscaler_desired_replicas").set(
                    st.target, tags={"deployment": st.key,
                                     "group": st.key})

    def _do_autoscale_tick(self, st: _DeploymentState, now: float) -> None:
        ac: Optional[AutoscalingConfig] = st.config.autoscaling_config
        if ac is None:
            st.target = st.config.num_replicas
            return
        ongoing = self._total_ongoing(st.key, now)
        desired = math.ceil(ongoing / ac.target_ongoing_requests)
        desired = max(ac.min_replicas, min(ac.max_replicas, desired))
        if desired > st.target:
            st.down_since = None
            st.up_since = st.up_since or now
            if now - st.up_since >= ac.upscale_delay_s:
                logger.info("autoscale %s: %d -> %d (ongoing=%d)",
                            st.key, st.target, desired, ongoing)
                st.target = desired
                st.up_since = None
        elif desired < st.target:
            st.up_since = None
            st.down_since = st.down_since or now
            if now - st.down_since >= ac.downscale_delay_s:
                logger.info("autoscale %s: %d -> %d (ongoing=%d)",
                            st.key, st.target, desired, ongoing)
                st.target = desired
                st.down_since = None
        else:
            st.up_since = st.down_since = None

    def _reconcile_tick(self, st: _DeploymentState, now: float) -> None:
        while len(st.replicas) < st.target and not st.failed:
            self._start_replica(st)
        while len(st.replicas) > st.target:
            # Prefer draining not-yet-ready replicas, then newest ready.
            tag = next((t for t in st.replicas if t not in st.ready), None)
            if tag is None:
                tag = next(reversed(st.ready))
            self._retire(st, st.replicas[tag], now)

    def _start_replica(self, st: _DeploymentState) -> None:
        tag = uuid.uuid4().hex[:8]
        actor_name = f"SERVE_REPLICA::{st.key}#{tag}"
        opts = dict(st.config.ray_actor_options or {})
        opts.setdefault("num_cpus", 1)
        p = st.payload
        handle = ray_tpu_torch.remote(Replica).options(
            name=actor_name, lifetime="detached",
            max_concurrency=st.config.max_ongoing_requests, **opts,
        ).remote(st.key, tag, p["user_cls"], p["init_args"], p["init_kwargs"])
        ready_ref: Future = Future()
        threading.Thread(target=self._await_ready, args=(handle, ready_ref),
                         name=f"serve-ready-{tag}", daemon=True).start()
        st.replicas[tag] = _ReplicaState(tag, actor_name, handle, ready_ref)
        logger.info("starting replica %s", actor_name)

    @staticmethod
    def _await_ready(handle, ready_ref: Future) -> None:
        """Resolve ``ready_ref`` once the replica's ``__init__`` returned
        (or raised).  A connect timeout means the actor is still being
        created: ask again, until it is alive or dead (a retired
        replica is killed, so this ends)."""
        while True:
            try:
                ray_tpu_torch.get(handle.__ray_ready__.remote())
                ready_ref.set_result(True)
                return
            except ray_tpu_torch.exceptions.GetTimeoutError:
                continue
            except Exception as e:  # noqa: BLE001 - reported by the tick
                ready_ref.set_exception(e)
                return

    def _retire(self, st: _DeploymentState, rs: _ReplicaState, now: float,
                grace: Optional[float] = None) -> None:
        st.replicas.pop(rs.tag, None)
        if grace is None:
            grace = st.config.graceful_shutdown_wait_s
        if st.ready.pop(rs.tag, None) is not None:
            st.version += 1
            # only a ready replica is asked to drain: a call on one still
            # in __init__ would block this loop until it is alive
            try:
                rs.handle.prepare_shutdown.remote()
            except Exception:  # noqa: BLE001
                pass
        st.draining.append((now + grace, rs))

    def _readiness_tick(self, st: _DeploymentState) -> None:
        pending = [(t, r) for t, r in list(st.replicas.items())
                   if r.ready_ref is not None]
        for tag, rs in pending:
            if not rs.ready_ref.done():
                continue
            with self._lock:
                try:
                    rs.ready_ref.result()
                except Exception as e:  # noqa: BLE001 - died on startup
                    logger.warning("replica %s failed to start: %s",
                                   rs.actor_name, e)
                    st.replicas.pop(tag, None)
                    st.start_failures += 1
                    st.message = f"replica {tag} failed to start: {e}"
                    if st.start_failures >= _MAX_START_FAILURES:
                        st.failed = True
                    continue
                rs.ready_ref = None
                st.start_failures = 0
                if tag in st.replicas:
                    st.ready[tag] = rs
                    st.version += 1

    def _health_tick(self, st: _DeploymentState, now: float) -> None:
        period = st.config.health_check_period_s
        for tag, rs in list(st.ready.items()):
            if rs.health_ref is None:
                if now - rs.started_at >= period:
                    rs.started_at = now
                    try:
                        rs.health_ref = rs.handle.check_health.remote()
                    except Exception:  # noqa: BLE001 - actor already dead:
                        # a raising submit must not abort the whole tick
                        # (it previously left the dead replica in the
                        # ready set forever — every tick re-raised)
                        self._replica_died(st, tag, "health submit failed")
                continue
            done, _ = ray_tpu_torch.wait([rs.health_ref], num_returns=1, timeout=0)
            if not done:
                if now - rs.started_at > 4 * period:
                    self._replica_died(st, tag, "health check timed out")
                continue
            try:
                ray_tpu_torch.get(rs.health_ref)
                rs.health_ref = None
            except Exception:  # noqa: BLE001
                self._replica_died(st, tag, "health check failed")

    def _replica_died(self, st: _DeploymentState, tag: str, why: str) -> None:
        logger.warning("replica %s#%s removed: %s", st.key, tag, why)
        with self._lock:
            rs = st.replicas.pop(tag, None)
            if st.ready.pop(tag, None) is not None:
                st.version += 1
        if rs is not None:
            try:
                ray_tpu_torch.kill(rs.handle)
            except Exception:  # noqa: BLE001
                pass

    def _drain_tick(self, st: _DeploymentState, now: float,
                    orphan: bool = False) -> None:
        with self._lock:
            due = [rs for kill_at, rs in st.draining if now >= kill_at]
            if not orphan:
                st.draining = [(k, r) for k, r in st.draining if now < k]
        for rs in due:
            try:
                ray_tpu_torch.kill(rs.handle)
            except Exception:  # noqa: BLE001
                pass

    # --------------------------------------------------------------- shutdown
    def shutdown_all(self) -> bool:
        self._stop.set()
        with self._lock:
            for st in self._deployments.values():
                draining = [rs for _, rs in st.draining]
                st.draining = []
                for rs in list(st.replicas.values()) + draining:
                    try:
                        ray_tpu_torch.kill(rs.handle)
                    except Exception:  # noqa: BLE001
                        pass
            self._deployments.clear()
            self._apps.clear()
            self._routes.clear()
        return True
