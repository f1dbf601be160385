"""StandardAutoscaler: reconcile resource demand against running nodes.

Reference: ``python/ray/autoscaler/_private/autoscaler.py`` (SURVEY.md
§2.3) — a periodic ``update()``: read unfulfilled demand from the control
plane, bin-pack onto configured node types (resource_demand_scheduler),
launch the difference through the NodeProvider, and reap nodes idle longer
than ``idle_timeout_s`` (never below ``min_workers``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler import resource_demand_scheduler as rds
from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_WORKER, NodeProvider, TAG_NODE_KIND, TAG_NODE_TYPE,
)


class AutoscalerConfig:
    """Subset of the reference cluster YAML that matters here.

    node_types: {name: {"resources": {...}, "min_workers": int,
                        "max_workers": int}}
    """

    def __init__(self, node_types: Dict[str, dict],
                 max_workers: int = 100, idle_timeout_s: float = 60.0,
                 boot_grace_s: float = 300.0):
        self.node_types = node_types
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        # how long a launched node may stay "booting" (provider lists
        # it, cluster doesn't) before its capacity stops absorbing
        # demand — a crashed-before-join agent must not block its own
        # replacement forever
        self.boot_grace_s = boot_grace_s


class StandardAutoscaler:
    def __init__(self, config: AutoscalerConfig, provider: NodeProvider):
        self.config = config
        self.provider = provider
        self._idle_since: Dict[str, float] = {}
        self._pending_since: Dict[str, float] = {}
        # Autopilot pre-warm ledger (DESIGN.md §4n): draining-node id ->
        # {"type", "node_id"}.  While the drained node is still listed,
        # its pre-warmed replacement is RESERVED — excluded from
        # _net_pending_capacity's pools so ordinary backlog cannot eat
        # the credit and the incoming loss re-launch.  Once the drained
        # node disappears the reservation lifts and the materialized
        # loss demand nets against the (by then mostly booted)
        # replacement instead of launching another.
        self._prewarm: Dict[str, dict] = {}      # guarded by: _lock
        # Autopilot forecast floor: extra demand slots packed AHEAD of
        # the measured backlog (the lead-time diurnal signal); also
        # exempts that many idle nodes from scale-down so pre-scaled
        # capacity survives until the predicted demand lands.
        self._forecast_slots = 0                 # guarded by: _lock
        self._forecast_shape: Optional[Dict[str, float]] = None
        self._lock = threading.Lock()
        # nodes the last resource_demand reply named as holding pending
        # work that waits for a worker there (set by _demand)
        self._waiting_on: set = set()
        # injectable clock: the fleet simulator replays hour-long
        # preemption/demand traces against this same reconcile loop on
        # simulated time (elastic/fleet_sim.py)
        self._clock = time.monotonic

    # -- inputs --------------------------------------------------------------
    def _demand(self) -> List[Dict[str, float]]:
        from ray_tpu_torch._private import worker as worker_mod
        resp = worker_mod.global_worker().rpc("resource_demand")
        # nodes whose free resources hold pending work that waits for a
        # worker to boot there: busy, not idle (_node_utilization)
        self._waiting_on = set(resp.get("waiting_on") or ())
        return list(resp["task_shapes"]) + list(resp["pg_bundles"])

    def _node_phases(self) -> Dict[str, str]:
        """Cluster node lifecycle phases keyed like _node_utilization
        (node id AND ray-pod label) — draining nodes must neither be
        scale-down victims (the provider already owns their death) nor
        count as placement capacity."""
        from ray_tpu_torch._private import worker as worker_mod
        nodes = worker_mod.global_worker().rpc("list_nodes")["nodes"]
        out: Dict[str, str] = {}
        for n in nodes:
            phase = n.get("phase", "running" if n["alive"] else
                          "terminating")
            out[n["node_id"]] = phase
            pod = (n.get("labels") or {}).get("ray-pod")
            if pod:
                out[pod] = phase
        return out

    def _node_utilization(self) -> Dict[str, bool]:
        """provider-node-id -> is_idle (all resources available == total).

        Keyed by BOTH the cluster node id (FakeMultiNodeProvider ids) and
        the node's ``ray-pod`` label (Kubernetes provider ids are pod
        names; the provider stamps each pod's agent with its own pod
        name, see kube.py)."""
        from ray_tpu_torch._private import worker as worker_mod
        nodes = worker_mod.global_worker().rpc("list_nodes")["nodes"]
        out = {}
        for n in nodes:
            if not n["alive"]:
                continue
            total = {k: v for k, v in n["resources_total"].items()
                     if not k.startswith("node:")}
            avail = n["resources_available"]
            idle = all(avail.get(k, 0.0) >= v for k, v in total.items()) \
                and n["node_id"] not in self._waiting_on
            out[n["node_id"]] = idle
            pod = (n.get("labels") or {}).get("ray-pod")
            if pod:
                out[pod] = idle
        return out

    def _snapshot(self):
        """ONE provider listing + tag fetch per reconcile — every
        consumer below works off this snapshot (a Kubernetes provider
        pays an API round-trip per call, and update() used to make
        five of them)."""
        node_ids = list(self.provider.non_terminated_nodes({}))
        tags = {nid: self.provider.node_tags(nid).get(TAG_NODE_TYPE, "")
                for nid in node_ids}
        counts: Dict[str, int] = {}
        for nid in node_ids:
            counts[tags[nid]] = counts.get(tags[nid], 0) + 1
        return node_ids, tags, counts

    # -- autopilot hooks (DESIGN.md §4n) -------------------------------------
    def prewarm_for_drain(self, node_id: str) -> bool:
        """Reserve + launch one replacement for a draining node DURING
        its warning window.  Idempotent per node id; the launch happens
        on the next :meth:`update`.  Returns False when the node's type
        is unknown (nothing to warm) or a pre-warm is already active."""
        with self._lock:
            if node_id in self._prewarm:
                return False
            t = self.provider.node_tags(node_id).get(TAG_NODE_TYPE, "")
            if t not in self.config.node_types:
                return False
            self._prewarm[node_id] = {"type": t, "node_id": None}
            return True

    def set_forecast_demand(self, slots: int,
                            shape: Optional[Dict[str, float]] = None
                            ) -> None:
        """Lead-time demand signal: pack ``slots`` extra shapes ahead of
        the measured backlog on every reconcile (and exempt as many
        idle nodes from scale-down).  ``shape`` defaults to the first
        configured node type's resources — single-shape fleets; mixed
        fleets pass the shape the forecast predicts."""
        with self._lock:
            self._forecast_slots = max(int(slots), 0)
            self._forecast_shape = dict(shape) if shape else None

    def _forecast_shapes(self) -> List[Dict[str, float]]:
        """Caller must hold ``_lock``."""
        if self._forecast_slots <= 0:
            return []
        shape = self._forecast_shape
        if shape is None:
            first = next(iter(self.config.node_types.values()), None)
            if not first:
                return []
            shape = first["resources"]
        return [dict(shape) for _ in range(self._forecast_slots)]

    def _reap_prewarm(self, node_ids: List[str],
                      phases: Dict[str, str]) -> None:
        """Caller must hold ``_lock``.  Release reservations whose
        drained node is gone (the loss demand nets against the pending
        replacement from here on) or whose replacement already joined
        the cluster (it is ordinary capacity now)."""
        listed = set(node_ids)
        for key in list(self._prewarm):
            pw = self._prewarm[key]
            joined = pw["node_id"] is not None and \
                phases.get(pw["node_id"], "pending") != "pending"
            if key not in listed or joined:
                del self._prewarm[key]

    # -- reconcile -----------------------------------------------------------
    def update(self) -> Dict[str, Any]:
        """One reconcile step; returns a report for logging/tests."""
        with self._lock:
            demand = self._demand()
            node_ids, tags, counts = self._snapshot()
            phases = self._node_phases()
            # a draining node's capacity is already forfeit: exclude it
            # from the packing counts so the replacement launches DURING
            # the warning window, not after the node dies
            draining = {nid for nid, ph in phases.items()
                        if ph == "draining"}
            if draining:
                packing_counts = dict(counts)
                for nid in node_ids:
                    if nid in draining:
                        t = tags[nid]
                        packing_counts[t] = max(
                            packing_counts.get(t, 0) - 1, 0)
            else:
                packing_counts = counts
            # autopilot inputs: release stale pre-warm reservations and
            # splice the forecast floor into what we pack (the floor is
            # packed like real demand but never counted in the backlog
            # metric — it is a prediction, not a queue)
            self._reap_prewarm(node_ids, phases)
            reserved = {pw["node_id"]
                        for pw in self._prewarm.values()
                        if pw["node_id"] is not None}
            forecast_extra = self._forecast_shapes()
            idle = None
            if forecast_extra:
                # the floor asks for CAPACITY, not launches: idle
                # running nodes already ARE the pre-scaled capacity
                # (the packer only sees unfulfilled demand, so without
                # this netting every reconcile would re-launch the
                # same floor).  The utilization snapshot is shared with
                # _scale_down below — one list_nodes RPC per reconcile.
                idle = self._node_utilization()
                n_idle = sum(1 for nid in node_ids
                             if idle.get(nid, False)
                             and phases.get(nid) == "running")
                forecast_extra = forecast_extra[
                    :max(len(forecast_extra) - n_idle, 0)]
            # net BOOTING capacity against demand before packing: a
            # launched-but-not-yet-joined node (provider lists it, the
            # cluster doesn't → phase "pending") will absorb its share
            # of the backlog when it comes up; without this every
            # reconcile during the boot window re-launches for the same
            # demand (the churn sim caught the over-launch)
            demand_to_pack = self._net_pending_capacity(
                demand + forecast_extra, phases, node_ids, tags,
                reserved=reserved)
            to_launch = rds.get_nodes_to_launch(
                self.config.node_types, packing_counts, demand_to_pack,
                max_total_nodes=self.config.max_workers)
            launched = {}
            for t, n in to_launch.items():
                cfg = self.config.node_types[t]
                # pass the node type's whole config through (labels, GPU
                # selectors, pod overrides...), not just resources — the
                # provider decides what it understands
                node_cfg = {k: v for k, v in cfg.items()
                            if k not in ("min_workers", "max_workers")}
                ids = self.provider.create_node(
                    node_cfg,
                    {TAG_NODE_KIND: NODE_KIND_WORKER, TAG_NODE_TYPE: t}, n)
                launched[t] = ids
            self._launch_prewarm(launched, node_ids)

            terminated = self._scale_down(counts, launched, draining,
                                          node_ids, tags,
                                          keep_idle=self._forecast_slots,
                                          idle=idle)
            infeasible = rds.infeasible_shapes(self.config.node_types, demand)
            self._publish_metrics(demand, phases, launched, terminated,
                                  node_ids)
            return {"demand": demand, "launched": launched,
                    "terminated": terminated, "infeasible": infeasible,
                    "draining": sorted(draining)}

    def _net_pending_capacity(self, demand: List[Dict[str, float]],
                              phases: Dict[str, str],
                              node_ids: List[str],
                              tags: Dict[str, str],
                              reserved: Optional[set] = None
                              ) -> List[Dict[str, float]]:
        """Drop the demand shapes that fit onto provider nodes still
        booting (listed by the provider, not yet joined the cluster).
        Largest shapes first, mirroring the packer's own order.  A node
        "booting" longer than ``boot_grace_s`` stops absorbing demand:
        its agent probably crashed before registering, and a phantom
        must not block its own replacement forever.  ``reserved`` ids
        (active pre-warm replacements, DESIGN.md §4n) never absorb
        ordinary demand — their credit is held for the loss their
        draining node is about to become."""
        now = self._clock()
        pending_ids = set()
        pools: List[Dict[str, float]] = []
        for nid in node_ids:
            if phases.get(nid, "pending") != "pending":
                self._pending_since.pop(nid, None)
                continue
            pending_ids.add(nid)
            since = self._pending_since.setdefault(nid, now)
            if now - since > self.config.boot_grace_s:
                continue               # phantom: stop counting it
            if reserved and nid in reserved:
                continue               # pre-warm credit: held for the loss
            cfg = self.config.node_types.get(tags.get(nid, ""))
            if cfg:
                pools.append(dict(cfg["resources"]))
        # forget nodes the provider no longer lists
        for nid in list(self._pending_since):
            if nid not in pending_ids:
                self._pending_since.pop(nid, None)
        if not pools:
            return demand
        remaining = []
        for shape in sorted(demand, key=lambda s: -sum(s.values())):
            for avail in pools:
                if rds._fits(avail, shape):
                    rds._consume(avail, shape)
                    break
            else:
                remaining.append(shape)
        return remaining

    def _launch_prewarm(self, launched: Dict[str, list],
                        node_ids: List[str]) -> None:
        """Caller must hold ``_lock``.  Launch one replacement per
        active pre-warm reservation that has none yet, bounded by
        ``max_workers``.  A provider launch failure (capacity outage)
        leaves the entry pending — retried next reconcile."""
        total = len(node_ids) + sum(len(ids) for ids in launched.values())
        for key, pw in self._prewarm.items():
            if pw["node_id"] is not None:
                continue
            if total >= self.config.max_workers:
                break
            t = pw["type"]
            cfg = self.config.node_types[t]
            node_cfg = {k: v for k, v in cfg.items()
                        if k not in ("min_workers", "max_workers")}
            try:
                ids = self.provider.create_node(
                    node_cfg,
                    {TAG_NODE_KIND: NODE_KIND_WORKER, TAG_NODE_TYPE: t}, 1)
            except Exception:  # noqa: BLE001 - outage: retry next pass
                continue
            if ids:
                pw["node_id"] = ids[0]
                launched.setdefault(t, []).extend(ids)
                total += 1

    def _publish_metrics(self, demand, phases, launched, terminated,
                         node_ids) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        if not GLOBAL_CONFIG.metrics_enabled:
            return
        from ray_tpu_torch.util import metrics_catalog as mcat
        mcat.get("rtt_autoscaler_demand_backlog").set(float(len(demand)))
        by_phase: Dict[str, int] = {}
        for nid in node_ids:
            by_phase[phases.get(nid, "pending")] = \
                by_phase.get(phases.get(nid, "pending"), 0) + 1
        for phase in ("pending", "running", "draining"):
            mcat.get("rtt_autoscaler_nodes").set(
                float(by_phase.get(phase, 0)), tags={"phase": phase})
        mcat.get("rtt_autoscaler_forecast_slots").set(
            float(self._forecast_slots))
        n_launched = sum(len(ids) for ids in launched.values())
        if n_launched:
            mcat.get("rtt_autoscaler_decisions_total").inc(
                n_launched, tags={"action": "launch"})
        if terminated:
            mcat.get("rtt_autoscaler_decisions_total").inc(
                len(terminated), tags={"action": "terminate"})

    def _scale_down(self, counts: Dict[str, int],
                    launched: Dict[str, list],
                    draining: Optional[set] = None,
                    node_ids: Optional[List[str]] = None,
                    tags: Optional[Dict[str, str]] = None,
                    keep_idle: int = 0,
                    idle: Optional[Dict[str, bool]] = None) -> List[str]:
        now = self._clock()
        if idle is None:
            idle = self._node_utilization()
        just_launched = {nid for ids in launched.values() for nid in ids}
        terminated = []
        terminated_per_type: Dict[str, int] = {}
        # forecast floor (DESIGN.md §4n): the first keep_idle idle nodes
        # are pre-scaled capacity for predicted demand — reaping them
        # would thrash against the very launches the forecast asked for
        spared = 0
        if node_ids is None:
            node_ids, tags, _ = self._snapshot()
        for nid in node_ids:
            if nid in just_launched:
                self._idle_since.pop(nid, None)
                continue
            if draining and nid in draining:
                # the provider owns a draining node's death; reaping it
                # here would double-terminate and skew the type counts
                self._idle_since.pop(nid, None)
                continue
            if not idle.get(nid, False):
                self._idle_since.pop(nid, None)
                continue
            since = self._idle_since.setdefault(nid, now)
            if now - since < self.config.idle_timeout_s:
                continue
            if spared < keep_idle:
                spared += 1
                continue
            # resolve the type BEFORE terminating (providers forget
            # terminated nodes) and count kills per type so the
            # min_workers floor holds within one update
            t = tags.get(nid, "")
            cfg = self.config.node_types.get(t, {})
            live = counts.get(t, 0) + len(launched.get(t, [])) \
                - terminated_per_type.get(t, 0)
            if live <= cfg.get("min_workers", 0):
                continue
            self.provider.terminate_node(nid)
            self._idle_since.pop(nid, None)
            terminated.append(nid)
            terminated_per_type[t] = terminated_per_type.get(t, 0) + 1
        return terminated


class AutoscalerLoop:
    """Background thread calling update() periodically (the monitor)."""

    def __init__(self, autoscaler: StandardAutoscaler,
                 interval_s: float = 5.0):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._attach_autopilot()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def _attach_autopilot(self) -> None:
        """When this loop runs in the head process, hand the autoscaler
        to the autopilot's actuator (DESIGN.md §4n) — the pre-warm and
        forecast reflexes actuate through it.  Out-of-process operators
        (the Kubernetes operator) run without the reflexes; the
        autopilot records their actions as skipped(no-autoscaler)."""
        try:
            from ray_tpu_torch._private import gcs as gcs_mod
            head = gcs_mod._INPROC_SERVER
            if head is not None and head._autopilot is not None:
                head._autopilot.actuator.autoscaler = self.autoscaler
        except Exception:  # noqa: BLE001 - attach is best-effort
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.autoscaler.update()
            except Exception:  # noqa: BLE001 - keep reconciling
                import logging
                logging.getLogger(__name__).exception("autoscaler update")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
