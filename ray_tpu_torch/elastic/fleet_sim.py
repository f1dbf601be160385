"""Fleet simulator: O(100) simulated nodes vs the REAL autoscaler loop.

The harness ``cluster_utils.Cluster`` + the fake kube provider grew into
(DESIGN.md §4j): a simulated clock drives

- a :class:`SimNodeProvider` (instant CRUD, boot delays applied on sim
  time, launch outages from the trace),
- the real :class:`~ray_tpu_torch.autoscaler.autoscaler.StandardAutoscaler`
  reconcile loop — ``update()`` runs verbatim with its inputs
  (demand / utilization / phases / clock) fed from sim state, so the
  bin-packing under test is ``resource_demand_scheduler
  .get_nodes_to_launch`` itself, not a reimplementation,
- a placement ledger asserting the two churn invariants: **no demand
  stranded** (every feasible shape eventually places once capacity
  allows) and **no double-placement** (node capacity never
  oversubscribed; one placement per demand slot),
- goodput accounting for one fleet-wide elastic training job under the
  two recovery policies (elastic re-mesh vs restart-from-checkpoint),
  replayed on the SAME node trajectory,
- optionally, the CLOSED LOOP (§4n): the REAL autopilot policy
  (``elastic/autopilot.py``) driven on sim time through a
  :class:`SimActuator` — straggler episodes from the trace become
  node-tagged detections, remediation drains cost the job real warned
  transitions, pre-warms and the forecast floor actuate through the
  real autoscaler hooks, and the rate-limit / veto bounds are asserted
  against the exact code production runs.

Everything is deterministic from ``(seed, params)``: traces are data
(``elastic/traces.py``), the sim never reads wall clocks (the autopilot
gets the sim clock injected), and ties break by sorted ids.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                 StandardAutoscaler)
from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_WORKER, NodeProvider, TAG_NODE_KIND, TAG_NODE_TYPE)
from ray_tpu_torch.elastic.autopilot import (Actuator, Autopilot,
                                             AutopilotConfig)
from ray_tpu_torch.elastic.goodput import GoodputTracker
from ray_tpu_torch.elastic.traces import DemandTrace, PreemptionTrace


# ------------------------------------------------------------------ provider
class SimNode:
    __slots__ = ("node_id", "node_type", "resources", "phase",
                 "ready_at", "drain_deadline", "placements")

    def __init__(self, node_id: str, node_type: str,
                 resources: Dict[str, float], ready_at: float):
        self.node_id = node_id
        self.node_type = node_type
        self.resources = dict(resources)
        self.phase = "pending"        # pending -> running -> draining
        self.ready_at = ready_at
        self.drain_deadline: Optional[float] = None
        self.placements: List[Dict[str, float]] = []

    def available(self) -> Dict[str, float]:
        out = dict(self.resources)
        for shape in self.placements:
            for k, v in shape.items():
                out[k] = out.get(k, 0.0) - v
        return out

    def fits(self, shape: Dict[str, float]) -> bool:
        avail = self.available()
        return all(avail.get(k, 0.0) >= v for k, v in shape.items()
                   if v > 0)


class SimNodeProvider(NodeProvider):
    """Deterministic in-memory provider on sim time.  ``create_node``
    during a trace outage window raises (spot capacity crunch) — the
    autoscaler's reconcile loop must tolerate that and retry."""

    def __init__(self, boot_delay_s: float = 30.0):
        super().__init__({}, "sim")
        self.boot_delay_s = boot_delay_s
        self.nodes: Dict[str, SimNode] = {}
        self.now = 0.0
        self.outage = False
        self._seq = 0
        self.launch_failures = 0

    # -- NodeProvider interface
    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        want_type = tag_filters.get(TAG_NODE_TYPE)
        return sorted(nid for nid, n in self.nodes.items()
                      if want_type is None or n.node_type == want_type)

    def node_tags(self, node_id: str) -> Dict[str, str]:
        n = self.nodes.get(node_id)
        if n is None:
            return {}
        return {TAG_NODE_KIND: NODE_KIND_WORKER,
                TAG_NODE_TYPE: n.node_type}

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        if self.outage:
            self.launch_failures += count
            raise RuntimeError("sim provider: launch capacity outage")
        out = []
        for _ in range(count):
            self._seq += 1
            nid = f"sim-{self._seq:05d}"
            self.nodes[nid] = SimNode(
                nid, tags.get(TAG_NODE_TYPE, ""),
                dict(node_config.get("resources", {})),
                ready_at=self.now + self.boot_delay_s)
            out.append(nid)
        return out

    def terminate_node(self, node_id: str) -> None:
        self.nodes.pop(node_id, None)

    def drain_node(self, node_id: str, deadline_s: float = 0.0,
                   reason: str = "preemption") -> None:
        n = self.nodes.get(node_id)
        if n is not None and n.phase != "pending":
            n.phase = "draining"
            n.drain_deadline = self.now + deadline_s

    # -- sim hooks
    def tick(self, now: float, outage: bool) -> None:
        self.now = now
        self.outage = outage
        for n in self.nodes.values():
            if n.phase == "pending" and now >= n.ready_at:
                n.phase = "running"

    def running(self) -> List[SimNode]:
        return sorted((n for n in self.nodes.values()
                       if n.phase == "running"),
                      key=lambda n: n.node_id)


class SimAutoscaler(StandardAutoscaler):
    """The real reconcile loop with sim-fed inputs: demand comes from
    the harness's unplaced ledger, utilization/phases from sim nodes,
    and the clock from the sim."""

    def __init__(self, config: AutoscalerConfig, provider: SimNodeProvider,
                 harness: "FleetSimulator"):
        super().__init__(config, provider)
        self._harness = harness
        self._clock = lambda: provider.now

    def _demand(self) -> List[Dict[str, float]]:
        return self._harness.unfulfilled_demand()

    def _node_utilization(self) -> Dict[str, bool]:
        return {nid: not n.placements
                for nid, n in self._harness.provider.nodes.items()}

    def _node_phases(self) -> Dict[str, str]:
        return {nid: n.phase
                for nid, n in self._harness.provider.nodes.items()}


# ----------------------------------------------------------------- actuator
class SimActuator(Actuator):
    """Binds the REAL autopilot policy (``elastic/autopilot.py``) to the
    simulated fleet: drains go through the sim provider (and cost the
    job a warned transition, exactly like a provider preemption),
    pre-warms and the forecast floor go through the REAL autoscaler's
    new hooks, and every emitted event lands in the sim's action log.
    The storm bounds asserted here are the storm bounds production
    runs."""

    def __init__(self, sim: "FleetSimulator"):
        self.sim = sim
        self.veto_fn = None          # test hook: node_id -> reason|None

    def drain(self, node_id: str, reason: str) -> bool:
        return self.sim._autopilot_drain(node_id, reason)

    def undrain(self, node_id: str) -> bool:
        n = self.sim.provider.nodes.get(node_id)
        if n is None or n.phase != "draining":
            return False
        n.phase = "running"
        return True

    def veto(self, node_id):
        return self.veto_fn(node_id) if self.veto_fn else None

    def prewarm(self, node_id: str) -> bool:
        n = self.sim.provider.nodes.get(node_id)
        if n is None or not n.placements:
            return False        # idle node: a replacement buys nothing
        return self.sim.autoscaler.prewarm_for_drain(node_id)

    def demand_now(self) -> float:
        return float(self.sim._demand_level)

    def demand_forecast(self):
        return self.sim._seasonal_forecast()

    def forecast_demand(self, slots: int) -> bool:
        self.sim.autoscaler.set_forecast_demand(slots)
        return True

    def emit(self, kind, node_id=None, **fields):
        self.sim.emitted.append({"kind": kind, "node_id": node_id,
                                 "t": self.sim.provider.now, **fields})


# ------------------------------------------------------------------ job model
@dataclass
class TrainJobModel:
    """One fleet-wide elastic training job for the goodput A/B.

    Throughput is ``steps_per_s_per_slice × active_slices`` (per-slice
    batch, weak scaling).  Transition costs are the policy knobs:

    - ``remesh_s`` — elastic quiesce → re-init → re-shard pause (the
      figure is a parameter of the simulation, not a measurement;
      15s is a conservative multi-host default).
    - ``coldstart_s`` — full-group restart: processes respawn, torch
      re-imports, the CUDA contexts and kernels load again, state
      restores from the persisted checkpoint.
    - ``checkpoint_every_s`` — the restart policy additionally re-runs
      work since the last checkpoint; the elastic path gathers at the
      quiesce boundary so a WARNED preemption never loses steps.
    """

    slices_target: int = 16
    steps_per_s_per_slice: float = 1.0
    remesh_s: float = 15.0
    coldstart_s: float = 120.0
    checkpoint_every_s: float = 300.0


class _PolicyState:
    def __init__(self, policy: str, job: TrainJobModel, t0: float):
        self.policy = policy
        self.job = job
        self.tracker = GoodputTracker(t0=t0)
        self.active = 0              # live slices
        self.formed = False          # reached full strength once
        self.paused_until = 0.0
        self.pending_recompute_s = 0.0
        self.last_checkpoint_t = 0.0
        self.transitions = 0

    def lose_slice(self, t: float, warned: bool) -> None:
        if self.active <= 0:
            return
        self.active -= 1
        self.transitions += 1
        if self.policy == "elastic" and warned:
            self._pause(t, self.job.remesh_s)
        else:
            # unwarned loss (both policies) or restart policy: full
            # cold start + recompute back to the last checkpoint
            lost = min(t - self.last_checkpoint_t,
                       self.job.checkpoint_every_s)
            self.pending_recompute_s = max(lost, 0.0)
            self._pause(t, self.job.coldstart_s)

    def gain_slice(self, t: float) -> None:
        if self.active >= self.job.slices_target:
            return
        self.active += 1
        if not self.formed:
            # initial formation is free for BOTH policies: the A/B
            # measures recovery economics, not first bring-up
            if self.active >= self.job.slices_target:
                self.formed = True
                self.last_checkpoint_t = t
            return
        self.transitions += 1
        if self.policy == "elastic":
            self._pause(t, self.job.remesh_s)
        else:
            lost = min(t - self.last_checkpoint_t,
                       self.job.checkpoint_every_s)
            self.pending_recompute_s = max(lost, 0.0)
            self._pause(t, self.job.coldstart_s)

    def _pause(self, t: float, dur: float) -> None:
        # overlapping pauses extend, not stack: account only the wall
        # time this transition actually adds
        new_until = max(self.paused_until, t + dur)
        self.tracker.record_pause(new_until - max(self.paused_until, t))
        self.paused_until = new_until

    def advance(self, t: float, dt: float,
                rate_scale: float = 1.0) -> None:
        """Accrue progress over [t, t+dt).  ``rate_scale`` < 1 models a
        degraded (straggling) member gating the synchronous domain —
        the whole job runs at the slowest rank's pace until the node is
        drained out (the autopilot reflex) or recovers."""
        run_s = dt
        if t < self.paused_until:
            run_s = max(0.0, (t + dt) - self.paused_until)
        if run_s <= 0 or self.active <= 0:
            self.tracker.add_progress(ts=t + dt)
            return
        rate = self.job.steps_per_s_per_slice * self.active * rate_scale
        # recompute debt burns run time producing WASTED steps first
        waste_s = min(self.pending_recompute_s, run_s)
        self.pending_recompute_s -= waste_s
        useful_s = run_s - waste_s
        self.tracker.add_progress(useful=rate * useful_s,
                                  wasted=rate * waste_s, ts=t + dt)
        if t + dt - self.last_checkpoint_t >= self.job.checkpoint_every_s:
            self.last_checkpoint_t = t + dt


# ------------------------------------------------------------------ simulator
@dataclass
class FleetReport:
    duration_s: float
    ticks: int
    launched: int
    preempted: int
    stranded_demand: int
    max_unfulfilled: int
    double_placements: int
    policies: Dict[str, dict] = field(default_factory=dict)
    unfulfilled_integral: float = 0.0      # shape-seconds of demand lag
    autopilot: Optional[dict] = None       # closed-loop action summary

    @property
    def goodput_ratio(self) -> float:
        e = self.policies.get("elastic", {}).get("goodput_steps_per_s", 0.0)
        r = self.policies.get("restart", {}).get("goodput_steps_per_s", 0.0)
        return e / r if r else float("inf")

    def to_dict(self) -> dict:
        return {"duration_s": self.duration_s, "ticks": self.ticks,
                "launched": self.launched, "preempted": self.preempted,
                "stranded_demand": self.stranded_demand,
                "max_unfulfilled": self.max_unfulfilled,
                "double_placements": self.double_placements,
                "unfulfilled_integral": round(self.unfulfilled_integral, 3),
                "autopilot": self.autopilot,
                "goodput_ratio": (round(self.goodput_ratio, 4)
                                  if self.goodput_ratio != float("inf")
                                  else None),
                "policies": self.policies}


class FleetSimulator:
    def __init__(self, *, node_types: Dict[str, dict],
                 demand_shape: Dict[str, float],
                 preemption: PreemptionTrace,
                 demand: Optional[DemandTrace] = None,
                 job: Optional[TrainJobModel] = None,
                 tick_s: float = 5.0,
                 boot_delay_s: float = 30.0,
                 max_workers: int = 200,
                 autoscale_every_s: float = 10.0,
                 autopilot: bool = False,
                 autopilot_config: Optional[AutopilotConfig] = None,
                 detector_delay_s: float = 20.0,
                 drain_grace_s: float = 20.0,
                 forecast_horizon_s: float = 90.0,
                 forecast_period_s: Optional[float] = None):
        self.preemption = preemption
        self.demand_trace = demand
        self.demand_shape = dict(demand_shape)
        self.tick_s = tick_s
        self.provider = SimNodeProvider(boot_delay_s=boot_delay_s)
        self.autoscaler = SimAutoscaler(
            AutoscalerConfig(node_types=node_types,
                             max_workers=max_workers,
                             idle_timeout_s=120.0),
            self.provider, self)
        self.autoscale_every_s = autoscale_every_s
        self.job = job
        self._demand_level = 0
        self._placed = 0          # placements currently held
        self._double_placements = 0
        # --- closed loop (§4n): the REAL autopilot policy on sim time
        self.actuator = SimActuator(self)
        self.autopilot: Optional[Autopilot] = None
        if autopilot:
            self.autopilot = Autopilot(
                autopilot_config or AutopilotConfig(),
                self.actuator, clock=lambda: self.provider.now,
                metrics=False)
        self.detector_delay_s = detector_delay_s
        self.drain_grace_s = drain_grace_s
        self.forecast_horizon_s = forecast_horizon_s
        self.forecast_period_s = forecast_period_s or (
            demand.period_s if demand is not None else 3600.0)
        self.emitted: List[dict] = []            # autopilot fleet events
        self.unfulfilled_integral = 0.0          # shape-seconds of lag
        self._policies: Dict[str, _PolicyState] = {}
        self._death_row: List[tuple] = []        # (kill_at, node_id)
        self._stragglers: Dict[str, tuple] = {}  # node -> (factor, until)
        self._strag_reported: Dict[str, float] = {}
        self._demand_history: List[tuple] = []   # (t, level)

    # -- harness inputs to the real autoscaler
    def unfulfilled_demand(self) -> List[Dict[str, float]]:
        missing = max(self._demand_level - self._placed, 0)
        return [dict(self.demand_shape) for _ in range(missing)]

    # -- placement ledger
    def _place_pending(self) -> None:
        missing = max(self._demand_level - self._placed, 0)
        if missing <= 0:
            return
        for node in self.provider.running():
            while missing > 0 and node.fits(self.demand_shape):
                node.placements.append(dict(self.demand_shape))
                avail = node.available()
                if any(v < -1e-9 for v in avail.values()):
                    self._double_placements += 1
                self._placed += 1
                missing -= 1
            if missing <= 0:
                break

    def _release_over_demand(self) -> None:
        """Diurnal down-curve: drop the most recent placements first
        (live systems cancel the newest queued work)."""
        excess = self._placed - self._demand_level
        for node in reversed(self.provider.running()):
            while excess > 0 and node.placements:
                node.placements.pop()
                self._placed -= 1
                excess -= 1

    # -- closed-loop hooks (§4n)
    def _seasonal_forecast(self) -> Optional[float]:
        """Demand level one season back at (now + horizon) — the sim's
        stand-in for the head TSDB's 48h rungs (same seasonal-naive
        baseline as ``TSDB.forecast``)."""
        anchor = self.provider.now + self.forecast_horizon_s \
            - self.forecast_period_s
        if anchor < 0:
            return None     # cold start: less than one period of history
        best = None
        for ts, level in self._demand_history:
            if ts <= anchor:
                best = level
            else:
                break
        return None if best is None else float(best)

    def _autopilot_drain(self, node_id: str, reason: str) -> bool:
        """The autopilot's remediation drain, sim-side: mark the node
        draining (it stops straggling the domain — the quiesce excludes
        it), schedule its hand-off death after ``drain_grace_s``, and
        charge every policy the WARNED transition it causes."""
        node = self.provider.nodes.get(node_id)
        if node is None or node.phase != "running":
            return False
        t = self.provider.now
        self.provider.drain_node(node_id, deadline_s=self.drain_grace_s)
        self._death_row.append((t + self.drain_grace_s, node_id))
        self._stragglers.pop(node_id, None)
        if node.placements:
            for ps in self._policies.values():
                ps.lose_slice(t, warned=True)
        return True

    def _rate_scale(self, t: float) -> float:
        """The synchronous domain runs at its slowest member's pace: the
        min factor over currently-degraded nodes still holding
        placements and still in the domain (phase running)."""
        scale = 1.0
        for nid in list(self._stragglers):
            factor, until = self._stragglers[nid]
            node = self.provider.nodes.get(nid)
            if until <= t or node is None:
                self._stragglers.pop(nid)
                self._strag_reported.pop(nid, None)
                continue
            if node.phase == "running" and node.placements:
                scale = min(scale, factor)
        return scale

    def _feed_autopilot(self, t: float) -> None:
        """Synthesize the detector/fleet-event feed for the reflex
        engine: a degradation episode older than ``detector_delay_s``
        (the sim's stand-in for the straggler detector's window) fires a
        node-tagged straggler event, re-fired each detector interval
        while it persists — the flapping input the rate limits must
        bound."""
        ap = self.autopilot
        if ap is None:
            return
        for nid, (factor, until) in self._stragglers.items():
            node = self.provider.nodes.get(nid)
            if node is None or node.phase != "running" \
                    or not node.placements:
                continue
            onset = self._strag_onset.get(nid, t)
            last = self._strag_reported.get(nid)
            if t - onset < self.detector_delay_s:
                continue
            if last is not None and t - last < self.detector_delay_s:
                continue
            self._strag_reported[nid] = t
            ap.observe({"kind": "straggler", "node_id": nid,
                        "skew_ratio": round(1.0 / max(factor, 1e-9), 3)})
        ap.tick(now=t)

    # -- run
    def run(self) -> FleetReport:
        trace = self.preemption
        events = sorted(trace.events, key=lambda e: (e.t, e.slice_index))
        stragglers = sorted(trace.stragglers,
                            key=lambda e: (e.t, e.slice_index))
        ev_i = sv_i = 0
        t = 0.0
        ticks = 0
        launched_total = 0
        preempted_total = 0
        max_unfulfilled = 0
        next_autoscale = 0.0
        self._death_row = []
        self._strag_onset: Dict[str, float] = {}
        policies = {}
        if self.job is not None:
            policies = {p: _PolicyState(p, self.job, t0=0.0)
                        for p in ("elastic", "restart")}
        self._policies = policies

        while t < trace.duration_s:
            outage = trace.in_outage(t)
            self.provider.tick(t, outage)
            # demand level from the trace (constant when none)
            if self.demand_trace is not None:
                self._demand_level = self.demand_trace.shapes_at(t)
            elif self.job is not None:
                self._demand_level = self.job.slices_target
            self._demand_history.append((t, self._demand_level))
            # job slices come up as placements land on booted nodes
            before = self._placed
            self._place_pending()
            self._release_over_demand()
            gained = self._placed - before
            for ps in policies.values():
                for _ in range(max(gained, 0)):
                    ps.gain_slice(t)

            # degradation episodes due this tick hit a PLACED node (an
            # idle node straggling drags nobody)
            while sv_i < len(stragglers) and \
                    stragglers[sv_i].t < t + self.tick_s:
                sv = stragglers[sv_i]
                sv_i += 1
                placed = [n for n in self.provider.running()
                          if n.placements]
                if not placed:
                    continue
                victim = placed[sv.slice_index % len(placed)]
                self._stragglers[victim.node_id] = (
                    sv.factor, sv.t + sv.duration_s)
                self._strag_onset[victim.node_id] = sv.t

            # preemption events due this tick
            while ev_i < len(events) and events[ev_i].t < t + self.tick_s:
                ev = events[ev_i]
                ev_i += 1
                running = self.provider.running()
                if not running:
                    continue
                victim = running[ev.slice_index % len(running)]
                preempted_total += 1
                warned = ev.warning_s > 0
                if warned:
                    self.provider.drain_node(victim.node_id,
                                             deadline_s=ev.warning_s)
                    self._death_row.append(
                        (ev.t + ev.warning_s, victim.node_id))
                    if self.autopilot is not None:
                        self.autopilot.observe(
                            {"kind": "node_draining",
                             "node_id": victim.node_id})
                else:
                    self._kill_node(victim.node_id)
                if victim.placements:
                    for ps in policies.values():
                        ps.lose_slice(ev.t, warned)
            # warned preemptions whose deadline passed die now
            due = [nid for kill_at, nid in self._death_row
                   if kill_at <= t]
            self._death_row = [(k, n) for k, n in self._death_row
                               if k > t]
            for nid in due:
                self._kill_node(nid)

            # the reflex pass: detector feed + autopilot tick (§4n)
            self._feed_autopilot(t)

            # the REAL autoscaler reconcile, on its own cadence
            if t >= next_autoscale:
                next_autoscale = t + self.autoscale_every_s
                try:
                    report = self.autoscaler.update()
                    launched_total += sum(
                        len(ids) for ids in report["launched"].values())
                except RuntimeError:
                    pass        # outage window: launches rejected
            backlog = len(self.unfulfilled_demand())
            max_unfulfilled = max(max_unfulfilled, backlog)
            self.unfulfilled_integral += backlog * self.tick_s
            rate_scale = self._rate_scale(t)
            for ps in policies.values():
                ps.advance(t, self.tick_s, rate_scale)
            t += self.tick_s
            ticks += 1

        # drain phase: a backlog at trace end is only STRANDED if it
        # survives quiet time too (no events, no outage) — an in-flight
        # boot or a just-closed outage window resolves here.  Goodput
        # accounting stays frozen at duration_s.
        drain_deadline = t + 600.0
        while t < drain_deadline and self.unfulfilled_demand():
            self.provider.tick(t, False)
            self._place_pending()
            if t >= next_autoscale:
                next_autoscale = t + self.autoscale_every_s
                try:
                    self.autoscaler.update()
                except RuntimeError:
                    pass
            t += self.tick_s

        ap_summary = None
        if self.autopilot is not None:
            stats = self.autopilot.stats()
            ap_summary = {"counts": stats["counts"],
                          "forecast_slots": stats["forecast_slots"],
                          "events": len(self.emitted)}
        report = FleetReport(
            duration_s=trace.duration_s, ticks=ticks,
            launched=launched_total, preempted=preempted_total,
            stranded_demand=len(self.unfulfilled_demand()),
            max_unfulfilled=max_unfulfilled,
            double_placements=self._double_placements,
            unfulfilled_integral=self.unfulfilled_integral,
            autopilot=ap_summary,
            policies={p: {**ps.tracker.summary(now=trace.duration_s),
                          "active_slices": ps.active,
                          "transitions": ps.transitions}
                      for p, ps in policies.items()})
        return report

    def _kill_node(self, node_id: str) -> None:
        node = self.provider.nodes.get(node_id)
        if node is None:
            return
        self._placed -= len(node.placements)
        self.provider.terminate_node(node_id)
        self._stragglers.pop(node_id, None)
        self._strag_reported.pop(node_id, None)
        if self.autopilot is not None:
            self.autopilot.observe({"kind": "node_removed",
                                    "node_id": node_id})
