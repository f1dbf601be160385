"""Fleet autopilot: the observability → actuation reflex arc (§4n).

The head's detectors (straggler skew, SLO burn) *emit* node-tagged
fleet events; the autoscaler *reacts* to provider signals.  This module
closes the loop: a head-side supervision pass (ticked from the GCS
monitor thread, config-gated ``autopilot_enabled``) that turns fleet
events and TSDB history into **bounded** remediation actions:

- **straggler → drain**: a straggler fleet event (node-tagged by the
  detector) drains the offending host — no new work is placed there, and
  subscribers of the ``node_draining`` event move theirs away; a
  replacement is pre-warmed through the attached autoscaler.  The node
  is returned to the pool (un-drained) once the signal clears; a
  relapse drains it permanently.
- **drain warning → pre-warm**: any ``node_draining`` warning (provider
  preemption included) pre-warms a replacement *during* the warning
  window via :meth:`StandardAutoscaler.prewarm_for_drain`; the
  replacement is reserved in ``_net_pending_capacity`` so the incoming
  loss is credited, never double-launched.
- **history → forecast**: a seasonal-naive forecast over the TSDB's 48h
  demand rungs feeds the autoscaler a lead-time demand floor
  (:meth:`StandardAutoscaler.set_forecast_demand`) so it scales ahead
  of the diurnal curve instead of behind it.
- **standby supervision**: keep one warm GCS standby attached (launch
  ``python -m ray_tpu_torch._private.replication`` when none is, re-launch on
  standby death) and emit ``unprotected_head`` while the ledger is
  unreplicated.

Every reflex is **rate-limited and hysteresis-guarded** so a noisy
detector can never cause an actuation storm: at most
``max_drains_per_window`` drains per ``drain_window_s`` cluster-wide, a
per-node relapse window (``node_cooldown_s``: straggling again soon
after an undrain is drained permanently; later starts fresh), and
explicit vetoes (a node that is the sole host of a placement group,
the sole provider of a resource kind, or the last schedulable node, is
never drained).  Every action — applied, skipped, or errored — is
recorded in a bounded history, emitted as an ``autopilot_action`` fleet
event, and counted in ``rtt_autopilot_actions_total{kind,outcome}``,
so the loop itself is observable and chaos-testable.

The policy core (:class:`Autopilot`) is clock-injectable and actuates
through a narrow duck-typed :class:`Actuator`; :class:`GcsActuator`
binds it to the live head, and the fleet simulator's ``SimActuator``
(``elastic/fleet_sim.py``) drives the identical policy over seeded
100-node traces — the storm bounds are asserted against the same code
that runs in production.

What the autopilot will NEVER do without an operator: terminate a
node, delete data, scale the fleet *down* (the forecast floor only adds
capacity; reclaim stays the autoscaler's idle-timeout policy), or
touch a node twice inside its cooldown.

Locking: one no-block leaf lock (``AUTOPILOT_LOCK_DAG`` in
lock_watchdog.py) guards everything ``autopilot_status`` readers see —
the bounded action history, the counters, and the two stats fields
(``_forecast_slots``, ``_unprotected_since``).  All other reflex state
(cooldowns, rate window, per-node ledger) is single-writer — only the
tick thread touches it — and actuator calls run with no autopilot lock
held.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import rtlog

logger = rtlog.get("autopilot")

# action kinds / outcomes (the rtt_autopilot_actions_total tag values)
KIND_DRAIN = "drain"
KIND_UNDRAIN = "undrain"
KIND_PREWARM = "prewarm"
KIND_FORECAST = "forecast"
KIND_STANDBY = "standby_launch"
OUT_APPLIED = "applied"
OUT_SKIPPED = "skipped"
OUT_ERROR = "error"

_ACTION_HISTORY = 256          # bounded action ring (status surface)


@dataclass
class AutopilotConfig:
    """Reflex policy knobs — see the ``autopilot_*`` flags in
    ``_private/config.py`` for the operator-facing documentation."""

    interval_s: float = 1.0
    drain_window_s: float = 300.0
    max_drains_per_window: int = 1
    node_cooldown_s: float = 600.0
    undrain_after_s: float = 120.0
    prewarm: bool = True
    forecast: bool = True
    forecast_interval_s: float = 30.0
    forecast_horizon_s: float = 120.0
    forecast_period_s: float = 86400.0
    standby: bool = False
    standby_backoff_s: float = 5.0

    @classmethod
    def from_global_config(cls) -> "AutopilotConfig":
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as g
        return cls(
            interval_s=g.autopilot_interval_s,
            drain_window_s=g.autopilot_drain_window_s,
            max_drains_per_window=g.autopilot_max_drains_per_window,
            node_cooldown_s=g.autopilot_node_cooldown_s,
            undrain_after_s=g.autopilot_undrain_after_s,
            prewarm=g.autopilot_prewarm,
            forecast=g.autopilot_forecast,
            forecast_interval_s=g.autopilot_forecast_interval_s,
            forecast_horizon_s=g.autopilot_forecast_horizon_s,
            forecast_period_s=g.autopilot_forecast_period_s,
            standby=g.autopilot_standby and g.gcs_wal,
            standby_backoff_s=g.autopilot_standby_backoff_s)


class Actuator:
    """What the autopilot may do to the world — the narrow, duck-typed
    surface both the live head (:class:`GcsActuator`) and the fleet
    simulator implement.  Methods returning ``bool`` report whether the
    action took effect; ``False`` records a ``skipped`` outcome."""

    def drain(self, node_id: str, reason: str) -> bool:
        raise NotImplementedError

    def undrain(self, node_id: str) -> bool:
        raise NotImplementedError

    def veto(self, node_id: str) -> Optional[str]:
        """Reason this node must NOT be drained, or None."""
        return None

    def prewarm(self, node_id: str) -> bool:
        return False

    def demand_now(self) -> float:
        return 0.0

    def demand_forecast(self) -> Optional[float]:
        return None

    def forecast_demand(self, slots: int) -> bool:
        return False

    def emit(self, kind: str, node_id: Optional[str] = None,
             **fields) -> None:
        pass

    def incident(self, node_id: str, reason: str) -> Optional[str]:
        """Post-mortem bundle id for this node's episode (§4o) — the
        head captures one (or returns the id the detector's capture
        already minted inside the dedup window); None = unsupported."""
        return None

    # -- standby supervision (head-only; None = unsupported here)
    def standby_count(self) -> Optional[int]:
        return None

    def standby_alive(self) -> bool:
        return False

    def launch_standby(self) -> bool:
        return False

    def shutdown(self) -> None:
        pass


class Autopilot:
    """The reflex engine.  Feed fleet events with :meth:`observe`, run
    reflex passes with :meth:`tick` (the GCS monitor loop / the sim's
    tick loop); read the bounded action history with :meth:`actions`.

    Single-writer: ``observe``/``tick`` must be called from ONE thread
    (the GCS monitor thread live; the sim loop in the harness).  Only
    the action history crosses threads (status RPC) and is guarded by
    the one leaf lock."""

    def __init__(self, config: AutopilotConfig, actuator: Actuator,
                 clock=time.monotonic, metrics: bool = True):
        self.config = config
        self.actuator = actuator
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()   # no-block leaf (AUTOPILOT_LOCK_DAG)
        self._actions: deque = deque(maxlen=_ACTION_HISTORY)
        # guarded by: _lock
        self._counts: Dict[str, int] = {}            # guarded by: _lock
        # -- tick-thread-only reflex state (single owner, never locked):
        self._pending: List[dict] = []           # observed, unprocessed
        self._drain_times: deque = deque()       # applied drains (rate win)
        self._nodes: Dict[str, dict] = {}        # per-node ledger
        self._prewarmed: set = set()
        self._skip_memo: Dict[tuple, float] = {}
        # the two tick-written fields stats() also reports cross-thread
        # ride the same leaf lock as the history (scalar writes, but
        # the single-writer contract stays lint-enforceable)
        self._forecast_slots = -1                # guarded by: _lock
        self._last_forecast = float("-inf")
        self._unprotected: Optional[float] = None  # guarded by: _lock
        self._last_unprotected_emit = float("-inf")
        self._last_standby_launch: Optional[float] = None

    # --------------------------------------------------------------- intake
    def observe(self, event: dict) -> None:
        """Feed one fleet event (straggler / node_draining /
        node_removed); processed on the next :meth:`tick`."""
        kind = event.get("kind")
        if kind in ("straggler", "node_draining", "node_removed"):
            self._pending.append(dict(event))

    # ----------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One reflex pass; returns the actions recorded this pass."""
        now = self._clock() if now is None else now
        taken: List[dict] = []
        pending, self._pending = self._pending, []
        for ev in pending:
            kind = ev.get("kind")
            if kind == "straggler":
                taken += self._reflex_straggler(ev, now)
            elif kind == "node_draining":
                taken += self._reflex_prewarm(ev, now)
            elif kind == "node_removed":
                nid = ev.get("node_id")
                self._nodes.pop(nid, None)
                self._prewarmed.discard(nid)
        taken += self._reflex_undrain(now)
        # the forecast is a slow diurnal signal: two TSDB ladder scans
        # plus a demand scan per evaluation belong on their own cadence,
        # not on every monitor tick
        if self.config.forecast and \
                now - self._last_forecast >= self.config.forecast_interval_s:
            self._last_forecast = now
            taken += self._reflex_forecast(now)
        if self.config.standby:
            taken += self._reflex_standby(now)
        return taken

    # ----------------------------------------------------- reflex: straggler
    def _node(self, node_id: str) -> dict:
        return self._nodes.setdefault(node_id, {
            "drained_at": None, "undrained_at": None,
            "drains": 0, "permanent": False})

    def _drains_in_window(self, now: float) -> int:
        cutoff = now - self.config.drain_window_s
        while self._drain_times and self._drain_times[0] <= cutoff:
            self._drain_times.popleft()
        return len(self._drain_times)

    def _reflex_straggler(self, ev: dict, now: float) -> List[dict]:
        node_id = ev.get("node_id")
        if not node_id:
            return self._skip(KIND_DRAIN, None, "untagged", now)
        st = self._node(node_id)
        if st["permanent"] or st["drained_at"] is not None:
            # a refire against a node we already drained proves the
            # signal has NOT cleared: refresh the sick-timer so the
            # undrain quiet period restarts (the flag contract —
            # "returns after this long WITHOUT a fresh signal")
            if st["drained_at"] is not None:
                st["drained_at"] = now
            return self._skip(KIND_DRAIN, node_id, "already-draining", now)
        if self._drains_in_window(now) >= self.config.max_drains_per_window:
            return self._skip(KIND_DRAIN, node_id, "rate-limited", now)
        veto = self.actuator.veto(node_id)
        if veto:
            return self._skip(KIND_DRAIN, node_id, f"veto:{veto}", now)
        # per-node hysteresis: a straggler signal inside node_cooldown_s
        # of the node's undrain is a RELAPSE — the host is genuinely
        # sick, so it is drained again immediately and permanently
        # (replacement owns it); past the cooldown the node starts
        # fresh and a new drain is an ordinary, recoverable one
        relapse = st["undrained_at"] is not None and \
            now - st["undrained_at"] < self.config.node_cooldown_s
        out: List[dict] = []
        try:
            ok = self.actuator.drain(node_id, "straggler")
        except Exception:  # noqa: BLE001 - an actuator fault is an outcome
            logger.exception("autopilot drain of %s failed", node_id[:8])
            ok = None
        if ok:
            self._drain_times.append(now)
            st["drained_at"] = now
            st["drains"] += 1
            if relapse:
                st["permanent"] = True
            # link the post-mortem bundle: inside the dedup window this
            # returns the id the detector's capture already minted, so
            # the action history points at the evidence without a
            # second bundle ever being written
            try:
                iid = self.actuator.incident(node_id, "straggler")
            except Exception:  # noqa: BLE001 - evidence is best-effort
                iid = None
            out += self._record(KIND_DRAIN, OUT_APPLIED, node_id,
                                "straggler", now,
                                skew=ev.get("skew_ratio"),
                                rank=ev.get("rank"),
                                incident=iid)
            if self.config.prewarm:
                out += self._do_prewarm(node_id, now)
        else:
            outcome = OUT_SKIPPED if ok is False else OUT_ERROR
            out += self._record(KIND_DRAIN, outcome, node_id,
                                "actuator-declined" if ok is False
                                else "actuator-error", now)
        return out

    # ------------------------------------------------------- reflex: prewarm
    def _reflex_prewarm(self, ev: dict, now: float) -> List[dict]:
        node_id = ev.get("node_id")
        if not self.config.prewarm or not node_id:
            return []
        return self._do_prewarm(node_id, now)

    def _do_prewarm(self, node_id: str, now: float) -> List[dict]:
        if node_id in self._prewarmed:
            return []       # one replacement per drain, never a second
        try:
            ok = self.actuator.prewarm(node_id)
        except Exception:  # noqa: BLE001
            logger.exception("autopilot prewarm for %s failed",
                             node_id[:8])
            return self._record(KIND_PREWARM, OUT_ERROR, node_id,
                                "actuator-error", now)
        if ok:
            # only a SUCCESSFUL warm consumes the one-per-drain slot:
            # a decline (e.g. the autoscaler has not attached yet) must
            # stay retryable on the next detector refire
            self._prewarmed.add(node_id)
            return self._record(KIND_PREWARM, OUT_APPLIED, node_id,
                                "drain-warning", now)
        return self._skip(KIND_PREWARM, node_id, "actuator-declined", now)

    # ------------------------------------------------------- reflex: undrain
    def _reflex_undrain(self, now: float) -> List[dict]:
        out: List[dict] = []
        for node_id, st in list(self._nodes.items()):
            if st["drained_at"] is None or st["permanent"]:
                continue
            if now - st["drained_at"] < self.config.undrain_after_s:
                continue
            try:
                ok = self.actuator.undrain(node_id)
            except Exception:  # noqa: BLE001
                logger.exception("autopilot undrain of %s failed",
                                 node_id[:8])
                continue
            if ok:
                # NOT a "last_action" for hysteresis purposes: an
                # undrain must never delay the relapse drain it exists
                # to detect
                st["drained_at"] = None
                st["undrained_at"] = now
                out += self._record(KIND_UNDRAIN, OUT_APPLIED, node_id,
                                    "signal-cleared", now)
            else:
                # the drain is no longer ours to reverse (a provider
                # warning superseded it, or the node is gone): forget
                # the node entirely — it never got its recovery window,
                # so a future straggler there must read as FRESH, not
                # as a relapse-to-permanent
                self._nodes.pop(node_id, None)
                out += self._record(KIND_UNDRAIN, OUT_SKIPPED, node_id,
                                    "not-ours", now)
            self._prewarmed.discard(node_id)
        return out

    # ------------------------------------------------------ reflex: forecast
    def _reflex_forecast(self, now: float) -> List[dict]:
        try:
            pred = self.actuator.demand_forecast()
        except Exception:  # noqa: BLE001 - forecast is advisory
            logger.debug("demand forecast failed", exc_info=True)
            return []
        if pred is None:
            return []
        cur = self.actuator.demand_now()
        slots = max(int(math.ceil(pred - cur)), 0)
        with self._lock:
            unchanged = slots == self._forecast_slots
        if unchanged:
            return []       # hysteresis: hand over only on change
        if self.actuator.forecast_demand(slots):
            with self._lock:
                self._forecast_slots = slots
            return self._record(KIND_FORECAST, OUT_APPLIED, None,
                                f"slots={slots}", now)
        return self._skip(KIND_FORECAST, None, "actuator-declined", now)

    # ------------------------------------------------------- reflex: standby
    def _reflex_standby(self, now: float) -> List[dict]:
        count = self.actuator.standby_count()
        if count is None:
            return []       # no replication hub here
        if count > 0:
            with self._lock:
                self._unprotected = None
            return []
        with self._lock:
            if self._unprotected is None:
                self._unprotected = now
            since = self._unprotected
        # the head is unreplicated: say so (rate-limited), and make it
        # false — launch/relaunch the supervised standby
        if now - self._last_unprotected_emit >= self.config.drain_window_s:
            self._last_unprotected_emit = now
            self.actuator.emit("unprotected_head",
                               since_s=round(now - since, 3))
        if self.actuator.standby_alive():
            return []       # launched; repl_attach still in flight
        last = self._last_standby_launch
        if last is not None and now - last < self.config.standby_backoff_s:
            return []
        self._last_standby_launch = now
        try:
            ok = self.actuator.launch_standby()
        except Exception:  # noqa: BLE001
            logger.exception("standby launch failed")
            return self._record(KIND_STANDBY, OUT_ERROR, None,
                                "launch-error", now)
        return self._record(KIND_STANDBY,
                            OUT_APPLIED if ok else OUT_SKIPPED, None,
                            "unprotected-head", now)

    # ------------------------------------------------------------ recording
    def _skip(self, kind: str, node_id: Optional[str], reason: str,
              now: float) -> List[dict]:
        """Record a skipped action, deduped per (kind, node, reason)
        within the drain window — a detector refiring every tick must
        not flood the history with identical skips."""
        memo = (kind, node_id, reason)
        last = self._skip_memo.get(memo)
        if last is not None and now - last < self.config.drain_window_s:
            return []
        self._skip_memo[memo] = last = now
        if len(self._skip_memo) > 4 * _ACTION_HISTORY:
            cutoff = now - self.config.drain_window_s
            self._skip_memo = {k: t for k, t in self._skip_memo.items()
                               if t >= cutoff}
        return self._record(kind, OUT_SKIPPED, node_id, reason, now)

    def _record(self, kind: str, outcome: str, node_id: Optional[str],
                reason: str, now: float, **extra) -> List[dict]:
        rec = {"ts": now, "kind": kind, "outcome": outcome,
               "node_id": node_id, "reason": reason,
               **{k: v for k, v in extra.items() if v is not None}}
        with self._lock:
            self._actions.append(rec)
            key = f"{kind}/{outcome}"
            self._counts[key] = self._counts.get(key, 0) + 1
        logger.info("autopilot %s %s node=%s (%s)", kind, outcome,
                    (node_id or "-")[:8], reason)
        try:
            self.actuator.emit("autopilot_action", node_id=node_id,
                               action=kind, outcome=outcome, reason=reason)
        except Exception:  # noqa: BLE001 - the feed is best-effort
            logger.debug("autopilot_action emit failed", exc_info=True)
        if self._metrics:
            try:
                from ray_tpu_torch._private.config import GLOBAL_CONFIG
                if GLOBAL_CONFIG.metrics_enabled:
                    from ray_tpu_torch.util import metrics_catalog as mcat
                    mcat.get("rtt_autopilot_actions_total").inc(
                        tags={"kind": kind, "outcome": outcome})
            except Exception:  # noqa: BLE001 - telemetry best-effort
                pass
        return [rec]

    # --------------------------------------------------------------- status
    def actions(self, limit: int = 50) -> List[dict]:
        with self._lock:
            out = list(self._actions)
        return out[-max(int(limit), 1):]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"counts": dict(self._counts),
                    "forecast_slots": max(self._forecast_slots, 0),
                    "unprotected": self._unprotected is not None}


# ---------------------------------------------------------------- live bind
class GcsActuator(Actuator):
    """Binds the reflex engine to the live head: node phases through the
    GCS ledger, capacity through an (optionally) attached autoscaler,
    forecasts through the head TSDB, standby supervision through a
    subprocess the head owns.  Runs on the GCS monitor thread with no
    GCS lock held; every method takes only the locks it documents."""

    def __init__(self, gcs):
        self.gcs = gcs
        self.autoscaler = None      # attached via AutoscalerLoop
        self._standby_proc = None
        self._closed = False

    # -- drains ride the same internal path as the node_draining RPC,
    # but never claim a node some other authority is already draining
    def drain(self, node_id: str, reason: str) -> bool:
        return self.gcs.drain_node_internal(node_id, deadline_s=0.0,
                                            reason=reason,
                                            only_if_running=True)

    def undrain(self, node_id: str) -> bool:
        # only reverse our OWN drains: a provider warning that arrived
        # (and overwrote the reason) while the node was drained must
        # not be cancelled by the recovery timer
        return self.gcs.undrain_node_internal(node_id,
                                              only_reason="straggler")

    def incident(self, node_id: str, reason: str) -> Optional[str]:
        # runs on the monitor thread like the detector pass, so the
        # head's per-node dedup ledger makes this the SAME bundle the
        # detector captured moments earlier (exactly-once per episode)
        return self.gcs._capture_incident(reason, node_id)

    def veto(self, node_id: str) -> Optional[str]:
        with self.gcs.lock:
            running = [n for n in self.gcs.nodes.values()
                       if n.alive and n.phase == "running"]
            if [n.node_id for n in running] == [node_id]:
                return "last-schedulable-node"
            node = self.gcs.nodes.get(node_id)
            if node is not None:
                # the sole provider of a resource kind (the last GPU
                # host, the only node with a custom accelerator) is
                # never drained: remediation must not take the fleet's
                # only capacity of a kind offline — operator territory
                for kind, total in node.resources_total.items():
                    if total <= 0 or kind.startswith("node:"):
                        continue
                    others = any(
                        n.resources_total.get(kind, 0.0) > 0
                        for n in running if n.node_id != node_id)
                    if not others:
                        return f"sole-resource-host:{kind}"
            for pg in self.gcs.pgs.values():
                hosts = {h for h in pg.assignment if h}
                if hosts == {node_id}:
                    # draining the sole host of a placement group would
                    # strand the whole group — operator territory
                    return "pg-sole-host"
        return None

    def prewarm(self, node_id: str) -> bool:
        if self.autoscaler is None:
            return False
        with self.gcs.lock:
            node = self.gcs.nodes.get(node_id)
            busy = node is not None and bool(node.workers)
            # the autoscaler's provider speaks ITS id namespace —
            # Kubernetes pod names, carried as the ray-pod label (the
            # same dual-keying _node_phases does); fall back to the
            # cluster id for providers whose ids coincide
            provider_id = node_id
            if node is not None:
                provider_id = node.labels.get("ray-pod") or node_id
        if not busy:
            return False        # idle node: a replacement buys nothing
        return self.autoscaler.prewarm_for_drain(provider_id)

    def demand_now(self) -> float:
        """The demand LEVEL (backlog + capacity already serving it) —
        the same quantity the forecast predicts, so the floor is their
        difference.  Forecasting residual backlog alone would
        self-extinguish: once scaling keeps up, yesterday's backlog is
        ~0 and the reflex would oscillate with the seasonal period."""
        d = self.gcs._h_resource_demand({})
        backlog = float(len(d["task_shapes"]) + len(d["pg_bundles"]))
        with self.gcs.lock:
            # exclude the head: the forecast side is built from
            # rtt_autoscaler_nodes{phase="running"}, which counts
            # provider worker nodes only — now and predicted must be
            # the same unit or the floor is biased by the difference
            running = sum(1 for nid, n in self.gcs.nodes.items()
                          if n.alive and n.phase == "running"
                          and nid != self.gcs.head_node_id)
        return backlog + running

    def demand_forecast(self) -> Optional[float]:
        if self.autoscaler is None or self.gcs._tsdb is None:
            return None
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        def fc(expr):
            rows = self.gcs._tsdb.forecast(
                expr, GLOBAL_CONFIG.autopilot_forecast_horizon_s,
                period_s=GLOBAL_CONFIG.autopilot_forecast_period_s)
            return sum(r["value"] for r in rows) if rows else None

        backlog = fc("rtt_autoscaler_demand_backlog")
        running = fc('rtt_autoscaler_nodes{phase="running"}')
        if backlog is None and running is None:
            return None
        return float(backlog or 0.0) + float(running or 0.0)

    def forecast_demand(self, slots: int) -> bool:
        if self.autoscaler is None:
            return False
        self.autoscaler.set_forecast_demand(slots)
        return True

    def emit(self, kind: str, node_id: Optional[str] = None,
             **fields) -> None:
        self.gcs._fleet_event(kind, node_id, **fields)

    # -- standby supervision (satellite of §4l: successor item b)
    def standby_count(self) -> Optional[int]:
        hub = self.gcs._repl_hub
        return None if hub is None else hub.standby_count()

    def standby_alive(self) -> bool:
        p = self._standby_proc
        return p is not None and p.poll() is None

    def launch_standby(self) -> bool:
        import os
        import subprocess
        import sys
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        if self._closed or self.gcs._shutdown:
            return False    # a clean shutdown is in progress: no respawn
        session_dir = str(self.gcs.session.path)
        log_path = os.path.join(session_dir, "logs",
                                "autopilot_standby.log")
        logf = open(log_path, "ab")
        try:
            self._standby_proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.replication",
                 "--session", session_dir],
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True,
                env={**os.environ, **GLOBAL_CONFIG.to_env()})
        finally:
            logf.close()
        logger.info("autopilot launched GCS standby pid=%d (log: %s)",
                    self._standby_proc.pid, log_path)
        if self._closed:
            # raced a concurrent clean shutdown (the monitor thread was
            # mid-tick when it started): tear the fresh standby down —
            # an orphan would promote over a deliberately stopped head
            self.shutdown()
            return False
        return True

    def shutdown(self) -> None:
        """Clean head shutdown: the supervised standby must die with us
        (promoting over a deliberately stopped cluster would resurrect
        it).  A SIGKILLed head never runs this — exactly the case the
        standby exists to survive."""
        self._closed = True
        p, self._standby_proc = self._standby_proc, None
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001 - stubborn child
                p.kill()
                p.wait(timeout=5)
