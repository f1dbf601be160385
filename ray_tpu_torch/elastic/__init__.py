"""``ray_tpu_torch.elastic`` — fleet elasticity's control plane
(DESIGN.md §4j, §4n).

- **Fleet events** (``events.py``): ``drain_node`` (a provider's
  preemption warning), the ``FleetEventSubscriber`` polling client and
  ``fleet_state``, over the head's ``node_draining`` / ``fleet_events``
  RPCs.

- **Fleet simulator** (``fleet_sim.py`` + ``traces.py``): an
  O(100)-simulated-node harness replaying scripted preemption and
  diurnal-demand traces (seeded, deterministic) against the REAL
  autoscaler bin-packing loop, with goodput accounting for the elastic
  vs restart-from-checkpoint recovery policies.

- **Goodput accounting** (``goodput.py``): useful (first-time) train
  steps per wall-second.

- **Autopilot** (``autopilot.py``, DESIGN.md §4n): the reflex arc
  closing the observability → actuation loop — straggler events drain
  the offending host, drain warnings pre-warm replacements, the TSDB's
  diurnal history feeds the autoscaler a lead-time demand signal, and
  the head keeps a warm GCS standby attached.  Rate-limited,
  hysteresis-guarded, vetoed — and every action is itself a fleet
  event + metric.  The head runs it with ``autopilot_enabled``.

The elasticity manager and its worker loop (re-forming a training group
at a new world size without a restart) are not here yet.
"""

from ray_tpu_torch.elastic.autopilot import (Autopilot, AutopilotConfig,
                                             GcsActuator)
from ray_tpu_torch.elastic.events import (FleetEventSubscriber, drain_node,
                                          fleet_events, fleet_state)
from ray_tpu_torch.elastic.goodput import GoodputTracker

__all__ = [
    "Autopilot", "AutopilotConfig", "FleetEventSubscriber", "GcsActuator",
    "GoodputTracker", "drain_node", "fleet_events", "fleet_state",
]
