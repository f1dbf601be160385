"""``ray_tpu_torch.elastic`` — fleet elasticity (DESIGN.md §4j, §4n).

- **Elasticity manager** (``manager.py``) and its **worker loop**
  (``worker_loop.py``): a driver-side controller that subscribes to the
  GCS fleet-event feed (``node_draining`` preemption warnings, node
  add/remove) and drives *re-mesh-without-restart*: on a warned drain
  the group's gloo domain (``parallel/multihost.py``) quiesces at a step
  boundary, every rank leaves it cleanly, survivors re-form it at the
  new world size and restore model/optimizer state from the gathered
  checkpoint — the surviving Python processes never die.  On scale-up a
  new node's worker attaches to the running group the same way.
  Unwarned (SIGKILL) losses fall back to a full-group restart from the
  same gathered state.  ``TorchTrainer`` routes through it with
  ``TorchConfig(elastic=True)``.

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
"""

from ray_tpu_torch.elastic.autopilot import (Autopilot, AutopilotConfig,
                                             GcsActuator)
from ray_tpu_torch.elastic.events import (FleetEventSubscriber, drain_node,
                                          fleet_events, fleet_state)
from ray_tpu_torch.elastic.goodput import GoodputTracker
from ray_tpu_torch.elastic.manager import (ElasticConfig, ElasticResult,
                                           ElasticityManager)
from ray_tpu_torch.elastic.worker_loop import ElasticSpec

__all__ = [
    "Autopilot", "AutopilotConfig", "ElasticConfig", "ElasticResult",
    "ElasticSpec", "ElasticityManager", "FleetEventSubscriber",
    "GcsActuator", "GoodputTracker", "drain_node", "fleet_events",
    "fleet_state",
]
