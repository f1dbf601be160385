"""The port's fleet simulator (elastic/fleet_sim.py): the O(100)-node
harness that replays scripted preemption + diurnal-demand traces against
the REAL autoscaler bin-packing loop, deterministically from a seed —
the reference's ``tests/test_fleet_sim.py`` case by case, on hosts of
eight cards.

Pure simulation — no cluster, no torch; runs in milliseconds.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ray_tpu_torch.elastic.autopilot import AutopilotConfig  # noqa: E402
from ray_tpu_torch.elastic.fleet_sim import (FleetSimulator,  # noqa: E402
                                       TrainJobModel)
from ray_tpu_torch.elastic.traces import (DemandTrace,  # noqa: E402
                                    diurnal_demand_trace,
                                    synthetic_preemption_trace)

SLICE = {"CPU": 8, "GPU": 8}


def _node_types(n=120):
    return {"slice": {"resources": dict(SLICE),
                      "min_workers": 0, "max_workers": n}}


def _ab_sim(seed=7, duration=7200.0, nodes=100, **job_kw):
    trace = synthetic_preemption_trace(
        seed, duration_s=duration, n_slices=nodes,
        mean_interval_s=240.0, warning_s=30.0, unwarned_fraction=0.1,
        outage_every_s=1800.0, outage_len_s=120.0)
    return FleetSimulator(
        node_types=_node_types(nodes), demand_shape=dict(SLICE),
        preemption=trace,
        job=TrainJobModel(slices_target=16, **job_kw),
        tick_s=5.0, boot_delay_s=45.0, max_workers=nodes)


def test_traces_are_seeded_and_reproducible():
    a = synthetic_preemption_trace(3, 3600, 100, mean_interval_s=120)
    b = synthetic_preemption_trace(3, 3600, 100, mean_interval_s=120)
    c = synthetic_preemption_trace(4, 3600, 100, mean_interval_s=120)
    assert [vars(e) for e in a.events] == [vars(e) for e in b.events]
    assert [vars(e) for e in a.events] != [vars(e) for e in c.events]
    assert a.events, "empty trace"
    d1 = diurnal_demand_trace(3, 3600)
    d2 = diurnal_demand_trace(3, 3600)
    assert d1.bursts == d2.bursts
    assert any(d1.shapes_at(t) != d1.base for t in range(0, 3600, 60))


def test_100_node_sim_deterministic_and_elastic_beats_restart():
    """The acceptance sim: 100 simulated nodes, scripted preemptions,
    identical seed → bit-identical report; elastic re-mesh ≥2× the
    restart-from-checkpoint goodput on the same trajectory; no stranded
    demand, no double-placement."""
    r1 = _ab_sim().run().to_dict()
    r2 = _ab_sim().run().to_dict()
    assert r1 == r2, "not deterministic from the seed"
    assert r1["preempted"] > 10
    assert r1["stranded_demand"] == 0
    assert r1["double_placements"] == 0
    assert r1["goodput_ratio"] >= 2.0, r1["goodput_ratio"]
    e = r1["policies"]["elastic"]
    r = r1["policies"]["restart"]
    # the mechanism, not just the headline: the restart policy loses
    # time to recompute (wasted steps) AND long cold-start pauses
    assert e["useful_steps"] > r["useful_steps"]
    assert e["paused_s"] < r["paused_s"]
    assert r["wasted_steps"] > e["wasted_steps"]


def test_warned_vs_unwarned_preemptions_change_elastic_cost():
    """With NO advance warning the elastic policy degrades toward the
    restart policy — the node_draining signal is what buys the gap."""
    warned = _ab_sim().run()
    trace = synthetic_preemption_trace(
        7, duration_s=7200.0, n_slices=100, mean_interval_s=240.0,
        warning_s=30.0, unwarned_fraction=1.0)
    unwarned = FleetSimulator(
        node_types=_node_types(), demand_shape=dict(SLICE),
        preemption=trace, job=TrainJobModel(slices_target=16),
        tick_s=5.0, boot_delay_s=45.0, max_workers=100).run()
    assert unwarned.goodput_ratio < warned.goodput_ratio
    # unwarned: both policies pay cold starts; ratio collapses to ~1
    assert unwarned.goodput_ratio < 1.5


def test_autoscaler_does_not_overlaunch_during_boot_window():
    """Repeated reconciles while replacements boot must not re-launch
    for the same demand (the pending-capacity netting in
    StandardAutoscaler.update): steady demand of 16 slices with a 45s
    boot delay and a 10s reconcile cadence launches exactly 16."""
    trace = synthetic_preemption_trace(0, 600.0, 10,
                                       mean_interval_s=1e9)  # no events
    sim = FleetSimulator(
        node_types=_node_types(), demand_shape=dict(SLICE),
        preemption=trace, job=TrainJobModel(slices_target=16),
        tick_s=5.0, boot_delay_s=45.0, max_workers=100)
    report = sim.run()
    assert report.launched == 16, report.launched
    assert report.stranded_demand == 0


def test_outage_backlogs_then_drains():
    """A launch-capacity outage backlogs demand (max_unfulfilled > 0)
    but nothing is permanently stranded once capacity returns."""
    trace = synthetic_preemption_trace(
        5, duration_s=3600.0, n_slices=100, mean_interval_s=200.0,
        warning_s=30.0, outage_every_s=600.0, outage_len_s=180.0)
    sim = FleetSimulator(
        node_types=_node_types(), demand_shape=dict(SLICE),
        preemption=trace, job=TrainJobModel(slices_target=16),
        tick_s=5.0, boot_delay_s=45.0, max_workers=100)
    report = sim.run()
    assert report.max_unfulfilled > 0
    assert report.stranded_demand == 0
    assert report.double_placements == 0


def _closed_sim(autopilot, *, straggler_every=900.0, seed=7,
                duration=7200.0, ap_cfg=None, **sim_kw):
    trace = synthetic_preemption_trace(
        seed, duration_s=duration, n_slices=100,
        mean_interval_s=240.0, warning_s=30.0, unwarned_fraction=0.1,
        outage_every_s=1800.0, outage_len_s=120.0,
        straggler_every_s=straggler_every, straggler_factor=0.4,
        straggler_len_s=900.0)
    return FleetSimulator(
        node_types=_node_types(), demand_shape=dict(SLICE),
        preemption=trace, job=TrainJobModel(slices_target=16),
        tick_s=5.0, boot_delay_s=45.0, max_workers=100,
        autopilot=autopilot,
        autopilot_config=ap_cfg or AutopilotConfig(
            drain_window_s=300.0, max_drains_per_window=2,
            node_cooldown_s=300.0, undrain_after_s=240.0),
        **sim_kw)


def test_closed_loop_autopilot_beats_reactive_on_same_weather():
    """The §4n acceptance sim: on the identical straggler-bearing
    100-node trace, the autopilot-driven elastic policy beats the
    reactive elastic policy against the SAME uninstrumented restart
    denominator — and the closed run is bit-deterministic."""
    reactive = _closed_sim(False).run().to_dict()
    closed = _closed_sim(True).run().to_dict()
    assert closed == _closed_sim(True).run().to_dict(), \
        "closed loop not deterministic from the seed"
    r_restart = reactive["policies"]["restart"]["goodput_steps_per_s"]
    closed_ratio = \
        closed["policies"]["elastic"]["goodput_steps_per_s"] / r_restart
    assert closed_ratio > reactive["goodput_ratio"], \
        (closed_ratio, reactive["goodput_ratio"])
    # the mechanism: remediation drains fired, every one pre-warmed a
    # replacement, no stranded demand and no double placement either way
    counts = closed["autopilot"]["counts"]
    assert counts.get("drain/applied", 0) > 0
    assert counts.get("prewarm/applied", 0) > 0
    for r in (reactive, closed):
        assert r["stranded_demand"] == 0
        assert r["double_placements"] == 0


def test_flapping_straggler_storm_is_rate_bounded():
    """Actuation-storm coverage: degradation episodes arriving far
    faster than the drain budget (every ~120s vs 1 drain / 600s) must
    produce AT MOST the budgeted drains; the suppressed firings land as
    skipped outcomes on the action feed, and every action is a fleet
    event."""
    cfg = AutopilotConfig(drain_window_s=600.0, max_drains_per_window=1,
                          node_cooldown_s=600.0, undrain_after_s=1e9)
    sim = _closed_sim(True, straggler_every=120.0, duration=3600.0,
                      ap_cfg=cfg)
    rep = sim.run()
    counts = rep.autopilot["counts"]
    budget = int(3600.0 / 600.0) + 1
    assert 0 < counts.get("drain/applied", 0) <= budget, counts
    assert counts.get("drain/skipped", 0) > 0, counts
    skipped = [e for e in sim.emitted
               if e["kind"] == "autopilot_action"
               and e.get("action") == "drain"
               and e.get("outcome") == "skipped"]
    assert skipped and any(e["reason"] == "rate-limited"
                           for e in skipped), skipped


def test_vetoed_drain_is_skipped_with_outcome_event():
    """A veto (e.g. the node is a placement group's sole host) blocks
    the drain and the veto is VISIBLE: a skipped outcome action + fleet
    event, zero drains actuated."""
    sim = _closed_sim(True, straggler_every=600.0, duration=3600.0)
    sim.actuator.veto_fn = lambda nid: "pg-sole-host"
    rep = sim.run()
    counts = rep.autopilot["counts"]
    assert counts.get("drain/applied", 0) == 0, counts
    assert counts.get("drain/skipped", 0) > 0, counts
    ev = [e for e in sim.emitted
          if e.get("action") == "drain" and e.get("outcome") == "skipped"]
    assert ev and all(e["reason"] == "veto:pg-sole-host" for e in ev)


def test_forecast_reflex_reduces_demand_lag():
    """Reflex 3 on a pure diurnal trace: scale-ahead cuts the
    unfulfilled-demand integral vs the reactive run on identical
    weather (at the cost of extra launches — reported, not hidden)."""
    def sim(ap):
        trace = synthetic_preemption_trace(0, 10800.0, 100,
                                           mean_interval_s=1e18)
        demand = diurnal_demand_trace(3, 10800.0, base=10, amplitude=8,
                                      period_s=3600.0,
                                      burst_rate_per_hour=0.0)
        return FleetSimulator(
            node_types=_node_types(), demand_shape=dict(SLICE),
            preemption=trace, demand=demand, job=None,
            tick_s=5.0, boot_delay_s=45.0, max_workers=100,
            autopilot=ap, forecast_horizon_s=90.0)
    reactive = sim(False).run()
    closed = sim(True).run()
    assert closed.unfulfilled_integral < reactive.unfulfilled_integral
    assert closed.autopilot["counts"].get("forecast/applied", 0) > 0
    assert closed.stranded_demand == 0 and reactive.stranded_demand == 0


def test_diurnal_demand_drives_scale_up_and_down():
    """The diurnal curve scales the fleet both ways through the real
    reconcile loop: launches track the peak, idle scale-down brings the
    trough back in."""
    trace = synthetic_preemption_trace(0, 7200.0, 100,
                                       mean_interval_s=1e9)
    demand = DemandTrace(duration_s=7200.0, base=10, amplitude=8,
                         period_s=3600.0, bursts=[])
    sim = FleetSimulator(
        node_types=_node_types(), demand_shape=dict(SLICE),
        preemption=trace, demand=demand, job=None,
        tick_s=5.0, boot_delay_s=30.0, max_workers=100)
    report = sim.run()
    assert report.stranded_demand == 0
    assert report.double_placements == 0
    # peak needs ~18 nodes; the trough (~2) must have triggered reaping
    assert report.launched >= 18
    live = len(sim.provider.nodes)
    assert live < report.launched, (live, report.launched)
