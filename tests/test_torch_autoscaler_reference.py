"""The port's autoscaler, fleet simulator, autopilot and CLI against the
JAX package's, on the same seeded inputs, exactly.

- ``get_nodes_to_launch`` / ``infeasible_shapes`` on 200 node-type
  tables and demand lists drawn from a numpy seed;
- both ``FleetSimulator``s on the same seeded preemption and demand
  traces, with the autopilot on and off: equal reports;
- both ``Autopilot``s fed one seeded event sequence through a recording
  actuator on an injected clock: equal action logs, stats, actuator
  calls and emitted events;
- both ``build_parser()``s: the same subcommands and flags, save
  ``join --num-tpus`` → ``--num-gpus``;
- a CPU-only pod manifest, equal up to the port's names.

Only the port's modules and the reference's JAX-free ones are imported;
the tolerance is exact equality throughout.
"""

import argparse
import copy

import numpy as np
import pytest

from ray_tpu.autoscaler import kube as j_kube
from ray_tpu.autoscaler import resource_demand_scheduler as j_rds
from ray_tpu.elastic import autopilot as j_ap
from ray_tpu.elastic import fleet_sim as j_sim
from ray_tpu.elastic import traces as j_traces
from ray_tpu.scripts import cli as j_cli
from ray_tpu_torch.autoscaler import kube as t_kube
from ray_tpu_torch.autoscaler import resource_demand_scheduler as t_rds
from ray_tpu_torch.elastic import autopilot as t_ap
from ray_tpu_torch.elastic import fleet_sim as t_sim
from ray_tpu_torch.elastic import traces as t_traces
from ray_tpu_torch.scripts import cli as t_cli

KINDS = ("CPU", "GPU", "memory", "h100-8")


def _draw_case(rng):
    """One node-type table and one demand list."""
    types = {}
    for i in range(int(rng.integers(1, 5))):
        res = {k: float(rng.integers(1, 9)) for k in KINDS
               if rng.random() < (0.9 if k == "CPU" else 0.4)}
        cfg = {"resources": res or {"CPU": 1.0}}
        if rng.random() < 0.7:
            cfg["min_workers"] = int(rng.integers(0, 3))
        if rng.random() < 0.7:
            cfg["max_workers"] = int(rng.integers(0, 6))
        types[f"t{i}"] = cfg
    demand = []
    for _ in range(int(rng.integers(0, 25))):
        shape = {k: float(rng.choice([0.5, 1.0, 2.0, 4.0, 8.0, 16.0]))
                 for k in KINDS if rng.random() < 0.4}
        demand.append(shape or {"CPU": 1.0})
    counts = {t: int(rng.integers(0, 3)) for t in types
              if rng.random() < 0.5}
    max_total = int(rng.integers(1, 30))
    return types, counts, demand, max_total


def test_bin_packing_equals_reference_on_200_seeded_cases():
    rng = np.random.default_rng(20)
    launched = infeasible = 0
    for _ in range(200):
        types, counts, demand, max_total = _draw_case(rng)
        j = j_rds.get_nodes_to_launch(copy.deepcopy(types), dict(counts),
                                      copy.deepcopy(demand), max_total)
        t = t_rds.get_nodes_to_launch(copy.deepcopy(types), dict(counts),
                                      copy.deepcopy(demand), max_total)
        assert t == j, (types, counts, demand, max_total)
        ji = j_rds.infeasible_shapes(types, demand)
        ti = t_rds.infeasible_shapes(types, demand)
        assert ti == ji
        launched += sum(j.values())
        infeasible += len(ji)
    # the draw exercises both outcomes
    assert launched > 100 and infeasible > 20


def _sim(mod, traces, autopilot, seed):
    shape = {"CPU": 8.0, "GPU": 8.0}
    pre = traces.synthetic_preemption_trace(
        seed, duration_s=3600.0, n_slices=60, mean_interval_s=180.0,
        warning_s=30.0, unwarned_fraction=0.2, outage_every_s=1200.0,
        outage_len_s=120.0, straggler_every_s=600.0,
        straggler_factor=0.4, straggler_len_s=600.0)
    demand = traces.diurnal_demand_trace(
        seed, duration_s=3600.0, base=12, amplitude=8, period_s=1800.0,
        burst_rate_per_hour=3.0, burst_extra=6, burst_len_s=240.0)
    return mod.FleetSimulator(
        node_types={"host": {"resources": dict(shape), "min_workers": 0,
                             "max_workers": 60}},
        demand_shape=dict(shape), preemption=pre, demand=demand,
        job=mod.TrainJobModel(slices_target=8), tick_s=5.0,
        boot_delay_s=45.0, max_workers=60, autopilot=autopilot)


@pytest.mark.parametrize("autopilot", [False, True], ids=["off", "on"])
def test_fleet_simulator_reports_equal_reference(autopilot):
    for seed in (3, 11):
        j = _sim(j_sim, j_traces, autopilot, seed)
        t = _sim(t_sim, t_traces, autopilot, seed)
        jr, tr = j.run().to_dict(), t.run().to_dict()
        assert tr == jr
        assert t.emitted == j.emitted
        assert tr["launched"] > 0 and tr["preempted"] > 0
        if autopilot:
            assert tr["autopilot"]["counts"].get("drain/applied", 0) > 0


class RecordingActuator:
    """Both packages' autopilots actuate through this one duck-typed
    class; its answers are drawn from a seed shared by both runs."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = []
        self.events = []
        self._standby = False

    def _ok(self):
        return bool(self.rng.random() < 0.8)

    def drain(self, node_id, reason):
        self.calls.append(("drain", node_id, reason))
        return self._ok()

    def undrain(self, node_id):
        self.calls.append(("undrain", node_id))
        return self._ok()

    def veto(self, node_id):
        return "pg-sole-host" if self.rng.random() < 0.1 else None

    def prewarm(self, node_id):
        self.calls.append(("prewarm", node_id))
        return self._ok()

    def demand_now(self):
        return float(self.rng.integers(0, 10))

    def demand_forecast(self):
        return None if self.rng.random() < 0.2 else \
            float(self.rng.integers(0, 14))

    def forecast_demand(self, slots):
        self.calls.append(("forecast", slots))
        return True

    def emit(self, kind, node_id=None, **fields):
        self.events.append({"kind": kind, "node_id": node_id, **fields})

    def incident(self, node_id, reason):
        self.calls.append(("incident", node_id, reason))
        return f"inc-{len(self.calls)}"

    def standby_count(self):
        return int(self.rng.integers(0, 2))

    def standby_alive(self):
        return self._standby

    def launch_standby(self):
        self.calls.append(("standby",))
        self._standby = not self._standby
        return True

    def shutdown(self):
        pass


def _drive(mod, seed):
    rng = np.random.default_rng(seed)
    now = [0.0]
    cfg = mod.AutopilotConfig(
        drain_window_s=120.0, max_drains_per_window=2,
        node_cooldown_s=300.0, undrain_after_s=60.0,
        forecast_interval_s=15.0, standby=True, standby_backoff_s=10.0)
    act = RecordingActuator(seed + 1)
    ap = mod.Autopilot(cfg, act, clock=lambda: now[0], metrics=False)
    kinds = ("straggler", "node_draining", "node_removed", "node_added",
             "slo_burn")
    for _ in range(400):
        now[0] += float(rng.choice([0.5, 1.0, 5.0, 20.0]))
        for _ in range(int(rng.integers(0, 3))):
            ev = {"kind": str(rng.choice(kinds)),
                  "node_id": f"n{int(rng.integers(0, 8))}",
                  "ts": now[0]}
            if ev["kind"] == "straggler":
                ev["skew_ratio"] = float(rng.integers(2, 9))
                ev["rank"] = str(int(rng.integers(0, 4)))
            ap.observe(ev)
        ap.tick(now=now[0])
    return ap, act


def test_autopilot_action_logs_equal_reference():
    for seed in (0, 7, 42):
        ja, jact = _drive(j_ap, seed)
        ta, tact = _drive(t_ap, seed)
        assert ta.actions(limit=100000) == ja.actions(limit=100000)
        assert ta.stats() == ja.stats()
        assert tact.calls == jact.calls
        assert tact.events == jact.events
        counts = ta.stats()["counts"]
        assert counts.get("drain/applied") and counts.get("drain/skipped")
        assert counts.get("prewarm/applied") and counts.get("undrain/applied")


def _surface(parser):
    """{subcommand: sorted (option strings, dest, default, choices,
    nargs, type, required)} of a CLI parser."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, sp in sub.choices.items():
        out[name] = sorted(
            (tuple(a.option_strings), a.dest, repr(a.default),
             repr(a.choices), repr(a.nargs),
             getattr(a.type, "__name__", repr(a.type)), a.required)
            for a in sp._actions)
    return out


def test_cli_surface_equals_reference():
    j = _surface(j_cli.build_parser())
    t = _surface(t_cli.build_parser())
    assert sorted(t) == sorted(j)
    assert len(t) == 16
    swap = {"--num-tpus": "--num-gpus", "num_tpus": "num_gpus"}
    j["join"] = sorted(
        (tuple(swap.get(o, o) for o in opts), swap.get(dest, dest),
         *rest) for opts, dest, *rest in j["join"])
    assert t == j
    assert any(opts == ("--num-gpus",) for opts, *_ in t["join"])


def test_cpu_pod_manifest_equals_reference_up_to_names(monkeypatch):
    for var in ("RTPU_AUTH_KEY", "RTT_AUTH_KEY", "RTPU_IMAGE", "RTT_IMAGE",
                "RTPU_HEAD_ADDRESS", "RTT_HEAD_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr("uuid.uuid4", lambda: __import__("uuid").UUID(int=7))
    node_cfg = {"resources": {"CPU": 4}, "labels": {"pool": "a"},
                "drain_grace_s": 20,
                "pod_overrides": {"spec": {"priorityClassName": "hi"}}}
    tags = {"node-kind": "worker", "node-type": "cpu4"}
    pcfg = {"client": object(), "head_address": "head:10001",
            "auth_key_secret": "k"}
    j = j_kube.KubernetesNodeProvider(dict(pcfg), "c")._pod_manifest(
        copy.deepcopy(node_cfg), dict(tags))
    t = t_kube.KubernetesNodeProvider(dict(pcfg), "c")._pod_manifest(
        copy.deepcopy(node_cfg), dict(tags))
    names = {"ray-tpu/": "ray-tpu-torch/", "RTPU_": "RTT_",
             "NUM_TPUS": "NUM_GPUS", "ray_tpu.": "ray_tpu_torch.",
             "ray-tpu-worker": "ray-tpu-torch-worker",
             "ray-tpu:latest": "ray-tpu-torch:latest"}

    def rename(x):
        if isinstance(x, dict):
            return {rename(k): rename(v) for k, v in x.items()}
        if isinstance(x, list):
            return [rename(v) for v in x]
        if isinstance(x, str):
            for a, b in names.items():
                x = x.replace(a, b)
        return x

    assert t == rename(j)
    assert t["metadata"]["labels"]["ray-tpu-torch/cluster"] == "c"
    assert "nodeSelector" not in t["spec"]
    assert t["spec"]["priorityClassName"] == "hi"
