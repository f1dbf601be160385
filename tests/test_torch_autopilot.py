"""The port's fleet autopilot (DESIGN.md §4n): the observability →
actuation loop — the reference's ``tests/test_autopilot.py`` case by
case, on hosts with cards.

Three layers, cheapest first:

- **reflex policy units** — the rate limiter, per-node hysteresis,
  vetoes (with ``skipped`` outcome events), relapse-to-permanent, the
  forecast floor, and standby supervision, against a fake actuator on a
  fake clock;
- **mechanism units** — ``TSDB.forecast`` (seasonal-naive over the
  rungs), the autoscaler's pre-warm reservation in
  ``_net_pending_capacity`` (credited against the incoming loss, never
  double-launched) and forecast-floor scale-down exemption, and the
  elastic gathered-state transport over the object plane;
- **live integration** — the GcsActuator vetoes (pg-sole-host /
  last-schedulable-node), the ``autopilot_status`` RPC, standby
  supervision end to end (launch → kill → relaunch → shutdown);
- **the chaos acceptance path** — straggler injection → detector →
  automatic drain → re-mesh → recovery, under BOTH runtime oracles,
  with ``TorchTrainer.fit`` surviving the cycle through the elastic
  worker loop and the actuation-storm bound asserted.
"""

import gc
import os
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch

# worker processes cannot import this test module by name
cloudpickle.register_pickle_by_value(sys.modules[__name__])

from conftest import time_scale  # noqa: E402
from ray_tpu_torch._private.config import GLOBAL_CONFIG  # noqa: E402
from ray_tpu_torch.elastic.autopilot import (  # noqa: E402
    Actuator, Autopilot, AutopilotConfig, GcsActuator)
from ray_tpu_torch.util import state  # noqa: E402
from rtt_fixtures import restore_logger, session_root  # noqa: E402

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")


@pytest.fixture(scope="module", autouse=True)
def _logger():
    with restore_logger():
        yield


@pytest.fixture
def own_root(monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    with session_root(monkeypatch) as d:
        yield d


def _override(**kw):
    GLOBAL_CONFIG.apply_system_config(kw)


def _clear_overrides(*names):
    with GLOBAL_CONFIG._lock:
        for k in names:
            GLOBAL_CONFIG._overrides.pop(k, None)


# ------------------------------------------------------------ policy units
class FakeActuator(Actuator):
    def __init__(self):
        self.calls = []
        self.events = []
        self.veto_map = {}
        self.drain_ok = True
        self.prewarm_ok = True
        self.forecast_value = None
        self.demand = 0.0
        self.n_standbys = None
        self.launched_standbys = 0
        self._standby_alive = False

    def drain(self, node_id, reason):
        self.calls.append(("drain", node_id, reason))
        return self.drain_ok

    def undrain(self, node_id):
        self.calls.append(("undrain", node_id))
        return True

    def veto(self, node_id):
        return self.veto_map.get(node_id)

    def prewarm(self, node_id):
        self.calls.append(("prewarm", node_id))
        return self.prewarm_ok

    def demand_now(self):
        return self.demand

    def demand_forecast(self):
        return self.forecast_value

    def forecast_demand(self, slots):
        self.calls.append(("forecast", slots))
        return True

    def emit(self, kind, node_id=None, **fields):
        self.events.append({"kind": kind, "node_id": node_id, **fields})

    def standby_count(self):
        return self.n_standbys

    def standby_alive(self):
        return self._standby_alive

    def launch_standby(self):
        self.launched_standbys += 1
        self._standby_alive = True
        return True


def _pilot(**cfg_kw):
    cfg = AutopilotConfig(**{
        "drain_window_s": 60.0, "max_drains_per_window": 1,
        "node_cooldown_s": 120.0, "undrain_after_s": 30.0,
        "standby_backoff_s": 5.0, **cfg_kw})
    act = FakeActuator()
    return Autopilot(cfg, act, clock=lambda: 0.0, metrics=False), act


def _drains(actions, outcome="applied"):
    return [a for a in actions
            if a["kind"] == "drain" and a["outcome"] == outcome]


def test_straggler_reflex_drains_and_prewarms():
    ap, act = _pilot()
    ap.observe({"kind": "straggler", "node_id": "n1", "skew_ratio": 3.0,
                "rank": "2"})
    taken = ap.tick(now=10.0)
    assert ("drain", "n1", "straggler") in act.calls
    assert ("prewarm", "n1") in act.calls
    drains = _drains(taken)
    assert len(drains) == 1 and drains[0]["node_id"] == "n1"
    assert drains[0]["skew"] == 3.0
    # every action is itself a fleet event with its outcome
    kinds = [(e["kind"], e.get("action"), e.get("outcome"))
             for e in act.events]
    assert ("autopilot_action", "drain", "applied") in kinds
    assert ap.stats()["counts"]["drain/applied"] == 1


def test_flapping_straggler_bounded_to_one_drain_per_window():
    """The actuation-storm bound: a detector refiring every tick gets
    exactly max_drains_per_window applied drains per window; the rest
    land as skipped outcomes (deduped, not silent)."""
    ap, act = _pilot()
    for i in range(60):   # flap: a fresh node report every second
        ap.observe({"kind": "straggler", "node_id": f"n{i}"})
        ap.tick(now=float(i))
    applied = _drains(ap.actions(limit=500))
    assert len(applied) == 1, applied          # one drain in the 60s window
    skipped = _drains(ap.actions(limit=500), "skipped")
    assert skipped and all(a["reason"] == "rate-limited"
                           for a in skipped), skipped
    # the skipped outcome is visible on the event feed too
    assert any(e.get("outcome") == "skipped" for e in act.events)
    # window rolls: the next window admits exactly one more
    ap.observe({"kind": "straggler", "node_id": "late"})
    ap.tick(now=100.0)
    assert len(_drains(ap.actions(limit=500))) == 2


def test_vetoed_drain_emits_skipped_outcome():
    ap, act = _pilot()
    act.veto_map["pgn"] = "pg-sole-host"
    ap.observe({"kind": "straggler", "node_id": "pgn"})
    taken = ap.tick(now=1.0)
    assert not [c for c in act.calls if c[0] == "drain"]
    assert taken and taken[0]["outcome"] == "skipped"
    assert taken[0]["reason"] == "veto:pg-sole-host"
    ev = [e for e in act.events if e.get("action") == "drain"]
    assert ev and ev[0]["outcome"] == "skipped"
    assert ev[0]["reason"] == "veto:pg-sole-host"


def test_same_node_hysteresis_and_refire_dedup():
    """Refires against a node already draining are skipped (and the
    identical skip is recorded once per window, not per tick)."""
    ap, act = _pilot()
    for t in range(20):
        ap.observe({"kind": "straggler", "node_id": "n1"})
        ap.tick(now=float(t))
    actions = ap.actions(limit=500)
    assert len(_drains(actions)) == 1
    skips = [a for a in actions if a["outcome"] == "skipped"]
    assert len(skips) == 1 and skips[0]["reason"] == "already-draining"


def test_undrain_after_quiet_and_permanent_on_relapse():
    ap, act = _pilot()   # cooldown 120, undrain_after 30, rate 1/60s
    ap.observe({"kind": "straggler", "node_id": "n1"})
    ap.tick(now=0.0)
    assert len([c for c in act.calls if c[0] == "drain"]) == 1
    # quiet period passes -> returned to the pool
    taken = ap.tick(now=31.0)
    assert [a["kind"] for a in taken] == ["undrain"]
    assert ("undrain", "n1") in act.calls
    # a RELAPSE (straggles again inside node_cooldown_s of the undrain)
    # is drained IMMEDIATELY — the host is sick — and permanently
    ap.observe({"kind": "straggler", "node_id": "n1"})
    ap.tick(now=70.0)    # rate window rolled; 70-31 < cooldown 120
    assert len([c for c in act.calls if c[0] == "drain"]) == 2
    ap.tick(now=500.0)   # way past undrain_after_s
    assert len([c for c in act.calls if c[0] == "undrain"]) == 1  # no 2nd
    # a node whose relapse comes AFTER the cooldown starts fresh: the
    # new drain is ordinary and recoverable
    ap.observe({"kind": "straggler", "node_id": "n2"})
    ap.tick(now=600.0)
    ap.tick(now=631.0)   # undrained
    ap.observe({"kind": "straggler", "node_id": "n2"})
    ap.tick(now=900.0)   # 900-631 > cooldown 120: fresh, not a relapse
    ap.tick(now=931.0)
    assert [c for c in act.calls
            if c[0] == "undrain" and c[1] == "n2"] == \
        [("undrain", "n2"), ("undrain", "n2")]


def test_refire_while_drained_restarts_the_quiet_period():
    """The undrain contract: the node returns only after
    undrain_after_s WITHOUT a fresh signal — a refire against the
    drained node restarts the clock, so a still-sick host is not
    handed back to the scheduler."""
    ap, act = _pilot()   # undrain_after 30
    ap.observe({"kind": "straggler", "node_id": "n1"})
    ap.tick(now=0.0)
    ap.observe({"kind": "straggler", "node_id": "n1"})   # still sick
    ap.tick(now=20.0)
    assert ap.tick(now=31.0) == []      # 31 < 20 + 30: NOT returned
    taken = ap.tick(now=51.0)           # quiet since 20 -> returned
    assert [a["kind"] for a in taken] == ["undrain"]


def test_drain_warning_prewarms_once():
    ap, act = _pilot()
    for _ in range(3):
        ap.observe({"kind": "node_draining", "node_id": "gone"})
        ap.tick(now=1.0)
    assert [c for c in act.calls if c[0] == "prewarm"] == \
        [("prewarm", "gone")]
    # node replaced -> a later drain of a NEW node prewarms again
    ap.observe({"kind": "node_removed", "node_id": "gone"})
    ap.observe({"kind": "node_draining", "node_id": "gone2"})
    ap.tick(now=2.0)
    assert ("prewarm", "gone2") in act.calls


def test_declined_prewarm_stays_retryable():
    """A decline (e.g. no autoscaler attached yet) must NOT consume the
    one-warm-per-drain slot: the next refire retries and succeeds."""
    ap, act = _pilot()
    act.prewarm_ok = False
    ap.observe({"kind": "node_draining", "node_id": "n1"})
    ap.tick(now=0.0)
    skipped = [a for a in ap.actions() if a["kind"] == "prewarm"]
    assert skipped and skipped[-1]["outcome"] == "skipped"
    act.prewarm_ok = True       # the autoscaler attached
    ap.observe({"kind": "node_draining", "node_id": "n1"})
    ap.tick(now=1.0)
    applied = [a for a in ap.actions() if a["kind"] == "prewarm"
               and a["outcome"] == "applied"]
    assert len(applied) == 1
    # and only ONCE: further refires are absorbed
    ap.observe({"kind": "node_draining", "node_id": "n1"})
    ap.tick(now=2.0)
    assert len([c for c in act.calls if c[0] == "prewarm"]) == 2


def test_forecast_floor_hysteresis():
    ap, act = _pilot(forecast_interval_s=0.0)   # every tick, for the test
    act.forecast_value, act.demand = 7.0, 3.0
    ap.tick(now=1.0)
    assert ("forecast", 4) in act.calls
    n = len(act.calls)
    ap.tick(now=2.0)               # unchanged -> not re-handed-over
    assert len(act.calls) == n
    act.demand = 7.0               # surge arrived: floor decays to 0
    ap.tick(now=3.0)
    assert ("forecast", 0) in act.calls
    assert act.forecast_value is not None


def test_standby_supervision_launch_relaunch_and_unprotected_event():
    ap, act = _pilot(standby=True)
    act.n_standbys = 0
    ap.tick(now=0.0)
    assert act.launched_standbys == 1
    assert any(e["kind"] == "unprotected_head" for e in act.events)
    # alive-but-not-attached: no relaunch spam
    ap.tick(now=1.0)
    assert act.launched_standbys == 1
    # the supervised process died: relaunch after the backoff
    act._standby_alive = False
    ap.tick(now=2.0)               # inside backoff
    assert act.launched_standbys == 1
    ap.tick(now=10.0)
    assert act.launched_standbys == 2
    # protected again: the unprotected window closes
    act.n_standbys = 1
    ap.tick(now=11.0)
    assert ap.stats()["unprotected"] is False
    # no hub at all (replication disabled): reflex is silent
    act.n_standbys = None
    before = len(act.calls)
    ap.tick(now=12.0)
    assert len(act.calls) == before


# --------------------------------------------------------- TSDB forecast
def test_tsdb_seasonal_forecast_and_cold_start():
    from ray_tpu_torch.util.tsdb import TSDB, QueryError

    class Clock:
        t = 1_000_000.0

    db = TSDB(clock=lambda: Clock.t)

    def put(v, at):
        db.ingest("w0", {"snapshot": {"demand": {
            "kind": "gauge", "series": [{"tags": {}, "value": v}]}}},
            now=at)

    period, t0 = 1200.0, Clock.t
    # two periods of a ramp pattern, one sample / 30s
    for i in range(80):
        ts = t0 + 30.0 * i
        put(float((i * 30) % period), ts)
    Clock.t = t0 + 80 * 30.0
    # seasonal anchor: now + 120 - period -> pattern value there
    rows = db.forecast("demand", horizon_s=120.0, period_s=period,
                       smooth_s=60.0)
    assert len(rows) == 1 and rows[0]["seasonal"] is True
    anchor = Clock.t + 120.0 - period
    want = [((t0 + 30.0 * i) - t0) % period for i in range(80)
            if anchor - 60.0 <= t0 + 30.0 * i <= anchor]
    assert rows[0]["value"] == pytest.approx(sum(want) / len(want))
    # cold start: horizon - period reaches before history -> falls back
    # to the recent mean, flagged non-seasonal
    rows = db.forecast("demand", horizon_s=120.0, period_s=10 * period,
                       smooth_s=60.0)
    assert rows and rows[0]["seasonal"] is False
    with pytest.raises(QueryError):
        db.forecast("demand[60s]", horizon_s=1.0)
    with pytest.raises(QueryError):
        db.forecast("demand", horizon_s=1.0, period_s=0.0)


# --------------------------------------------- autoscaler pre-warm units
class _BenchAutoscaler:
    """StandardAutoscaler with sim-fed inputs and an injected clock —
    the prewarm/forecast mechanism under a microscope, no cluster."""

    def __new__(cls, provider, demand_fn, node_types, **kw):
        from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                   StandardAutoscaler)

        class _A(StandardAutoscaler):
            def _demand(self):
                return demand_fn()

            def _node_phases(self):
                return {nid: n.phase for nid, n in provider.nodes.items()}

            def _node_utilization(self):
                return {nid: not n.placements
                        for nid, n in provider.nodes.items()}

        a = _A(AutoscalerConfig(node_types=node_types, **kw), provider)
        return a


def _sim_provider():
    from ray_tpu_torch.elastic.fleet_sim import SimNodeProvider
    return SimNodeProvider(boot_delay_s=30.0)


SLICE = {"CPU": 8, "GPU": 8}
NT = {"slice": {"resources": dict(SLICE), "min_workers": 0,
                "max_workers": 50}}


def test_prewarm_reserved_against_incoming_loss_not_double_launched():
    from ray_tpu_torch.autoscaler.node_provider import (TAG_NODE_KIND,
                                                  TAG_NODE_TYPE,
                                                  NODE_KIND_WORKER)
    provider = _sim_provider()
    demand = []
    auto = _BenchAutoscaler(provider, lambda: list(demand), NT,
                            idle_timeout_s=1e9)
    auto._clock = lambda: provider.now
    tags = {TAG_NODE_KIND: NODE_KIND_WORKER, TAG_NODE_TYPE: "slice"}
    (victim,) = provider.create_node({"resources": dict(SLICE)}, tags, 1)
    provider.tick(100.0, False)   # victim boots
    provider.nodes[victim].placements.append(dict(SLICE))
    provider.drain_node(victim, deadline_s=30.0)
    assert auto.prewarm_for_drain(victim) is True
    assert auto.prewarm_for_drain(victim) is False    # idempotent
    rep = auto.update()
    launched = [n for ids in rep["launched"].values() for n in ids]
    assert len(launched) == 1                          # the replacement
    pw = launched[0]
    # repeated reconciles do NOT launch again for the same drain
    assert auto.update()["launched"] == {}
    # ordinary backlog during the warning window must not eat the
    # reserved replacement: one demand shape -> one NEW launch
    demand.append(dict(SLICE))
    rep = auto.update()
    extra = [n for ids in rep["launched"].values() for n in ids]
    assert len(extra) == 1 and extra[0] != pw
    demand.clear()
    # the drained node dies -> reservation lifts -> the materialized
    # loss demand nets against the (pending) replacement: NO launch
    provider.terminate_node(victim)
    demand.append(dict(SLICE))
    assert auto.update()["launched"] == {}


def test_forecast_floor_launches_ahead_and_survives_scale_down():
    provider = _sim_provider()
    auto = _BenchAutoscaler(provider, lambda: [], NT, idle_timeout_s=60.0)
    auto._clock = lambda: provider.now
    provider.tick(0.0, False)
    auto.set_forecast_demand(3)
    rep = auto.update()
    launched = [n for ids in rep["launched"].values() for n in ids]
    assert len(launched) == 3      # scaled AHEAD of measured demand
    provider.tick(100.0, False)    # booted, idle
    auto.update()                  # idle timers start
    provider.tick(300.0, False)    # idle >> idle_timeout
    assert auto.update()["terminated"] == []   # floor exempts them
    # floor withdrawn -> normal reclaim resumes immediately (the idle
    # timers kept counting through the exemption)
    auto.set_forecast_demand(0)
    assert len(auto.update()["terminated"]) == 3


# ------------------------------------- elastic state over the data plane
def test_elastic_state_rides_object_plane_above_threshold(own_root):
    from ray_tpu_torch.elastic.worker_loop import ElasticKv
    _override(elastic_state_inline_max_bytes=1024)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        kv = ElasticKv("sgrp")
        small = {"w": np.arange(8, dtype=np.float32)}
        kv.put_state(small, step=1, gen=0)
        assert kv.peek_state_record() is None          # inline: no ref
        assert ElasticKv("sgrp").get_state()["step"] == 1
        big = {"w": np.arange(200_000, dtype=np.float32)}
        kv.put_state(big, step=2, gen=0)
        rec = kv.peek_state_record()
        assert "ref" in rec and rec["step"] == 2       # object plane
        # a fresh reader (the re-shard path) pulls peer-to-peer
        got = ElasticKv("sgrp").get_state()
        assert got["step"] == 2
        np.testing.assert_array_equal(got["state"]["w"], big["w"])
        # the manager's adopted borrow keeps the blob alive after the
        # publisher's own handle is gone (worker restart survival)
        adopted = ElasticKv("sgrp").peek_state_record()
        kv._state_ref = None
        gc.collect()
        got = ElasticKv("sgrp").get_state()
        np.testing.assert_array_equal(got["state"]["w"], big["w"])
        assert adopted is not None
        # a newer inline checkpoint supersedes the object record and
        # clears the adoption key
        kv.put_state(small, step=3, gen=0)
        assert kv.peek_state_record() is None
        assert ElasticKv("sgrp").get_state()["step"] == 3
        kv.clear()
    finally:
        ray_tpu_torch.shutdown()
        _clear_overrides("elastic_state_inline_max_bytes")


# ----------------------------------------------------- live integration
def test_gcs_actuator_vetoes_and_status_rpc(own_root):
    """Live veto rules: the last schedulable node and a placement
    group's sole host are never drained; the status RPC reports the
    disabled autopilot honestly."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)
    cluster = Cluster(head_node_args={"num_cpus": 2})
    try:
        head_id = state.list_nodes()[0]["node_id"]
        act = GcsActuator(ray_tpu_torch._head)
        assert act.veto(head_id) == "last-schedulable-node"
        n2 = cluster.add_node(num_cpus=2)
        assert act.veto(head_id) is None
        # a PG whose every bundle sits on n2: n2 is its sole host
        pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
        # head has the driver's CPU pressure; force both bundles by
        # waiting for ready and checking the table
        ray_tpu_torch.get(pg.ready(), timeout=30 * time_scale())
        table = state.autopilot_status()
        assert table["enabled"] is False and table["actions"] == []
        from ray_tpu_torch.util.placement_group import placement_group_table
        hosts = set()
        for rec in placement_group_table().values():
            hosts.update(h for h in rec["assignment"] if h)
        if hosts == {n2.node_id}:
            assert act.veto(n2.node_id) == "pg-sole-host"
        remove_placement_group(pg)
        # the autopilot never claims a node some other authority is
        # already draining — and never cancels a drain it does not own
        # (its undrain would void the provider's preemption warning)
        cluster.drain_node(n2, deadline_s=60.0, reason="spot")
        assert act.drain(n2.node_id, "straggler") is False
        assert act.undrain(n2.node_id) is False  # not ours to reverse
        assert ray_tpu_torch._head.undrain_node_internal(n2.node_id) is True
    finally:
        cluster.shutdown()


def test_autopilot_standby_supervision_live(own_root):
    """With autopilot_standby on, the head launches its own warm
    standby, relaunches it when it dies, and flags the unprotected
    window on the fleet feed."""
    keys = dict(autopilot_enabled=True, autopilot_standby=True,
                autopilot_interval_s=0.2, autopilot_standby_backoff_s=0.5,
                autopilot_forecast=False, autopilot_prewarm=False)
    _override(**keys)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        head = ray_tpu_torch._head
        if head._repl_hub is None:
            pytest.skip("replication hub disabled")
        deadline = time.monotonic() + 60 * time_scale()
        while time.monotonic() < deadline \
                and head._repl_hub.standby_count() < 1:
            time.sleep(0.2)
        assert head._repl_hub.standby_count() == 1, \
            "autopilot never attached a standby"
        status = state.autopilot_status()
        assert status["enabled"]
        launches = [a for a in status["actions"]
                    if a["kind"] == "standby_launch"
                    and a["outcome"] == "applied"]
        assert launches, status["actions"]
        events = ray_tpu_torch._private.worker.global_worker().rpc(
            "fleet_events", since=0)["events"]
        assert any(e["kind"] == "unprotected_head" for e in events)
        # kill the supervised standby: it must come back
        proc = head._autopilot.actuator._standby_proc
        proc.kill()
        proc.wait(timeout=10)
        deadline = time.monotonic() + 60 * time_scale()
        relaunched = False
        while time.monotonic() < deadline and not relaunched:
            cur = head._autopilot.actuator._standby_proc
            relaunched = cur is not proc and cur is not None \
                and cur.poll() is None and \
                head._repl_hub.standby_count() >= 1
            time.sleep(0.2)
        assert relaunched, "standby was not relaunched after death"
        survivor = head._autopilot.actuator._standby_proc
    finally:
        ray_tpu_torch.shutdown()
        _clear_overrides(*keys)
    # clean shutdown tears the supervised standby down with the head
    deadline = time.monotonic() + 20 * time_scale()
    while time.monotonic() < deadline and survivor.poll() is None:
        time.sleep(0.2)
    assert survivor.poll() is not None, \
        "supervised standby outlived a clean head shutdown"


def test_straggler_drains_its_node_once_live(own_root):
    """The head's reflex arc end to end, without the elasticity manager:
    a rank on the victim node reports 20x slower train steps through the
    normal metrics publishers, the head's detector emits node-tagged
    ``straggler`` events, and the autopilot ticked by the monitor loop
    drains that node exactly once (the storm bound), although the
    detector keeps refiring, and reports it in ``autopilot_status``."""
    from ray_tpu_torch.cluster_utils import Cluster

    ts = time_scale()
    cluster = Cluster(head_node_args={
        "num_cpus": 2, "num_gpus": 0,
        "_system_config": {
            "metrics_export_period_s": 1.0,
            "tsdb_detector_interval_s": 1.0,
            "tsdb_straggler_window_s": 8.0 * ts,
            "autopilot_enabled": True,
            "autopilot_interval_s": 0.3,
            "autopilot_drain_window_s": 600.0,
            "autopilot_max_drains_per_window": 1,
            "autopilot_node_cooldown_s": 3600.0,
            "autopilot_undrain_after_s": 36000.0,
            "autopilot_forecast": False,
            "autopilot_standby": False}})
    try:
        head = ray_tpu_torch._head
        if head._tsdb is None:
            pytest.skip("tsdb disabled")
        cluster.add_node(num_cpus=2)
        victim = cluster.add_node(num_cpus=2)

        @ray_tpu_torch.remote
        class Injector:
            def __init__(self, rank):
                self.rank = rank

            def steps(self, n, step_s):
                from ray_tpu_torch.util import metrics_catalog as mc
                h = mc.get("rtt_train_step_seconds")
                for _ in range(n):
                    h.observe(step_s, tags={"rank": self.rank})
                return n

        fast = [Injector.options(num_cpus=0.05).remote(f"i{r}")
                for r in range(3)]
        slow = Injector.options(
            num_cpus=0.05,
            resources={f"node:{victim.node_id}": 0.001}).remote("i3")
        w = ray_tpu_torch._private.worker.global_worker()

        def drained():
            return [e for e in w.rpc("fleet_events", since=0)["events"]
                    if e["kind"] == "node_draining"
                    and e.get("reason") == "straggler"]

        deadline = time.monotonic() + 90 * ts
        while time.monotonic() < deadline and not drained():
            ray_tpu_torch.get([a.steps.remote(3, 0.1) for a in fast]
                              + [slow.steps.remote(3, 2.0)], timeout=60)
            time.sleep(0.5)
        assert drained(), "the autopilot never drained the straggler's node"
        # the detector keeps firing; the rate limit holds the drains at one
        refire_until = time.monotonic() + 4.0
        while time.monotonic() < refire_until:
            ray_tpu_torch.get([a.steps.remote(3, 0.1) for a in fast]
                              + [slow.steps.remote(3, 2.0)], timeout=60)
            time.sleep(0.5)
        drains = drained()
        assert len(drains) == 1 and drains[0]["node_id"] == victim.node_id
        status = state.autopilot_status(limit=200)
        applied = [a for a in status["actions"]
                   if a["kind"] == "drain" and a["outcome"] == "applied"]
        assert len(applied) == 1, status["actions"]
        assert applied[0]["node_id"] == victim.node_id
        assert applied[0]["reason"] == "straggler"
        stragglers = [e for e in w.rpc("fleet_events", since=0)["events"]
                      if e["kind"] == "straggler"]
        assert stragglers and all(e["rank"] == "i3" for e in stragglers)
        assert all(e["node_id"] == victim.node_id for e in stragglers)
        fs = state.fleet_state()
        assert [d["node_id"] for d in fs["draining"]] == [victim.node_id]
    finally:
        cluster.shutdown()
        GLOBAL_CONFIG.reset()


# --------------------------------------------- the chaos acceptance path
DIM = 24     # divisible by every world size a generation can have


class DecayProgram:
    """Deterministic sharded program (test_torch_elastic's): w <- 0.9w."""

    def __init__(self, step_s: float = 0.05):
        self.step_s = step_s

    def init_state(self):
        from ray_tpu_torch.parallel import multihost
        return multihost.put_global(np.arange(DIM, dtype=np.float32),
                                    "cpu", axis=0)

    def restore_state(self, host_state):
        from ray_tpu_torch.parallel import multihost
        return multihost.put_global(host_state, "cpu", axis=0)

    def gather_state(self, state_):
        from ray_tpu_torch.parallel import multihost
        return multihost.gather_to_host(state_, axis=0)

    def step(self, state_, i):
        from ray_tpu_torch.parallel import multihost
        loss = multihost.allreduce((state_ * state_).sum(), op="sum")
        if self.step_s:
            time.sleep(self.step_s)
        return state_ * 0.9, {"loss": float(loss)}


def elastic_train_loop(config):
    """TorchConfig(elastic=True) contract: return the elastic program."""
    return DecayProgram(step_s=config.get("step_s", 0.05))


def test_torchtrainer_elastic_route_smoke(own_root):
    """TorchTrainer.fit routes through the elastic worker loop: history
    keyed by training_iteration, the elastic summary on the result,
    custom resources honored like the BackendExecutor path, and a precise
    error for a non-elastic loop."""
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.train.backend import TorchConfig
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, resources={"acc": 2})
    try:
        # non-CPU claims flow through to the elastic workers: with only
        # 1 "acc" unit visible per run, a 1-acc-per-worker config must
        # still schedule (and a run asking for a resource the cluster
        # lacks would hang instead of silently dropping the claim)
        trainer = TorchTrainer(
            elastic_train_loop,
            train_loop_config={"step_s": 0.0},
            torch_config=TorchConfig(elastic=True, elastic_total_steps=2,
                                     elastic_timeout_s=120 * time_scale()),
            scaling_config=ScalingConfig(
                num_workers=1,
                resources_per_worker={"CPU": 1, "acc": 1}))
        res = trainer.fit()
        assert res.error is None, res.error
        trainer = TorchTrainer(
            elastic_train_loop,
            train_loop_config={"step_s": 0.0},
            torch_config=TorchConfig(elastic=True, elastic_total_steps=5,
                                     elastic_timeout_s=120 * time_scale()),
            scaling_config=ScalingConfig(num_workers=1))
        res = trainer.fit()
        assert res.error is None, res.error
        assert [m["training_iteration"] for m in res.metrics_history] \
            == list(range(5))
        assert res.metrics["elastic"]["useful_steps"] == 5
        assert res.metrics["elastic"]["wasted_steps"] == 0
        # contract errors are precise
        bad = TorchTrainer(
            lambda cfg: object(),
            torch_config=TorchConfig(elastic=True, elastic_total_steps=3),
            scaling_config=ScalingConfig(num_workers=1))
        res = bad.fit()
        assert res.error is not None
        with pytest.raises(ValueError, match="step budget"):
            TorchTrainer(elastic_train_loop,
                         torch_config=TorchConfig(elastic=True),
                         scaling_config=ScalingConfig(num_workers=1)).fit()
    finally:
        ray_tpu_torch.shutdown()


def test_straggler_to_drain_to_remesh_chaos_both_oracles(own_root,
                                                         monkeypatch):
    """The acceptance chaos path, under BOTH runtime oracles: an
    injected straggler signal (slow rtt_train_step_seconds published
    from the victim node) trips the real detector; the autopilot drains
    the node (exactly once — storm bound asserted against a continuously
    refiring detector); the elasticity manager quiesces → re-meshes the
    surviving gloo domain without a restart; and TorchTrainer.fit,
    routed through the elastic worker loop, finishes every step with
    zero waste."""
    monkeypatch.setenv("RTT_LOCK_WATCHDOG", "1")
    monkeypatch.setenv("RTT_RESOURCE_SANITIZER", "1")
    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.train.backend import TorchConfig

    ts = time_scale()
    window_s = 8.0 * ts
    cluster = Cluster(head_node_args={
        "num_cpus": 2, "num_gpus": 0,
        "_system_config": {
            "metrics_export_period_s": 1.0,
            "tsdb_detector_interval_s": 1.0,
            "tsdb_straggler_window_s": window_s,
            "autopilot_enabled": True,
            "autopilot_interval_s": 0.3,
            "autopilot_drain_window_s": 600.0,
            "autopilot_max_drains_per_window": 1,
            "autopilot_node_cooldown_s": 3600.0,
            "autopilot_undrain_after_s": 36000.0,
            "autopilot_forecast": False,
            "autopilot_standby": False}})
    try:
        head = ray_tpu_torch._head
        if head._tsdb is None:
            pytest.skip("tsdb disabled")
        cluster.add_node(num_cpus=2)
        victim = cluster.add_node(num_cpus=2)

        @ray_tpu_torch.remote
        class Injector:
            def __init__(self, rank):
                self.rank = rank

            def steps(self, n, step_s):
                from ray_tpu_torch.util import metrics_catalog as mc
                h = mc.get("rtt_train_step_seconds")
                for _ in range(n):
                    h.observe(step_s, tags={"rank": self.rank})
                return n

        fast = [Injector.options(num_cpus=0.05).remote(f"i{r}")
                for r in range(3)]
        slow = Injector.options(
            num_cpus=0.05,
            resources={f"node:{victim.node_id}": 0.001}).remote("i3")

        stop = threading.Event()
        drained = threading.Event()

        def chaos():
            # wait until the elastic group is stepping (its per-rank
            # series exist), then inject the 20x skew from the victim
            # node until the autopilot reacts
            deadline = time.time() + 120 * ts
            w = ray_tpu_torch._private.worker.global_worker()
            while time.time() < deadline and not stop.is_set():
                series = state.metrics_series("rtt_train_step_seconds")
                if len(series) >= 2:
                    break
                time.sleep(0.5)
            while time.time() < deadline and not stop.is_set():
                try:
                    ray_tpu_torch.get([a.steps.remote(3, 0.1) for a in fast]
                                      + [slow.steps.remote(3, 2.0)])
                except Exception:  # noqa: BLE001 - teardown race
                    return
                events = w.rpc("fleet_events", since=0)["events"]
                if any(e["kind"] == "node_draining"
                       and e["node_id"] == victim.node_id
                       for e in events):
                    drained.set()
                    return
                time.sleep(0.5)

        t = threading.Thread(target=chaos, daemon=True, name="chaos")
        t.start()
        trainer = TorchTrainer(
            elastic_train_loop,
            train_loop_config={"step_s": 0.05},
            torch_config=TorchConfig(
                elastic=True, elastic_total_steps=600,
                elastic_gather_every=5,
                elastic_auto_rejoin=False,
                init_timeout_s=90 * ts,
                elastic_quiesce_timeout_s=60 * ts,
                elastic_timeout_s=360 * ts),
            scaling_config=ScalingConfig(num_workers=3),
            run_config=RunConfig(name="apgrp"))
        res = trainer.fit()
        stop.set()
        t.join(timeout=10)

        assert res.error is None, res.error
        el = res.metrics["elastic"]
        actions = [x["action"] for x in el["transitions"]]
        assert "restart" not in actions, el["transitions"]
        assert drained.is_set(), "autopilot never drained the victim"
        assert actions.count("remesh") == 1, el["transitions"]
        # recovery: every step completed exactly once through the cycle
        assert el["useful_steps"] == 600
        assert el["wasted_steps"] == 0
        # the drained node is the straggler's node, via the autopilot,
        # for the straggler reason — and exactly ONCE (no storm),
        # although the detector kept refiring all through the window
        status = state.autopilot_status(limit=200)
        applied = [a for a in status["actions"]
                   if a["kind"] == "drain" and a["outcome"] == "applied"]
        assert len(applied) == 1, status["actions"]
        assert applied[0]["node_id"] == victim.node_id
        assert applied[0]["reason"] == "straggler"
        fs = state.fleet_state()
        assert any(d["node_id"] == victim.node_id
                   for d in fs["draining"]), fs
        w = ray_tpu_torch._private.worker.global_worker()
        events = w.rpc("fleet_events", since=0)["events"]
        stragglers = [e for e in events if e["kind"] == "straggler"]
        assert stragglers and all(e["rank"] == "i3" for e in stragglers)
        drains = [e for e in events if e["kind"] == "node_draining"
                  and e.get("reason") == "straggler"]
        assert len(drains) == 1, drains
    finally:
        cluster.shutdown()
        GLOBAL_CONFIG.reset()
