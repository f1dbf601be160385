"""The port's elastic training (DESIGN.md §4j): the reference's
``tests/test_elastic.py`` case by case, then the port against the JAX
package.

The acceptance path, live on the CPU: a gloo group
(``ray_tpu_torch/parallel/multihost.py``) under the elasticity manager

- re-meshes WITHOUT a restart when a node drains (survivor processes
  keep their pids, their second generation is not a cold start, and the
  loss trajectory matches the uninterrupted single-process closed form —
  state was re-sharded, not recomputed), and
- attaches a restored node's worker to the RUNNING group the same way
  (only the joiner cold-starts).

Plus the fleet-event feed, the drain plumbing end to end (cluster_utils
→ GCS phase → subscriber), goodput accounting, and the status surface
with the last transition.

Against the JAX package: a tiny GPT-2 (2 layers, width 64, float32)
through ``TorchTrainer(TorchConfig(elastic=True))``, drained 2 → 1
mid-run, held to the JAX ``build_train_program`` run in this process on
the same global batch from the same init (losses within 1e-4 relative,
each param leaf's update within 1e-3 of its L2 norm: the limits of
``tests/test_torch_train_parity.py``; the mean of equal shards' means is
the full batch's mean, so only the order of sums differs); and
``ElasticKv``'s records, inline and object-plane, key for key and
payload for payload against the reference's.
"""

import dataclasses
import os
import pickle
import sys
import threading
import time

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ray_tpu_torch

# worker processes cannot import this test module by name — ship the
# program classes by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(chip_smoke)

from conftest import time_scale  # noqa: E402
from ray_tpu_torch import elastic  # noqa: E402
from ray_tpu_torch._private.config import GLOBAL_CONFIG  # noqa: E402
from ray_tpu_torch.cluster_utils import Cluster  # noqa: E402
from ray_tpu_torch.elastic.goodput import GoodputTracker  # noqa: E402
from ray_tpu_torch.elastic.manager import (  # noqa: E402
    ElasticConfig, ElasticityManager)
from ray_tpu_torch.elastic.worker_loop import ElasticSpec  # noqa: E402
from ray_tpu_torch.util import state  # noqa: E402
from rtt_fixtures import restore_logger, session_root  # noqa: E402

# tests/conftest.py sets only the JAX package's variable
os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")

DIM = 24     # divisible by every world size a generation can have


@pytest.fixture(scope="module", autouse=True)
def _logger():
    with restore_logger():
        yield


@pytest.fixture
def own_root(monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    with session_root(monkeypatch) as d:
        yield d


@pytest.fixture
def ray_start_regular(own_root):
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


class DecayProgram:
    """Deterministic sharded program: w <- 0.9 w, loss = sum(w^2).

    Each rank holds its 1/world of ``w`` (``put_global`` along axis 0);
    the loss is summed over the ranks.  The loss sequence is closed-form,
    so the elastic run's trajectory can be checked exactly against an
    uninterrupted reference — the strongest re-shard-correctness signal a
    toy permits.  ``step_s`` slows the loop down enough for mid-run
    choreography.
    """

    def __init__(self, step_s: float = 0.0):
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


def _reference_losses(steps: int):
    w = np.arange(DIM, dtype=np.float32)
    out = []
    for _ in range(steps):
        out.append(float((w * w).sum()))
        w = w * 0.9
    return out


def _assert_losses_match(history, steps):
    got = {h["step"]: h["metrics"]["loss"] for h in history}
    ref = _reference_losses(steps)
    missing = [i for i in range(steps) if i not in got]
    assert not missing, f"steps never reported: {missing}"
    for i in range(steps):
        assert got[i] == pytest.approx(ref[i], rel=1e-3), (i, got[i], ref[i])


def _wait(pred, timeout_s, what):
    deadline = time.time() + timeout_s * time_scale()
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


# --------------------------------------------------------------- fast units
def test_goodput_tracker_counts_only_first_time_steps():
    tr = GoodputTracker(t0=0.0)
    assert tr.record_step(0, ts=1.0) and tr.record_step(1, ts=2.0)
    # restart replays step 1: waste, not progress
    assert not tr.record_step(1, ts=3.0)
    assert tr.record_step(2, ts=4.0)
    tr.record_pause(0.5)
    s = tr.summary(now=4.0)
    assert s["useful_steps"] == 3 and s["wasted_steps"] == 1
    assert s["goodput_steps_per_s"] == pytest.approx(3 / 4.0)
    assert s["pauses"] == 1 and s["paused_s"] == 0.5


def test_fleet_events_drain_and_status_surface(ray_start_regular, capsys):
    """node_draining flows end to end: drain RPC → node phase flips to
    draining (placement refuses it) → fleet event reaches a subscriber
    → fleet_state / cluster_summary / the CLI expose it; an elastic
    transition reported to the head becomes ``last_remesh`` and the
    status line."""
    cluster_node = state.list_nodes()[0]
    seen = []
    sub = elastic.FleetEventSubscriber(seen.append,
                                      kinds=("node_draining",))
    sub.start(from_now=True)
    try:
        nid = elastic.drain_node(node_id=cluster_node["node_id"],
                                 deadline_s=45.0, reason="spot")
        assert nid == cluster_node["node_id"]
        _wait(lambda: seen, 15, "node_draining event")
        assert seen[0]["kind"] == "node_draining"
        assert seen[0]["node_id"] == nid
        assert seen[0]["reason"] == "spot"
    finally:
        sub.stop()
    fs = state.fleet_state()
    assert fs["phases"].get("draining") == 1
    assert fs["draining"][0]["node_id"] == nid
    assert fs["draining"][0]["deadline_in_s"] > 0
    assert fs["last_remesh"] is None
    # a draining node takes no new work: the only node is draining, so
    # a fresh task must sit unscheduled (and count as demand backlog)
    @ray_tpu_torch.remote
    def f():
        return 1

    ref = f.remote()
    done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=1.5)
    assert not done, "task was placed on a draining node"
    fs = state.fleet_state()
    assert fs["demand_backlog_count"] >= 1
    # events feed cursor semantics
    events, seq = elastic.fleet_events(since=0)
    kinds = [e["kind"] for e in events]
    assert "node_added" in kinds and "node_draining" in kinds
    assert elastic.fleet_events(since=seq)[0] == []
    # summary carries the fleet block (the `ray_tpu_torch status` payload)
    summary = state.cluster_summary()
    assert summary["fleet"]["phases"] == fs["phases"]
    # the manager's transition report: last_remesh, a feed event, and
    # the status line
    w = ray_tpu_torch._private.worker.global_worker()
    w.rpc("elastic_event", group="g1", action="remesh", generation=1,
          world_size=2, detail={"duration_s": 0.25})
    last = state.fleet_state()["last_remesh"]
    assert {k: last[k] for k in ("group", "action", "generation",
                                 "world_size")} == {
        "group": "g1", "action": "remesh", "generation": 1,
        "world_size": 2}
    assert last["detail"] == {"duration_s": 0.25}
    events, _ = elastic.fleet_events(since=seq)
    assert [e["kind"] for e in events] == ["remesh"]
    assert events[0]["group"] == "g1"
    from ray_tpu_torch.scripts import cli
    capsys.readouterr()
    assert cli.main(["status"]) == 0
    out = capsys.readouterr().out
    assert "  last elastic transition: remesh group=g1 gen=1 world=2" in out


def test_torch_backend_drain_handler_subscribes(ray_start_regular):
    """TorchConfig(drain_handler=...) wires a train run into the feed."""
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup
    from ray_tpu_torch.train.backend import TorchConfig, _TorchBackend

    got = []
    cfg = TorchConfig(init_collective_group=False, drain_handler=got.append)
    backend = _TorchBackend()
    wg = WorkerGroup(ScalingConfig(num_workers=1))
    try:
        # on_training_start owns the subscription (on_start would need a
        # full train session; the hook under test doesn't)
        backend.on_training_start(wg, cfg)
        nid = state.list_nodes()[0]["node_id"]
        elastic.drain_node(node_id=nid, deadline_s=10, reason="warn")
        _wait(lambda: got, 15, "drain_handler delivery")
        assert got[0]["node_id"] == nid
    finally:
        backend.on_shutdown(wg, cfg)
        wg.shutdown(force=True)
    assert backend._drain_sub is None


# ------------------------------------------------------- the acceptance path
def test_drain_remeshes_group_without_restart(own_root):
    """Preempt one node WITH warning: the surviving gloo domain re-forms
    at world-1 and resumes from the gathered state — same pids, no cold
    start, exact loss continuity, zero wasted steps."""
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        cluster.add_node(num_cpus=2)
        victim = cluster.add_node(num_cpus=2)
        total = 60
        spec = ElasticSpec(build=lambda: DecayProgram(step_s=0.1),
                           total_steps=total, gather_every=1,
                           init_timeout_s=90 * time_scale())
        mgr = ElasticityManager(spec, ElasticConfig(
            num_workers=3, min_workers=1, poll_s=0.05,
            quiesce_timeout_s=60 * time_scale(), auto_rejoin=False))

        def chaos():
            _wait(lambda: len(mgr._history) >= 3, 120,
                  "progress before the drain")
            elastic.drain_node(node_id=victim.node_id, deadline_s=30,
                               reason="spot-preemption")

        t = threading.Thread(target=chaos, daemon=True, name="chaos")
        t.start()
        res = mgr.fit(timeout_s=360 * time_scale())
        t.join(timeout=5)
        assert res.error is None, res.error
        actions = [x["action"] for x in res.transitions]
        assert actions.count("remesh") == 1, res.transitions
        assert "restart" not in actions, res.transitions
        _assert_losses_match(res.history, total)
        # goodput: every step useful exactly once; the re-mesh paused,
        # never recomputed
        assert res.goodput["useful_steps"] == total
        assert res.goodput["wasted_steps"] == 0
        assert res.goodput["pauses"] == 1
        # the no-cold-start evidence: two survivors ran BOTH generations
        # in one process each (same pid, second generation warm)
        survivors = [w for w in res.worker_results if w["completed"]]
        drained = [w for w in res.worker_results if w["drained"]]
        assert len(survivors) == 2 and len(drained) == 1
        for w in survivors:
            gens = w["generations"]
            assert [g["gen"] for g in gens] == [0, 1]
            assert all(g["pid"] == w["pid"] for g in gens)
            assert gens[0]["cold"] and not gens[1]["cold"]
            assert gens[1]["world"] == 2
            # resumed where the quiesce stopped, not from zero
            assert gens[1]["start_step"] == gens[0]["end_step"] > 0
        # the transition is visible cluster-wide
        last = state.fleet_state()["last_remesh"]
        assert last and last["action"] == "remesh"
    finally:
        cluster.shutdown()


def test_restored_slice_rejoins_running_group(own_root):
    """Scale-up rejoin: the group starts degraded (2 of target 3); when
    a node appears, the joiner attaches to the RUNNING group — the two
    incumbents re-mesh warm (same pids, no cold start) and only the
    joiner pays a fresh start, mid-run."""
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        cluster.add_node(num_cpus=2)
        # runway matters: the joiner's actor + domain bring-up must land
        # BEFORE the incumbents finish — restore the node as early as
        # possible (2 reports in) and keep stepping long enough that a
        # loaded CI host still joins mid-run
        total = 120
        spec = ElasticSpec(build=lambda: DecayProgram(step_s=0.1),
                           total_steps=total, gather_every=1,
                           init_timeout_s=90 * time_scale())
        mgr = ElasticityManager(spec, ElasticConfig(
            num_workers=3, min_workers=1, poll_s=0.05,
            quiesce_timeout_s=60 * time_scale(), auto_rejoin=True))

        def chaos():
            _wait(lambda: len(mgr._history) >= 2, 120,
                  "progress before the node's restore")
            cluster.add_node(num_cpus=2)   # the node comes back

        t = threading.Thread(target=chaos, daemon=True, name="chaos")
        t.start()
        res = mgr.fit(timeout_s=360 * time_scale())
        t.join(timeout=5)
        assert res.error is None, res.error
        actions = [x["action"] for x in res.transitions]
        assert "join" in actions and "restart" not in actions, \
            res.transitions
        _assert_losses_match(res.history, total)
        assert res.goodput["useful_steps"] == total
        assert res.goodput["wasted_steps"] == 0
        survivors = [w for w in res.worker_results
                     if len(w["generations"]) == 2]
        joiners = [w for w in res.worker_results
                   if len(w["generations"]) == 1]
        assert len(survivors) == 2 and len(joiners) == 1
        join_gen = max(x["generation"] for x in res.transitions)
        for w in survivors:
            gens = w["generations"]
            assert all(g["pid"] == w["pid"] for g in gens)
            assert not gens[1]["cold"]         # warm re-mesh
            assert gens[1]["world"] == 3
        jg = joiners[0]["generations"][0]
        assert jg["gen"] == join_gen and jg["cold"]
        assert jg["start_step"] > 0            # attached mid-run
        assert jg["world"] == 3
        assert jg["pulled"]["via"] == "kv"     # the gathered checkpoint
        assert joiners[0]["pid"] not in {w["pid"] for w in survivors}
    finally:
        cluster.shutdown()


# ------------------------------------------------ against the JAX package
GPT2_STEPS = 12
GPT2_LR = 1e-2


def test_elastic_gpt2_matches_jax_train_program_across_remesh(own_root,
                                                              tmp_path):
    """chip_smoke.py's data-parallel GPT-2 program at a tiny size (2
    layers, width 64, float32, the flash kernels' plain versions) through
    TorchTrainer's elastic route on a 3-node cluster, drained 2 → 1 after
    3 steps: every step reported once, one remesh and nothing else, the
    survivor warm in one pid, and the losses and final params held to the
    JAX package's build_train_program run on the whole global batch from
    the same init."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2 as tgpt2

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.parallel import spmd as jspmd

    jcfg = dataclasses.replace(jgpt2.tiny(), n_layer=2, n_embd=64,
                               dtype=jnp.float32, attn_impl="flash")
    tcfg = dataclasses.replace(tgpt2.tiny(), n_layer=2, n_embd=64,
                               dtype=torch.float32, attn_impl="flash")
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(0),
                                                      jcfg))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    progress = str(tmp_path / "progress.json")
    saved = str(tmp_path / "params.pkl")

    # the manager spreads over the nodes with the most free CPUs: the two
    # added ones, so the victim holds a member
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    try:
        cluster.add_node(num_cpus=2)
        victim = cluster.add_node(num_cpus=2)

        def step_seen():
            try:
                with open(progress) as f:
                    return chip_smoke.json.load(f)["step"]
            except (OSError, ValueError):
                return -1

        def chaos():
            _wait(lambda: step_seen() >= 2, 120, "3 steps before the drain")
            cluster.drain_node(victim, deadline_s=30.0, reason="spot")

        t = threading.Thread(target=chaos, daemon=True, name="chaos")
        t.start()
        result = train.TorchTrainer(
            chip_smoke.elastic_gpt2_loop,
            train_loop_config={
                "device": "cpu", "cfg": tcfg, "tree": tree, "tokens": toks,
                "lr": GPT2_LR, "schedule_steps": 50, "step_s": 0.5,
                "progress": progress, "save_to": saved,
                "total_steps": GPT2_STEPS},
            torch_config=train.TorchConfig(
                elastic=True, elastic_total_steps=GPT2_STEPS,
                elastic_auto_rejoin=False,
                init_timeout_s=90 * time_scale(),
                elastic_timeout_s=300 * time_scale()),
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(storage_path=str(tmp_path))).fit()
        t.join(timeout=5)
    finally:
        cluster.shutdown()
    assert result.error is None, result.error
    el = result.metrics["elastic"]
    assert [x["action"] for x in el["transitions"]] == ["start", "remesh"]
    assert el["useful_steps"] == GPT2_STEPS and el["wasted_steps"] == 0
    hist = result.metrics_history
    assert [h["training_iteration"] for h in hist] == list(range(GPT2_STEPS))
    worlds = [h["world"] for h in hist]
    assert worlds[0] == 2.0 and worlds[-1] == 1.0, worlds
    survivor = next(w for w in el["workers"] if w["completed"])
    gens = survivor["generations"]
    assert [g["world"] for g in gens] == [2, 1]
    assert gens[0]["cold"] and not gens[1]["cold"]
    assert {g["pid"] for g in gens} == {survivor["pid"]}
    assert [h["restored_bitwise"] for h in hist
            if "restored_bitwise" in h] == [1.0]

    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jgpt2.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=GPT2_LR, warmup=1,
                                          total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    js = jprog.init_fn(jax.random.key(0))
    jb = jspmd.shard_batch(jprog, {"tokens": toks})
    jlosses = []
    for _ in range(GPT2_STEPS):
        js, jm = jprog.step_fn(js, jb)
        jlosses.append(float(jm["loss"]))
    losses = [h["loss"] for h in hist]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]

    with open(saved, "rb") as f:
        got = pickle.load(f)
    ref = jax.tree.map(np.array, js.params)
    # the key bias has an exactly zero gradient (a shift of every score of
    # a query row); Adam turns noise into steps of up to lr: held within lr
    # a step of its start (test_torch_train.py's _assert_params_close)
    k0 = tree["blocks"]["attn_qkv"]["bias"][:, 1]
    for t_ in (got, ref):
        kb = t_["blocks"]["attn_qkv"]["bias"]
        assert np.abs(kb[:, 1] - k0).max() <= GPT2_LR * GPT2_STEPS * 1.001
        kb[:, 1] = k0
    for (path, r), g, p0 in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(tree)):
        du_ref, du = r - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)


class _FakeKv:
    """One package's internal KV and object plane, in memory."""

    def __init__(self, monkeypatch, kv_mod, pkg):
        self.store = {}
        self.objects = {}
        monkeypatch.setattr(kv_mod, "_internal_kv_put", self.put)
        monkeypatch.setattr(kv_mod, "_internal_kv_get", self.get)
        monkeypatch.setattr(kv_mod, "_internal_kv_del", self.delete)
        monkeypatch.setattr(kv_mod, "_internal_kv_list", self.list)
        monkeypatch.setattr(pkg, "put", self.obj_put)
        monkeypatch.setattr(pkg, "get", self.obj_get)

    def put(self, key, value, overwrite=True, namespace="default"):
        self.store[(namespace, key)] = bytes(value)

    def get(self, key, namespace="default"):
        return self.store.get((namespace, key))

    def delete(self, key, namespace="default"):
        return self.store.pop((namespace, key), None) is not None

    def list(self, prefix, namespace="default"):
        return [k for ns, k in self.store if ns == namespace
                and k.startswith(prefix)]

    def obj_put(self, value):
        ref = f"obj{len(self.objects)}"
        self.objects[ref] = value
        return ref

    def obj_get(self, ref):
        return self.objects[ref]


def test_elastic_kv_records_match_reference(monkeypatch):
    """ElasticKv's round trip, inline and above the inline limit, in both
    packages over in-memory KVs: the same keys in the same namespace, the
    same ``{"step", "gen", "state"}`` payload back, the same object-plane
    record (``{"step", "gen", "ref"}``, under ``state`` and ``stateref``),
    the reports and acks alike, and ``clear`` leaving nothing."""
    import ray_tpu
    from ray_tpu._private.config import GLOBAL_CONFIG as J_CONFIG
    from ray_tpu.elastic import worker_loop as j_loop
    from ray_tpu.experimental import internal_kv as j_kv

    from ray_tpu_torch.elastic import worker_loop as t_loop
    from ray_tpu_torch.experimental import internal_kv as t_kv

    fakes = {"jax": _FakeKv(monkeypatch, j_kv, ray_tpu),
             "torch": _FakeKv(monkeypatch, t_kv, ray_tpu_torch)}
    limit = 4096
    for cfg in (J_CONFIG, GLOBAL_CONFIG):
        cfg.apply_system_config({"elastic_state_inline_max_bytes": limit})
    try:
        kvs = {"jax": j_loop.ElasticKv("grp"), "torch": t_loop.ElasticKv("grp")}
        small = {"w": np.arange(8, dtype=np.float32), "n": np.int32(3)}
        big = {"w": np.arange(4096, dtype=np.float32)}
        records = {}
        for name, kv in kvs.items():
            fake = fakes[name]
            kv.put_plan({"gen": 0, "members": ["a", "b"],
                         "coordinator": "127.0.0.1:1"})
            kv.put_quiesce(1)
            kv.ack(1, "a")
            kv.report(0, 0, {"loss": 1.5})
            kv.put_state(small, step=1, gen=0)
            inline = kv.get_state()
            assert kv.peek_state_record() is None
            keys_inline = sorted(fake.store)
            kv.put_state(big, step=2, gen=0)
            rec = kv.peek_state_record()
            plane = kv.get_state()
            keys_plane = sorted(fake.store)
            reports = kv.poll_reports()
            records[name] = dict(
                inline=inline, plane=plane, keys_inline=keys_inline,
                keys_plane=keys_plane, acked=kv.acked(1),
                plan=kv.get_plan(), quiesce=kv.peek_quiesce(),
                rec={k: v for k, v in rec.items() if k != "ref"},
                reports=[{k: v for k, v in r.items() if k != "ts"}
                         for r in reports],
                obj=fake.objects[rec["ref"]])
            kv.clear()
            assert fake.store == {}
        j, t = records["jax"], records["torch"]
        # the reference's object is the pickled record; the port's is the
        # record itself, so its arrays ride out of band
        j["obj"] = pickle.loads(j["obj"])
        for key in ("keys_inline", "keys_plane", "acked", "plan", "quiesce",
                    "rec", "reports"):
            assert j[key] == t[key], key
        assert j["keys_inline"][0][0] == "elastic"
        assert ("elastic", "grp/stateref") in t["keys_plane"]
        for key in ("inline", "plane", "obj"):
            assert j[key].keys() == t[key].keys() == {"step", "gen",
                                                       "state"}, key
            assert (j[key]["step"], j[key]["gen"]) == \
                (t[key]["step"], t[key]["gen"]), key
            for leaf in j[key]["state"]:
                np.testing.assert_array_equal(j[key]["state"][leaf],
                                              t[key]["state"][leaf])
        assert t["rec"] == {"step": 2, "gen": 0}
    finally:
        for cfg in (J_CONFIG, GLOBAL_CONFIG):
            with cfg._lock:
                cfg._overrides.pop("elastic_state_inline_max_bytes", None)


# ------------------------------------------------------------ the rest
def test_placement_group_lifetime_detached(ray_start_regular):
    """The reference's signature: ``lifetime="detached"`` is accepted and
    the group places, lists and removes as any other."""
    from ray_tpu_torch.util.placement_group import (
        placement_group, placement_group_table, remove_placement_group)
    pg = placement_group([{"CPU": 1}], strategy="PACK", name="keep",
                         lifetime="detached")
    assert ray_tpu_torch.get(pg.ready(), timeout=30 * time_scale()) is pg
    row = placement_group_table()[pg.id]
    assert row["state"] == "ready" and row["bundles"] == [{"CPU": 1}]
    plain = placement_group([{"CPU": 1}], lifetime=None)
    assert ray_tpu_torch.get(plain.ready(), timeout=30 * time_scale())
    remove_placement_group(pg)
    remove_placement_group(plain)


def test_torch_config_elastic_fields_and_nccl_still_raises():
    """``elastic`` and ``drain_handler`` are accepted with the reference's
    knobs; ``use_distributed=True`` is the mesh route, and with
    ``elastic`` (which forms each generation's domain itself) it raises."""
    from ray_tpu_torch.train import TorchConfig
    cfg = TorchConfig(elastic=True, drain_handler=print,
                      elastic_total_steps=3, elastic_gather_every=2)
    assert (cfg.elastic_min_workers, cfg.elastic_auto_rejoin,
            cfg.elastic_quiesce_timeout_s, cfg.elastic_timeout_s) == \
        (1, True, 60.0, 600.0)
    assert TorchConfig(use_distributed=True).use_distributed
    with pytest.raises(ValueError, match="elastic"):
        TorchConfig(use_distributed=True, elastic=True)
